"""Inference CLI of the port (counterpart of the root inference.py).

    python -m dfc_sa_unet_torch.inference --config CFG.yaml --model WEIGHTS.pth
        --input DIR [--output DIR] [--csv_dir DIR] [--threshold 0.5]
        [--tile_size 224] [--overlap 50] [--resize W H] [--no_slide_window]
        [--tta] [--bf16] [--engine] [--batch_size 128] [--serial]
        [--device cuda]

WEIGHTS is a reference-layout PyTorch ``.pth`` (raw state dict or trainer
checkpoint), or the ``best_model`` or a checkpoint that
``python -m dfc_sa_unet_torch.train`` wrote; ``model.pretrained_path`` in the
config is the fallback.  The
config names ``DFC-SA-Res-Block``, ``VisionTransformerSegmentation`` or
``TransformerUNet``; the transformer families take tiles of their own input
size only (``--tile_size 224`` for the shipped configs), and ``--engine``
is the DFC model's.  There is no ``--no_pallas``: on the card every
attention core runs its hand-written kernel.  If
DIR holds ``original/`` and ``mask/``, per-image and micro-averaged global
metrics are printed and written to CSV.  Runs on the card; ``--device cpu``
runs the plain PyTorch path on the CPU.
"""

import argparse
import csv
import glob
import os

import numpy as np
import torch

from dfc_sa_unet_torch.config import load_config
from dfc_sa_unet_torch.infer.predictor import Predictor, load_image, prefetch
from dfc_sa_unet_torch.metrics import confusion_counts, metrics_from_counts
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.utils.device import resolve_device
from dfc_sa_unet_torch.utils.weights import load_state_dict_file


def _norm(p):
    return p.replace("\\", "/") if p else p


def create_overlay(image: np.ndarray, mask: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Red overlay of a binary mask on an RGB image, with the reference's
    flat tint (copied from dfc_sa_unet_tpu/utils/visualization.py:78-93)."""
    overlay = image.copy()
    m = np.asarray(mask) > 0.5
    if np.any(m):
        overlay[m, 0] = int(255 * alpha + overlay[m, 0].mean() * (1 - alpha))
        overlay[m, 1] = int(overlay[m, 1].mean() * (1 - alpha))
        overlay[m, 2] = int(overlay[m, 2].mean() * (1 - alpha))
    return overlay


def save_prediction(original, pred_prob, pred_binary, output_dir, filename, gt_mask=None):
    """original / heatmap / binary / overlay (/ ground truth) PNGs per image."""
    import cv2

    individual = os.path.join(output_dir, filename)
    os.makedirs(individual, exist_ok=True)
    heatmap = cv2.applyColorMap((pred_prob * 255).astype(np.uint8), cv2.COLORMAP_JET)
    overlay = create_overlay(original, pred_binary)
    cv2.imwrite(os.path.join(individual, "original.png"), cv2.cvtColor(original, cv2.COLOR_RGB2BGR))
    cv2.imwrite(os.path.join(individual, "pred_heatmap.png"), heatmap)
    cv2.imwrite(os.path.join(individual, "pred_binary.png"), (pred_binary * 255).astype(np.uint8))
    cv2.imwrite(os.path.join(individual, "pred_overlay.png"), cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
    if gt_mask is not None:
        cv2.imwrite(os.path.join(individual, "ground_truth.png"), ((gt_mask > 0) * 255).astype(np.uint8))


def build_predictor(config, weights, bf16=False, engine=False, device=None) -> Predictor:
    """Model (or folded engine) + weights -> Predictor on ``device``."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else torch.float32
    if engine:
        name = config.get("model", config)["name"]
        if name != "DFC-SA-Res-Block":
            raise ValueError(f"--engine folds the DFC-SA-Res-Block only; {name!r} is served as a module")
        from dfc_sa_unet_torch.infer.engine import DFCEngine

        model = DFCEngine(config, weights, dtype=dtype, device=dev, tail_kernel_levels="auto",
                          conv_kernel_levels="auto")
    else:
        model = create_model(config, dtype=torch.bfloat16 if bf16 else None, device=dev)
        model.load_state_dict(weights, strict=True)
    return Predictor(model, compute_dtype=dtype, device=dev)


def main(args):
    import cv2

    config = load_config(_norm(args.config))
    model_path = args.model or config["model"].get("pretrained_path")
    if not model_path:
        raise SystemExit("no weights: pass --model or set model.pretrained_path in the config")
    model_path = _norm(model_path)
    if os.path.isdir(model_path):
        raise SystemExit(f"{model_path}: the port loads torch.save files only (a reference .pth, or the "
                         f"best_model or a checkpoint of dfc_sa_unet_torch.train), not an Orbax directory (ROADMAP.md)")
    predictor = build_predictor(config, load_state_dict_file(model_path), bf16=args.bf16,
                                engine=args.engine, device=args.device)
    print(f"Loaded {model_path}; model {config['model']['name']} on {predictor.device}"
          + (" (folded engine)" if args.engine else ""))
    print("Mode: " + ("direct prediction" if args.no_slide_window else "sliding window")
          + (", TTA" if args.tta else ""))

    output_dir = _norm(args.output)
    os.makedirs(output_dir, exist_ok=True)
    input_dir = _norm(args.input)
    original_dir, mask_dir, evaluate = input_dir, os.path.join(input_dir, "mask"), False
    if os.path.isdir(mask_dir) and os.path.isdir(os.path.join(input_dir, "original")):
        original_dir, evaluate = os.path.join(input_dir, "original"), True
        print("Found 'original' and 'mask' subdirectories - evaluation enabled.")
    image_files = []
    for ext in ("*.png", "*.jpg", "*.jpeg", "*.tif", "*.tiff"):
        image_files.extend(sorted(glob.glob(os.path.join(original_dir, ext))))
    if not image_files:
        print(f"No image files found in {original_dir}.")
        return

    def decoded():
        for image_path in image_files:
            filename = os.path.splitext(os.path.basename(image_path))[0]
            target = tuple(args.resize) if (args.no_slide_window and args.resize) else None
            img, original = load_image(image_path, target_size=target)
            if original is None:
                continue
            gt_gray = None
            if evaluate:
                mask_path = next(iter(glob.glob(os.path.join(mask_dir, f"{filename}.*"))), None)
                _, gt_full = load_image(mask_path) if mask_path else (None, None)
                if gt_full is not None:
                    gt_gray = cv2.cvtColor(gt_full, cv2.COLOR_RGB2GRAY)
                else:
                    print(f"Warning: no readable mask for '{filename}'")
            yield filename, img, original, gt_gray

    stream = decoded() if args.serial else prefetch(decoded(), depth=2)
    if args.no_slide_window or args.serial:
        def predicted():
            for filename, img, original, gt_gray in stream:
                if args.no_slide_window:
                    prob_small = predictor.predict_single(img)
                    oh, ow = original.shape[:2]
                    prob = cv2.resize(prob_small, (ow, oh), interpolation=cv2.INTER_LINEAR)
                else:
                    prob = predictor.predict_sliding(original, args.tile_size, args.overlap,
                                                     args.batch_size, tta=args.tta)
                yield filename, original, gt_gray, prob
    else:
        meta: dict = {}

        def keyed():
            for i, (filename, _, original, gt_gray) in enumerate(stream):
                meta[i] = (filename, original, gt_gray)
                yield i, original

        def predicted():
            for i, prob in predictor.predict_sliding_stream(keyed(), args.tile_size, args.overlap,
                                                            args.batch_size, tta=args.tta):
                filename, original, gt_gray = meta.pop(i)
                yield filename, original, gt_gray, prob

    rows, totals = [], {"tp": 0, "fp": 0, "fn": 0, "tn": 0}
    for n_done, (filename, original, gt_gray, prob) in enumerate(predicted(), 1):
        pred_binary = (prob > args.threshold).astype(np.uint8)
        gt_mask = None
        if gt_gray is not None:
            ph, pw = prob.shape
            gt_resized = cv2.resize(gt_gray, (pw, ph), interpolation=cv2.INTER_NEAREST) > 128
            gt_mask = (gt_gray > 128).astype(np.uint8)
            counts = confusion_counts(torch.from_numpy(pred_binary), torch.from_numpy(gt_resized))
            for key in totals:
                totals[key] += counts[key]
            rows.append({**metrics_from_counts(**counts), "file": filename, **counts})
        save_prediction(original, prob, pred_binary, output_dir, filename, gt_mask=gt_mask)
        print(f"[{n_done}/{len(image_files)}] {filename}")

    if evaluate and rows:
        keys = ["iou", "dice_f1", "accuracy", "recall", "precision", "tp", "fp", "fn", "tn"]
        print(f"{'File':<30}" + "".join(f"{k.upper():>12}" for k in keys))
        for m in rows:
            print(f"{m['file']:<30}" + "".join(f"{m[k]:>12.4f}" for k in keys))
        g = metrics_from_counts(**totals)
        print("--- Global metrics (Micro-Averaged) ---")
        for k in ("iou", "dice_f1", "accuracy", "recall", "precision"):
            print(f"{k:<15} | {g[k]:.4f}")
        if args.csv_dir:
            os.makedirs(_norm(args.csv_dir), exist_ok=True)
            cfg_name = os.path.splitext(os.path.basename(args.config))[0]
            csv_path = os.path.join(_norm(args.csv_dir), f"{cfg_name}_metrics.csv")
        else:
            csv_path = os.path.join(output_dir, "evaluation_metrics.csv")
        with open(csv_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=["file"] + keys)
            writer.writeheader()
            writer.writerows(rows)
        print(f"Metrics CSV saved to: {csv_path}")
    print(f"Inference complete. Results saved to {output_dir}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run inference (sliding window, TTA, metrics) with the PyTorch port")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--model", "--model_path", dest="model", type=str, default=None,
                        help="reference-layout .pth weights; falls back to model.pretrained_path")
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", "--output_dir", dest="output", type=str, default="results")
    parser.add_argument("--csv_dir", type=str, default=None)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--tile_size", type=int, default=224)
    parser.add_argument("--overlap", type=int, default=50)
    parser.add_argument("--resize", nargs=2, type=int, metavar=("WIDTH", "HEIGHT"))
    parser.add_argument("--no_slide_window", action="store_true")
    parser.add_argument("--tta", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--engine", action="store_true",
                        help="folded inference engine: the fused DFC-tail kernel on its 7 'auto' "
                             "levels, the 3x3 conv kernel on the other two")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--serial", action="store_true", help="no decode/compute pipelining")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
