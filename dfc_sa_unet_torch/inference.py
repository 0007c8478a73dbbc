"""Inference CLI of the port (counterpart of the root inference.py).

    python -m dfc_sa_unet_torch.inference --config CFG.yaml --model WEIGHTS.pth
        --input DIR [--output DIR] [--csv_dir DIR] [--threshold 0.5]
        [--tile_size 224] [--overlap 50] [--resize W H] [--no_slide_window]
        [--tta] [--bf16 | --no_bf16] [--engine] [--batch_size 128] [--serial]
        [--int8 [--int8_percentile 99.9 | --int8_maxabs] [--no_int8_check] [--strict]]
        [--exe_cache DIR] [--device cuda] [--data_parallel] [--spatial_parallel S] [--multihost]
        [--coordinator HOST:PORT --num_processes N --process_id I]

    torchrun --nproc_per_node N -m dfc_sa_unet_torch.inference ... --data_parallel
    torchrun --nproc_per_node N -m dfc_sa_unet_torch.inference ... --spatial_parallel S --no_slide_window

WEIGHTS is a reference-layout PyTorch ``.pth`` (raw state dict or trainer
checkpoint), or the ``best_model`` or a checkpoint that
``python -m dfc_sa_unet_torch.train`` wrote; ``model.pretrained_path`` in the
config is the fallback.  Both are read by the factory's facade
(``models/factory.py``): an Orbax directory stops the CLI with the command that
converts it.  The
config names any of the factory's twelve models: ``DFC-SA-Res-Block``,
``UNet``, the eight ``UNet_*`` ablations, ``VisionTransformerSegmentation``
or ``TransformerUNet``; or ``SegFormer`` (its YAML:
``dfc_sa_unet_torch/configs/config_segformer_b5.yaml``; ``--tile_size 1024
--overlap 256 --batch_size 16``, the source's windows at stride 768; tiles
whose side is a multiple of 32); or ``SAM`` (``--tile_size 1024``, its one
input size; every tile prompted with the config's ``model.box``).  ViT-seg and
TransUNet take tiles of their own input size only (``--tile_size 224`` for the
shipped configs);
``UNet_FullResAttention`` attends over every pixel of a tile, so it takes
tiles up to 64x64 (``--tile_size 64``) and the attention wrapper raises for
a larger one; ``--engine`` is the flagship's.  There is no ``--no_pallas``:
on the card every attention core runs its hand-written kernel.  If
DIR holds ``original/`` and ``mask/``, per-image and micro-averaged global
metrics are printed and written to CSV, with a combined view per image; a
``mask/`` without ``original/`` is served without evaluation, with a warning.
An ``inference: {bf16: true}`` section of the config serves in bfloat16 unless
``--no_bf16`` is given.  ``--int8`` serves the flagship, ViT-seg or TransUNet
through its int8 engine (``infer/quant*.py``; it takes precedence over
``--engine``), with static activation scales calibrated on the first 8
images (a percentile of |t|, 99.9 by default, or max |t| with
``--int8_maxabs``), and, unless ``--no_int8_check``, a self-check of the int8
masks against the fp ones on those images and on images 8..16 (``--strict``
refuses to serve when it fails); any other model is served as without
``--int8``.  Runs on the card; ``--device cpu`` runs the plain PyTorch path on
the CPU.  ``--exe_cache DIR`` builds the CUDA kernels in DIR and loads them
from there (a warm DIR skips the nvcc build; the libraries are the port's only
compiled artifacts).

Several processes (``--data_parallel`` under torchrun, one process per card
on ``cuda:LOCAL_RANK`` or ``--device``; or ``--multihost`` / ``--coordinator``)
serve as the JAX CLI does across processes: every process lists the global
file list (int8 calibration runs on its first images), serves
``files[rank::world]`` on its own card with no collective, and writes
``evaluation_metrics.part{rank}.json`` into the output directory, which
must be shared; after a barrier over a Gloo group the primary merges the
rows into the global file order and writes the CSV and the summary.  In
JAX ``--data_parallel`` splits a batch over one process's devices; either
way each image gets the same probabilities.

``--spatial_parallel S`` under torchrun (row sharding of every model and
engine, ``--engine`` and ``--int8`` included): the N processes form N / S
data groups of S ranks
(rank d * S + s); data group d serves ``files[d::N/S]``, and each of its
ranks holds a band of every image's rows (parallel/rows.py): halo exchanges
between neighbouring bands, the pooled attention's pool over the bands, the
probabilities gathered over the group, so one large image is served exactly
across cards, without tile seams (``--no_slide_window``, on images whose
activations exceed one card's memory); the transformers' token stage and the
full-resolution attention's keys are gathered, and int8 calibration runs on
whole images on every rank.  The height must be a multiple of S times the
family's stride (16; ViT-seg: its patch); another height runs whole on every
rank of the group.  The group is NCCL on the cards; the spatial index 0 of
each data group writes the artifacts and the metrics' part.
"""

import argparse
import csv
import glob
import json
import os

import numpy as np
import torch
from torch import nn

from dfc_sa_unet_torch.config import load_config, merge_parallel_flags
from dfc_sa_unet_torch.data.normalize import normalize
from dfc_sa_unet_torch.infer.predictor import Predictor, load_image, prefetch
from dfc_sa_unet_torch.metrics import confusion_counts, metrics_from_counts
from dfc_sa_unet_torch.models.factory import create_model, load_variables, read_variables
from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.parallel import multihost as mh
from dfc_sa_unet_torch.parallel.mesh import add_parallel_flags, mesh_from_flags
from dfc_sa_unet_torch.utils.device import resolve_device
from dfc_sa_unet_torch.utils.visualization import create_combined_visualization


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
    """original / heatmap / binary / overlay (/ ground truth) PNGs per image, and
    with a ground truth the combined view ``{output_dir}/{filename}_combined_view.png``."""
    import cv2

    pred_binary_img = (pred_binary * 255).astype(np.uint8)
    gt_vis = ((gt_mask > 0) * 255).astype(np.uint8) if gt_mask is not None else None
    if gt_vis is not None:
        create_combined_visualization(original, pred_binary_img, gt_vis, filename,
                                      os.path.join(output_dir, f"{filename}_combined_view.png"))
    individual = os.path.join(output_dir, filename)
    os.makedirs(individual, exist_ok=True)
    heatmap = cv2.applyColorMap((pred_prob * 255).astype(np.uint8), cv2.COLORMAP_JET)
    overlay = create_overlay(original, pred_binary)
    cv2.imwrite(os.path.join(individual, "original.png"), cv2.cvtColor(original, cv2.COLOR_RGB2BGR))
    cv2.imwrite(os.path.join(individual, "pred_heatmap.png"), heatmap)
    cv2.imwrite(os.path.join(individual, "pred_binary.png"), pred_binary_img)
    cv2.imwrite(os.path.join(individual, "pred_overlay.png"), cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
    if gt_vis is not None:
        cv2.imwrite(os.path.join(individual, "ground_truth.png"), gt_vis)


def build_predictor(config, weights, bf16=False, engine=False, device=None, exe_cache_dir=None,
                    mesh=None) -> Predictor:
    """Model (or folded engine) + weights -> Predictor on ``device``; ``exe_cache_dir`` and ``mesh`` (row
    sharding) as the Predictor's.  ``weights`` is a state dict, or a module of ``config`` that holds
    them (``models.factory.load_variables``), which the module path serves as it is."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else torch.float32
    if engine:
        name = config.get("model", config)["name"]
        if name != "DFC-SA-Res-Block":
            raise ValueError(f"--engine folds the DFC-SA-Res-Block only; {name!r} is served as a module")
        from dfc_sa_unet_torch.infer.engine import DFCEngine

        model = DFCEngine(config, weights, dtype=dtype, device=dev, tail_kernel_levels="auto",
                          conv_kernel_levels="auto")
    elif isinstance(weights, nn.Module):
        model = weights
    else:
        model = create_model(config, dtype=torch.bfloat16 if bf16 else None, device=dev)
        model.load_state_dict(weights, strict=True)
    return Predictor(model, compute_dtype=dtype, device=dev, exe_cache_dir=exe_cache_dir, mesh=mesh)


INT8_MODELS = ("DFC-SA-Res-Block", "VisionTransformerSegmentation", "TransformerUNet", "TransUNet")
CALIB_IMAGES = 8


def _calibration_batches(config, image_files, args, dtype, dev):
    """(calibration batch, held-out batch or None): the first 8 images and images 8..16, cycled to
    the calibration batch's size, at the model's working side, normalised as the Predictor does."""
    name = config["model"]["name"]
    img = config.get("dataset", {}).get("img_size", [224, 224])
    img_size = (img, img) if isinstance(img, int) else tuple(img)
    side = args.tile_size if not args.no_slide_window else img_size[0]
    if name == "VisionTransformerSegmentation":
        side = config["model"].get("img_dim", 224)  # ViT-seg takes img_dim inputs only
    elif name in ("TransformerUNet", "TransUNet"):
        side = img_size[0]  # its position embeddings are sized from dataset.img_size

    def images(paths):
        return [im for im, _ in (load_image(p, target_size=(side, side)) for p in paths) if im is not None]

    def to_input(ims):
        return normalize(torch.from_numpy(np.stack(ims)).to(dev), dtype).permute(0, 3, 1, 2)

    calib = images(image_files[:CALIB_IMAGES])
    if not calib:
        raise SystemExit("--int8: no readable calibration images")
    held = images(image_files[CALIB_IMAGES:2 * CALIB_IMAGES])
    if held:
        held = (held * ((len(calib) + len(held) - 1) // len(held)))[:len(calib)]
    return to_input(calib), to_input(held) if held else None, len(calib)


def build_int8_predictor(config, weights, image_files, args, device=None, mesh=None) -> Predictor:
    """The model's int8 engine, calibrated on the input images, self-checked unless
    ``--no_int8_check``, in a Predictor on ``device`` (default ``args.device``) with ``mesh`` (row
    sharding: calibration runs on whole images, the same on every rank)."""
    from dfc_sa_unet_torch.infer.quant import int8_self_check

    dev = resolve_device(args.device if device is None else device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    percentile = None if args.int8_maxabs else args.int8_percentile
    xs, holdout, n = _calibration_batches(config, image_files, args, dtype, dev)
    kw = dict(dtype=dtype, device=dev, calib_batches=[xs], calib_percentile=percentile, holdout_batch=holdout)
    name = config["model"]["name"]
    if name == "VisionTransformerSegmentation":
        from dfc_sa_unet_torch.infer.quant_vit import Int8ViTEngine

        engine = Int8ViTEngine(config, weights, **kw)
        print(f"Using the int8 transformer serving engine (all four linears x {engine.num_layers} blocks; "
              f"calibrated on {n} images).")
    elif name in ("TransformerUNet", "TransUNet"):
        from dfc_sa_unet_torch.infer.quant_transunet import Int8TransUNetEngine

        engine = Int8TransUNetEngine(config, weights, **kw)
        print(f"Using the int8 TransUNet serving engine (all four encoder linears x {engine.num_layers} "
              f"blocks; calibrated on {n} images).")
    else:
        from dfc_sa_unet_torch.infer.quant import Int8DFCEngine

        engine = Int8DFCEngine(config, weights, tail_kernel_levels="auto", conv_kernel_levels="auto", **kw)
        print(f"Using the int8 quantized serving engine (levels: {sorted(engine.int8_levels)}; "
              f"calibrated on {n} images).")
    if not args.no_int8_check:
        chk = int8_self_check(engine, strict=args.strict)
        if chk is not None:
            extra = (f"; held-out flip rate {chk['holdout_flip_rate']:.3%}" if "holdout_flip_rate" in chk else "")
            print(f"int8 self-check: mask flip rate {chk['flip_rate']:.3%}, mean |dprob| "
                  f"{chk['mean_abs_dprob']:.5f}{extra}")
    return Predictor(engine, compute_dtype=dtype, device=dev, mesh=mesh)


def main(args):
    config = load_config(_norm(args.config))
    merge_parallel_flags(args, config, sections=("inference",))
    # without row sharding a group only for the barrier before the merge: Gloo, whatever the device;
    # with it the halos and the pool's sums too: NCCL on the cards
    mesh = mesh_from_flags(args, backend="gloo" if args.spatial_parallel <= 1 else None)
    try:
        serve(args, config, mesh)
    finally:
        mesh.close()


def serve(args, config, mesh):
    import cv2

    nproc, pid, primary = mesh.world_size, mesh.rank, mesh.is_primary
    # row sharding: the S ranks of a data index serve the same files, each a band of their rows
    writes = mesh.spatial_index == 0
    model_path = args.model or config["model"].get("pretrained_path")
    if not model_path:
        raise SystemExit("no weights: pass --model or set model.pretrained_path in the config")
    model_path = _norm(model_path)
    name = config["model"]["name"]
    int8 = args.int8 and name in INT8_MODELS
    engine = args.engine and not args.int8
    try:
        if int8 or engine:  # the engines fold or quantize the file's state dict themselves
            weights = read_variables(model_path)
        else:  # the module path serves the factory's model, which holds the weights
            weights = create_model(config, dtype=torch.bfloat16 if args.bf16 else None, device=mesh.device)
            load_variables(weights, model_path)
    except IsADirectoryError as e:  # an Orbax directory: the message names the converter
        raise SystemExit(str(e)) from None

    output_dir = _norm(args.output)
    os.makedirs(output_dir, exist_ok=True)
    input_dir = _norm(args.input)
    original_dir, mask_dir, evaluate = input_dir, os.path.join(input_dir, "mask"), False
    if os.path.isdir(mask_dir):
        if os.path.isdir(os.path.join(input_dir, "original")):
            original_dir, evaluate = os.path.join(input_dir, "original"), True
            print("Found 'original' and 'mask' subdirectories - evaluation enabled.")
        else:
            print("Warning: 'mask' found without 'original'; skipping evaluation.")
    image_files = []
    for ext in ("*.png", "*.jpg", "*.jpeg", "*.tif", "*.tiff"):
        image_files.extend(sorted(glob.glob(os.path.join(original_dir, ext))))
    if not image_files:
        print(f"No image files found in {original_dir}.")
        return

    # the global file order drives int8 calibration and the merged CSV; each process serves a strided shard
    global_files = image_files
    if nproc > 1:
        image_files = image_files[mesh.data_index::mesh.data_size]
        if primary:
            print(f"Multi-process serving: {nproc} processes, one card each; the file list shards round-robin"
                  + (f" over {mesh.data_size} data groups of {mesh.spatial} bands" if mesh.spatial > 1 else "")
                  + "; the output dir must be shared.")

    if args.exe_cache:  # before anything launches a kernel: int8 calibration does, before the Predictor exists
        _build.set_build_dir(args.exe_cache)
    if args.int8 and not int8:
        print("(--int8 supports DFC-SA-Res-Block, VisionTransformerSegmentation, and TransformerUNet; "
              "using standard path)")
    if int8:
        predictor = build_int8_predictor(config, weights, global_files, args, device=mesh.device, mesh=mesh)
    else:
        predictor = build_predictor(config, weights, bf16=args.bf16, engine=engine,
                                    device=mesh.device, exe_cache_dir=args.exe_cache, mesh=mesh)
    kind = " (int8 engine)" if int8 else " (folded engine)" if engine else ""
    print(f"Loaded {model_path}; model {name} on {predictor.device} in "
          f"{str(predictor.compute_dtype).split('.')[-1]}{kind}")
    print("Mode: " + ("direct prediction" if args.no_slide_window else "sliding window")
          + (", TTA" if args.tta else ""))

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

    metric_rows, totals = [], {"tp": 0, "fp": 0, "fn": 0, "tn": 0}
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
            metric_rows.append({**metrics_from_counts(**counts), "file": filename, **counts})
        if writes:
            save_prediction(original, prob, pred_binary, output_dir, filename, gt_mask=gt_mask)
            print(f"[{n_done}/{len(image_files)}] {filename}")

    if evaluate and nproc > 1:
        metric_rows, totals = merge_parts(output_dir, pid, nproc, metric_rows, totals, global_files, mesh.spatial)
        if not primary:
            return
    if evaluate and metric_rows:
        keys = ["iou", "dice_f1", "accuracy", "recall", "precision", "tp", "fp", "fn", "tn"]
        print(f"{'File':<30}" + "".join(f"{k.upper():>12}" for k in keys))
        for m in metric_rows:
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
            writer.writerows(metric_rows)
        print(f"Metrics CSV saved to: {csv_path}")
    if primary:
        print(f"Inference complete. Results saved to {output_dir}")


def merge_parts(output_dir, pid, nproc, rows, totals, global_files, spatial=1):
    """Every process writes its rows and totals beside the output (under row sharding the spatial
    index 0 of each data group: its other ranks served the same files); after a barrier the primary
    reads every part (and removes it) and returns the rows in the global file order and the summed
    totals; the other processes return (None, None)."""
    part = os.path.join(output_dir, f"evaluation_metrics.part{pid}.json")
    if pid % spatial == 0:
        with open(part, "w", encoding="utf-8") as f:
            json.dump({"rows": rows, "totals": totals}, f)
    mh.sync("eval_parts")
    if pid != 0:
        return None, None
    rows, totals = [], {k: 0 for k in totals}
    for p in range(0, nproc, spatial):
        path = os.path.join(output_dir, f"evaluation_metrics.part{p}.json")
        if not os.path.exists(path):
            print(f"Warning: the evaluation rows of process {p} are missing (is the output dir shared?); "
                  f"the summary covers the rest")
            continue
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        rows.extend(d["rows"])
        for k in totals:
            totals[k] += d["totals"][k]
        os.remove(path)
    order = {os.path.splitext(os.path.basename(fp))[0]: i for i, fp in enumerate(global_files)}
    rows.sort(key=lambda m: order.get(m["file"], len(order)))
    return rows, totals


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
    parser.add_argument("--bf16", action="store_true", default=None,
                        help="bfloat16 compute; fills from the config's inference.bf16 when not given")
    parser.add_argument("--no_bf16", action="store_false", dest="bf16",
                        help="override a config-enabled inference.bf16")
    parser.add_argument("--engine", action="store_true",
                        help="folded inference engine: the fused DFC-tail kernel on its 7 'auto' "
                             "levels, the 3x3 conv kernel on the other two")
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving engine (DFC-SA-Res-Block, VisionTransformerSegmentation, "
                             "TransformerUNet), calibrated on the first input images; takes precedence over "
                             "--engine")
    parser.add_argument("--int8_percentile", type=float, default=99.9,
                        help="with --int8: activation scales from this percentile of |t| (default 99.9)")
    parser.add_argument("--int8_maxabs", action="store_true",
                        help="with --int8: activation scales from max |t| instead of a percentile")
    parser.add_argument("--no_int8_check", action="store_true",
                        help="with --int8: skip the int8-vs-fp self-check on the calibration images")
    parser.add_argument("--strict", action="store_true",
                        help="with --int8: refuse to serve (instead of warning) when the self-check's mask "
                             "flip rate exceeds its gate")
    parser.add_argument("--exe_cache", type=str, default=None,
                        help="directory the CUDA kernels are built in and loaded from (a warm directory skips "
                             "the nvcc build)")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--serial", action="store_true", help="no decode/compute pipelining")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: cuda:LOCAL_RANK under torchrun), cuda:I or cpu")
    add_parallel_flags(parser, "serve a strided shard of the files in each process, one process per card")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
