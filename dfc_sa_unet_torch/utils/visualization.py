"""Training/inference artifact rendering: plots, CSVs, overlays (a copy of
dfc_sa_unet_tpu/utils/visualization.py; matplotlib, pandas and PIL are
imported by the functions that need them, so the package imports without).

Produces the reference's artifact set (reference utils/visualization.py):
loss/metric curve PNGs with paired CSVs, red prediction overlays, the
5-panel combined view (Original | Prediction | Ground Truth | Edge
Overlay | Pred-GT Overlay), and per-sample prediction dumps - implemented
vectorized (the reference paints borders with per-pixel putpixel loops).
All host-side; matplotlib uses the Agg backend.
"""

import os
from typing import Sequence

import numpy as np

from dfc_sa_unet_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _norm_path(p: str) -> str:
    return p.replace("\\", "/")


def save_metrics_to_csv(epochs, train_metrics, val_metrics, metric_name, save_path):
    """Epoch/train/val CSV (reference utils/visualization.py:43-66)."""
    import pandas as pd

    save_path = _norm_path(save_path)
    pd.DataFrame(
        {
            "Epoch": list(epochs),
            f"Train_{metric_name}": list(train_metrics),
            f"Val_{metric_name}": list(val_metrics),
        }
    ).to_csv(save_path, index=False)


def save_loss_plot(train_losses, val_losses, save_path):
    """Loss curves PNG + CSV (reference utils/visualization.py:14-41)."""
    plt = _pyplot()
    save_path = _norm_path(save_path)
    plt.figure(figsize=(10, 5))
    plt.plot(train_losses, label="Train Loss")
    plt.plot(val_losses, label="Validation Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title("Training and Validation Loss")
    plt.legend()
    plt.grid(True)
    plt.savefig(save_path)
    plt.close("all")
    save_metrics_to_csv(
        range(1, len(train_losses) + 1), train_losses, val_losses, "Loss",
        os.path.splitext(save_path)[0] + ".csv",
    )


def save_metrics_plot(epochs, train_metrics, val_metrics, metric_name, save_path):
    """Metric curves PNG + CSV (reference utils/visualization.py:68-96)."""
    plt = _pyplot()
    save_path = _norm_path(save_path)
    plt.figure(figsize=(10, 5))
    plt.plot(epochs, train_metrics, label=f"Train {metric_name}")
    plt.plot(epochs, val_metrics, label=f"Validation {metric_name}")
    plt.xlabel("Epoch")
    plt.ylabel(metric_name)
    plt.title(f"Training and Validation {metric_name}")
    plt.legend()
    plt.grid(True)
    plt.savefig(save_path)
    plt.close("all")
    save_metrics_to_csv(
        epochs, train_metrics, val_metrics, metric_name, os.path.splitext(save_path)[0] + ".csv"
    )


def create_overlay(image: np.ndarray, mask: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Red overlay of a binary mask on an RGB image
    (reference utils/visualization.py:114-145, including its flat-tint
    behavior: masked pixels get channel-mean-based constants)."""
    if image.dtype != np.uint8:
        image = (image * 255).astype(np.uint8)
    mask = np.asarray(mask, dtype=np.float32)
    if mask.max() > 1:
        mask = (mask > 128).astype(np.float32) / 255.0
    overlay = image.copy()
    m = mask > 0.5
    if np.any(m):
        overlay[m, 0] = int(255 * alpha + overlay[m, 0].mean() * (1 - alpha))
        overlay[m, 1] = int(overlay[m, 1].mean() * (1 - alpha))
        overlay[m, 2] = int(overlay[m, 2].mean() * (1 - alpha))
    return overlay


def denormalize_image(img_chw_or_hwc: np.ndarray, channels_last: bool = True) -> np.ndarray:
    """Invert ImageNet normalization back to uint8 RGB
    (reference utils/visualization.py:334-341)."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    img = np.asarray(img_chw_or_hwc, np.float32)
    if not channels_last:
        img = np.transpose(img, (1, 2, 0))
    img = img * std + mean
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def create_combined_visualization(img, pred, mask, filename, save_path) -> np.ndarray:
    """5-panel comparison PNG (reference utils/visualization.py:147-312):
    Original | Prediction(red) | GT(green) | Edge overlay | Pred-GT overlay,
    with titles and white borders."""
    from PIL import Image, ImageDraw, ImageFilter, ImageFont

    save_path = _norm_path(save_path)
    if not save_path.lower().endswith((".png", ".jpg", ".jpeg")):
        save_path += ".png"
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)

    if img.dtype != np.uint8:
        img = (img * 255).astype(np.uint8)
    mask_bin = (np.asarray(mask) > 128).astype(np.uint8) * 255
    pred_bin = (np.asarray(pred) > 128).astype(np.uint8) * 255

    pred_rgb = np.zeros_like(img)
    pred_rgb[:, :, 0] = pred_bin
    mask_rgb = np.zeros_like(img)
    mask_rgb[:, :, 1] = mask_bin

    mask_edge = np.array(Image.fromarray(mask_bin, "L").filter(ImageFilter.FIND_EDGES))
    pred_edge = np.array(Image.fromarray(pred_bin, "L").filter(ImageFilter.FIND_EDGES))
    edge_overlay = img.copy()
    edge_overlay[mask_edge > 0] = (0, 255, 0)
    edge_overlay[pred_edge > 0] = (255, 0, 0)

    gt_pred = np.zeros_like(img)
    gt_pred[mask_bin > 0, 1] = 255
    gt_pred[pred_bin > 0, 0] = 255

    h, w = img.shape[:2]
    title_h, border = 40, 3
    panels = [img, pred_rgb, mask_rgb, edge_overlay, gt_pred]
    titles = ["Original", "Prediction", "Ground Truth", "Edge Overlay", "Pred-GT Overlay"]
    total_w = 5 * w + 4 * border
    canvas = np.full((h + title_h, total_w, 3), 50, np.uint8)
    canvas[title_h - 1 : title_h + 1, :, :] = 255
    x = 0
    for i, p in enumerate(panels):
        canvas[title_h:, x : x + w] = p
        if i < 4:
            canvas[title_h:, x + w : x + w + border] = 255
        x += w + border

    out = Image.fromarray(canvas, "RGB")
    draw = ImageDraw.Draw(out)
    try:
        font = ImageFont.truetype("DejaVuSans.ttf", 16)
    except IOError:
        font = ImageFont.load_default()
    for i, title in enumerate(titles):
        offset = i * (w + border)
        bbox = draw.textbbox((0, 0), title, font=font)
        tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
        draw.text((offset + (w - tw) // 2, (title_h - th) // 2), title, fill=(255, 255, 255), font=font)
    out.save(save_path)
    return np.array(out)


def save_prediction_samples(
    images: np.ndarray,
    predictions: np.ndarray,
    masks: np.ndarray,
    filenames: Sequence[str],
    save_dir: str,
    channels_last: bool = True,
):
    """Per-sample artifact dump (reference utils/visualization.py:314-388):
    <save_dir>/<name>/{original,prediction,ground_truth,overlay}.png plus
    <save_dir>/<name>.png combined view.  Inputs are normalized images and
    probability maps; NHWC by default (set channels_last=False for NCHW).
    """
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    images = np.asarray(images)
    predictions = np.asarray(predictions)
    masks = np.asarray(masks)
    for i, fname in enumerate(filenames):
        img = denormalize_image(images[i], channels_last=channels_last)
        pred = predictions[i, ..., 0] if channels_last else predictions[i, 0]
        mask = masks[i, ..., 0] if channels_last else masks[i, 0]
        pred_u8 = (pred > 0.5).astype(np.uint8) * 255
        mask_u8 = (mask > 0.5).astype(np.uint8) * 255
        base = os.path.splitext(fname)[0]
        sample_dir = os.path.join(save_dir, base)
        os.makedirs(sample_dir, exist_ok=True)
        Image.fromarray(img).save(os.path.join(sample_dir, "original.png"))
        Image.fromarray(pred_u8).save(os.path.join(sample_dir, "prediction.png"))
        Image.fromarray(mask_u8).save(os.path.join(sample_dir, "ground_truth.png"))
        Image.fromarray(create_overlay(img, pred_u8 / 255.0)).save(
            os.path.join(sample_dir, "overlay.png")
        )
        create_combined_visualization(img, pred_u8, mask_u8, base, os.path.join(save_dir, f"{base}.png"))
