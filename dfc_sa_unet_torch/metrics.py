"""Evaluation metrics (counterpart of dfc_sa_unet_tpu/metrics.py).

The training metrics take probabilities and {0,1} targets ``[B,1,H,W]``
(the port's NCHW) and return f32 tensors on the inputs' device; the
serving metrics work on raw counts.
"""

from typing import Any, Mapping, Optional

import torch

from dfc_sa_unet_torch.losses import compute_loss


def dice_coefficient(pred, target, smooth: float = 1.0) -> torch.Tensor:
    """Soft Dice, the mean over (batch, channel) of per-image scores."""
    p, t = pred.float(), target.float()
    inter = (p * t).sum(dim=(2, 3))
    denom = p.sum(dim=(2, 3)) + t.sum(dim=(2, 3))
    return ((2.0 * inter + smooth) / (denom + smooth)).mean()


def iou_score(pred, target, smooth: float = 1.0) -> torch.Tensor:
    """Soft IoU, the mean over per-image scores."""
    p, t = pred.float(), target.float()
    inter = (p * t).sum(dim=(2, 3))
    union = p.sum(dim=(2, 3)) + t.sum(dim=(2, 3)) - inter
    return ((inter + smooth) / (union + smooth)).mean()


def hard_dice_iou(pred, target, threshold: float = 0.5):
    """Hard (binarised) IoU and Dice from counts summed over the batch.
    Returns (iou, dice)."""
    pb = (pred > threshold).float()
    t = target.float()
    inter = (pb * t).sum()
    union = (pb + t).sum() - inter
    return inter / (union + 1e-7), 2.0 * inter / (pb.sum() + t.sum() + 1e-7)


def per_sample_hard_dice_iou(pred, target, threshold: float = 0.5):
    """Hard IoU and Dice of each sample: two [B] tensors (iou, dice)."""
    pb = (pred > threshold).float()
    t = target.float()
    axes = tuple(range(1, pred.dim()))
    inter = (pb * t).sum(dim=axes)
    psum, tsum = pb.sum(dim=axes), t.sum(dim=axes)
    return inter / (psum + tsum - inter + 1e-7), 2.0 * inter / (psum + tsum + 1e-7)


def calculate_metrics(pred, target, loss_type: str = "dice",
                      loss_params: Optional[Mapping[str, Any]] = None) -> dict:
    """Loss, hard IoU and hard Dice of one batch."""
    iou, dice = hard_dice_iou(pred, target)
    return {"loss": compute_loss(pred, target, loss_type, loss_params), "iou": iou, "dice": dice}


def confusion_counts(pred_binary, gt_binary) -> dict:
    """Raw TP/FP/FN/TN counts as Python ints (reference inference.py:73-91)."""
    p = torch.as_tensor(pred_binary) > 0
    g = torch.as_tensor(gt_binary) > 0
    tp = int((p & g).sum())
    fp = int(p.sum()) - tp
    fn = int(g.sum()) - tp
    tn = p.numel() - (tp + fp + fn)
    return {"tp": tp, "fp": fp, "fn": fn, "tn": tn}


def metrics_from_counts(tp, fp, fn, tn, eps: float = 1e-7) -> dict:
    """IoU/Dice/Accuracy/Recall/Precision from raw counts
    (reference inference.py:317-321, 349-353)."""
    tp, fp, fn, tn = float(tp), float(fp), float(fn), float(tn)
    return {
        "iou": tp / (tp + fp + fn + eps),
        "dice_f1": (2.0 * tp) / (2.0 * tp + fp + fn + eps),
        "accuracy": (tp + tn) / (tp + tn + fp + fn + eps),
        "recall": tp / (tp + fn + eps),
        "precision": tp / (tp + fp + eps),
    }
