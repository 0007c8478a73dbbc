"""Serving metrics (counterpart of dfc_sa_unet_tpu/metrics.py:75-100)."""

import torch


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
