"""Segmentation losses (counterpart of dfc_sa_unet_tpu/losses.py).

Every loss takes **probabilities** (after the sigmoid) and a {0,1} target,
both ``[B,1,H,W]`` (the port's NCHW), computes in f32 and returns a scalar.
``sample_mask`` (``[B]`` of 0/1) makes the loss of a zero-padded batch
equal that of the valid samples alone.

The BCE is ``torch.nn.BCELoss`` in value (log terms clamped at -100) but not
in gradient: at a probability of exactly 0 or 1 the gradient is zero, as in
the JAX package (losses.py:41-55), where ``F.binary_cross_entropy`` would
return a clamped 1e12.  Both spellings of the bce_dice weights are taken
(``weight_bce``/``bce_weight``, ``weight_dice``/``dice_weight``).

Each loss is a function of a few sums over the batch (the BCE's terms and
their count, Dice's and Tversky's products and totals).  ``reduce`` maps the
stacked sums of this process's chunk to those of the global batch; the data-
parallel step passes ``parallel.spmd.all_reduce_sum``, so the loss is that of
the global batch after one all-reduce.  Without it the sums are the batch's.
Under a band of rows (parallel/rows.py) the sums are the band's, and ``joint``'s
contour reads the neighbours' halo rows of the probabilities and the targets.
"""

from typing import Any, Mapping, Optional

import torch

from dfc_sa_unet_torch.parallel import rows

_EPS_LOG = -100.0  # torch BCELoss clamps log terms at -100


def _mask_bt(x: torch.Tensor, sample_mask) -> torch.Tensor:
    """Zero the padded samples of a [B, ...] tensor (the mask is [B])."""
    if sample_mask is None:
        return x
    return x * sample_mask.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))


def _reduced(reduce, *sums):
    """The scalar ``sums``, made global by ``reduce`` in one call, or as they are without it."""
    if reduce is None:
        return sums
    return reduce(torch.stack([s.float() for s in sums])).unbind(0)


def _bce_sums(p: torch.Tensor, t: torch.Tensor, sample_mask=None):
    """(minus the sum of the BCE terms, the number of terms it averages) over
    the valid samples' pixels.  At the endpoints the value is the clamped one
    and the gradient is zero: the ``where`` hands the log a harmless 0.5
    there, so no 0 * inf arises."""
    p, t = p.float(), t.float()
    at0, at1 = p <= 0.0, p >= 1.0
    floor = torch.full_like(p, _EPS_LOG)
    half = torch.full_like(p, 0.5)
    log_p = torch.where(at0, floor, torch.log(torch.where(at0, half, p)).clamp(min=_EPS_LOG))
    log_1p = torch.where(at1, floor, torch.log1p(-torch.where(at1, half, p)).clamp(min=_EPS_LOG))
    terms = t * log_p + (1.0 - t) * log_1p
    if sample_mask is None:
        return -terms.sum(), terms.new_tensor(float(terms.numel()))
    w = sample_mask.float().reshape(-1, *([1] * (terms.dim() - 1))).expand_as(terms)
    return -(terms * w).sum(), w.sum()


def _mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return total / count.clamp(min=1.0)


def _dice_sums(p: torch.Tensor, t: torch.Tensor):
    """(intersection, sum of p, sum of t) of the flattened batch."""
    p, t = p.reshape(-1), t.reshape(-1)
    return (p * t).sum(), p.sum(), t.sum()


def _dice(inter, p_sum, t_sum, smooth: float) -> torch.Tensor:
    return 1.0 - (2.0 * inter + smooth) / (p_sum + t_sum + smooth)


def dice_loss(pred, target, smooth: float = 1.0, sample_mask=None, reduce=None) -> torch.Tensor:
    """Soft Dice loss over the flattened batch."""
    p = _mask_bt(pred.float(), sample_mask)
    t = _mask_bt(target.float(), sample_mask)
    return _dice(*_reduced(reduce, *_dice_sums(p, t)), smooth)


def tversky_loss(pred, target, alpha: float = 0.5, beta: float = 0.5, smooth: float = 1.0,
                 sample_mask=None, reduce=None) -> torch.Tensor:
    p = _mask_bt(pred.float(), sample_mask).reshape(-1)
    t = _mask_bt(target.float(), sample_mask).reshape(-1)
    tp, fp, fn = _reduced(reduce, (p * t).sum(), ((1.0 - t) * p).sum(), (t * (1.0 - p)).sum())
    return 1.0 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)


def bce_dice_loss(pred, target, weight_bce: float = 1.0, weight_dice: float = 1.0,
                  sample_mask=None, reduce=None) -> torch.Tensor:
    p = _mask_bt(pred.float(), sample_mask)
    t = _mask_bt(target.float(), sample_mask)
    bce, n, inter, p_sum, t_sum = _reduced(reduce, *_bce_sums(pred, target, sample_mask), *_dice_sums(p, t))
    return weight_bce * _mean(bce, n) + weight_dice * _dice(inter, p_sum, t_sum, 1.0)


_LAPLACIAN = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))


def _contour(x: torch.Tensor) -> torch.Tensor:
    """3x3 Laplacian edge response, padding 1, of a [B,1,H,W] map (under a band of rows,
    parallel/rows.py, of the band with its neighbours' halo rows)."""
    kernel = torch.tensor(_LAPLACIAN, dtype=torch.float32, device=x.device).reshape(1, 1, 3, 3)
    return rows.conv3x3(x.float(), kernel)


def joint_loss(pred, target, bce_weight: float = 1.0, dice_weight: float = 1.0,
               contour_weight: float = 1.0, sample_mask=None, reduce=None) -> torch.Tensor:
    """BCE + Dice + Laplacian contour penalty, with the reference's quirks:
    inputs scrubbed of NaN and clamped to [1e-7, 1-1e-7], a Dice with
    smooth 1e-6, the contours of prediction and target clamped to [0, 1]
    before a BCE between them (no gradient through the target's).  The
    contour conv is per-sample work; only its BCE sums are reduced."""
    p = torch.nan_to_num(pred.float(), nan=0.5, posinf=1.0, neginf=0.0)
    t = torch.nan_to_num(target.float(), nan=0.0)
    p = p.clamp(1e-7, 1.0 - 1e-7)
    # the mask goes on after the clamp: a padded sample would otherwise sit at the floor
    p, t = _mask_bt(p, sample_mask), _mask_bt(t, sample_mask)
    pred_contour = _contour(p).clamp(0.0, 1.0)
    target_contour = _contour(t).clamp(0.0, 1.0).detach()
    bce, n, inter, p_sum, t_sum, cp, n_cp = _reduced(
        reduce, *_bce_sums(p, t, sample_mask), *_dice_sums(p, t),
        *_bce_sums(pred_contour, target_contour, sample_mask))

    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    l_bce = _mean(bce, n)
    l_dice = _dice(inter, p_sum, t_sum, 1e-6)
    l_bce = torch.where(torch.isnan(l_bce), zero, l_bce)
    l_dice = torch.where(torch.isnan(l_dice), zero, l_dice)
    l_seg = bce_weight * l_bce + dice_weight * l_dice
    l_cp = _mean(cp, n_cp)
    l_cp = torch.where(torch.isnan(l_cp), zero, l_cp)

    total = l_seg + contour_weight * l_cp
    return torch.where(torch.isnan(total), l_bce + l_dice, total)


def compute_loss(pred, target, loss_type: str = "dice", loss_params: Optional[Mapping[str, Any]] = None,
                 sample_mask=None, reduce=None) -> torch.Tensor:
    """The loss named by ``loss_type`` with ``loss_params``; ``reduce`` as in the module's docstring."""
    lp = dict(loss_params or {})
    if loss_type == "dice":
        return dice_loss(pred, target, sample_mask=sample_mask, reduce=reduce)
    if loss_type == "tversky":
        return tversky_loss(pred, target, lp.get("alpha", 0.5), lp.get("beta", 0.5), sample_mask=sample_mask,
                            reduce=reduce)
    if loss_type == "bce_dice":
        w_bce = lp.get("weight_bce", lp.get("bce_weight", 1.0))
        w_dice = lp.get("weight_dice", lp.get("dice_weight", 1.0))
        return bce_dice_loss(pred, target, w_bce, w_dice, sample_mask=sample_mask, reduce=reduce)
    if loss_type == "joint":
        return joint_loss(pred, target, lp.get("bce_weight", 1.0), lp.get("dice_weight", 1.0),
                          lp.get("contour_weight", 1.0), sample_mask=sample_mask, reduce=reduce)
    raise ValueError(f"unsupported loss type: {loss_type!r}")
