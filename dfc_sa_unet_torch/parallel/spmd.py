"""The data-parallel step's hand-placed reductions (counterpart of
dfc_sa_unet_tpu/parallel/spmd.py).

Each process holds a chunk of the global batch.  The losses of the family
are means (the BCE terms) or ratios of global sums (Dice, Tversky), so each
process computes its chunk's sums, one all-reduce makes them global, and
every process takes the same ratio: the loss of the global batch.  The
mean of per-process losses would be wrong for the ratios.  The Laplacian
contour conv of ``joint`` is per-sample work and stays local (under a band
of rows it reads the neighbours' halo rows, parallel/rows.py); only its BCE
sums are reduced.  Under row sharding every process holds other pixels, so
the same sums over every process are the global batch's.  The formulas are
those of ``losses.py``; ``global_loss`` hands them ``all_reduce_sum`` as
their ``reduce``.

``all_reduce_sum`` (parallel/rows.py) is autograd-aware: its backward sums
the incoming gradients over the processes.  Every process computes the same loss from
the same global sums, so the gradient that reaches a process's chunk is
world size x its share of the true gradient; the trainer therefore
*averages* the gradients over the processes (it does not sum them).
"""

import functools
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from dfc_sa_unet_torch.losses import compute_loss
from dfc_sa_unet_torch.parallel.rows import all_reduce_sum


def global_loss(probs: torch.Tensor, targets: torch.Tensor, loss_type: str,
                loss_params: Optional[Mapping[str, Any]] = None, sample_mask=None, group=None) -> torch.Tensor:
    """``losses.compute_loss`` of the global batch, from this process's chunk (``[b,1,H,W]``
    probabilities and targets, ``sample_mask`` [b] or None), with one all-reduce of its sums over
    ``group`` (default: every process)."""
    return compute_loss(probs, targets, loss_type, loss_params, sample_mask=sample_mask,
                        reduce=functools.partial(all_reduce_sum, group=group))


def hard_counts(probs: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """[intersection, predicted, target] pixel counts of this chunk's binarised masks."""
    pb = (probs > threshold).float()
    t = targets.float()
    return torch.stack([(pb * t).sum(), pb.sum(), t.sum()])


def dice_iou_from_counts(counts: torch.Tensor):
    """(iou, dice) from [intersection, predicted, target] counts, as ``metrics.hard_dice_iou``."""
    inter, p_sum, t_sum = counts.unbind(0)
    return inter / (p_sum + t_sum - inter + 1e-7), 2.0 * inter / (p_sum + t_sum + 1e-7)


def global_hard_dice_iou(probs: torch.Tensor, targets: torch.Tensor, group=None):
    """Hard IoU and Dice of the global batch from counts all-reduced over ``group`` (exact below
    2^24 pixels)."""
    counts = hard_counts(probs, targets)
    dist.all_reduce(counts, group=group)
    return dice_iou_from_counts(counts)


def per_sample_hard_dice_iou(probs: torch.Tensor, targets: torch.Tensor, group=None, threshold: float = 0.5):
    """Each sample's hard IoU and Dice (``metrics.per_sample_hard_dice_iou``) from its counts summed
    over ``group``: under row sharding the ranks of a spatial group hold bands of the same images."""
    pb = (probs > threshold).float()
    t = targets.float()
    axes = tuple(range(1, probs.dim()))
    counts = torch.stack([(pb * t).sum(dim=axes), pb.sum(dim=axes), t.sum(dim=axes)])
    dist.all_reduce(counts, group=group)
    inter, psum, tsum = counts.unbind(0)
    return inter / (psum + tsum - inter + 1e-7), 2.0 * inter / (psum + tsum + 1e-7)
