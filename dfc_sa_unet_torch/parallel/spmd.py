"""The data-parallel step's hand-placed reductions (counterpart of
dfc_sa_unet_tpu/parallel/spmd.py).

Each process holds a chunk of the global batch.  The losses of the family
are means (the BCE terms) or ratios of global sums (Dice, Tversky), so each
process computes its chunk's sums, one all-reduce makes them global, and
every process takes the same ratio: the loss of the global batch.  The
mean of per-process losses would be wrong for the ratios.  The Laplacian
contour conv of ``joint`` is per-sample work and stays local; only its BCE
sums are reduced.  The formulas are those of ``losses.py``; ``global_loss`` hands
them ``all_reduce_sum`` as their ``reduce``.

``all_reduce_sum`` is autograd-aware: its backward sums the incoming
gradients over the processes.  Every process computes the same loss from
the same global sums, so the gradient that reaches a process's chunk is
world size x its share of the true gradient; the trainer therefore
*averages* the gradients over the processes (it does not sum them).
"""

from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from dfc_sa_unet_torch.losses import compute_loss


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes of the default group, differentiable."""
    return _AllReduceSum.apply(x)


def global_loss(probs: torch.Tensor, targets: torch.Tensor, loss_type: str,
                loss_params: Optional[Mapping[str, Any]] = None, sample_mask=None) -> torch.Tensor:
    """``losses.compute_loss`` of the global batch, from this process's chunk (``[b,1,H,W]``
    probabilities and targets, ``sample_mask`` [b] or None), with one all-reduce of its sums."""
    return compute_loss(probs, targets, loss_type, loss_params, sample_mask=sample_mask, reduce=all_reduce_sum)


def hard_counts(probs: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """[intersection, predicted, target] pixel counts of this chunk's binarised masks."""
    pb = (probs > threshold).float()
    t = targets.float()
    return torch.stack([(pb * t).sum(), pb.sum(), t.sum()])


def dice_iou_from_counts(counts: torch.Tensor):
    """(iou, dice) from [intersection, predicted, target] counts, as ``metrics.hard_dice_iou``."""
    inter, p_sum, t_sum = counts.unbind(0)
    return inter / (p_sum + t_sum - inter + 1e-7), 2.0 * inter / (p_sum + t_sum + 1e-7)


def global_hard_dice_iou(probs: torch.Tensor, targets: torch.Tensor):
    """Hard IoU and Dice of the global batch from all-reduced counts (exact below 2^24 pixels)."""
    counts = hard_counts(probs, targets)
    dist.all_reduce(counts)
    return dice_iou_from_counts(counts)
