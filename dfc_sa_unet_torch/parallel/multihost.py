"""Multi-process helpers (counterpart of dfc_sa_unet_tpu/parallel/multihost.py).

Every process runs the same program over its own card; these helpers keep
the processes' decisions and host-side artifacts in step.  Each reads
``torch.distributed``'s default group, and each is a no-op or an identity
when there is none (a single process).  Every process must call a helper
that communicates the same number of times, in the same order.

Gloo takes CUDA tensors for ``broadcast`` and ``all_reduce`` only, so the
per-sample gathers go through ``all_gather_object`` on host values (they
are host values anyway).
"""

from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = ["is_primary", "process_index", "process_count", "sync", "any_flag", "broadcast_tree",
           "gather_rows", "gather_rows_many", "shard_for_this_process"]


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def is_primary() -> bool:
    """True on the process that writes artifacts and checkpoints."""
    return process_index() == 0


def comm_device() -> torch.device:
    """Where a tensor handed to a collective lives: the current card under NCCL, else the host."""
    if _active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sync(name: str = "sync") -> None:
    """Barrier across every process (no-op without a group); ``name`` labels it for a reader."""
    if _active():
        dist.barrier()


def any_flag(flag: bool) -> bool:
    """True iff ANY process passes True: the one decision every process takes together (a
    preemption stop reaches each process at a different moment; one leaving the step loop alone
    would block the others in their next collective)."""
    if not _active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _flatten(tree, leaves: list):
    """``tree`` with each tensor replaced by its index in ``leaves``."""
    if isinstance(tree, dict):
        return {k: _flatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Leaf(len(leaves) - 1)
    return tree


class _Leaf(int):
    pass


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if isinstance(tree, _Leaf):
        return leaves[int(tree)]
    return tree


@torch.no_grad()
def broadcast_tree(tree: Any) -> Any:
    """Process 0's values for every leaf, on every process.

    Tensors are overwritten in place (so ``broadcast_tree(model.state_dict())`` brings a model
    into step with rank 0's), one broadcast per (dtype, device) bucket; every other leaf (numbers,
    strings, numpy arrays) travels in one pickled object.  Every process must pass an identically
    structured tree with tensors of the same shapes and dtypes."""
    if not _active():
        return tree
    leaves: List[torch.Tensor] = []
    skeleton = _flatten(tree, leaves)
    obj = [skeleton]
    dist.broadcast_object_list(obj, src=0)
    dev = comm_device()
    buckets: dict = {}
    for i, t in enumerate(leaves):
        if t.numel():
            buckets.setdefault((t.dtype, t.device), []).append(i)
    for (dtype, device), idx in buckets.items():
        tensors = [leaves[i] for i in idx]
        flat = _flatten_dense_tensors([t.reshape(-1) for t in tensors]).to(dev)
        dist.broadcast(flat, src=0)
        for t, v in zip(tensors, _unflatten_dense_tensors(flat, [t.reshape(-1) for t in tensors])):
            t.copy_(v.view_as(t))
    return _unflatten(obj[0], leaves)


def gather_rows_many(arrs, n_real: int, every: int = 1):
    """Global per-sample values in the global batch's order, without the padded rows, for several
    [L] arrays of this process's chunk in one gather.  ``every``: the chunks of processes 0,
    every, 2 every, ... (under row sharding the ranks of a spatial group hold the same chunk).

    Each process holds the contiguous chunk of the padded global batch that the loader gave it
    (``BatchLoader(shard=...)``): real rows sit at their global index and the padding at the end,
    at indices >= ``n_real``; so the chunks in process order, cut at ``n_real``, are the batch.
    Returns numpy arrays."""
    local = np.stack([np.asarray(torch.as_tensor(a).detach().cpu()) for a in arrs], axis=-1)
    if _active():
        parts: list = [None] * dist.get_world_size()
        dist.all_gather_object(parts, local)
        local = np.concatenate(parts[::every])
    return [local[:n_real, j] for j in range(len(arrs))]


def gather_rows(arr, n_real: int):
    """One array's global per-sample values (see :func:`gather_rows_many`)."""
    return gather_rows_many([arr], n_real)[0]


def shard_for_this_process() -> Optional[tuple]:
    """(process_id, process_count) for ``BatchLoader(shard=...)``, or None for a single process."""
    n = process_count()
    return (process_index(), n) if n > 1 else None
