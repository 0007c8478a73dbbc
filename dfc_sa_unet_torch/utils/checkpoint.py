"""Checkpointing on ``torch.save`` with resume semantics (counterpart of
dfc_sa_unet_tpu/utils/checkpoint.py, whose Orbax imports JAX).

Layout, as in the JAX package, with a file where Orbax has a directory:

  <log_dir>/checkpoints/checkpoint_epoch_<N>   full training state
  <log_dir>/checkpoints/best_checkpoint        full training state at the best epoch
  <log_dir>/best_model                         weights only: a state dict that
                                               ``python -m dfc_sa_unet_torch.inference --model`` loads

A tree is written under a hidden temporary name beside its target and
renamed into place, so a reader never sees half a file and a crashed
writer's leftovers stay out of ``latest_epoch_checkpoint``'s scan.
"""

import os
from typing import Any, Mapping, Optional

import torch


def _abspath(p: str) -> str:
    return os.path.abspath(str(p).replace("\\", "/"))


def save_tree(path: str, tree: Mapping[str, Any]) -> str:
    """``tree`` (nested dicts and lists of tensors, numbers, strings) to ``path``, atomically."""
    path = _abspath(path)
    parent, base = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp.{base}.{os.getpid()}")
    try:
        torch.save(tree, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def restore_tree(path: str):
    """What ``save_tree`` wrote, with its tensors on the CPU."""
    return torch.load(_abspath(path), map_location="cpu", weights_only=False)


def latest_epoch_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Path of the newest ``checkpoint_epoch_<N>``, or None."""
    checkpoint_dir = _abspath(checkpoint_dir)
    if not os.path.isdir(checkpoint_dir):
        return None
    best, best_n = None, -1
    for name in os.listdir(checkpoint_dir):
        if name.startswith("checkpoint_epoch_"):
            try:
                n = int(name.rsplit("_", 1)[1])
            except ValueError:
                continue
            if n > best_n:
                best, best_n = os.path.join(checkpoint_dir, name), n
    return best
