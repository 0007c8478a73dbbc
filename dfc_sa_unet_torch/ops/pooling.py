"""Pooling ops on NCHW tensors (counterpart of dfc_sa_unet_tpu/ops/pooling.py).

``adaptive_avg_pool`` is torch's own adaptive average pool: its windows
[floor(i*H/p), ceil((i+1)*H/p)) are the ones the JAX package rebuilds as a
matrix, including p > H (overlapping one-pixel windows).  It accumulates
in f32 for bf16 input and rounds once.  ``max_pool`` is MaxPool2d with
-inf padding: window 2 in floor mode between the DFC U-Net's encoder
levels, window 2 in ceil mode in the vanilla U-Net's ``Down``, window 3 /
stride 2 / padding 1 after the TransUNet backbone's root.
"""

import torch
import torch.nn.functional as F


def adaptive_avg_pool(x: torch.Tensor, output_size) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,p_h,p_w]; the identity when the size already matches."""
    p_h, p_w = int(output_size[0]), int(output_size[1])
    if tuple(x.shape[2:]) == (p_h, p_w):
        return x
    return F.adaptive_avg_pool2d(x, (p_h, p_w))


def max_pool(x: torch.Tensor, window: int = 2, stride: int | None = None, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """Max pool as torch.nn.MaxPool2d: ``padding`` pads every side with -inf.
    In floor mode partial windows at the edge are dropped; with ``ceil_mode``
    a partial window that starts inside the input is kept (the right and
    bottom edges read as -inf)."""
    return F.max_pool2d(x, window, stride if stride is not None else window, padding, ceil_mode=ceil_mode)
