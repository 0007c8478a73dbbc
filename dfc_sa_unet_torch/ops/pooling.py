"""Pooling ops on NCHW tensors (counterpart of dfc_sa_unet_tpu/ops/pooling.py).

``adaptive_avg_pool`` is torch's own adaptive average pool: its windows
[floor(i*H/p), ceil((i+1)*H/p)) are the ones the JAX package rebuilds as a
matrix, including p > H (overlapping one-pixel windows).  It accumulates
in f32 for bf16 input and rounds once.  ``max_pool`` is MaxPool2d with
-inf padding: window 2 in floor mode between the DFC U-Net's encoder
levels, window 2 in ceil mode in the vanilla U-Net's ``Down``, window 3 /
stride 2 / padding 1 after the TransUNet backbone's root.

Under a band of rows (parallel/rows.py) the adaptive pool is the whole
image's, from every band's window sums (the same p x p map on every rank of
the spatial group); a max pool reads the halo rows its window reaches, -inf
past the image's edge (TransUNet's 3x3/2 at padding 1: one row above), and a
2x2 / stride-2 one is the band's own, since every band's height is even.
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.parallel import rows


def adaptive_avg_pool(x: torch.Tensor, output_size) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,p_h,p_w]; the identity when the size already matches."""
    p_h, p_w = int(output_size[0]), int(output_size[1])
    if rows.current() is not None:
        if p_h != p_w:
            raise rows.unported(f"an adaptive pool to {p_h}x{p_w}")
        return rows.adaptive_avg_pool_band(x, p_h)
    if tuple(x.shape[2:]) == (p_h, p_w):
        return x
    return F.adaptive_avg_pool2d(x, (p_h, p_w))


def max_pool(x: torch.Tensor, window: int = 2, stride: int | None = None, padding: int = 0,
             ceil_mode: bool = False) -> torch.Tensor:
    """Max pool as torch.nn.MaxPool2d: ``padding`` pads every side with -inf.
    In floor mode partial windows at the edge are dropped; with ``ceil_mode``
    a partial window that starts inside the input is kept (the right and
    bottom edges read as -inf)."""
    stride = stride if stride is not None else window
    if rows.current() is not None and (window, stride, padding, x.shape[2] % 2) != (2, 2, 0, 0):
        if ceil_mode and (x.shape[2] + 2 * padding - window) % stride:
            raise rows.unported(f"a ceil-mode max pool of window {window}, stride {stride} on {x.shape[2]} rows")
        xe = rows.window_rows(x, window, stride, padding, fill=float("-inf"))
        return F.max_pool2d(xe, window, stride, (0, padding), ceil_mode=ceil_mode)
    return F.max_pool2d(x, window, stride, padding, ceil_mode=ceil_mode)
