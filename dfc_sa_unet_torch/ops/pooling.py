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
the spatial group), and a 2x2 / stride-2 max pool is the band's own, since
every band's height is even; any other max pool raises.
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
    if rows.current() is not None and (window, stride or window, padding, x.shape[2] % 2) != (2, 2, 0, 0):
        raise rows.unported(f"a max pool of window {window}, stride {stride}, padding {padding} on "
                            f"{x.shape[2]} rows")
    return F.max_pool2d(x, window, stride if stride is not None else window, padding, ceil_mode=ceil_mode)
