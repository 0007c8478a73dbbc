"""Bilinear resize on NCHW tensors (counterpart of dfc_sa_unet_tpu/ops/resize.py).

The JAX package builds torch's bilinear taps as dense matrices because
gathers are slow on a TPU; here torch's own kernel computes the same
function: align_corners=False, source index (i + 0.5) * in/out - 0.5
clamped at 0, upper tap clamped to in - 1.

Under a band of rows (parallel/rows.py) a resize reads across the band's
edges: it raises unless the size already matches (the decoder's shape fix
must not fire there, and the vanilla UNet's ``bilinear: true`` is not
ported under a band).  The pooled attention's upsample has its band version,
``parallel.rows.upsample_band``.
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.parallel import rows


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """[B,C,H,W] -> [B,C,H_out,W_out]; the identity when the size already matches."""
    h_out, w_out = int(size[0]), int(size[1])
    if tuple(x.shape[2:]) == (h_out, w_out):
        return x
    if rows.current() is not None:
        raise rows.unported(f"a bilinear resize of {tuple(x.shape[2:])} to {(h_out, w_out)}")
    return F.interpolate(x, size=(h_out, w_out), mode="bilinear", align_corners=align_corners)
