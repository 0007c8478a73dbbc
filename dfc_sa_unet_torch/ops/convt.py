"""2x2 / stride-2 transposed convolution (counterpart of dfc_sa_unet_tpu/ops/convt.py).

The weight is torch's ConvTranspose2d layout IOHW [Cin, Cout, 2, 2]; the
JAX package's [2, 2, Cin, Cout] is its permutation (2, 3, 0, 1).  As in
JAX, the product is emitted in the activation dtype and the f32 bias is
added before the final cast.
"""

import torch
import torch.nn.functional as F


def conv_transpose_2x2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """[B,Cin,H,W] -> [B,Cout,2H,2W]."""
    cin, _, kh, kw = weight.shape
    if (kh, kw) != (2, 2) or cin != x.shape[1]:
        raise ValueError(f"weight {tuple(weight.shape)} does not fit input {tuple(x.shape)}")
    y = F.conv_transpose2d(x, weight.to(x.dtype), stride=2)
    if bias is not None:
        y.add_(bias.view(-1, 1, 1))  # summed in f32, rounded to x's dtype once
    return y
