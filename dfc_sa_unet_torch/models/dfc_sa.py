"""UNetDFCSA / UNetDFCSARes, the flagship model (counterpart of
dfc_sa_unet_tpu/models/dfc_sa.py; reference models/unet_dfc_sa_res.py:118-220).

Takes normalised NCHW images (stored channels_last) and returns NCHW
logits in the compute dtype.
"""

from functools import partial

from torch import nn

from dfc_sa_unet_torch.models.blocks import DFCBlock, unet_forward
from dfc_sa_unet_torch.nn.layers import Conv, ConvTranspose2x2


class UNetDFCSA(nn.Module):
    """4-level U-Net of DFC-SA blocks (encoder, bottleneck and decoder)."""

    def __init__(self, in_channels=3, out_channels=1, features=(64, 128, 256, 512), pool_size=8,
                 qk_div=8, compute_dtype=None):
        super().__init__()
        f = list(features)
        block = partial(DFCBlock, pool_size=pool_size, qk_div=qk_div, compute_dtype=compute_dtype)
        cins = [in_channels] + f[:3]
        for i in range(4):
            setattr(self, f"down{i + 1}", block(cins[i], f[i]))
        self.bottleneck = block(f[3], f[3] * 2)
        ups = [f[3] * 2] + f[3:0:-1]  # channels entering up4, up3, up2, up1
        for i, cin in zip(range(4, 0, -1), ups):
            setattr(self, f"up{i}", ConvTranspose2x2(cin, f[i - 1], compute_dtype=compute_dtype))
            setattr(self, f"up_conv{i}", block(2 * f[i - 1], f[i - 1]))
        self.final_conv = Conv(f[0], out_channels, 1, compute_dtype=compute_dtype)

    def forward(self, x):
        return unet_forward(self, x)


class UNetDFCSARes(UNetDFCSA):
    """Alias of UNetDFCSA (reference models/unet_dfc_sa_res.py:207-220)."""
