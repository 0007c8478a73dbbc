"""UNetDFCSA / UNetDFCSARes, the flagship model (counterpart of
dfc_sa_unet_tpu/models/dfc_sa.py; reference models/unet_dfc_sa_res.py:118-220).

Takes normalised NCHW images (stored channels_last) and returns NCHW
logits in the compute dtype.
"""

from functools import partial

from torch import nn

from dfc_sa_unet_torch.models.blocks import DFCBlock, build_unet, unet_forward


class UNetDFCSA(nn.Module):
    """4-level U-Net of DFC-SA blocks (encoder, bottleneck and decoder)."""

    def __init__(self, in_channels=3, out_channels=1, features=(64, 128, 256, 512), pool_size=8,
                 qk_div=8, compute_dtype=None, remat=False):
        super().__init__()
        self.remat = remat
        block = partial(DFCBlock, pool_size=pool_size, qk_div=qk_div, compute_dtype=compute_dtype)
        build_unet(self, in_channels, out_channels, features, block, block, compute_dtype)

    def forward(self, x):
        return unet_forward(self, x, self.remat)


class UNetDFCSARes(UNetDFCSA):
    """Alias of UNetDFCSA (reference models/unet_dfc_sa_res.py:207-220)."""
