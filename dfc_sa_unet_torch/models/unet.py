"""Vanilla U-Net (counterpart of dfc_sa_unet_tpu/models/unet.py; reference
models/unet.py:6-101).

DoubleConv / Down (ceil-mode MaxPool) / Up (bilinear with
align_corners=True, or ConvTranspose2d) / OutConv, channels 64..1024
(halved by ``factor = 2`` in the decoder when bilinear).  Module names are
the reference's state-dict keys (``inc.conv.0``, ``down1.mpconv.1.conv.3``,
``up1.up``, ``up1.conv.conv.0``, ``outc.conv``).  It holds no kernel: its
convolutions go to ``F.conv2d`` as the JAX module leaves them to XLA.
"""

import torch
from torch import nn

from dfc_sa_unet_torch.nn.layers import BatchNorm, Conv, ConvTranspose2x2
from dfc_sa_unet_torch.ops.pooling import max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear


class DoubleConv(nn.Module):
    """(conv3x3 + BN + ReLU) twice, both at ``features`` channels."""

    def __init__(self, cin, features, compute_dtype=None):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(cin, features, 3, padding=1, compute_dtype=compute_dtype), BatchNorm(features), nn.ReLU(),
            Conv(features, features, 3, padding=1, compute_dtype=compute_dtype), BatchNorm(features), nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class _CeilMaxPool(nn.Module):
    """MaxPool2d(2, ceil_mode=True): an odd size keeps its last row and column."""

    def forward(self, x):
        return max_pool(x, 2, 2, ceil_mode=True)


class Down(nn.Module):
    """MaxPool2d(2, ceil_mode=True) + DoubleConv (reference models/unet.py:21-30)."""

    def __init__(self, cin, features, compute_dtype=None):
        super().__init__()
        self.mpconv = nn.Sequential(_CeilMaxPool(), DoubleConv(cin, features, compute_dtype))

    def forward(self, x):
        return self.mpconv(x)


class Up(nn.Module):
    """Upsample x1, crop to match, concat with the skip x2, DoubleConv
    (reference models/unet.py:33-58).  ``cin`` is x1's channel count: the
    transposed conv halves it, the bilinear resize keeps it."""

    def __init__(self, cin, skip_channels, features, bilinear=True, compute_dtype=None):
        super().__init__()
        self.bilinear = bilinear
        if not bilinear:
            self.up = ConvTranspose2x2(cin, cin // 2, compute_dtype=compute_dtype)
            cin = cin // 2
        self.conv = DoubleConv(cin + skip_channels, features, compute_dtype)

    def forward(self, x1, x2):
        if self.bilinear:
            x1 = resize_bilinear(x1, (2 * x1.shape[2], 2 * x1.shape[3]), align_corners=True)
        else:
            x1 = self.up(x1)
        dy = x2.shape[2] - x1.shape[2]
        dx = x2.shape[3] - x1.shape[3]
        if dy < 0 or dx < 0:  # x1 overshoots (an odd size pooled in ceil mode): cut it to the skip
            x1 = x1[:, :, : x2.shape[2], : x2.shape[3]]
        else:  # centre-crop the skip
            x2 = x2[:, :, dy // 2: dy // 2 + x1.shape[2], dx // 2: dx // 2 + x1.shape[3]]
        return self.conv(torch.cat([x2, x1], 1))


class OutConv(nn.Module):
    """The final 1x1 conv, under the reference's key ``outc.conv``."""

    def __init__(self, cin, features, compute_dtype=None):
        super().__init__()
        self.conv = Conv(cin, features, 1, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """Classic 4-level U-Net (factory name 'UNet')."""

    def __init__(self, in_channels=3, out_channels=1, bilinear=False, compute_dtype=None):
        super().__init__()
        factor = 2 if bilinear else 1
        dt = compute_dtype
        self.inc = DoubleConv(in_channels, 64, dt)
        self.down1 = Down(64, 128, dt)
        self.down2 = Down(128, 256, dt)
        self.down3 = Down(256, 512, dt)
        self.down4 = Down(512, 1024 // factor, dt)
        self.up1 = Up(1024 // factor, 512, 512 // factor, bilinear, dt)
        self.up2 = Up(512 // factor, 256, 256 // factor, bilinear, dt)
        self.up3 = Up(256 // factor, 128, 128 // factor, bilinear, dt)
        self.up4 = Up(128 // factor, 64, 64, bilinear, dt)
        self.outc = OutConv(64, out_channels, dt)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y)
