"""Core layers (counterpart of dfc_sa_unet_tpu/nn/layers.py).

Subclasses of torch's own layers, so parameter names and shapes are the
reference checkpoints' (``weight``, ``bias``, ``running_mean`` ...).  Mixed
precision is JAX's: parameters stay f32 and are cast to the compute dtype
at use, a conv emits the compute dtype and adds its f32 bias before the
final cast, and BatchNorm normalises in f32 even for bf16 activations.
The convolutions go to ``F.conv2d`` as the JAX package left them to XLA.
"""

import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.ops.convt import conv_transpose_2x2


class Conv(nn.Conv2d):
    """nn.Conv2d (stride 1) computing in ``compute_dtype`` (default: the input's)."""

    def __init__(self, cin, cout, kernel_size, padding=0, bias=True, compute_dtype=None):
        super().__init__(cin, cout, kernel_size, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        y = F.conv2d(x.to(dtype), self.weight.to(dtype), None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.view(-1, 1, 1)
        return y.to(dtype)


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5) that normalises in f32 and returns the input dtype."""

    def forward(self, x):
        y = F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight, self.bias,
                         self.training, self.momentum, self.eps)
        return y.to(x.dtype)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """nn.ConvTranspose2d(cin, cout, kernel_size=2, stride=2) in ``compute_dtype``."""

    def __init__(self, cin, cout, compute_dtype=None):
        super().__init__(cin, cout, kernel_size=2, stride=2)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return conv_transpose_2x2(x.to(self.compute_dtype or x.dtype), self.weight, self.bias)
