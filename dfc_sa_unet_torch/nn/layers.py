"""Core layers (counterpart of dfc_sa_unet_tpu/nn/layers.py).

Subclasses of torch's own layers, so parameter names and shapes are the
reference checkpoints' (``weight``, ``bias``, ``running_mean`` ...).  Mixed
precision is JAX's: parameters stay f32 and are cast to the compute dtype
at use, a conv or a linear layer emits the compute dtype and adds its f32
bias before the final cast, and every normalisation runs in f32 even for
bf16 activations.  The convolutions and matrix products go to ``F.conv2d``
and ``F.linear`` as the JAX package left them to XLA.
"""

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.ops.convt import conv_transpose_2x2
from dfc_sa_unet_torch.ops.dropout import recomputing


class _AddBias(torch.autograd.Function):
    """``y.add_(bias)`` whose backward sums the bias gradient in f32: plain
    autograd would reduce a bf16 ``grad_y`` to a bf16 sum before the cast."""

    @staticmethod
    def forward(ctx, y, bias):
        ctx.mark_dirty(y)
        ctx.bias_shape = bias.shape
        return y.add_(bias)

    @staticmethod
    def backward(ctx, grad):
        shape = (1,) * (grad.dim() - len(ctx.bias_shape)) + tuple(ctx.bias_shape)
        dims = [d for d, n in enumerate(shape) if n == 1 and grad.shape[d] != 1]
        grad_bias = grad.sum(dim=dims, dtype=torch.float32) if dims else grad.float()
        return grad, grad_bias.reshape(ctx.bias_shape)


def add_bias_(y, bias):
    """The f32 bias added to a fresh product ``y`` in place: the sum is taken
    in f32 and rounded to y's dtype once, in one pass over y (the same values
    as ``(y + bias).to(y.dtype)``, which takes two passes and an f32 copy).
    Safe under autograd: a conv or a matrix product saves its inputs, not
    its output, and the bias gradient is summed in f32 as it would be for the
    out-of-place sum."""
    if bias is None:
        return y
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        return _AddBias.apply(y, bias)
    return y.add_(bias)


class Conv(nn.Conv2d):
    """nn.Conv2d computing in ``compute_dtype`` (default: the input's)."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, bias=True, compute_dtype=None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        y = F.conv2d(x.to(dtype), self.weight.to(dtype), None, self.stride, self.padding)
        return add_bias_(y, None if self.bias is None else self.bias.view(-1, 1, 1))


class WSConv(nn.Conv2d):
    """Weight-standardised conv (TransUNet's StdConv2d): the kernel is
    standardised per output channel with the biased variance and eps 1e-5,
    in f32, before the cast to the compute dtype.  No bias by default."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, bias=False, compute_dtype=None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (self.weight - mean) / torch.sqrt(var + 1e-5)
        y = F.conv2d(x.to(dtype), w.to(dtype), None, self.stride, self.padding)
        return add_bias_(y, None if self.bias is None else self.bias.view(-1, 1, 1))


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5, momentum 0.1) that normalises in f32 and
    returns the input dtype.  In training it normalises with the batch's
    biased variance and moves the running statistics with the unbiased one,
    as the JAX layer does (dfc_sa_unet_tpu/nn/layers.py:273-294), and counts
    ``num_batches_tracked``; the second run of a rematerialised block
    (ops/dropout.py::remat_call) leaves the running statistics alone: it
    moves throwaway copies, so autograd saves the same set of tensors."""

    def forward(self, x):
        mean, var = self.running_mean, self.running_var
        if self.training:
            if recomputing():
                mean, var = mean.clone(), var.clone()
            else:
                self.num_batches_tracked.add_(1)
        y = F.batch_norm(x.float(), mean, var, self.weight, self.bias, self.training, self.momentum, self.eps)
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm that normalises in f32 and returns the input dtype.

    Computed on the NHWC view ``[B, H*W, G, C/G]`` (free for a channels_last
    tensor), as the JAX layer does: mean and biased variance over the pixels
    and the group's channels, then one fused multiply-add.  ``F.group_norm``
    would copy a channels_last tensor to NCHW and back."""

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.num_groups
        xf = x.float().permute(0, 2, 3, 1).reshape(b, h * w, g, c // g)
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, unbiased=False)
        scale = torch.rsqrt(var + self.eps) * self.weight.view(g, c // g)
        shift = self.bias.view(g, c // g) - mean * scale
        y = torch.addcmul(shift, xf, scale).to(x.dtype)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last dimension, in f32, returning the input dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class Dense(nn.Linear):
    """nn.Linear computing in ``compute_dtype``; the f32 bias is added
    before the final cast."""

    def __init__(self, cin, cout, bias=True, compute_dtype=None):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        return add_bias_(F.linear(x.to(dtype), self.weight.to(dtype)), self.bias)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """nn.ConvTranspose2d(cin, cout, kernel_size=2, stride=2) in ``compute_dtype``."""

    def __init__(self, cin, cout, compute_dtype=None):
        super().__init__(cin, cout, kernel_size=2, stride=2)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return conv_transpose_2x2(x.to(self.compute_dtype or x.dtype), self.weight, self.bias)


class ConvTranspose(nn.ConvTranspose2d):
    """nn.ConvTranspose2d(cin, cout, k, s, p) in ``compute_dtype`` (the
    ViT-seg head uses k=4, s=2, p=1)."""

    def __init__(self, cin, cout, kernel_size=2, stride=2, padding=0, bias=True, compute_dtype=None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        y = F.conv_transpose2d(x.to(dtype), self.weight.to(dtype), None, self.stride, self.padding)
        return add_bias_(y, None if self.bias is None else self.bias.view(-1, 1, 1))
