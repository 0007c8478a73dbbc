"""Core layers (counterpart of dfc_sa_unet_tpu/nn/layers.py).

Subclasses of torch's own layers, so parameter names and shapes are the
reference checkpoints' (``weight``, ``bias``, ``running_mean`` ...).  Mixed
precision is JAX's: parameters stay f32 and are cast to the compute dtype
at use, a conv or a linear layer emits the compute dtype and adds its f32
bias before the final cast, and every normalisation runs in f32 even for
bf16 activations.  The convolutions and matrix products go to ``F.conv2d``
and ``F.linear`` as the JAX package left them to XLA.
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.ops.bias_add import bias_add
from dfc_sa_unet_torch.ops.convt import conv_transpose_2x2
from dfc_sa_unet_torch.ops.dropout import recomputing
from dfc_sa_unet_torch.ops.layer_norm import layer_norm, layer_norm_plain
from dfc_sa_unet_torch.parallel import rows


# Set by the Trainer's data-parallel step: every BatchNorm in training mode inside the context takes
# its batch statistics over the processes of a group (JAX's bn_cross_replica_axis): the value is
# (the group,), (None,) for every process, or False
_CROSS_REPLICA: contextvars.ContextVar = contextvars.ContextVar("bn_cross_replica", default=False)


@contextlib.contextmanager
def bn_cross_replica(enabled: bool = True, group=None):
    """Make every BatchNorm that trains inside this context use the batch statistics of the
    processes of ``group`` (default: every process)."""
    token = _CROSS_REPLICA.set((group,) if enabled else False)
    try:
        yield
    finally:
        _CROSS_REPLICA.reset(token)


class _CrossReplicaNorm(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * w + b with ``mean`` and ``var`` the global batch's.

    The backward needs the global sums of dy and dy * xhat over the processes (one all-reduce);
    the weight and bias gradients are this process's own sums, which the trainer's gradient
    average combines.  Saves x in its own dtype, so a bf16 step keeps no f32 copy of x; the
    backward reads x and dy in f32 for two sums and two fused multiply-adds."""

    @staticmethod
    def forward(ctx, x, xf, weight, bias, mean, var, n, eps, group):
        """``xf`` is x in f32, made once for the statistics; ``group`` that of the statistics."""
        invstd = torch.rsqrt(var + eps)
        ctx.group = group
        ctx.save_for_backward(x, weight, mean, invstd, n)
        return F.batch_norm(xf, mean, var, weight, bias, False, 0.0, eps).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        xf, dyf = x.float(), dy.float()
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = ((dyf * xf).sum(dims) - mean * sum_dy) * invstd
        both = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(both, group=ctx.group)
        g_dy, g_dy_xhat = (both / n).chunk(2)
        # dx = w invstd (dy - g_dy - xhat g_dy_xhat), as a dy + b x + c per channel: two fused passes
        a = weight * invstd
        b = -a * invstd * g_dy_xhat
        c = a * (invstd * g_dy_xhat * mean - g_dy)
        dx = torch.addcmul(torch.addcmul(c.view(shape), dyf, a.view(shape)), xf, b.view(shape))
        return dx.to(x.dtype), None, sum_dy_xhat, sum_dy, None, None, None, None, None


class _AddBias(torch.autograd.Function):
    """``y.add_(bias)`` (``ops.bias_add``) whose backward sums the bias gradient in f32: plain
    autograd would reduce a bf16 ``grad_y`` to a bf16 sum before the cast."""

    @staticmethod
    def forward(ctx, y, bias):
        ctx.mark_dirty(y)
        ctx.bias_shape = bias.shape
        return bias_add(y, bias)

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
    out-of-place sum.  On a card the pass is ``ops.bias_add``'s kernel, the
    same bits as ``y.add_(bias)``."""
    if bias is None:
        return y
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        return _AddBias.apply(y, bias)
    return bias_add(y, bias)


class Conv(nn.Conv2d):
    """nn.Conv2d computing in ``compute_dtype`` (default: the input's).  Under a band of rows
    (parallel/rows.py) a conv reads the halo rows its window reaches (a 3x3 conv at padding 1 one
    each side, TransUNet's 7x7/2 root 3 above and 2 below, a patch conv none) and gives the band's
    output rows."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, bias=True, compute_dtype=None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        y = rows.conv2d(x.to(dtype), self.weight.to(dtype), self.stride, self.padding)
        return add_bias_(y, None if self.bias is None else self.bias.view(-1, 1, 1))


class WSConv(nn.Conv2d):
    """Weight-standardised conv (TransUNet's StdConv2d): the kernel is
    standardised per output channel with the biased variance and eps 1e-5,
    in f32, before the cast to the compute dtype.  No bias by default.  Under a
    band of rows it reads the halo rows its window reaches, as ``Conv``."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, bias=False, compute_dtype=None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = (self.weight - mean) / torch.sqrt(var + 1e-5)
        y = rows.conv2d(x.to(dtype), w.to(dtype), self.stride, self.padding)
        return add_bias_(y, None if self.bias is None else self.bias.view(-1, 1, 1))


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5, momentum 0.1) that normalises in f32 and
    returns the input dtype.  In training it normalises with the batch's
    biased variance and moves the running statistics with the unbiased one,
    as the JAX layer does (dfc_sa_unet_tpu/nn/layers.py:273-294), and counts
    ``num_batches_tracked``; the second run of a rematerialised block
    (ops/dropout.py::remat_call) leaves the running statistics alone: it
    moves throwaway copies, so autograd saves the same set of tensors.
    Inside ``bn_cross_replica()`` (the data-parallel step) a training
    BatchNorm takes the global batch's statistics; elsewhere it is
    ``F.batch_norm`` and no collective."""

    def forward(self, x):
        if self.training and _CROSS_REPLICA.get():
            return self._cross_replica(x, *_CROSS_REPLICA.get())
        mean, var = self.running_mean, self.running_var
        if self.training:
            if recomputing():
                mean, var = mean.clone(), var.clone()
            else:
                self.num_batches_tracked.add_(1)
        y = F.batch_norm(x.float(), mean, var, self.weight, self.bias, self.training, self.momentum, self.eps)
        return y.to(x.dtype)

    def _cross_replica(self, x, group=None):
        """Training with the global batch's statistics (``bn_cross_replica``), as the JAX layer
        under an axis: the sums of x and x^2 (from this process's mean and variance, one pass) and
        the count over the processes in one all-reduce, var = max(E[x^2] - E[x]^2, 0), the running
        variance moved with the global n's unbiased one.  No host synchronisation."""
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        with torch.no_grad():
            xf = x.float()
            var_local, mean_local = torch.var_mean(xf, dims, correction=0)
            n_local = xf.numel() / c
            sums = torch.cat([mean_local * n_local, (var_local + mean_local.square()) * n_local,
                              mean_local.new_full((1,), n_local)])
            dist.all_reduce(sums, group=group)
            n = sums[2 * c:]
            mean = sums[:c] / n
            var = (sums[c:2 * c] / n - mean.square()).clamp(min=0.0)
            if not recomputing():
                self.num_batches_tracked.add_(1)
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * n / (n - 1.0).clamp(min=1.0))
        return _CrossReplicaNorm.apply(x, xf, self.weight, self.bias, mean, var, n, self.eps, group)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm that normalises in f32 and returns the input dtype.

    Computed on the NHWC view ``[B, H*W, G, C/G]`` (free for a channels_last
    tensor), as the JAX layer does: mean and biased variance over the pixels
    and the group's channels, then one fused multiply-add.  ``F.group_norm``
    would copy a channels_last tensor to NCHW and back.  Under a band of
    rows the statistics are the whole image's (``rows.group_stats``: two
    all-reduces over the spatial group)."""

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.num_groups
        xf = x.float().permute(0, 2, 3, 1).reshape(b, h * w, g, c // g)
        if rows.current() is None:
            var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, unbiased=False)
        else:
            var, mean = rows.group_stats(xf, (1, 3))
        scale = torch.rsqrt(var + self.eps) * self.weight.view(g, c // g)
        shift = self.bias.view(g, c // g) - mean * scale
        y = torch.addcmul(shift, xf, scale).to(x.dtype)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last dimension, in f32, returning the input dtype.  On a card one pass
    of ``ops.layer_norm``'s kernel; where autograd needs the graph (grad enabled and x, the weight
    or the bias requiring it), and on the CPU, torch's ops (``layer_norm_plain``)."""

    def forward(self, x):
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad or self.bias.requires_grad):
            return layer_norm_plain(x, self.weight, self.bias, self.eps)
        return layer_norm(x, self.weight, self.bias, self.eps)


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
    ViT-seg head uses k=4, s=2, p=1).  Under a band of rows it reads one halo
    row each side (``rows.conv_transpose``)."""

    def __init__(self, cin, cout, kernel_size=2, stride=2, padding=0, bias=True, compute_dtype=None):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        if self.stride[0] != self.stride[1] or self.padding[0] != self.padding[1]:
            raise ValueError(f"ConvTranspose takes a square stride and padding, not {self.stride}, {self.padding}")
        y = rows.conv_transpose(x.to(dtype), self.weight.to(dtype), self.stride[0], self.padding[0])
        return add_bias_(y, None if self.bias is None else self.bias.view(-1, 1, 1))
