"""The f32 bias of a product added in place through one hand-written CUDA kernel (csrc/bias_add.cu).

Every ``Dense`` and biased ``Conv`` of the port (nn/layers.py::add_bias_) runs its product in the
compute dtype and then adds its f32 bias to the product in place: the sum in f32, rounded to y's
dtype once.  The plain version, ``bias_add_plain``, is torch's ``y.add_(bias)``; the kernel gives
the same bits.  No TPU kernel corresponds: XLA fuses the bias into the ops around it.

``bias_add`` on a CUDA tensor always launches the kernel: y in bf16 or f32 and dense, with the
channel the bias runs along either the innermost index in memory (a Dense output ``[..., C]``, a
channels_last conv output) or the outer index of contiguous planes (an NCHW-contiguous conv
output), or a one-value bias over y in either layout; the bias f32, on y's device, with at least
one dimension (``kernel_layout``).  Anything else on a CUDA tensor raises ValueError.  On the CPU
it runs the plain version.  ``LAUNCHES`` counts the kernel's launches (``bias_add``).
"""

import math

import torch

from dfc_sa_unet_torch.ops import _build

_NAMES = {torch.bfloat16: "bias_add_bf16", torch.float32: "bias_add_f32"}

LAUNCHES = {"bias_add": 0}


def bias_add_plain(y, bias):
    """``y.add_(bias)``: y in place, returned."""
    return y.add_(bias)


def kernel_layout(y, bias):
    """(C, inner) where the kernel adds ``bias`` to ``y`` in place as torch's add_ would, element i
    in memory taking bias[(i // inner) % C]: inner 1 with the channel innermost, the plane's size
    over planes; None for any other input.  Looks at dtypes, shapes and strides, not the device.
    A 0-dim bias is refused: torch's add_ rounds it to y's dtype first, where a bias with a
    dimension takes part in the sum in f32."""
    if (y.dtype not in _NAMES or bias.dtype != torch.float32 or bias.device != y.device
            or not 1 <= bias.dim() <= y.dim()):
        return None
    c = bias.numel()
    dense = y.is_contiguous() or (y.dim() == 4 and y.is_contiguous(memory_format=torch.channels_last))
    if c == 1:  # one value for every element, in either dense layout
        return (1, y.numel()) if dense else None
    dims = [d for d, n in enumerate(bias.shape) if n != 1]
    if len(dims) != 1:
        return None
    d = y.dim() - bias.dim() + dims[0]  # the channel's dimension of y
    if y.shape[d] != c:
        return None
    if (d == y.dim() - 1 and y.is_contiguous()) or (
            d == 1 and y.dim() == 4 and y.is_contiguous(memory_format=torch.channels_last)):
        return (c, 1)
    if y.is_contiguous():
        return (c, math.prod(y.shape[d + 1:]))
    return None


def bias_add(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y += bias in place, broadcast as torch broadcasts it, the sum in f32 rounded to y's dtype
    once; returns y.  On a CUDA tensor the kernel, or ValueError where ``kernel_layout`` refuses
    the input; on the CPU ``bias_add_plain``."""
    if not y.is_cuda:
        return bias_add_plain(y, bias)
    layout = kernel_layout(y, bias)
    if layout is None:
        raise ValueError(f"bias_add: the kernel takes a dense bf16 or f32 y and an f32 bias of at least one "
                         f"dimension along one of y's channels, not y {y.dtype} {tuple(y.shape)} strides "
                         f"{y.stride()} and bias {bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if y.numel():
        name = _NAMES[y.dtype]
        err = _build.kernel(name)(y.data_ptr(), bias.contiguous().data_ptr(), y.numel(), *layout,
                                  _build.stream_handle(y.device))
        _build.check(err, name)
        LAUNCHES["bias_add"] += 1
    if not y.is_inference():  # as torch's in-place ops do; inference tensors keep no version
        torch.autograd.graph.increment_version(y)
    return y
