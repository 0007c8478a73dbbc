"""LayerNorm over the last dimension through one hand-written CUDA kernel (csrc/layer_norm.cu).

Every ``LayerNorm`` of the port (nn/layers.py) normalises in f32 and returns its input's dtype:
mean and biased variance in f32 from the input values, rstd = 1 / sqrt(var + eps), the f32 scale
and shift, one rounding at the end.  The plain version, ``layer_norm_plain``, is that as torch ops:
x cast to f32, torch's layer_norm, the cast back (three passes over x).  The kernel reads each row
once into registers and writes it once; its mean and variance may differ from torch's in the last
place of f32 (another order of summation), so a bf16 y may differ from the plain one by an ulp in a
few elements.  No TPU kernel corresponds: XLA fuses the LayerNorm into the ops around it.

``layer_norm`` on a CUDA tensor always launches the kernel: x in bf16 or f32, contiguous (the
channel innermost) and 16-byte aligned, of a width C that ``lanes`` takes; weight and bias f32 of C
elements on x's device.  Anything else on a CUDA tensor raises.  On the CPU it runs the plain
version.  ``ops.launches()`` counts the kernel's launches (``layer_norm``).
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build

_ENTRY = {dtype: f"layer_norm_{suffix}" for dtype, suffix in _build.SUFFIX.items()}
GROUPS = (8, 16, 32)  # lanes a row
MAX_VECTORS = 8  # 16-byte vectors a lane holds


def layer_norm_plain(x, weight, bias, eps):
    """x normalised over its last dimension in f32 by torch's layer_norm, returned in x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(x.dtype)


def lanes(c: int, dtype):
    """(G, V): the kernel's group of G lanes a row of ``c`` elements of ``dtype``, each holding V
    16-byte vectors of it, where G is the smallest of ``GROUPS`` at which V = ceil(c / 16 bytes /
    G) is at most MAX_VECTORS (the last lanes of a group may hold one vector fewer); None where
    ``dtype`` is not the kernel's, no 16-byte vector divides a row, or the row is wider than 32
    lanes hold (2048 bf16, 1024 f32)."""
    if dtype not in _ENTRY:
        return None
    per = 16 // dtype.itemsize
    if c <= 0 or c % per:
        return None
    nvec = c // per
    for g in GROUPS:
        v = -(-nvec // g)
        if v <= MAX_VECTORS:
            return g, v
    return None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``layer_norm_plain``'s result: on a CUDA tensor the kernel, or TypeError / ValueError where it
    does not take the operands (NotImplementedError under autograd: it has no backward); on the CPU
    the plain version."""
    if _build.on_cpu(x, weight, bias):
        return layer_norm_plain(x, weight, bias, eps)
    _build.check_operands("layer_norm", (("x", x, None), ("weight", weight, torch.float32),
                                         ("bias", bias, torch.float32)), aligned=True, no_grad=(x, weight, bias))
    c = x.shape[-1]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm: weight {tuple(weight.shape)} and bias {tuple(bias.shape)} must hold the "
                         f"{c} elements of x's last dimension")
    plan = lanes(c, x.dtype)
    if plan is None:
        raise ValueError(f"layer_norm: the kernel takes rows that 16-byte vectors divide, at most "
                         f"{GROUPS[-1] * MAX_VECTORS} vectors wide, not {c} elements of {x.dtype}")
    y = torch.empty_like(x)
    if y.numel():
        _build.launch(_ENTRY[x.dtype], ("layer_norm",), x.device, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                      y.data_ptr(), x.numel() // c, c, *plan, float(eps))
    return y
