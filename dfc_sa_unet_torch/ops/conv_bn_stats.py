"""conv3x3 + bias with BatchNorm partial statistics, through a hand-written CUDA kernel.

Counterpart of scripts/bench_bn_stats.py::make_pallas (kernel body
``_kernel``), the JAX package's training probe: a 3x3 conv whose epilogue
also emits the per-channel sums that train-mode BatchNorm needs, so that
the conv output is never read back for the reduction.  The kernel is
csrc/conv_bn_stats.cu.  As in the JAX package its user is a probe script
(scripts/bench_torch_bn_stats.py), not the trainer.

    y     = (conv3x3(x) + b) rounded to x's dtype      [B,H,W,Cout]
    mean  = mean over B,H,W of the unrounded f32 sum   [Cout] f32
    mean2 = mean over B,H,W of its square              [Cout] f32

Layout NHWC, the weight HWIO ``[3,3,Cin,Cout]`` in x's dtype, the bias f32.
The kernel writes one row of sums per block of 64 pixels (no atomics: the
result is the same run to run); the wrapper adds the rows up.  On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches
the kernel or raises.
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build

BLOCK_PIXELS = 64  # kM of csrc/conv_bn_stats.cu
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

LAUNCHES = {"conv3x3_bias_stats": 0}


def conv3x3_bias_stats_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The arithmetic of ``xla_conv_stats`` (scripts/bench_bn_stats.py:68-77):
    an f32 conv plus bias, rounded once for y, the statistics of the
    unrounded values."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.to(x.dtype).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    return y.to(x.dtype), y.mean(dim=(0, 1, 2)), (y * y).mean(dim=(0, 1, 2))


def conv3x3_bias_stats(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x: [B,H,W,Cin]; w: [3,3,Cin,Cout]; b: [Cout] f32 -> (y, mean, mean2)."""
    if x.device.type == "cpu" and w.device.type == "cpu" and b.device.type == "cpu":
        return conv3x3_bias_stats_plain(x, w, b)
    name = "conv3x3_bias_stats"
    if x.dim() != 4:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}; the kernel takes NHWC")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}; the kernel takes CUDA tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x is {x.dtype}; the kernel takes f32 or bf16")
    for label, t, want in (("x", x, x.dtype), ("w", w, x.dtype), ("b", b, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}, x on {x.device}")
        if t.dtype != want:
            raise TypeError(f"{name}: {label} is {t.dtype}, must be {want}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        raise NotImplementedError(f"{name}: the kernel is a forward-only probe, as the TPU kernel it replaces")
    bsz, h, width, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, cin, cout) or tuple(b.shape) != (cout,):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    npix = bsz * h * width
    if cout % 8 or npix >= 2**31 or npix == 0:
        raise ValueError(f"{name}: Cout={cout} (a multiple of 8) or {npix} pixels (1 .. 2^31-1) "
                         f"not supported by the kernel")
    y = torch.empty((bsz, h, width, cout), dtype=x.dtype, device=x.device)
    blocks = -(-npix // BLOCK_PIXELS)
    partial = torch.empty((2, blocks, cout), dtype=torch.float32, device=x.device)
    fn = f"{name}_{_DTYPES[x.dtype]}"
    err = _build.kernel(fn)(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), partial[0].data_ptr(),
                            partial[1].data_ptr(), npix, h, width, cin, cout, _build.stream_handle(x.device))
    _build.check(err, fn)
    LAUNCHES[name] += 1
    stats = partial.sum(dim=1) / npix
    return y, stats[0], stats[1]
