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
The kernel writes one row of sums per tile of pixels (no atomics, and the
tile does not depend on the card: the result is the same run to run); the
wrapper adds the rows up (``partial_rows``).  In bf16 the kernel is the
bf16 conv's on ``wgmma`` with a statistics epilogue, at the conv's tiling
(``ops/dfc_tail.py::conv_tiling``, ``pack_conv_taps``; ``stats_tiling``):
the ring for deep K, the persistent kernel that reads RGB as it is at Cin
3 or 8 and Cout <= 64.  On CPU tensors the wrapper runs the plain version;
on CUDA tensors it launches the kernel or raises.
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.ops.dfc_tail import conv_tiling, pack_conv_taps, pad_dim

F32_BLOCK_PIXELS = 64  # kM of csrc/conv_bn_stats.cu: pixels a block of the f32 kernel
# The partial rows are summed in groups of ROW_GROUP first: torch's sum over the middle dimension
# of [2, rows, Cout] gives each column one thread; at down1's 100352 rows the wrapper read
# 0.571-0.577 ms with one sum and 0.485-0.499 with the groups (H100 80GB HBM3, 700 W,
# scripts/bench_torch_bn_stats.py).
ROW_GROUP = 64


def conv3x3_bias_stats_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The arithmetic of ``xla_conv_stats`` (scripts/bench_bn_stats.py:68-77):
    an f32 conv plus bias, rounded once for y, the statistics of the
    unrounded values."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.to(x.dtype).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1) + b.float()
    return y.to(x.dtype), y.mean(dim=(0, 1, 2)), (y * y).mean(dim=(0, 1, 2))


def stats_tiling(cin: int, cout: int):
    """The bf16 kernel's tiling (csrc/conv_bn_stats.cu::stats_dispatch_bf16 instantiates exactly
    these): ``conv_tiling``'s, except that a ring with a B tile 128 wide has three stages, so that
    two 99 KB blocks share an SM where four stages (132 KB) leave one.  At down2 (Cin 64, 9 steps
    a tile) the single block's prologue and epilogue are not hidden by another block's products:
    0.80-0.81 ms with four stages, 0.65 with three (H100 80GB HBM3, 700 W,
    scripts/bench_torch_bn_stats.py); at down3 and down4 a B tile 128 wide read slower than 256."""
    t = conv_tiling(cin, cout)
    if t.stages and t.nb == 128:
        return t._replace(stages=3, smem_bytes=1024 + 3 * (t.bm * 128 + t.nb * 128 + 8))
    return t


def partial_rows(npix: int, cin: int, cout: int, dtype: torch.dtype) -> int:
    """Rows of the kernel's partial sums: one per tile of pixels, ``stats_tiling(cin, cout).bm`` in
    bf16 (128 on the ring, 64 on the persistent kernel), ``F32_BLOCK_PIXELS`` in f32."""
    bm = stats_tiling(cin, cout).bm if dtype == torch.bfloat16 else F32_BLOCK_PIXELS
    return -(-npix // bm)


def partial_buffer(npix: int, cin: int, cout: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The kernel's partial sums, [2, rows, Cout] f32 (S, then Q) with ``partial_rows`` rounded up to
    a multiple of ROW_GROUP; the kernel writes the first ``partial_rows``, the others are zero."""
    rows = partial_rows(npix, cin, cout, dtype)
    partial = torch.empty((2, -(-rows // ROW_GROUP) * ROW_GROUP, cout), dtype=torch.float32, device=device)
    partial[:, rows:].zero_()
    return partial


def row_means(partial: torch.Tensor, npix: int):
    """(mean, mean2) from ``partial_buffer``'s rows: their sums over npix pixels, in groups of ROW_GROUP
    rows first, in a fixed order."""
    two, rows, cout = partial.shape
    stats = partial.view(two, rows // ROW_GROUP, ROW_GROUP, cout).sum(dim=2).sum(dim=1) / npix
    return stats[0], stats[1]


def conv3x3_bias_stats(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x: [B,H,W,Cin]; w: [3,3,Cin,Cout]; b: [Cout] f32 -> (y, mean, mean2)."""
    if _build.on_cpu(x, w, b):
        return conv3x3_bias_stats_plain(x, w, b)
    name = "conv3x3_bias_stats"
    if x.dim() != 4:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}; the kernel takes NHWC")
    _build.check_operands(name, (("x", x, None), ("w", w, None), ("b", b, torch.float32)), aligned=True,
                          no_grad=(x, w, b))
    bsz, h, width, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, cin, cout) or tuple(b.shape) != (cout,):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    npix = bsz * h * width
    if cout % 8 or npix >= 2**31 or npix == 0:
        raise ValueError(f"{name}: Cout={cout} (a multiple of 8) or {npix} pixels (1 .. 2^31-1) "
                         f"not supported by the kernel")
    y = torch.empty((bsz, h, width, cout), dtype=x.dtype, device=x.device)
    partial = partial_buffer(npix, cin, cout, x.dtype, x.device)
    out = (y.data_ptr(), partial[0].data_ptr(), partial[1].data_ptr())
    if x.dtype == torch.bfloat16:  # the wgmma kernels: the flat K walk's weight, x with the channels they read
        t = stats_tiling(cin, cout)
        x, wk = pad_dim(x, -1, t.cin), pack_conv_taps(w)
        args = (x.data_ptr(), wk.data_ptr(), b.data_ptr(), *out, npix, h, width, t.cin, cout, t.nb, t.stages)
    else:
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), *out, npix, h, width, cin, cout)
    _build.launch(f"{name}_{_build.SUFFIX[x.dtype]}", (name,), x.device, *args)
    return (y, *row_means(partial, npix))
