"""Matrix-unit probes through hand-written CUDA kernels.

Counterpart of the three Pallas kernels of scripts/bench_mxu.py
(``pl_matmul``, ``pl_conv_cat``, ``pl_conv_9dot``); the kernels are in
csrc/mxu_probes.cu.  As in the JAX package their user is a probe script
(scripts/bench_torch_mxu.py), not a model: they say how close a product
written by hand gets to the library's at the flagship's down3 shape, and
whether a conv mainloop should run few deep accumulation passes or many
shallow ones.

    probe_matmul(x, w)       [M,K] @ [K,N]
    probe_conv_cat(x, w3)    SAME conv3x3 without bias, NHWC x [B,H,W,Cin];
                             w3 [3, 3*Cin, Cout]: per row offset dy, the three
                             dx taps side by side against w3[dy]
    probe_conv_9dot(x, w9)   the same conv; w9 [9, Cin, Cout]: one product
                             per tap against w9[dy*3 + dx]

All accumulate in f32 and round once to x's dtype.  The two conv layouts
hold the same weights: ``w3 = w.reshape(3, 3*Cin, Cout)`` and
``w9 = w.reshape(9, Cin, Cout)`` of one HWIO ``w [3,3,Cin,Cout]``.  The
conv kernels run on the pipelined wgmma mainloop of csrc/conv3x3_wgmma.cuh
(the same shared memory a block whatever Cin), the matmul is a persistent
wgmma GEMM whose operands come by TMA (one block an SM walks 128 x 256
output tiles, so M has no grid limit).  The kernels take bf16 (the probe's
type); the plain versions any float type.  On CPU tensors a wrapper runs its
plain version; on CUDA tensors it launches its kernel or raises.
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build

BLOCK_ROWS = 128  # rows or pixels a tile: kGemmBM of csrc/mxu_probes.cu, wgconv::kBM of conv3x3_wgmma.cuh


def probe_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 accumulation, rounded once (``_mm_kernel``, bench_mxu.py:51-54)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _padded(x: torch.Tensor) -> torch.Tensor:
    """x in f32 with a zero border of one pixel: [B,H+2,W+2,Cin]."""
    return F.pad(x.float(), (0, 0, 1, 1, 1, 1))


def probe_conv_cat_plain(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """Three products of depth 3*Cin (``_conv_cat_kernel``, bench_mxu.py:82-93):
    for row offset dy the taps dx = 0, 1, 2 are concatenated along the channels."""
    b, h, w, _ = x.shape
    xp = _padded(x)
    acc = 0.0
    for dy in range(3):
        taps = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dx in range(3)], dim=-1)
        acc = acc + torch.matmul(taps, w3[dy].float())
    return acc.to(x.dtype)


def probe_conv_9dot_plain(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """Nine products of depth Cin (``_conv_9dot_kernel``, bench_mxu.py:96-107)."""
    b, h, w, _ = x.shape
    xp = _padded(x)
    acc = 0.0
    for dy in range(3):
        for dx in range(3):
            acc = acc + torch.matmul(xp[:, dy:dy + h, dx:dx + w], w9[dy * 3 + dx].float())
    return acc.to(x.dtype)


def probe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M,K]; w: [K,N] -> [M,N]."""
    if _build.on_cpu(x, w):
        return probe_matmul_plain(x, w)
    name = "probe_matmul"
    _build.check_operands(name, (("x", x, torch.bfloat16), ("w", w, torch.bfloat16)), aligned=True, no_grad=(x, w))
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if k % 8 or n % 8 or k == 0 or n == 0 or not 0 < m < 2**31:
        raise ValueError(f"{name}: M={m} (1 .. 2^31 - 1), K={k} and N={n} (multiples of 8: the 16-byte strides "
                         f"of its TMA maps) not supported by the kernel")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    _build.launch("probe_matmul_bf16", (name,), x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n)
    return out


def _probe_conv(name, taps_per_pass, x, w):
    _build.check_operands(name, (("x", x, torch.bfloat16), ("w", w, torch.bfloat16)), aligned=True, no_grad=(x, w))
    if x.dim() != 4:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}; the kernel takes NHWC")
    bsz, h, width, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (9 // taps_per_pass, taps_per_pass * cin, cout):
        raise ValueError(f"{name}: w has shape {tuple(w.shape)}; x {tuple(x.shape)} needs "
                         f"{(9 // taps_per_pass, taps_per_pass * cin, cout)}")
    npix = bsz * h * width
    if cin % 8 or cout % 8 or cin == 0 or not 0 < npix < 2**31:
        raise ValueError(f"{name}: Cin={cin} and Cout={cout} (multiples of 8) or {npix} pixels "
                         f"(1 .. 2^31 - 1) not supported by the kernel")
    out = torch.empty((bsz, h, width, cout), dtype=x.dtype, device=x.device)
    _build.launch(f"{name}_bf16", (name,), x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), npix, h, width, cin,
                  cout)
    return out


def probe_conv_cat(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """x: [B,H,W,Cin]; w3: [3, 3*Cin, Cout] -> [B,H,W,Cout]."""
    if _build.on_cpu(x, w3):
        return probe_conv_cat_plain(x, w3)
    return _probe_conv("probe_conv_cat", 3, x, w3)


def probe_conv_9dot(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """x: [B,H,W,Cin]; w9: [9, Cin, Cout] -> [B,H,W,Cout]."""
    if _build.on_cpu(x, w9):
        return probe_conv_9dot_plain(x, w9)
    return _probe_conv("probe_conv_9dot", 1, x, w9)
