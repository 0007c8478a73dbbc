"""The fused DFC block tail and its 3x3 conv, through hand-written CUDA kernels.

Counterparts of dfc_sa_unet_tpu/ops/pallas_conv.py::conv3x3_bn_relu and
::dfc_tail_from_x; both kernels are in csrc/dfc_tail.cu.  Each wrapper
runs its plain version on CPU tensors and launches its kernel (or raises)
on CUDA tensors.  Layout NHWC; weights in the JAX layout: wc [3,3,Cin,C]
(HWIO), wg [2C,C] ordered [local|a], wf [3C,C] ordered [fused|local|a],
wr [Cin,C] with res_scale folded in; weights in the activation dtype,
biases f32.  The kernels mask every image edge, so any H and W work; the
bf16 kernels take any Cin, which the wrappers zero-pad to a multiple of 8.
The bf16 conv walks K = 9 Cin8 flat in 64-deep steps (``conv_tiling``,
``pack_conv_taps``), so at down1's Cin = 3 a step packs eight taps, and reads
down1's 3-channel x as it is.

Row sharding (parallel/rows.py): both kernels, and their plain versions,
take two optional rows ``top`` and ``bottom`` ([B,W,Cin] in x's dtype), the
rows just above and below a band of the image, which the 3x3 taps in rows -1
and H read instead of zero; None is the image's edge.  ``a`` and the
residual's x are the band's own rows.  With either row the wrappers launch
the kernels' halo instantiations (``conv3x3_bn_relu_halo_*``,
``dfc_tail_halo_*``: the template flag ``dfc::HaloRows`` of csrc/common.cuh),
counted under the same names.  ``halo_rows``, ``pad_rows``, ``halo_ptrs`` and ``pad_dim`` serve
the int8 conv (ops/conv_s8.py) too.
"""

from collections import namedtuple

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build

TAIL_CHANNELS = (32, 64, 128, 256, 512)  # C of the tail: one block holds all C
CONV_BLOCK_PIXELS = 128  # pixels a block of the bf16 conv's ring: wgconv::kBM of csrc/conv3x3_wgmma.cuh
NARROW_BLOCK_PIXELS = 64  # pixels a tile of its persistent kernel (Cin <= 8): wgconv::kNarrowBM
ConvTiling = namedtuple("ConvTiling", "cin steps nb bm stages smem_bytes")


def _conv3x3_f32(x: torch.Tensor, wc: torch.Tensor, top=None, bottom=None) -> torch.Tensor:
    """f32 3x3 conv, padding 1, of NHWC x with an HWIO kernel -> NHWC; ``top`` and ``bottom``
    ([B,W,Cin] or None: zeros) are the rows above and below x."""
    k = wc.to(x.dtype).float().permute(3, 2, 0, 1)
    if top is None and bottom is None:
        y = F.conv2d(x.float().permute(0, 3, 1, 2), k, padding=1)
    else:
        edge = x.new_zeros(x.shape[0], 1, *x.shape[2:])
        rows = [edge if t is None else t.reshape(edge.shape) for t in (top, bottom)]
        y = F.conv2d(torch.cat([rows[0], x, rows[1]], 1).float().permute(0, 3, 1, 2), k, padding=(0, 1))
    return y.permute(0, 2, 3, 1)


def conv3x3_bn_relu_plain(x, w, b, top=None, bottom=None):
    """ReLU(conv3x3(x) + b), summed in f32, cast to x's dtype once."""
    return torch.relu(_conv3x3_f32(x, w, top, bottom) + b.float()).to(x.dtype)


def dfc_tail_plain(x, a, wc, bc, wg, bg, wf, bf, wr, top=None, bottom=None):
    """The TPU kernel's math (pallas_conv.py:156-194) with f32 sums: the
    gate and fusion products read `local` rounded to the activation dtype,
    the fusion itself reads it in f32."""
    dtype = a.dtype
    local_f = torch.relu(_conv3x3_f32(x, wc, top, bottom) + bc.float())
    local = local_f.to(dtype)
    g = torch.sigmoid(torch.cat([local, a], -1).float() @ wg.to(dtype).float() + bg.float())
    fused = (g * local_f + (1.0 - g) * a.float()).to(dtype)
    o = torch.relu(torch.cat([fused, local, a], -1).float() @ wf.to(dtype).float() + bf.float())
    o = o + x.float() @ wr.to(dtype).float()
    return o.to(dtype)


def pad_dim(t, dim, width):
    """t zero-padded at the end of dimension ``dim`` to ``width`` entries; t itself where it has them."""
    pad = width - t.shape[dim]
    return F.pad(t, (0, 0) * (t.dim() - 1 - dim % t.dim()) + (0, pad)) if pad else t


def pad_cin(x, wc, wr, multiple=8):
    """x, wc and wr with Cin zero-padded to a multiple of ``multiple``: the same tail (the
    added channels meet zero weights), with x's rows in whole 16-byte copies for the bf16
    kernel."""
    width = -(-x.shape[-1] // multiple) * multiple
    return pad_dim(x, -1, width), pad_dim(wc, 2, width), pad_dim(wr, 0, width)


def conv_tiling(cin: int, cout: int) -> ConvTiling:
    """The bf16 conv kernel's tiling (csrc/dfc_tail.cu::conv_wgmma_dispatch instantiates exactly
    these).  K is 9 taps of Cin8 rows (Cin zero-padded to a multiple of 8, ``pack_conv_taps``),
    walked in ``steps`` 64-deep steps (one tap a step where Cin is a multiple of 64, eight where it
    is 8); the B tile is ``nb`` columns wide from Cout; ``bm`` pixels a tile.  ``stages`` of the ring
    (128 pixels a block), or 0 for Cin <= 8 and Cout <= 64 (down1): the persistent kernel without a
    ring (64-pixel tiles, one warpgroup a block), which keeps the weight resident.  ``cin``: the channels of x the kernel reads, zero-padded to Cin8 by the
    wrapper, except 3 (RGB), which the persistent kernel reads as it is.  Dynamic shared memory: 1
    KB of alignment slack, then the ring (an A tile of 128 x 64 and a B tile of 64 x nb in bf16 and
    a TMA barrier a stage), or two A tiles, two 64 x 64 B tiles and the output tile (64 x 64
    bf16)."""
    cin_p = -(-cin // 8) * 8
    steps = -(-9 * cin_p // 64)
    nb = 64 if cout <= 64 else 128 if cout <= 128 else 256
    bm = CONV_BLOCK_PIXELS
    if cin_p == 8 and nb == 64:
        return ConvTiling(3 if cin == 3 else 8, steps, nb, NARROW_BLOCK_PIXELS, 0,
                          1024 + 3 * NARROW_BLOCK_PIXELS * 128 + 2 * 64 * 128)
    return ConvTiling(cin_p, steps, nb, bm, 4, 1024 + 4 * (bm * 128 + nb * 128 + 8))


def pack_conv_taps(w: torch.Tensor) -> torch.Tensor:
    """HWIO w [3,3,Cin,Cout] -> the bf16 conv kernel's weight [9 * Cin8, Cout], Cin zero-padded to
    Cin8, a multiple of 8: row tap * Cin8 + c is tap (dy+1)*3 + (dx+1), channel c, the order of
    the kernel's flat K walk (step s, 16-byte chunk q -> K row 64 s + 8 q)."""
    w = pad_dim(w, 2, -(-w.shape[2] // 8) * 8)
    return w.reshape(9 * w.shape[2], w.shape[3])


def halo_rows(name, x, top, bottom):
    """The halo rows given, {label: tensor} without the None ones, each of x's [B,W,Cin] shape (else
    ValueError)."""
    rows = {k: t for k, t in (("top", top), ("bottom", bottom)) if t is not None}
    for label, t in rows.items():
        if tuple(t.shape) != (x.shape[0], x.shape[2], x.shape[3]):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected {(x.shape[0], *x.shape[2:])}")
    return rows


def pad_rows(rows, width):
    """The halo rows with their channels zero-padded to ``width``, as x's are for the kernels."""
    return {k: pad_dim(t, -1, width) for k, t in rows.items()}


def halo_ptrs(rows):
    """The halo rows' device addresses as the halo kernels take them, top then bottom, None (a null
    pointer: the image's edge) for a missing one; ``()`` without a row (the plain kernels)."""
    if not rows:
        return ()
    return tuple(None if rows.get(k) is None else rows[k].data_ptr() for k in ("top", "bottom"))


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, top=None, bottom=None) -> torch.Tensor:
    """x: [B,H,W,Cin]; w: [3,3,Cin,Cout] (BN folded); b: [Cout] f32 -> [B,H,W,Cout]; ``top``,
    ``bottom``: the halo rows (see the module docstring)."""
    rows = halo_rows("conv3x3_bn_relu", x, top, bottom)
    if _build.on_cpu(x, w, b, top, bottom):
        return conv3x3_bn_relu_plain(x, w, b, top, bottom)
    _check("conv3x3_bn_relu", x, rows, (("w", w, None), ("b", b, torch.float32)), (w,))
    bsz, h, width, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, cin, cout) or tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3_bn_relu: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if cout % 8:
        raise ValueError(f"conv3x3_bn_relu: Cout={cout} not supported by the kernel (a multiple of 8)")
    out = torch.empty((bsz, h, width, cout), dtype=x.dtype, device=x.device)
    if out.numel():
        entry = f"conv3x3_bn_relu{'_halo' if rows else ''}_{_build.SUFFIX[x.dtype]}"
        if x.dtype == torch.bfloat16:  # the wgmma kernels: the flat K walk's weight, x with the channels they read
            t = conv_tiling(cin, cout)
            if t.cin != cin:
                x, rows = pad_dim(x, -1, t.cin), pad_rows(rows, t.cin)
            wk = pack_conv_taps(w)
            head, tail = (x.data_ptr(), wk.data_ptr(), b.data_ptr()), (t.cin, cout, t.nb, t.stages)
        else:
            head, tail = (x.data_ptr(), w.data_ptr(), b.data_ptr()), (cin, cout)
        _build.launch(entry, ("conv3x3_bn_relu",), x.device, *head, *halo_ptrs(rows), out.data_ptr(), bsz * h * width,
                      h, width, *tail)
    return out


def _check(name, x, rows, weights, no_grad):
    """The operand rules of both kernels: x NHWC, x, the halo rows and ``weights`` ((label, tensor,
    dtype), None: x's) on x's card, contiguous and 16-byte aligned; no gradient through x, the rows and
    ``no_grad``; the pixels within the kernels' int32 index."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}; the kernel takes NHWC")
    halo = tuple((k, t, None) for k, t in rows.items()) if rows else ()
    _build.check_operands(name, (("x", x, None), *halo, *weights), aligned=True,
                          no_grad=(x, *rows.values(), *no_grad))
    if x.shape[0] * x.shape[1] * x.shape[2] >= 2**31:
        raise ValueError(f"{name}: {x.shape[0] * x.shape[1] * x.shape[2]} pixels exceed the kernel's int32 pixel index")


def dfc_tail(x, a, wc, bc, wg, bg, wf, bf, wr, top=None, bottom=None) -> torch.Tensor:
    """x: [B,H,W,Cin]; a: [B,H,W,C] -> [B,H,W,C]; ``top``, ``bottom``: the halo rows of x (see the
    module docstring)."""
    args = (x, a, wc, bc, wg, bg, wf, bf, wr)
    rows = halo_rows("dfc_tail", x, top, bottom)
    if _build.on_cpu(*args, top, bottom):
        return dfc_tail_plain(*args, top, bottom)
    f32 = torch.float32
    _check("dfc_tail", x, rows, (("a", a, None), ("wc", wc, None), ("wg", wg, None), ("wf", wf, None),
                                 ("wr", wr, None), ("bc", bc, f32), ("bg", bg, f32), ("bf", bf, f32)),
           (a, wc, wg, wf, wr))
    bsz, h, width, cin = x.shape
    c = a.shape[-1]
    shapes = {"a": (a.shape, (bsz, h, width, c)), "wc": (wc.shape, (3, 3, cin, c)),
              "wg": (wg.shape, (2 * c, c)), "wf": (wf.shape, (3 * c, c)), "wr": (wr.shape, (cin, c)),
              "bc": (bc.shape, (c,)), "bg": (bg.shape, (c,)), "bf": (bf.shape, (c,))}
    for label, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"dfc_tail: {label} has shape {tuple(got)}, expected {want}")
    if c not in TAIL_CHANNELS:
        raise ValueError(f"dfc_tail: C={c} not supported by the kernel (one of {TAIL_CHANNELS})")
    out = torch.empty_like(a)
    if out.numel():
        if x.dtype == torch.bfloat16:  # the bf16 kernel copies x in 16-byte rows
            x, wc, wr = pad_cin(x, wc, wr)
            rows = pad_rows(rows, x.shape[-1])
            cin = x.shape[-1]
            args = (x, a, wc, bc, wg, bg, wf, bf, wr)
        entry = f"dfc_tail{'_halo' if rows else ''}_{_build.SUFFIX[x.dtype]}"
        _build.launch(entry, ("dfc_tail",), x.device, *(t.data_ptr() for t in args), *halo_ptrs(rows),
                      out.data_ptr(), bsz * h * width, h, width, cin, c)
    return out
