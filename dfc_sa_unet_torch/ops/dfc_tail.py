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
"""

from collections import namedtuple

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build

TAIL_CHANNELS = (32, 64, 128, 256, 512)  # C of the tail: one block holds all C
CONV_BLOCK_PIXELS = 128  # pixels a block of the bf16 conv's ring: wgconv::kBM of csrc/conv3x3_wgmma.cuh
NARROW_BLOCK_PIXELS = 64  # pixels a tile of its persistent kernel (Cin <= 8): wgconv::kNarrowBM
ConvTiling = namedtuple("ConvTiling", "cin steps nb bm stages smem_bytes")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

LAUNCHES = {"conv3x3_bn_relu": 0, "dfc_tail": 0}


def _conv3x3_f32(x: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """f32 3x3 conv, padding 1, of NHWC x with an HWIO kernel -> NHWC."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), wc.to(x.dtype).float().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_bn_relu_plain(x, w, b):
    """ReLU(conv3x3(x) + b), summed in f32, cast to x's dtype once."""
    return torch.relu(_conv3x3_f32(x, w) + b.float()).to(x.dtype)


def dfc_tail_plain(x, a, wc, bc, wg, bg, wf, bf, wr):
    """The TPU kernel's math (pallas_conv.py:156-194) with f32 sums: the
    gate and fusion products read `local` rounded to the activation dtype,
    the fusion itself reads it in f32."""
    dtype = a.dtype
    local_f = torch.relu(_conv3x3_f32(x, wc) + bc.float())
    local = local_f.to(dtype)
    g = torch.sigmoid(torch.cat([local, a], -1).float() @ wg.to(dtype).float() + bg.float())
    fused = (g * local_f + (1.0 - g) * a.float()).to(dtype)
    o = torch.relu(torch.cat([fused, local, a], -1).float() @ wf.to(dtype).float() + bf.float())
    o = o + x.float() @ wr.to(dtype).float()
    return o.to(dtype)


def pad_cin(x, wc, wr, multiple=8):
    """x, wc and wr with Cin zero-padded to a multiple of ``multiple``: the same tail (the
    added channels meet zero weights), with x's rows in whole 16-byte copies for the bf16
    kernel."""
    pad = -x.shape[-1] % multiple
    if not pad:
        return x, wc, wr
    return F.pad(x, (0, pad)), F.pad(wc, (0, 0, 0, pad)), F.pad(wr, (0, 0, 0, pad))


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
    pad = -w.shape[2] % 8
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
    return w.reshape(9 * w.shape[2], w.shape[3])


def _check(name, x, tensors, weights, biases):
    dev = x.device
    if x.dim() != 4:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}; the kernel takes NHWC")
    if dev.type != "cuda":
        raise ValueError(f"{name}: x is on {dev}; the kernel takes CUDA tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: activations are {x.dtype}; the kernel takes f32 or bf16")
    for label, t in {"x": x, **tensors, **weights, **biases}.items():
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")
        want = torch.float32 if label in biases else x.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {label} is {t.dtype}, must be {want}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *tensors.values(), *weights.values())):
        raise NotImplementedError(f"{name}: the kernel is inference-only (ROADMAP.md)")
    bsz, h, w, _ = x.shape
    if bsz * h * w >= 2**31:
        raise ValueError(f"{name}: {bsz * h * w} pixels exceed the kernel's int32 pixel index")


def conv3x3_bn_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: [B,H,W,Cin]; w: [3,3,Cin,Cout] (BN folded); b: [Cout] f32 -> [B,H,W,Cout]."""
    if x.device.type == "cpu" and w.device.type == "cpu" and b.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, w, b)
    _check("conv3x3_bn_relu", x, {}, {"w": w}, {"b": b})
    bsz, h, width, cin = x.shape
    cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, cin, cout) or tuple(b.shape) != (cout,):
        raise ValueError(f"conv3x3_bn_relu: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}")
    if cout % 8:
        raise ValueError(f"conv3x3_bn_relu: Cout={cout} not supported by the kernel (a multiple of 8)")
    out = torch.empty((bsz, h, width, cout), dtype=x.dtype, device=x.device)
    if out.numel():
        name = f"conv3x3_bn_relu_{_DTYPES[x.dtype]}"
        npix, stream = bsz * h * width, _build.stream_handle(x.device)
        if x.dtype == torch.bfloat16:  # the wgmma kernels: the flat K walk's weight, x with the channels they read
            t = conv_tiling(cin, cout)
            if t.cin != cin:
                x = F.pad(x, (0, t.cin - cin))
            wk = pack_conv_taps(w)
            err = _build.kernel(name)(x.data_ptr(), wk.data_ptr(), b.data_ptr(), out.data_ptr(), npix, h, width,
                                      t.cin, cout, t.nb, t.stages, stream)
        else:
            err = _build.kernel(name)(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), npix, h, width,
                                      cin, cout, stream)
        _build.check(err, name)
        LAUNCHES["conv3x3_bn_relu"] += 1
    return out


def dfc_tail(x, a, wc, bc, wg, bg, wf, bf, wr) -> torch.Tensor:
    """x: [B,H,W,Cin]; a: [B,H,W,C] -> [B,H,W,C] (see the module docstring)."""
    args = (x, a, wc, bc, wg, bg, wf, bf, wr)
    if all(t.device.type == "cpu" for t in args):
        return dfc_tail_plain(*args)
    _check("dfc_tail", x, {"a": a}, {"wc": wc, "wg": wg, "wf": wf, "wr": wr},
           {"bc": bc, "bg": bg, "bf": bf})
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
            cin = x.shape[-1]
            args = (x, a, wc, bc, wg, bg, wf, bf, wr)
        name = f"dfc_tail_{_DTYPES[x.dtype]}"
        err = _build.kernel(name)(*(t.data_ptr() for t in args), out.data_ptr(),
                                  bsz * h * width, h, width, cin, c, _build.stream_handle(x.device))
        _build.check(err, name)
        LAUNCHES["dfc_tail"] += 1
    return out
