"""The pooled attention's epilogue through one hand-written CUDA kernel (csrc/lsa_epilogue.cu).

After the attention over the p x p pooled map, the serving engine (infer/engine.py::_lsa) resizes
its output o to the block's H x W and adds it, scaled by gamma, to the attention branch's input a:

    out = (gamma * bilinear(o).float() + a.float()).to(a.dtype)

The kernel reads a once, writes out once and reads o's taps from the caches; its plain version is
that torch expression, with the upsample rounded to a's dtype as torch's upsample does.  No TPU
kernel corresponds: XLA fuses the chain there.  Layout NHWC; a and o of one dtype (f32 or bf16),
gamma an f32 scalar tensor.  Inference only, as the tail kernel: the module path
(models/blocks.py::LightSelfAttention) keeps its torch ops and their autograd.

Under a band of rows (parallel/rows.py) ``height`` and ``row0`` are the whole image's height and
the band's first row: the result is the band's rows of the whole image's epilogue.  Without a band
``height`` is a's H and ``row0`` 0.  Every launch counts under ``LAUNCHES``.
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

LAUNCHES = {"lsa_epilogue": 0}


def _band(a, height, row0):
    """(the image's height, the band's first row), checked against a's rows."""
    h = a.shape[1]
    height = h if height is None else int(height)
    row0 = int(row0)
    if not 0 <= row0 <= height - h:
        raise ValueError(f"lsa_epilogue: rows {row0}..{row0 + h - 1} do not lie in an image of {height} rows")
    return height, row0


def lsa_epilogue_plain(a, o, gamma, height=None, row0=0):
    """a: [B,H,W,C]; o: [B,p,q,C] -> [B,H,W,C]: o resized to height x W (torch's bilinear,
    align_corners False, in o's dtype), rows row0 .. row0 + H - 1 of it, times gamma, plus a, in f32,
    rounded to a's dtype once."""
    h, w = a.shape[1:3]
    height, row0 = _band(a, height, row0)
    up = o.permute(0, 3, 1, 2)
    if tuple(up.shape[2:]) != (height, w):
        up = F.interpolate(up, size=(height, w), mode="bilinear", align_corners=False)
    up = up[:, :, row0:row0 + h]
    out = (gamma * up.float() + a.permute(0, 3, 1, 2).float()).to(a.dtype)
    return out.permute(0, 2, 3, 1).contiguous()


def lsa_epilogue(a: torch.Tensor, o: torch.Tensor, gamma: torch.Tensor, height=None, row0=0) -> torch.Tensor:
    """a: [B,H,W,C]; o: [B,p,q,C] in a's dtype; gamma: f32, one element -> [B,H,W,C] in a's dtype;
    ``height``, ``row0``: the band (see the module docstring)."""
    if all(t.device.type == "cpu" for t in (a, o, gamma)):
        return lsa_epilogue_plain(a, o, gamma, height, row0)
    if a.dim() != 4 or o.dim() != 4:
        raise ValueError(f"lsa_epilogue: a {tuple(a.shape)} and o {tuple(o.shape)} must be NHWC")
    if a.device.type != "cuda":
        raise ValueError(f"lsa_epilogue: a is on {a.device}; the kernel takes CUDA tensors")
    for label, t in (("o", o), ("gamma", gamma)):
        if t.device != a.device:
            raise ValueError(f"lsa_epilogue: {label} is on {t.device}, a on {a.device}")
    if a.dtype not in _DTYPES or o.dtype != a.dtype:
        raise TypeError(f"lsa_epilogue: a is {a.dtype}, o {o.dtype}; the kernel takes both f32 or both bf16")
    if gamma.dtype != torch.float32 or gamma.numel() != 1:
        raise TypeError(f"lsa_epilogue: gamma is {gamma.dtype} of {gamma.numel()} elements; takes one f32")
    for label, t in (("a", a), ("o", o)):
        if not t.is_contiguous():
            raise ValueError(f"lsa_epilogue: {label} must be a contiguous NHWC tensor")
    bsz, h, w, c = a.shape
    if o.shape[0] != bsz or o.shape[3] != c or min(o.shape[1:3]) < 1:
        raise ValueError(f"lsa_epilogue: o has shape {tuple(o.shape)}, a {tuple(a.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, o, gamma)):
        raise NotImplementedError("lsa_epilogue: the kernel is inference-only (ROADMAP.md)")
    height, row0 = _band(a, height, row0)
    if bsz * h >= 2**31 or w * c >= 2**31:
        raise ValueError(f"lsa_epilogue: {bsz * h} rows of {w * c} elements exceed the kernel's int32 indices")
    out = torch.empty_like(a)
    if out.numel():
        name = f"lsa_epilogue_{_DTYPES[a.dtype]}"
        err = _build.kernel(name)(a.data_ptr(), o.data_ptr(), gamma.data_ptr(), out.data_ptr(), bsz, h, w, c,
                                  o.shape[1], o.shape[2], height, row0, _build.stream_handle(a.device))
        _build.check(err, name)
        LAUNCHES["lsa_epilogue"] += 1
    return out
