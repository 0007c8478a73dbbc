"""Pooled self-attention through the hand-written CUDA kernels.

Counterpart of dfc_sa_unet_tpu/ops/pallas_attention.py::fused_pooled_attention;
the kernels are in csrc/pooled_attention.cu.  On a CPU tensor the wrapper
runs the plain version (ops/attention.py::pooled_self_attention); on a CUDA
tensor it launches a kernel or raises.  Layout NHWC, as in JAX.

``entry_point`` names the kernel of a call.  bf16, every N = p*p up to
``MAX_TOKENS``: one Hopper kernel (``wgmma`` for both products; q, K and V
fed by TMA from a producer warpgroup; consumer warpgroups whose exponentials
run while the tensor cores take their products and the other warpgroups';
an online softmax over chunks of 128 keys, 64 where C' > 64).  It rounds the
probabilities, unnormalised and relative to a reference row maximum, to bf16
and divides the f32 sum by the row sum once at the end, where the reference
rounds the normalised ones: the two differ by bf16 roundings only.  TMA reads
rows whose stride is a multiple of 16 bytes, so the wrapper zero-pads q and k
(and v, whose extra output columns it drops) to a multiple of 8 channels
where a call has another width, and copies a tensor that does not start
16-byte aligned (``tma_rows``).  At the full-resolution model's first level
(N = 4096, C' = 8) the exponentials bound it, at the flagship's N = 64 the
bytes.  f32, the parity path: two SIMT
kernels, the 16-row kernel that keeps its energies in shared memory up to
``SHORT_TOKENS`` and the two-pass kernel above.  All count under
``ops.launches()["pooled_attention"]``, one per call.  Above ``MAX_TOKENS`` (the
full-resolution attention of a 64x64 image, the TPU kernel's own limit,
blocks.py:58) the wrapper raises: the plain version would hold B*N*N f32
energies in device memory.

Queries and keys may differ in number.  Under a band of rows the
full-resolution attention (parallel/rows.py) takes the band's queries
against the whole image's keys and values (fewer queries than keys);
SegFormer's spatial-reduction attention (models/segformer.py) takes every
pixel's query against the keys of a map its reduction conv cut down (more
queries than keys, up to 64 times as many at its first stage).  The tiles
walk the ``nq`` queries, the key loops the ``nk`` keys; ``entry_point``,
``MAX_TOKENS`` and the bf16 kernel's chunks go by ``nk``, so a query's row is
the same bits in a band as in the whole map.  A launch with fewer queries
than keys also counts under ``pooled_attention.fewer_queries``, one with more
under ``pooled_attention.more_queries``.

Heads (``heads`` > 1, SegFormer): q and k hold ``heads`` heads of C' channels
side by side in each row, v ``heads`` heads of C, and the output the heads'
results in the same order, as the model's linear layers lay them out.  The
kernels read each head's channels where they lie: k and v may be the two
halves of one projection (views whose rows lie twice their width apart);
nothing is permuted or copied unless TMA cannot read a tensor as it is
(``tma_rows``).  Token tensors ``[B,N,*]`` are taken beside NHWC maps.

Decomposed relative-position bias (``rel_h``, ``rel_w``: SAM's image encoder, models/sam.py): keys
lie on a ``kh`` x ``kw`` grid (``nk = kh kw``, key j at row j // kw, column j % kw), and each energy
takes the bias of its query and its key's row and column, ``e[i, j] = (q_i . k_j + rel_h[i, j //
kw]) + rel_w[i, j % kw]``, in f32 and in that order, before the softmax.  The tables are [B, nq,
heads, kh] and [B, nq, heads, kw] in q's dtype (any layout; the card reads dense copies), one row a
query and head; no nq x nk tensor is made on the card.  On the card only the bf16 kernel takes them
(its ``relpos`` instantiation: heads of at most 64 channels of q and of v, kh and kw at most 64, kw
even); an f32 call or another shape with tables raises ValueError.  Such a launch also counts under
``pooled_attention.rel_pos``.

Under autograd the forward still launches the kernel; the backward
recomputes through the plain version and returns its gradients
(``_build.PlainBackward``; the tables' too), which is what the JAX custom VJP does
(pallas_attention.py:98-106): the TPU package has no backward kernel either.
"""

import math

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.ops.attention import pooled_self_attention

SHORT_TOKENS = 128  # f32: N = p*p up to which the 16-row kernel is launched (it takes N <= 1024)
MAX_TOKENS = 4096
MAX_QK_CHANNELS = 256
MAX_REL_CHANNELS = 64  # with tables: C' and C of a head, at most (the kernel's relpos instantiations)
MAX_REL_SIDE = 64  # with tables: kh and kw, at most (a query row's tables staged in 256 bytes of shared memory)
# the names a launch counts under, by the sign of nq - nk
_COUNTED = {0: ("pooled_attention",), -1: ("pooled_attention", "pooled_attention.fewer_queries"),
            1: ("pooled_attention", "pooled_attention.more_queries")}
REL_COUNTED = "pooled_attention.rel_pos"


def pooled_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int = 1, rel_h=None,
                           rel_w=None) -> torch.Tensor:
    """The plain version of ``pooled_attention``: ``pooled_self_attention`` of each head, or with tables
    its math with the bias added to the f32 energies, rel_h first."""

    def split(t):  # [B, *rows, heads x ch] -> [B heads, rows, 1, ch]
        return t.reshape(t.shape[0], -1, heads, t.shape[-1] // heads).transpose(1, 2).flatten(0, 1).unsqueeze(2)

    if rel_h is None:
        out = pooled_self_attention(split(q), split(k), split(v))  # [B heads, nq, 1, C]
    else:
        qh, kh, vh = (split(t).squeeze(2).float() for t in (q, k, v))
        e = torch.matmul(qh, kh.transpose(1, 2))  # [B heads, nq, nk]
        th, tw = (t.transpose(1, 2).flatten(0, 1).float() for t in (rel_h, rel_w))  # [B heads, nq, kh], [.., kw]
        e = ((e.unflatten(-1, (th.shape[-1], tw.shape[-1])) + th[..., :, None]) + tw[..., None, :]).flatten(-2)
        out = torch.matmul(torch.softmax(e, dim=-1).to(v.dtype).float(), vh).to(v.dtype).unsqueeze(2)
    return out.reshape(q.shape[0], heads, -1, out.shape[-1]).transpose(1, 2).reshape(*q.shape[:-1], v.shape[-1])


def _check_tables(q, k, heads, rel_h, rel_w):
    """Raise unless ``rel_h`` and ``rel_w`` are both given or both None and, given, are [B, nq, heads, kh] and
    [B, nq, heads, kw] tables with kh kw = nk; returns (kh, kw), or None without tables."""
    if rel_h is None and rel_w is None:
        return None
    if rel_h is None or rel_w is None:
        raise ValueError("pooled_attention: rel_h and rel_w are given together")
    b, nq, nk = q.shape[0], math.prod(q.shape[1:-1]), math.prod(k.shape[1:-1])
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    if rel_h.shape != (b, nq, heads, kh) or rel_w.shape != (b, nq, heads, kw) or kh * kw != nk:
        raise ValueError(f"pooled_attention: tables rel_h {tuple(rel_h.shape)}, rel_w {tuple(rel_w.shape)} for "
                         f"{b} images, {nq} queries, {heads} heads and {nk} keys (kh x kw = nk)")
    return kh, kw


def tensors_first(fn, heads):
    """``fn(q, k, v, heads, rel_h, rel_w)`` as ``_build.PlainBackward`` calls it: on q, k, v and any tables."""
    return lambda q, k, v, *tables: fn(q, k, v, heads, *tables)


def pooled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int = 1, rel_h=None,
                     rel_w=None) -> torch.Tensor:
    """q: [B,h,w,heads C'] or [B,nq,heads C'] (nq queries); k: [B,p,q,heads C'] or [B,nk,heads C'], v: the
    same with heads C channels (nk keys) -> q's shape with heads C channels; softmax(q k^T) v of each head,
    unscaled, with the decomposed bias of ``rel_h`` [B,nq,heads,kh] and ``rel_w`` [B,nq,heads,kw] added to
    the energies where they are given (nk = kh kw).  Each tensor's channels are adjacent and its rows evenly
    apart (k and v may be views of one projection's halves)."""
    tables = _check_tables(q, k, heads, rel_h, rel_w)
    if _build.on_cpu(q, k, v, rel_h, rel_w):
        return pooled_attention_plain(q, k, v, heads, rel_h, rel_w)
    operands = (("q", q, None), ("k", k, None), ("v", v, None))
    if tables is not None:
        operands += (("rel_h", rel_h, None), ("rel_w", rel_w, None))
    _build.check_operands("pooled_attention", operands, contiguous=False)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() not in (3, 4) or t.dim() != q.dim():
            raise ValueError(f"pooled_attention: {name} must be an NHWC map or [B,N,*] tokens, not {tuple(t.shape)}")
    b, cq, n = q.shape[0], q.shape[-1] // max(heads, 1), math.prod(k.shape[1:-1])
    if (heads < 1 or q.shape[-1] % heads or v.shape[-1] % heads or k.shape[0] != b or k.shape[-1] != q.shape[-1]
            or v.shape[:-1] != k.shape[:-1]):
        raise ValueError(f"pooled_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"with {heads} heads")
    if n > MAX_TOKENS or cq > MAX_QK_CHANNELS or b * heads > 65535:
        raise ValueError(f"pooled_attention: N={n} (max {MAX_TOKENS}), C'={cq} (max "
                         f"{MAX_QK_CHANNELS}), B x heads={b * heads} (max 65535) not supported by the kernel")
    if tables is not None:
        kh, kw = tables
        c = v.shape[-1] // heads
        if q.dtype != torch.bfloat16 or cq > MAX_REL_CHANNELS or c > MAX_REL_CHANNELS or kh > MAX_REL_SIDE \
                or kw > MAX_REL_SIDE or kw % 2:
            raise ValueError(f"pooled_attention: tables take the bf16 kernel with C' and C <= {MAX_REL_CHANNELS} "
                             f"and an even kw, kh and kw <= {MAX_REL_SIDE}; not {q.dtype}, C'={cq}, C={c}, "
                             f"kh={kh}, kw={kw}")
    tensors = (q, k, v) if tables is None else (q, k, v, rel_h, rel_w)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _build.PlainBackward.apply(tensors_first(_launch, heads), tensors_first(pooled_attention_plain, heads),
                                          (), *tensors)
    return _launch(q, k, v, heads, rel_h, rel_w)


def _rows(t: torch.Tensor):
    """The stride between ``t``'s rows (the channels of a pixel or a token), where ``t`` is [B, rows,
    channels] with its channels adjacent, its rows evenly apart and its images one after the other; else
    None."""
    if t.is_contiguous():
        return t.shape[-1]
    n = math.prod(t.shape[1:-1])
    try:
        r = t.view(t.shape[0], n, t.shape[-1])
    except RuntimeError:
        return None
    row = r.stride(1) if n > 1 else r.stride(0) if t.shape[0] > 1 else t.shape[-1]
    ok = (r.stride(2) == 1 or t.shape[-1] == 1) and (t.shape[0] == 1 or r.stride(0) == n * row)
    return row if ok and row >= t.shape[-1] else None


def entry_point(dtype: torch.dtype, n: int, tables: bool = False) -> str:
    """The C function of csrc/pooled_attention.cu that computes a call of N keys, with relative-position
    tables where ``tables`` (bf16 only)."""
    if tables:
        if dtype != torch.bfloat16:
            raise ValueError(f"pooled_attention: tables take the bf16 kernel, not {dtype}")
        return "pooled_attention_relpos_bf16"
    if dtype == torch.bfloat16:
        return "pooled_attention_wgmma_bf16"
    return f"pooled_attention_{'long_' if n > SHORT_TOKENS else ''}{_build.SUFFIX[dtype]}"


def tma_rows(t: torch.Tensor, heads: int = 1, row=None) -> torch.Tensor:
    """``t`` itself where TMA can read its rows (each head's channels a multiple of 8, rows a multiple of 8
    elements apart, ``row`` where the caller has it, the start 16-byte aligned), else a dense copy with
    each head's channels zero-padded to a multiple of 8."""
    ch = t.shape[-1] // heads
    pad = -ch % 8
    if pad == 0 and t.data_ptr() % 16 == 0 and (_rows(t) if row is None else row) % 8 == 0:
        return t
    if pad == 0:
        return t.clone(memory_format=torch.contiguous_format)
    return F.pad(t.unflatten(-1, (heads, ch)), (0, pad)).flatten(-2)


def _launch(q, k, v, heads, rel_h=None, rel_w=None):
    """One launch on checked CUDA tensors, with the relative-position tables where they are given."""
    b, c = q.shape[0], v.shape[-1] // heads
    nq, nk = math.prod(q.shape[1:-1]), math.prod(k.shape[1:-1])
    tensors, rows = [], []
    for name, t in (("q", q), ("k", k), ("v", v)):
        row = _rows(t)
        if row is None:
            raise ValueError(f"pooled_attention: {name}'s channels must be adjacent and its rows evenly apart, "
                             f"not shape {tuple(t.shape)} strides {t.stride()}")
        if t.dtype == torch.bfloat16:  # zero channels add nothing to q k^T; v's extra columns are dropped
            padded = tma_rows(t, heads, row)
            t, row = padded, (row if padded is t else padded.shape[-1])
        tensors.append(t)
        rows.append(row)
    q, k, v = tensors
    cq, cv = q.shape[-1] // heads, v.shape[-1] // heads
    out = torch.empty((*q.shape[:-1], heads * cv), dtype=v.dtype, device=v.device)
    counted = _COUNTED[(nq > nk) - (nq < nk)]
    if out.numel() and rel_h is None:
        _build.launch(entry_point(v.dtype, nk), counted, q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, heads, nq, nk, cq, cv, *rows)
    elif out.numel():
        rel_h, rel_w = (t.contiguous() for t in (rel_h, rel_w))
        rel_h, rel_w = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (rel_h, rel_w))  # 4-byte loads
        _build.launch(entry_point(v.dtype, nk, True), counted + (REL_COUNTED,), q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), b, heads, nq, nk, cq, cv,
                      *rows, rel_h.shape[-1], rel_w.shape[-1])
    if cv == c:
        return out
    return out.unflatten(-1, (heads, cv))[..., :c].flatten(-2)
