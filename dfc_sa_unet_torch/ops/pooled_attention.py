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

Under autograd the forward still launches the kernel; the backward
recomputes through the plain version and returns its gradients
(``_build.PlainBackward``), which is what the JAX custom VJP does
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
# the names a launch counts under, by the sign of nq - nk
_COUNTED = {0: ("pooled_attention",), -1: ("pooled_attention", "pooled_attention.fewer_queries"),
            1: ("pooled_attention", "pooled_attention.more_queries")}


def pooled_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int = 1) -> torch.Tensor:
    """The plain version of ``pooled_attention``: ``pooled_self_attention`` of each head."""

    def split(t):  # [B, *rows, heads x ch] -> [B heads, rows, 1, ch]
        return t.reshape(t.shape[0], -1, heads, t.shape[-1] // heads).transpose(1, 2).flatten(0, 1).unsqueeze(2)

    out = pooled_self_attention(split(q), split(k), split(v))  # [B heads, nq, 1, C]
    return out.reshape(q.shape[0], heads, -1, out.shape[-1]).transpose(1, 2).reshape(*q.shape[:-1], v.shape[-1])


def pooled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int = 1) -> torch.Tensor:
    """q: [B,h,w,heads C'] or [B,nq,heads C'] (nq queries); k: [B,p,q,heads C'] or [B,nk,heads C'], v: the
    same with heads C channels (nk keys) -> q's shape with heads C channels; softmax(q k^T) v of each head,
    unscaled.  Each tensor's channels are adjacent and its rows evenly apart (k and v may be views of one
    projection's halves)."""
    if _build.on_cpu(q, k, v):
        return pooled_attention_plain(q, k, v, heads)
    _build.check_operands("pooled_attention", (("q", q, None), ("k", k, None), ("v", v, None)), contiguous=False)
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _build.PlainBackward.apply(_launch, pooled_attention_plain, (heads,), q, k, v)
    return _launch(q, k, v, heads)


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


def entry_point(dtype: torch.dtype, n: int) -> str:
    """The C function of csrc/pooled_attention.cu that computes a call of N keys."""
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


def _launch(q, k, v, heads):
    """One launch on checked CUDA tensors."""
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
    if out.numel():
        _build.launch(entry_point(v.dtype, nk), _COUNTED[(nq > nk) - (nq < nk)], q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, heads, nq, nk, cq, cv, *rows)
    if cv == c:
        return out
    return out.unflatten(-1, (heads, cv))[..., :c].flatten(-2)
