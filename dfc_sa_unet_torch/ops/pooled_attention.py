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
``LAUNCHES["pooled_attention"]``, one per call.  Above ``MAX_TOKENS`` (the
full-resolution attention of a 64x64 image, the TPU kernel's own limit,
blocks.py:58) the wrapper raises: the plain version would hold B*N*N f32
energies in device memory.

Queries and keys may differ in number: under a band of rows the
full-resolution attention (parallel/rows.py) takes the band's queries
against the whole image's keys and values.  The tiles walk the ``nq``
queries, the key loops the ``nk`` keys; ``entry_point``, ``MAX_TOKENS`` and
the bf16 kernel's chunks go by ``nk``, so a query's row is the same bits in a
band as in the whole map.  Every launch counts under ``LAUNCHES``; one with fewer
queries than keys also under ``FEWER_QUERIES``.

Under autograd the forward still launches the kernel; the backward
recomputes through the plain version and returns its gradients, which is
what the JAX custom VJP does (pallas_attention.py:98-106): the TPU package
has no backward kernel either.
"""

import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.ops.attention import pooled_self_attention

SHORT_TOKENS = 128  # f32: N = p*p up to which the 16-row kernel is launched (it takes N <= 1024)
MAX_TOKENS = 4096
MAX_QK_CHANNELS = 256
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

LAUNCHES = {"pooled_attention": 0}
FEWER_QUERIES = {"pooled_attention": 0}  # the launches above with nq < nk (a band's queries)

pooled_attention_plain = pooled_self_attention


def pooled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: [B,h,w,C'] (nq queries); k: [B,p,q,C'], v: [B,p,q,C] (nk keys) -> [B,h,w,C]; softmax(q k^T)
    v, unscaled."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return pooled_attention_plain(q, k, v)
    b, ph, pw, cq = q.shape
    c = v.shape[-1]
    n = k.shape[1] * k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"pooled_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES or t.dtype != v.dtype:
            raise TypeError(f"pooled_attention: {name} is {t.dtype}; takes q, k, v all f32 or all bf16")
        if not t.is_contiguous():
            raise ValueError(f"pooled_attention: {name} must be a contiguous NHWC tensor")
    if k.shape[0] != b or k.shape[3] != cq or v.shape[:3] != k.shape[:3] or ph * pw > n:
        raise ValueError(f"pooled_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if n > MAX_TOKENS or cq > MAX_QK_CHANNELS or b > 65535:
        raise ValueError(f"pooled_attention: N={n} (max {MAX_TOKENS}), C'={cq} (max "
                         f"{MAX_QK_CHANNELS}), B={b} (max 65535) not supported by the kernel")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _PooledAttention.apply(q, k, v)
    return _launch(q, k, v)


def entry_point(dtype: torch.dtype, n: int) -> str:
    """The C function of csrc/pooled_attention.cu that computes a call of N keys."""
    if dtype == torch.bfloat16:
        return "pooled_attention_wgmma_bf16"
    return f"pooled_attention_{'long_' if n > SHORT_TOKENS else ''}{_DTYPES[dtype]}"


def tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where TMA can read its rows (channels a multiple of 8, the start 16-byte aligned), else
    a copy with its channels zero-padded to a multiple of 8."""
    pad = -t.shape[-1] % 8
    if pad == 0 and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, pad)) if pad else t.clone()


def _launch(q, k, v):
    """One launch on checked, contiguous CUDA tensors."""
    b, ph, pw, _ = q.shape
    c, nq, nk = v.shape[-1], ph * pw, k.shape[1] * k.shape[2]
    if v.dtype == torch.bfloat16:  # zero channels add nothing to q k^T; v's extra columns are dropped
        q, k, v = tma_rows(q), tma_rows(k), tma_rows(v)
    cq, cv = q.shape[-1], v.shape[-1]
    out = torch.empty((b, ph, pw, cv), dtype=v.dtype, device=v.device)
    if out.numel():
        name = entry_point(v.dtype, nk)
        err = _build.kernel(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  b, nq, nk, cq, cv, _build.stream_handle(q.device))
        _build.check(err, name)
        LAUNCHES["pooled_attention"] += 1
        FEWER_QUERIES["pooled_attention"] += nq < nk
    return out if cv == c else out[..., :c].contiguous()


def plain_vjp(plain, inputs, grad_out):
    """Gradients of ``plain(*inputs)`` w.r.t. the inputs that need one, for
    the backward of a kernel's autograd.Function: the forward is recomputed
    through the plain version on detached copies, so nothing but the inputs
    was saved.  Gradients come back contiguous, in the inputs' layout."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(t.requires_grad) for t in inputs]
        out = plain(*leaves)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return tuple(next(grads).contiguous() if t.requires_grad else None for t in leaves)


class _PooledAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        return plain_vjp(pooled_attention_plain, ctx.saved_tensors, grad_out)
