"""Pooled self-attention through the hand-written CUDA kernel.

Counterpart of dfc_sa_unet_tpu/ops/pallas_attention.py::fused_pooled_attention;
the kernel is csrc/pooled_attention.cu.  On a CPU tensor the wrapper runs
the plain version (ops/attention.py::pooled_self_attention); on a CUDA
tensor it launches the kernel or raises.  Layout NHWC, as in JAX.
"""

import torch

from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.ops.attention import pooled_self_attention

MAX_TOKENS = 1024  # N = p*p; the energies of 16 query rows stay in shared memory
MAX_QK_CHANNELS = 256
_KERNELS = {torch.float32: "pooled_attention_f32", torch.bfloat16: "pooled_attention_bf16"}

LAUNCHES = {"pooled_attention": 0}

pooled_attention_plain = pooled_self_attention


def pooled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k: [B,p,p,C']; v: [B,p,p,C] -> [B,p,p,C]; softmax(q k^T) v, unscaled."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return pooled_attention_plain(q, k, v)
    b, ph, pw, cq = q.shape
    c = v.shape[-1]
    n = ph * pw
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"pooled_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype not in _KERNELS or t.dtype != v.dtype:
            raise TypeError(f"pooled_attention: {name} is {t.dtype}; takes q, k, v all f32 or all bf16")
        if not t.is_contiguous():
            raise ValueError(f"pooled_attention: {name} must be a contiguous NHWC tensor")
    if k.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"pooled_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if n > MAX_TOKENS or cq > MAX_QK_CHANNELS or b > 65535:
        raise ValueError(f"pooled_attention: N={n} (max {MAX_TOKENS}), C'={cq} (max "
                         f"{MAX_QK_CHANNELS}), B={b} (max 65535) not supported by the kernel")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("pooled_attention: the kernel has no backward yet (ROADMAP.md)")
    out = torch.empty_like(v)
    if out.numel():
        name = _KERNELS[v.dtype]
        err = _build.kernel(name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  b, n, cq, c, _build.stream_handle(q.device))
        _build.check(err, name)
        LAUNCHES["pooled_attention"] += 1
    return out
