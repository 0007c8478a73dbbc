"""Multi-head self-attention through the hand-written CUDA kernel.

Counterparts of dfc_sa_unet_tpu/ops/pallas_attention.py::fused_mha (packed
qkv ``[B,N,3E]``) and ::fused_mha_sep (separate q, k, v ``[B,N,E]``); one
kernel, csrc/mha.cu, serves both: it takes three base pointers and a row
stride.  Per head: f32 scores (q k^T) * 1/sqrt(hd), max-subtracted softmax,
the probabilities rounded to v's dtype, P v accumulated in f32; the heads
land merged in ``[B,N,E]`` with no transpose on either side.

On CPU tensors the wrappers run the plain versions below (the math of
``_mha_sep_reference``, pallas_attention.py:188-210); on CUDA tensors they
launch a kernel or raise.  ``entry_point`` names the C function: in bf16 the
one-pass ``wgmma`` kernel up to ``WGMMA_TOKENS`` (every model of the factory:
ViT-B/16 at 224x224 has N = 196), the two-pass ``mma.sync`` kernel above; in
f32 the exact SIMT kernel.

Under autograd the forward still launches the kernel; the backward
recomputes through the plain version and returns its gradients
(``_build.PlainBackward``), as the JAX custom VJPs do
(pallas_attention.py:231-236, :287-293): the TPU package has no backward
kernel either.
"""

import torch

from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.ops.dropout import dropout

MAX_TOKENS = 1024
WGMMA_TOKENS = 256  # bf16 up to here: the one-pass wgmma kernel keeps a row tile's scores in registers
MAX_HEAD_DIM = 128  # and a multiple of 8: rows of a head are 16-byte aligned in bf16


def fused_mha_sep_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                        dropout_p: float = 0.0, generator=None) -> torch.Tensor:
    """q, k, v: [B,N,E] -> [B,N,E], through the [B,h,N,N] scores in f32.
    ``dropout_p`` > 0 drops attention weights (the training path the kernel
    does not cover), drawing from ``generator``."""
    b, n, e = q.shape
    hd = e // num_heads

    def heads(t):
        return t.reshape(b, n, num_heads, hd).transpose(1, 2).float()

    s = torch.matmul(heads(q), heads(k).transpose(2, 3)) / float(hd) ** 0.5
    attn = dropout(torch.softmax(s, dim=-1).to(q.dtype), dropout_p, True, generator)
    out = torch.matmul(attn.float(), heads(v)).to(q.dtype)
    return out.transpose(1, 2).reshape(b, n, e)


def fused_mha_plain(qkv: torch.Tensor, num_heads: int, dropout_p: float = 0.0, generator=None) -> torch.Tensor:
    """Packed qkv [B,N,3E] -> [B,N,E]."""
    q, k, v = qkv.chunk(3, dim=-1)
    return fused_mha_sep_plain(q, k, v, num_heads, dropout_p, generator)


def entry_point(dtype: torch.dtype, n: int) -> str:
    """The C function of csrc/mha.cu that computes a call of N tokens."""
    if dtype == torch.bfloat16:
        return "mha_wgmma_bf16" if n <= WGMMA_TOKENS else "mha_bf16"
    return "mha_f32"


def _launch(counter: str, operands, ptrs, row_stride: int, b: int, n: int, e: int, num_heads: int):
    """Check what the kernel takes, launch it once on ``ptrs`` and count it under ``counter``."""
    _build.check_operands(counter, operands)
    if num_heads < 1 or e % num_heads:
        raise ValueError(f"{counter}: E={e} is not a multiple of num_heads={num_heads}")
    hd = e // num_heads
    if n > MAX_TOKENS or hd > MAX_HEAD_DIM or hd % 8 or b > 65535:
        raise ValueError(f"{counter}: N={n} (max {MAX_TOKENS}), head_dim={hd} (a multiple of 8, max "
                         f"{MAX_HEAD_DIM}), B={b} (max 65535) not supported by the kernel")
    first = operands[0][1]
    out = torch.empty((b, n, e), dtype=first.dtype, device=first.device)
    if out.numel():
        _build.launch(entry_point(first.dtype, n), (counter,), first.device, *ptrs, out.data_ptr(), b, n, num_heads,
                      hd, row_stride)
    return out


def fused_mha(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Packed qkv [B,N,3E] -> merged heads [B,N,E]."""
    if _build.on_cpu(qkv):
        return fused_mha_plain(qkv, num_heads)
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_mha: qkv {tuple(qkv.shape)} is not [B,N,3E]")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _build.PlainBackward.apply(_launch_packed, fused_mha_plain, (num_heads,), qkv)
    return _launch_packed(qkv, num_heads)


def _launch_packed(qkv, num_heads):
    b, n, e3 = qkv.shape
    e = e3 // 3
    base, step = qkv.data_ptr(), e * qkv.element_size()
    return _launch("fused_mha", (("qkv", qkv, None),), (base, base + step, base + 2 * step), e3, b, n, e, num_heads)


def fused_mha_sep(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Separate q, k, v [B,N,E] -> merged heads [B,N,E]."""
    if _build.on_cpu(q, k, v):
        return fused_mha_sep_plain(q, k, v, num_heads)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_mha_sep: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _build.PlainBackward.apply(_launch_sep, fused_mha_sep_plain, (num_heads,), q, k, v)
    return _launch_sep(q, k, v, num_heads)


def _launch_sep(q, k, v, num_heads):
    b, n, e = q.shape
    return _launch("fused_mha_sep", (("q", q, None), ("k", k, None), ("v", v, None)),
                   (q.data_ptr(), k.data_ptr(), v.data_ptr()), e, b, n, e, num_heads)
