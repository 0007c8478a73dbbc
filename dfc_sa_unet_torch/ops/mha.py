"""Multi-head self-attention through the hand-written CUDA kernel.

Counterparts of dfc_sa_unet_tpu/ops/pallas_attention.py::fused_mha (packed
qkv ``[B,N,3E]``) and ::fused_mha_sep (separate q, k, v ``[B,N,E]``); one
kernel, csrc/mha.cu, serves both: it takes three base pointers and a row
stride.  Per head: f32 scores (q k^T) * 1/sqrt(hd), max-subtracted softmax,
the probabilities rounded to v's dtype, P v accumulated in f32; the heads
land merged in ``[B,N,E]`` with no transpose on either side.

On CPU tensors the wrappers run the plain versions below (the math of
``_mha_sep_reference``, pallas_attention.py:188-210); on CUDA tensors they
launch the kernel or raise.

Under autograd the forward still launches the kernel; the backward
recomputes through the plain version and returns its gradients, as the JAX
custom VJPs do (pallas_attention.py:231-236, :287-293): the TPU package has
no backward kernel either.
"""

import torch

from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.ops.dropout import dropout
from dfc_sa_unet_torch.ops.pooled_attention import plain_vjp

MAX_TOKENS = 1024
MAX_HEAD_DIM = 128  # and a multiple of 8: rows of a head are 16-byte aligned in bf16
_KERNELS = {torch.float32: "mha_f32", torch.bfloat16: "mha_bf16"}

LAUNCHES = {"fused_mha": 0, "fused_mha_sep": 0}


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


def _launch(counter: str, tensors, ptrs, row_stride: int, b: int, n: int, e: int, num_heads: int):
    """Check what the kernel takes, launch it once on ``ptrs`` and count it."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{counter}: tensors on {t.device} and {first.device}; takes CUDA tensors of one device")
        if t.dtype not in _KERNELS or t.dtype != first.dtype:
            raise TypeError(f"{counter}: got {t.dtype}; takes tensors all f32 or all bf16")
        if not t.is_contiguous():
            raise ValueError(f"{counter}: takes contiguous [B,N,*] tensors")
    if num_heads < 1 or e % num_heads:
        raise ValueError(f"{counter}: E={e} is not a multiple of num_heads={num_heads}")
    hd = e // num_heads
    if n > MAX_TOKENS or hd > MAX_HEAD_DIM or hd % 8 or b > 65535:
        raise ValueError(f"{counter}: N={n} (max {MAX_TOKENS}), head_dim={hd} (a multiple of 8, max "
                         f"{MAX_HEAD_DIM}), B={b} (max 65535) not supported by the kernel")
    out = torch.empty((b, n, e), dtype=first.dtype, device=first.device)
    if out.numel():
        name = _KERNELS[first.dtype]
        err = _build.kernel(name)(*ptrs, out.data_ptr(), b, n, num_heads, hd, row_stride,
                                  _build.stream_handle(first.device))
        _build.check(err, name)
        LAUNCHES[counter] += 1
    return out


def fused_mha(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Packed qkv [B,N,3E] -> merged heads [B,N,E]."""
    if qkv.device.type == "cpu":
        return fused_mha_plain(qkv, num_heads)
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_mha: qkv {tuple(qkv.shape)} is not [B,N,3E]")
    b, n, e3 = qkv.shape
    e = e3 // 3
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedMha.apply(qkv, num_heads)
    return _launch_packed(qkv, num_heads)


def _launch_packed(qkv, num_heads):
    b, n, e3 = qkv.shape
    e = e3 // 3
    base, step = qkv.data_ptr(), e * qkv.element_size()
    return _launch("fused_mha", (qkv,), (base, base + step, base + 2 * step), e3, b, n, e, num_heads)


def fused_mha_sep(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Separate q, k, v [B,N,E] -> merged heads [B,N,E]."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return fused_mha_sep_plain(q, k, v, num_heads)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_mha_sep: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedMhaSep.apply(q, k, v, num_heads)
    return _launch_sep(q, k, v, num_heads)


def _launch_sep(q, k, v, num_heads):
    b, n, e = q.shape
    return _launch("fused_mha_sep", (q, k, v), (q.data_ptr(), k.data_ptr(), v.data_ptr()), e, b, n, e,
                   num_heads)


class _FusedMha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _launch_packed(qkv, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        return (*plain_vjp(lambda t: fused_mha_plain(t, ctx.num_heads), ctx.saved_tensors, grad_out), None)


class _FusedMhaSep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return _launch_sep(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        return (*plain_vjp(lambda a, b, c: fused_mha_sep_plain(a, b, c, ctx.num_heads), ctx.saved_tensors,
                           grad_out), None)
