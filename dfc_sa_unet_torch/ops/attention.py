"""The pooled self-attention core in plain PyTorch: the oracle of the kernel.

Counterpart of dfc_sa_unet_tpu/ops/attention.py::pooled_self_attention
and the math of the TPU kernel _attn_kernel (pallas_attention.py:32-43):
unscaled energies q k^T (the reference model applies no 1/sqrt(d)), the
softmax in f32, P cast to v's dtype, then A v accumulated in f32 and cast
to v's dtype.  Layout NHWC, as in JAX: q, k [B,p,p,C'], v [B,p,p,C].  Under
a band of rows (the full-resolution attention, parallel/rows.py) q holds the
band's rows and k, v the whole image's: fewer queries than keys.

``full_res_self_attention`` is ablation 3's core over all H*W tokens
(dfc_sa_unet_tpu/ops/attention.py:41): the same contract and math.
"""

import torch


def pooled_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: [B,h,w,C'] (nq = h w queries); k: [B,p,q,C'] and v: [B,p,q,C] (nk = p q keys) ->
    [B,h,w,C]."""
    b, ph, pw, cq = q.shape
    c = v.shape[-1]
    nq, nk = ph * pw, k.shape[1] * k.shape[2]
    energy = torch.matmul(q.reshape(b, nq, cq).float(), k.reshape(b, nk, cq).float().transpose(1, 2))
    attn = torch.softmax(energy, dim=-1).to(v.dtype)
    out = torch.matmul(attn.float(), v.reshape(b, nk, c).float())
    return out.to(v.dtype).reshape(b, ph, pw, c)


def full_res_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over all spatial tokens (ablation 3); the contract of ``pooled_self_attention``."""
    return pooled_self_attention(q, k, v)
