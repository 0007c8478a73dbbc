"""The pooled self-attention core in plain PyTorch: the oracle of the kernel.

Counterpart of dfc_sa_unet_tpu/ops/attention.py::pooled_self_attention
and the math of the TPU kernel _attn_kernel (pallas_attention.py:32-43):
unscaled energies q k^T (the reference model applies no 1/sqrt(d)), the
softmax in f32, P cast to v's dtype, then A v accumulated in f32 and cast
to v's dtype.  Layout NHWC, as in JAX: q, k [B,p,p,C'], v [B,p,p,C].
"""

import torch


def pooled_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k: [B,p,p,C']; v: [B,p,p,C] -> [B,p,p,C]."""
    b, ph, pw, cq = q.shape
    c = v.shape[-1]
    n = ph * pw
    energy = torch.matmul(q.reshape(b, n, cq).float(), k.reshape(b, n, cq).float().transpose(1, 2))
    attn = torch.softmax(energy, dim=-1).to(v.dtype)
    out = torch.matmul(attn.float(), v.reshape(b, n, c).float())
    return out.to(v.dtype).reshape(b, ph, pw, c)
