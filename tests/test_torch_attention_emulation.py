"""The bf16 pooled-attention kernel's order of arithmetic, emulated in PyTorch on the CPU.

csrc/pooled_attention.cu (pooled_attention_mma_kernel) does not compute what
the TPU kernel's body does in the same order: it takes the row maximum m
first, forms p = 2^(e log2(e) - m log2(e)) in f32, sums the unrounded p into
l, rounds p to bf16 for the p v product and multiplies the f32 accumulator by
1/l at the end; the reference rounds the normalised p / l to bf16
(dfc_sa_unet_tpu/ops/pallas_attention.py:37-43).  ``kernel_order`` below is
that arithmetic, written for this test alone; it is held against the JAX
kernel (Pallas interpret mode) and against the port's plain version, on bf16
inputs made with numpy from a seed, at the full-resolution model's shapes with
B cut to 2.

Tolerance: 8e-3 of max|reference|.  The two orders differ by bf16 roundings of
p, which flip the output's last bit here and there: one ulp of the largest
outputs (2^-7 at |out| in [2, 4)) is 4.9e-3 of max|reference| at these shapes,
and that is what the comparison reads.  chip_smoke.py allows the kernel 2e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfc_sa_unet_tpu.ops.pallas_attention import fused_pooled_attention
from dfc_sa_unet_torch.ops.attention import pooled_self_attention

torch.set_num_threads(2)
LOG2E = 1.4426950408889634
TOL = 8e-3


def kernel_order(q, k, v):
    """q, k [B,p,p,Cq], v [B,p,p,C], bf16 -> bf16: max first, one exponential per energy,
    p rounded to bf16 for the product, the f32 sum of the unrounded p divided out last."""
    b, ph, pw, cq = q.shape
    c, n = v.shape[-1], ph * pw
    e = q.reshape(b, n, cq).float() @ k.reshape(b, n, cq).float().transpose(1, 2)
    m = e.amax(dim=-1, keepdim=True)
    p = torch.exp2(e * LOG2E - m * LOG2E)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(torch.bfloat16).float() @ v.reshape(b, n, c).float()
    return (acc * (1.0 / l)).to(torch.bfloat16).reshape(b, ph, pw, c)


# (p, Cq, C): the full-resolution model at 64x64, first level (N = 4096) and second
# (N = 1024); the flagship's bottleneck width at its pool 8 (N = 64, C = 1024)
@pytest.mark.parametrize("p,cq,c", [(64, 8, 64), (32, 16, 128), (8, 128, 1024)],
                         ids=["N4096_Cq8_C64", "N1024_Cq16_C128", "N64_Cq128_C1024"])
def test_kernel_order_matches_the_jax_kernel_and_the_plain_version(p, cq, c):
    rng = np.random.default_rng(p * c)
    arrays = [rng.standard_normal((2, p, p, ch)).astype(np.float32) for ch in (cq, cq, c)]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = kernel_order(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (2, p, p, c)
    want = np.asarray(fused_pooled_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrays)), np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=TOL * scale)
    plain = pooled_self_attention(tq, tk, tv).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), plain, rtol=0, atol=TOL * scale)


def test_kernel_order_is_the_softmax_in_exact_arithmetic():
    """In f64, without the bf16 rounding of p, the order is softmax(q k^T) v itself."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 4, ch))) for ch in (2, 2, 5))
    e = q.reshape(16, 2) @ k.reshape(16, 2).T
    m = e.amax(dim=-1, keepdim=True)
    p = torch.exp2(e * LOG2E - m * LOG2E)
    got = (p @ v.reshape(16, 5)) * (1.0 / p.sum(dim=-1, keepdim=True))
    np.testing.assert_allclose(got.numpy(), (torch.softmax(e, dim=-1) @ v.reshape(16, 5)).numpy(), rtol=1e-12)
