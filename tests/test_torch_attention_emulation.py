"""The bf16 pooled-attention kernel's order of arithmetic, emulated in PyTorch on the CPU.

csrc/pooled_attention.cu (pooled_attention_wgmma_kernel) does not compute what
the TPU kernel's body does in the same order.  It walks the keys once, in
chunks of 128 (64 where Cq > 64) in key order, with an online softmax against
a reference d per row: per chunk the energies e = q k^T in f32 and the chunk's
row maximum times log2(e), dc (rounded to f32); where dc passes d by more than
8 (the first chunk always, d starting at -inf) alpha = 2^(d - dc) and d = dc,
else alpha = 1 and d stays; p = 2^(e log2(e) - d) in f32 (one multiply-add and
one exponential, at most 2^8); l = l alpha + sum p of the unrounded p; acc =
acc alpha + bf16(p) v, the product summed in f32.  Keys past nk have no
weight.  After the last chunk out = acc (1 / l), rounded to bf16.  The
reference rounds the normalised p / l to bf16 instead
(dfc_sa_unet_tpu/ops/pallas_attention.py:37-43).  ``kernel_order`` below is
that arithmetic, written for this test alone.  It is held against the JAX
kernel (Pallas interpret mode) and against the port's plain version, on bf16
inputs made with numpy from a seed, at the full-resolution model's shapes with
B cut to 2, and at a key count that no chunk divides.  A band's queries
against every key (``nq < nk``, parallel/rows.py) must give the whole map's
rows bit for bit: the chunks go by key index, never by query.

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
SLACK = 8.0  # log2 units the chunk maximum may pass the reference by before it moves (wg::kSlack)


def chunk_of(cq):
    """Keys a chunk of the kernel (csrc/pooled_attention.cu, the CH of its dispatch): 128 where q's
    fragments leave the registers room (Cq <= 64), else 64; one chunk holds every key when Nk <= 64."""
    return 128 if cq <= 64 else 64
TOL = 8e-3


def kernel_order(q, k, v):
    """q [B,h,w,Cq] (nq queries), k [B,p,p',Cq], v [B,p,p',C] (nk keys), bf16 -> [B,h,w,C] bf16: one pass
    over the keys in chunks of ``chunk_of(Cq)``, the online softmax of the kernel (a row's reference d moves to the
    chunk's maximum only when that passes it by more than SLACK), p rounded to bf16 relative to the
    reference, the f32 sum of the unrounded p divided out last."""
    b, ph, pw, cq = q.shape
    c, nq, nk = v.shape[-1], ph * pw, k.shape[1] * k.shape[2]
    qf = q.reshape(b, nq, cq).float()
    kf, vf = k.reshape(b, nk, cq).float(), v.reshape(b, nk, c).float()
    d = torch.full((b, nq, 1), -float("inf"))
    l, acc = torch.zeros(b, nq, 1), torch.zeros(b, nq, c)
    chunk = chunk_of(cq)
    for j0 in range(0, nk, chunk):
        e = qf @ kf[:, j0:j0 + chunk].transpose(1, 2)
        dc = e.amax(dim=-1, keepdim=True) * LOG2E  # an f32 product, as the kernel's
        up = dc - d > SLACK
        alpha = torch.where(up, torch.exp2(d - dc), torch.ones_like(d))
        d = torch.where(up, dc, d)
        p = torch.exp2((e.double() * LOG2E - d.double()).float())  # fmaf(e, log2(e), -d)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, j0:j0 + chunk]
    return (acc * (1.0 / l)).to(torch.bfloat16).reshape(b, ph, pw, c)


def _bf16_inputs(seed, b, h, w, cq, c):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, w, ch)).astype(np.float32) for ch in (cq, cq, c)]


# (h, w, Cq, C): the full-resolution model at 64x64, first level (N = 4096) and second
# (N = 1024); the flagship's bottleneck width at its pool 8 (N = 64, C = 1024); 17x17 = 289 keys,
# two whole chunks and one of 33
@pytest.mark.parametrize("h,w,cq,c", [(64, 64, 8, 64), (32, 32, 16, 128), (8, 8, 128, 1024), (17, 17, 8, 64)],
                         ids=["N4096_Cq8_C64", "N1024_Cq16_C128", "N64_Cq128_C1024", "N289_Cq8_C64"])
def test_kernel_order_matches_the_jax_kernel_and_the_plain_version(h, w, cq, c):
    arrays = _bf16_inputs(h * w * c, 2, h, w, cq, c)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = kernel_order(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (2, h, w, c)
    want = np.asarray(fused_pooled_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrays)), np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=TOL * scale)
    plain = pooled_self_attention(tq, tk, tv).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), plain, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("h,cq,c,bands", [(64, 8, 64, 2), (17, 8, 64, 3)], ids=["N4096_2bands", "N289_3bands"])
def test_a_bands_queries_give_the_whole_maps_rows_bit_for_bit(h, cq, c, bands):
    """nq < nk: each band of rows (the last one short where h does not divide) against every key equals
    the same rows of the whole map's emulation, and stays within the tolerance of the plain version."""
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in _bf16_inputs(h + bands, 2, h, h, cq, c))
    whole = kernel_order(tq, tk, tv)
    step = -(-h // bands)
    for r0 in range(0, h, step):
        qb = tq[:, r0:r0 + step].contiguous()
        got = kernel_order(qb, tk, tv)
        assert torch.equal(got, whole[:, r0:r0 + step]), r0
        plain = pooled_self_attention(qb, tk, tv).float()
        assert (got.float() - plain).abs().max() <= TOL * plain.abs().max()


@pytest.mark.parametrize("spread", [0.25, 6.0], ids=["reference_moves_once", "reference_moves_often"])
def test_kernel_order_is_the_softmax_in_exact_arithmetic(spread):
    """In f64, without the bf16 rounding of p, the online order over chunks (the reference moving only
    past SLACK) is softmax(q k^T) v itself; wide energies move the reference in later chunks too."""
    rng = np.random.default_rng(3)
    n, chunk = 150, 64  # three chunks, the last one short
    q, k, v = (torch.from_numpy(rng.standard_normal((n, ch))) for ch in (2, 2, 5))
    e = (q @ k.T) * spread * torch.linspace(0.5, 2.0, n, dtype=torch.float64)  # maxima growing along the keys
    d = torch.full((n, 1), -float("inf"), dtype=torch.float64)
    l, acc = torch.zeros(n, 1, dtype=torch.float64), torch.zeros(n, 5, dtype=torch.float64)
    moves = torch.zeros(n, 1)
    for j0 in range(0, n, chunk):
        dc = e[:, j0:j0 + chunk].amax(dim=-1, keepdim=True) * LOG2E
        up = dc - d > SLACK
        moves += up
        alpha = torch.where(up, torch.exp2(d - dc), torch.ones_like(d))
        d = torch.where(up, dc, d)
        p = torch.exp2(e[:, j0:j0 + chunk] * LOG2E - d)
        assert p.max() <= 2 ** SLACK
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v[j0:j0 + chunk]
    assert (moves >= 1).all() and (moves.max() > 1) == (spread > 1)
    np.testing.assert_allclose((acc / l).numpy(), (torch.softmax(e, dim=-1) @ v).numpy(), rtol=1e-12)
