"""The port's multi-head attention against the JAX kernels and reference.

``fused_mha_plain`` / ``fused_mha_sep_plain`` (the CPU path of the wrappers
and the oracle of the CUDA kernel) against JAX ``fused_mha`` /
``fused_mha_sep`` (Pallas, interpret mode off-TPU) and ``_mha_reference``.
Tolerances are those of tests/test_pallas_attention.py: f32 atol 2e-5, rtol
1e-4 (sums in another order); bf16 atol 0.04, rtol 0.05 (P and the output
are rounded to bf16 on both sides, at values up to a few units).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfc_sa_unet_tpu.ops import pallas_attention as jpa
from dfc_sa_unet_torch.ops import launches, mha

torch.set_num_threads(2)
SIZES = [(2, 16, 32, 2), (1, 196, 768, 12), (2, 37, 48, 3)]  # B, N, E, heads
TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=0.04, rtol=0.05)}


def _qkv(seed, b, n, e, dtype):
    x = np.random.default_rng(seed).standard_normal((b, n, 3 * e)).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jnp.ndarray) else a.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,e,nh", SIZES)
def test_packed_plain_matches_jax(b, n, e, nh, dtype):
    jx, tx = _qkv(0, b, n, e, dtype)
    got = mha.fused_mha_plain(tx, nh)
    assert got.shape == (b, n, e) and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(jpa.fused_mha(jx, nh)), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jpa._mha_reference(jx, nh)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,e,nh", SIZES)
def test_separate_plain_matches_jax(b, n, e, nh, dtype):
    jx, tx = _qkv(1, b, n, e, dtype)
    jq, jk, jv = jnp.split(jx, 3, axis=-1)
    tq, tk, tv = (t.contiguous() for t in tx.chunk(3, dim=-1))
    got = mha.fused_mha_sep_plain(tq, tk, tv, nh)
    assert got.shape == (b, n, e) and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(jpa.fused_mha_sep(jq, jk, jv, nh)), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jpa._mha_sep_reference(jq, jk, jv, nh)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_wrappers_run_the_plain_versions(dtype):
    _, tx = _qkv(2, 2, 37, 48, dtype)
    before = launches()
    packed = mha.fused_mha(tx, 3)
    assert torch.equal(packed, mha.fused_mha_plain(tx, 3))
    q, k, v = (t.contiguous() for t in tx.chunk(3, dim=-1))
    sep = mha.fused_mha_sep(q, k, v, 3)
    assert torch.equal(sep, mha.fused_mha_sep_plain(q, k, v, 3))
    assert torch.equal(packed, sep)  # packed equals separate on split inputs
    assert launches() == before  # no kernel was launched on the CPU


def test_scores_are_scaled_and_softmax_rows_sum_to_one():
    """One head, v = identity: the output is the probability matrix itself."""
    n = 8
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, n, n)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, n, n)).astype(np.float32))
    p = mha.fused_mha_sep_plain(q, k, torch.eye(n)[None], 1)[0]
    want = torch.softmax(q[0] @ k[0].T / n ** 0.5, dim=-1)
    np.testing.assert_allclose(p.numpy(), want.numpy(), atol=1e-6)
    np.testing.assert_allclose(p.sum(-1).numpy(), np.ones(n), atol=1e-6)


def test_launch_counters_are_registered():
    from dfc_sa_unet_torch.ops import launches, reset_launches

    reset_launches()
    counts = launches()
    assert counts["fused_mha"] == 0 and counts["fused_mha_sep"] == 0
    assert {"pooled_attention", "dfc_tail", "conv3x3_bn_relu"} <= set(counts)


def test_build_signatures_name_the_mha_exports():
    """Every exported function of csrc/mha.cu is bound, with its ten arguments."""
    from dfc_sa_unet_torch.ops import _build

    src = (_build.CSRC / "mha.cu").read_text()
    for name in ("mha_f32", "mha_bf16", "mha_wgmma_bf16"):
        stem, argtypes = _build.SIGNATURES[name]
        assert stem == "mha" and len(argtypes) == 10
        assert f'extern "C" int {name}(' in src


# --------------------------------------------------------------------------------------------
# The bf16 one-pass kernel's order of arithmetic (csrc/mha.cu, mha_wgmma_kernel), emulated on
# the CPU and held to the JAX kernels in interpret mode.  The kernel cannot run here; this pins
# what it computes: the raw scores q k^T in f32 over the keys zero-padded to a multiple of 16,
# padded keys at -inf (p = 0), the exact row maximum m, p = 2^(s c - m c) with the scale folded
# into c = log2(e)/sqrt(hd), the f32 sum l of the unrounded p, p * (1/l) rounded to bf16 (the
# reference's rounding point: it rounds the normalised softmax), and p v accumulated in f32.
# Tolerance: 1e-2 of max|reference|.  The orders differ by exp2 against exp, one reciprocal
# against a division and the sums' order, which flip bf16 roundings of p and of the output
# here and there: one ulp of the largest outputs is up to 2^-8 of them.

LOG2E = 1.4426950408889634
ONE_PASS_TOL = 1e-2


def one_pass_order(q, k, v, num_heads):
    """q, k, v [B,N,E] bf16 -> [B,N,E] bf16 in the one-pass kernel's order."""
    b, n, e = q.shape
    hd = e // num_heads
    nkp = -(-n // 16) * 16

    def heads(t, rows):
        t = t.reshape(b, n, num_heads, hd).transpose(1, 2).float()
        return torch.nn.functional.pad(t, (0, 0, 0, rows - n))

    s = heads(q, n) @ heads(k, nkp).transpose(2, 3)
    s[..., n:] = float("-inf")
    c = LOG2E / hd ** 0.5
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s * c - m * c)
    l = p.sum(dim=-1, keepdim=True)
    out = (p * (1.0 / l)).to(torch.bfloat16).float() @ heads(v, nkp)
    return out.to(torch.bfloat16).transpose(1, 2).reshape(b, n, e)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("n", [196, 200, 256])
def test_one_pass_order_matches_the_jax_kernels(n, hd, packed):
    nh = 2
    jx, tx = _qkv(n + hd, 1, n, nh * hd, "bfloat16")
    tq, tk, tv = (t.contiguous() for t in tx.chunk(3, dim=-1))
    if packed:
        want = _np(jpa.fused_mha(jx, nh))
    else:
        want = _np(jpa.fused_mha_sep(*jnp.split(jx, 3, axis=-1), nh))
    got = one_pass_order(tq, tk, tv, nh)
    assert got.dtype == torch.bfloat16 and got.shape == (1, n, nh * hd)
    scale = np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=ONE_PASS_TOL * scale)
    np.testing.assert_allclose(_np(got), _np(mha.fused_mha_sep_plain(tq, tk, tv, nh)), rtol=0,
                               atol=ONE_PASS_TOL * scale)


def test_entry_point_per_dtype_and_token_count():
    """bf16: the one-pass wgmma kernel up to 256 tokens, the two-pass kernel above; f32: SIMT."""
    assert mha.entry_point(torch.bfloat16, 196) == "mha_wgmma_bf16"
    assert mha.entry_point(torch.bfloat16, mha.WGMMA_TOKENS) == "mha_wgmma_bf16"
    assert mha.entry_point(torch.bfloat16, mha.WGMMA_TOKENS + 1) == "mha_bf16"
    assert mha.entry_point(torch.bfloat16, mha.MAX_TOKENS) == "mha_bf16"
    assert mha.entry_point(torch.float32, 196) == "mha_f32"


def test_chip_smoke_checks_both_bf16_kernels_at_every_head_dim():
    """chip_smoke.py's phase 3 holds both bf16 kernels (N either side of the one-pass
    kernel's limit, and the largest N) to the plain version at head dimensions 32, 64, 128."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seen = {(n, e // nh) for _, n, e, nh in smoke.MHA_SHAPES}
    assert {(n, hd) for n in (196, 197, 256, 257, 1024) for hd in (32, 64, 128)} <= seen
    kernels = {mha.entry_point(torch.bfloat16, n) for _, n, _, _ in smoke.MHA_SHAPES}
    assert kernels == {"mha_wgmma_bf16", "mha_bf16"}
    assert all(n <= mha.MAX_TOKENS and (e // nh) % 8 == 0 and e // nh <= mha.MAX_HEAD_DIM
               for _, n, e, nh in smoke.MHA_SHAPES)
