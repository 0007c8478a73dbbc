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
from dfc_sa_unet_torch.ops import mha

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
    before = dict(mha.LAUNCHES)
    packed = mha.fused_mha(tx, 3)
    assert torch.equal(packed, mha.fused_mha_plain(tx, 3))
    q, k, v = (t.contiguous() for t in tx.chunk(3, dim=-1))
    sep = mha.fused_mha_sep(q, k, v, 3)
    assert torch.equal(sep, mha.fused_mha_sep_plain(q, k, v, 3))
    assert torch.equal(packed, sep)  # packed equals separate on split inputs
    assert mha.LAUNCHES == before  # no kernel was launched on the CPU


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
    for name in ("mha_f32", "mha_bf16"):
        stem, argtypes = _build.SIGNATURES[name]
        assert stem == "mha" and len(argtypes) == 10
        assert f'extern "C" int {name}(' in src
