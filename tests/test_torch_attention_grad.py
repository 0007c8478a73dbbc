"""Gradients of the port's three attention wrappers against ``jax.grad``
through the JAX package's Pallas functions (interpret mode off the TPU;
their custom VJPs recompute through the lax reference, as the port's
autograd Functions recompute through the plain versions).

f32, tolerance 1e-5 of max|reference gradient|: the same f32 sums in
another order.  On the CPU the wrappers run their plain versions under
plain autograd; the one autograd Function that wraps the CUDA kernels
(``_build.PlainBackward``) is driven here with each wrapper's launch replaced
by its plain version, which checks its backward (recompute, gradient routing
and layout) without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfc_sa_unet_tpu.ops import pallas_attention as jpa
from dfc_sa_unet_torch.ops import _build, mha, pooled_attention as pa

torch.set_num_threads(2)
TOL = 1e-5


def _np(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.fixture
def plain_launch(monkeypatch):
    """The Function's forward goes to the plain versions instead of a CUDA launch."""
    monkeypatch.setattr(pa, "_launch", pa.pooled_attention_plain)
    monkeypatch.setattr(mha, "_launch_packed", mha.fused_mha_plain)
    monkeypatch.setattr(mha, "_launch_sep", mha.fused_mha_sep_plain)


def _pooled(q, k, v):
    return _build.PlainBackward.apply(pa._launch, pa.pooled_attention_plain, (1,), q, k, v)


def _packed(qkv, num_heads):
    return _build.PlainBackward.apply(mha._launch_packed, mha.fused_mha_plain, (num_heads,), qkv)


def _sep(q, k, v, num_heads):
    return _build.PlainBackward.apply(mha._launch_sep, mha.fused_mha_sep_plain, (num_heads,), q, k, v)


@pytest.mark.parametrize("p,c", [(4, 64), (8, 128), (5, 24)])  # N = 16, 64 and an odd 25
@pytest.mark.parametrize("through_function", [False, True], ids=["wrapper", "function"])
def test_pooled_attention_grad_matches_jax(p, c, through_function, plain_launch):
    q, k, v, w = _np(p * c, (2, p, p, c // 8), (2, p, p, c // 8), (2, p, p, c), (2, p, p, c))
    want = jax.grad(lambda *a: jnp.sum(jpa.fused_pooled_attention(*a) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    leaves = _leaves((q, k, v))
    fn = _pooled if through_function else pa.pooled_attention
    (fn(*leaves) * torch.from_numpy(w)).sum().backward()
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.is_contiguous() and leaf.grad.shape == leaf.shape
        _close(leaf.grad, ref)


@pytest.mark.parametrize("n,e,heads", [(16, 32, 2), (49, 64, 4), (197, 48, 3)])  # odd N like ViT's 196+1
@pytest.mark.parametrize("through_function", [False, True], ids=["wrapper", "function"])
def test_fused_mha_grad_matches_jax(n, e, heads, through_function, plain_launch):
    qkv, w = _np(n + e, (2, n, 3 * e), (2, n, e))
    want = jax.grad(lambda t: jnp.sum(jpa.fused_mha(t, heads) * w))(jnp.asarray(qkv))
    (leaf,) = _leaves((qkv,))
    fn = _packed if through_function else mha.fused_mha
    (fn(leaf, heads) * torch.from_numpy(w)).sum().backward()
    assert leaf.grad.is_contiguous()
    _close(leaf.grad, want)


@pytest.mark.parametrize("n,e,heads", [(16, 32, 2), (49, 64, 4), (197, 48, 3)])
@pytest.mark.parametrize("through_function", [False, True], ids=["wrapper", "function"])
def test_fused_mha_sep_grad_matches_jax(n, e, heads, through_function, plain_launch):
    q, k, v, w = _np(n * e, (2, n, e), (2, n, e), (2, n, e), (2, n, e))
    want = jax.grad(lambda *a: jnp.sum(jpa.fused_mha_sep(*a, heads) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))
    leaves = _leaves((q, k, v))
    fn = _sep if through_function else mha.fused_mha_sep
    (fn(*leaves, heads) * torch.from_numpy(w)).sum().backward()
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.is_contiguous()
        _close(leaf.grad, ref)


def test_function_routes_gradients_only_where_needed(plain_launch):
    q, k, v = (torch.from_numpy(a) for a in _np(1, (1, 4, 4, 2), (1, 4, 4, 2), (1, 4, 4, 16)))
    v.requires_grad_(True)
    _pooled(q, k, v).sum().backward()
    assert q.grad is None and k.grad is None and v.grad is not None
    # non-contiguous upstream gradients (a transposed sum) still come back contiguous
    q2, k2, v2 = _leaves(_np(2, (2, 9, 16), (2, 9, 16), (2, 9, 16)))
    out = _sep(q2, k2, v2, 2)
    (out.transpose(1, 2) * torch.arange(9.0)).sum().backward()
    assert all(t.grad.is_contiguous() for t in (q2, k2, v2))


def test_gradcheck_of_the_plain_versions_in_f64():
    """f64 inputs and f64 finite differences; the plain versions sum in f32 inside by design,
    so the step is 1e-2 (rounding 1e-7 / 1e-2, truncation ~1e-4) and the tolerance 2e-3."""
    g = torch.Generator().manual_seed(0)
    check = dict(eps=1e-2, atol=2e-3, rtol=1e-2)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)

    assert torch.autograd.gradcheck(pa.pooled_attention_plain, (rnd(1, 2, 2, 2), rnd(1, 2, 2, 2), rnd(1, 2, 2, 3)),
                                    **check)
    assert torch.autograd.gradcheck(lambda t: mha.fused_mha_plain(t, 2), (rnd(1, 3, 12),), **check)
    assert torch.autograd.gradcheck(lambda a, b, c: mha.fused_mha_sep_plain(a, b, c, 2),
                                    (rnd(1, 3, 4), rnd(1, 3, 4), rnd(1, 3, 4)), **check)
