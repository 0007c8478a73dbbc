"""The port's pooled-attention oracle against the JAX kernel and oracle, on the CPU.

The JAX kernel ``fused_pooled_attention`` runs in Pallas interpret mode
here (it picks that itself off the TPU).  f32: atol 1e-5, the same sums
in another order.  bf16: inputs rounded to bf16 on both sides, then
atol 2e-2 (about two bf16 ulps at |out| ~ 2): P and the output are each
rounded once to bf16 and a one-ulp flip of P moves the output by ~1e-2.
Long token counts (the full-resolution attention: 40x40 = 1600 tokens, a
non-square 25x41 grid): atol 2e-5, rtol 1e-4, as tests/test_pallas_attention.py:20
holds the JAX kernel to its own oracle.  The CUDA kernels themselves are
checked against this oracle on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfc_sa_unet_tpu.ops.attention import full_res_self_attention as jax_full_res
from dfc_sa_unet_tpu.ops.attention import pooled_self_attention as jax_attention
from dfc_sa_unet_tpu.ops.pallas_attention import fused_pooled_attention
from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.ops.attention import full_res_self_attention, pooled_self_attention
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention

torch.set_num_threads(2)


def _qkv(seed, b, p, c):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, p, p, c // 8)).astype(np.float32)
    k = rng.standard_normal((b, p, p, c // 8)).astype(np.float32)
    v = rng.standard_normal((b, p, p, c)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("p", [4, 8, 16])  # N = 16, 64, 256
@pytest.mark.parametrize("c", [64, 256])
def test_plain_matches_jax_f32(p, c):
    q, k, v = _qkv(p * c, 2, p, c)
    got = pooled_attention(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(fused_pooled_attention(jq, jk, jv)), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_attention(jq, jk, jv)), atol=1e-5)


@pytest.mark.parametrize("p", [4, 8])
def test_plain_matches_jax_bf16(p):
    q, k, v = _qkv(7, 2, p, 64)
    got = pooled_self_attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = fused_pooled_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)


def _qkv_grid(seed, b, h, w, cq, c):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, cq)).astype(np.float32), rng.standard_normal((b, h, w, cq)).astype(np.float32),
            rng.standard_normal((b, h, w, c)).astype(np.float32))


@pytest.mark.parametrize("grid", [(40, 40, 2, 16), (25, 41, 2, 16), (33, 32, 1, 8)],
                         ids=["40x40_N1600", "25x41_N1025", "33x32_N1056"])
def test_plain_matches_jax_kernel_at_long_n(grid):
    """Past the short kernel's 1024 tokens, where the JAX kernel still runs (N <= 4096)."""
    h, w, cq, c = grid
    q, k, v = _qkv_grid(h * w, 2, h, w, cq, c)
    got = pooled_attention(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    want = np.asarray(fused_pooled_attention(*(jnp.asarray(t) for t in (q, k, v))))
    assert got.shape == (2, h, w, c)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("grid", [(8, 8, 2, 16), (12, 10, 4, 32)], ids=["8x8_N64", "12x10_N120"])
def test_full_res_core_matches_jax_f32(grid):
    """Ablation 3's core over all H*W tokens, as JAX's (ops/attention.py:41): the pooled core's math."""
    h, w, cq, c = grid
    q, k, v = _qkv_grid(h * w + 1, 2, h, w, cq, c)
    got = full_res_self_attention(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    want = np.asarray(jax_full_res(*(jnp.asarray(t) for t in (q, k, v))))
    assert got.shape == (2, h, w, c)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_cpu_wrapper_takes_the_largest_n():
    """N = 4096, the full-resolution model's first level at 64x64, at a tiny C; the limit
    itself is the TPU kernel's (dfc_sa_unet_tpu/models/blocks.py:58)."""
    from dfc_sa_unet_torch.ops import pooled_attention as ops

    assert ops.MAX_TOKENS == 4096 and ops.SHORT_TOKENS < ops.MAX_TOKENS
    q, k, v = (torch.from_numpy(t) for t in _qkv_grid(1, 1, 64, 64, 1, 8))
    reset_launches()
    got = pooled_attention(q, k, v)
    assert got.shape == (1, 64, 64, 8) and torch.isfinite(got).all() and launches()["pooled_attention"] == 0
    want = torch.softmax(q.reshape(4096, 1) @ k.reshape(4096, 1).T, dim=-1) @ v.reshape(4096, 8)
    np.testing.assert_allclose(got.reshape(4096, 8).numpy(), want.numpy(), atol=2e-5, rtol=1e-4)


def test_cpu_wrapper_launches_nothing():
    reset_launches()
    q, k, v = _qkv(0, 1, 8, 64)
    pooled_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert launches()["pooled_attention"] == 0


def test_non_cpu_tensor_never_falls_back():
    q, k, v = (torch.from_numpy(t) for t in _qkv(0, 1, 4, 64))
    with pytest.raises(ValueError, match="pooled_attention"):
        pooled_attention(q, k.to("meta"), v)


def test_entry_point_per_dtype_and_token_count():
    """bf16: the wgmma kernel for every N the wrapper takes; f32: the 16-row SIMT kernel
    up to SHORT_TOKENS and the two-pass one above.  Every export of the source is reached."""
    from dfc_sa_unet_torch.ops import _build
    from dfc_sa_unet_torch.ops import pooled_attention as ops

    bf16 = {ops.entry_point(torch.bfloat16, n) for n in range(1, ops.MAX_TOKENS + 1)}
    assert bf16 == {"pooled_attention_wgmma_bf16"}
    f32 = [ops.entry_point(torch.float32, n) for n in range(1, ops.MAX_TOKENS + 1)]
    assert set(f32[:ops.SHORT_TOKENS]) == {"pooled_attention_f32"}
    assert set(f32[ops.SHORT_TOKENS:]) == {"pooled_attention_long_f32"}
    exports = {name for name, (stem, _) in _build.SIGNATURES.items() if stem == "pooled_attention"}
    assert exports == bf16 | set(f32)


@pytest.mark.parametrize("channels,offset,padded", [(8, 0, False), (64, 0, False), (25, 0, True), (4, 0, True),
                                                    (8, 3, True), (200, 0, False)])
def test_tma_rows_pads_channels_to_eight_and_realigns(channels, offset, padded):
    """The bf16 kernel reads q, k and v by TMA: rows a multiple of 16 bytes, starts 16-byte aligned.
    ``tma_rows`` leaves such a tensor as it is and otherwise copies it, zero-padded to a multiple of 8
    channels (q k^T is unchanged; the wrapper drops v's extra output columns)."""
    from dfc_sa_unet_torch.ops.pooled_attention import tma_rows

    flat = torch.randn(offset + 2 * 3 * 5 * channels).to(torch.bfloat16)
    t = flat[offset:].view(2, 3, 5, channels)
    got = tma_rows(t)
    assert (got is t) != padded
    assert got.shape[:3] == t.shape[:3] and got.shape[-1] == -(-channels // 8) * 8 and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got[..., :channels], t) and not got[..., channels:].any()
