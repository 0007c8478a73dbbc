"""The plain version of ``conv3x3_bias_stats`` against the JAX probe it is a
port of (scripts/bench_bn_stats.py): ``xla_conv_stats``, and the Pallas
kernel body ``_kernel`` run in interpret mode through a ``pallas_call`` built
here with ``make_pallas``'s specs.  The CUDA kernel itself is held against
this plain version on the card by chip_smoke.py.

f32: y, mean and mean2 to 1e-5 of max|reference| (the same f32 sums in
another order).  bf16: inputs rounded to bf16 on both sides, then 2e-2, the
probe's own tolerance (bench_bn_stats.py:159): y is rounded once to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.ops.conv_bn_stats import conv3x3_bias_stats, conv3x3_bias_stats_plain
from scripts import bench_bn_stats as probe

torch.set_num_threads(2)
SHAPES = [(2, 8, 8, 3, 8), (2, 7, 5, 4, 16), (1, 12, 9, 16, 24)]  # B, H, W, Cin, Cout; odd H != W among them


def _inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32),
            rng.uniform(-0.1, 0.1, (cout,)).astype(np.float32))


def _interpreted_kernel(x, w, b, r):
    """``make_pallas`` (bench_bn_stats.py:80-118) with ``interpret=True``."""
    bsz, h, width, cin = x.shape
    cout = w.shape[-1]
    xp = jnp.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))
    g = h // r
    y, ps, pq = pl.pallas_call(
        probe._kernel,
        out_shape=[jax.ShapeDtypeStruct((bsz, h, width, cout), x.dtype),
                   jax.ShapeDtypeStruct((bsz * g, 1, cout), jnp.float32),
                   jax.ShapeDtypeStruct((bsz * g, 1, cout), jnp.float32)],
        grid=(bsz, g),
        in_specs=[pl.BlockSpec((pl.Element(1), pl.Element(r + 2), pl.Element(width), pl.Element(cin)),
                               lambda i, j: (i, j * r, 0, 0)),
                  pl.BlockSpec((3, 3 * cin, cout), lambda i, j: (0, 0, 0)),
                  pl.BlockSpec((cout,), lambda i, j: (0,))],
        out_specs=[pl.BlockSpec((1, r, width, cout), lambda i, j: (i, j, 0, 0)),
                   pl.BlockSpec((1, 1, cout), lambda i, j: (i * g + j, 0, 0)),
                   pl.BlockSpec((1, 1, cout), lambda i, j: (i * g + j, 0, 0))],
        interpret=True,
    )(xp, w.reshape(3, 3 * cin, cout), b)
    n = bsz * h * width
    return y, jnp.sum(ps, axis=(0, 1)) / n, jnp.sum(pq, axis=(0, 1)) / n


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * max(1e-6, np.abs(want).max()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_xla_conv_stats_f32(shape):
    x, w, b = _inputs(sum(shape), *shape)
    got = conv3x3_bias_stats(*(torch.from_numpy(t) for t in (x, w, b)))
    want = probe.xla_conv_stats(*(jnp.asarray(t) for t in (x, w, b)))
    assert got[0].shape == (*shape[:3], shape[4]) and got[1].shape == got[2].shape == (shape[4],)
    for g, r in zip(got, want):
        _close(g, r, 1e-5)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_xla_conv_stats_bf16(shape):
    x, w, b = _inputs(sum(shape) + 1, *shape)
    got = conv3x3_bias_stats_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), torch.from_numpy(b))
    want = probe.xla_conv_stats(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    for g, r in zip(got, want):
        _close(g, r, 2e-2)


@pytest.mark.parametrize("shape,rows", [((2, 8, 8, 3, 8), 4), ((2, 7, 5, 4, 16), 7), ((1, 12, 9, 16, 24), 3)],
                         ids=["8x8_r4", "7x5_r7", "12x9_r3"])
def test_plain_matches_the_interpreted_tpu_kernel(shape, rows):
    x, w, b = _inputs(sum(shape) + 2, *shape)
    got = conv3x3_bias_stats_plain(*(torch.from_numpy(t) for t in (x, w, b)))
    want = _interpreted_kernel(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), rows)
    for g, r in zip(got, want):
        _close(g, r, 1e-5)


def test_cpu_wrapper_launches_nothing_and_other_devices_never_fall_back():
    reset_launches()
    x, w, b = (torch.from_numpy(t) for t in _inputs(0, 1, 4, 4, 3, 8))
    conv3x3_bias_stats(x, w, b)
    assert launches()["conv3x3_bias_stats"] == 0
    with pytest.raises(ValueError, match="conv3x3_bias_stats"):
        conv3x3_bias_stats(x.to("meta"), w, b)
