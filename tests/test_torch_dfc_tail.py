"""The port's plain conv3x3_bn_relu and DFC tail against the JAX Pallas
kernels (interpret mode), at the shapes of tests/test_pallas_conv.py.

f32, atol/rtol 1e-4 as test_pallas_conv.py: both sides sum in f32 in
another order.  The CUDA kernels are checked against these plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfc_sa_unet_tpu.ops.pallas_conv import conv3x3_bn_relu as jax_conv3x3, dfc_tail_from_x
from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.ops.dfc_tail import conv3x3_bn_relu, dfc_tail

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 16, 8, 12, 10), (1, 8, 16, 3, 8), (3, 12, 8, 8, 8), (2, 32, 8, 4, 6),
])
def test_conv3x3_bn_relu(b, h, w, cin, cout):
    rng = np.random.default_rng(cin * cout)
    x, k, bias = _rand(rng, (b, h, w, cin)), _rand(rng, (3, 3, cin, cout), 0.1), _rand(rng, (cout,))
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), interpret=True))
    got = conv3x3_bn_relu(*(torch.from_numpy(t) for t in (x, k, bias))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _tail_args(seed, b, h, w, cin, c):
    rng = np.random.default_rng(seed)
    wr = _rand(rng, (cin, c), 0.1) if cin != c else np.eye(c, dtype=np.float32) * np.float32(0.1)
    return [_rand(rng, (b, h, w, cin)), _rand(rng, (b, h, w, c)), _rand(rng, (3, 3, cin, c), 0.1),
            _rand(rng, (c,)), _rand(rng, (2 * c, c), 0.1), _rand(rng, (c,)),
            _rand(rng, (3 * c, c), 0.1), _rand(rng, (c,)), wr]


@pytest.mark.parametrize("b,h,w,cin,c", [
    (2, 16, 8, 12, 10),   # Cin != C: projected residual
    (2, 16, 8, 10, 10),   # Cin == C: identity residual as eye * res_scale
    (1, 13, 11, 6, 8),    # odd H and W
])
def test_dfc_tail(b, h, w, cin, c):
    args = _tail_args(b * h * cin, b, h, w, cin, c)
    if h % 2:  # the TPU kernel needs R*W % 8 == 0; the lax formula is its math
        want = _tail_reference(*args)
    else:
        want = np.asarray(dfc_tail_from_x(*(jnp.asarray(t) for t in args), interpret=True))
    got = dfc_tail(*(torch.from_numpy(t) for t in args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _tail_reference(x, a, wc, bc, wg, bg, wf, bf, wr):
    """The tail's math in numpy float64 (test_pallas_conv.py:67-73)."""
    x, a = x.astype(np.float64), a.astype(np.float64)
    b, h, w, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    conv = sum(xp[:, dy:dy + h, dx:dx + w] @ wc[dy, dx] for dy in range(3) for dx in range(3))
    local = np.maximum(conv + bc, 0.0)
    g = 1.0 / (1.0 + np.exp(-(np.concatenate([local, a], -1) @ wg + bg)))
    fused = g * local + (1 - g) * a
    o = np.maximum(np.concatenate([fused, local, a], -1) @ wf + bf, 0.0)
    return (o + x @ wr).astype(np.float32)


def test_dfc_tail_bf16_rounds_like_the_engine():
    """bf16 activations: the plain tail equals the f32 math on bf16-rounded
    inputs to within bf16 rounding of local/fused and the output (2e-2)."""
    args = _tail_args(3, 1, 8, 8, 12, 16)
    got = dfc_tail(*(torch.from_numpy(t).to(torch.bfloat16) if t.ndim != 1 else torch.from_numpy(t)
                     for t in args))
    assert got.dtype == torch.bfloat16
    rounded = [torch.from_numpy(t).to(torch.bfloat16).float().numpy() if t.ndim != 1 else t for t in args]
    np.testing.assert_allclose(got.float().numpy(), _tail_reference(*rounded), atol=5e-2, rtol=2e-2)


def test_cpu_wrappers_launch_nothing_and_meta_raises():
    reset_launches()
    args = [torch.from_numpy(t) for t in _tail_args(0, 1, 8, 8, 4, 8)]
    dfc_tail(*args)
    conv3x3_bn_relu(args[0], args[2], args[3])
    assert launches()["dfc_tail"] == 0 and launches()["conv3x3_bn_relu"] == 0
    with pytest.raises(ValueError, match="dfc_tail"):
        dfc_tail(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError, match="conv3x3_bn_relu"):
        conv3x3_bn_relu(args[0].to("meta"), args[2], args[3])
