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
from dfc_sa_unet_torch.ops.dfc_tail import conv3x3_bn_relu, dfc_tail, pad_cin

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


# The channel counts the bf16 wgmma tail kernel takes (C = 32 padded to 64 columns, C = 64
# one 64-channel chunk), Cin = C and 2C, held against the JAX kernel in interpret mode in f32
# and bf16; H = 7 is odd (R = 1 row tiles in the TPU kernel).  The plain version is the CUDA
# kernel's arithmetic (f32 sums; local rounded for the gate and fusion products, f32 for the
# fusion itself; fused rounded), so this pins what the kernel computes.  f32: TOL.  bf16:
# 2e-2 of max|reference|: both sides round local, fused and the output to bf16 at the same
# points and sum in f32 in other orders, which flips a rounding here and there (one ulp of
# the output is up to 2^-8 of it, and a flipped local moves the output by less).
BF16_TAIL_TOL = 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,cin,b,h,w", [(32, 32, 2, 8, 8), (32, 64, 1, 7, 8), (64, 64, 1, 7, 8),
                                         (64, 128, 2, 8, 8)],
                         ids=["C32_Cin32", "C32_Cin64_odd_H", "C64_Cin64_odd_H", "C64_Cin128"])
def test_dfc_tail_at_the_wgmma_kernels_channel_counts(c, cin, b, h, w, dtype):
    args = _tail_args(c * cin + h, b, h, w, cin, c)
    is_bias = [False, False, False, True, False, True, False, True, False]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(dfc_tail_from_x(*(jnp.asarray(t) if bias else jnp.asarray(t).astype(jdt)
                                        for t, bias in zip(args, is_bias)), interpret=True), np.float32)
    got = dfc_tail(*(torch.from_numpy(t) if bias else torch.from_numpy(t).to(tdt) for t, bias in zip(args, is_bias)))
    assert got.dtype == tdt and got.shape == (b, h, w, c)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_TAIL_TOL * np.abs(want).max())


def test_chip_smoke_checks_the_tail_at_every_auto_level_and_ragged_shapes():
    """chip_smoke.py's phase 3 holds the tail kernel to the plain version at every level the
    engine sends it, and at odd H and W with pixel counts that no block divides, at C >= 256
    (64-pixel blocks) and at C <= 128 (128-pixel blocks), at C = 32 and 64, and at a Cin that
    the wrapper zero-pads to a multiple of 8."""
    import importlib.util
    import pathlib

    from dfc_sa_unet_torch.infer.engine import AUTO_TAIL_LEVELS
    from dfc_sa_unet_torch.ops.dfc_tail import TAIL_CHANNELS

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(AUTO_TAIL_LEVELS) <= {name for name, *_ in smoke.BLOCK_SHAPES}
    odd = [(b, h, w, cin, c) for b, h, w, cin, c in smoke.TAIL_ODD_SHAPES if h % 2 or w % 2]
    assert {c for *_, c in odd} >= {512, 256, 128, 64, 32} and set(TAIL_CHANNELS) == {32, 64, 128, 256, 512}
    for c, block in ((512, 64), (256, 64), (128, 128)):
        assert any(b * h * w % block for b, h, w, _, cc in odd if cc == c)
    assert any(cin % 8 for *_, cin, _ in smoke.TAIL_ODD_SHAPES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [3, 12, 16])
def test_pad_cin_keeps_the_tail(cin, dtype):
    """The bf16 wrapper zero-pads Cin to a multiple of 8 (down1's Cin = 3): x's added channels
    meet zero rows of wc and wr, so the tail is the same, and a multiple of 8 is left alone."""
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(t) if t.ndim == 1 else torch.from_numpy(t).to(tdt)
            for t in _tail_args(cin, 2, 7, 9, cin, 32)]
    x, wc, wr = pad_cin(args[0], args[2], args[8])
    want_cin = -(-cin // 8) * 8
    assert x.shape[-1] == want_cin and wc.shape == (3, 3, want_cin, 32) and wr.shape == (want_cin, 32)
    if cin % 8 == 0:
        assert x is args[0] and wc is args[2] and wr is args[8]
    got = dfc_tail(x, args[1], wc, *args[3:8], wr)
    want = dfc_tail(*args)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=0,
                               atol=(1e-5 if dtype == "float32" else BF16_TAIL_TOL) * want.float().abs().max().item())
