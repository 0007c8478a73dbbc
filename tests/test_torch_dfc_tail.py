"""The port's plain conv3x3_bn_relu and DFC tail against the JAX Pallas
kernels (interpret mode), at the shapes of tests/test_pallas_conv.py.

f32, atol/rtol 1e-4 as test_pallas_conv.py: both sides sum in f32 in
another order.  The CUDA kernels are checked against these plain
versions on the card by chip_smoke.py.
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dfc_sa_unet_tpu.ops.pallas_conv import conv3x3_bn_relu as jax_conv3x3, dfc_tail_from_x
from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.ops.dfc_tail import (CONV_BLOCK_PIXELS, NARROW_BLOCK_PIXELS, conv3x3_bn_relu, conv3x3_bn_relu_plain, conv_tiling,
                                            dfc_tail, pack_conv_taps, pad_cin)

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


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    """chip_smoke.py as a module (its constants; main() is not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_checks_the_tail_at_every_auto_level_and_ragged_shapes():
    """chip_smoke.py's phase 3 holds the tail kernel to the plain version at every level the
    engine sends it, and at odd H and W with pixel counts that no block divides, at C >= 256
    (64-pixel blocks) and at C <= 128 (128-pixel blocks), at C = 32 and 64, and at a Cin that
    the wrapper zero-pads to a multiple of 8."""
    from dfc_sa_unet_torch.infer.engine import AUTO_TAIL_LEVELS
    from dfc_sa_unet_torch.ops.dfc_tail import TAIL_CHANNELS

    smoke = _chip_smoke()
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


# The bf16 conv kernel's implicit GEMM (csrc/conv3x3_wgmma.cuh::conv3x3_wgmma), emulated in torch in
# the kernel's index order: K is walked flat in 64-deep steps over pack_conv_taps(w); chunk q (16
# bytes, 8 channels) of a pixel's row in step s is K row 64 s + 8 q = tap * Cin8 + c, x's channels
# c..c+8 at the pixel shifted by the tap, zero outside the image (each chunk masked on its own, here by
# a zero border) and past the ninth tap; f32 sums, the bias and the ReLU in f32, one rounding.
def _tap_packed_conv(x, w, b):
    bsz, h, wd, cin = x.shape
    t, cin8 = conv_tiling(cin, w.shape[-1]), -(-cin // 8) * 8
    xp = F.pad(x.float(), (0, cin8 - cin, 1, 1, 1, 1))  # Cin zero-padded to Cin8, a zero border
    chunks = []
    for s in range(t.steps):
        for q in range(8):
            tap, c = divmod(64 * s + 8 * q, cin8)
            dy, dx = divmod(tap, 3)
            chunks.append(xp[:, dy:dy + h, dx:dx + wd, c:c + 8] if tap < 9 else xp.new_zeros(bsz, h, wd, 8))
    a = torch.cat(chunks, -1).reshape(-1, 64 * t.steps)
    wk = F.pad(pack_conv_taps(w).float(), (0, 0, 0, 64 * t.steps - 9 * cin8))
    return torch.relu(a @ wk + b.float()).to(x.dtype).reshape(bsz, h, wd, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [3, 8, 16, 24])
def test_tap_packed_conv_matches_the_plain_version_and_the_jax_kernel(cin, dtype):
    """Cin 3 (padded to 8) and 8 pack eight taps into a step, 16 four, 24 lets a step end inside a
    tap: the kernel's walk equals conv3x3_bn_relu_plain and the JAX kernel in interpret mode.  f32:
    TOL.  bf16: 2e-2 of max|reference| (the same bf16 inputs, f32 sums in another order, one
    rounding of the output)."""
    rng = np.random.default_rng(cin)
    x, k, bias = _rand(rng, (2, 8, 8, cin)), _rand(rng, (3, 3, cin, 16), (9 * cin) ** -0.5), _rand(rng, (16,))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = (torch.from_numpy(x).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(bias))
    got = _tap_packed_conv(*args)
    plain = conv3x3_bn_relu_plain(*args)
    jax_out = np.asarray(jax_conv3x3(jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt), jnp.asarray(bias),
                                     interpret=True), np.float32)
    assert got.dtype == tdt and got.shape == plain.shape == jax_out.shape
    for want in (plain.float().numpy(), jax_out):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_TAIL_TOL * np.abs(want).max())


@pytest.mark.parametrize("cin", [3, 8, 12])
def test_pack_conv_taps_orders_rows_as_the_flat_walk(cin):
    """Row tap * Cin8 + c of the packed weight is w[dy, dx, c] (tap = 3 dy + dx), zero for c >= Cin;
    a Cin that is a multiple of 8 is a view of w."""
    w = torch.arange(9 * cin * 16, dtype=torch.float32).reshape(3, 3, cin, 16)
    wk = pack_conv_taps(w)
    cin8 = -(-cin // 8) * 8
    assert wk.shape == (9 * cin8, 16)
    for tap in range(9):
        assert torch.equal(wk[tap * cin8:tap * cin8 + cin], w[tap // 3, tap % 3])
        assert not wk[tap * cin8 + cin:(tap + 1) * cin8].any()
    if cin % 8 == 0:
        assert wk.data_ptr() == w.data_ptr()


def _instantiated_conv_tilings():
    """{(NB, stages)} of the bf16 conv kernels that csrc/dfc_tail.cu launches (stages 0: the
    persistent kernel of Cin <= 8, whose B tile is 64 wide)."""
    src = (ROOT / "dfc_sa_unet_torch" / "csrc" / "dfc_tail.cu").read_text()
    ring = re.findall(r"if \(nb == (\d+) && stages == (\d+)\) return launch_conv_wgmma<(\d+), (\d+)>\(", src)
    narrow = re.findall(r"if \(nb == 64 && stages == 0 && cin == (\d+)\) return launch_conv_narrow<(\d+)>\(", src)
    assert ring and all(a == c and b == d for a, b, c, d in ring)
    assert sorted(narrow) == [("3", "3"), ("8", "8")]
    return {(int(a), int(b)) for a, b, _, _ in ring} | {(64, 0)}


@pytest.mark.parametrize("cin", [1, 3, 8, 16, 24, 64, 520, 1024])
def test_conv_wrapper_tilings_are_the_ones_the_kernel_instantiates(cin):
    """conv_tiling (which the wrapper passes to the kernel) gives only (NB, stages) pairs that
    csrc/dfc_tail.cu instantiates (the persistent kernel, stages 0, for x of 3 or 8 channels),
    128-pixel blocks as wgconv::kBM, shared memory as wgconv::conv_smem_bytes (1 KB of slack, the
    ring, a TMA barrier a stage) or kNarrowSmemBytes within the 232448 bytes an H100 block may
    use, and 9 Cin8 / 64 steps; the Couts reach every instance but one at NB = 64 (the persistent
    kernel takes Cin <= 8, the ring of four stages the rest)."""
    header = (ROOT / "dfc_sa_unet_torch" / "csrc" / "conv3x3_wgmma.cuh").read_text()
    const = {name: int(val) for name, val in re.findall(r"constexpr int (k\w+) = (\d+);", header)}
    assert CONV_BLOCK_PIXELS == 64 * const["kWarpgroups"] and "return 1024 + ConvRing<NB, STAGES, TMA>::kBytes" in header
    assert "kNarrowSmemBytes = 1024 + 3 * kNarrowBM * 128 + 2 * static_cast<int>(kBlock);" in header
    assert const["kNarrowTap"] == 8 and const["kNarrowBM"] == NARROW_BLOCK_PIXELS == const["kNarrowThreads"] // 2
    instances = _instantiated_conv_tilings()
    seen = set()
    for cout in (8, 40, 64, 72, 128, 136, 256, 512, 1024):
        t = conv_tiling(cin, cout)
        assert (t.nb, t.stages) in instances and t.nb >= min(cout, 256)
        assert t.bm == (CONV_BLOCK_PIXELS if t.stages else NARROW_BLOCK_PIXELS)
        cin8 = -(-cin // 8) * 8
        assert t.cin == (3 if cin == 3 and t.stages == 0 else cin8) and t.steps == -(-9 * cin8 // 64)
        ring = 1024 + t.stages * (t.bm * 128 + t.nb * 128 + 8)
        narrow = 1024 + 3 * NARROW_BLOCK_PIXELS * 128 + 2 * 64 * 128
        assert t.smem_bytes == (ring if t.stages else narrow) <= 232448
        assert (t.stages == 0) == (cin <= 8 and cout <= 64)
        seen.add((t.nb, t.stages))
    assert seen == instances - ({(64, 4)} if cin <= 8 else {(64, 0)})  # Cin <= 8 at Cout <= 64: no ring


def test_chip_smoke_checks_the_conv_at_its_tilings_and_engine_levels():
    """chip_smoke.py's phase 3 holds conv3x3_bn_relu (bf16 and f32, after a NaN launch) at Cin 3, 8,
    16, 24 and 520 (taps packed into a step, steps across taps and across a tap's end) and Cout 8,
    40, 64 and 1024, at pixel counts that no block divides and at one pixel; phase 7 at the
    engine's two levels (scripts/bench_torch_conv3x3.py's), which it records level by level."""
    from dfc_sa_unet_torch.infer.engine import AUTO_CONV_LEVELS
    from scripts import bench_torch_conv3x3 as bench

    smoke = _chip_smoke()
    shapes = smoke.CONV_ODD_SHAPES
    assert {3, 8, 16, 24, 520} <= {cin for *_, cin, _ in shapes} and {8, 40, 64, 1024} <= {c for *_, c in shapes}
    assert any(b * h * w % CONV_BLOCK_PIXELS for b, h, w, *_ in shapes) and (1, 1, 1) in {s[:3] for s in shapes}
    tilings = [conv_tiling(cin, c) for *_, cin, c in shapes]
    assert {(t.steps, t.stages) for t in tilings} >= {(2, 0), (2, 4), (3, 4), (4, 4)} and {t.nb for t in tilings} == {64, 256}
    assert {name for name, *_ in bench.LEVELS} == set(AUTO_CONV_LEVELS)
    assert set(bench.LEVELS) <= set(smoke.BLOCK_SHAPES)
    src = (ROOT / "chip_smoke.py").read_text()
    assert '"conv3x3_bn_relu": conv_levels' in src and "CONV_ODD_SHAPES" in src.split("[3]")[1]


@pytest.mark.parametrize("cin", [3, 16])
def test_cpu_bf16_conv_wrapper_runs_the_plain_version_and_launches_nothing(cin):
    """On CPU tensors the wrapper is the plain version, whatever the dtype, and counts no launch;
    the kernel's walk gives the same numbers."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, (1, 5, 7, cin))).to(torch.bfloat16)
    w = torch.from_numpy(_rand(rng, (3, 3, cin, 8), 0.2)).to(torch.bfloat16)
    b = torch.from_numpy(_rand(rng, (8,)))
    reset_launches()
    got = conv3x3_bn_relu(x, w, b)
    assert launches()["conv3x3_bn_relu"] == 0 and torch.equal(got, conv3x3_bn_relu_plain(x, w, b))
    want = _tap_packed_conv(x, w, b).float()
    assert (got.float() - want).abs().max() <= BF16_TAIL_TOL * want.abs().max()
