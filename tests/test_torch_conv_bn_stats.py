"""The plain version of ``conv3x3_bias_stats`` against the JAX probe it is a
port of (scripts/bench_bn_stats.py): ``xla_conv_stats``, and the Pallas
kernel body ``_kernel`` run in interpret mode through a ``pallas_call`` built
here with ``make_pallas``'s specs.  The CUDA kernel itself is held against
this plain version on the card by chip_smoke.py; here an emulation of the
bf16 kernel's tiling (the flat K walk, one partial row per tile of pixels,
phantom rows masked) is held against both.

f32: y, mean and mean2 to 1e-5 of max|reference| (the same f32 sums in
another order).  bf16: inputs rounded to bf16 on both sides, then 2e-2, the
probe's own tolerance (bench_bn_stats.py:159): y is rounded once to bf16.
"""

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.ops.conv_bn_stats import (F32_BLOCK_PIXELS, ROW_GROUP, conv3x3_bias_stats,
                                                 conv3x3_bias_stats_plain, partial_buffer, partial_rows, row_means,
                                                 stats_tiling)
from dfc_sa_unet_torch.ops.dfc_tail import CONV_BLOCK_PIXELS, NARROW_BLOCK_PIXELS, conv_tiling, pack_conv_taps
from scripts import bench_bn_stats as probe

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "dfc_sa_unet_torch" / "csrc"

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


# ---------------------------------------------------------------- the bf16 kernel's tiling

# (Cin, Cout): the persistent kernel at Cin 3 and 8 (64-pixel tiles), the ring at 16 (four taps a
# step), 24 (a step across taps; NB 128 at Cout 72) and 64 (one tap a step; 128-pixel tiles)
EMULATED = [(3, 16), (8, 40), (16, 24), (24, 72), (64, 16)]
# (B, H, W) with P below one tile and just past one, for tiles of 64 and of 128 pixels; H is
# divisible by the rows of the interpreted kernel's row tiles
PIXELS = {64: {"below": (1, 5, 7), "past": (1, 6, 11)}, 128: {"below": (2, 5, 7), "past": (2, 6, 11)}}
ROWS = {5: 5, 6: 3}


def _tiled_stats(x, w, b, mask=True):
    """The bf16 kernel's arithmetic, in f32: the implicit GEMM of the flat K walk (64 K rows a step,
    x zero-padded to Cin8, ``pack_conv_taps``), acc = taps . w + b with no ReLU, y = acc rounded once;
    one partial row per tile of ``stats_tiling(cin, cout).bm`` pixels, each the sum of its warps'
    16-row sums in warp order, over acc and acc^2.  A tile's rows past the last pixel gather zeros,
    so their acc is the bias: ``mask`` counts them as zero, as the kernel does.  The wrapper's sum
    of the rows over P gives mean and mean2."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    t, cin8 = stats_tiling(cin, cout), -(-cin // 8) * 8
    xp = F.pad(x.float(), (0, cin8 - cin, 1, 1, 1, 1))
    chunks = []
    for s in range(t.steps):
        for q in range(8):
            tap, c = divmod(64 * s + 8 * q, cin8)
            dy, dx = divmod(tap, 3)
            chunks.append(xp[:, dy:dy + h, dx:dx + wd, c:c + 8] if tap < 9 else xp.new_zeros(bsz, h, wd, 8))
    a = torch.cat(chunks, -1).reshape(-1, 64 * t.steps)
    npix = a.shape[0]
    tiles = -(-npix // t.bm)
    a = F.pad(a, (0, 0, 0, tiles * t.bm - npix))  # the last tile's phantom rows
    wk = F.pad(pack_conv_taps(w).float(), (0, 0, 0, 64 * t.steps - 9 * cin8))
    acc = a @ wk + b.float()
    y = acc[:npix].to(x.dtype).reshape(bsz, h, wd, cout)
    v = acc.clone()
    if mask:
        v[npix:] = 0.0
    warps = lambda u: u.reshape(tiles, t.bm // 16, 16, cout).sum(dim=2)  # noqa: E731
    ps, pq = warps(v), warps(v * v)
    ps, pq = sum(ps[:, i] for i in range(t.bm // 16)), sum(pq[:, i] for i in range(t.bm // 16))
    assert ps.shape == (partial_rows(npix, cin, cout, torch.bfloat16), cout)
    return y, ps.sum(dim=0) / npix, pq.sum(dim=0) / npix


def _emulated_case(cin, cout, where, dtype, seed):
    bm = stats_tiling(cin, cout).bm
    bsz, h, wd = PIXELS[bm][where]
    npix = bsz * h * wd
    assert (npix < bm) if where == "below" else (bm < npix < 2 * bm)
    x, w, b = _inputs(seed, bsz, h, wd, cin, cout)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    targs = (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.from_numpy(b))
    jargs = (jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b))
    return targs, jargs, ROWS[h]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["below", "past"])
@pytest.mark.parametrize("cin,cout", EMULATED, ids=lambda v: str(v))
def test_tiled_kernel_emulation_matches_plain_and_the_interpreted_tpu_kernel(cin, cout, where, dtype):
    """The bf16 kernel's tiling with the phantom rows masked gives y, mean and mean2 of the plain
    version and of the JAX kernel in interpret mode, with P below one tile and just past one."""
    targs, jargs, rows = _emulated_case(cin, cout, where, dtype, cin + cout + len(where))
    got = _tiled_stats(*targs)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (conv3x3_bias_stats_plain(*targs), _interpreted_kernel(*jargs, rows)):
        assert got[0].dtype == targs[0].dtype and got[0].shape == tuple(np.shape(want[0]))
        for g, r in zip(got, want):
            _close(g, np.asarray(r.float() if isinstance(r, torch.Tensor) else r, np.float32), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["below", "past"])
@pytest.mark.parametrize("cin,cout", [EMULATED[0], EMULATED[3]], ids=lambda v: str(v))
def test_tiled_emulation_without_the_phantom_row_mask_misses(cin, cout, where, dtype):
    """Without the mask every ragged shape's mean is off by bias * phantoms / P: the tolerance that
    the masked tiling meets catches it, so the emulation above can see the fault."""
    targs, _, _ = _emulated_case(cin, cout, where, dtype, cin + cout + len(where))
    assert targs[2].abs().min() > 0
    want = conv3x3_bias_stats_plain(*targs)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for mask in (True, False):
        y, mean, mean2 = _tiled_stats(*targs, mask=mask)
        err = (mean - want[1]).abs().max().item()
        assert torch.equal(y, _tiled_stats(*targs)[0])  # y never shows the phantom rows
        assert (err <= tol * want[1].abs().max().item()) == mask, (mask, err)


def _instantiated_stats_tilings():
    """{(NB, stages)} of the bf16 kernels that csrc/conv_bn_stats.cu launches (stages 0: the persistent
    kernel, at x of 3 or 8 channels)."""
    src = (CSRC / "conv_bn_stats.cu").read_text()
    ring = re.findall(r"if \(nb == (\d+) && stages == (\d+)\) return launch_stats_wgmma<(\d+), (\d+)>\(", src)
    narrow = re.findall(r"if \(nb == 64 && stages == 0 && cin == (\d+)\) return launch_stats_narrow<(\d+)>\(", src)
    assert ring and all(a == c and b == d for a, b, c, d in ring)
    assert sorted(narrow) == [("3", "3"), ("8", "8")]
    return {(int(a), int(b)) for a, b, _, _ in ring} | {(64, 0)}


@pytest.mark.parametrize("cin", [1, 3, 8, 16, 24, 64, 520])
def test_stats_wrapper_tilings_and_partial_rows_are_the_ones_the_kernel_dispatches(cin):
    """The (NB, stages) that the bf16 wrapper passes (stats_tiling's: conv_tiling's with three stages
    at NB 128, two blocks an SM) are the ones conv_bn_stats.cu instantiates, and its partial sums have
    one row per tile the kernels write: blockIdx.x of the ring's 128-pixel tiles, t of the persistent
    kernel's 64-pixel tiles, blockIdx.x of the f32 kernel's 64-pixel blocks; three persistent blocks
    with their scratch fit an SM."""
    header = (CSRC / "conv3x3_wgmma.cuh").read_text()
    const = {name: int(val) for name, val in re.findall(r"constexpr int (k\w+) = (\d+);", header)}
    src = (CSRC / "conv_bn_stats.cu").read_text()
    assert F32_BLOCK_PIXELS == int(re.search(r"constexpr int kM = (\d+);", src).group(1))
    assert "psum[(size_t)blockIdx.x * cout + n] = s;" in src
    assert "write_row<kThreads / 32, NB>(reinterpret_cast<float*>(so + kBM * LD), blockIdx.x, n0)" in header
    assert "write_row<kNarrowThreads / 32, NB>(reinterpret_cast<const float*>(base + otile + BM * 128), t, 0)" in header
    assert "kNarrowStatsBytes = 2 * (kNarrowThreads / 32) * 64 * 4;" in header
    narrow_smem = 1024 + 3 * NARROW_BLOCK_PIXELS * 128 + 2 * 64 * 128 + 2 * 4 * 64 * 4
    assert "constexpr int smem = wgconv::kNarrowSmemBytes + wgconv::kNarrowStatsBytes;" in src
    assert 3 * (narrow_smem + 1024) <= 233472 and "__launch_bounds__(wgconv::kNarrowThreads, 3)" in src
    instances, seen = _instantiated_stats_tilings(), set()
    for cout in (8, 40, 64, 72, 128, 136, 256, 512, 520):
        t, conv = stats_tiling(cin, cout), conv_tiling(cin, cout)
        assert t._replace(stages=conv.stages, smem_bytes=conv.smem_bytes) == conv
        assert t.stages == (3 if conv.stages and t.nb == 128 else conv.stages)
        assert t.smem_bytes == (1024 + t.stages * (t.bm * 128 + t.nb * 128 + 8) if t.stages else conv.smem_bytes)
        assert 232448 // t.smem_bytes >= (2 if t.nb == 128 else 1)
        seen.add((t.nb, t.stages))
        assert (t.nb, t.stages) in instances and t.bm == (CONV_BLOCK_PIXELS if t.stages else NARROW_BLOCK_PIXELS)
        assert CONV_BLOCK_PIXELS == 64 * const["kWarpgroups"] and NARROW_BLOCK_PIXELS == const["kNarrowBM"]
        for npix in (1, 63, 64, 65, 127, 128, 129, 128 * 224 * 224 + 77):
            assert partial_rows(npix, cin, cout, torch.bfloat16) == -(-npix // t.bm)
            assert partial_rows(npix, cin, cout, torch.float32) == -(-npix // F32_BLOCK_PIXELS)
    assert seen == instances - ({(64, 4)} if cin <= 8 else {(64, 0)})  # Cin <= 8 at Cout <= 64: no ring


@pytest.mark.parametrize("npix,cin,cout,dtype", [(1, 3, 64, torch.bfloat16), (35, 8, 40, torch.bfloat16),
                                                (200, 16, 24, torch.bfloat16), (12293, 64, 136, torch.bfloat16),
                                                (4097, 16, 24, torch.float32)])
def test_row_means_sum_every_written_row_once(npix, cin, cout, dtype):
    """The wrapper's buffer holds partial_rows rows rounded up to ROW_GROUP, the rows past them zero,
    and row_means gives the written rows' sums over npix, whatever their count."""
    rows = partial_rows(npix, cin, cout, dtype)
    partial = partial_buffer(npix, cin, cout, dtype, "cpu")
    assert partial.shape == (2, -(-rows // ROW_GROUP) * ROW_GROUP, cout) and partial.dtype == torch.float32
    assert not partial[:, rows:].any()
    partial[:, :rows] = torch.from_numpy(np.random.default_rng(rows).standard_normal((2, rows, cout)).astype(np.float32))
    want = partial[:, :rows].double().sum(dim=1) / npix
    for got, ref in zip(row_means(partial, npix), want):
        assert got.dtype == torch.float32 and got.shape == (cout,)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5 * max(1.0, ref.abs().max().item()))


def test_chip_smoke_checks_the_stats_kernel_at_its_tilings():
    """chip_smoke.py's phase 3 holds conv3x3_bias_stats (after a NaN launch) at Cin 3, 8, 16, 24 and
    520 and Cout 8, 40, 64, 128 and 512, on both bf16 kernels, at pixel counts below one tile, just
    past one and ragged, and at one pixel; phase 9 launches each probe level twice and compares the
    bits; phase 2 reads ptxas on both new kernels."""
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = smoke.STATS_ODD_SHAPES
    assert {3, 8, 16, 24, 520} <= {cin for *_, cin, _ in shapes}
    assert {8, 40, 64, 128, 512} <= {c for *_, c in shapes}
    tilings = {(b * h * w, stats_tiling(cin, c)) for b, h, w, cin, c in shapes}
    assert {(t.nb, t.stages) for _, t in tilings} == _instantiated_stats_tilings()
    assert any(p < t.bm for p, t in tilings) and any(t.bm < p < 2 * t.bm for p, t in tilings)
    assert any(p % t.bm for p, t in tilings if p > t.bm) and (1, 1, 1) in {s[:3] for s in shapes}
    src = (ROOT / "chip_smoke.py").read_text()
    assert "STATS_ODD_SHAPES" in src.split("[3]")[1] and '"conv3x3_bias_stats": stats_levels' in src
    assert "conv3x3_bias_stats_wgmma_kernel" in src and "conv3x3_bias_stats_narrow_kernel" in src
    assert '2 * len(probe.LEVELS)' in src and "torch.equal(u, v)" in src
