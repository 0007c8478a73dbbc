"""The plain versions of the matrix-unit probes against the JAX probe they are a
port of (scripts/bench_mxu.py): the Pallas kernel bodies ``_mm_kernel``,
``_conv_cat_kernel`` and ``_conv_9dot_kernel`` run in interpret mode through
``pallas_call``s built here with the script's specs (bench_mxu.py:62-70 and
:114-125) at a small tile and row count, and ``xla_conv``.  The CUDA kernels
themselves are held against these plain versions on the card by chip_smoke.py.

f32: 1e-5 of max|reference| (the same f32 sums in another order).  bf16:
inputs rounded to bf16 on both sides, then 2e-2 of max|reference|: the output
is rounded once to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.ops import mxu_probes as ops
from scripts import bench_mxu as probe

torch.set_num_threads(2)
# B, H, W, Cin, Cout, rows per block of the interpreted kernel; an odd H != W among them
CONV_SHAPES = [(2, 8, 8, 8, 16, 4), (2, 7, 5, 8, 24, 7), (1, 12, 9, 16, 8, 3)]
CONV_IDS = ["8x8_r4", "7x5_r7", "12x9_r3"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _conv_inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, cin)).astype(np.float32),
            (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32))


def _interpreted_matmul(x, w, tile):
    """``pl_matmul`` (bench_mxu.py:58-70) with ``interpret=True`` and a small tile."""
    m, kk = x.shape
    n = w.shape[-1]
    return pl.pallas_call(
        probe._mm_kernel,
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        grid=(m // tile,),
        in_specs=[pl.BlockSpec((tile, kk), lambda i: (i, 0)),
                  pl.BlockSpec((kk, n), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((tile, n), lambda i: (i, 0)),
        interpret=True,
    )(x, w)


def _interpreted_conv(x, w, kernel_fn, r):
    """``_pl_conv`` (bench_mxu.py:110-125) with ``interpret=True`` and ``r`` rows per block."""
    bsz, h, width, cin = x.shape
    cout = w.shape[-1]
    xp = jnp.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0)))
    return pl.pallas_call(
        kernel_fn,
        out_shape=jax.ShapeDtypeStruct((bsz, h, width, cout), x.dtype),
        grid=(bsz, h // r),
        in_specs=[
            pl.BlockSpec((pl.Element(1), pl.Element(r + 2), pl.Element(width), pl.Element(cin)),
                         lambda i, j: (i, j * r, 0, 0)),
            pl.BlockSpec(w.shape, lambda i, j: (0,) * w.ndim),
        ],
        out_specs=pl.BlockSpec((1, r, width, cout), lambda i, j: (i, j, 0, 0)),
        interpret=True,
    )(xp, w)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def _pair(a, dtype):
    """The same values, rounded to ``dtype``, as a torch and a JAX array."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return torch.from_numpy(a).to(dtype), jnp.asarray(a, jdtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,tile", [((24, 16, 8), 8), ((40, 24, 16), 20)], ids=["24x16x8", "40x24x16"])
def test_matmul_plain_matches_the_interpreted_tpu_kernel(shape, tile, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m)
    (tx, jx), (tw, jw) = _pair(rng.standard_normal((m, k)).astype(np.float32), dtype), \
        _pair(rng.standard_normal((k, n)).astype(np.float32), dtype)
    got = ops.probe_matmul(tx, tw)
    assert got.dtype == dtype
    _close(got, _interpreted_matmul(jx, jw, tile), TOL[str(dtype).split(".")[-1]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=CONV_IDS)
@pytest.mark.parametrize("layout", ["cat", "9dot"])
def test_conv_plain_matches_the_interpreted_tpu_kernel(layout, shape, dtype):
    b, h, w, cin, cout, rows = shape
    x, w4 = _conv_inputs(h * w + cin, b, h, w, cin, cout)
    wshape = (3, 3 * cin, cout) if layout == "cat" else (9, cin, cout)
    (tx, jx), (tw, jw) = _pair(x, dtype), _pair(w4.reshape(wshape), dtype)
    if layout == "cat":
        got, body = ops.probe_conv_cat(tx, tw), probe._conv_cat_kernel
    else:
        got, body = ops.probe_conv_9dot(tx, tw), probe._conv_9dot_kernel
    assert got.dtype == dtype
    _close(got, _interpreted_conv(jx, jw, body, rows), TOL[str(dtype).split(".")[-1]])


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=CONV_IDS)
def test_conv_plain_versions_match_xla_conv_and_each_other(shape):
    """One HWIO weight reshaped into the two layouts gives the same conv."""
    b, h, w, cin, cout, _ = shape
    x, w4 = _conv_inputs(h + w, b, h, w, cin, cout)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w4)
    cat = ops.probe_conv_cat_plain(tx, tw.reshape(3, 3 * cin, cout))
    dot = ops.probe_conv_9dot_plain(tx, tw.reshape(9, cin, cout))
    want = probe.xla_conv(jnp.asarray(x), jnp.asarray(w4))
    _close(cat, want, 1e-5)
    _close(dot, want, 1e-5)
    _close(cat, dot.numpy(), 1e-6)


def test_cpu_wrappers_launch_nothing_and_other_devices_never_fall_back():
    reset_launches()
    x, w4 = (torch.from_numpy(t) for t in _conv_inputs(0, 1, 4, 4, 8, 8))
    ops.probe_matmul(x.reshape(16, 8), w4.reshape(72, 8)[:8])
    ops.probe_conv_cat(x, w4.reshape(3, 24, 8))
    ops.probe_conv_9dot(x, w4.reshape(9, 8, 8))
    counts = launches()
    assert counts["probe_matmul"] == counts["probe_conv_cat"] == counts["probe_conv_9dot"] == 0
    for fn, args in ((ops.probe_matmul, (x.reshape(16, 8).to("meta"), w4.reshape(72, 8)[:8])),
                     (ops.probe_conv_cat, (x, w4.reshape(3, 24, 8).to("meta"))),
                     (ops.probe_conv_9dot, (x.to("meta"), w4.reshape(9, 8, 8)))):
        with pytest.raises(ValueError, match=fn.__name__):
            fn(*args)


def test_probe_script_bounds_and_operands():
    """scripts/bench_torch_mxu.py at the probe's shape: the bounds written into PERF.md
    (0.153 ms by bytes for the matmul, 0.239 ms by operations for either conv) and one
    weight behind both conv layouts."""
    from scripts import bench_torch_mxu as script

    need = script.bounds(128)
    assert need["matmul"][1] == 2 * 401408 * 384 * 256 and need["conv"][1] == 3 * need["matmul"][1]
    mm, conv = script.bound_ms(*need["matmul"]), script.bound_ms(*need["conv"])
    assert mm[1] == "bytes" and abs(mm[0] - 0.153) < 1e-3
    assert conv[1] == "operations" and abs(conv[0] - 0.239) < 1e-3
    x2, w2, x, w4 = script.inputs(1, torch.Generator().manual_seed(0), h=4, w=4, cin=8, cout=8)
    assert x2.shape == (16, 24) and w2.shape == (24, 8) and x.shape == (1, 4, 4, 8) and w4.shape == (3, 3, 8, 8)
    assert x.dtype == torch.bfloat16


def test_conv_wrapper_rows_and_shared_memory_match_the_wgmma_mainloop():
    """The wrapper's BLOCK_ROWS is the pixel tile of csrc/conv3x3_wgmma.cuh, whose ring (kStages
    buffers of a tap tile and a weight tile in bf16, plus 1 KB of alignment slack) fits in the
    232448 bytes an H100 block may use, whatever Cin: the wrapper checks no shared-memory limit."""
    import pathlib
    import re

    src = (pathlib.Path(ops.__file__).resolve().parent.parent / "csrc" / "conv3x3_wgmma.cuh").read_text()
    const = {name: int(val) for name, val in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    bm = 64 * const["kWarpgroups"]
    assert bm == ops.BLOCK_ROWS
    assert const["kStages"] * 2 * (bm * const["kBK"] + const["kBK"] * const["kBN"]) + 1024 <= 232448


def test_matmul_kernel_tile_and_shared_memory_fit_one_block():
    """csrc/mxu_probes.cu's GEMM: 128-row tiles (the wrapper's BLOCK_ROWS) of 256 columns, two
    consumer warpgroups of 64 rows and a producer warpgroup, and in shared memory the output tile
    (bf16), a ring of stages of a 128 x 64 box of x and four 64 x 64 boxes of w, two barriers a
    stage and 1 KB of alignment slack: within the 232448 bytes an H100 block may use, with at
    least three stages (the producer two steps ahead of the one in flight)."""
    import pathlib
    import re

    src = (pathlib.Path(ops.__file__).resolve().parent.parent / "csrc" / "mxu_probes.cu").read_text()
    const = {name: int(val) for name, val in re.findall(r"constexpr int (kGemm\w+) = (\d+);", src)}
    bm, bn, stages = const["kGemmBM"], const["kGemmBN"], const["kGemmStages"]
    assert bm == ops.BLOCK_ROWS == 64 * const["kGemmConsumers"] and bn == 256
    stage = bm * 64 * 2 + 64 * bn * 2
    assert stage == 48 * 1024 and stages >= 3
    assert 1024 + bm * bn * 2 + stages * stage + 2 * 8 * stages <= 232448


@pytest.mark.parametrize("m,k,n", [(4 * 56 * 56, 384, 256), (1000, 384, 256), (129, 8, 8), (128 * 56 * 56 + 77, 384, 256)])
def test_chip_smoke_checks_the_matmul_kernel_at_ragged_and_large_shapes(m, k, n):
    """chip_smoke.py's phase 3 holds probe_matmul to its plain version (after a NaN launch) at the
    probe's shape cut in B, at row counts that no 128-row tile divides, at K = N = 8 (one TMA box
    mostly past the tensor) and at the probe's full M plus a ragged tile, more tiles than blocks
    on the card's 132 SMs; the wrapper takes them all (no grid limit on M)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", pathlib.Path(__file__).resolve().parent.parent
                                                  / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (m, k, n) in smoke.PROBE_MATMUL_SHAPES
    assert k % 8 == 0 and n % 8 == 0 and 0 < m < 2**31
    if m > 10**5:
        assert m % ops.BLOCK_ROWS and -(-m // ops.BLOCK_ROWS) > 132
