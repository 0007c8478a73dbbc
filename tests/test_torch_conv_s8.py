"""The int8 products of the port (ops/conv_s8.py) against the JAX int8 engine's on the CPU.

The plain 3x3 s8 conv (the kernel's oracle on the card) must equal JAX's
``_conv_s8`` (an s8 x s8 -> s32 XLA convolution, quant.py:240) exactly on
ragged shapes, and its dequant epilogue must sit within one unit in the last
place of the output dtype of JAX's (XLA may contract the multiply-add).
``s8_matmul`` must equal an int32 matmul exactly, whatever the padding that
``torch._int_mm``'s CUDA rules ask for.  CPU tensors never launch the kernel;
a tensor on another device raises instead of falling back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfc_sa_unet_tpu.infer.quant import _conv_s8
from dfc_sa_unet_torch.ops import conv_s8 as ops
from dfc_sa_unet_torch.ops import launches, reset_launches

torch.set_num_threads(2)
# (B, H, W, Cin, Cout): Cin 16 (taps packed into a step), 48 (a step across taps), 3 and 272 (zero-padded
# to 16 and 288), odd H and W, one pixel
SHAPES = [(2, 7, 9, 16, 8), (1, 9, 7, 48, 40), (1, 1, 1, 16, 8), (2, 5, 3, 3, 16), (1, 3, 5, 272, 24)]


def _inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x8 = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    k_hwio = rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8)
    scale = (rng.random(cout) * 1e-3 + 1e-4).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x8, k_hwio, scale, bias


def _packed(k_hwio):
    """HWIO [3,3,Cin,Cout] -> the kernel's [Cout, 9 * Cin]."""
    return ops.pack_s8_taps(torch.from_numpy(k_hwio).permute(3, 2, 0, 1))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_s8_product_equals_jax_conv_s8(shape):
    x8, k, _, _ = _inputs(0, *shape)
    want = np.asarray(_conv_s8(jnp.asarray(x8), jnp.asarray(k), 1))
    got = ops.conv3x3_s8_s32(torch.from_numpy(x8), _packed(k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_plain_epilogue_within_one_ulp_of_jax(shape, dtype):
    """ReLU(acc * (sx * s_w) + b) cast once, as Int8DFCEngine._block (quant.py:286-290)."""
    x8, k, s_w, bias = _inputs(1, *shape)
    sx = 0.0123
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    acc = _conv_s8(jnp.asarray(x8), jnp.asarray(k), 1)
    want = np.asarray(jnp.maximum(acc.astype(jnp.float32) * (sx * jnp.asarray(s_w)) + jnp.asarray(bias), 0.0)
                      .astype(jdt).astype(jnp.float32))
    got = ops.conv3x3_s8(torch.from_numpy(x8), _packed(k), sx * torch.from_numpy(s_w), torch.from_numpy(bias),
                         out_dtype=dtype)
    assert got.dtype == dtype and got.shape == want.shape
    ulp = np.spacing(np.abs(want).astype(np.float32)) * (1 if dtype == torch.float32 else 2 ** 16)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp), np.abs(got.float().numpy() - want).max()


def test_pack_s8_taps_is_the_kernels_k_walk():
    """Column tap * Cin + c of the packed weight is tap (dy+1)*3 + (dx+1), channel c of HWIO."""
    _, k, _, _ = _inputs(2, 1, 1, 1, 5, 3)
    packed = _packed(k).numpy()
    for tap in range(9):
        for c in range(5):
            np.testing.assert_array_equal(packed[:, tap * 5 + c], k[tap // 3, tap % 3, c])


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (16, 27, 5), (17, 8, 8), (300, 3072, 40), (64, 768, 2304)])
def test_s8_matmul_equals_an_int32_matmul(m, k, n):
    """Rows under 17 and K, N off a multiple of 8 are zero-padded for _int_mm; K = 3072 sums reach
    3072 * 127^2 = 5e7, past f32's exact integers."""
    rng = np.random.default_rng(m + k + n)
    x8 = rng.integers(-128, 128, (m, k), dtype=np.int8)
    w8 = rng.integers(-127, 128, (n, k), dtype=np.int8)
    want = x8.astype(np.int64) @ w8.astype(np.int64).T
    got = ops.s8_matmul_s32(torch.from_numpy(x8), torch.from_numpy(w8))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    scale = torch.from_numpy(rng.random(n).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    y = ops.s8_matmul(torch.from_numpy(x8).reshape(1, m, k), torch.from_numpy(w8), scale, bias)
    assert torch.equal(y, (got.float() * scale + bias).reshape(1, m, n))


def test_s8_tiling():
    assert [ops.s8_tiling(c) for c in (8, 64, 65, 128, 256, 512, 1024)] == [64, 64, 128, 128, 256, 256, 256]


def test_cpu_runs_the_plain_version_and_other_devices_never_fall_back():
    x8, k, s, b = (torch.from_numpy(t) for t in _inputs(3, 1, 4, 4, 16, 8))
    w8 = _packed(k.numpy())
    reset_launches()
    got = ops.conv3x3_s8(x8, w8, s, b)
    assert launches()["conv3x3_s8"] == 0 and torch.equal(got, ops.conv3x3_s8_plain(x8, w8, s, b))
    with pytest.raises(ValueError, match="CUDA"):
        ops.conv3x3_s8(x8.to("meta"), w8, s, b)
    with pytest.raises(ValueError, match="shapes"):
        ops.conv3x3_s8(x8.to("meta"), w8[:, :-1], s, b)


def test_chip_smoke_checks_the_kernel_at_its_levels_and_ragged_shapes():
    """chip_smoke.py's phase 13 holds conv3x3_s8 (bf16 and f32 out) bit for bit at the int8 engine's four
    auto levels (scripts/bench_torch_int8.py's, the flagship's block shapes) and at Cin 3, 16, 48 and 272,
    Cout 8, 40 and 520, odd H and W, pixel counts that no 128-pixel block divides and one pixel."""
    import importlib.util
    import os

    from dfc_sa_unet_torch.infer.quant import AUTO_INT8_OPS
    from scripts import bench_torch_int8 as bench

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {name for name, *_ in bench.LEVELS} == set(AUTO_INT8_OPS)
    assert set(bench.LEVELS) <= set(smoke.BLOCK_SHAPES)
    shapes = smoke.S8_ODD_SHAPES
    assert {3, 16, 48, 272} <= {cin for *_, cin, _ in shapes} and {8, 40, 520} <= {c for *_, c in shapes}
    assert any(h % 2 and w % 2 for _, h, w, *_ in shapes) and (1, 1, 1) in {s[:3] for s in shapes}
    assert any(b * h * w % ops.BLOCK_PIXELS for b, h, w, *_ in shapes)
    assert smoke.PEAK_OPS["s8"] == bench.PEAK_S8_OPS == 1979e12  # dense int8, H100 SXM


def test_the_int8_bench_refuses_without_cuda():
    """scripts/bench_torch_int8.py measures on the card only: without one it fails and times nothing."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": root}
    out = subprocess.run([sys.executable, os.path.join(root, "scripts", "bench_torch_int8.py")], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr and "ms" not in out.stdout
