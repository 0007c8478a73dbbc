"""The port's plain ops against the JAX package's ops, on the CPU.

Inputs come from numpy seeds; the port takes NCHW (its model layout) and
JAX NHWC, so results are permuted before comparing.  f32 throughout;
atol 1e-5: both sides compute the same sums in f32, in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfc_sa_unet_tpu.config import load_config as jax_load_config
from dfc_sa_unet_tpu.data.loader import normalize_on_device
from dfc_sa_unet_tpu.metrics import confusion_counts as jax_confusion_counts
from dfc_sa_unet_tpu.metrics import metrics_from_counts as jax_metrics_from_counts
from dfc_sa_unet_tpu.ops import convt as jconvt, pooling as jpool, resize as jresize
from dfc_sa_unet_torch.config import load_config
from dfc_sa_unet_torch.data.normalize import normalize
from dfc_sa_unet_torch.metrics import confusion_counts, metrics_from_counts
from dfc_sa_unet_torch.ops.convt import conv_transpose_2x2
from dfc_sa_unet_torch.ops.pooling import adaptive_avg_pool, max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear

torch.set_num_threads(2)
ATOL = 1e-5


def _nhwc(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _port(fn, x_nhwc, *args):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    return fn(x, *args).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,out", [
    ((2, 16, 16, 5), (4, 4)),
    ((1, 13, 11, 3), (4, 4)),    # uneven torch windows
    ((1, 3, 5, 2), (8, 8)),      # p > H, W: overlapping one-pixel windows
    ((1, 28, 28, 4), (28, 28)),  # identity
])
def test_adaptive_avg_pool(shape, out):
    x = _nhwc(np.random.default_rng(0), shape)
    want = np.asarray(jpool.adaptive_avg_pool(jnp.asarray(x), out))
    np.testing.assert_allclose(_port(adaptive_avg_pool, x, out), want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 9, 7, 2), (1, 13, 11, 4)])
def test_max_pool(shape):
    x = _nhwc(np.random.default_rng(1), shape)
    want = np.asarray(jpool.max_pool(jnp.asarray(x), 2, 2))
    np.testing.assert_allclose(_port(max_pool, x, 2, 2), want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 9, 7, 2), (1, 13, 11, 4), (2, 5, 3, 2), (1, 1, 1, 3)])
def test_max_pool_ceil_mode(shape):
    """MaxPool2d(2, ceil_mode=True), the vanilla UNet's Down: an odd size keeps its last row and column."""
    x = _nhwc(np.random.default_rng(6), shape) - 3.0  # all negative in places: the -inf edge must not win
    want = np.asarray(jpool.max_pool(jnp.asarray(x), 2, 2, ceil_mode=True))
    got = _port(lambda t: max_pool(t, 2, 2, ceil_mode=True), x)
    assert got.shape == (shape[0], -(-shape[1] // 2), -(-shape[2] // 2), shape[3])
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,size", [
    ((1, 4, 4, 3), (8, 8)),      # the UNet's bilinear Up: twice the size
    ((2, 5, 3, 2), (10, 6)),
    ((1, 7, 5, 3), (13, 11)),
    ((1, 1, 3, 2), (2, 6)),      # one row: every output row is that row
])
def test_resize_bilinear_align_corners(shape, size):
    x = _nhwc(np.random.default_rng(7), shape)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), size, align_corners=True))
    got = _port(lambda t: resize_bilinear(t, size, align_corners=True), x)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("shape,size", [
    ((1, 8, 8, 3), (28, 28)),    # the attention upsample
    ((1, 7, 5, 3), (13, 11)),    # odd up
    ((2, 13, 11, 2), (6, 5)),    # odd down
])
def test_resize_bilinear(shape, size):
    x = _nhwc(np.random.default_rng(2), shape)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), size, align_corners=False))
    np.testing.assert_allclose(_port(resize_bilinear, x, size), want, atol=ATOL)


@pytest.mark.parametrize("shape,cout", [((2, 5, 7, 6), 4), ((1, 3, 3, 16), 8)])
def test_conv_transpose_2x2(shape, cout):
    rng = np.random.default_rng(3)
    x = _nhwc(rng, shape)
    kernel = rng.standard_normal((2, 2, shape[-1], cout)).astype(np.float32)  # JAX [2,2,Cin,Cout]
    bias = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jconvt.conv_transpose_2x2(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))
    weight = torch.from_numpy(kernel.transpose(2, 3, 0, 1).copy())  # torch IOHW
    got = _port(conv_transpose_2x2, x, weight, torch.from_numpy(bias))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_normalize():
    u8 = np.random.default_rng(4).integers(0, 256, (2, 9, 7, 3), dtype=np.uint8)
    want = np.asarray(normalize_on_device(jnp.asarray(u8)))
    np.testing.assert_allclose(normalize(torch.from_numpy(u8)).numpy(), want, atol=ATOL)


def test_confusion_counts_and_metrics():
    rng = np.random.default_rng(5)
    pred, gt = rng.integers(0, 2, (37, 41)), rng.integers(0, 2, (37, 41))
    got = confusion_counts(torch.from_numpy(pred), torch.from_numpy(gt))
    want = {k: int(v) for k, v in jax_confusion_counts(jnp.asarray(pred), jnp.asarray(gt)).items()}
    assert got == want
    assert metrics_from_counts(**got) == jax_metrics_from_counts(**want)


def test_load_config_matches_jax():
    path = "configs/config_dfc-sa-res-block.yaml"
    assert load_config(path) == jax_load_config(path)
