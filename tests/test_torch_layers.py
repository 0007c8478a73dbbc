"""The port's new layers against the JAX layers, weights carried by from_jax_variables.

Each JAX layer is initialised for its shapes, its parameters are replaced
by seeded numpy values (so scales and biases count), converted to a state
dict and loaded with strict=True.  f32 on both sides, atol 1e-5 (sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from _torch_port import images, to_nchw, to_nhwc
from dfc_sa_unet_tpu.nn import layers as jl
from dfc_sa_unet_tpu.ops.pooling import max_pool as jax_max_pool
from dfc_sa_unet_torch.nn import layers as tl
from dfc_sa_unet_torch.ops.pooling import max_pool
from dfc_sa_unet_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)
ATOL = 1e-5


def _seeded_variables(jlayer, x, seed):
    variables = jlayer.init(jax.random.key(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32), variables)


def _loaded(tlayer, variables):
    holder = nn.ModuleDict({"m": tlayer})
    holder.load_state_dict(from_jax_variables({"params": {"m": variables["params"]}}), strict=True)
    return tlayer.eval()


def _check_nhwc(jlayer, tlayer, shape, seed, scale=1.0):
    x = scale * images(seed, shape)
    variables = _seeded_variables(jlayer, x, seed + 1)
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = to_nhwc(_loaded(tlayer, variables)(to_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def _check_tokens(jlayer, tlayer, shape, seed):
    x = images(seed, shape)
    variables = _seeded_variables(jlayer, x, seed + 1)
    want = np.asarray(jlayer.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _loaded(tlayer, variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dense():
    _check_tokens(jl.Dense(24), tl.Dense(16, 24), (2, 7, 16), 0)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm(eps):
    _check_tokens(jl.LayerNorm(eps=eps), tl.LayerNorm(32, eps=eps), (2, 7, 32), 1)


@pytest.mark.parametrize("groups,channels,eps", [(32, 64, 1e-6), (16, 16, 1e-5)])
def test_group_norm(groups, channels, eps):
    _check_nhwc(jl.GroupNorm(groups, eps=eps), tl.GroupNorm(groups, channels, eps=eps), (2, 9, 7, channels), 2)


@pytest.mark.parametrize("kernel,stride,padding", [(1, 1, 0), (3, 2, 1), (7, 2, 3)])
def test_ws_conv(kernel, stride, padding):
    # standardised weights have unit variance: scale the input by 1/sqrt(fan_in) for O(1) outputs
    _check_nhwc(jl.WSConv(12, kernel, stride=stride, padding=padding),
                tl.WSConv(5, 12, kernel, stride=stride, padding=padding), (2, 17, 14, 5), 3,
                scale=(5 * kernel * kernel) ** -0.5)


def test_conv_transpose_4_2_1():
    _check_nhwc(jl.ConvTranspose(6, kernel_size=4, stride=2, padding=1),
                tl.ConvTranspose(5, 6, kernel_size=4, stride=2, padding=1), (2, 7, 5, 5), 4)


def test_conv_transpose_2_2_0():
    _check_nhwc(jl.ConvTranspose(6), tl.ConvTranspose(5, 6), (2, 7, 5, 5), 5)


@pytest.mark.parametrize("kernel,stride", [(8, 8), ((2, 1), (2, 1))])
def test_strided_conv(kernel, stride):
    _check_nhwc(jl.Conv(10, kernel, stride=stride), tl.Conv(3, 10, kernel, stride=stride), (2, 16, 24, 3), 6)


@pytest.mark.parametrize("h,w", [(15, 13), (16, 16)])
def test_padded_max_pool(h, w):
    x = images(7, (2, h, w, 4))
    want = np.asarray(jax_max_pool(jnp.asarray(x), 3, 2, padding=1))
    got = to_nhwc(max_pool(to_nchw(x), 3, 2, padding=1))
    assert got.shape == want.shape == (2, (h + 1) // 2, (w + 1) // 2, 4)
    np.testing.assert_array_equal(got, want)


def test_layers_emit_the_compute_dtype_with_f32_parameters():
    x = torch.from_numpy(images(8, (2, 5, 16)))
    dense = tl.Dense(16, 8, compute_dtype=torch.bfloat16)
    assert dense(x).dtype == torch.bfloat16 and dense.weight.dtype == torch.float32
    assert tl.LayerNorm(16)(x.bfloat16()).dtype == torch.bfloat16
    img = torch.from_numpy(images(9, (1, 32, 6, 6)))
    assert tl.GroupNorm(32, 32)(img.bfloat16()).dtype == torch.bfloat16
    assert tl.WSConv(32, 8, 3, padding=1, compute_dtype=torch.bfloat16)(img).dtype == torch.bfloat16
