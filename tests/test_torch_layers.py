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


@pytest.mark.parametrize("shape", [(4, 6, 5, 8), (1, 3, 3, 4)], ids=["batch4", "one_image"])
def test_batch_norm_training_path(shape):
    """Train mode against the JAX layer: the batch's biased variance normalises, the unbiased one
    moves the running statistics with momentum 0.1, in f32 whatever the input; output, running
    statistics and the gradients of x, scale and bias to 1e-5 (JAX takes max(E[x^2]-E[x]^2, 0),
    torch a two-pass variance)."""
    x = 2.0 * images(3, shape) + 0.5
    jlayer = jl.BatchNorm()
    variables = jlayer.init(jax.random.key(0), jnp.asarray(x), False)
    rng = np.random.default_rng(4)
    variables = jax.tree.map(lambda a: (1.0 + 0.3 * rng.uniform(-1, 1, a.shape)).astype(np.float32), variables)
    w = images(5, shape)

    def f(params, xj):
        y, mutated = jlayer.apply({"params": params, "batch_stats": variables["batch_stats"]}, xj, True,
                                  mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mutated["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(variables["params"],
                                                                                     jnp.asarray(x))
    layer = tl.BatchNorm(shape[-1])
    holder = nn.ModuleDict({"m": layer})
    holder.load_state_dict(from_jax_variables({"params": {"m": variables["params"]},
                                               "batch_stats": {"m": variables["batch_stats"]}}), strict=True)
    layer.train()
    xt = to_nchw(x).requires_grad_(True)
    got = layer(xt)
    (got * to_nchw(w)).sum().backward()
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(layer.running_mean.numpy(), np.asarray(stats["mean"]), atol=ATOL)
    np.testing.assert_allclose(layer.running_var.numpy(), np.asarray(stats["var"]), atol=ATOL)
    assert int(layer.num_batches_tracked) == 1
    for g, ref in ((to_nhwc(xt.grad), gx), (layer.weight.grad.numpy(), gp["scale"]), (layer.bias.grad.numpy(), gp["bias"])):
        np.testing.assert_allclose(g, np.asarray(ref), atol=ATOL * max(1.0, np.abs(np.asarray(ref)).max()))
    half = layer(to_nchw(x).bfloat16())
    assert half.dtype == torch.bfloat16 and layer.running_mean.dtype == torch.float32


def test_in_place_bias_add_under_autograd():
    """``add_bias_`` writes into the conv's (or the product's) bf16 output: the f32 bias must get an
    f32 gradient, the conv's saved tensors must stay intact (backward would raise otherwise), and
    the gradients must equal those of the out-of-place sum."""
    torch.manual_seed(0)
    for layer, x in ((tl.Conv(3, 8, 3, padding=1, compute_dtype=torch.bfloat16), torch.randn(2, 3, 6, 6)),
                     (tl.Dense(5, 7, compute_dtype=torch.bfloat16), torch.randn(2, 4, 5)),
                     (tl.ConvTranspose(3, 4, 4, 2, 1, compute_dtype=torch.bfloat16), torch.randn(2, 3, 5, 5))):
        xa = x.clone().requires_grad_(True)
        y = layer(xa)
        assert y.dtype == torch.bfloat16
        w = torch.randn(y.shape)
        (y.float() * w).sum().backward()
        assert layer.bias.grad.dtype == torch.float32 and layer.weight.grad.dtype == torch.float32
        got = [g.clone() for g in (xa.grad, layer.weight.grad, layer.bias.grad)]
        layer.zero_grad()
        xb = x.clone().requires_grad_(True)
        if isinstance(layer, tl.Dense):
            raw = torch.nn.functional.linear(xb.bfloat16(), layer.weight.bfloat16())
            ref = (raw + layer.bias).to(torch.bfloat16)
        elif isinstance(layer, tl.ConvTranspose):
            raw = torch.nn.functional.conv_transpose2d(xb.bfloat16(), layer.weight.bfloat16(), None, 2, 1)
            ref = (raw + layer.bias.view(-1, 1, 1)).to(torch.bfloat16)
        else:
            raw = torch.nn.functional.conv2d(xb.bfloat16(), layer.weight.bfloat16(), None, 1, 1)
            ref = (raw + layer.bias.view(-1, 1, 1)).to(torch.bfloat16)
        assert torch.equal(ref, y)
        (ref.float() * w).sum().backward()
        for g, r in zip(got, (xb.grad, layer.weight.grad, layer.bias.grad)):
            assert torch.allclose(g, r, rtol=0, atol=1e-6 * max(1.0, r.abs().max().item()))
