"""The port's DFCEngine against the port module and the JAX DFCEngine.

Weights with jittered BatchNorm statistics (as tests/test_engine.py:14-29)
so the folding counts.  f32, atol 2e-4 / rtol 1e-3, the gate of
tests/test_engine.py: folding BN into the weights reorders the f32
arithmetic of every conv.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SMALL, images, jax_model_and_variables, port_model, to_nchw, to_nhwc
from dfc_sa_unet_tpu.infer.engine import DFCEngine as JaxDFCEngine
from dfc_sa_unet_torch.infer.engine import DFCEngine, fold_conv_bn
from dfc_sa_unet_torch.ops import launches, reset_launches

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=1e-3)
CFG = {"model": SMALL}


def test_fold_conv_bn_formula():
    g = torch.Generator().manual_seed(0)
    w, b = torch.randn(6, 4, 3, 3, generator=g), torch.randn(6, generator=g)
    bn_w, bn_b = torch.rand(6, generator=g) + 0.5, torch.randn(6, generator=g)
    mean, var = torch.randn(6, generator=g), torch.rand(6, generator=g) + 0.5
    x = torch.randn(2, 4, 8, 8, generator=g)
    y = torch.nn.functional.conv2d(x, w, b, padding=1)
    want = (y - mean.view(-1, 1, 1)) / torch.sqrt(var.view(-1, 1, 1) + 1e-5) * bn_w.view(-1, 1, 1) + bn_b.view(-1, 1, 1)
    wf, bf = fold_conv_bn(w, b, bn_w, bn_b, mean, var)
    np.testing.assert_allclose(torch.nn.functional.conv2d(x, wf, bf, padding=1).numpy(), want.numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("levels", [None, "auto"])
@pytest.mark.parametrize("hw", [(28, 28), (48, 40)])
def test_engine_matches_module_and_jax_engine(levels, hw):
    model = port_model(SMALL, seed=4)
    x = images(4, (2, *hw, 3))
    with torch.no_grad():
        module_out = to_nhwc(model(to_nchw(x)))
    engine = DFCEngine(CFG, model, dtype=torch.float32, device="cpu", tail_kernel_levels=levels,
                       conv_kernel_levels=levels)
    got = to_nhwc(engine(to_nchw(x)))
    np.testing.assert_allclose(got, module_out, **TOL)

    _, variables = jax_model_and_variables(SMALL, model, hw)
    # the TPU tail kernel needs rows that split into 8-sublane tiles, which
    # 48x40 at pool 4 does not; there the JAX engine runs its lax tail
    jax_levels = levels if hw == (28, 28) else None
    jengine = JaxDFCEngine(CFG, variables, dtype=jnp.float32, pallas_conv_levels=jax_levels)
    np.testing.assert_allclose(got, np.asarray(jengine(jnp.asarray(x))), **TOL)


def test_engine_levels_and_cpu_launch_counts():
    model = port_model(SMALL, seed=5)
    engine = DFCEngine(CFG, model.state_dict(), dtype=torch.float32, device="cpu",
                       tail_kernel_levels="auto", conv_kernel_levels="auto")
    assert len(engine.tail_kernel_levels) == 7
    assert engine.conv_kernel_levels == {"down1", "bottleneck"}
    reset_launches()
    engine(to_nchw(images(5, (1, 28, 28, 3))))
    assert set(launches().values()) == {0}  # CPU tensors run the plain versions
    with pytest.raises(ValueError, match="unknown block"):
        DFCEngine(CFG, model, device="cpu", tail_kernel_levels={"down9"})
    with pytest.raises(ValueError, match="in both"):
        DFCEngine(CFG, model, device="cpu", tail_kernel_levels="auto", conv_kernel_levels={"down2"})


def test_engine_bf16_tracks_f32():
    model = port_model(SMALL, seed=6)
    x = to_nchw(images(6, (1, 28, 28, 3)))
    f32 = DFCEngine(CFG, model, dtype=torch.float32, device="cpu", tail_kernel_levels="auto")(x)
    bf16 = DFCEngine(CFG, model, dtype=torch.bfloat16, device="cpu", tail_kernel_levels="auto")(x)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), atol=0.1, rtol=0.05)
