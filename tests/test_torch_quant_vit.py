"""The port's int8 ViT-seg engine (infer/quant_vit.py) against the port's module and JAX's engine.

At ``_torch_port.py``'s VIT_SMALL (32x32, patch 8, E 32, one layer, two
heads, MLP 64) with seeded weights and BatchNorm statistics fitted to the
batch: with ``int8_ops={}`` the engine is the port's module (f32, 1e-5, as
tests/test_quant_vit.py holds JAX's); in "auto" it quantizes to JAX's s8
weights, calibrates JAX's scales (1e-5 relative) and, on JAX's scales, serves
JAX's probabilities (1e-3) and masks (99.9% of pixels).  JAX's engine runs
its plain attention (``use_pallas=False``), as its own tests do on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import VIT_SMALL, images, jax_model_and_variables, port_model, to_nchw
from dfc_sa_unet_tpu.infer.quant_vit import Int8ViTEngine as JaxInt8ViTEngine
from dfc_sa_unet_torch.infer.quant_vit import VIT_OPS, Int8ViTEngine
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_

torch.set_num_threads(2)
CFG = {"model": VIT_SMALL}
HW = (32, 32)


@pytest.fixture(scope="module")
def setup():
    """(port module, calibration batch, held-out batch, JAX variables), 20% foreground."""
    model = port_model(VIT_SMALL, seed=2)
    x, held = to_nchw(images(2, (4, *HW, 3))), to_nchw(images(3, (4, *HW, 3)))
    with torch.no_grad():
        calibrate_batch_stats_(model, x)
        model.segmentation_head[-1].bias -= torch.quantile(model(x).flatten(), 0.8)
    _, variables = jax_model_and_variables(VIT_SMALL, model, HW)
    return model, x, held, variables


def _nhwc(x):
    return jnp.asarray(x.permute(0, 2, 3, 1).numpy())


def test_fp_engine_is_the_module(setup):
    model, x, held, _ = setup
    fp = Int8ViTEngine(CFG, model, dtype=torch.float32, device="cpu", int8_ops={})
    assert fp.int8_ops == {} and fp.act_scales == {}
    with torch.no_grad():
        for batch in (x, held):
            np.testing.assert_allclose(fp(batch).numpy(), model(batch).numpy(), atol=1e-5, rtol=1e-5)


def test_int8_auto_quantizes_and_serves_as_jax(setup):
    model, x, held, variables = setup
    jeng = JaxInt8ViTEngine(CFG, variables, dtype=jnp.float32, calib_batches=[_nhwc(x)], use_pallas=False)
    eng = Int8ViTEngine(CFG, model, dtype=torch.float32, device="cpu", calib_batches=[x])
    assert eng.int8_ops == {0: VIT_OPS} == jeng.int8_ops
    assert set(eng.act_scales) == set(jeng.act_scales) == {"0.x", "0.attn", "0.ln1", "0.gelu"}
    for key, v in jeng.act_scales.items():
        assert abs(eng.act_scales[key] - v) <= 1e-5 * v, key
    for op, (jw, js) in jeng.qlayers[0].items():
        w8, s = eng.qlayers[0][op]
        np.testing.assert_array_equal(w8.t().numpy(), np.asarray(jw), err_msg=op)  # [out, in] vs [in, out]
        np.testing.assert_array_equal(s.numpy(), np.asarray(js), err_msg=op)
    on_jax_scales = Int8ViTEngine(CFG, model, dtype=torch.float32, device="cpu", act_scales=jeng.act_scales)
    for batch in (x, held):
        got = torch.sigmoid(on_jax_scales(batch)).permute(0, 2, 3, 1).numpy()
        want = np.asarray(jax.nn.sigmoid(jeng(_nhwc(batch))))
        assert np.abs(got - want).max() <= 1e-3
        assert ((got > 0.5) == (want > 0.5)).mean() >= 0.999
        assert 0.05 < (want > 0.5).mean() < 0.5  # the masks are not trivial


def test_per_op_and_per_layer_selection(setup):
    model, x, _, _ = setup
    q = Int8ViTEngine(CFG, model, dtype=torch.float32, device="cpu", int8_ops=("fc1", "fc2"), calib_batches=[x])
    assert q.int8_ops == {0: frozenset({"fc1", "fc2"})} and set(q.qlayers[0]) == {"fc1", "fc2"}
    fp = Int8ViTEngine(CFG, model, dtype=torch.float32, device="cpu", int8_ops={})
    assert (torch.sigmoid(q(x)) - torch.sigmoid(fp(x))).abs().max() < 5e-3
    q2 = Int8ViTEngine(CFG, model, dtype=torch.float32, device="cpu", int8_ops={0: ("qkv",)},
                       act_scales={"0.x": q.act_scales["0.x"]})
    assert q2.int8_ops == {0: frozenset({"qkv"})} and set(q2.qlayers[0]) == {"qkv"}
    with pytest.raises(ValueError, match="unknown layers/ops"):
        Int8ViTEngine(CFG, model, device="cpu", int8_ops={5: ("qkv",)}, act_scales="timing")
    with pytest.raises(ValueError, match="unknown layers/ops"):
        Int8ViTEngine(CFG, model, device="cpu", int8_ops=("conv",), act_scales="timing")


def test_act_scales_reusable_and_validated(setup):
    model, x, _, _ = setup
    q = Int8ViTEngine(CFG, model, dtype=torch.float32, device="cpu", calib_batches=[x])
    q2 = Int8ViTEngine(CFG, model, dtype=torch.float32, device="cpu", act_scales=q.act_scales)
    assert q2.act_scales == q.act_scales and torch.equal(q2(x), q(x))
    with pytest.raises(ValueError, match="missing"):
        Int8ViTEngine(CFG, model, device="cpu", act_scales={"0.x": 0.1})
    with pytest.raises(ValueError, match="act_scales or calib"):
        Int8ViTEngine(CFG, model, device="cpu")
    with pytest.raises(ValueError, match="serves VisionTransformer"):
        Int8ViTEngine({"model": {"name": "UNet"}}, model, device="cpu")
    timing = Int8ViTEngine(CFG, model, device="cpu", act_scales="timing")
    assert set(timing.act_scales.values()) == {0.05} and timing(x).dtype == torch.float32


@pytest.mark.slow
def test_int8_vit_dice_delta_gate_end_to_end(tmp_path):
    """The mirror of tests/test_quant_vit.py's gate: a 2-layer ViT-seg trained by the port's Trainer on 16
    synthetic images, |Dice(fp) - Dice(int8)| <= 1e-3 on those images (a model this small memorises them
    and does not generalise), int8 calibrated on the held-out ones."""
    from _torch_port import micro_dice, normalised, train_on_synthetic
    from dfc_sa_unet_torch.models.factory import create_model

    torch.manual_seed(0)  # torch's default initialisation of the model
    cfg = {**VIT_SMALL, "num_layers": 2, "num_heads": 4, "dropout": 0.1}
    model, config, train, val = train_on_synthetic(tmp_path, create_model({"model": cfg}, device="cpu"), cfg, 32,
                                                   epochs=40, lr=0.02)
    d_fp = micro_dice(Int8ViTEngine(config, model, dtype=torch.float32, device="cpu", int8_ops={}), train)
    d_q = micro_dice(Int8ViTEngine(config, model, dtype=torch.float32, device="cpu", calib_batches=[normalised(val)]),
                     train)
    assert d_fp > 0.5, f"the fp model did not learn to segment (Dice {d_fp})"
    assert abs(d_fp - d_q) <= 1e-3, (d_fp, d_q)
