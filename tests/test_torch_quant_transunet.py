"""The port's int8 TransUNet engine (infer/quant_transunet.py) against the port's module and JAX's.

At ``_torch_port.py``'s TRANSUNET_SMALL (64x64, ResNet units 1/1/1, hidden
64, one block, two heads), built as a module, with seeded weights and
BatchNorm statistics fitted to the batch: with ``int8_ops={}`` the engine is
the port's module (f32, 1e-5, as tests/test_quant_transunet.py holds JAX's;
a 1-channel input repeated to 3 likewise); in "auto" it quantizes to JAX's s8
weights (q, k and v packed), calibrates JAX's scales (1e-5 relative) and, on
JAX's scales, serves JAX's probabilities (1e-3) and masks (99.9% of pixels).
JAX's engine runs its plain attention (``use_pallas=False``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TRANSUNET_SMALL, TRANSUNET_SMALL_IMG, images, jax_transunet, port_transunet, to_nchw
from _torch_port import variables_from_port
from dfc_sa_unet_tpu.infer.quant_transunet import Int8TransUNetEngine as JaxInt8TransUNetEngine
from dfc_sa_unet_torch.infer.quant_transunet import TRANSUNET_OPS, Int8TransUNetEngine
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_

torch.set_num_threads(2)
HW = (TRANSUNET_SMALL_IMG, TRANSUNET_SMALL_IMG)
CFG = {"model": {"name": "TransUNet", "in_channels": 3, "out_channels": 1},
       "dataset": {"img_size": list(HW)}}


@pytest.fixture(scope="module")
def setup():
    """(port module, calibration batch, held-out batch, JAX variables), 20% foreground."""
    model = port_transunet(seed=3)
    x, held = to_nchw(images(6, (2, *HW, 3))), to_nchw(images(7, (2, *HW, 3)))
    with torch.no_grad():
        calibrate_batch_stats_(model, x)
        model.segmentation_head[0].bias -= torch.quantile(model(x).flatten(), 0.8)
    return model, x, held, variables_from_port(jax_transunet(), model, HW)


def _engine(model, **kw):
    return Int8TransUNetEngine(CFG, model, dtype=torch.float32, device="cpu", vit_config=TRANSUNET_SMALL, **kw)


def _nhwc(x):
    return jnp.asarray(x.permute(0, 2, 3, 1).numpy())


def test_fp_engine_is_the_module(setup):
    model, x, held, _ = setup
    fp = _engine(model, int8_ops={})
    one = to_nchw(images(8, (1, *HW, 1)))  # a single channel, repeated to 3
    with torch.no_grad():
        for batch in (x, held, one):
            np.testing.assert_allclose(fp(batch).numpy(), model(batch).numpy(), atol=1e-5, rtol=1e-5)


def test_int8_auto_quantizes_and_serves_as_jax(setup):
    model, x, held, variables = setup
    jeng = JaxInt8TransUNetEngine(CFG, variables, dtype=jnp.float32, calib_batches=[_nhwc(x)], use_pallas=False,
                                  vit_config=dict(TRANSUNET_SMALL))
    eng = _engine(model, calib_batches=[x])
    assert eng.int8_ops == {0: TRANSUNET_OPS} == jeng.int8_ops
    assert set(eng.act_scales) == set(jeng.act_scales) == {"0.ln_a", "0.attn", "0.ln_f", "0.gelu"}
    for key, v in jeng.act_scales.items():
        assert abs(eng.act_scales[key] - v) <= 1e-5 * v, key
    for op, (jw, js) in jeng.qlayers[0].items():
        w8, s = eng.qlayers[0][op]
        np.testing.assert_array_equal(w8.t().numpy(), np.asarray(jw), err_msg=op)  # [out, in] vs [in, out]
        np.testing.assert_array_equal(s.numpy(), np.asarray(js), err_msg=op)
    on_jax_scales = _engine(model, act_scales=jeng.act_scales)
    for batch in (x, held):
        got = torch.sigmoid(on_jax_scales(batch)).permute(0, 2, 3, 1).numpy()
        want = np.asarray(jax.nn.sigmoid(jeng(_nhwc(batch))))
        assert np.abs(got - want).max() <= 1e-3
        assert ((got > 0.5) == (want > 0.5)).mean() >= 0.999
        assert 0.05 < (want > 0.5).mean() < 0.5  # the masks are not trivial


def test_per_op_and_per_layer_selection(setup):
    model, x, _, _ = setup
    q = _engine(model, int8_ops=("qkv", "fc2"), calib_batches=[x])
    assert q.int8_ops == {0: frozenset({"qkv", "fc2"})} and set(q.qlayers[0]) == {"qkv", "fc2"}
    assert set(q.act_scales) == {"0.ln_a", "0.attn", "0.ln_f", "0.gelu"}  # calibration records every point
    fp = _engine(model, int8_ops={})
    assert (torch.sigmoid(q(x)) - torch.sigmoid(fp(x))).abs().max() < 5e-3
    q2 = _engine(model, int8_ops={0: ("out",)}, act_scales={"0.attn": q.act_scales["0.attn"]})
    assert q2.int8_ops == {0: frozenset({"out"})} and set(q2.qlayers[0]) == {"out"}
    with pytest.raises(ValueError, match="unknown layers/ops"):
        _engine(model, int8_ops={3: ("qkv",)}, act_scales="timing")
    with pytest.raises(ValueError, match="unknown layers/ops"):
        _engine(model, int8_ops=("gate",), act_scales="timing")


def test_act_scales_reusable_and_validated(setup):
    model, x, _, _ = setup
    q = _engine(model, calib_batches=[x])
    q2 = _engine(model, act_scales=q.act_scales)
    assert q2.act_scales == q.act_scales and torch.equal(q2(x), q(x))
    with pytest.raises(ValueError, match="missing"):
        _engine(model, act_scales={"0.ln_a": 0.1})
    with pytest.raises(ValueError, match="act_scales or calib"):
        _engine(model)
    with pytest.raises(ValueError, match="serves TransformerUNet"):
        Int8TransUNetEngine({"model": {"name": "UNet"}}, model, device="cpu")
    assert set(_engine(model, act_scales="timing").act_scales.values()) == {0.05}


@pytest.mark.slow
def test_int8_transunet_dice_delta_gate_end_to_end(tmp_path):
    """The mirror of tests/test_quant_transunet.py's gate: its small TransUNet (hidden 96, two blocks)
    trained by the port's Trainer on 16 synthetic images, |Dice(fp) - Dice(int8)| <= 1e-3 on those
    images, int8 calibrated on the held-out ones."""
    from _torch_port import micro_dice, normalised, train_on_synthetic
    from dfc_sa_unet_torch.models.transunet import TransUNet, get_r50_b16_config

    torch.manual_seed(0)  # torch's default initialisation of the model
    vcfg = get_r50_b16_config()
    vcfg.update(patches_grid=(4, 4), resnet_num_layers=(1, 1, 1), hidden_size=96, mlp_dim=64, num_heads=4,
                num_layers=2, n_classes=1)
    model, config, train, val = train_on_synthetic(tmp_path, TransUNet(vcfg, img_size=64, num_classes=1),
                                                   CFG["model"], 64, epochs=12, lr=0.02)
    kw = dict(dtype=torch.float32, device="cpu", vit_config=vcfg)
    d_fp = micro_dice(Int8TransUNetEngine(config, model, int8_ops={}, **kw), train)
    d_q = micro_dice(Int8TransUNetEngine(config, model, calib_batches=[normalised(val)], **kw), train)
    assert d_fp > 0.5, f"the fp model did not learn to segment (Dice {d_fp})"
    assert abs(d_fp - d_q) <= 1e-3, (d_fp, d_q)
