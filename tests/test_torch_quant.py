"""The port's int8 serving engine (infer/quant.py) against the JAX package's on the CPU.

The same seeded weights go to both (the port's state dict through the JAX
package's converter).  ``quantize_weight`` and ``quantize_act`` are bit-equal
to JAX's; ``range_tap``'s percentile is numpy's "linear" one also past 2^24
elements, where ``torch.quantile`` refuses; ``Int8DFCEngine`` quantizes to
JAX's s8 weights, calibrates JAX's scales (1e-5 relative: the fp forwards sum
in another order) and, on JAX's scales, serves JAX's probabilities (1e-3) and
masks (99.9% of pixels); without int8 levels it is the fp engine bit for bit.
Then the mechanics of tests/test_quant.py: scale reuse and validation,
"timing" scales, level selection and the self-check (clean, broken,
multi-channel, held-out, without calibration).

The self-check's model is the seeded one with BatchNorm statistics fitted to
the batch (``calibrate_batch_stats_``) and its output bias set so that 5% of
the pixels are foreground: a seeded model's logits otherwise sit at one side
of 0 and no mask can flip (JAX's tests train a model instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SMALL, images, jax_model_and_variables, port_model, to_nchw
from dfc_sa_unet_tpu.infer import quant as jquant
from dfc_sa_unet_torch.infer import quant
from dfc_sa_unet_torch.infer.engine import BLOCKS, DFCEngine
from dfc_sa_unet_torch.infer.quant import Int8DFCEngine, int8_self_check, quantize_act, quantize_weight, range_tap
from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_

torch.set_num_threads(2)
CFG = {"model": SMALL}
HW = (64, 64)


@pytest.fixture(scope="module")
def segmenter():
    """(port model, calibration batch, held-out batch): seeded weights, fitted BatchNorm statistics,
    5% foreground."""
    model = port_model(SMALL, seed=4)
    x, held = to_nchw(images(4, (2, *HW, 3))), to_nchw(images(5, (2, *HW, 3)))
    with torch.no_grad():
        calibrate_batch_stats_(model, x)
        model.final_conv.bias -= torch.quantile(model(x).flatten(), 0.95)
    return model, x, held


@pytest.fixture(scope="module")
def jax_engine(segmenter):
    """JAX's Int8DFCEngine on the same weights, calibrated (max |t|) on the same batch."""
    model, x, _ = segmenter
    _, variables = jax_model_and_variables(SMALL, model, HW)
    return variables, jquant.Int8DFCEngine(CFG, variables, dtype=jnp.float32,
                                           calib_batches=[jnp.asarray(x.permute(0, 2, 3, 1).numpy())])


@pytest.fixture(scope="module")
def port_engine(segmenter):
    model, x, held = segmenter
    return Int8DFCEngine(CFG, model, dtype=torch.float32, device="cpu", calib_batches=[x], holdout_batch=held)


def test_tables_are_the_jax_packages():
    assert quant._ALL_OPS == jquant._ALL_OPS
    assert quant.AUTO_INT8_OPS == jquant.AUTO_INT8_OPS
    assert quant.PROBE_INT8_OPS == jquant.PROBE_INT8_OPS
    assert quant.AUTO_INT8_LEVELS == jquant.AUTO_INT8_LEVELS


@pytest.mark.parametrize("shape", [(16, 8, 3, 3), (24, 40, 1, 1), (96, 32)], ids=["3x3", "1x1", "linear"])
def test_quantize_weight_is_bit_equal_to_jax(shape):
    """The port's weights put out channels first (OIHW, [out, in]), JAX's last (HWIO, [in, out])."""
    k = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) * 0.2
    k[0] = 0.0  # an all-zero channel: the 1e-12 floor
    q, s = quantize_weight(torch.from_numpy(k))
    perm = (2, 3, 1, 0) if k.ndim == 4 else (1, 0)
    jq, js = jquant.quantize_weight(jnp.asarray(k.transpose(perm)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().transpose(perm), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_act_is_bit_equal_to_jax():
    """Half-way values round to even (jnp.round); |x| / scale past 127 clips symmetrically."""
    rng = np.random.default_rng(0)
    scale = 0.05
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 3,
                        (np.arange(-20, 21) + 0.5).astype(np.float32) * np.float32(scale),
                        np.float32([-300.0, 300.0, 0.0])])
    got = quantize_act(torch.from_numpy(x), scale)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.quantize_act(jnp.asarray(x), scale)))
    np.testing.assert_array_equal(quantize_act(torch.tensor([[-300.0, -1.0, 0.0, 0.26, 300.0]]), 0.5).numpy(),
                                  [[-127, -2, 0, 1, 127]])


def test_range_tap_percentile_matches_numpy_past_2_24_elements():
    """numpy's "linear" percentile with its index in float64: on f32 data numpy and jnp take the
    index q (n - 1) in f32, which past 2^24 elements lands on another order statistic (they read
    3.2933629 and 3.2933085 here, the exact value is 3.2933540)."""
    t = torch.from_numpy(np.random.default_rng(1).standard_normal(2 ** 24 + 1).astype(np.float32))
    ranges = {}
    range_tap(ranges, "p", t, 99.9)
    range_tap(ranges, "m", t)
    range_tap(None, "none", t, 99.9)  # serving: a no-op
    want = np.percentile(np.abs(t.numpy()).astype(np.float64), 99.9)
    assert abs(float(ranges["p"]) - want) <= 1e-6 * want
    assert float(ranges["m"]) == float(t.abs().max())


@pytest.mark.parametrize("percentile", [None, 99.9], ids=["maxabs", "p99.9"])
def test_int8_engine_quantizes_and_calibrates_as_jax(segmenter, jax_engine, percentile):
    model, x, _ = segmenter
    variables, jeng = jax_engine
    if percentile is None:
        want = jeng.act_scales
    else:
        jp = jquant.Int8DFCEngine(CFG, variables, dtype=jnp.float32, act_scales=jeng.act_scales,
                                  calib_percentile=percentile)
        want = jp.collect_act_scales([jnp.asarray(x.permute(0, 2, 3, 1).numpy())])
    eng = Int8DFCEngine(CFG, model, dtype=torch.float32, device="cpu", calib_batches=[x],
                        calib_percentile=percentile)
    assert set(eng.act_scales) == set(want) and len(want) == 27
    for key, v in want.items():
        assert abs(eng.act_scales[key] - float(v)) <= 1e-5 * float(v), key
    assert set(eng.qblocks) == set(jeng.qblocks)
    for name, jq in jeng.qblocks.items():
        assert set(eng.qblocks[name]) == set(jq)
        for key, (jw, js) in jq.items():
            w8, s = eng.qblocks[name][key]
            # the port's layouts: [Cout, 9 * Cin] (tap-major) for the 3x3, [Cout, Cin] for the 1x1s
            w8 = (w8.reshape(w8.shape[0], 3, 3, -1).permute(1, 2, 3, 0) if key == "conv" else w8.t()[None, None])
            np.testing.assert_array_equal(w8.numpy(), np.asarray(jw), err_msg=f"{name}.{key}")
            # the folds agree to an ulp (XLA computes a / sqrt(v + eps) as a * rsqrt(v + eps))
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0, err_msg=f"{name}.{key}")


def test_int8_engine_serves_jax_probabilities_on_jax_scales(segmenter, jax_engine):
    model, x, held = segmenter
    _, jeng = jax_engine
    eng = Int8DFCEngine(CFG, model, dtype=torch.float32, device="cpu", act_scales=jeng.act_scales)
    for batch in (x, held):
        got = torch.sigmoid(eng(batch)).permute(0, 2, 3, 1).numpy()
        want = np.asarray(jax.nn.sigmoid(jeng._forward(jnp.asarray(batch.permute(0, 2, 3, 1).numpy()))))
        assert np.abs(got - want).max() <= 1e-3
        assert ((got > 0.5) == (want > 0.5)).mean() >= 0.999
        assert 0.01 < (want > 0.5).mean() < 0.2  # the masks are not trivial


def test_bf16_engine_quantizes_the_f32_folded_kernels(segmenter, port_engine):
    model, _, _ = segmenter
    bf16 = Int8DFCEngine(CFG, model, dtype=torch.bfloat16, device="cpu", act_scales=port_engine.act_scales)
    for name, q in port_engine.qblocks.items():
        for key, (w8, s) in q.items():
            assert torch.equal(bf16.qblocks[name][key][0], w8) and torch.equal(bf16.qblocks[name][key][1], s)


def test_levels_and_kernel_levels(segmenter, port_engine):
    model, x, _ = segmenter
    assert port_engine.int8_levels == {"down4", "bottleneck", "up_conv4", "up_conv3"}
    assert port_engine.tail_kernel_levels == port_engine.conv_kernel_levels == set()
    auto = Int8DFCEngine(CFG, model, device="cpu", act_scales="timing", tail_kernel_levels="auto",
                         conv_kernel_levels="auto")
    assert auto.tail_kernel_levels == {"down2", "down3", "up_conv2", "up_conv1"}
    assert auto.conv_kernel_levels == {"down1"}
    with pytest.raises(ValueError, match="int8 levels and kernel levels"):
        Int8DFCEngine(CFG, model, device="cpu", act_scales="timing", tail_kernel_levels={"down4"})
    with pytest.raises(ValueError, match="int8 levels and kernel levels"):
        Int8DFCEngine(CFG, model, device="cpu", act_scales="timing", conv_kernel_levels={"bottleneck"})
    with pytest.raises(ValueError, match="unknown levels"):
        Int8DFCEngine(CFG, model, device="cpu", int8_levels=["down9"], act_scales="timing")
    with pytest.raises(ValueError, match="unknown levels"):
        Int8DFCEngine(CFG, model, device="cpu", int8_levels={"down4": {"conv3"}}, act_scales="timing")
    # a {level: ops} slice needs only its ops' scales: the gate reads c2 alone
    gate = Int8DFCEngine(CFG, model, dtype=torch.float32, device="cpu", int8_levels={"down2": {"gate"}, "up_conv1": ()},
                         act_scales={"down2.c2": port_engine.act_scales["down2.c2"]})
    assert gate.int8_ops == {"down2": frozenset({"gate"})} and set(gate.qblocks["down2"]) == {"kg"}
    reset_launches()
    out = gate(x)
    assert out.shape == (2, 1, *HW) and torch.isfinite(out).all()
    assert set(launches().values()) == {0}  # CPU tensors run the plain versions


def test_act_scales_reusable_and_validated(segmenter, port_engine):
    model, x, _ = segmenter
    again = Int8DFCEngine(CFG, model, dtype=torch.float32, device="cpu", act_scales=port_engine.act_scales)
    assert again.act_scales == port_engine.act_scales and again.calib_batch is None
    for name, q in port_engine.qblocks.items():
        for key, (w8, s) in q.items():
            assert torch.equal(again.qblocks[name][key][0], w8) and torch.equal(again.qblocks[name][key][1], s)
    assert torch.equal(again(x), port_engine(x))
    with pytest.raises(ValueError, match="missing"):
        Int8DFCEngine(CFG, model, device="cpu", act_scales={"down4.x": 0.1})
    with pytest.raises(ValueError, match="act_scales or calib"):
        Int8DFCEngine(CFG, model, device="cpu")
    timing = Int8DFCEngine(CFG, model, device="cpu", act_scales="timing")
    assert set(timing.act_scales.values()) == {0.05} and len(timing.act_scales) == 12
    assert int8_self_check(timing) is None  # no calibration, no reference


def test_self_check_clean_and_held_out(port_engine):
    chk = int8_self_check(port_engine, strict=True)
    assert set(chk) == {"flip_rate", "mean_abs_dprob", "holdout_flip_rate", "holdout_mean_abs_dprob"}
    assert chk["flip_rate"] <= 5e-3 and chk["holdout_flip_rate"] <= 5e-3


def test_self_check_flags_broken_scales(segmenter, port_engine, capsys):
    """Scales 1000x too small saturate every quantize: the masks flip, a warning prints, and
    ``strict`` raises."""
    model, _, _ = segmenter
    broken = Int8DFCEngine(CFG, model, dtype=torch.float32, device="cpu",
                           act_scales={k: v / 1000 for k, v in port_engine.act_scales.items()})
    broken.calib_batch, broken.calib_fp_probs = port_engine.calib_batch, port_engine.calib_fp_probs
    chk = int8_self_check(broken)
    assert chk["flip_rate"] > 5e-3
    assert "int8 self-check: quantized vs fp masks disagree" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="self-check"):
        int8_self_check(broken, strict=True)


def test_self_check_gates_on_the_held_out_batch(segmenter, capsys):
    model, x, held = segmenter
    eng = Int8DFCEngine(CFG, model, dtype=torch.float32, device="cpu", calib_batches=[x], holdout_batch=held)
    with torch.no_grad():
        eng.calib_fp_probs = torch.sigmoid(eng(eng.calib_batch).float())  # a perfect calibration reference
    eng.holdout_fp_probs = 1.0 - eng.holdout_fp_probs
    chk = int8_self_check(eng)
    assert chk["holdout_flip_rate"] > 5e-3 >= chk["flip_rate"]
    assert "held-out" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="held-out"):
        int8_self_check(eng, strict=True)


def test_self_check_multichannel_uses_argmax():
    """A multi-channel head (channels on dim 1) is gated on argmax disagreement: a uniform logit
    shift flips every per-channel threshold and no argmax."""
    class FakeEngine:
        def __init__(self, logits_fp, logits_q):
            self.calib_batch = torch.zeros(1)
            self.calib_fp_probs = torch.sigmoid(torch.from_numpy(logits_fp))
            self._q = torch.from_numpy(logits_q)

        def __call__(self, x):
            return self._q

    rng = np.random.default_rng(3)
    fp = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    assert int8_self_check(FakeEngine(fp, fp - 10.0), strict=True)["flip_rate"] == 0.0
    assert int8_self_check(FakeEngine(fp, fp[:, ::-1].copy()))["flip_rate"] > 0.5
    fp1 = rng.normal(size=(2, 1, 4, 4)).astype(np.float32)
    assert int8_self_check(FakeEngine(fp1, fp1 - 10.0))["flip_rate"] > 0.5


def test_range_taps_leave_the_fp_forward_unchanged(segmenter):
    """The calibration forward records 27 ranges and computes the serving forward's logits bit for
    bit; the serving forward takes no taps."""
    model, x, _ = segmenter
    eng = DFCEngine(CFG, model, dtype=torch.float32, device="cpu")
    ranges = {}
    with torch.no_grad():
        served = eng(x)
        calibrating = eng._fwd(x, ranges)
        module = model(x)
    assert torch.equal(served, calibrating)
    assert sorted(ranges) == sorted(f"{n}.{t}" for n in BLOCKS for t in ("x", "c2", "c3"))
    assert all(float(v) > 0 for v in ranges.values())
    np.testing.assert_allclose(served.numpy(), module.numpy(), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_engine_without_int8_levels_is_the_fp_engine(segmenter, dtype):
    """No int8 level, so no scales and no s8 weight: every step of every block is DFCEngine's own, and
    the logits are its bits."""
    model, x, _ = segmenter
    kernels = {"tail_kernel_levels": "auto", "conv_kernel_levels": "auto"}
    with torch.inference_mode():
        fp = DFCEngine(CFG, model, dtype=dtype, device="cpu", **kernels)
        q = Int8DFCEngine(CFG, model, dtype=dtype, device="cpu", int8_levels=[], **kernels)
        assert q.act_scales == {} and q.qblocks == {} and q.tail_kernel_levels == fp.tail_kernel_levels
        assert torch.equal(q(x), fp(x))


@pytest.mark.slow
def test_int8_engine_all_levels_tracks_the_fp_engine(segmenter):
    """Every level in int8 (the small-Cin ones too) stays close to the fp engine (the mirror of
    tests/test_quant.py::test_int8_engine_all_levels_runs, whose model is at its initialisation: the
    seeded one, without the fitted statistics)."""
    x = segmenter[1]
    model = port_model(SMALL, seed=4)
    fp = torch.sigmoid(DFCEngine(CFG, model, dtype=torch.float32, device="cpu")(x))
    q = Int8DFCEngine(CFG, model, dtype=torch.float32, device="cpu", int8_levels=BLOCKS, calib_batches=[x])
    assert (torch.sigmoid(q(x)) - fp).abs().max() < 1e-2


def test_int8_engines_raise_without_cuda(monkeypatch, segmenter):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Int8DFCEngine(CFG, segmenter[0], act_scales="timing")


@pytest.mark.slow
def test_int8_dice_delta_gate_end_to_end(tmp_path):
    """The end-metric gate (the mirror of tests/test_quant.py::test_int8_dice_delta_gate_end_to_end):
    the small model trained by the port's Trainer into a segmenter on synthetic ellipses, then
    |Dice(fp) - Dice(int8)| <= 1e-3 on the held-out images (micro Dice), int8 calibrated on them."""
    from _torch_port import micro_dice, normalised, train_on_synthetic
    from dfc_sa_unet_torch.models.factory import create_model

    torch.manual_seed(0)  # torch's default initialisation of the model
    model, cfg, _, val = train_on_synthetic(tmp_path, create_model({"model": SMALL}, device="cpu"), SMALL, 64,
                                            epochs=30, lr=0.05)
    d_fp = micro_dice(DFCEngine(cfg, model, dtype=torch.float32, device="cpu"), val)
    d_q = micro_dice(Int8DFCEngine(cfg, model, dtype=torch.float32, device="cpu", calib_batches=[normalised(val)]),
                     val)
    assert d_fp > 0.5, f"the fp model did not learn to segment (Dice {d_fp})"
    assert abs(d_fp - d_q) <= 1e-3, (d_fp, d_q)
