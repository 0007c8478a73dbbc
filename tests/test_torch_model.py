"""The port's flagship model against the torch-reference golden and the JAX module.

* tests/goldens/dfc_sa_res_small.npz through the port, weights loaded via
  ``from_jax_variables``: atol 5e-4, rtol 1e-3, the gate of
  tests/test_goldens.py (the golden was captured from the reference).
* JAX module vs port at the flagship's full widths (64/128/256/512, pool
  8), use_pallas on both sides: 1e-4.  Both sides are f32; a 3x3 conv at
  K = 9*1024 summed in another order leaves ~1e-6 relative per layer.
* An odd 48x40 input at small widths (bilinear shape fix, torch windows).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import SMALL, images, jax_model_and_variables, port_model, to_nchw, to_nhwc
from dfc_sa_unet_tpu.utils.torch_convert import variables_to_torch_state_dict
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, from_jax_variables, load_state_dict_file

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "dfc_sa_res_small.npz")
FLAGSHIP = {"name": "DFC-SA-Res-Block", "features": [64, 128, 256, 512], "pool_size": 8}


def _golden_variables(flat):
    """Flat ``params::down1/conv_branch_0/kernel`` names -> nested numpy
    (tests/test_goldens.py:59-73)."""
    variables = {}
    for key, val in flat.items():
        if key.startswith("__"):
            continue
        coll, path = key.split("::", 1)
        node = variables.setdefault(coll, {})
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val, np.float32)
    return variables


@pytest.mark.parametrize("use_pallas", [False, True])
def test_golden_dfc_sa_res_small(use_pallas):
    g = np.load(GOLDEN)
    flat = {k: g[k] for k in g.files}
    model = create_model({"model": SMALL}, use_pallas=use_pallas, device="cpu")
    model.load_state_dict(from_jax_variables(_golden_variables(flat)), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(flat["__input__"]))
    np.testing.assert_allclose(got.numpy(), flat["__output__"], atol=5e-4, rtol=1e-3)


def test_from_jax_variables_matches_jax_export_and_loads_strict(tmp_path):
    g = np.load(GOLDEN)
    variables = _golden_variables({k: g[k] for k in g.files})
    sd = from_jax_variables(variables)
    want = variables_to_torch_state_dict(variables)
    assert list(sd) == list(want)
    for key in sd:
        np.testing.assert_array_equal(sd[key].numpy(), want[key])
    model = create_model({"model": SMALL}, device="cpu")
    model.load_state_dict(sd, strict=True)
    torch.save({"model_state_dict": sd, "epoch": 3}, tmp_path / "ckpt.pth")
    model.load_state_dict(load_state_dict_file(str(tmp_path / "ckpt.pth")), strict=True)


def test_full_width_matches_jax_module():
    model = port_model(FLAGSHIP, seed=1, use_pallas=True)
    jmodel, variables = jax_model_and_variables(FLAGSHIP, model, (64, 64), use_pallas=True)
    x = images(1, (1, 64, 64, 3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = to_nhwc(model(to_nchw(x)))
    assert np.abs(want).max() > 0.1  # the comparison is not of two near-zero maps
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_odd_size_matches_jax_module(use_pallas):
    model = port_model(SMALL, seed=2, use_pallas=use_pallas)
    jmodel, variables = jax_model_and_variables(SMALL, model, (48, 40), use_pallas=use_pallas)
    x = images(2, (2, 48, 40, 3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = to_nhwc(model(to_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_bf16_module_tracks_f32():
    """bf16 compute (parameters f32, cast at use): logits within bf16 noise of f32."""
    model = port_model(SMALL, seed=3)
    x = to_nchw(images(3, (1, 32, 32, 3)))
    bf16 = create_model({"model": SMALL}, dtype=torch.bfloat16, device="cpu").eval()
    bf16.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        want, got = model(x), bf16(x)
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=0.1, rtol=0.05)


def test_use_pallas_is_only_validated():
    """The attention core runs the kernel wrapper whatever use_pallas says."""
    for flag in (False, True):
        model = create_model({"model": {**SMALL, "use_pallas": flag}}, device="cpu")
        assert not hasattr(model.down1.attn_branch[3], "use_kernel")
    with pytest.raises(TypeError, match="use_pallas"):
        create_model({"model": {**SMALL, "use_pallas": "yes"}}, device="cpu")


def test_calibrated_batch_stats_spread_logits_and_match_jax():
    model = port_model(SMALL, seed=7)
    x = images(7, (4, 32, 32, 3))
    calibrate_batch_stats_(model, to_nchw(x))
    assert not model.training
    assert all(m.momentum == 0.1 for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d))
    with torch.no_grad():
        y = model.down1.conv_branch[0](to_nchw(x))
        got = to_nhwc(model(to_nchw(x)))
    bn = model.down1.conv_branch[1]
    np.testing.assert_allclose(bn.running_mean.numpy(), y.mean((0, 2, 3)).numpy(), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), y.var((0, 2, 3)).numpy(), rtol=1e-4)
    assert got.std() > 0.1  # O(1) spread, not a near-constant map
    jmodel, variables = jax_model_and_variables(SMALL, model)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
