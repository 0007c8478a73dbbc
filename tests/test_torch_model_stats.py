"""``python -m dfc_sa_unet_torch.model_stats`` against the JAX tool (model_stats.py and
tests/test_model_stats.py) on the flagship at features 8/16/24/32, pool 4, 32x32: the per-leaf
parameter table (the port's state-dict paths mapped to JAX's leaf paths by the rule
``utils/weights.from_jax_variables`` inverts), the totals, the analytic per-leaf FLOPs and the
forward summary's shapes (NCHW against NHWC) equal JAX's; the counted total covers the per-leaf
sum within the JAX test's 0.7-1.05 band and lies within that band of XLA's cost-model total;
and the CLI prints FLOPs and MACs under their right labels."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from dfc_sa_unet_tpu.models.factory import create_model as jax_create_model
from dfc_sa_unet_torch import model_stats as pms
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.utils.weights import _unfold_numeric

torch.set_num_threads(2)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("model_stats_cli_jax", os.path.join(_ROOT, "model_stats.py"))
jms = importlib.util.module_from_spec(_spec)
sys.modules["model_stats_cli_jax"] = jms
_spec.loader.exec_module(jms)

CFG = {"model": {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 4}}


def _port_name(jax_path: str, sep: str = ".") -> str:
    """A JAX module path ('down1.conv_branch_0' or 'down1/conv_branch_0') as the port's."""
    return ".".join(p for part in jax_path.split(sep) for p in _unfold_numeric(part))


@pytest.fixture(scope="module")
def both():
    jmodel = jax_create_model(CFG)
    xj = jnp.zeros((1, 32, 32, 3), jnp.float32)
    variables = jmodel.init(jax.random.key(0), xj, train=False)
    model = create_model(CFG, device="cpu").eval()
    return jmodel, variables, xj, model, torch.zeros((1, 3, 32, 32))


def test_leaf_parameter_table_equals_jax(both):
    jmodel, variables, _, model, _ = both
    want = {_port_name(name): n for name, n in jms.leaf_parameter_rows(variables["params"])}
    got = dict(pms.leaf_parameter_rows(model))
    assert len(got) > 100 and got == want
    assert pms.count_parameters(model)[1] == jms.count_parameters(variables["params"])[1] == sum(got.values())
    assert {n for n, _ in pms.count_parameters(model)[0]} == set(variables["params"])


def test_leaf_flops_equal_jax(both):
    jmodel, variables, xj, model, x = both
    want = {_port_name(name): fl for name, fl in jms.leaf_flops_rows(jmodel, variables, xj)}
    by_leaf = dict(pms.leaf_flops_rows(model, x))
    assert by_leaf == want
    # the JAX test's two exact checks (tests/test_model_stats.py:59-64)
    assert by_leaf["down1.conv_branch.0"] == 2 * 32 * 32 * (3 * 3 * 3 * 8)
    assert by_leaf["up1"] == 2 * 16 * 16 * (2 * 2 * 16 * 8)
    agg = pms.module_flops_rows(model, list(by_leaf.items()))
    assert set(agg) == set(variables["params"]) and sum(agg.values()) == sum(by_leaf.values())


def test_forward_summary_shapes_equal_jax(both):
    jmodel, variables, xj, model, x = both
    got = {name: (shape, n) for name, shape, n in pms.forward_summary(model, x)}
    rows = jms.forward_summary(jmodel, variables, xj)
    assert len(rows) > 100
    for name, shape, n in rows:
        port = "<root>" if name == "<root>" else _port_name(name, "/")
        want = (shape[0], shape[3], shape[1], shape[2]) if len(shape) == 4 else shape
        assert got[port] == (want, n), (name, got.get(port), want, n)
    assert got["final_conv"][0] == (1, 1, 32, 32)


def test_counted_total_covers_the_leaf_sum(both):
    jmodel, variables, xj, model, x = both
    total = pms.model_flops(model, x)
    leaf_sum = sum(fl for _, fl in pms.leaf_flops_rows(model, x))
    assert 0.7 * total <= leaf_sum <= 1.05 * total
    jax_total, _ = jms.model_flops(jmodel, variables, xj)
    assert 0.7 * jax_total <= total <= 1.05 * jax_total, (total, jax_total)


def test_cli_prints_flops_and_macs(tmp_path, capsys):
    import yaml

    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump({**CFG, "training": {}, "dataset": {"img_size": [32, 32]}, "logging": {}}))
    r = pms.main(["--config", str(cfg), "--device", "cpu", "--output", str(tmp_path / "out")])
    text = capsys.readouterr().out
    assert r["macs"] * 2 == r["flops"] > 0 and r["activation_mb"] is None
    assert f"FLOPs (per forward, counted by FlopCounterMode on the plain versions): {r['flops']:,}" in text
    assert f"MACs: {r['macs']:,}" in text and "Activation memory: not measured on the CPU" in text
    assert "down1.conv_branch.0" in text and "Architecture summary" in text
    for suffix in ("_stats.txt", "_stats.csv", "_stats_layers.csv"):
        assert (tmp_path / "out" / f"DFC-SA-Res-Block{suffix}").exists()
