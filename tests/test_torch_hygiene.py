"""Boundaries of the PyTorch port.

* No file of dfc_sa_unet_torch/ (nor chip_smoke.py) imports jax, flax or
  dfc_sa_unet_tpu - checked on the source, and by importing every module
  in a process where ``import jax`` fails.
* Without CUDA every entry point raises unless it is given device="cpu".
* Every C function that ops/_build.py binds is defined in its source with
  the argument count its ctypes signature gives, and no source exports a
  function that is not bound: a stale export shows here, not on the card.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from dfc_sa_unet_torch.ops._build import SIGNATURES

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "dfc_sa_unet_torch"
FORBIDDEN = ("jax", "flax", "orbax", "optax", "dfc_sa_unet_tpu")
CFG = {"model": {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 4}}
# the transformer families at toy sizes: one ViT layer; the R50-ViT-B/16 widths are fixed by the
# factory, so TransUNet is built on the meta device (no storage) where only construction matters
VIT_CFG = {"model": {"name": "VisionTransformerSegmentation", "img_dim": 32, "patch_dim": 8, "embed_dim": 32,
                     "num_layers": 1, "num_heads": 2, "mlp_dim": 64}}
TRANSUNET_CFG = {"model": {"name": "TransUNet"}, "dataset": {"img_size": [32, 32]}}


def _imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_imports_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", *sorted((ROOT / "scripts").glob("*torch*.py"))]
    assert len(files) > 40
    names = {f.name for f in files}
    assert {"mha.py", "vit_seg.py", "transunet.py", "layers.py", "chip_smoke.py", "trainer.py", "losses.py",
            "loader.py", "conv_bn_stats.py", "cli.py", "unet.py", "ablations.py", "mxu_probes.py",
            "bench_torch_mxu.py", "bench_torch_bn_stats.py", "profile_torch_serving.py",
            "profile_torch_training.py"} <= names
    bad = [(str(f.relative_to(ROOT)), r) for f in files for r in _imported_roots(f) if r in FORBIDDEN]
    assert not bad, bad


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'orbax', 'optax', 'dfc_sa_unet_tpu', 'PIL', 'yaml', 'matplotlib', 'tqdm',\n"
        "             'pandas', 'cv2'): sys.modules[name] = None\n"
        "import dfc_sa_unet_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(dfc_sa_unet_torch.__path__, 'dfc_sa_unet_torch.')]\n"
        "for m in mods:\n"
        "    if not m.endswith('.__main__'): importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 41  # the DFC zoo's models and the probes' wrapper among them


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.inference import build_predictor, parse_args
    from dfc_sa_unet_torch.models.factory import ModelFactory, create_model, get_model_and_variables

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model_and_variables(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelFactory.get_model(CFG)
    model = create_model(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DFCEngine(CFG, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model)
    args = parse_args(["--config", "c.yaml", "--input", "d"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_predictor(CFG, model.state_dict(), device=args.device)
    build_predictor(CFG, model.state_dict(), engine=True, device="cpu")
    for cfg in (VIT_CFG, TRANSUNET_CFG):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_model(cfg)
    vit = create_model(VIT_CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(vit)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_predictor(VIT_CFG, vit.state_dict(), device=args.device)
    build_predictor(VIT_CFG, vit.state_dict(), device="cpu")
    with torch.device("meta"):
        transunet = create_model(TRANSUNET_CFG, device="meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(transunet)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_predictor(TRANSUNET_CFG, {}, device=args.device)


def test_training_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.train import cli
    from dfc_sa_unet_torch.train.trainer import Trainer

    log = str(tmp_path / "logs")
    config = {**CFG, "training": {"num_epochs": 1, "batch_size": 2},
              "dataset": {"train_dir": str(tmp_path), "val_dir": str(tmp_path)},
              "logging": {"log_dir": log, "images_dir": log + "/images"}}
    model = create_model(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, None, None, config)
    assert Trainer(model, None, None, config, device="cpu").device.type == "cpu"
    args = cli.parse_args(["--config", "c.yaml"])
    assert args.device == "cuda" and args.bf16 is None and args.remat is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build_trainer(config, args)
    # the JAX CLI's parallel flags are taken; their mesh raises without CUDA unless given the CPU
    from dfc_sa_unet_torch.parallel.mesh import mesh_from_flags

    dp = cli.parse_args(["--config", "c.yaml", "--data_parallel"])
    assert dp.data_parallel is True and dp.multihost is None and dp.spatial_parallel is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_from_flags(dp)
    assert mesh_from_flags(cli.parse_args(["--config", "c.yaml", "--data_parallel", "--device", "cpu"])).group is None
    assert cli.parse_args(["--config", "c.yaml", "--remat"]).remat == "all"
    assert cli.parse_args(["--config", "c.yaml", "--no_bf16"]).bf16 is False


ZOO_NAMES = ["UNet", "UNet_Baseline", "UNet_AttentionOnly", "UNet_AdditionFusion", "UNet_ConcatFusion",
             "UNet_FullResAttention", "UNet_EncoderOnlyDFC", "UNet_DecoderOnlyDFC", "UNet_BothStandardConv"]


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_zoo_entry_points_raise_without_cuda(no_cuda, tmp_path, name):
    """The vanilla UNet and the ablations: factory, predictor, inference and training entry
    points raise without a card unless given the CPU; ``--engine`` folds the flagship only."""
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.inference import build_predictor
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.train import cli

    cfg = {"model": {"name": name, "features": [8, 16, 24, 32], "pool_size": 4}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(cfg)
    with torch.device("meta"):  # the UNet's widths are fixed: no storage where only construction matters
        model = create_model(cfg, device="meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_predictor(cfg, {}, device="cuda")
    with pytest.raises(ValueError, match="--engine folds the DFC-SA-Res-Block only"):
        build_predictor(cfg, {}, engine=True, device="cpu")
    log = str(tmp_path / "logs")
    config = {**cfg, "training": {"num_epochs": 1, "batch_size": 2},
              "dataset": {"train_dir": str(tmp_path), "val_dir": str(tmp_path)},
              "logging": {"log_dir": log, "images_dir": log + "/images"}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build_trainer(config, cli.parse_args(["--config", "c.yaml"]))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, capsys):
    """``utils.profiling.trace`` profiles the CPU where there is no card; a falsy directory traces nothing."""
    import json

    from dfc_sa_unet_torch.utils.profiling import trace

    with trace(None):
        torch.ones(4).sum()
    with trace(str(tmp_path / "prof")):
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1 and str(files[0]) in capsys.readouterr().out
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)


def test_probe_scripts_raise_without_cuda():
    """The probe and profile scripts measure on the card only."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    for script in ("bench_torch_mxu.py", "bench_torch_bn_stats.py", "bench_torch_pooled_attention.py",
                   "bench_torch_predictor_batch.py"):
        out = subprocess.run([sys.executable, str(ROOT / "scripts" / script)], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, script
        assert "CUDA" in out.stderr and "ms" not in out.stdout, (script, out.stderr[-500:])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py fails and prints no result line without a card, and
    also when it stands alone outside the repo."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def _c_exports(stem):
    """{name: argument count} of the ``extern "C" int`` functions defined in csrc/<stem>.cu."""
    src = (PKG / "csrc" / f"{stem}.cu").read_text(encoding="utf-8")
    return {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_every_bound_function_is_defined_with_its_argument_count(name):
    stem, argtypes = SIGNATURES[name]
    assert _c_exports(stem).get(name) == len(argtypes), (name, stem, _c_exports(stem))


def test_every_exported_function_is_bound():
    sources = sorted((PKG / "csrc").glob("*.cu"))
    assert {f.stem for f in sources} == {stem for stem, _ in SIGNATURES.values()}
    exported = {name for f in sources for name in _c_exports(f.stem)}
    assert exported == set(SIGNATURES)
