"""Boundaries of the PyTorch port.

* No file of dfc_sa_unet_torch/ (nor chip_smoke.py) imports jax, flax or
  dfc_sa_unet_tpu - checked on the source, and by importing every module
  in a process where ``import jax`` fails.
* Without CUDA every entry point raises unless it is given device="cpu".
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

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
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "scripts" / "bench_torch_bn_stats.py",
                                         ROOT / "scripts" / "profile_torch_serving.py",
                                         ROOT / "scripts" / "profile_torch_training.py"]
    assert len(files) > 35
    names = {f.name for f in files}
    assert {"mha.py", "vit_seg.py", "transunet.py", "layers.py", "chip_smoke.py", "trainer.py", "losses.py",
            "loader.py", "conv_bn_stats.py", "cli.py"} <= names
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
    assert int(out.stdout.split()[-1]) >= 38  # the training slice's modules among them


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.inference import build_predictor, parse_args
    from dfc_sa_unet_torch.models.factory import create_model

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(CFG)
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
    with pytest.raises(SystemExit):  # the JAX CLI's parallel flags are not taken
        cli.parse_args(["--config", "c.yaml", "--data_parallel"])
    assert cli.parse_args(["--config", "c.yaml", "--remat"]).remat == "all"
    assert cli.parse_args(["--config", "c.yaml", "--no_bf16"]).bf16 is False


def test_other_models_raise_not_implemented():
    from dfc_sa_unet_torch.models.factory import create_model

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_model({"model": {"name": "UNet"}}, device="cpu")


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
