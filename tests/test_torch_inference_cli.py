"""The port's inference CLI (``python -m dfc_sa_unet_torch.inference``) on the CPU.

Against what the JAX CLI does (inference.py and tests/test_inference.py:101-107):
the artifact set per image with the combined view beside it, the metrics CSV
and the micro-averaged metrics when the input holds ``original/`` and
``mask/``; the config's ``inference.bf16`` choosing the compute type unless
``--bf16`` / ``--no_bf16`` says otherwise; and a warning, with no evaluation,
for a ``mask/`` without ``original/``.  A tiny DFC-SA-Res-Block (features
8/16/24/32, pool 4) with seeded weights, four 32x32 images.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from dfc_sa_unet_torch import inference
from dfc_sa_unet_torch.data.synthetic import generate
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.utils.weights import init_random_

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"name": "DFC-SA-Res-Block", "in_channels": 3, "out_channels": 1, "features": [8, 16, 24, 32],
         "pool_size": 4}
ARTIFACTS = ["original.png", "pred_heatmap.png", "pred_binary.png", "pred_overlay.png", "ground_truth.png"]


def _setup(tmp_path, inference_section=None):
    """(config path, weights path, data dir) of the tiny model over four synthetic 32x32 images."""
    import yaml

    data = generate(str(tmp_path / "data"), n=4, size=32, seed=3)
    cfg = {"model": MODEL, "dataset": {"img_size": [32, 32], "train_dir": data, "val_dir": data},
           "training": {"batch_size": 2}, "logging": {"log_dir": str(tmp_path / "logs")}}
    if inference_section is not None:
        cfg["inference"] = inference_section
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    weights = tmp_path / "w.pth"
    torch.save(init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(0)).state_dict(), weights)
    return str(cfg_path), str(weights), data


def _args(cfg, weights, data, out, *flags):
    return ["--config", cfg, "--model", weights, "--input", data, "--output", str(out), "--tile_size", "32",
            "--overlap", "0", "--device", "cpu", *flags]


def test_cli_writes_the_artifacts_the_combined_view_and_the_metrics(tmp_path):
    cfg, weights, data = _setup(tmp_path)
    out = tmp_path / "out"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-m", "dfc_sa_unet_torch.inference", *_args(cfg, weights, data, out)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    for i in range(4):
        for f in ARTIFACTS:
            assert (out / f"sample_{i:03d}" / f).exists(), (i, f)
        assert (out / f"sample_{i:03d}_combined_view.png").exists(), i
    assert (out / "evaluation_metrics.csv").exists()
    assert "Micro-Averaged" in res.stdout
    assert "evaluation enabled" in res.stdout and "in float32" in res.stdout


@pytest.mark.parametrize("section,flags,want", [
    ({"bf16": True}, [], torch.bfloat16),
    ({"bf16": True}, ["--no_bf16"], torch.float32),
    ({"bf16": False}, ["--bf16"], torch.bfloat16),
    (None, [], torch.float32),
], ids=["yaml_bf16", "no_bf16_overrides_yaml", "bf16_flag_overrides_yaml", "default_f32"])
def test_yaml_inference_bf16_and_the_flags_choose_the_predictor_dtype(tmp_path, monkeypatch, capsys, section,
                                                                      flags, want):
    cfg, weights, data = _setup(tmp_path, section)
    built = []
    build = inference.build_predictor

    def recording(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    monkeypatch.setattr(inference, "build_predictor", recording)
    inference.main(inference.parse_args(_args(cfg, weights, data, tmp_path / "out", "--no_slide_window", *flags)))
    assert len(built) == 1 and built[0].compute_dtype == want
    assert f"in {str(want).split('.')[-1]}" in capsys.readouterr().out


def test_mask_without_original_warns_and_serves_without_evaluation(tmp_path, capsys):
    cfg, weights, data = _setup(tmp_path)
    flat = tmp_path / "flat"
    shutil.copytree(os.path.join(data, "mask"), flat / "mask")
    for name in sorted(os.listdir(os.path.join(data, "original")))[:2]:
        shutil.copy(os.path.join(data, "original", name), flat / name)
    out = tmp_path / "out"
    inference.main(inference.parse_args(_args(cfg, weights, str(flat), out)))
    stdout = capsys.readouterr().out
    assert "Warning: 'mask' found without 'original'; skipping evaluation." in stdout
    assert "Micro-Averaged" not in stdout and not (out / "evaluation_metrics.csv").exists()
    for name in ("sample_000", "sample_001"):
        assert (out / name / "pred_binary.png").exists()
        assert not (out / name / "ground_truth.png").exists() and not (out / f"{name}_combined_view.png").exists()
