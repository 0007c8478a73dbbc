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


# ---------------------------------------------------------------- --int8

VIT = {"name": "VisionTransformerSegmentation", "in_channels": 3, "out_channels": 1, "img_dim": 32, "patch_dim": 8,
       "embed_dim": 32, "num_layers": 1, "num_heads": 2, "mlp_dim": 64, "dropout": 0.0}


def _int8_setup(tmp_path, model_cfg=MODEL, n=4, size=32, module=None):
    """(config, weights, data) as _setup, the weights with BatchNorm statistics fitted to the images and
    the output bias set so that 20% of the pixels are foreground: masks that quantization can flip."""
    import numpy as np
    import yaml
    from PIL import Image

    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_

    data = generate(str(tmp_path / "data"), n=n, size=size, seed=3)
    cfg = {"model": model_cfg, "dataset": {"img_size": [size, size], "train_dir": data, "val_dir": data},
           "training": {"batch_size": 2}, "logging": {"log_dir": str(tmp_path / "logs")}}
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    model = module if module is not None else create_model(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    ims = np.stack([np.array(Image.open(os.path.join(data, "original", f))) for f in sorted(os.listdir(
        os.path.join(data, "original")))])
    x = normalize(torch.from_numpy(ims)).permute(0, 3, 1, 2)
    with torch.no_grad():
        calibrate_batch_stats_(model, x)
        last = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)][-1]
        last.bias -= torch.quantile(model(x).flatten(), 0.8)
    weights = tmp_path / "w.pth"
    torch.save(model.state_dict(), weights)
    return str(cfg_path), str(weights), data


def test_cli_int8_flagship_serves_and_self_checks(tmp_path):
    """``python -m dfc_sa_unet_torch.inference --int8 --device cpu``: the int8 engine calibrated on the
    first 8 images, the self-check on them and on images 8..9 (held out), the artifacts, the metrics."""
    cfg, weights, data = _int8_setup(tmp_path, n=10)
    out = tmp_path / "out"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-m", "dfc_sa_unet_torch.inference",
                          *_args(cfg, weights, data, out, "--int8")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Using the int8 quantized serving engine (levels: ['bottleneck', 'down4', 'up_conv3', 'up_conv4']; " \
           "calibrated on 8 images)." in res.stdout
    assert "int8 self-check: mask flip rate" in res.stdout and "held-out flip rate" in res.stdout
    assert "(int8 engine)" in res.stdout and "Micro-Averaged" in res.stdout
    for i in range(10):
        assert (out / f"sample_{i:03d}" / "pred_binary.png").exists(), i


def _record_int8(monkeypatch):
    built = []
    build = inference.build_int8_predictor

    def recording(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    monkeypatch.setattr(inference, "build_int8_predictor", recording)
    return built


@pytest.mark.parametrize("flags,want", [([], 99.9), (["--int8_percentile", "99"], 99.0), (["--int8_maxabs"], None)],
                         ids=["default_p99.9", "p99", "maxabs"])
def test_cli_int8_calibration_statistic(tmp_path, monkeypatch, capsys, flags, want):
    cfg, weights, data = _int8_setup(tmp_path)
    built = _record_int8(monkeypatch)
    inference.main(inference.parse_args(_args(cfg, weights, data, tmp_path / "out", "--int8", "--no_int8_check",
                                              *flags)))
    assert len(built) == 1 and built[0].model.calib_percentile == want
    assert "int8 self-check" not in capsys.readouterr().out


def test_cli_int8_strict_refuses_broken_scales(tmp_path, monkeypatch, capsys):
    """Scales 1000x too small saturate every quantize: the self-check warns, and under --strict the
    CLI refuses to serve."""
    from dfc_sa_unet_torch.infer.quant import Calibrated

    cfg, weights, data = _int8_setup(tmp_path)
    collect = Calibrated.collect_act_scales
    monkeypatch.setattr(Calibrated, "collect_act_scales",
                        lambda self, b: {k: v / 1000 for k, v in collect(self, b).items()})
    inference.main(inference.parse_args(_args(cfg, weights, data, tmp_path / "warned", "--int8")))
    assert "WARNING: int8 self-check: quantized vs fp masks disagree" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="self-check"):
        inference.main(inference.parse_args(_args(cfg, weights, data, tmp_path / "strict", "--int8", "--strict")))


def test_cli_int8_vit_seg(tmp_path, capsys):
    cfg, weights, data = _int8_setup(tmp_path, VIT)
    inference.main(inference.parse_args(_args(cfg, weights, data, tmp_path / "out", "--int8")))
    stdout = capsys.readouterr().out
    assert "Using the int8 transformer serving engine (all four linears x 1 blocks; calibrated on 4 images)." in stdout
    assert "int8 self-check: mask flip rate" in stdout and (tmp_path / "out" / "sample_003" / "pred_binary.png").exists()


def test_cli_int8_transunet(tmp_path, monkeypatch, capsys):
    """TransUNet's R50-ViT-B/16 widths are fixed by the config: the engine is given the small encoder."""
    from _torch_port import TRANSUNET_SMALL, TRANSUNET_SMALL_IMG
    from dfc_sa_unet_torch.infer import quant_transunet
    from dfc_sa_unet_torch.models.transunet import TransUNet

    monkeypatch.setattr(quant_transunet, "get_r50_b16_config", lambda: dict(TRANSUNET_SMALL))
    size = TRANSUNET_SMALL_IMG
    cfg, weights, data = _int8_setup(tmp_path, {"name": "TransUNet", "in_channels": 3, "out_channels": 1}, size=size,
                                     module=TransUNet(TRANSUNET_SMALL, img_size=size, num_classes=1))
    args = _args(cfg, weights, data, tmp_path / "out", "--int8")
    args[args.index("--tile_size") + 1] = str(size)
    inference.main(inference.parse_args(args))
    stdout = capsys.readouterr().out
    assert "Using the int8 TransUNet serving engine (all four encoder linears x 1 blocks; calibrated on 4 images)." \
        in stdout
    assert "int8 self-check: mask flip rate" in stdout and (tmp_path / "out" / "sample_003" / "pred_binary.png").exists()


def test_cli_int8_other_models_take_the_standard_path(tmp_path, monkeypatch, capsys):
    cfg, weights, data = _int8_setup(tmp_path, {"name": "UNet_AttentionOnly", "features": [8, 16, 24, 32],
                                                "pool_size": 4})
    built = _record_int8(monkeypatch)
    inference.main(inference.parse_args(_args(cfg, weights, data, tmp_path / "out", "--int8", "--engine")))
    stdout = capsys.readouterr().out
    assert "(--int8 supports DFC-SA-Res-Block, VisionTransformerSegmentation, and TransformerUNet; using standard " \
           "path)" in stdout
    assert not built and "engine)" not in stdout and (tmp_path / "out" / "sample_000" / "pred_binary.png").exists()


def test_cli_names_the_converter_for_an_orbax_directory(tmp_path):
    cfg, _, data = _setup(tmp_path)
    with pytest.raises(SystemExit, match="scripts/convert_checkpoint.py --config CFG --ckpt DIR --out W.pth --to_torch"):
        inference.main(inference.parse_args(_args(cfg, str(tmp_path), data, tmp_path / "out")))
