"""The port's CLIs with row (spatial) sharding: 2 processes on the CPU (``python -m
torch.distributed.run --standalone --nproc_per_node 2 ... --spatial_parallel 2 --device cpu``:
one data group of 2 bands, Gloo, each run under a hard time limit).

* Serving ``--no_slide_window --engine``: both ranks serve every file, each a band of its 32 rows,
  the probabilities gathered over the pair; the primary writes the artifacts and the CSV, which
  equals the single-process run's, row for row, metrics within 1e-6.
* Training: one epoch of the tiny flagship over 8 synthetic 32x32 images in batches of 4 (every
  rank on the whole batch's band of 16 rows); the checkpoint's history equals one process's within
  rtol 1e-4.
* ``--int8`` under a band serves: every rank calibrates on the same whole images, the flagship's
  int8 engine runs its s8 3x3 convs on the neighbours' s8 rows, and the CSV equals one process's.
"""

import glob
import os

import numpy as np
import pytest
import torch

from dfc_sa_unet_torch import inference
from dfc_sa_unet_torch.data.normalize import normalize
from dfc_sa_unet_torch.data.synthetic import samples
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.train import cli as train_cli
from dfc_sa_unet_torch.utils import checkpoint as ckpt_util
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_
from test_torch_multihost_cli import _config, _read_csv, _two_processes

torch.set_num_threads(2)
ROWS = ["--spatial_parallel", "2"]


def _weights(tmp_path, cfg):
    model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    calibrate_batch_stats_(model, normalize(torch.from_numpy(np.stack([i for _, i, _ in samples(4, 32, 9)])))
                           .permute(0, 3, 1, 2))
    path = tmp_path / "w.pth"
    torch.save(model.state_dict(), path)
    return str(path)


def test_two_bands_serve_one_large_image_as_one_process(tmp_path):
    cfg_path, cfg, data = _config(tmp_path)
    common = ["--config", cfg_path, "--model", _weights(tmp_path, cfg), "--input", data, "--no_slide_window",
              "--engine"]
    inference.main(inference.parse_args([*common, "--output", str(tmp_path / "one"), "--device", "cpu"]))
    outs = _two_processes("dfc_sa_unet_torch.inference", [*common, "--output", str(tmp_path / "two"), *ROWS],
                          tmp_path / "torchrun")
    want, got = (_read_csv(tmp_path / run / "evaluation_metrics.csv") for run in ("one", "two"))
    assert [r["file"] for r in got] == [r["file"] for r in want] == [f"sample_{i:03d}" for i in range(8)]
    for g, w in zip(got, want):
        for key in w:
            if key != "file":
                assert abs(float(g[key]) - float(w[key])) <= 1e-6, (g["file"], key, g[key], w[key])
    assert len({r["dice_f1"] for r in want}) > 1  # the masks are not all alike
    assert not glob.glob(str(tmp_path / "two" / "*.part*.json"))
    assert "data=1 x spatial=2" in outs[0] and "Micro-Averaged" in outs[0]
    assert "Micro-Averaged" not in outs[1] and "sample_" not in outs[1]  # the primary alone writes and reports
    assert sorted(os.listdir(tmp_path / "two")) == sorted(os.listdir(tmp_path / "one"))


def test_two_bands_train_one_epoch_as_one_process(tmp_path):
    cfg_path, cfg, _ = _config(tmp_path)
    outs = _two_processes("dfc_sa_unet_torch.train", ["--config", cfg_path, *ROWS], tmp_path / "run")
    assert "data=1 x spatial=2" in outs[0] and "Epoch [1/1]" in outs[0] and "Epoch [" not in outs[1]
    assert "sharding the batch dimension only" not in outs[0]
    got = ckpt_util.restore_tree(str(tmp_path / "logs" / "checkpoints" / "checkpoint_epoch_1"))
    import yaml

    single = dict(cfg, logging={**cfg["logging"], "log_dir": str(tmp_path / "single"),
                                "images_dir": str(tmp_path / "single" / "images")})
    with open(tmp_path / "single.yaml", "w") as f:
        f.write(yaml.safe_dump(single))
    train_cli.main(["--config", str(tmp_path / "single.yaml"), "--device", "cpu"])
    want = ckpt_util.restore_tree(str(tmp_path / "single" / "checkpoints" / "checkpoint_epoch_1"))
    for key in ("train_losses", "val_losses", "val_dice_scores"):
        np.testing.assert_allclose(got["history"][key], want["history"][key], rtol=1e-4, atol=1e-6, err_msg=key)
    for key, v in want["model"].items():
        np.testing.assert_allclose(np.asarray(got["model"][key]), np.asarray(v), atol=1e-5, rtol=1e-4, err_msg=key)


def test_int8_under_a_band_raises(tmp_path):
    """It raised until the int8 engines were banded; now two bands serve ``--int8`` as one process
    does (every rank calibrates on the first whole images of the global file list)."""
    cfg_path, cfg, data = _config(tmp_path)
    common = ["--config", cfg_path, "--model", _weights(tmp_path, cfg), "--input", data, "--no_slide_window",
              "--int8", "--no_bf16"]
    inference.main(inference.parse_args([*common, "--output", str(tmp_path / "one"), "--device", "cpu"]))
    outs = _two_processes("dfc_sa_unet_torch.inference", [*common, "--output", str(tmp_path / "two"), *ROWS],
                          tmp_path / "torchrun")
    want, got = (_read_csv(tmp_path / run / "evaluation_metrics.csv") for run in ("one", "two"))
    assert [r["file"] for r in got] == [r["file"] for r in want] == [f"sample_{i:03d}" for i in range(8)]
    for g, w in zip(got, want):
        for key in w:
            if key != "file":
                assert abs(float(g[key]) - float(w[key])) <= 1e-6, (g["file"], key, g[key], w[key])
    assert "data=1 x spatial=2" in outs[0] and "int8 quantized serving engine" in outs[0]
