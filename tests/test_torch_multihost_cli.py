"""The port's CLIs as 2 processes on the CPU (``python -m torch.distributed.run --standalone
--nproc_per_node 2 ... --data_parallel --device cpu``: Gloo, each run under a hard time limit).

* Serving, on the module path, ``--engine``, ``--int8`` and ``--int8 --tta``: every process
  serves ``files[rank::2]`` and the primary merges the rows; the merged CSV equals the
  single-process run's, row for row in its order, metrics within 1e-6.
* Training: one epoch of the tiny flagship over 8 synthetic 32x32 images in batches of 4 (two
  rows a process), then a second run resuming from the epoch-1 checkpoint for epoch 2.  Only the
  primary writes and reports (rank 1's output holds no epoch line), and the resumed run's
  history equals one process training both epochs, within rtol 1e-4.
"""

import csv
import glob
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from dfc_sa_unet_torch import inference
from dfc_sa_unet_torch.data.normalize import normalize
from dfc_sa_unet_torch.data.synthetic import generate, samples
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.train import cli as train_cli
from dfc_sa_unet_torch.utils import checkpoint as ckpt_util
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"name": "DFC-SA-Res-Block", "in_channels": 3, "out_channels": 1, "features": [8, 16, 24, 32],
         "pool_size": 4}
TIMEOUT_S = 120


def _two_processes(module, args, log_dir):
    """``module`` with ``args`` as 2 torchrun processes; each rank's output lands under ``log_dir``."""
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    # its own session, so that a hang is ended with torchrun's workers, not only torchrun
    run = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                            "--log-dir", str(log_dir), "--redirects", "3", "-m", module, *args, "--data_parallel",
                            "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, start_new_session=True)
    try:
        log = run.communicate(timeout=TIMEOUT_S)[0]
    finally:
        if run.poll() is None:
            os.killpg(run.pid, signal.SIGKILL)
            run.communicate()
    outs = {rank: "".join(open(p).read() for p in glob.glob(os.path.join(log_dir, "**", str(rank), "std*.log"),
                                                            recursive=True)) for rank in (0, 1)}
    assert run.returncode == 0, (log[-3000:], outs)
    return outs


def _config(tmp_path, **training):
    import yaml

    data = generate(str(tmp_path / "data"), n=8, size=32, seed=3)
    log = str(tmp_path / "logs")
    cfg = {"model": MODEL, "dataset": {"img_size": [32, 32], "train_dir": data, "val_dir": data,
                                       "augmentation": False},
           "training": {"num_epochs": 1, "batch_size": 4, "learning_rate": 0.05, "momentum": 0.9,
                        "weight_decay": 1e-4, "num_workers": 1, "save_checkpoint_freq": 1,
                        "loss": {"type": "bce_dice", "params": {"bce_weight": 0.5, "dice_weight": 0.5}},
                        **training},
           "logging": {"log_dir": log, "images_dir": log + "/images", "save_best_worst_samples": 0}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg, data


def _read_csv(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


def test_two_process_serving_writes_the_single_process_csv(tmp_path):
    _serve_with_one_and_two_processes(tmp_path, [])


@pytest.mark.parametrize("flags", [["--engine"], ["--int8"], ["--int8", "--tta"]], ids=["engine", "int8", "int8_tta"])
def test_two_process_serving_of_the_engines_writes_the_single_process_csv(tmp_path, flags):
    """The folded engine and the int8 engine (each process calibrates on the first 8 files of the
    global list, so both hold the same scales), with and without TTA."""
    _serve_with_one_and_two_processes(tmp_path, flags)


def _serve_with_one_and_two_processes(tmp_path, flags):
    cfg_path, cfg, data = _config(tmp_path)
    model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    calibrate_batch_stats_(model, normalize(torch.from_numpy(np.stack([i for _, i, _ in samples(4, 32, 9)])))
                           .permute(0, 3, 1, 2))
    weights = tmp_path / "w.pth"
    torch.save(model.state_dict(), weights)
    common = ["--config", cfg_path, "--model", str(weights), "--input", data, "--tile_size", "32", "--overlap", "0",
              *flags]
    inference.main(inference.parse_args([*common, "--output", str(tmp_path / "one"), "--device", "cpu"]))
    outs = _two_processes("dfc_sa_unet_torch.inference", [*common, "--output", str(tmp_path / "two")],
                          tmp_path / "torchrun")
    want, got = _read_csv(tmp_path / "one" / "evaluation_metrics.csv"), _read_csv(tmp_path / "two" /
                                                                                 "evaluation_metrics.csv")
    assert [r["file"] for r in got] == [r["file"] for r in want] == [f"sample_{i:03d}" for i in range(8)]
    for g, w in zip(got, want):
        for key in w:
            if key != "file":
                assert abs(float(g[key]) - float(w[key])) <= 1e-6, (g["file"], key, g[key], w[key])
    assert len({r["dice_f1"] for r in want}) > 1  # the masks are not all alike
    assert not glob.glob(str(tmp_path / "two" / "*.part*.json"))
    assert "Micro-Averaged" in outs[0] and "Micro-Averaged" not in outs[1]
    assert outs[0].count("sample_") >= 4 and "[4/4] sample_007" in outs[1]


def test_two_process_training_checkpoints_once_and_resumes(tmp_path):
    import yaml

    cfg_path, cfg, _ = _config(tmp_path)
    outs = _two_processes("dfc_sa_unet_torch.train", ["--config", cfg_path], tmp_path / "run1")
    ckpt_dir = tmp_path / "logs" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir)) in (["checkpoint_epoch_1"], ["best_checkpoint", "checkpoint_epoch_1"])
    assert "Epoch [1/1]" in outs[0] and "Epoch [" not in outs[1] and "rank 1 of 2, gloo" in outs[1]

    cfg["training"]["num_epochs"] = 2  # resumed, the run goes on to epoch 2
    with open(cfg_path, "w") as f:
        f.write(yaml.safe_dump(cfg))
    resume = str(ckpt_dir / "checkpoint_epoch_1")
    outs = _two_processes("dfc_sa_unet_torch.train", ["--config", cfg_path, "--resume", resume], tmp_path / "run2")
    assert "Resuming from epoch 1" in outs[0] and "Epoch [2/2]" in outs[0] and "Epoch [1/2]" not in outs[0]
    got = ckpt_util.restore_tree(str(ckpt_dir / "checkpoint_epoch_2"))["history"]

    single = dict(cfg, logging={**cfg["logging"], "log_dir": str(tmp_path / "single"),
                                "images_dir": str(tmp_path / "single" / "images")})
    with open(tmp_path / "single.yaml", "w") as f:
        f.write(yaml.safe_dump(single))
    train_cli.main(["--config", str(tmp_path / "single.yaml"), "--device", "cpu"])
    want = ckpt_util.restore_tree(str(tmp_path / "single" / "checkpoints" / "checkpoint_epoch_2"))["history"]
    for key in ("train_losses", "val_losses", "val_dice_scores"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert len(got["train_losses"]) == 2
