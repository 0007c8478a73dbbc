#!/usr/bin/env python3
"""Where the time of one training step goes, for the PyTorch port on one GPU.

    python3 scripts/profile_torch_training.py [--model NAME] [--batch 32] [--f32] [--remat MODE]
                                              [--seed 0] [--top 25] [--report FILE]

Builds one model at full width with seeded weights (the flagship
``DFC-SA-Res-Block`` at 224x224 by default, or a transformer of
scripts/profile_torch_serving.py's list), a batch of synthetic ellipses made
in memory, and the port's Trainer (bce_dice 0.5/0.5, SGD lr 0.01, momentum
0.9, weight decay 1e-4, clip 1.0, as configs/config_dfc-sa-res-block.yaml).
After two warm-up steps it times three ``train_step`` calls with the host
clock around a synchronise, then traces two more with torch.profiler: device
time by kernel, the device's busy share of the traced wall time, and the
peak of allocated device memory.  Prints a summary; ``--report`` also writes
the profiler's full table to FILE.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.data.dataset import ArrayDataset  # noqa: E402
from dfc_sa_unet_torch.data.loader import BatchLoader, to_device  # noqa: E402
from dfc_sa_unet_torch.data.synthetic import samples  # noqa: E402
from dfc_sa_unet_torch.models.factory import create_model  # noqa: E402
from dfc_sa_unet_torch.ops import launches, reset_launches  # noqa: E402
from dfc_sa_unet_torch.train.trainer import Trainer  # noqa: E402
from dfc_sa_unet_torch.utils.weights import init_random_  # noqa: E402
from scripts.profile_torch_serving import CONFIGS, _device_us, _is_kernel  # noqa: E402

TRAINING = {"num_epochs": 1, "learning_rate": 0.01, "momentum": 0.9, "weight_decay": 1e-4, "num_workers": 2,
            "loss": {"type": "bce_dice", "params": {"bce_weight": 0.5, "dice_weight": 0.5}}}


def build_trainer(model_cfg, batch, bf16, remat, seed, log_dir, device="cuda"):
    """A Trainer of ``model_cfg`` with seeded weights over ``batch`` synthetic 224x224 samples."""
    dtype = torch.bfloat16 if bf16 else None
    config = {**model_cfg, "training": {**TRAINING, "batch_size": batch},
              "logging": {"log_dir": log_dir, "images_dir": os.path.join(log_dir, "images")}}
    model = init_random_(create_model(config, dtype=dtype, device="cpu", remat=remat or False),
                         torch.Generator().manual_seed(seed))
    data = ArrayDataset(samples(n=batch, size=224, seed=seed))
    loader = BatchLoader(data, batch, shuffle=True, num_workers=2, seed=seed)
    return Trainer(model, loader, loader, config, seed=seed, compute_dtype=dtype, device=device, progress=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(CONFIGS), default="DFC-SA-Res-Block")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--f32", action="store_true", help="f32 compute instead of bf16")
    ap.add_argument("--remat", choices=["all", "l12", "deep"], default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--report", type=str, default=None, help="file for the full profiler table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as log_dir:
        trainer = build_trainer(CONFIGS[args.model], args.batch, not args.f32, args.remat, args.seed, log_dir)
        imgs, masks = to_device(next(iter(trainer.train_loader)), trainer.device)
        for _ in range(2):
            trainer.train_step(imgs, masks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(3):
            metrics = trainer.train_step(imgs, masks)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {k: v // 3 for k, v in launches().items() if v}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                trainer.train_step(imgs, masks)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    kernels = [e for e in averages if _is_kernel(e)]
    busy_us = sum(_device_us(e) for e in kernels)
    mode = ("f32" if args.f32 else "bf16") + (f", remat {args.remat}" if args.remat else "")
    print(f"card: {card}; torch {torch.__version__}; {args.model}, B={args.batch} {mode} 224x224")
    print(f"train_step {step_ms:.2f} ms = {args.batch / step_ms * 1e3:.1f} img/s (host clock around a synchronise, "
          f"{card}); peak allocated {peak:.2f} GiB; kernel launches per step {counts}; last loss "
          f"{metrics['loss']:.4f}, finite {metrics['finite']}")
    print(f"traced 2 steps: device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
          f"({100 * busy_us / wall_us:.1f}%)")
    for e in sorted(kernels, key=_device_us, reverse=True)[: args.top]:
        us = _device_us(e)
        if us <= 0:
            break
        print(f"  {us / 2e3:9.3f} ms/step {100 * us / busy_us:5.1f}%  x{e.count // 2:<5d} {e.key[:150]}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w", encoding="utf-8") as f:
            f.write(f"== {args.model} training step ({card}, B={args.batch} {mode})\n"
                    + averages.table(sort_by="self_device_time_total", row_limit=150) + "\n")


if __name__ == "__main__":
    main()
