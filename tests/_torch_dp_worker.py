"""One process of the CPU process groups of tests/test_torch_parallel.py and
tests/test_torch_parallel_vs_jax.py (Gloo, torch only: this module never imports JAX).

Run as a script, it joins a group of ``--world`` processes at ``--coordinator`` and runs the
named cases through the port's Trainer with data parallelism, each process on its chunk of every
batch (``BatchLoader(shard=...)``), and saves what each case gives into ``--out`` as
``{case}.rank{rank}.npz``.  Imported, :func:`run_case` with ``mesh=None`` runs the same case in
one process, the reference the tests hold the group to.  :func:`spawn` starts the group, with a
hard time limit, from a test.
"""

import argparse
import os
import subprocess
import sys

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

INIT_TIMEOUT_S = 60    # the group's rendezvous and every collective
PROCESS_TIMEOUT_S = 120

# (model, loss, loss params, training samples, batch, image side[, training settings]); every case
# validates on 5 samples in one batch, so that under 2 processes the second holds a padding row
# the widths of tests/test_parallel_fast.py doubled: at C = 4 the query and key convs have C // 8 = 0
# channels, which torch's conv refuses
FLAGSHIP = {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 1}
VIT = {"name": "VisionTransformerSegmentation", "img_dim": 32, "patch_dim": 8, "embed_dim": 32, "num_layers": 1,
       "num_heads": 2, "mlp_dim": 64, "dropout": 0.3}
BCE_DICE = ("bce_dice", {"bce_weight": 0.5, "dice_weight": 0.5})
ROW_FLAGSHIP = {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 2}
ROW_ZOO = ["UNet", "UNet_Baseline", "UNet_BothStandardConv", "UNet_AttentionOnly", "UNet_AdditionFusion",
           "UNet_ConcatFusion", "UNet_EncoderOnlyDFC", "UNet_DecoderOnlyDFC"]
CASES = {
    "mini_bce_dice": ("mini", *BCE_DICE, 8, 8, 16),
    "mini_dice": ("mini", "dice", {}, 8, 8, 16),
    "mini_tversky": ("mini", "tversky", {"alpha": 0.3, "beta": 0.7}, 8, 8, 16),
    "mini_joint": ("mini", "joint", {"bce_weight": 0.4, "dice_weight": 0.4, "contour_weight": 0.2}, 8, 8, 16),
    "flagship": (FLAGSHIP, *BCE_DICE, 16, 8, 16),      # two steps: the second carries momentum
    "replicated": ("mini", *BCE_DICE, 5, 5, 16),       # 5 rows over 2 processes: run whole on each
    "vit_dropout": (VIT, *BCE_DICE, 8, 8, 32),
    # grad_accum 2: microbatches of 4, 2 rows of each a process (BatchLoader(microbatches=2))
    "mini_dice_accum2": ("mini", "dice", {}, 16, 8, 16, {"grad_accum": 2}),
    "mini_dice_exact2": ("mini", "dice", {}, 16, 8, 16, {"grad_accum": 2, "grad_accum_exact": True}),
    "flagship_exact2": (FLAGSHIP, *BCE_DICE, 16, 8, 16, {"grad_accum": 2, "grad_accum_exact": True}),
    # tests/test_grad_accum.py:220's exact step: batch 16, microbatches of 8 (JAX: over its 8 devices)
    "mini_dice_exact16": ("mini", "dice", {}, 16, 16, 16, {"grad_accum": 2, "grad_accum_exact": True}),
    # microbatches of 3 do not divide among 2 processes: every batch whole on each, with a warning
    "accum_replicated": ("mini", *BCE_DICE, 12, 6, 16, {"grad_accum": 2}),
    # row sharding (tests/test_torch_rows_*.py, 2 bands of 16 rows): the mini-net under each loss, grad_accum
    # 2 default and exact, a height that breaks the band rule (24 rows: the data axis only), the flagship two
    # steps and exact; the DFC family's nine models one step each (ROW_ZOO)
    "rows_mini_bce_dice": ("mini", *BCE_DICE, 8, 8, 32),
    "rows_mini_dice": ("mini", "dice", {}, 8, 8, 32),
    "rows_mini_tversky": ("mini", "tversky", {"alpha": 0.3, "beta": 0.7}, 8, 8, 32),
    "rows_mini_joint": ("mini", "joint", {"bce_weight": 0.4, "dice_weight": 0.4, "contour_weight": 0.2}, 8, 8, 32),
    "rows_mini_accum2": ("mini", *BCE_DICE, 8, 8, 32, {"grad_accum": 2}),
    "rows_mini_exact2": ("mini", *BCE_DICE, 8, 8, 32, {"grad_accum": 2, "grad_accum_exact": True}),
    "rows_mini_joint_exact2": ("mini", "joint", {"bce_weight": 0.4, "dice_weight": 0.4, "contour_weight": 0.2},
                               8, 8, 32, {"grad_accum": 2, "grad_accum_exact": True}),
    "rows_fallback": ("mini", *BCE_DICE, 8, 8, 24),
    "rows_flagship": (ROW_FLAGSHIP, *BCE_DICE, 16, 8, 32),
    "rows_flagship_exact2": (ROW_FLAGSHIP, *BCE_DICE, 16, 8, 32, {"grad_accum": 2, "grad_accum_exact": True}),
    "rows_flagship_remat": ({**ROW_FLAGSHIP, "remat": "all"}, *BCE_DICE, 8, 8, 32),
    "rows_grid_flagship": (ROW_FLAGSHIP, *BCE_DICE, 8, 8, 32),  # data 2 x spatial 2: tests/test_torch_rows_grid.py
    **{f"rows_zoo_{name}": ({"name": "UNet", "bilinear": False} if name == "UNet" else {**ROW_FLAGSHIP, "name": name},
                            *BCE_DICE, 4, 4, 32) for name in ROW_ZOO},
}
ACCUM_WARNING = "does not divide the data axis"
SPATIAL_WARNING = "sharding the batch dimension only"
VAL_SAMPLES = 5


def mini_net():
    """conv + BatchNorm + ReLU + conv over the port's own layers (tests/test_parallel_fast.py's MiniNet)."""
    import torch
    from torch import nn

    from dfc_sa_unet_torch.nn.layers import BatchNorm, Conv

    class MiniNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.c1 = Conv(3, 4, 3, padding=1)
            self.bn1 = BatchNorm(4)
            self.c2 = Conv(4, 1, 1)

        def forward(self, x):
            return self.c2(torch.relu(self.bn1(self.c1(x))))

    return MiniNet()


def val_samples(side):
    """The validation samples of every case: 5 in one batch."""
    from dfc_sa_unet_torch.data.synthetic import samples

    return list(samples(n=VAL_SAMPLES, size=side, seed=6))


def config(log_dir, model, loss, params, batch, side, training=None):
    return {"training": {"num_epochs": 1, "batch_size": batch, "learning_rate": 0.01, "momentum": 0.9,
                         "weight_decay": 1e-4, "num_workers": 1, "save_checkpoint_freq": 100,
                         "loss": {"type": loss, "params": dict(params)}, **(training or {})},
            "model": {"name": "MiniNet"} if model == "mini" else dict(model),
            "dataset": {"img_size": [side, side], "augmentation": False},
            "logging": {"log_dir": log_dir, "images_dir": log_dir + "/images",
                        "save_best_worst_samples": VAL_SAMPLES}}


def build_model(model, seed=0):
    import torch

    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.utils.weights import init_random_

    net = mini_net() if model == "mini" else create_model({"model": model}, device="cpu")
    return init_random_(net, torch.Generator().manual_seed(seed))


def run_case(name, mesh, log_dir, state_dict=None, items=None):
    """The case's training epoch and validation through the Trainer (with ``mesh``, or in one
    process when it is None).  ``state_dict`` and ``items`` (training samples) replace the seeded
    weights and the synthetic data.  Returns numpy arrays: the state dict after the epoch
    (``sd/<key>``), the epoch's and the validation's loss, IoU and Dice, the validation's
    per-sample Dice and IoU in name order, the last step's dropout seed and the count of the
    replicated-microbatch and band-rule warnings the epoch printed."""
    import contextlib
    import io

    from dfc_sa_unet_torch.data.dataset import ArrayDataset
    from dfc_sa_unet_torch.data.loader import BatchLoader
    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.train.trainer import Trainer

    model, loss, params, n_train, batch, side, *training = CASES[name]
    cfg = config(log_dir, model, loss, params, batch, side, *training)
    net = build_model(model)
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    items = list(samples(n=n_train, size=side, seed=5)) if items is None else items
    val_items = val_samples(side)
    # under row sharding the ranks of a spatial group load their data index's chunk
    shard = None if mesh is None or mesh.group is None else (mesh.data_index, mesh.data_size)
    train = BatchLoader(ArrayDataset(items), batch, shuffle=True, num_workers=1, seed=0, shard=shard,
                        partial="replicate", microbatches=cfg["training"].get("grad_accum", 1))
    val = BatchLoader(ArrayDataset(val_items), VAL_SAMPLES, shuffle=False, num_workers=1, seed=0, shard=shard,
                      partial="pad")
    trainer = Trainer(net, train, val, cfg, mesh=mesh, seed=3, device="cpu", progress=False)
    seeds = []
    step = trainer.train_step

    def logged(*a, **k):
        out = step(*a, **k)
        seeds.append(trainer.generator.initial_seed())
        return out

    trainer.train_step = logged
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tr_loss, tr_iou, tr_dice = trainer.train_epoch(0)
    print(printed.getvalue(), end="")
    v = trainer.validate_epoch()
    records = sorted(v["best_samples"], key=lambda r: r[2])
    out = {f"sd/{k}": t.detach().numpy().copy() for k, t in trainer.model.state_dict().items()}
    out.update(train=np.array([tr_loss, tr_iou, tr_dice]), val=np.array([v["loss"], v["iou"], v["dice"]]),
               val_dice=np.array([r[0] for r in records]), val_iou=np.array([r[1] for r in records]),
               val_names=np.array([r[2] for r in records]), seed=np.array(seeds[-1], np.uint64),
               accum_warnings=np.array(printed.getvalue().count(ACCUM_WARNING)),
               spatial_warnings=np.array(printed.getvalue().count(SPATIAL_WARNING)))
    return out


def run_preemption(mesh, log_dir):
    """``Trainer.train`` of the mini-net for 3 epochs of 2 steps, in which the last process sends
    itself SIGTERM after step 3 (a preemption that reaches one process only).  Returns the steps
    this process took, the epochs in its history and the checkpoints in its log directory."""
    import signal

    from dfc_sa_unet_torch.data.dataset import ArrayDataset
    from dfc_sa_unet_torch.data.loader import BatchLoader
    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.train.trainer import Trainer

    cfg = config(log_dir, "mini", *BCE_DICE, 4, 16)
    cfg["training"]["num_epochs"] = 3
    shard = (mesh.rank, mesh.world_size)
    items = ArrayDataset(samples(n=8, size=16, seed=5))
    trainer = Trainer(build_model("mini"), BatchLoader(items, 4, shuffle=True, num_workers=1, shard=shard,
                                                       partial="replicate"),
                      BatchLoader(items, 4, shuffle=False, num_workers=1, shard=shard), cfg, mesh=mesh,
                      device="cpu", progress=False)
    steps = []
    step = trainer.train_step

    def preempted_step(*a, **k):
        out = step(*a, **k)
        steps.append(trainer.step)
        if mesh.rank == mesh.world_size - 1 and trainer.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = preempted_step
    trainer.train()
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    return {"steps": np.array(steps), "epochs": np.array(len(trainer.history["train_losses"])),
            "checkpoints": np.array(sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else [])}


def spawn(cases, out_dir, world=2, inputs=None, spatial=1):
    """Run ``cases`` in a group of ``world`` processes of this module (``spatial`` > 1: a 2-D mesh of
    world / spatial data groups of ``spatial`` bands, ``parallel.mesh.serving_mesh``); returns
    {case: [result of rank 0, rank 1, ...]}.  Fails the calling test on a non-zero exit or when a
    process outlives PROCESS_TIMEOUT_S (it is killed)."""
    from dfc_sa_unet_torch.parallel.mesh import local_coordinator

    coordinator = local_coordinator()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, TESTS, os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(world):
        cmd = [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world", str(world),
               "--coordinator", coordinator, "--out", str(out_dir), "--cases", ",".join(cases), "--spatial", str(spatial)]
        if inputs:
            cmd += ["--inputs", str(inputs)]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{log[-4000:]}"
    return {c: [dict(np.load(os.path.join(out_dir, f"{c}.rank{r}.npz"))) for r in range(world)] for c in cases}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="rank 0's host:port")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    ap.add_argument("--inputs", default=None, help="a torch.save'd {case: (state dict, training items)}")
    ap.add_argument("--spatial", type=int, default=1, help="ranks of a spatial group (row sharding)")
    args = ap.parse_args()

    import faulthandler

    import torch

    faulthandler.enable()  # a native abort prints the Python stack of every thread

    from dfc_sa_unet_torch.parallel.mesh import serving_mesh

    torch.set_num_threads(1)
    inputs = torch.load(args.inputs, weights_only=False) if args.inputs else {}
    mesh = serving_mesh(args.spatial, device="cpu", coordinator=args.coordinator, num_processes=args.world,
                        process_id=args.rank, timeout_s=INIT_TIMEOUT_S)
    try:
        for case in args.cases.split(","):
            log_dir = os.path.join(args.out, f"logs_{case}_{args.rank}")
            if case == "preemption":
                np.savez(os.path.join(args.out, f"{case}.rank{args.rank}.npz"), **run_preemption(mesh, log_dir))
                continue
            res = run_case(case, mesh, log_dir, *inputs.get(case, (None, None)))
            if case == "vit_dropout":  # the same case again: the same bits
                again = run_case(case, mesh, log_dir + "_again")
                res.update({f"again/{k}": v for k, v in again.items() if k.startswith("sd/")})
            np.savez(os.path.join(args.out, f"{case}.rank{args.rank}.npz"), **res)
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
