"""Training, epochs of ``Trainer.train_epoch`` over the port's ``BatchLoader``.

Set-up writes ``images`` seeded image/mask PNGs of ``height`` x ``width`` (``traffic.ellipses``)
into a directory under ``TMPDIR``, builds the configuration's module in ``dtype`` with seeded
weights, the loader (``data/loader.py``: the configuration's augmentation, resize to its
``img_size``, ``num_workers`` threads, the in-RAM cache) and the Trainer, and runs
``warmup_epochs`` epochs through the same ``train_epoch`` call the window makes, which fills the
cache and warms every shape (the epoch's last batch is partial).  The window runs whole epochs
until ``run.seconds`` have passed; its rate is every image of every step over the time of all of
them.  The traced segment is one more epoch.

The check: the first three steps of set-up's first epoch, on the three batches the loader handed
the Trainer (all rows different), are replayed by the configuration's plain reference in float32
from the same seeded state: each step's loss, the first step's gradient as the optimiser has it
(the momentum buffer after one step: clipped, with the weight decay), the parameters' change
after three steps (leaves whose reference gradient is nought to rounding left out,
``compare.moving_leaves``), and BatchNorm's running statistics' change after three steps.
"""

import contextlib
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from portbench import compare
from portbench.core import dtype, host_copy
from portbench.reference.plain import bce_dice_loss, exact_f32, masks_to_target, normalize, sgd_step
from portbench.traffic import ellipses
from portbench.trace import UNIT_SPAN
from portbench.weights import seeded_state

CHECKED_STEPS = 3


def _write_dataset(root, t, seed, device):
    from PIL import Image

    images, masks = ellipses(t["images"], t["height"], t["width"], seed, device)
    images, masks = images.cpu().numpy(), masks.cpu().numpy()
    for sub in ("original", "mask"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def write(i):
        name = f"sample_{i:04d}.png"
        Image.fromarray(images[i]).save(os.path.join(root, "original", name), compress_level=1)
        Image.fromarray(masks[i]).save(os.path.join(root, "mask", name), compress_level=1)

    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(write, range(t["images"])))


class _TimedLoader:
    """The port's loader with the benchmark's span around each ``next()`` the Trainer makes."""

    def __init__(self, inner, waits):
        self.inner, self.waits = inner, waits

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        it = iter(self.inner)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.waits.append((t0, time.perf_counter()))
            if batch is None:
                return
            yield batch


def _config(run, root):
    """The port's config of the cell: the configuration's sections, the cell's batch, a dataset
    at ``root`` and logs beside it."""
    cfg, t = run.config, run.workload["traffic"]
    training = {**cfg["training"], "batch_size": t["batch"], "num_epochs": 1 << 30, "save_checkpoint_freq": 1 << 30}
    logs = os.path.join(root, "logs")
    return {"model": dict(cfg["model"]), "training": training,
            "dataset": {**cfg["dataset"], "train_dir": os.path.join(root, "data"),
                        "val_dir": os.path.join(root, "data"), "cache": True},
            "logging": {"log_dir": logs, "images_dir": os.path.join(logs, "images"), "save_best_worst_samples": 0}}


def _instrument(run, st, trainer):
    """Wrap ``trainer.train_step``: the step's span, and what the check needs from the first steps."""
    orig = trainer.train_step

    def step(images_u8, masks_u8, *args, **kwargs):
        k = st["calls"]
        if k < CHECKED_STEPS:
            st["batches"].append((host_copy(images_u8), host_copy(masks_u8)))
        n = int(images_u8.shape[0])
        span = torch.profiler.record_function(UNIT_SPAN) if st["tracing"] else contextlib.nullcontext()
        t0 = time.perf_counter()
        with span:
            out = orig(images_u8, masks_u8, *args, **kwargs)
        st["steps"].append((t0, time.perf_counter(), n, out["finite"]))
        if k < CHECKED_STEPS:
            st["losses"].append(out["loss"])
        if k == 0:
            st["direction"] = {name: host_copy(b) for name, b in trainer.optimizer.momentum_buffers.items()}
        if k == CHECKED_STEPS - 1:
            st["after"] = {name: host_copy(v) for name, v in trainer.model.state_dict().items()}
        st["calls"] += 1
        return out

    trainer.train_step = step


def _model(run, sd, config):
    """The module the cell trains, holding the seeded state dict ``sd``."""
    from dfc_sa_unet_torch.models.factory import create_model

    compute = dtype(run.workload["program"]["dtype"])
    with torch.device(run.device):
        model = create_model(config, dtype=None if compute == torch.float32 else compute, device=run.device)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"state dict does not fit the module: missing {missing}, unexpected {unexpected}")
    return model


def setup(run):
    from dfc_sa_unet_torch.data.loader import DataLoaderFactory
    from dfc_sa_unet_torch.train.trainer import Trainer

    t = run.workload["traffic"]
    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    with run.part("traffic"):
        _write_dataset(os.path.join(tmp.name, "data"), t, run.seed, run.device)
    config = _config(run, tmp.name)
    with run.part("weights"):
        sd = seeded_state(run.reference.state_spec(run.config), run.seed, run.device)
    with run.part("program"):
        model = _model(run, sd, config)
    sd_host = {k: host_copy(v) for k, v in sd.items()}
    del sd
    waits = []
    loader = _TimedLoader(DataLoaderFactory(config, seed=run.seed).get_train_loader(), waits)
    trainer = Trainer(model, loader, loader, config, seed=run.seed,
                      compute_dtype=dtype(run.workload["program"]["dtype"]), device=run.device, progress=False)
    st = {"tmp": tmp, "trainer": trainer, "waits": waits, "steps": [], "calls": 0, "tracing": False,
          "batches": [], "losses": [], "sd": sd_host, "epoch": 0,
          "param_names": [n for n, _ in trainer.optimizer.named_params]}
    _instrument(run, st, trainer)
    with run.part("warmup"):
        for _ in range(t["warmup_epochs"]):
            trainer.train_epoch(st["epoch"])
            st["epoch"] += 1
    return st


def window(run, st):
    trainer = st["trainer"]
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < run.seconds:
        trainer.train_epoch(st["epoch"])
        st["epoch"] += 1
        t_end = time.perf_counter()
    wall = t_end - t_start
    steps = [s for s in st["steps"] if s[0] >= t_start]
    waits = [e - s for s, e in st["waits"] if s >= t_start]
    images = sum(s[2] for s in steps)
    run.attempted, run.failed = len(steps), sum(1 for s in steps if not s[3])
    run.window = {"seconds": wall, "units": len(steps), "images": images, "wait_s": sum(waits)}
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    return {"train_img_per_s": images / wall, "train_peak_gib": peak / 2**30}


def traced(run, st):
    st["tracing"] = True
    st["trainer"].train_epoch(st["epoch"])
    st["epoch"] += 1
    st["tracing"] = False


def release(run, st):
    keys = ("sd", "batches", "losses", "direction", "after", "param_names")
    kept = {k: st[k] for k in keys}
    st["tmp"].cleanup()
    st.clear()
    return kept


def reference_steps(run, kept) -> dict:
    """The reference's first ``CHECKED_STEPS`` steps from the seeded state on the kept batches."""
    tr, dev = run.config["training"], run.device
    lp = tr["loss"]["params"]
    sd0 = {k: v.to(dev) for k, v in kept["sd"].items()}
    names = kept["param_names"]
    params = {n: sd0[n].clone().requires_grad_(True) for n in names}
    buffers = {k: v.clone() for k, v in sd0.items() if k not in params}
    momentum, losses = {}, []
    for step, (images, masks) in enumerate(kept["batches"]):
        model = run.reference.Model(run.config, {**params, **buffers}, train=True, checkpoint=True)
        probs = torch.sigmoid(model(normalize(images.to(dev))))
        loss = bce_dice_loss(probs, masks_to_target(masks.to(dev)), lp["bce_weight"], lp["dice_weight"])
        grads = dict(zip(names, torch.autograd.grad(loss, list(params.values()))))
        del probs
        if step == 0:
            first_grads = {n: g.detach().clone() for n, g in grads.items()}
        direction = sgd_step(params, grads, momentum, tr["learning_rate"], tr["momentum"], tr["weight_decay"])
        if step == 0:
            first_direction = direction
        del grads
        buffers.update(model.norms.moved())
        losses.append(float(loss.detach()))
    after = {**{n: p.detach() for n, p in params.items()}, **buffers}
    return {"losses": losses, "direction": first_direction, "grads": first_grads, "after": after, "sd0": sd0}


def _readings(run, got: dict, ref: dict, names: list) -> list:
    """The compared numbers: each step's loss gap (the largest, relative), and for the first step's
    gradient, the parameters' change and the running statistics' change the worst leaf's gap and
    the median leaf's (``compare.leaf_gaps``)."""
    sd0 = ref["sd0"]
    stats = [k for k in sd0 if k.endswith(("running_mean", "running_var"))]
    moving = compare.moving_leaves({n: ref["grads"][n] for n in names})
    change_got = {k: got["after"][k].to(sd0[k].device) - sd0[k] for k in moving + stats if k in got["after"]}
    change_ref = {k: ref["after"][k] - sd0[k] for k in moving + stats}
    direction = {k: v.to(sd0[k].device) for k, v in got["direction"].items()}
    out = [("loss_gap", max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])))]
    for label, gaps in (("grad", compare.leaf_gaps(direction, ref["direction"], names)),
                        ("change", compare.leaf_gaps(change_got, change_ref, moving)),
                        ("bn", compare.leaf_gaps(change_got, change_ref, stats))):
        worst, at = compare.worst_leaf(gaps)
        run.log(f"{label}: worst leaf {at} {worst!r}, median leaf {compare.median(gaps.values())!r}")
        out += [(f"{label}_gap", worst), (f"{label}_gap_median", compare.median(gaps.values()))]
    return out


def check(run, kept):
    with exact_f32():
        return _readings(run, kept, reference_steps(run, kept), kept["param_names"])
