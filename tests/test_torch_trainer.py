"""The training slice of the port as a whole, against the JAX trainer and
against itself, on the CPU (plain attention on the port's side, the Pallas
kernel in interpret mode on JAX's).

Tolerances of the parity checks are in ``_torch_port.assert_step_matches``:
loss, IoU and Dice 1e-5; parameter updates 1e-3 of the largest update of the
tensor plus 1e-7; BatchNorm running statistics 1e-5.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import (SMALL, assert_step_matches, jax_model_and_variables, port_model, run_both_trainers,
                         train_config, uint8_batches)
import _torch_rows_worker as rows_worker
from dfc_sa_unet_torch.data.loader import DataLoaderFactory
from dfc_sa_unet_torch.data.synthetic import generate
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.parallel.mesh import data_parallel_mesh, local_coordinator, serving_mesh
from dfc_sa_unet_torch.train import trainer as trainer_mod
from dfc_sa_unet_torch.train.trainer import Trainer
from dfc_sa_unet_torch.utils import checkpoint as ckpt_util
from dfc_sa_unet_torch.utils.weights import init_random_, load_jax_train_state_

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 32)


def _data_config(tmp_path, n=8, seed=0, **training):
    root = generate(str(tmp_path / "data"), n=n, size=32, seed=seed)
    cfg = train_config(tmp_path, **training)
    cfg["dataset"].update(train_dir=root, val_dir=root)
    return cfg


def _trainer(cfg, seed=0, model_seed=0, remat=False):
    model = init_random_(create_model(cfg, device="cpu", remat=remat), torch.Generator().manual_seed(model_seed))
    factory = DataLoaderFactory(cfg, seed=seed)
    return Trainer(model, factory.get_train_loader(), factory.get_val_loader(), cfg, seed=seed, device="cpu",
                   progress=False)


def _state(trainer):
    sd = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    return sd, {k: v.clone() for k, v in trainer.optimizer.momentum_buffers.items()}


# (a) and (c): the flagship against the JAX trainer

@pytest.mark.parametrize("grad_accum", [1, 2], ids=["plain", "grad_accum2"])
def test_flagship_steps_match_the_jax_trainer(tmp_path, grad_accum):
    """One and then three steps (the later ones carry momentum and moved BatchNorm statistics)."""
    cfg = train_config(tmp_path, grad_accum=grad_accum)
    model = port_model(SMALL, seed=1)
    jmodel, _ = jax_model_and_variables(SMALL, model, use_pallas=True)
    steps, init = run_both_trainers(cfg, model, jmodel, HW, uint8_batches(0, 3 if grad_accum == 1 else 1, 4, HW))
    for step in steps:
        assert_step_matches(*step, init)
    tracked = [v for k, v in steps[-1][2].items() if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == len(steps) * grad_accum for v in tracked)


def test_training_state_crosses_from_jax(tmp_path):
    """utils.weights.load_jax_train_state_: weights, BatchNorm statistics, momentum and step of a
    JAX TrainState after two steps land in a fresh port trainer, whose third step then matches JAX's."""
    import jax.numpy as jnp

    from dfc_sa_unet_tpu.train.trainer import Trainer as JaxTrainer
    from _torch_port import state_dict_of_jax_state

    cfg = train_config(tmp_path)
    model = port_model(SMALL, seed=2)
    jmodel, variables = jax_model_and_variables(SMALL, model, use_pallas=True)
    jt = JaxTrainer(jmodel, None, None, cfg, seed=0, init_variables=variables)
    state = jt.init_state(None)
    batches = uint8_batches(4, 3, 4, HW)
    for img, mask in batches[:2]:
        state, _ = jt._train_step_jit(state, jnp.asarray(img), jnp.asarray(mask))
    tree = jt._state_to_tree(state, 0)
    fresh = Trainer(create_model({"model": SMALL}, device="cpu"), None, None, cfg, device="cpu", progress=False)
    fresh.step = load_jax_train_state_(fresh.model, fresh.optimizer, tree["params"], tree["batch_stats"],
                                       tree["opt_leaves"], int(tree["step"]))
    assert fresh.step == 2 and len(fresh.optimizer.momentum_buffers) == len(list(fresh.model.parameters()))
    init = {k: v.detach().numpy().copy() for k, v in fresh.model.state_dict().items()}
    for name, want in state_dict_of_jax_state(state).items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(init[name], want)
    state, jm = jt._train_step_jit(state, jnp.asarray(batches[2][0]), jnp.asarray(batches[2][1]))
    tm = fresh.train_step(torch.from_numpy(batches[2][0]), torch.from_numpy(batches[2][1]))
    port_sd = {k: v.detach().numpy() for k, v in fresh.model.state_dict().items()}
    assert_step_matches(tm, {k: float(v) for k, v in jm.items()}, port_sd, state_dict_of_jax_state(state), init)


# (d): the NaN guard

def test_trainer_skips_update_on_nan_gradient(tmp_path, monkeypatch):
    """A finite loss with a NaN gradient leaves parameters, momentum and BatchNorm running
    statistics (num_batches_tracked too) untouched, still counts as a step, and train() goes on."""
    cfg = _data_config(tmp_path, n=4, num_epochs=2)
    trainer = _trainer(cfg)
    batch = next(iter(trainer.train_loader))
    trainer.train_step(batch["image"], batch["mask"])  # a good step first: momentum exists
    sd0, mom0 = _state(trainer)
    real = trainer_mod.compute_loss
    poisoned = {"on": True}

    def poisoned_loss(probs, t, loss_type, params, sample_mask=None):
        base = real(probs, t, loss_type, params, sample_mask=sample_mask)
        if not poisoned["on"]:
            return base
        # finite value (-100, the clamp), NaN gradient: the clip(log(0)) trap
        return base + 0.001 * torch.log(probs.sum() * 0.0).clamp(min=-100.0)

    monkeypatch.setattr(trainer_mod, "compute_loss", poisoned_loss)
    metrics = trainer.train_step(batch["image"], batch["mask"])
    assert np.isfinite(metrics["loss"]) and not metrics["finite"] and trainer.step == 2
    sd1, mom1 = _state(trainer)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0), "weights or BatchNorm statistics moved"
    assert any(k.endswith("num_batches_tracked") for k in sd0)
    assert mom0.keys() == mom1.keys() and all(torch.equal(mom0[k], mom1[k]) for k in mom0)
    assert all(p.grad is None for p in trainer.model.parameters())
    # an epoch of skipped steps reports zeros and the run continues; then the poison goes away
    assert trainer.train_epoch(0) == (0.0, 0.0, 0.0)
    sd2, _ = _state(trainer)
    assert all(torch.equal(sd0[k], sd2[k]) for k in sd0)
    poisoned["on"] = False
    trainer.train()
    assert len(trainer.history["train_losses"]) == 2 and np.isfinite(trainer.history["train_losses"]).all()
    assert all(torch.isfinite(v).all() for v in trainer.model.state_dict().values())


def test_non_finite_loss_is_skipped_too(tmp_path, monkeypatch):
    cfg = train_config(tmp_path)
    trainer = Trainer(port_model(SMALL), None, None, cfg, device="cpu", progress=False)
    img, mask = uint8_batches(0, 1, 4, HW)[0]
    sd0, _ = _state(trainer)
    monkeypatch.setattr(trainer_mod, "compute_loss", lambda p, t, *a, **k: (p * float("inf")).mean())
    metrics = trainer.train_step(torch.from_numpy(img), torch.from_numpy(mask))
    assert not metrics["finite"] and not np.isfinite(metrics["loss"])
    assert all(torch.equal(sd0[k], v) for k, v in trainer.model.state_dict().items())


# (e): checkpoint, resume, preemption

def test_resume_is_exact(tmp_path):
    """Two epochs, checkpoint, resume in a fresh Trainer: its third epoch equals an
    uninterrupted run's bit for bit (augmentation on: order and augmentation come from
    (seed, epoch), dropout masks from (seed, step))."""
    cfg = _data_config(tmp_path, num_epochs=3, save_checkpoint_freq=1)
    cfg["dataset"]["augmentation"] = True
    whole = _trainer(cfg, seed=3)
    whole.train()
    cfg2 = {**cfg, "training": {**cfg["training"], "num_epochs": 2},
            "logging": {**cfg["logging"], "log_dir": str(tmp_path / "b"), "images_dir": str(tmp_path / "b/img")}}
    first = _trainer(cfg2, seed=3)
    first.train()
    ckpt = ckpt_util.latest_epoch_checkpoint(first.checkpoint_dir)
    assert ckpt.endswith("checkpoint_epoch_2") and not [f for f in os.listdir(first.checkpoint_dir) if ".tmp" in f]
    cfg2["training"]["num_epochs"] = 3
    resumed = _trainer(cfg2, seed=3, model_seed=9)  # other weights: the checkpoint must replace them
    resumed.train(resume_from=ckpt)
    assert resumed.start_epoch == 2 and resumed.step == whole.step == 6
    assert resumed.epochs == [1, 2, 3] and resumed.best_val_dice == whole.best_val_dice
    for key in whole.history:
        assert resumed.history[key] == whole.history[key], key
    a, ma = _state(whole)
    b, mb = _state(resumed)
    assert all(torch.equal(a[k], b[k]) for k in a) and all(torch.equal(ma[k], mb[k]) for k in ma)


def test_stop_request_checkpoints_and_resumes(tmp_path):
    """SIGTERM during epoch 2: the epoch ends early, a checkpoint is written, and it resumes."""
    cfg = _data_config(tmp_path, seed=3, num_epochs=50)
    cfg["training"]["loss"] = {"type": "dice", "params": {}}
    trainer = _trainer(cfg)
    orig = trainer.train_epoch

    def stopping_train_epoch(epoch):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)  # the handler train() installed sets the flag
        return orig(epoch)

    trainer.train_epoch = stopping_train_epoch
    old = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        trainer.train()
    finally:
        signal.signal(signal.SIGTERM, old[0])
        signal.signal(signal.SIGINT, old[1])
    assert trainer._stop_requested.is_set() and len(trainer.history["train_losses"]) == 2
    assert trainer.step == 3  # epoch 2 stopped after its first step
    ckpt = ckpt_util.latest_epoch_checkpoint(trainer.checkpoint_dir)
    assert ckpt is not None and ckpt.endswith("checkpoint_epoch_2"), ckpt
    cfg["training"]["num_epochs"] = 3
    trainer2 = _trainer(cfg, model_seed=5)
    trainer2.train(resume_from=ckpt)
    assert trainer2.start_epoch == 2 and len(trainer2.history["train_losses"]) == 3
    assert np.isfinite(trainer2.history["train_losses"]).all()


# (f): remat

@pytest.mark.parametrize("remat", ["all", "l12", "deep"])
def test_remat_gives_the_same_loss_and_gradients(tmp_path, remat):
    """Tolerance 1e-6: the recomputation repeats the forward's arithmetic exactly; BatchNorm
    statistics move once."""
    img, mask = uint8_batches(6, 1, 4, HW)[0]
    results = {}
    for mode in (False, remat):
        model = init_random_(create_model({"model": SMALL}, device="cpu", remat=mode),
                             torch.Generator().manual_seed(0))
        assert model.remat == mode
        trainer = Trainer(model, None, None, train_config(tmp_path), device="cpu", progress=False)
        model.train()
        x, t = trainer._inputs(torch.from_numpy(img), torch.from_numpy(mask))
        loss = trainer_mod.compute_loss(torch.sigmoid(model(x).float()), t, "bce_dice", {})
        loss.backward()
        results[mode] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                         {n: b.clone() for n, b in model.named_buffers()})
    assert abs(results[remat][0] - results[False][0]) <= 1e-6
    for name, g in results[False][1].items():
        assert torch.allclose(results[remat][1][name], g, rtol=0, atol=1e-6 * max(1.0, g.abs().max().item())), name
    for name, b in results[False][2].items():
        assert torch.equal(results[remat][2][name], b), name


def test_unknown_remat_and_unported_options_raise(tmp_path):
    model = create_model({"model": SMALL}, device="cpu", remat="some")
    with pytest.raises(ValueError, match="remat"):
        model(torch.zeros(1, 3, 32, 32))
    # row sharding constructs: training.spatial_parallel is the CLI's to act on (the Trainer takes its
    # mesh), and serving_mesh(spatial=2) needs two processes (one raises JAX's ValueError); over two, the
    # 2-D layout forms, the flagship's Trainer constructs, and so do the Trainers and Predictors of the
    # models row sharding once refused; a Predictor of a callable that is neither a module nor an engine
    # of the port still raises
    Trainer(port_model(SMALL), None, None, train_config(tmp_path, spatial_parallel=2), device="cpu")
    with pytest.raises(ValueError, match="must divide the device count 1"):
        serving_mesh(spatial=2, device="cpu")
    pair = rows_worker.spawn(["mesh"], tmp_path)["mesh"]
    # world, rank, spatial, data size, data index, spatial index, has a spatial group, has a data group,
    # and the flagship Trainer's spatial and data axes
    assert [list(r["fields"]) for r in pair] == [[2, 0, 2, 1, 0, 0, 1, 1, 2, 1], [2, 1, 2, 1, 0, 1, 1, 1, 2, 1]]
    for got in pair:
        for label in rows_worker.BANDED_SINCE:
            for kind in ("Trainer", "Predictor"):
                assert str(got[f"{label} {kind}"]) == "constructed", (label, kind, str(got[f"{label} {kind}"]))
        assert "is not supported" in str(got["foreign callable"]), str(got["foreign callable"])
    # ported since: exact accumulation and the kernels' build directory construct
    from dfc_sa_unet_torch.ops import _build

    build_dir = _build.BUILD_DIR
    try:
        exact = Trainer(port_model(SMALL), None, None, train_config(tmp_path, grad_accum=2, grad_accum_exact=True),
                        device="cpu")
        assert exact.grad_accum == 2 and exact.grad_accum_exact
        Trainer(port_model(SMALL), None, None, train_config(tmp_path, exe_cache_dir=str(tmp_path / "x")), device="cpu")
        assert _build.BUILD_DIR == (tmp_path / "x").resolve()
    finally:
        _build.BUILD_DIR = build_dir
    # data_parallel in the YAML is the CLI's to act on; the Trainer takes its mesh
    Trainer(port_model(SMALL), None, None, train_config(tmp_path, data_parallel=True), device="cpu")
    # grad_accum > 1 under a group (here of one process) constructs too
    mesh = data_parallel_mesh("cpu", coordinator=local_coordinator(), num_processes=1, process_id=0, timeout_s=60)
    try:
        assert mesh.group is not None and mesh.backend == "gloo"
        for exact in (False, True):
            dp = Trainer(port_model(SMALL), None, None, train_config(tmp_path, grad_accum=2, grad_accum_exact=exact),
                         mesh=mesh, device="cpu")
            assert dp.data_parallel and dp.grad_accum == 2 and dp.grad_accum_exact == exact
    finally:
        mesh.close()


def test_same_seed_gives_the_same_dropout_step_twice(tmp_path):
    vit = {"name": "VisionTransformerSegmentation", "img_dim": 32, "patch_dim": 8, "embed_dim": 32, "num_layers": 1,
           "num_heads": 2, "mlp_dim": 64, "dropout": 0.3}
    img, mask = uint8_batches(7, 1, 4, HW)[0]
    losses = []
    for seed in (11, 11, 12):
        trainer = Trainer(port_model(vit, seed=0), None, None, train_config(tmp_path, vit), seed=seed, device="cpu",
                          progress=False)
        losses.append(trainer.train_step(torch.from_numpy(img), torch.from_numpy(mask))["loss"])
    assert losses[0] == losses[1] != losses[2]


# (g): the command line

def test_train_cli_writes_artifacts_that_the_inference_cli_serves(tmp_path):
    import yaml

    cfg = _data_config(tmp_path, num_epochs=8, batch_size=2, learning_rate=0.05)  # 32 steps: the running statistics settle
    cfg["logging"]["save_best_worst_samples"] = 1
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    # two threads, as the in-process tests: the test workers share the machine's cores
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-m", "dfc_sa_unet_torch.train", "--config", str(path), "--device", "cpu",
                          "--remat", "l12", "--seed", "1"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    log = cfg["logging"]["log_dir"]
    assert os.path.isfile(os.path.join(log, "best_model")), out.stdout[-1500:]
    assert os.path.isfile(os.path.join(log, "checkpoints", "best_checkpoint"))
    for name in ("loss_plot.png", "loss_plot.csv", "dice_plot.png", "iou_plot.png"):
        assert os.path.isfile(os.path.join(log, "images", name)), name
    assert os.path.isdir(os.path.join(log, "epoch_1", "best_samples"))
    weights = torch.load(os.path.join(log, "best_model"), weights_only=True)
    assert set(weights) == set(create_model(cfg, device="cpu").state_dict())
    served = tmp_path / "served"
    out = subprocess.run([sys.executable, "-m", "dfc_sa_unet_torch.inference", "--config", str(path), "--model",
                          os.path.join(log, "best_model"), "--input", cfg["dataset"]["val_dir"], "--output",
                          str(served), "--tile_size", "32", "--overlap", "0", "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dice" in out.stdout.lower() and any(served.iterdir())
