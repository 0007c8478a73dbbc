"""Gradient accumulation in the port's Trainer, above all ``grad_accum_exact`` (one loss over every
microbatch's probabilities, each microbatch's forward rematerialised in the backward), against the
monolithic step, the default path, a one-graph reference and the JAX trainer's exact step
(tests/test_grad_accum.py holds the JAX trainer to the same properties).

Tolerances: exact against monolithic on a BatchNorm-free net, loss rtol 1e-6 and parameters rtol
1e-6 / atol 1e-9 (JAX's own gate, tests/test_grad_accum.py:173: the conv weight gradient's batch
sum is split in two, which reorders it); against the JAX trainer ``_torch_port.assert_step_matches``
(loss, IoU and Dice 1e-5, updates 1e-3 of the tensor's largest update, BatchNorm statistics 1e-5;
for ``joint`` the updates no further from JAX's than the monolithic step's, see its test);
BatchNorm statistics of the exact path against the default path rtol 1e-5 / atol 1e-6 (JAX :208);
gradients of the exact path with dropout against one graph 1e-6 of their largest magnitude;
parameters with and without ``remat`` l12 inside the exact step 1e-6.
"""

import contextvars
import threading

import numpy as np
import pytest
import torch
from torch import nn

from _torch_port import (SMALL, assert_step_matches, jax_model_and_variables, port_model, run_both_trainers,
                         train_config, uint8_batches, update_disagreement)
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.nn.layers import Conv
from dfc_sa_unet_torch.ops.dropout import remat_call
from dfc_sa_unet_torch.train import trainer as trainer_mod
from dfc_sa_unet_torch.train.trainer import Trainer
from dfc_sa_unet_torch.utils.weights import init_random_

torch.set_num_threads(2)
HW = (32, 32)
LOSSES = {"dice": {}, "tversky": {"alpha": 0.3, "beta": 0.7},
          "bce_dice": {"bce_weight": 0.5, "dice_weight": 0.5},
          "joint": {"bce_weight": 0.4, "dice_weight": 0.4, "contour_weight": 0.2}}
VIT_DROPOUT = {"name": "VisionTransformerSegmentation", "img_dim": 32, "patch_dim": 8, "embed_dim": 32,
               "num_layers": 1, "num_heads": 2, "mlp_dim": 64, "dropout": 0.3}


class PlainConvNet(nn.Module):
    """No BatchNorm (tests/test_grad_accum.py's _PlainConvNet): nothing couples the rows of a batch but
    the loss, so the exact step is the monolithic one."""

    def __init__(self):
        super().__init__()
        self.c1 = Conv(3, 6, 3, padding=1)
        self.c2 = Conv(6, 1, 1)

    def forward(self, x):
        return self.c2(torch.relu(self.c1(x)))


def _config(tmp_path, loss_type="dice", **training):
    cfg = train_config(tmp_path, **training)
    cfg["training"]["loss"] = {"type": loss_type, "params": dict(LOSSES[loss_type])}
    return cfg


def _step(tmp_path, model, loss_type="dice", seed=7, batch=4, **training):
    """One train_step of ``model`` on a seeded uint8 batch; returns (metrics, parameters and buffers)."""
    trainer = Trainer(model, None, None, _config(tmp_path, loss_type, **training), device="cpu", progress=False)
    img, mask = uint8_batches(seed, 1, batch, HW)[0]
    metrics = trainer.train_step(torch.from_numpy(img), torch.from_numpy(mask))
    assert metrics["finite"]
    return metrics, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _plain_net():
    return init_random_(PlainConvNet(), torch.Generator().manual_seed(3))


@pytest.mark.parametrize("loss_type", list(LOSSES))
def test_exact_equals_monolithic_without_batchnorm(tmp_path, loss_type):
    mono, sd_mono = _step(tmp_path, _plain_net(), loss_type)
    exact, sd_exact = _step(tmp_path, _plain_net(), loss_type, grad_accum=2, grad_accum_exact=True)
    np.testing.assert_allclose(exact["loss"], mono["loss"], rtol=1e-6)
    for k, v in sd_mono.items():
        np.testing.assert_allclose(sd_exact[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-9, err_msg=k)


def test_default_path_is_not_monolithic_for_dice(tmp_path):
    """The average of two microbatches' Dice losses is another loss: without it the exact path would
    be redundant (tests/test_grad_accum.py:195)."""
    _, sd_mono = _step(tmp_path, _plain_net())
    _, sd_avg = _step(tmp_path, _plain_net(), grad_accum=2)
    assert max((sd_avg[k] - v).abs().max().item() for k, v in sd_mono.items()) > 0


def test_undivided_batch_runs_as_one_monolithic_step(tmp_path):
    """grad_accum 3 does not divide a batch of 4: the step is the monolithic one (JAX trainer.py:320)."""
    mono, sd_mono = _step(tmp_path, port_model(SMALL, seed=1))
    for exact in (False, True):
        got, sd = _step(tmp_path, port_model(SMALL, seed=1), grad_accum=3, grad_accum_exact=exact)
        assert got == mono
        for k, v in sd_mono.items():
            assert torch.equal(sd[k], v), k


def _both_steps(tmp_path, loss_type, **training):
    cfg = _config(tmp_path, loss_type, **training)
    model = port_model(SMALL, seed=1)
    jmodel, _ = jax_model_and_variables(SMALL, model, use_pallas=True)
    steps, init = run_both_trainers(cfg, model, jmodel, HW, uint8_batches(0, 1, 4, HW))
    return steps[0], init


@pytest.mark.parametrize("loss_type", list(LOSSES))
def test_exact_step_matches_the_jax_trainer(tmp_path, loss_type):
    """The small flagship with BatchNorm, converted weights: the port's exact step against the JAX
    trainer's (grad_accum 2, grad_accum_exact), loss, metrics, parameters and BatchNorm statistics.

    ``joint`` is held to JAX in its parameter updates no worse than the monolithic step is: its
    contour BCE divides by the clamped Laplacian of the probabilities, close to 0 for the smooth
    maps of seeded weights, so the gradient amplifies f32 differences in the probabilities, and the
    clip to norm 1 leaves most tensors an update of a few ulps.  Even at grad_accum 1 the port's
    update sits a large fraction of a tensor's largest update from JAX's (ROADMAP.md, differences
    that are not faults)."""
    step, init = _both_steps(tmp_path, loss_type, grad_accum=2, grad_accum_exact=True)
    assert_step_matches(*step, init, updates=loss_type != "joint")
    if loss_type == "joint":
        mono, mono_init = _both_steps(tmp_path, loss_type)
        assert_step_matches(*mono, mono_init, updates=False)
        assert update_disagreement(*step[2:], init) <= update_disagreement(*mono[2:], mono_init)
    tracked = [v for k, v in step[2].items() if k.endswith("num_batches_tracked")]
    assert tracked and all(int(v) == 2 for v in tracked)  # once a microbatch; the recomputation moves nothing


def test_exact_batchnorm_statistics_equal_the_default_paths(tmp_path):
    """Only the loss's coupling changes: BatchNorm's running statistics thread through the microbatches
    as in the default path (tests/test_grad_accum.py:208)."""
    _, sd_exact = _step(tmp_path, port_model(SMALL, seed=2), grad_accum=2, grad_accum_exact=True)
    _, sd_avg = _step(tmp_path, port_model(SMALL, seed=2), grad_accum=2)
    keys = [k for k in sd_avg if k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(sd_exact[k].numpy(), sd_avg[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_exact_with_dropout_equals_one_graph(tmp_path):
    """Tiny ViT-seg at dropout 0.3: the exact step's gradients equal those of one graph in which both
    microbatch forwards run with grad from the step's generator state, then one loss and one backward.
    The recomputation must replay each microbatch's masks."""
    cfg = _config(tmp_path, "bce_dice", grad_accum=2, grad_accum_exact=True)
    img, mask = uint8_batches(9, 1, 4, HW)[0]
    grads = {}
    trainer = Trainer(port_model(VIT_DROPOUT, seed=0), None, None, cfg, seed=5, device="cpu", progress=False)
    start = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    step = trainer.optimizer.step

    def recording_step():
        grads.update({n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None})
        step()

    trainer.optimizer.step = recording_step
    got = trainer.train_step(torch.from_numpy(img), torch.from_numpy(mask))
    assert got["finite"] and grads

    ref = Trainer(port_model(VIT_DROPOUT, seed=0), None, None, cfg, seed=5, device="cpu", progress=False)
    ref.model.load_state_dict(start)
    ref.model.train()
    x, t = ref._inputs(torch.from_numpy(img), torch.from_numpy(mask))
    ref.generator.manual_seed(trainer_mod._step_seed(5, 0))
    probs = torch.cat([torch.sigmoid(ref.model(xi).float()) for xi in x.chunk(2)])
    loss = trainer_mod.compute_loss(probs, t, "bce_dice", LOSSES["bce_dice"])
    loss.backward()
    assert abs(loss.item() - got["loss"]) <= 1e-6 * max(1.0, abs(loss.item()))
    for n, p in ref.model.named_parameters():
        want = p.grad
        scale = max(want.abs().max().item(), 1e-12)
        assert (grads[n] - want).abs().max().item() <= 1e-6 * scale, n


def test_exact_with_remat_equals_exact_without(tmp_path):
    """``remat='l12'`` inside an exact step nests one rematerialised call in another: the same
    parameters and BatchNorm statistics as the exact step without it."""
    results = []
    for remat in (False, "l12"):
        model = init_random_(create_model({"model": SMALL}, device="cpu", remat=remat),
                             torch.Generator().manual_seed(4))
        results.append(_step(tmp_path, model, "bce_dice", grad_accum=2, grad_accum_exact=True))
    (m0, sd0), (m1, sd1) = results
    assert abs(m0["loss"] - m1["loss"]) <= 1e-6
    for k, v in sd0.items():
        np.testing.assert_allclose(sd1[k].numpy(), v.numpy(), rtol=0, atol=1e-6 * max(1.0, v.abs().max().item()),
                                   err_msg=k)


def test_recomputation_runs_in_the_forwards_context_from_another_thread():
    """On the card the backward runs in autograd's device thread, which does not see the caller's
    context variables (``bn_cross_replica``). Here a backward started from a fresh thread stands in for
    it: the recomputation must still see the value the forward saw."""
    flag = contextvars.ContextVar("flag", default="unset")
    seen = []

    def fn(x):
        seen.append(flag.get())
        return (x * 2.0).sin()

    x = torch.randn(5, requires_grad=True)
    token = flag.set("forward")
    try:
        y = remat_call(fn, x).sum()
    finally:
        flag.reset(token)
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert seen == ["forward", "forward"]
    assert torch.allclose(x.grad, 2.0 * (x.detach() * 2.0).cos())


def test_data_parallel_accumulation_needs_a_microbatch_loader(tmp_path):
    """Under a group a sharded train loader must hand each process its share of every microbatch: a
    loader built without ``microbatches=grad_accum`` would split each process's chunk instead."""
    from dfc_sa_unet_torch.data.dataset import ArrayDataset
    from dfc_sa_unet_torch.data.loader import BatchLoader
    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.parallel.mesh import data_parallel_mesh, local_coordinator

    data = ArrayDataset(list(samples(n=4, size=32, seed=0)))
    mesh = data_parallel_mesh("cpu", coordinator=local_coordinator(), num_processes=1, process_id=0, timeout_s=60)
    try:
        for k, ok in ((1, False), (2, True)):
            loader = BatchLoader(data, 4, shuffle=False, num_workers=1, shard=(0, 1), partial="replicate",
                                 microbatches=k)
            cfg = _config(tmp_path, grad_accum=2, grad_accum_exact=True)
            if ok:
                Trainer(port_model(SMALL), loader, None, cfg, mesh=mesh, device="cpu", progress=False)
            else:
                with pytest.raises(ValueError, match="microbatches=2"):
                    Trainer(port_model(SMALL), loader, None, cfg, mesh=mesh, device="cpu", progress=False)
    finally:
        mesh.close()
