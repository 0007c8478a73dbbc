"""The port's 2-process data-parallel step against the JAX package's sharded step.

JAX: the conv + BatchNorm + conv mini-net of tests/test_parallel_fast.py:45-66 through its
Trainer over the 8 virtual CPU devices (``parallel.data_parallel_mesh()``, GSPMD).  The port: the
same weights, converted by ``utils.weights.from_jax_variables``, and the same batch through its
Trainer in a group of 2 Gloo processes (``_torch_dp_worker``), for each of the four losses, a
batch of 5 rows that divides neither group (both run it replicated), and the exact accumulation
step of tests/test_grad_accum.py:220 (batch 16, ``grad_accum`` 2, ``grad_accum_exact``, Dice: JAX's
microbatch of 8 over its 8 devices, the port's 4 rows of each microbatch a process).  Loss, updated parameters
and BatchNorm statistics within atol 1e-5 / rtol 1e-4 (the loss rtol 1e-5).  After the step both
evaluate 5 validation samples padded to the group (JAX: to 8 rows with a ``valid`` mask; the
port: 3 rows a process, the last one padding), whose loss, hard IoU and Dice and per-sample
metrics agree within the same limits (the loss again rtol 1e-5).  The JAX flagship's sharded
step sits in the slow set (tests/test_parallel.py); the flagship is held to JAX through the
port's single-process step (tests/test_torch_trainer.py), which tests/test_torch_parallel.py
holds the group to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from _torch_port import uint8_batches
from dfc_sa_unet_tpu.parallel import data_parallel_mesh
from dfc_sa_unet_tpu.train.trainer import Trainer as JaxTrainer
from dfc_sa_unet_torch.data.dataset import ArrayDataset
from dfc_sa_unet_torch.data.loader import BatchLoader
from dfc_sa_unet_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

CASES = ["mini_bce_dice", "mini_dice", "mini_tversky", "mini_joint", "replicated", "mini_dice_exact16"]


def _jax_mini_net():
    import flax.linen as nn

    from dfc_sa_unet_tpu.nn.layers import BatchNorm, Conv

    class MiniNet(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            x = Conv(features=4, kernel_size=3, padding=1, name="c1")(x)
            x = BatchNorm(name="bn1")(x, train=train)
            x = nn.relu(x)
            return Conv(features=1, kernel_size=1, name="c2")(x)

    return MiniNet()


def _jax_case(case, log_dir):
    """The JAX sharded step of ``case`` and its padded eval after it.  Returns (the JAX results,
    the port's inputs: the starting state dict and the training items)."""
    model, loss, params, n, batch, side, *training = worker.CASES[case]
    cfg = worker.config(log_dir, model, loss, params, batch, side, *training)
    img, mask = uint8_batches(4, 1, n, (side, side))[0]
    items = [(f"s{i:02d}", img[i], mask[i]) for i in range(n)]
    # the port's loader shuffles the epoch's one batch; JAX takes its rows in the same order, which
    # decides the microbatches under grad_accum
    first = next(iter(BatchLoader(ArrayDataset(items), batch, shuffle=True, num_workers=1, seed=0)))
    img, mask = first["image"].numpy(), first["mask"].numpy()

    jmodel = _jax_mini_net()
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, side, side, 3), jnp.float32), train=False)
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda v: v + 0.1 * jnp.arange(v.size, dtype=v.dtype), variables["batch_stats"])}
    start = from_jax_variables(jax.tree.map(np.asarray, variables))  # before the step donates them
    jt = JaxTrainer(jmodel, None, None, cfg, mesh=data_parallel_mesh(), seed=0, init_variables=variables)
    state = jt.init_state(None)
    imgs, masks, valid = jt._put_batch({"image": img, "mask": mask})
    # a batch that does not divide the 8 devices runs replicated, unsharded
    assert valid is None and len(imgs.sharding.device_set) == (8 if n % 8 == 0 else 1)
    state, jm = jt._train_step(state, imgs, masks)
    want = from_jax_variables({"params": jax.tree.map(np.asarray, state.params),
                               "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})

    names, vimg, vmask = zip(*worker.val_samples(side))
    imgs, masks, valid = jt._put_batch({"image": np.stack(vimg), "mask": np.stack(vmask)}, pad_to_devices=True)
    assert valid is not None and valid.shape == (8,) and float(valid.sum()) == len(names)
    _, em = jt._eval_step(state, imgs, masks, valid)
    jax_out = {"loss": float(jm["loss"]), "state": want, "names": list(names),
               "val": np.array([float(em["loss"]), float(em["iou"]), float(em["dice"])]),
               "val_dice": np.asarray(em["per_sample_dice"])[:len(names)],
               "val_iou": np.asarray(em["per_sample_iou"])[:len(names)]}
    return jax_out, (start, items)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (the JAX results, [the port's result on rank 0, rank 1])}: every case's JAX step,
    then one group of 2 processes that runs them all."""
    tmp = tmp_path_factory.mktemp("vs_jax")
    jax_out, inputs = {}, {}
    for case in CASES:
        jax_out[case], inputs[case] = _jax_case(case, str(tmp / f"jax_logs_{case}"))
    torch.save(inputs, tmp / "inputs.pt")
    results = worker.spawn(CASES, tmp, inputs=tmp / "inputs.pt")
    return {case: (jax_out[case], results[case]) for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_two_process_step_matches_the_jax_sharded_step(runs, case):
    want, results = runs[case]
    accum = worker.CASES[case][6]["grad_accum"] if len(worker.CASES[case]) > 6 else 1
    for rank, got in enumerate(results):
        np.testing.assert_allclose(got["train"][0], want["loss"], atol=1e-5, rtol=1e-5, err_msg=f"rank {rank}")
        for k, v in want["state"].items():
            if k.endswith("num_batches_tracked"):
                assert int(got[f"sd/{k}"]) == accum, k  # once a microbatch
                continue
            np.testing.assert_allclose(got[f"sd/{k}"], v.numpy(), atol=1e-5, rtol=1e-4, err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("case", CASES)
def test_two_process_padded_eval_matches_the_jax_sharded_eval(runs, case):
    """The port's sharded ``validate_epoch`` (a padding row on the second process) against the JAX
    trainer's eval step on the batch padded to its 8 devices with a ``valid`` mask."""
    want, results = runs[case]
    for rank, got in enumerate(results):
        assert list(got["val_names"]) == want["names"], f"rank {rank}"
        np.testing.assert_allclose(got["val"][0], want["val"][0], atol=1e-5, rtol=1e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["val"][1:], want["val"][1:], atol=1e-5, rtol=1e-4, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["val_dice"], want["val_dice"], atol=1e-5, rtol=1e-4, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["val_iou"], want["val_iou"], atol=1e-5, rtol=1e-4, err_msg=f"rank {rank}")
