"""Data-parallel training in the port: a group of 2 Gloo processes on the CPU against one
process on the same global batches (as tests/test_parallel_fast.py holds JAX's sharded step to
its single-device step).

The group runs once for the file (``_torch_dp_worker.spawn``: every case through the Trainer's
train_epoch and validate_epoch, each process on its chunk of the batch, hard time limits).
Cases: the conv + BatchNorm + conv mini-net under each of the four losses (two steps of the
flagship at features 8/16/24/32, pool 1, 16x16, with momentum on the second), a training batch
of 5 that runs whole on both processes, and a validation batch of 5 that pads the second
process's chunk with a zero row (every case); ``grad_accum`` 2, the default path and the exact
one (the mini-net under Dice, the flagship under bce_dice: the exact step's recomputations run
BatchNorm's collectives inside the backward), each process on its share of every microbatch;
and microbatches of 3, which do not divide among 2 processes, run replicated with one warning.  Limits: loss atol 1e-5 / rtol 1e-5, parameters,
BatchNorm statistics and per-sample metrics atol 1e-5 / rtol 1e-4 (tests/test_parallel_fast.py:89-93).
"""

import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from dfc_sa_unet_torch.nn.layers import BatchNorm, bn_cross_replica
from dfc_sa_unet_torch.parallel.mesh import data_parallel_mesh, local_coordinator

torch.set_num_threads(2)
EQUAL_CASES = ["mini_bce_dice", "mini_dice", "mini_tversky", "mini_joint", "flagship", "replicated",
               "mini_dice_accum2", "mini_dice_exact2", "flagship_exact2", "accum_replicated"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    return worker.spawn(EQUAL_CASES + ["vit_dropout", "preemption"], out), out


@pytest.mark.parametrize("case", EQUAL_CASES)
def test_two_processes_equal_one(group, case):
    results, out = group
    ref = worker.run_case(case, None, str(out / f"single_{case}"))
    for rank, got in enumerate(results[case]):
        np.testing.assert_allclose(got["train"][0], ref["train"][0], atol=1e-5, rtol=1e-5, err_msg="train loss")
        np.testing.assert_allclose(got["train"][1:], ref["train"][1:], atol=1e-5, rtol=1e-4, err_msg="train iou/dice")
        np.testing.assert_allclose(got["val"][0], ref["val"][0], atol=1e-5, rtol=1e-5, err_msg="val loss")
        np.testing.assert_allclose(got["val"][1:], ref["val"][1:], atol=1e-5, rtol=1e-4, err_msg="val iou/dice")
        # the padded validation batch: every real row's metrics in the global order, the padding gone
        assert list(got["val_names"]) == list(ref["val_names"]) and len(ref["val_names"]) == worker.VAL_SAMPLES
        np.testing.assert_allclose(got["val_dice"], ref["val_dice"], atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got["val_iou"], ref["val_iou"], atol=1e-5, rtol=1e-4)
        keys = [k for k in ref if k.startswith("sd/")]
        assert keys and set(keys) == {k for k in got if k.startswith("sd/")}
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4, err_msg=f"rank {rank} {k}")
    # one update everywhere: the processes hold the same bits
    for k in results[case][0]:
        if k.startswith("sd/"):
            assert np.array_equal(results[case][0][k], results[case][1][k]), k


def test_replicated_batch_runs_without_the_rank_in_the_dropout_seed(group):
    """A batch that does not divide runs whole on each process with every collective off, so each
    process draws the single-process step's dropout seed; a sharded batch folds the rank in."""
    results, _ = group
    rep = results["replicated"]
    assert int(rep[0]["seed"]) == int(rep[1]["seed"])
    sharded = results["mini_bce_dice"]
    assert int(sharded[0]["seed"]) != int(sharded[1]["seed"])


def test_undivided_microbatch_runs_replicated_with_one_warning(group):
    """Batch 6 at grad_accum 2 on 2 processes: a microbatch of 3 does not divide, so every batch runs
    whole on each process with every collective off (the single-process dropout seed), and the primary
    warns once in JAX's words over the epoch's two steps (tests/test_parallel_fast.py:469 (b))."""
    results, _ = group
    r0, r1 = results["accum_replicated"]
    assert int(r0["accum_warnings"]) == 1 and int(r1["accum_warnings"]) == 0
    assert int(r0["seed"]) == int(r1["seed"])
    for case in ("mini_dice_accum2", "mini_dice_exact2"):
        assert all(int(r["accum_warnings"]) == 0 for r in results[case]), case


def test_vit_dropout_differs_between_processes_and_repeats(group):
    """Tiny ViT-seg at dropout 0.3: each process draws its own masks (the rank is folded into the
    step's seed), a second run of the same case gives the same bits, and the averaged update leaves
    both processes with the same weights."""
    results, _ = group
    r0, r1 = results["vit_dropout"]
    assert int(r0["seed"]) != int(r1["seed"])
    for k in r0:
        if k.startswith("sd/"):
            assert np.array_equal(r0[k], r0[f"again/{k}"]) and np.array_equal(r1[k], r1[f"again/{k}"]), k
            assert np.array_equal(r0[k], r1[k]), k


def test_sigterm_on_one_process_stops_both_at_the_same_step(group):
    """SIGTERM reaches the second process after step 3: both stop after step 3 (the flag is agreed
    on with ``any_flag`` at every step), both record the same epochs, and only the primary writes
    the preemption checkpoint."""
    results, _ = group
    r0, r1 = results["preemption"]
    assert list(r0["steps"]) == list(r1["steps"]) == [1, 2, 3]
    assert int(r0["epochs"]) == int(r1["epochs"]) == 2
    assert "checkpoint_epoch_2" in list(r0["checkpoints"]) and len(r1["checkpoints"]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cross_replica_batchnorm_of_one_process_equals_batch_norm(dtype):
    """``bn_cross_replica`` in a group of one process (Gloo, in this process) against the layer's
    ``F.batch_norm`` path: output, the gradients of x, weight and bias, and the running statistics,
    on activations whose mean is 3 standard deviations from 0 (E[x^2] - E[x]^2 and the backward's
    dy x - mean dy cancel there).  f32: 1e-5 of the largest magnitude; bf16: one bf16 rounding."""
    gen = torch.Generator().manual_seed(7)
    x0 = (torch.randn(6, 5, 7, 9, generator=gen) * 2 + 6).to(dtype).to(memory_format=torch.channels_last)
    dy = torch.randn(x0.shape, generator=gen).to(dtype)
    mesh = data_parallel_mesh("cpu", coordinator=local_coordinator(), num_processes=1, process_id=0, timeout_s=60)
    try:
        out = []
        for cross in (False, True):
            bn = BatchNorm(5).train()
            with torch.no_grad():
                bn.weight.copy_(torch.linspace(0.5, 1.5, 5))
                bn.bias.copy_(torch.linspace(-0.2, 0.2, 5))
            x = x0.clone().requires_grad_(True)
            with bn_cross_replica(cross):
                y = bn(x)
            y.backward(dy)
            out.append([y.float(), x.grad.float(), bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var])
    finally:
        mesh.close()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, got, want in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"), out[1], out[0]):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= tol * max(scale, 1.0), (name, (got - want).abs().max().item(), scale)


def test_each_process_takes_the_card_of_its_local_rank(monkeypatch):
    """``cuda`` (or no device) means ``cuda:LOCAL_RANK``; a rank past the visible cards raises instead
    of wrapping round; an explicit index or the CPU wins."""
    from dfc_sa_unet_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mesh_mod._rank_device(None, 1) == torch.device("cuda", 1)
    assert mesh_mod._rank_device("cuda", 0) == torch.device("cuda", 0)
    assert mesh_mod._rank_device("cuda:0", 1) == torch.device("cuda", 0)
    assert mesh_mod._rank_device("cpu", 5) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no card: 2 visible"):
        mesh_mod._rank_device("cuda", 2)


def test_the_clis_mesh_follows_their_flags(monkeypatch):
    """One process without torchrun (a note for --data_parallel), and a refusal for a process started
    as one of several without --data_parallel or --multihost: it would do the same work alone."""
    import argparse

    from dfc_sa_unet_torch.parallel.mesh import add_parallel_flags, mesh_from_flags

    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    add_parallel_flags(parser, "work")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    single = mesh_from_flags(parser.parse_args(["--data_parallel"]))
    assert single.group is None and single.world_size == 1 and single.device == torch.device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="one of 2 processes"):
        mesh_from_flags(parser.parse_args([]))
