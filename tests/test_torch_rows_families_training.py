"""Row (spatial) sharding of the families banded after the DFC family, in training: 2 Gloo
processes, each on a band of every image's rows, against one process on the same batches (the
port's counterpart of tests/test_parallel_fast.py:331 for these families).

One group runs every case for the file (``_torch_dp_worker.spawn(..., spatial=2)``, one f32 step
each through the Trainer's train_epoch and validate_epoch): ViT-seg (tests/test_parallel_fast.py:
548's size; the token stage gathered, its gradient reduce-scattered back to the bands' patches),
the small TransUNet (64x64: the R50 stem's strided convs and pool read their halo rows, GroupNorm
takes the group's statistics), UNet_FullResAttention (the gathered keys) and the vanilla UNet with
``bilinear: true``.  Limits: loss atol 1e-5 / rtol 1e-5, parameters, BatchNorm statistics and the
validation's metrics atol 1e-5 / rtol 1e-4 (tests/test_parallel_fast.py:89-93).  ViT-seg at dropout
0.1: every dropout acts on tokens, which both bands compute whole, so they draw the same masks (the
step's seed folds in the data index, not the rank) and their encoder outputs are the same bits.
"""

import numpy as np
import pytest
import torch

import _torch_dp_worker as worker

torch.set_num_threads(2)

CASES = ["bands_vit", "bands_transunet", "bands_fullres", "bands_bilinear"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rows_families_training")
    return worker.spawn(CASES + ["bands_vit_dropout"], tmp, spatial=2), tmp


@pytest.mark.parametrize("case", CASES)
def test_two_bands_train_as_one_process(runs, case):
    results, tmp = runs
    ref = worker.run_case(case, None, str(tmp / f"single_{case}"))
    for rank, got in enumerate(results[case]):
        assert int(got["spatial_warnings"]) == 0
        np.testing.assert_allclose(got["train"][0], ref["train"][0], atol=1e-5, rtol=1e-5, err_msg="train loss")
        np.testing.assert_allclose(got["train"][1:], ref["train"][1:], atol=1e-5, rtol=1e-4, err_msg="train iou/dice")
        np.testing.assert_allclose(got["val"], ref["val"], atol=1e-5, rtol=1e-4, err_msg="val loss/iou/dice")
        np.testing.assert_allclose(got["val_dice"], ref["val_dice"], atol=1e-5, rtol=1e-4)
        keys = [k for k in ref if k.startswith("sd/")]
        assert keys and set(keys) == {k for k in got if k.startswith("sd/")}
        for k in keys:
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4, err_msg=f"rank {rank} {k}")
    for k in results[case][0]:  # one update everywhere: the bands hold the same bits
        if k.startswith("sd/"):
            assert np.array_equal(results[case][0][k], results[case][1][k]), k


def test_dropout_draws_the_same_masks_in_both_bands(runs):
    results, _ = runs
    r0, r1 = results["bands_vit_dropout"]
    assert r0["encoded"].shape == r1["encoded"].shape == (1, 4, 16, 32)  # one step, 4 images of 16 tokens
    assert np.array_equal(r0["encoded"], r1["encoded"])
    assert int(r0["seed"]) == int(r1["seed"])
    assert np.isfinite(r0["encoded"]).all()
    for k in r0:
        if k.startswith("sd/"):
            assert np.array_equal(r0[k], r1[k]), k
