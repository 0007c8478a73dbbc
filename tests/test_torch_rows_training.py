"""Row (spatial) sharding in the port's training: 2 Gloo processes, each on a band of every image's
rows, against one process on the same batches and against the JAX package's 2-D sharded step
(the port's counterparts of tests/test_parallel_fast.py:331, 362 and 386).

The group runs once for the file (``_torch_dp_worker.spawn(..., spatial=2)``: every case through
the Trainer's train_epoch and validate_epoch; 32x32 images, 16 rows a band).  Against one process:
the conv + BatchNorm + conv mini-net under each of the four losses (``joint``'s Laplacian contour
reads the halo rows of the probabilities and the targets), ``grad_accum`` 2 default and exact
(``joint`` exact too), a 24-row height that breaks the band rule (16 S = 32) and falls back to the
data axis with JAX's warning, the flagship (features 8/16/24/32, pool 2: one row a band at the
bottleneck, one pool window in each band) for two steps, exact, and rematerialised, and each of
the DFC family's other eight models for one step.  Against JAX (``Trainer`` over
``serving_mesh(spatial=2, num_devices=2)``, GSPMD's halos): the mini-net's single steps, the
accumulation steps and the fall-back height, from the same weights and batch.  Limits: loss atol
1e-5 / rtol 1e-5, parameters, BatchNorm statistics and the validation's metrics atol 1e-5 / rtol
1e-4 (tests/test_parallel_fast.py:89-93).  The 4-process case (data 2 x spatial 2) is
tests/test_torch_rows_grid.py's.
"""

import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from _torch_port import assert_row_step, jax_row_step
from dfc_sa_unet_tpu.parallel import serving_mesh as jax_serving_mesh

torch.set_num_threads(2)

ROW_CASES = [c for c in worker.CASES if c.startswith("rows_") and c != "rows_grid_flagship"]
JAX_CASES = ["rows_mini_bce_dice", "rows_mini_dice", "rows_mini_tversky", "rows_mini_joint", "rows_mini_accum2",
             "rows_mini_exact2", "rows_mini_joint_exact2", "rows_fallback"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (the JAX results or None, [the port's result on rank 0, rank 1])}: the JAX steps, then
    one group of 2 processes, one band each, that runs every case."""
    tmp = tmp_path_factory.mktemp("rows")
    jax_out, inputs = {}, {}
    for case in JAX_CASES:
        jax_out[case], inputs[case] = jax_row_step(worker, case, str(tmp / f"jax_logs_{case}"),
                                                   jax_serving_mesh(spatial=2, num_devices=2))
    torch.save(inputs, tmp / "inputs.pt")
    results = worker.spawn(ROW_CASES, tmp, inputs=tmp / "inputs.pt", spatial=2)
    return {case: (jax_out.get(case), results[case], inputs.get(case, (None, None))) for case in ROW_CASES}, tmp


def assert_state(got, want, label):
    keys = [k for k in want if k.startswith("sd/")]
    assert keys and set(keys) == {k for k in got if k.startswith("sd/")}
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=f"{label} {k}")


@pytest.mark.parametrize("case", ROW_CASES)
def test_two_bands_equal_one_process(runs, case):
    results, tmp = runs
    _, got_ranks, inputs = results[case]
    ref = worker.run_case(case, None, str(tmp / f"single_{case}"), *inputs)
    for rank, got in enumerate(got_ranks):
        np.testing.assert_allclose(got["train"][0], ref["train"][0], atol=1e-5, rtol=1e-5, err_msg="train loss")
        np.testing.assert_allclose(got["train"][1:], ref["train"][1:], atol=1e-5, rtol=1e-4, err_msg="train iou/dice")
        np.testing.assert_allclose(got["val"], ref["val"], atol=1e-5, rtol=1e-4, err_msg="val loss/iou/dice")
        assert list(got["val_names"]) == list(ref["val_names"]) and len(ref["val_names"]) == worker.VAL_SAMPLES
        np.testing.assert_allclose(got["val_dice"], ref["val_dice"], atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(got["val_iou"], ref["val_iou"], atol=1e-5, rtol=1e-4)
        assert_state(got, ref, f"rank {rank}")
    for k in got_ranks[0]:  # one update everywhere: the bands hold the same bits
        if k.startswith("sd/"):
            assert np.array_equal(got_ranks[0][k], got_ranks[1][k]), k


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_bands_match_the_jax_2d_sharded_step(runs, case):
    results, _ = runs
    want, got_ranks, _ = results[case]
    accum = worker.CASES[case][6].get("grad_accum", 1) if len(worker.CASES[case]) > 6 else 1
    for rank, got in enumerate(got_ranks):
        assert_row_step(got, want, accum, f"rank {rank}")


def test_a_height_that_breaks_the_band_rule_falls_back_with_one_warning(runs):
    """24 rows are not a multiple of 16 S = 32: the batch shards on the data axis only (a data axis of
    one process here, so every collective is off and both ranks run the whole step), the primary
    warns once in JAX's words (tests/test_parallel_fast.py:272, 362), and the result stays exact
    (the cases above)."""
    results, _ = runs
    r0, r1 = results["rows_fallback"][1]
    assert int(r0["spatial_warnings"]) == 1 and int(r1["spatial_warnings"]) == 0
    assert int(r0["seed"]) == int(r1["seed"])  # no collective: the single-process dropout seed
    for case in ("rows_mini_bce_dice", "rows_flagship"):
        assert all(int(r["spatial_warnings"]) == 0 for r in results[case][1]), case
