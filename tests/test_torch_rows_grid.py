"""Row (spatial) sharding on a 2-D grid: 4 Gloo processes as data 2 x spatial 2 (rank d * 2 + s),
each data index on its chunk of the batch and each rank on a band of its rows, against the JAX
package and against one process.

One group for the file (``_torch_dp_worker.spawn(..., world=4, spatial=2)``), 8 images of 32x32
a batch (4 a data index, 16 rows a band), then the padded validation (5 samples over 2 data
indices: the second chunk holds a padding row):
- the conv + BatchNorm + conv mini-net, one bce_dice step against the JAX Trainer's step on a
  2 x 2 ('data', 'spatial') mesh of 4 CPU devices (tests/test_parallel_fast.py:331);
- the flagship (features 8/16/24/32, pool 2), one bce_dice step against JAX's single-device step;
- the mini-net at a 24-row height that breaks the band rule: the batch shards on the data axis
  only, every collective over the data group, with one warning.
Every case also against one process.  Limits of tests/test_parallel_fast.py:89-93: loss atol 1e-5 /
rtol 1e-5, parameters, BatchNorm statistics and metrics atol 1e-5 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import _torch_dp_worker as worker
from _torch_port import assert_row_step, jax_row_step
from dfc_sa_unet_tpu.parallel import serving_mesh as jax_serving_mesh

torch.set_num_threads(2)
CASES = ["rows_mini_bce_dice", "rows_grid_flagship", "rows_fallback"]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rows_grid")
    mesh = jax_serving_mesh(spatial=2, num_devices=4)
    want = {"mini 2x2": jax_row_step(worker, "rows_mini_bce_dice", str(tmp / "jax_mini"), mesh),
            "flagship 1": jax_row_step(worker, "rows_grid_flagship", str(tmp / "jax_flagship_1"), None)}
    inputs = {"rows_mini_bce_dice": want["mini 2x2"][1], "rows_grid_flagship": want["flagship 1"][1]}
    torch.save(inputs, tmp / "inputs.pt")
    results = worker.spawn(CASES, tmp, world=4, inputs=tmp / "inputs.pt", spatial=2)
    return {k: v[0] for k, v in want.items()}, inputs, results, tmp


def test_mini_net_on_data_2_by_spatial_2_matches_the_jax_2x2_mesh(grid):
    want, _, results, _ = grid
    for rank, got in enumerate(results["rows_mini_bce_dice"]):
        assert_row_step(got, want["mini 2x2"], label=f"rank {rank}")


def test_flagship_on_data_2_by_spatial_2_matches_jax(grid):
    want, _, results, _ = grid
    for rank, got in enumerate(results["rows_grid_flagship"]):
        assert_row_step(got, want["flagship 1"], label=f"rank {rank}, JAX on one device")


@pytest.mark.parametrize("case", CASES)
def test_data_2_by_spatial_2_equals_one_process(grid, case):
    _, inputs, results, tmp = grid
    ref = worker.run_case(case, None, str(tmp / f"single_{case}"), *inputs.get(case, (None, None)))
    for rank, got in enumerate(results[case]):
        np.testing.assert_allclose(got["train"][0], ref["train"][0], atol=1e-5, rtol=1e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["val"], ref["val"], atol=1e-5, rtol=1e-4, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["val_dice"], ref["val_dice"], atol=1e-5, rtol=1e-4, err_msg=f"rank {rank}")
        for k in (k for k in ref if k.startswith("sd/")):
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4, err_msg=f"rank {rank} {k}")
    warned = [int(r["spatial_warnings"]) for r in results[case]]
    assert warned == ([1, 0, 0, 0] if case == "rows_fallback" else [0, 0, 0, 0]), warned
