"""Row (spatial) sharding in the port's serving: 2 Gloo processes, each on a band of every image's
rows, against one process, and the flagship's banded forward against the JAX package's forward on
``serving_mesh(spatial=2)`` (the port's counterparts of tests/test_parallel_fast.py:249, 272, 291,
and 573).

The group runs once for the file (``_torch_rows_worker.spawn``): the flagship module (features
8/16/24/32, pool 2, f32, 32x32: one pool window in each band, one row a band at the bottleneck)
and its f32 ``DFCEngine`` with the tail and conv3x3 kernels' levels "auto", both through the
Predictor with the mesh; each of the DFC family's nine models; a 48-row height that breaks the
band rule (16 S = 32), which runs whole on every rank with JAX's note once; the flagship's
logits.  Probabilities within 1e-6 of one process's, the logits within 1e-5 of
JAX's (atol and rtol, as test_parallel_fast.py:291).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_rows_worker as worker
from _torch_port import jax_model_and_variables
from dfc_sa_unet_tpu.parallel import serving_mesh as jax_serving_mesh
from dfc_sa_unet_torch.parallel.mesh import serving_mesh

torch.set_num_threads(2)
CASES = ["module", "engine", "zoo", "fallback"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("rows_serving")
    return worker.spawn(CASES + ["logits"], out)


@pytest.mark.parametrize("case", CASES)
def test_two_bands_serve_what_one_process_serves(group, case):
    ref = worker.run_case(case, None)
    for rank, got in enumerate(group[case]):
        keys = [k for k in ref if k != "notes"]
        assert keys and set(keys) == {k for k in got if k != "notes"}
        for k in keys:
            assert got[k].shape == ref[k].shape, k
            assert np.isfinite(got[k]).all() and got[k].std() > 1e-3, k  # the outputs depend on the input
            np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=1e-6, err_msg=f"rank {rank} {k}")
    # the fallback's note, once, from the primary; the others print none
    notes = [int(r["notes"]) for r in group[case]]
    assert notes == ([1, 0] if case == "fallback" else [0, 0]), notes


def test_banded_flagship_forward_matches_the_jax_spatial_mesh(group):
    """The flagship's logits from two bands against JAX's forward with its rows sharded over two CPU
    devices (GSPMD's halo exchanges), on the same weights and normalised images."""
    model = worker._seeded(worker.FLAGSHIP)
    jmodel, variables = jax_model_and_variables(worker.FLAGSHIP, model, (worker.SIDE, worker.SIDE))
    x = jnp.asarray(worker.normalised(worker.images()))
    fn = jax.jit(lambda v, t: jmodel.apply(v, t, train=False))
    mesh = jax_serving_mesh(spatial=2, num_devices=2)
    got_jax = fn(jax.device_put(variables, NamedSharding(mesh, P())),
                 jax.device_put(x, NamedSharding(mesh, P("data", "spatial"))))
    assert len(got_jax.sharding.device_set) == 2
    want = np.asarray(got_jax)[..., 0]
    for rank, got in enumerate(group["logits"]):
        np.testing.assert_allclose(got["logits"], want, atol=1e-5, rtol=1e-5, err_msg=f"rank {rank}")


def test_serving_mesh_validates_the_spatial_axis():
    """A spatial axis that does not divide the processes raises JAX's ValueError (tests/
    test_parallel_fast.py:322); the 2-D layout over 2 processes is tests/test_torch_trainer.py's."""
    with pytest.raises(ValueError, match="must divide the device count 1"):
        serving_mesh(spatial=2, device="cpu")  # one process
    with pytest.raises(ValueError, match="at least 1"):
        serving_mesh(spatial=0, device="cpu")
    assert serving_mesh(spatial=1, device="cpu").spatial == 1
