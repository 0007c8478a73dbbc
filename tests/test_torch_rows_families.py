"""Row (spatial) sharding of the families banded after the DFC family, in serving: Gloo processes,
each on a band of every image's rows, against one process, and the modules' banded logits against
the JAX package's single-device forward (the port's counterparts of tests/test_parallel_fast.py:548
and 573).

One group of 2 processes runs every case for the file (``_torch_rows_worker.spawn``), one of 4 the
ViT-seg case: ViT-seg at tests/test_parallel_fast.py:548's size (32x32, patch 8, embed 32, 2 layers,
4 heads: its tokens gathered over the group, 1 token row a band in 4 bands), a small TransUNet
(64x64: its R50 stem banded, its 1/16 tokens gathered), UNet_FullResAttention (features
8/16/24/32, 32x32: the band's queries against the gathered keys) and the vanilla UNet with
``bilinear: true`` (32x32: the align-corners resize by global coordinates), each through the
Predictor with the mesh; the three f32 int8 engines (the flagship's ``Int8DFCEngine``, "auto"
levels, its s8 3x3 convs on the neighbours' s8 rows; ``Int8ViTEngine``; ``Int8TransUNetEngine``),
each calibrated on the same whole images in every process.  Probabilities within 1e-6 of one
process's, the modules' logits within 1e-5 of JAX's (atol and rtol, as
test_parallel_fast.py:291).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_rows_worker as worker
from _torch_port import jax_model_and_variables, jax_transunet, variables_from_port

torch.set_num_threads(2)
CASES = ["family", "int8", "int8_vit", "int8_transunet"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("rows_families")
    return worker.spawn(CASES + ["family_logits"], out)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return worker.spawn(["vit"], tmp_path_factory.mktemp("rows_families_4"), world=4, spatial=4)["vit"]


def _assert_equal_to_one_process(results, case):
    ref = worker.run_case(case, None)
    keys = [k for k in ref if k != "notes"]
    for rank, got in enumerate(results):
        assert keys and set(keys) == {k for k in got if k != "notes"}
        assert int(got["notes"]) == 0  # every height keeps the band rule: no fall-back
        for k in keys:
            assert got[k].shape == ref[k].shape, k
            assert np.isfinite(got[k]).all() and got[k].std() > 1e-3, k  # the outputs depend on the input
            np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=1e-6, err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("case", CASES)
def test_two_bands_serve_what_one_process_serves(group, case):
    _assert_equal_to_one_process(group[case], case)


def test_four_bands_of_one_token_row_serve_vit_seg_as_one_process(four):
    """tests/test_parallel_fast.py:548's mesh: 4 bands of 8 rows, one token row each."""
    assert len(four) == 4
    _assert_equal_to_one_process(four, "vit")


@pytest.mark.parametrize("family", list(worker.FAMILIES))
def test_banded_logits_match_the_jax_forward(group, family):
    """The module's logits from two bands, gathered, against the JAX module's single-device forward on
    the same weights and normalised images."""
    cfg, side = worker.FAMILIES[family]
    model = worker._seeded(cfg)
    if family == "transunet":
        jmodel = jax_transunet(worker.TRANSUNET, side)
        variables = variables_from_port(jmodel, model, (side, side))
    else:
        jmodel, variables = jax_model_and_variables(cfg, model, (side, side))
    x = jnp.asarray(worker.normalised(worker.images(side, 2)))
    want = np.asarray(jax.jit(lambda v, t: jmodel.apply(v, t, train=False))(variables, x)).transpose(0, 3, 1, 2)
    for rank, got in enumerate(group["family_logits"]):
        np.testing.assert_allclose(got[family], want, atol=1e-5, rtol=1e-5, err_msg=f"rank {rank}")
