"""The port's ``config.merge_parallel_flags`` against the JAX package's
(dfc_sa_unet_tpu/config.py:29-59) on a table of flags x YAML sections: the tri-state flags
(None = not given, so the YAML fills; True / False win both ways), ``spatial_parallel``'s fill,
the ``sections`` search in order, and the ``bf16`` fill where the parser has the flag."""

import argparse
import itertools

import pytest

from dfc_sa_unet_tpu.config import merge_parallel_flags as jax_merge
from dfc_sa_unet_torch.config import merge_parallel_flags

YAMLS = [
    {},
    {"training": {"data_parallel": True, "multihost": True, "bf16": True, "spatial_parallel": 2}},
    {"training": {"data_parallel": False, "bf16": False}, "inference": {"data_parallel": True}},
    {"inference": {"multihost": True, "spatial_parallel": None, "bf16": True}},
    {"training": None, "inference": {"data_parallel": True, "spatial_parallel": 4}},
]
FLAGS = list(itertools.product([None, True, False], [None, False], [None, 1, 2], ["absent", None, True, False]))
SECTIONS = [("training",), ("inference",), ("inference", "training")]


@pytest.mark.parametrize("sections", SECTIONS, ids=["training", "inference", "inference+training"])
@pytest.mark.parametrize("yaml_index", range(len(YAMLS)))
def test_merge_parallel_flags_agrees_with_jax(yaml_index, sections):
    config = YAMLS[yaml_index]
    for dp, mh, sp, bf16 in FLAGS:
        kw = {"data_parallel": dp, "multihost": mh, "spatial_parallel": sp}
        if bf16 != "absent":
            kw["bf16"] = bf16
        got = vars(merge_parallel_flags(argparse.Namespace(**kw), config, sections=sections))
        want = vars(jax_merge(argparse.Namespace(**kw), config, sections=sections))
        assert got == want, (kw, config, sections)
