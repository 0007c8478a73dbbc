"""The epilogue kernel's roofline arithmetic (roofline/lsa_epilogue.py) and its reader on a trace whose
numbers are known."""

from types import SimpleNamespace

import pytest
import torch

from portbench import core, peaks, readers
from portbench.roofline import lsa_epilogue
from portbench.trace import Trace


def test_work_of_a_launch():
    """a read and written once, o read once, in bf16; gamma; 10 operations an element."""
    assert lsa_epilogue.work(2, 14, 14, 1024, 8) == (4 * 2 * 14 * 14 * 1024 + 2 * 2 * 64 * 1024 + 4,
                                                     10 * 2 * 14 * 14 * 1024, 0)


def test_the_flagship_request():
    """Nine launches, one a block, from 224x224 x 64 to the bottleneck's 14x14 x 1024: 6.317e9 bytes
    at B=128 (6.268e9 of them a and the output), 1.886 ms at 3.35 TB/s, memory-bound at every level."""
    c = core.Cell("dfc_serve_b128")
    shapes = lsa_epilogue.launches(c.config, c.workload)
    assert len(shapes) == len(lsa_epilogue.LEVELS) == 9
    assert [(h, cc) for _, h, _, cc, _ in shapes] == [(224, 64), (112, 128), (56, 256), (28, 512), (14, 1024),
                                                       (28, 512), (56, 256), (112, 128), (224, 64)]
    assert sum(lsa_epilogue.work(*s)[0] for s in shapes) == 6_316_621_860
    assert 1e3 * sum(peaks.bound_s(*lsa_epilogue.work(*s)) for s in shapes) == pytest.approx(1.8856, abs=1e-4)
    for s in shapes:
        nbytes, ops, _ = lsa_epilogue.work(*s)
        assert nbytes / peaks.HBM_BYTES_PER_S > ops / peaks.BF16_FLOPS


class _Event:
    def __init__(self, name, start, end, cuda):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU


def test_reader_counts_its_launches():
    """The share is the nine launches' bound over their time, and silent unless the trace holds
    exactly nine a request (a parent without the kernel reads nothing)."""
    config = {"model": {"features": [8, 16, 24, 32], "pool_size": 4}}
    workload = {"traffic": {"batch": 2, "height": 32, "width": 32}}
    bound_us = 1e6 * sum(peaks.bound_s(*lsa_epilogue.work(*s)) for s in lsa_epilogue.launches(config, workload))
    ev = [_Event("portbench.unit", 0, 1000, False)]
    ev += [_Event("void (anonymous namespace)::lsa_epilogue_kernel<__nv_bfloat16, 8>(int)", 10 * i, 10 * i + 4, True)
           for i in range(9)]

    def run(events):
        tr = Trace(SimpleNamespace(events=lambda: events), {"lsa_epilogue_kernel"})
        return SimpleNamespace(trace=tr, device=torch.device("cuda"), config=config, workload=workload, window={})

    assert readers.roofline(run(ev), lsa_epilogue) == pytest.approx(100 * bound_us / 36)
    assert readers.roofline(run(ev[:-1]), lsa_epilogue) is None
    assert readers.roofline(run(ev[:1] + [_Event("sm90_xmma_gemm_bf16", 10, 20, True)]), lsa_epilogue) is None
