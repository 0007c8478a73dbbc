"""The benchmark's fixed arithmetic: each configuration's FLOPs a forward, the kernels' roofline
bounds, and the per-layer readers on a trace whose numbers are known."""

import json
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import core, peaks, readers
from portbench.roofline import dfc_tail, fused_mha_sep
from portbench.trace import Trace

CONFIGS = sorted((core.HERE / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_flops_constant_is_the_references_count(path):
    """``flops_per_image``: FlopCounterMode over the reference's forward of one image, on the meta
    device."""
    config = json.loads(path.read_text())
    ref = __import__(f"portbench.reference.{path.stem}", fromlist=["Model"])
    sd = {k: torch.empty(shape, device="meta") for k, (shape, _) in ref.state_spec(config).items()}
    h, w = config["dataset"]["img_size"]
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.Model(config, sd)(torch.empty(1, 3, h, w, device="meta"))
    assert counter.get_total_flops() == config["flops_per_image"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_parameter_count(path):
    config = json.loads(path.read_text())
    ref = __import__(f"portbench.reference.{path.stem}", fromlist=["state_spec"])
    spec = ref.state_spec(config)
    stats = ("running_mean", "running_var")
    n = sum(torch.Size(shape).numel() for k, (shape, _) in spec.items() if not k.endswith(stats))
    assert n == config["parameters"]


@pytest.mark.parametrize("cell,kernel,bound_ms", [("dfc_serve_b128", dfc_tail, 6.916),
                                                   ("transunet_serve_b128", fused_mha_sep, 0.552)])
def test_roofline_bound_of_a_request(cell, kernel, bound_ms):
    """At B=128 the tail's seven launches and the attention's twelve bound a request at the times
    chip_smoke.py's phase 7 gives (PERF.md, the kernel table)."""
    c = core.Cell(cell)
    shapes = kernel.launches(c.config, c.workload)
    assert len(shapes) == {dfc_tail: 7, fused_mha_sep: 12}[kernel]
    total_ms = 1e3 * sum(peaks.bound_s(*kernel.work(*s)) for s in shapes)
    assert total_ms == pytest.approx(bound_ms, abs=5e-4)


class _Event:
    def __init__(self, name, start, end, cuda):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU


def _run(events, config=None, workload=None, window=None):
    prof = SimpleNamespace(events=lambda: events)
    tr = Trace(prof, {"dfc_tail_wgmma_kernel"})
    return SimpleNamespace(trace=tr, device=torch.device("cuda"), config=config or {}, workload=workload or {},
                           window=window or {})


def test_readers_on_a_known_trace():
    """Two units of 100 us; kernels 10-40 (the program's) and 30-60 (a library's) in the first, a
    copy 120-130 and a kernel 150-170 in the second: busy 70 of 200 us."""
    ev = [_Event("portbench.unit", 0, 100, False), _Event("portbench.unit", 100, 200, False),
          _Event("void (anonymous namespace)::dfc_tail_wgmma_kernel<64>(int)", 10, 40, True),
          _Event("void at::native::vectorized_elementwise_kernel<4>(int)", 30, 60, True),
          _Event("Memcpy HtoD (Pageable -> Device)", 120, 130, True),
          _Event("sm90_xmma_gemm_bf16", 150, 170, True),
          _Event("aten::conv2d", 95, 160, False)]
    run = _run(ev)
    assert readers.device_ms(run) == pytest.approx((50 + 20) / 2 / 1e3)
    assert readers.device_ms(run, plain_only=True) == pytest.approx((30 + 20) / 2 / 1e3)
    assert readers.host_ms(run) == pytest.approx((200 - 80) / 2 / 1e3)
    assert readers.idle_pct(run) == pytest.approx(100 * (1 - 80 / 200))
    gaps = run.trace.breakdown()["idle_gaps"]  # longest first, each named by the host's operation under way
    assert [n for n, _ in gaps] == ["(no host operation)", "(no host operation)", "aten::conv2d", "(no host operation)"]
    assert [g for _, g in gaps] == pytest.approx([60e-6, 30e-6, 20e-6, 10e-6])


def test_roofline_reader_counts_its_launches():
    """The share is the launches' bound over their time, and silent unless the trace holds exactly
    the launches the shapes say."""
    config = {"model": {"features": [8, 16, 24, 32]}}
    workload = {"traffic": {"batch": 2, "height": 32, "width": 32}}
    bound_us = 1e6 * sum(peaks.bound_s(*dfc_tail.work(*s)) for s in dfc_tail.launches(config, workload))
    ev = [_Event("portbench.unit", 0, 1000, False)]
    ev += [_Event("void dfc_tail_wgmma_kernel<8>(int)", 10 * i, 10 * i + 5, True) for i in range(7)]
    run = _run(ev, config, workload)
    assert readers.roofline(run, dfc_tail) == pytest.approx(100 * bound_us / 35)
    run = _run(ev[:-1], config, workload)
    assert readers.roofline(run, dfc_tail) is None


def test_readers_give_nothing_without_a_card():
    run = _run([_Event("portbench.unit", 0, 100, False)])
    run.device = torch.device("cpu")
    assert readers.host_ms(run) is None and readers.device_ms(run) is None and readers.idle_pct(run) is None
    assert readers.mfu(run, 1) is None
