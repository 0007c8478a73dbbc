"""The readers of the program's own spans (``portbench/spans.py``) on a trace and records whose
numbers are known: the host's stall inside a span, the device time of a span a request, and None
where the spans do not match the traced units."""

from types import SimpleNamespace

import pytest
import torch

from portbench import spans
from portbench.trace import Trace
from dfc_sa_unet_torch.utils.profiling import SpanRecord


class _Event:
    def __init__(self, name, start, end, cuda=False, annotation=False):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        self.is_user_annotation = annotation


def _run(events, device="cuda"):
    tr = Trace(SimpleNamespace(events=lambda: events), set())
    return SimpleNamespace(trace=tr, device=torch.device(device))


def _two_units():
    """Two units of 100 us, each staging in (host 0-20, 100-130) and reading back (host 60-100,
    160-200).  First unit: a copy 2-18 inside the stage-in, kernels 20-70 and 80-90 (20 us of the
    read-back busy with kernels).  Second unit: a kernel 125-165 (5 us of the stage-in and 5 of the
    read-back), a copy 170-190.  The device's annotation of a span is no kernel."""
    return [_Event("portbench.unit", 0, 100), _Event("portbench.unit", 100, 200),
            _Event("dfc.predictor.request", 0, 100), _Event("dfc.predictor.request", 100, 200),
            _Event("dfc.predictor.stage_in", 0, 20), _Event("dfc.predictor.stage_in", 100, 130),
            _Event("dfc.predictor.read_back", 60, 100), _Event("dfc.predictor.read_back", 160, 200),
            _Event("dfc.predictor.read_back", 60, 100, cuda=True, annotation=True),
            _Event("Memcpy HtoD (Pageable -> Device)", 2, 18, cuda=True),
            _Event("sm90_xmma_gemm_bf16", 20, 70, cuda=True), _Event("elementwise_kernel", 80, 90, cuda=True),
            _Event("sm90_xmma_gemm_bf16", 125, 165, cuda=True),
            _Event("Memcpy DtoH (Device -> Pageable)", 170, 190, cuda=True)]


def test_stall_is_the_spans_host_time_less_its_kernels():
    run = _run(_two_units())
    assert spans.stall_ms(run, "predictor.stage_in") == pytest.approx((20 + (30 - 5)) / 2 / 1e3)
    assert spans.stall_ms(run, "predictor.read_back") == pytest.approx(((40 - 20) + (40 - 5)) / 2 / 1e3)


@pytest.mark.parametrize("change", ["missing", "doubled", "outside", "cpu", "untraced"])
def test_stall_reads_nothing_where_the_spans_do_not_match_the_units(change):
    events = _two_units()
    if change == "missing":
        events = [e for e in events if not (e.name == "dfc.predictor.stage_in" and e.time_range.start == 100)]
    elif change == "doubled":
        events.append(_Event("dfc.predictor.stage_in", 140, 150))
    elif change == "outside":
        events = [e for e in events if not (e.name == "dfc.predictor.stage_in" and e.time_range.start == 100)]
        events.append(_Event("dfc.predictor.stage_in", 300, 310))
    run = _run(events, "cpu" if change == "cpu" else "cuda")
    if change == "untraced":
        run.trace = None
    assert spans.stall_ms(run, "predictor.stage_in") is None


def test_a_program_without_the_spans_reads_nothing():
    events = [e for e in _two_units() if not e.name.startswith("dfc.")]
    assert spans.stall_ms(_run(events), "predictor.read_back") is None


def _records(requests, per_request, ms=1.5, skip=None):
    out = []
    for q in requests:
        out.append(SpanRecord("predictor.request", None, q, None))  # an untimed span
        for i in range(per_request):
            if (q, i) != skip:
                out.append(SpanRecord("engine.attn_branch", "predictor.forward", q, ms + i))
    return out


@pytest.mark.parametrize("case", ["sound", "extra_request", "one_missing", "untimed", "none"])
def test_device_ms_of_a_span_a_request(monkeypatch, case):
    """Two traced units: nine records a request of 1.5 .. 9.5 ms give 49.5 ms a request; a third
    request, a missing record, a record without device time or a program without spans give None."""
    records = {"sound": _records([7, 8], 9), "extra_request": _records([6, 7, 8], 9),
               "one_missing": _records([7, 8], 9, skip=(8, 4)),
               "untimed": _records([7, 8], 9)[:-1] + [SpanRecord("engine.attn_branch", "predictor.forward", 8, None)],
               "none": None}[case]
    monkeypatch.setattr(spans, "program_spans", lambda: records)
    got = spans.device_ms(_run(_two_units()), "engine.attn_branch", 9)
    if case == "sound":
        assert got == pytest.approx(sum(1.5 + i for i in range(9)))
    else:
        assert got is None


def test_device_ms_reads_the_programs_records():
    """Without a monkeypatch the reader reads the program's ring, which holds nothing here."""
    from dfc_sa_unet_torch.utils import profiling

    profiling.reset_spans()
    assert spans.program_spans() == []
    assert spans.device_ms(_run(_two_units()), "engine.attn_branch", 9) is None
