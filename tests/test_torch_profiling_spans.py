"""The spans inside the port's serving path (``dfc_sa_unet_torch/utils/profiling.py::span``).

Off (no profiler running) a span is one shared context that records nothing.  Under a CPU
``torch.profiler`` session a tiny Predictor over a tiny DFCEngine, its int8 engine and a tiny
TransUNet module emits every span of a request with its parent and request number, and its outputs
are the same bits as with the profiler off.  No CUDA context is in use here, so no record has device
ms; with a stand-in for CUDA's events only the timed spans (the engine's) record them.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dfc_sa_unet_torch.infer.engine import DFCEngine
from dfc_sa_unet_torch.infer.predictor import Predictor
from dfc_sa_unet_torch.infer.quant import Int8DFCEngine
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.models.transunet import TransUNet
from dfc_sa_unet_torch.utils import profiling
from dfc_sa_unet_torch.utils.weights import init_random_

torch.set_num_threads(2)
DFC_SMALL = {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 4}
TRANSUNET_SMALL = {"patches_grid": (2, 2), "resnet_num_layers": (1, 1, 1), "resnet_width_factor": 1,
                   "hidden_size": 32, "mlp_dim": 64, "num_heads": 2, "num_layers": 2,
                   "attention_dropout_rate": 0.0, "dropout_rate": 0.0, "decoder_channels": (32, 16, 8, 8),
                   "skip_channels": [512, 256, 64, 16], "n_classes": 1, "n_skip": 3}
PREDICTOR_SPANS = {"predictor.request": None, "predictor.stage_in": "predictor.request",
                   "predictor.forward": "predictor.request", "predictor.read_back": "predictor.request"}


def _tiles(seed, n, size):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _dfc_engine():
    model = init_random_(create_model({"model": DFC_SMALL}, device="cpu"), torch.Generator().manual_seed(3)).eval()
    return DFCEngine({"model": DFC_SMALL}, model, dtype=torch.float32, device="cpu",
                     tail_kernel_levels="auto", conv_kernel_levels="auto")


def _int8_engine():
    """The tiny flagship with its "auto" int8 levels on placeholder scales (the same ops)."""
    model = init_random_(create_model({"model": DFC_SMALL}, device="cpu"), torch.Generator().manual_seed(3)).eval()
    engine = Int8DFCEngine({"model": DFC_SMALL}, model, dtype=torch.float32, device="cpu", act_scales="timing")
    assert engine.int8_levels == {"down4", "bottleneck", "up_conv4", "up_conv3"}
    return engine


def _transunet():
    model = TransUNet(TRANSUNET_SMALL, img_size=32, num_classes=1)
    return init_random_(model, torch.Generator().manual_seed(5)).eval()


def _profiled(predictor, batches):
    """The predictor's probabilities of ``batches`` under a CPU profiler, the records of their spans
    and the names of the profiler's host events."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = [predictor.predict_probs(b) for b in batches]
    records = profiling.spans()
    profiling.reset_spans()
    return out, records, [e.name for e in prof.events()]


def test_span_is_one_shared_noop_without_a_profiler():
    profiling.reset_spans()
    first, second = profiling.span("predictor.request"), profiling.span("engine.between")
    assert first is second
    with first:
        with second:
            pass
    Predictor(_dfc_engine(), device="cpu").predict_probs(_tiles(0, 2, 16))
    assert profiling.spans() == []


@pytest.mark.parametrize("family", ["dfc_engine", "int8_engine", "transunet"])
def test_a_request_emits_its_spans(family):
    """Each request: the Predictor's four spans, and inside ``predictor.forward`` the model's parts
    (9 each of the engine's three, its int8 levels included, or TransUNet's three once), all with the
    request's number; the same bits as with the profiler off."""
    if family in ("dfc_engine", "int8_engine"):
        model, size = _dfc_engine() if family == "dfc_engine" else _int8_engine(), 32
        parts = {"engine.attn_branch": 9, "engine.local_tail": 9, "engine.between": 9}
    else:
        model, size = _transunet(), 32
        parts = {"transunet.backbone": 1, "transunet.encoder": 1, "transunet.decoder": 1}
    predictor = Predictor(model, device="cpu")
    batches = [_tiles(1, 3, size), _tiles(2, 2, size)]
    plain = [predictor.predict_probs(b) for b in batches]
    traced, records, host_events = _profiled(predictor, batches)
    for want, got in zip(plain, traced):
        assert np.array_equal(want, got)

    requests = sorted({r.request for r in records})
    assert len(requests) == len(batches)
    for request in requests:
        mine = [r for r in records if r.request == request]
        assert Counter(r.name for r in mine) == Counter({**dict.fromkeys(PREDICTOR_SPANS, 1), **parts})
        for r in mine:
            assert r.parent == PREDICTOR_SPANS.get(r.name, "predictor.forward"), r
            assert r.device_ms is None  # no CUDA context on the CPU
    for name, count in {**dict.fromkeys(PREDICTOR_SPANS, 1), **parts}.items():
        assert host_events.count(profiling.SPAN_PREFIX + name) == count * len(batches), name


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: counts its records, and reads 2 ms after any start."""

    recorded = 0

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        _FakeEvent.recorded += 1

    def elapsed_time(self, end):
        assert isinstance(end, _FakeEvent)
        return 2.0


def test_only_timed_spans_record_cuda_events(monkeypatch):
    """With a CUDA context in use the engine's spans record two events each and read their device
    ms; the Predictor's record none and read None."""
    predictor = Predictor(_dfc_engine(), device="cpu")
    batch = _tiles(3, 2, 32)
    plain = predictor.predict_probs(batch)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _FakeEvent.recorded = 0
    traced, records, _ = _profiled(predictor, [batch])
    assert np.array_equal(plain, traced[0])
    assert _FakeEvent.recorded == 2 * 27
    for r in records:
        assert r.device_ms == (2.0 if r.name.startswith("engine.") else None), r
    assert sum(r.name.startswith("engine.") for r in records) == 27


def test_spans_nest_and_number_requests():
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            with profiling.span("inner"):
                with profiling.span("innermost"):
                    pass
        with pytest.raises(ValueError):
            with profiling.span("failing"):
                raise ValueError("an error inside a span")
        with profiling.span("after"):
            pass
    records = profiling.spans()
    profiling.reset_spans()
    assert [(r.name, r.parent) for r in records] == [("innermost", "inner"), ("inner", "outer"), ("outer", None),
                                                     ("failing", None), ("after", None)]
    first = records[0].request
    assert [r.request for r in records] == [first, first, first, first + 1, first + 2]


def test_the_ring_never_holds_more_than_its_size():
    profiling.reset_spans()
    extra = 10
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.RING_SIZE + extra):
            with profiling.span(f"s{i}"):
                pass
        assert len(profiling._ring) == profiling.RING_SIZE
    records = profiling.spans()
    profiling.reset_spans()
    assert len(records) == profiling.RING_SIZE
    assert records[0].name == f"s{extra}" and records[-1].name == f"s{profiling.RING_SIZE + extra - 1}"
    assert profiling.spans() == []
