"""The SegFormer cell (``segformer_serve_b16_1024``) on the CPU: a tiny cut of it served through
``serve_closed`` against the configuration's plain reference, the pooled-attention roofline's work
against a count by hand, and its four per-layer readers silent on a program without the spans and
launches they read (a parent that lacks them)."""

import copy
from types import SimpleNamespace

import pytest
import torch

from portbench import core, peaks, readers, spans
from portbench.plant import planted
from portbench.roofline import pooled_attention
from portbench.trace import Trace
from dfc_sa_unet_torch.utils.profiling import SpanRecord

NAME = "segformer_serve_b16_1024"
METRICS = ("segformer.attention.device_ms.serve", "segformer.mix_ffn.device_ms.serve",
           "segformer.decoder.device_ms.serve", "pooled_attention_roofline")


def _tiny_cell():
    """The cell at the tiny width of tests/test_torch_segformer.py, 2 tiles of 64x96 a request."""
    full = core.Cell(NAME)
    config, workload = copy.deepcopy(full.config), copy.deepcopy(full.workload)
    config["model"].update({"embed_dims": [16, 32, 40, 64], "depths": [1, 1, 2, 1], "decoder_dim": 32})
    workload["traffic"].update({"batch": 2, "height": 64, "width": 96, "pool_requests": 2, "warmup_requests": 1,
                                "traced_requests": 2, "sampled_requests": 2, "reference_block": 2})
    return core.Cell(NAME, workload=workload, config=config)


@pytest.mark.parametrize("plant", [None, "altered_answer"], ids=["sound", "tile_flipped"])
def test_tiny_cell_served_against_the_reference(plant):
    """A sound run is correct under the cell's own limits; a flipped tile in every answer is caught.
    oneDNN is off: its CPU bf16 convolution at kernel 8, stride 8 is wrong on some maps
    (tests/test_torch_segformer.py)."""
    cell = _tiny_cell()
    with planted(plant), torch.backends.mkldnn.flags(enabled=False):
        result = core.run_cell(cell, 2**31 + 11, 0.3, False, torch.device("cpu"))
    assert set(result["checks"]) == set(cell.workload["limits"])
    assert result["correct"] == (plant is None), result["checks"]
    assert {m["name"] for m in cell.per_layer()} >= set(METRICS)


def test_work_of_a_launch_by_hand():
    """Stage 1 at B=16: q and the output 65536 x 64, k and v 1024 x 64 each, in bf16; 2 x 65536 x
    1024 x (64 + 64) operations and 65536 x 1024 exponentials an image."""
    nbytes, ops, exps = pooled_attention.work(16, 65536, 1024, 64, 64, 1)
    assert nbytes == 16 * 2 * (2 * 65536 * 64 + 2 * 1024 * 64) == 272_629_760
    assert ops == 16 * 2 * 65536 * 1024 * 128 and exps == 16 * 65536 * 1024
    assert pooled_attention.work(16, 1024, 1024, 64, 64, 8) == (16 * 8 * 2 * 4 * 1024 * 64,
                                                                16 * 8 * 2 * 1024 * 1024 * 128, 16 * 8 * 1024 * 1024)


def test_the_cells_request():
    """52 launches, one a block: 3 at 65536 queries (one head), 6 at 16384 (two), 40 at 4096 (five), 3 at
    1024 (eight), all against 1024 keys; 5.188 TFLOP and 2.03e10 exponentials, bound by the
    operations at 5.246 ms."""
    c = core.Cell(NAME)
    shapes = pooled_attention.launches(c.config, c.workload)
    assert [(s, shapes.count(s)) for s in dict.fromkeys(shapes)] == [
        ((16, 65536, 1024, 64, 64, 1), 3), ((16, 16384, 1024, 64, 64, 2), 6),
        ((16, 4096, 1024, 64, 64, 5), 40), ((16, 1024, 1024, 64, 64, 8), 3)]
    total = [sum(pooled_attention.work(*s)[i] for s in shapes) for i in range(3)]
    assert total == [6_069_157_888, 5_188_320_493_568, 20_266_876_928]
    assert 1e3 * sum(peaks.bound_s(*pooled_attention.work(*s)) for s in shapes) == pytest.approx(5.2460, abs=1e-4)


class _Event:
    def __init__(self, name, start, end, cuda=False):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU


def _run(kernel="sm90_xmma_gemm_bf16"):
    """Two traced units on a card, each holding one kernel (52 of ``kernel`` where it is the attention's)."""
    config, workload = core.Cell(NAME).config, core.Cell(NAME).workload
    events = [_Event("portbench.unit", 0, 1000), _Event("portbench.unit", 1000, 2000)]
    n = 52 if kernel.startswith("void (anonymous") else 1
    for u in (0, 1000):
        events += [_Event(kernel, u + 10 * i, u + 10 * i + 5, cuda=True) for i in range(n)]
    tr = Trace(SimpleNamespace(events=lambda: events), {"pooled_attention_wgmma_kernel"})
    return SimpleNamespace(trace=tr, device=torch.device("cuda"), config=config, workload=workload, window={})


@pytest.mark.parametrize("metric", METRICS)
def test_readers_are_silent_on_a_program_without_them(monkeypatch, metric):
    """No span records of the model (a parent's program has none) and no launch of the kernel: each
    reader returns None and raises nothing; the roofline reads its launches where there are 52 a request."""
    records = [SpanRecord("predictor.request", None, q, None) for q in (7, 8)]
    monkeypatch.setattr(spans, "program_spans", lambda: records)
    reader = core.load_module(core.HERE / "metrics" / f"{metric}.py", "portbench_metric")
    assert reader.read(_run()) is None
    if metric == "pooled_attention_roofline":
        kernel = "void (anonymous namespace)::wg::pooled_attention_wgmma_kernel<64, 64, 2, false, 128>(int)"
        c = core.Cell(NAME)
        bound_us = 1e6 * sum(peaks.bound_s(*pooled_attention.work(*s))
                             for s in pooled_attention.launches(c.config, c.workload))
        assert readers.roofline(_run(kernel), pooled_attention) == pytest.approx(100 * bound_us / (52 * 5))
