"""The SAM cell (``sam_serve_b16_1024``) on the CPU: a tiny cut of it served through ``serve_closed``
against the configuration's plain reference (correct when sound; caught with a flipped tile and with the
relative-position tables dropped from the program), the relative-position roofline's work against a count
by hand, and its five per-layer readers silent on a program without the spans and launches they read (a
parent that lacks them)."""

import copy
from types import SimpleNamespace

import pytest
import torch

from portbench import core, peaks, readers, spans
from portbench.plant import planted
from portbench.roofline import relpos_attention
from portbench.trace import Trace
from dfc_sa_unet_torch.utils.profiling import SpanRecord

NAME = "sam_serve_b16_1024"
METRICS = ("sam.window_attention.device_ms.serve", "sam.global_attention.device_ms.serve",
           "sam.mlp.device_ms.serve", "sam.decoder.device_ms.serve", "relpos_attention_roofline")
TINY = {"img_size": 128, "embed_dim": 64, "depth": 4, "num_heads": 2, "global_attn_indexes": [1, 3],
        "window_size": 3, "out_chans": 32, "decoder_mlp_dim": 64, "iou_head_hidden_dim": 32, "box": [10, 20, 100, 90]}


def _tiny_cell():
    """The cell at the tiny width of tests/test_torch_sam.py (8x8 tokens, windows of 3 with padding), 2 tiles
    of 128x128 a request."""
    full = core.Cell(NAME)
    config, workload = copy.deepcopy(full.config), copy.deepcopy(full.workload)
    config["model"].update(TINY)
    workload["traffic"].update({"batch": 2, "height": 128, "width": 128, "pool_requests": 2, "warmup_requests": 1,
                                "traced_requests": 2, "sampled_requests": 2, "reference_block": 2})
    return core.Cell(NAME, workload=workload, config=config)


@pytest.fixture
def tables_dropped(monkeypatch):
    """The program with its relative-position tables dropped: every attention of the encoder launched
    without them (a fault the check must catch; plant.py has no such plant)."""
    from dfc_sa_unet_torch.models import sam

    real = sam.pooled_attention
    monkeypatch.setattr(sam, "pooled_attention", lambda q, k, v, heads, rel_h, rel_w: real(q, k, v, heads))


@pytest.mark.parametrize("plant", [None, "altered_answer"], ids=["sound", "tile_flipped"])
def test_tiny_cell_served_against_the_reference(plant):
    """A sound run is correct under the cell's own limits; a flipped tile in every answer is caught."""
    cell = _tiny_cell()
    with planted(plant):
        result = core.run_cell(cell, 2**31 + 11, 0.3, False, torch.device("cpu"))
    assert set(result["checks"]) == set(cell.workload["limits"])
    assert result["correct"] == (plant is None), result["checks"]
    assert {m["name"] for m in cell.per_layer()} >= set(METRICS)


def test_tiny_cell_without_the_tables_is_caught(tables_dropped):
    """The tables drawn at the reference's spread move the output past the cell's limit: a program that drops
    them is not correct."""
    result = core.run_cell(_tiny_cell(), 2**31 + 11, 0.3, False, torch.device("cpu"))
    assert not result["correct"], result["checks"]
    assert result["checks"]["image_tail_max"]["value"] > 2 * result["checks"]["image_tail_max"]["limit"]


def test_work_of_a_launch_by_hand():
    """A global launch at B=16: q, k, v and the output 4096 x 64 each in bf16 for 16 x 12 image heads, and
    two tables of 64 a query; 2 x 4096 x 4096 x (64 + 64) operations and 4096 x 4096 exponentials an image
    head.  A windowed one: 400 windows of 196 tokens, tables of 14."""
    nbytes, ops, exps = relpos_attention.work(16, 4096, 4096, 64, 64, 12, 64, 64)
    assert nbytes == 16 * 12 * 2 * (4 * 4096 * 64 + 4096 * 128) == 603_979_776
    assert ops == 16 * 12 * 2 * 4096 * 4096 * 128 and exps == 16 * 12 * 4096 * 4096
    nbytes, ops, exps = relpos_attention.work(400, 196, 196, 64, 64, 12, 14, 14)
    assert nbytes == 400 * 12 * 2 * (4 * 196 * 64 + 196 * 28) == 534_374_400
    assert ops == 400 * 12 * 2 * 196 * 196 * 128 and exps == 400 * 12 * 196 * 196


def test_the_cells_request():
    """12 launches in block order, global at blocks 2, 5, 8 and 11; bound by the operations of the global ones
    (0.834 ms each; their exponentials 0.770) and the bytes of the windowed ones (0.160 ms each): 4.61 ms."""
    c = core.Cell(NAME)
    shapes = relpos_attention.launches(c.config, c.workload)
    glob, win = (16, 4096, 4096, 64, 64, 12, 64, 64), (400, 196, 196, 64, 64, 12, 14, 14)
    assert shapes == [win, win, glob, win, win, glob, win, win, glob, win, win, glob]
    g_bytes, g_ops, g_exps = relpos_attention.work(*glob)
    assert peaks.bound_s(g_bytes, g_ops, g_exps) == g_ops / peaks.BF16_FLOPS > g_exps / peaks.EXPS_PER_S
    w_bytes = relpos_attention.work(*win)[0]
    assert peaks.bound_s(*relpos_attention.work(*win)) == w_bytes / peaks.HBM_BYTES_PER_S
    total_ms = 1e3 * sum(peaks.bound_s(*relpos_attention.work(*s)) for s in shapes)
    assert total_ms == pytest.approx(4 * 824_633_720_832 / 989e9 + 8 * 534_374_400 / 3.35e9) == pytest.approx(4.6113,
                                                                                                             abs=1e-4)


class _Event:
    def __init__(self, name, start, end, cuda=False):
        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU


def _run(kernel="sm90_xmma_gemm_bf16", per_unit=1):
    """Two traced units on a card, each holding ``per_unit`` launches of ``kernel``."""
    c = core.Cell(NAME)
    events = [_Event("portbench.unit", 0, 1000), _Event("portbench.unit", 1000, 2000)]
    for u in (0, 1000):
        events += [_Event(kernel, u + 10 * i, u + 10 * i + 5, cuda=True) for i in range(per_unit)]
    tr = Trace(SimpleNamespace(events=lambda: events),
               {"pooled_attention_relpos_kernel", "pooled_attention_wgmma_kernel"})
    return SimpleNamespace(trace=tr, device=torch.device("cuda"), config=c.config, workload=c.workload, window={})


@pytest.mark.parametrize("metric", METRICS)
def test_readers_are_silent_on_a_program_without_them(monkeypatch, metric):
    """No span records of the model (a parent's program has none) and no launch of the relpos kernel (a
    parent's attention launches have another name): each reader returns None and raises nothing; the
    roofline reads its launches where there are 12 a request."""
    records = [SpanRecord("predictor.request", None, q, None) for q in (7, 8)]
    monkeypatch.setattr(spans, "program_spans", lambda: records)
    reader = core.load_module(core.HERE / "metrics" / f"{metric}.py", "portbench_metric")
    assert reader.read(_run()) is None
    parent_kernel = "void (anonymous namespace)::wg::pooled_attention_wgmma_kernel<64, 64, 2, false, 128>(int)"
    assert reader.read(_run(parent_kernel, 12)) is None
    if metric == "relpos_attention_roofline":
        kernel = "void (anonymous namespace)::wg::pooled_attention_relpos_kernel<64, 64, 2, 128>(int)"
        c = core.Cell(NAME)
        bound_us = 1e6 * sum(peaks.bound_s(*relpos_attention.work(*s))
                             for s in relpos_attention.launches(c.config, c.workload))
        assert readers.roofline(_run(kernel, 12), relpos_attention) == pytest.approx(100 * bound_us / (12 * 5))
        assert readers.roofline(_run(kernel, 11), relpos_attention) is None


def test_span_readers_read_the_models_records(monkeypatch):
    """With the model's records of two requests (8, 4, 12 and 1 of the four spans each), each span reader
    gives its records' device ms a request."""
    counts = {"sam.window_attention": 8, "sam.global_attention": 4, "sam.mlp": 12, "sam.decoder": 1}
    records = [SpanRecord(name, None, q, 0.5) for q in (7, 8) for name, n in counts.items() for _ in range(n)]
    monkeypatch.setattr(spans, "program_spans", lambda: records)
    for name, n in counts.items():
        reader = core.load_module(core.HERE / "metrics" / f"{name}.device_ms.serve.py", "portbench_metric")
        assert reader.read(_run()) == pytest.approx(0.5 * n)
