"""BENCHMARK.json against the benchmark's rules, and every name in it found as a file."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell to compile, 1200 spare, at 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [e["why"] for e in BENCH["configs"] + BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        reported = [m for m in e2e.values() if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2 and "setup_s" in {m["name"] for m in reported}


def test_per_layer_metrics_have_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", [])) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_have_their_files(w):
    workload = json.loads((ROOT / "portbench" / "workloads" / f"{w['traffic']}.json").read_text())
    assert workload["config"] == w["config"] and workload["chips"] == w["chips"]
    assert (ROOT / "portbench" / "drivers" / f"{workload['driver']}.py").is_file()
    assert workload["limits"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_have_their_files(c):
    path = ROOT / c["file"]
    config = json.loads(path.read_text())
    assert path.parts[-3:-1] == ("portbench", "configs") and path.stem == c["name"]
    assert config["reduced"] == c["reduced"] and config["source"] == c["source"]
    assert (ROOT / "portbench" / "reference" / f"{c['name']}.py").is_file()
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_files_are_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts or "_build" in p.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(p.relative_to(ROOT))), p
