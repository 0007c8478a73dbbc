"""One run of one cell: set-up, the measured window, the traced segment, the check of the outputs,
and the result line.

A cell (``workloads/<cell>.json``) names its configuration (``configs/<config>.json``, with its
plain reference in ``reference/<config>.py``), its driver (``drivers/<driver>.py``), its traffic
and the limits of its checks.  The metrics a cell reports are those of ``BENCHMARK.json`` that
apply to it; a per-layer metric is read by ``metrics/<metric>.py``.  Every piece is found by its
name, so a new configuration, traffic mix or metric is a new file and a new entry.

A driver is a module with
    _model(run, sd, ...) -> model the program, from the seeded state dict ``sd`` (``plant.py`` puts the
                                  plain reference in its place for the control)
    setup(run) -> state           build the program, make its inputs from the seed, warm every shape
    window(run, state) -> dict    the measured window: {end-to-end metric: value}
    traced(run, state)            a fixed number of units (requests or steps) under the profiler
    release(run, state) -> dict   free the program's device state; keep what the check needs
    check(run, kept) -> list      [(name, value)]: readings against the plain reference; those the
                                  cell's ``limits`` name are compared, the others only printed
Set-up runs from the start of the process to the start of the window; its parts (``Run.part``) go
to standard error.  The control and the faults that the checks must catch are planted from outside
the run (``plant.py``).
"""

import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = HERE / "_build"
PROGRAM = "dfc_sa_unet_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "dfc_sa_unet_tpu")
_IMPORTED_AT = time.perf_counter()


def dtype(name: str):
    """A workload's ``program.dtype`` ("bfloat16" or "float32") as a torch dtype."""
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def host_copy(t):
    """A copy of tensor ``t`` on the host that nothing the program does later can change."""
    return t.detach().to("cpu", copy=True)


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside the checkout, so that only
    a cell's first run there builds (set before torch is imported)."""
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module was imported."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in file ``path`` (a metric's reader, whose name holds dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell's files, found by its name."""

    def __init__(self, name: str, workload: dict = None, config: dict = None):
        self.name = name
        self.benchmark = load_json(ROOT / "BENCHMARK.json")
        self.workload = workload or load_json(HERE / "workloads" / f"{name}.json")
        self.config = config or load_json(HERE / "configs" / f"{self.workload['config']}.json")
        self.reference = importlib.import_module(f"portbench.reference.{self.workload['config']}")
        self.driver = importlib.import_module(f"portbench.drivers.{self.workload['driver']}")

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.benchmark["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics read in this cell's traced runs."""
        moved = {m["name"] for m in self.end_to_end()}
        return [m for m in self.benchmark["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in moved else [])]


class Run:
    """What one run knows: its cell, seed, length and device, and what set-up, the window and the
    traced segment recorded, for the drivers and the metric readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds, self.tracing, self.device = cell, seed, seconds, trace, device
        self.config, self.workload, self.reference = cell.config, cell.workload, cell.reference
        self.setup_info = {}
        self.setup_parts = {}
        self.window = {}
        self.trace = None
        self.attempted = self.failed = 0

    def log(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)

    @contextlib.contextmanager
    def part(self, name: str):
        """A named part of set-up, its seconds (the device's work in it finished) in ``setup_parts``."""
        t0 = time.perf_counter()
        yield
        _synchronize(self.device)
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + time.perf_counter() - t0


def _synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _build_kernels(run: Run) -> None:
    """The program's CUDA kernels, built into (or loaded warm from) ``_build/nvcc``; the span is
    ``setup.build_s``."""
    from dfc_sa_unet_torch.ops import _build

    _build.set_build_dir(BUILD / "nvcc")
    if run.device.type == "cuda":
        t0 = time.perf_counter()
        with run.part("build"):
            _build.build()
        run.setup_info["build_s"] = time.perf_counter() - t0


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process (by whole top-level name)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    import torch

    run = Run(cell, seed, seconds, trace, device)
    driver = cell.driver
    started = process_age_s()
    with contextlib.redirect_stdout(sys.stderr):  # the program's prints stay off the result's stream
        with run.part("device"):  # the CUDA context
            torch.empty(1, device=device)
        _build_kernels(run)
        state = driver.setup(run)
        _synchronize(device)
        setup_s = process_age_s()
        run.log("setup parts: " + " ".join(f"{k} {v!r}" for k, v in
                                           [("start", started), *run.setup_parts.items(), ("setup_s", setup_s)]))
        cuda = device.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        e2e = driver.window(run, state)
        if trace:
            from portbench.trace import Trace, port_kernel_names, profiler

            with profiler() as prof:
                driver.traced(run, state)
                _synchronize(device)
            run.trace = Trace(prof, port_kernel_names(ROOT / PROGRAM))
        peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if cuda else 0
        kept = driver.release(run, state)
        del state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        readings = driver.check(run, kept)
    limits = cell.workload["limits"]
    checks = [(n, v, limits[n]) for n, v in readings if n in limits]
    for n, v in readings:
        if n not in limits:
            run.log(f"reading {n} {v!r} (not compared)")
    e2e["setup_s"] = setup_s
    run.log("end-to-end " + " ".join(f"{k} {v!r}" for k, v in e2e.items()))
    metrics = {}
    if trace:
        for m in cell.per_layer():
            value = load_module(HERE / "metrics" / f"{m['name']}.py", "portbench_metric").read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    numbers_ok = all(math.isfinite(v["value"]) for v in metrics.values())
    correct = (numbers_ok and run.failed == 0 and all(math.isfinite(v) and v <= lim for _, v, lim in checks))
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(cell.workload.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit"] = _power_limit()
    result = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
              "device": dev}
    if trace and run.trace is not None and run.trace.units:
        lo, hi = run.trace.window
        dev["busy_s"] = run.trace.busy_us() * 1e-6
        dev["window_s"] = (hi - lo) * 1e-6
        result["breakdown"] = run.trace.breakdown()
    result["readings"] = dict(readings)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them, or "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def print_checks(result: dict) -> None:
    """Each compared number beside its limit, as the last lines of standard error."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
