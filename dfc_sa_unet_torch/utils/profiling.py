"""Step telemetry, a profiler context and spans inside the program (counterpart of
dfc_sa_unet_tpu/utils/profiling.py).

* ``StepTimer`` - mean step duration and throughput, which the Trainer logs per epoch.
* ``trace`` - ``torch.profiler`` around a block, written as a Chrome trace.
* ``span`` - a named part of the serving path, recorded only while a ``torch.profiler`` session
  runs (``trace`` or any other): a ``dfc.<name>`` range in the profiler's trace and, for a timed
  span on a card, the device time between two CUDA events; ``spans()`` reads the finished records.
"""

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch


class StepTimer:
    """Mean step duration and throughput over the ticks of an epoch.  PyTorch
    returns before the device finishes, so with ``device`` a CUDA device each
    tick waits for it first; the trainer reads the loss every step anyway,
    which is such a wait already."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def reset(self):
        self._t_last: Optional[float] = None
        self.total_s = 0.0
        self.steps = 0
        self.items = 0

    def tick(self, items: int = 0):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._t_last is not None:
            self.total_s += now - self._t_last
            self.steps += 1
            self.items += items
        self._t_last = now

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.total_s / self.steps if self.steps else float("nan")

    @property
    def items_per_sec(self) -> float:
        return self.items / self.total_s if self.total_s > 0 else float("nan")

    def summary(self) -> str:
        return f"{self.ms_per_step:.1f} ms/step, {self.items_per_sec:.1f} img/s"


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``with trace('/tmp/prof'):`` profiles the enclosed block with ``torch.profiler`` (CPU
    activity, and CUDA activity when a card is present) and writes a Chrome trace into ``log_dir``;
    a falsy ``log_dir`` profiles nothing.  Where the JAX version prints and goes on when its
    profiler is unavailable, this one raises."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")  # TensorBoard's naming
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


SPAN_PREFIX = "dfc."  # the profiler's name of span ``name`` is ``SPAN_PREFIX + name``
RING_SIZE = 4096  # finished spans kept; older ones are dropped, so a long session cannot grow memory

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_ring: "collections.deque" = collections.deque(maxlen=RING_SIZE)
_open = threading.local()  # .stack: this thread's open spans, outermost first
_requests = itertools.count()


class SpanRecord(NamedTuple):
    """A finished span: its name, the name of the span it ran in (None for an outermost one), the
    number of its outermost span (one a request, counted in the process), and the device ms
    between its two CUDA events (None for an untimed span, or where no CUDA context was in use)."""

    name: str
    parent: Optional[str]
    request: int
    device_ms: Optional[float]


class _Span:
    __slots__ = ("name", "timed", "parent", "request", "_range", "_start")

    def __init__(self, name: str, timed: bool):
        self.name, self.timed = name, timed
        self._range = torch.profiler.record_function(SPAN_PREFIX + name)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            self.parent, self.request = stack[-1].name, stack[0].request
        else:
            self.parent, self.request = None, next(_requests)
        stack.append(self)
        self._range.__enter__()
        self._start = None
        if self.timed and torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc):
        end = None
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self._range.__exit__(*exc)
        _open.stack.pop()
        _ring.append((self.name, self.parent, self.request, self._start, end))
        return False


def span(name: str, timed: bool = False):
    """``with span("engine.between", timed=True):`` marks a part of the program.  With no profiler
    running this is one shared context that does nothing; under a profiler it is a
    ``record_function`` range named ``dfc.<name>`` and a record for ``spans()``.  A ``timed`` span
    also records two CUDA events on the current stream where a CUDA context is in use (most of a
    span's host cost under the profiler, so only the spans whose device ms something reads are
    timed).
    It changes no tensor and no control flow."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, timed)


def spans() -> list:
    """The finished spans still in the ring, oldest first, as ``SpanRecord``s (one synchronise of
    the card first, where any span recorded CUDA events)."""
    records = list(_ring)
    if any(start is not None for *_, start, _ in records):
        torch.cuda.synchronize()
    return [SpanRecord(name, parent, request, None if start is None else start.elapsed_time(end))
            for name, parent, request, start, end in records]


def reset_spans() -> None:
    """Drop every finished span."""
    _ring.clear()
