"""The device trace of a run's traced segment, read from ``torch.profiler`` in process.

``Trace`` holds the segment's units (one request or one step each: the host interval of the
benchmark's own span around the call), the device's kernels and copies with their times, and the
host's operations, all in microseconds on the profiler's clock.  Per-layer metrics read it through
its helpers; nothing is written to disk.

The port's own kernels are told from the libraries' by name: the names of the ``__global__``
functions in the program's CUDA sources (and of any ``@triton.jit`` function in its Python), read
from the program's checkout when the trace is parsed.
"""

import re
from pathlib import Path

import torch

UNIT_SPAN = "portbench.unit"
_SPAN_PREFIX = "portbench."


def port_kernel_names(package_dir: Path) -> set:
    """The kernel function names of the program at ``package_dir``."""
    names = set()
    for src in sorted(package_dir.rglob("*.cu")) + sorted(package_dir.rglob("*.cuh")):
        text = src.read_text(encoding="utf-8", errors="replace")
        for m in re.finditer(r"__global__", text):
            rest = re.sub(r"^\s*void\s+", "", text[m.end():m.end() + 600])
            if rest.startswith("__launch_bounds__"):
                rest = _skip_parens(rest[len("__launch_bounds__"):].lstrip())
            name = re.match(r"\s*(?:void\s+)?(\w+)\s*\(", rest)
            if name:
                names.add(name.group(1))
    for src in sorted(package_dir.rglob("*.py")):
        names.update(re.findall(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)", src.read_text(encoding="utf-8")))
    return names


def _skip_parens(text: str) -> str:
    """``text`` after a leading balanced ``( ... )`` (the launch bounds), else as it is."""
    if not text.startswith("("):
        return text
    depth = 0
    for i, ch in enumerate(text):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0:
            return text[i + 1:]
    return text


def profiler():
    """A profiler of host operations and, where a card is present, device activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=acts)


def union(intervals) -> list:
    """The union of [start, end) intervals, merged and sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clipped_length(intervals, lo, hi) -> float:
    """The length of the union of ``intervals`` inside [lo, hi)."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


class Trace:
    def __init__(self, prof, port_kernels: set):
        self.units, self.kernels, self.copies, self.host = [], [], [], []
        for ev in prof.events():
            start, end = float(ev.time_range.start), float(ev.time_range.end)
            name = ev.name
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if name.startswith(_SPAN_PREFIX) or getattr(ev, "is_user_annotation", False):
                    continue
                kind = self.copies if name.startswith(("Memcpy", "Memset")) else self.kernels
                kind.append((name, start, end))
            elif name == UNIT_SPAN:
                self.units.append((start, end))
            else:
                self.host.append((name, start, end))
        self.units.sort()
        self.port_kernels = port_kernels

    @property
    def window(self):
        """(start, end) of the traced segment: the first unit's start to the last unit's end."""
        return self.units[0][0], self.units[-1][1]

    @staticmethod
    def base_name(name: str) -> str:
        """A kernel's function name without return type, namespace, template or arguments."""
        base = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
        return re.split(r"[<(]", base, maxsplit=1)[0].split("::")[-1].strip()

    def is_port_kernel(self, name: str) -> bool:
        return self.base_name(name) in self.port_kernels

    def device_in_units(self, events) -> float:
        """Microseconds of ``events`` (name, start, end) inside the units, their overlaps counted once."""
        spans = [(s, e) for _, s, e in events]
        return sum(clipped_length(spans, lo, hi) for lo, hi in self.units)

    def busy_us(self) -> float:
        """Microseconds of the window in which a kernel or a copy ran on the device."""
        lo, hi = self.window
        return clipped_length([(s, e) for _, s, e in self.kernels + self.copies], lo, hi)

    def breakdown(self, top=10) -> dict:
        """The device operations that took most time and the longest idle gaps, the latter named by
        the innermost host operation under way when each began (seconds)."""
        lo, hi = self.window
        by_name = {}
        for name, s, e in self.kernels + self.copies:
            if s < hi and e > lo:
                by_name[name] = by_name.get(name, 0.0) + (min(e, hi) - max(s, lo)) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, t = [], lo
        for s, e in union([(s, e) for _, s, e in self.kernels + self.copies]):
            if e <= lo or s >= hi:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self._host_at(s), (e - s) * 1e-6] for s, e in gaps]}

    def _host_at(self, t: float) -> str:
        best = None
        for name, s, e in self.host:
            if s <= t < e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "(no host operation)"
