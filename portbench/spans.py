"""The arithmetic of the readers of the program's own spans (``utils/profiling.py::span`` of the
program): the host's stall inside a span, from the device trace, and the device time of a span,
from the program's records (``profiling.spans()``).

A span ``name`` is the profiler's host range ``dfc.<name>`` and a record with the number of its
request.  A reader returns None unless the run was traced on a card and the spans match the traced
units: each unit holds the expected count of the span, and the records make exactly as many
requests as there are units.  A program without the spans (one that predates them) reads None.
"""

from collections import Counter

from portbench.readers import _units
from portbench.trace import clipped_length

HOST_PREFIX = "dfc."


def stall_ms(run, name):
    """Per unit: ms in which no kernel ran while the host was inside span ``name`` (its host
    intervals less the union of the kernels inside them: the device idle or copying).  None unless
    every unit holds the span once."""
    n = _units(run)
    if n is None:
        return None
    tr = run.trace
    intervals = [(s, e) for host, s, e in tr.host if host == HOST_PREFIX + name]
    per_unit = Counter(i for s, _ in intervals for i, (lo, hi) in enumerate(tr.units) if lo <= s < hi)
    if len(intervals) != n or sorted(per_unit) != list(range(n)) or set(per_unit.values()) != {1}:
        return None
    kernels = [(s, e) for _, s, e in tr.kernels]
    stall_us = sum((e - s) - clipped_length(kernels, s, e) for s, e in intervals)
    return stall_us / n / 1e3


def program_spans():
    """The program's finished span records, or None where the program has no spans."""
    from dfc_sa_unet_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def device_ms(run, name, per_request):
    """Per request: device ms of the records of span ``name`` (between each one's CUDA events).
    None unless the records make as many requests as the traced units, each with ``per_request``
    records of the span, each timed on the card."""
    n = _units(run)
    if n is None:
        return None
    records = program_spans()
    if not records:
        return None
    requests = {r.request for r in records}
    mine = [r for r in records if r.name == name]
    counts = Counter(r.request for r in mine)
    if len(requests) != n or any(counts[q] != per_request for q in requests):
        return None
    if any(r.device_ms is None for r in mine):
        return None
    return sum(r.device_ms for r in mine) / n
