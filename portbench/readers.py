"""The arithmetic the per-layer metric readers share.  A reader returns None where its run has
nothing to read: no traced segment, no card (a CPU run gives no device number), or no launch of
its kernel in the shape it expects."""

from portbench import peaks


def _units(run):
    tr = run.trace
    return None if tr is None or not tr.units or run.device.type != "cuda" or not tr.kernels else len(tr.units)


def host_ms(run):
    """Per unit: the benchmark's span around the call less the device's activity inside it."""
    n = _units(run)
    if n is None:
        return None
    tr = run.trace
    total = sum(e - s for s, e in tr.units)
    return (total - tr.device_in_units(tr.kernels + tr.copies)) / n / 1e3


def device_ms(run, plain_only=False):
    """Per unit: device kernel time inside the units (copies left out); ``plain_only``: the kernels
    that are not the program's own."""
    n = _units(run)
    if n is None:
        return None
    tr = run.trace
    kernels = [k for k in tr.kernels if not (plain_only and tr.is_port_kernel(k[0]))]
    return tr.device_in_units(kernels) / n / 1e3


def idle_pct(run):
    """The share of the traced window in which nothing ran on the device."""
    if _units(run) is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - run.trace.busy_us() / (hi - lo))


def mfu(run, passes: int):
    """The window's work (``passes`` x the configuration's FLOPs a forward, a training step being
    3) over its time, as a share of the bf16 tensor-core peak."""
    w = run.window
    if run.device.type != "cuda" or not w.get("seconds"):
        return None
    return 100.0 * passes * run.config["flops_per_image"] * w["images"] / w["seconds"] / peaks.BF16_FLOPS


def roofline(run, kernel):
    """A kernel's share of its roofline: the bound of its launches inside the traced units
    (``kernel.launches``, from the cell's shapes) over their kernel time.  None unless the trace
    holds exactly the launches the shapes say."""
    n = _units(run)
    if n is None:
        return None
    tr = run.trace
    shapes = kernel.launches(run.config, run.workload)
    events = [(s, e) for name, s, e in tr.kernels
              if tr.base_name(name) in kernel.KERNELS and any(lo <= s < hi for lo, hi in tr.units)]
    if not shapes or len(events) != len(shapes) * n:
        return None
    bound_s = n * sum(peaks.bound_s(*kernel.work(*shape)) for shape in shapes)
    return 100.0 * bound_s / (sum(e - s for s, e in events) * 1e-6)
