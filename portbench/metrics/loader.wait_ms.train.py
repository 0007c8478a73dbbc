"""loader.wait_ms.train: ms a step the Trainer waited in next() on the loader (the benchmark's span
around each next() of the loader it hands the Trainer), over the measured window."""


def read(run):
    w = run.window
    return 1e3 * w["wait_s"] / w["units"] if w.get("units") else None
