"""step.device_ms.train: device kernel time a step (forward, backward, clip and update; copies left
out)."""

from portbench import readers


def read(run):
    return readers.device_ms(run)
