"""trainer.host_ms.train: ms a step in which the device did nothing, inside the benchmark's span
around Trainer.train_step (the step's span less the device's kernels and copies in it)."""

from portbench import readers


def read(run):
    return readers.host_ms(run)
