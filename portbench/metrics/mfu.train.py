"""mfu.train: the window's trained images times 3 x the configuration's FLOPs a forward (forward
and backward), over the window's time, as a share of the bf16 tensor-core peak (989 TFLOP/s)."""

from portbench import readers


def read(run):
    return readers.mfu(run, 3)
