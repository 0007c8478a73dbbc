"""mfu.serve: the window's served images times the configuration's FLOPs a forward, over the
window's time, as a share of the bf16 tensor-core peak (989 TFLOP/s)."""

from portbench import readers


def read(run):
    return readers.mfu(run, 1)
