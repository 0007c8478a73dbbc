"""device.idle_pct.train: the share of the traced epoch's window (first step to last) in which no
kernel or copy ran."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
