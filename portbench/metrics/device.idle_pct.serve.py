"""device.idle_pct.serve: the share of the traced requests' window in which no kernel or copy ran."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
