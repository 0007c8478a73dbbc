"""dfc_tail_roofline: the bound of the DFC tail kernel's seven launches a request over their kernel
time in the traced requests (roofline/dfc_tail.py)."""

from portbench import readers
from portbench.roofline import dfc_tail


def read(run):
    return readers.roofline(run, dfc_tail)
