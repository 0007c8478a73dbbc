"""relpos_attention_roofline: the bound of SAM's pooled-attention launches with relative-position tables (one a
block, 12 a request: 4 global, 8 windowed) over their kernel time in the traced requests
(roofline/relpos_attention.py)."""

from portbench import readers
from portbench.roofline import relpos_attention


def read(run):
    return readers.roofline(run, relpos_attention)
