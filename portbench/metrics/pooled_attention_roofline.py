"""pooled_attention_roofline: the bound of SegFormer's pooled-attention launches (one a block, 52 a
request of SegFormer-B5) over their kernel time in the traced requests (roofline/pooled_attention.py)."""

from portbench import readers
from portbench.roofline import pooled_attention


def read(run):
    return readers.roofline(run, pooled_attention)
