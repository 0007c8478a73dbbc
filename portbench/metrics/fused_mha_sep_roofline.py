"""fused_mha_sep_roofline: the bound of the attention kernel's twelve launches a request over their
kernel time in the traced requests (roofline/fused_mha_sep.py)."""

from portbench import readers
from portbench.roofline import fused_mha_sep


def read(run):
    return readers.roofline(run, fused_mha_sep)
