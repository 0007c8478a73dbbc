"""lsa_epilogue_roofline: the bound of the pooled attention's epilogue kernel's nine launches a
request over their kernel time in the traced requests (roofline/lsa_epilogue.py)."""

from portbench import readers
from portbench.roofline import lsa_epilogue


def read(run):
    return readers.roofline(run, lsa_epilogue)
