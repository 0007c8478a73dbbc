"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W limit).

Every roofline share and MFU of the benchmark divides by these.  The exponential rate is the
special-function units' (132 SMs, 16 exponentials an SM a clock) at the card's maximum SM clock.
"""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
SMS = 132
EXP_PER_SM_CLOCK = 16
MAX_SM_HZ = 1980e6
EXPS_PER_S = SMS * EXP_PER_SM_CLOCK * MAX_SM_HZ


def bound_s(nbytes: float, ops: float, exps: float = 0.0) -> float:
    """The least time a launch can take: the largest of its bytes over the memory bandwidth, its
    operations over the bf16 tensor-core rate and its exponentials over the special-function
    units' rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS, exps / EXPS_PER_S)
