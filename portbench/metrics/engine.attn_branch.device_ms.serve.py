"""engine.attn_branch.device_ms.serve: device ms a request of the program's span `engine.attn_branch`,
the attention branch of each of the nine blocks (1x1 conv, pool, attention, upsample, the gamma
island): its nine records a request in `profiling.spans()`, each timed between two CUDA events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "engine.attn_branch", 9)
