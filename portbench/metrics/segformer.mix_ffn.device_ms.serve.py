"""segformer.mix_ffn.device_ms.serve: device ms a request of the program's span `segformer.mix_ffn`,
each block's Mix-FFN branch (its norm, fc1, the depthwise conv, GELU, fc2, the add): its records in
`profiling.spans()`, one a block, each timed between two CUDA events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "segformer.mix_ffn", sum(run.config["model"]["depths"]))
