"""segformer.attention.device_ms.serve: device ms a request of the program's span
`segformer.attention`, each block's first residual branch (its norm, the reduction conv and norm, q
and kv, the attention kernel, the projection, the add): its records in `profiling.spans()`, one a
block, each timed between two CUDA events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "segformer.attention", sum(run.config["model"]["depths"]))
