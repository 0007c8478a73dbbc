"""sam.mlp.device_ms.serve: device ms a request of the program's span `sam.mlp`, each encoder block's second
residual branch (its norm, lin1, GELU, lin2, the add): its records in `profiling.spans()`, one a block (12 a
request of SAM ViT-B), each timed between two CUDA events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "sam.mlp", run.config["model"]["depth"])
