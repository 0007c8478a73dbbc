"""sam.global_attention.device_ms.serve: device ms a request of the program's span `sam.global_attention`,
each global block's first residual branch (its norm, qkv, the tables, the attention kernel over the whole
map, proj, the add): its records in `profiling.spans()`, one a global block (4 a request of SAM ViT-B), each
timed between two CUDA events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "sam.global_attention", len(run.config["model"]["global_attn_indexes"]))
