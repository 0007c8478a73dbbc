"""sam.window_attention.device_ms.serve: device ms a request of the program's span `sam.window_attention`,
each windowed block's first residual branch (its norm, the pad and partition into 14x14 windows, qkv, the
tables, the attention kernel, proj, the unpartition and crop, the add): its records in
`profiling.spans()`, one a windowed block (8 a request of SAM ViT-B), each timed between two CUDA events."""

from portbench import spans


def read(run):
    m = run.config["model"]
    return spans.device_ms(run, "sam.window_attention", m["depth"] - len(m["global_attn_indexes"]))
