"""segformer.decoder.device_ms.serve: device ms a request of the program's span `segformer.decoder`,
the all-MLP head and the resize of the logits to the tile: its records in `profiling.spans()`, one a
request, each timed between two CUDA events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "segformer.decoder", 1)
