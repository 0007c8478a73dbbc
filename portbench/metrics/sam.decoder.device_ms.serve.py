"""sam.decoder.device_ms.serve: device ms a request of the program's span `sam.decoder`, the neck, the prompt
encoder, the mask decoder and the resize of the logits: its records in `profiling.spans()`, one a request,
timed between two CUDA events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "sam.decoder", 1)
