"""predictor.read_back.stall_ms.serve: ms a request in which no kernel ran while the host was inside
the program's span `predictor.read_back`, the copy of the probabilities to the host
(`.cpu().numpy()`, which first waits for the forward): the span's host intervals in the device
trace less the kernels inside them (the device idle or copying both count as stall)."""

from portbench import spans


def read(run):
    return spans.stall_ms(run, "predictor.read_back")
