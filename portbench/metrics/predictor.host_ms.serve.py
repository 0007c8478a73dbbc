"""predictor.host_ms.serve: ms a request in which the device did nothing, inside the benchmark's
span around Predictor.predict_probs (the request's span less the device's kernels and copies in it)."""

from portbench import readers


def read(run):
    return readers.host_ms(run)
