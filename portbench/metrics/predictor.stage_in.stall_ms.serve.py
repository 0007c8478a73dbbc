"""predictor.stage_in.stall_ms.serve: ms a request in which no kernel ran while the host was inside
the program's span `predictor.stage_in`, the copy of the request's uint8 tiles to the card
(`from_numpy` and the copy): the span's host intervals in the device trace less the kernels inside
them (the device idle or copying both count as stall)."""

from portbench import spans


def read(run):
    return spans.stall_ms(run, "predictor.stage_in")
