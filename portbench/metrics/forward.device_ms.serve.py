"""forward.device_ms.serve: device kernel time a request (copies left out), the whole forward and
the normalisation and sigmoid around it."""

from portbench import readers


def read(run):
    return readers.device_ms(run)
