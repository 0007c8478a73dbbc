"""plain_ops.device_ms.serve: device time a request in kernels that are not the program's own
(cuDNN, cuBLAS, torch's elementwise kernels and casts)."""

from portbench import readers


def read(run):
    return readers.device_ms(run, plain_only=True)
