"""engine.local_tail.device_ms.serve: device ms a request of the program's span `engine.local_tail`,
the rest of each of the nine blocks (the tail kernel at its seven levels; the conv3x3 kernel and
the tail as torch ops at the other two): its nine records a request in `profiling.spans()`, each
timed between two CUDA events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "engine.local_tail", 9)
