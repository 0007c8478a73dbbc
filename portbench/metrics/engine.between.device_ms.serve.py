"""engine.between.device_ms.serve: device ms a request of the program's span `engine.between`, what
lies between the blocks (the four max pools, the four conv-transposes with their resize and concat,
the final conv): its nine records a request in `profiling.spans()`, each timed between two CUDA
events."""

from portbench import spans


def read(run):
    return spans.device_ms(run, "engine.between", 9)
