"""setup.build_s: seconds of the benchmark's span around its first call of the program's kernel
build (ops/_build.py::build): nvcc on a cold checkout, the hash of the sources on a warm one."""


def read(run):
    return run.setup_info.get("build_s")
