"""Set-up: seconds from the process's start to the window's: imports and
the CUDA context, the cell's streams and weights, the warm-up job (and,
in a checkout's first run, the port's nvcc and g++ builds)."""


def read(run):
    return run["setup_s"]
