"""Seconds from the process's start to the first timed step: imports,
the CUDA context, the kernel libraries, the weights drawn and the
warm-up of the cell's own shape."""


def read(run):
    return run["setup_s"]
