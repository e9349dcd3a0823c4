"""Seconds from the process's start to the first timed call: imports,
weights drawn on the device, inputs, the kernels' loading or build, and
one warm call of the window's shape."""

LAYER = "end to end"
UNIT = "s"
MOVES = None


def read(run):
    return run.setup_s
