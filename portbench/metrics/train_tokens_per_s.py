"""Tokens of every whole training step of the window over the window's
time (host clock)."""

LAYER = "end to end"
UNIT = "tokens/s"
MOVES = None


def read(run):
    return run.units / run.window_s
