"""Tokens of every decode step of the window (B a step) over the
window's time (host clock)."""

LAYER = "end to end"
UNIT = "tokens/s"
MOVES = None


def read(run):
    return run.units / run.window_s
