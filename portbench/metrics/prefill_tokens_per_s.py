"""Prompt tokens of every prefill of the window over the window's time
(the first call's start to the last call's end, host clock)."""

LAYER = "end to end"
UNIT = "tokens/s"
MOVES = None


def read(run):
    return run.units / run.window_s
