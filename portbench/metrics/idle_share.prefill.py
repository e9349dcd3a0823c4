"""The share of the traced window (the traced prefill calls' span on the
host's clock) in which no kernel ran: one less the union of the kernel
intervals over the window."""

LAYER = "device"
UNIT = "%"
MOVES = "prefill_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
