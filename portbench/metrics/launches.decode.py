"""Device launches (kernels, copies, fills) a decode step in the trace:
the host's work a step."""

LAYER = "decode cache"
UNIT = "launches"
MOVES = "decode_gap_p95_ms"


def read(run):
    if run.trace is None:
        return None
    return run.trace.count() / run.trace.calls
