"""Device ms a decode step in the cat, stack and copy kernels (the new
cache written whole, the repeats stacked again, the float32 upcasts)."""

LAYER = "decode cache"
UNIT = "ms"
MOVES = "decode_tokens_per_s"


def pick(name):
    n = name.lower()
    return "cat" in n or "copy" in n


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.seconds(pick)
    return 1e3 * secs / run.trace.calls if secs > 0 else None
