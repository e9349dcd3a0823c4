"""Device ms a prefill in gemv kernels: the float32 batched products of
the WKV's chunks run as matrix-vector kernels. Nothing to read where
none ran."""

LAYER = "rwkv time mix"
UNIT = "ms"
MOVES = "prefill_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.seconds(lambda n: "gemv" in n.lower())
    return 1e3 * secs / run.trace.calls if secs > 0 else None
