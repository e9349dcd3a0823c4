"""Device ms a prefill in matrix-product kernels of cuBLAS and CUTLASS,
gemv left out (``yardstick.is_gemm``)."""

LAYER = "matrix products"
UNIT = "ms"
MOVES = "prefill_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.seconds(run.yard.is_gemm)
    return 1e3 * secs / run.trace.calls if secs > 0 else None
