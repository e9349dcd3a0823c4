"""Device ms a training step in elementwise and reduction kernels (the
update, the accumulation, norms, casts and the loss), classified by
name as ``chip_smoke.py::train_step_groups`` does
(``yardstick.is_elementwise``)."""

LAYER = "training update"
UNIT = "ms"
MOVES = "train_tokens_per_s"


def read(run):
    if run.trace is None:
        return None
    return 1e3 * run.trace.seconds(run.yard.is_elementwise) / run.trace.calls
