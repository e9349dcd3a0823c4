"""K4′'s share of its roofline in a training step: 10·Dh operations a
kept pair a query head, every layer and microbatch
(``yardstick.k4b_flops``), at the bf16 peak, over the device time of
the kernels named in ``KERNELS`` a traced step."""

LAYER = "attention kernels"
UNIT = "%"
MOVES = "train_tokens_per_s"

KERNELS = ("bwd_tc_dq_kernel", "bwd_tc_dkdv_kernel", "bwd_tc_reduce_kernel",
           "bwd_dq_kernel", "bwd_dkdv_kernel", "bwd_reduce_kernel")


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.seconds(lambda n: any(k in n for k in KERNELS))
    if secs <= 0:
        return None
    tr = run.traffic
    rows = tr["microbatches"] * tr["micro_batch"]
    flops = run.yard.k4b_flops(run.c, rows, tr["seq_len"])
    return 100.0 * flops * run.trace.calls / secs / run.yard.BF16_FLOP_PER_S
