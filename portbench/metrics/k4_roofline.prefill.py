"""K4's share of its roofline in a prefill: causal attention's
operations (4·Dh a kept (query, key) pair a query head, every layer;
``yardstick.k4_flops``) at the bf16 peak, over the device time of the
kernels named in ``KERNELS`` a traced prefill. Nothing to read where
no such kernel ran."""

LAYER = "attention kernels"
UNIT = "%"
MOVES = "prefill_tokens_per_s"

KERNELS = ("flash_tc_kernel", "flash_fwd_kernel")


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.seconds(lambda n: any(k in n for k in KERNELS))
    if secs <= 0:
        return None
    tr = run.traffic
    flops = run.yard.k4_flops(run.c, tr["batch"], tr["prompt_len"])
    return 100.0 * flops * run.trace.calls / secs / run.yard.BF16_FLOP_PER_S
