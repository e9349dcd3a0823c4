"""The model's operations a training step (three times the forward's
products and causal attention, the head on every token, no recompute
counted; ``yardstick.train_flops``) over the mean wall of the window's
untraced steps, against the bf16 peak."""

LAYER = "model step"
UNIT = "%"
MOVES = "train_tokens_per_s"


def read(run):
    tr = run.traffic
    rows = tr["microbatches"] * tr["micro_batch"]
    flops = run.yard.train_flops(run.c, rows, tr["seq_len"])
    return 100.0 * flops / run.mean_wall() / run.yard.BF16_FLOP_PER_S
