"""The model's operations a prefill (every layer's products on every
token, causal attention on the pairs the mask keeps or the WKV's state
products, the head on the last token; ``yardstick.prefill_flops``) over
the mean wall of the window's untraced prefills, against the bf16 peak."""

LAYER = "model step"
UNIT = "%"
MOVES = "prefill_tokens_per_s"


def read(run):
    tr = run.traffic
    flops = run.yard.prefill_flops(run.c, tr["batch"], tr["prompt_len"])
    return 100.0 * flops / run.mean_wall() / run.yard.BF16_FLOP_PER_S
