"""A decode step's roofline share: the larger of its operations at the
bf16 peak and its least bytes at the HBM peak (every weight and the
head read once, the cache read once, the new K/V written once;
``yardstick.decode_bytes``), over the mean wall of the window's
untraced steps. Bytes bound it."""

LAYER = "model step"
UNIT = "%"
MOVES = "decode_tokens_per_s"


def read(run):
    tr = run.traffic
    # the steps' middle position (attention's share of the operations
    # grows with it; the bytes do not)
    b = tr["batch"]
    pos = tr["start_pos"] + (tr["cache_len"] - tr["start_pos"]) // 2
    y = run.yard
    least = max(y.decode_flops(run.c, b, pos) / y.BF16_FLOP_PER_S,
                y.decode_bytes(run.c, b, tr["cache_len"])
                / y.HBM_BYTES_PER_S)
    return 100.0 * least / run.mean_wall()
