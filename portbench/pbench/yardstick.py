"""The benchmark's yardstick: the card's peaks, the operations and bytes of
a model step counted from the configuration and the shapes, and the
reduction of a device trace to busy time. Nothing here imports the
program; later changes to the program cannot move these numbers.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity)
at its 700 W power limit. The kernel counts follow
``chip_smoke.py::k4_work`` and ``k4b_work`` (4·Dh operations a kept
(query, key) pair forward, 10·Dh backward); the model counts follow the
products that ``launch/cost.py`` sees, with causal attention counted on
the pairs the mask keeps.
"""

from __future__ import annotations

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


# ---------------------------------------------------------------- counts

def causal_pairs(tq: int, tk: int | None = None) -> int:
    """(query, key) pairs a causal mask keeps for ``tq`` queries at the
    end of ``tk`` keys (the queries are the last ``tq`` positions)."""
    tk = tq if tk is None else tk
    past = tk - tq
    return tq * past + tq * (tq + 1) // 2


def attn_pair_flops(dh: int, backward: bool = False) -> int:
    """Operations a kept (query, key) pair costs one query head: two
    products of 2·Dh forward (Q·K, P·V), five backward."""
    return (10 if backward else 4) * dh


def transformer_layer_weights(c: dict) -> int:
    """Matrix elements of one attention layer with a gated FFN."""
    d, dh = c["d_model"], c["d_head"]
    attn = d * dh * c["n_heads"] * 2 + 2 * d * dh * c["n_kv_heads"]
    return attn + 3 * d * c["d_ff"]


def rwkv_layer_weights(c: dict) -> int:
    """Matrix elements of one RWKV-6 layer: r, k, v, g, o and the decay's
    low-rank pair in the time mix; k, v and r in the channel mix."""
    d = c["d_model"]
    return 5 * d * d + 2 * d * 64 + 2 * d * c["d_ff"] + d * d


def is_rwkv(c: dict) -> bool:
    return tuple(c["block_pattern"]) == ("rwkv",)


def layer_weights(c: dict) -> int:
    return rwkv_layer_weights(c) if is_rwkv(c) \
        else transformer_layer_weights(c)


def mixer_flops(c: dict, b: int, tq: int, tk: int) -> float:
    """Operations of one layer's sequence mixer beyond its projections:
    causal attention on the kept pairs, or the WKV recurrence (per token
    and head, the state's read and its rank-one update: two N×N products,
    4·N² operations)."""
    if is_rwkv(c):
        n = c["rwkv_head_dim"]
        return float(b * tq * (c["d_model"] // n) * 4 * n * n)
    return float(b * c["n_heads"] * causal_pairs(tq, tk)
                 * attn_pair_flops(c["d_head"]))


def prefill_flops(c: dict, b: int, t: int) -> float:
    """A prefill of ``b`` prompts of ``t`` tokens: every layer's products
    on every token, the mixer, and the head on the last token a row."""
    layers = c["n_layers"]
    return (2.0 * b * t * layer_weights(c) * layers
            + layers * mixer_flops(c, b, t, t)
            + 2.0 * b * c["d_model"] * c["vocab_size"])


def decode_flops(c: dict, b: int, pos: int) -> float:
    """One decode step of ``b`` rows at position ``pos``: the products,
    attention over ``pos + 1`` keys, and the head."""
    layers = c["n_layers"]
    return (2.0 * b * layer_weights(c) * layers
            + layers * mixer_flops(c, b, 1, pos + 1)
            + 2.0 * b * c["d_model"] * c["vocab_size"])


def decode_bytes(c: dict, b: int, cache_len: int, esize: int = 2) -> float:
    """The least bytes a decode step of an attention model moves: every
    layer's weights and the head read once, ``b`` embedding rows, the K/V
    cache read once and the new K/V written once (as
    ``chip_smoke.py::decode_bytes``)."""
    layers = c["n_layers"]
    weights = layer_weights(c) * layers + c["d_model"] * c["vocab_size"]
    kv_row = 2 * c["n_kv_heads"] * c["d_head"]
    cache = layers * b * cache_len * kv_row
    new = layers * b * kv_row
    return float(esize * (weights + b * c["d_model"] + cache + new))


def train_flops(c: dict, rows: int, t: int) -> float:
    """A training step on ``rows`` sequences of ``t`` tokens: three times
    the forward (the forward, the two products of the backward), with no
    recompute counted; the head on every token."""
    layers = c["n_layers"]
    fwd = (2.0 * rows * t * layer_weights(c) * layers
           + layers * mixer_flops(c, rows, t, t)
           + 2.0 * rows * t * c["d_model"] * c["vocab_size"])
    return 3.0 * fwd


def k4_flops(c: dict, b: int, t: int) -> float:
    """K4's operations in one pass over ``b`` rows of ``t`` tokens, every
    attention layer: 4·Dh a kept pair a query head."""
    return float(c["n_layers"] * b * c["n_heads"] * causal_pairs(t)
                 * attn_pair_flops(c["d_head"]))


def k4b_flops(c: dict, b: int, t: int) -> float:
    """K4′'s operations in one backward: 10·Dh a kept pair a query head."""
    return float(c["n_layers"] * b * c["n_heads"] * causal_pairs(t)
                 * attn_pair_flops(c["d_head"], backward=True))


# ---------------------------------------------------------------- traces

def union_seconds(intervals) -> float:
    """The length of the union of ``(start_ns, end_ns)`` intervals, in
    seconds: overlapping kernels count once."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def idle_gaps(intervals, lo: int, hi: int):
    """The gaps ``(start_ns, end_ns)`` within [lo, hi] in which no
    interval runs."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [g for g in gaps if g[1] > g[0]]


def is_gemm(name: str) -> bool:
    """A matrix-product kernel of cuBLAS or CUTLASS (gemv excluded)."""
    n = name.lower()
    return "gemv" not in n and any(
        x in n for x in ("gemm", "nvjet", "xmma", "cutlass", "splitk",
                         "sm90_", "sm80_"))


def is_elementwise(name: str) -> bool:
    """Elementwise and reduction kernels, as
    ``chip_smoke.py::train_step_groups`` classifies them."""
    return any(x in name for x in ("elementwise", "reduce", "softmax",
                                   "Reduce"))
