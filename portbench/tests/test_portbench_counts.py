"""The benchmark's operation and byte counts against the program's own
count of a step on ``meta`` tensors (``repro_torch.launch.cost``), at
small sizes. The program's count takes attention as every query against
every key; the benchmark's takes the pairs a causal mask keeps, so the
two are compared on the products and on the full-pair attention apart."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from pbench import weights as W  # noqa: E402
from pbench import yardstick as Y  # noqa: E402
from tiny import TINY  # noqa: E402

C = dict(TINY["tiny-glm"], n_layers=3, remat=False)


def _cfg(c):
    from pbench.harness import port_config
    return port_config(c)


def _full_attention(c, b, t, products):
    return c["n_layers"] * b * c["n_heads"] * t * t * c["d_head"] * 2 \
        * products


@pytest.mark.parametrize("b,t", [(1, 16), (2, 40)])
def test_prefill_flops_match_cost_mode(b, t):
    from repro_torch.launch.cost import count
    from repro_torch.models import param_specs, prefill
    cfg = _cfg(C)
    params = param_specs(cfg)
    toks = torch.zeros((b, t), dtype=torch.long, device="meta")
    _, cost = count(prefill, params, {"tokens": toks}, cfg, t)
    products = Y.prefill_flops(C, b, t) - C["n_layers"] * Y.mixer_flops(
        C, b, t, t)
    assert cost.flops == pytest.approx(
        products + _full_attention(C, b, t, 2), rel=1e-12)
    assert Y.k4_flops(C, b, t) == C["n_layers"] * Y.mixer_flops(C, b, t, t)


def test_train_flops_match_cost_mode():
    from repro_torch.launch.cost import count
    from repro_torch.models import param_specs
    from repro_torch.training.optimizer import loss_and_grads
    cfg = _cfg(C)
    params = param_specs(cfg)
    b, t = 2, 24
    batch = {"tokens": torch.zeros((b, t), dtype=torch.long, device="meta"),
             "labels": torch.zeros((b, t), dtype=torch.long, device="meta")}
    _, cost = count(loss_and_grads, params, batch, cfg)
    attn = C["n_layers"] * Y.mixer_flops(C, b, t, t)
    products = Y.train_flops(C, b, t) - 3 * attn
    # forward 2 products of K4, backward 5 of K4′, every pair
    assert cost.flops == pytest.approx(
        products + _full_attention(C, b, t, 7), rel=1e-12)
    assert Y.k4b_flops(C, b, t) == pytest.approx(2.5 * Y.k4_flops(C, b, t))


def test_causal_pairs():
    assert Y.causal_pairs(4) == 10
    assert Y.causal_pairs(1, 9) == 9
    assert Y.causal_pairs(3, 5) == 3 + 4 + 5


def test_decode_bytes_count_weights_and_cache():
    c = C
    params = W.draw_params(c, 1, "cpu")
    b, slots = 3, 20
    cache = W.draw_kv_cache(c, 1, b, slots, "cpu")
    leaves = W.flat(params)
    weights = sum(t.numel() * 2 for p, t in leaves.items() if p != "embed")
    want = weights + b * c["d_model"] * 2 \
        + sum(t.numel() * 2 for t in cache.values()) \
        + 2 * c["n_layers"] * b * c["n_kv_heads"] * c["d_head"] * 2
    # the norms' vectors are not counted by the yardstick: add them back
    norms = sum(t.numel() * 2 for p, t in leaves.items()
                if p.endswith(("ln1", "ln2", "final_ln")))
    assert Y.decode_bytes(c, b, slots) + norms == want


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40)]
    assert Y.union_seconds(iv) == pytest.approx(30e-9)
    assert Y.idle_gaps(iv, 0, 50) == [(20, 30), (40, 50)]
