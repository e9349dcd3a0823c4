"""Port of ``src/repro/configs/base.py`` (pure data).

Config helpers shared by the per-architecture config modules."""

from __future__ import annotations

import dataclasses

from ..models.common import ModelConfig

__all__ = ["ModelConfig", "reduce_for_smoke"]


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Same-family reduced config: tiny widths/depths for CPU smoke tests.

    Keeps the *structure* (block pattern, GQA ratio, MoE top-k, gating kinds)
    and shrinks every dimension.
    """
    pat = cfg.block_pattern
    n_layers = len(pat) + min(2, len(pat))     # ≥1 full repeat + remainder bit
    if len(pat) == 1:
        n_layers = 2
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, 4 - (4 % kv))
    base = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        window=min(cfg.window, 16),
        chunk_q=16, chunk_k=16, chunk_rec=8,
        remat=False,
        param_dtype="float32",
    )
    if cfg.is_moe:
        base.update(n_experts=4, top_k=min(cfg.top_k, 2), d_expert=32,
                    moe_impl="dense")
    if cfg.d_rnn:
        base.update(d_rnn=64)
    if cfg.is_encdec:
        base.update(encoder_layers=2)
    if "rwkv" in pat:
        base.update(rwkv_head_dim=16)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
