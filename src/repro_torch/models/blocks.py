"""Port of ``src/repro/models/blocks.py``: per-kind transformer blocks with
pre-norm residual wiring, for prefill.

Kinds "attn" (full causal) and "local" (sliding window) with a dense FFN.
MoE FFNs, the recurrent kinds ("rec", "rwkv") and cross-attention
(``cross=True``) raise ``NotImplementedError`` until their modules are
ported (ROADMAP.md, queue 1); so do train and decode.
"""

from __future__ import annotations

import torch

from . import attention as attn
from .layers import mlp_apply, mlp_init, rms_norm

__all__ = ["block_init", "block_prefill", "block_cache_spec"]

WAITS = ("waits for its port: ROADMAP.md queue 1, the LM stack's "
         "MoE / 'rec' / 'rwkv' / encoder-decoder item")


def _supported(cfg, kind: str, cross: bool = False):
    if kind not in ("attn", "local", "rec", "rwkv"):
        raise ValueError(kind)
    if kind in ("rec", "rwkv"):
        raise NotImplementedError(f"block kind {kind!r} {WAITS}")
    if cfg.is_moe:
        raise NotImplementedError(f"the MoE FFN {WAITS}")
    if cross:
        raise NotImplementedError(f"cross-attention {WAITS}")


def block_init(generator, cfg, kind: str, dtype, *, cross: bool = False,
               device=None):
    _supported(cfg, kind, cross)
    d = cfg.d_model
    dev = device or generator.device
    return {
        "ln1": torch.zeros((d,), dtype=dtype, device=dev),
        "ln2": torch.zeros((d,), dtype=dtype, device=dev),
        "attn": attn.attn_init(generator, cfg, dtype=dtype, device=device),
        "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                        dtype, device=device),
    }


def block_cache_spec(cfg, kind: str, batch: int, cache_len: int, dtype,
                     *, cross_len: int = 0):
    _supported(cfg, kind, bool(cross_len))
    return attn.cache_spec(cfg, kind, batch, cache_len, dtype)


def block_prefill(params, x, cfg, kind: str, cache_len: int):
    _supported(cfg, kind, "cross" in params)
    eps = cfg.norm_eps
    h, cache = attn.attn_prefill(params["attn"],
                                 rms_norm(x, params["ln1"], eps), cfg, kind,
                                 cache_len)
    x = x + h
    x = x + mlp_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                      cfg.mlp_kind)
    return x, cache
