"""Port of ``src/repro/models/blocks.py``: per-kind transformer blocks with
pre-norm residual wiring, for the training forward, prefill and decode.

Kinds "attn" (full attention), "local" (sliding window), "rec" (RG-LRU)
and "rwkv" (RWKV-6 time and channel mix); the FFN of the attention and
"rec" kinds is the MoE FFN in an MoE config. The encoder-decoder adds
cross-attention with ``cross=True``. Each kind has the reference's uniform
cache interface; the training forward's backward is autograd (K4′ on the
full-attention route, ``kernels/attn/attn.py::FlashAttention``).
"""

from __future__ import annotations

import torch

from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec
from . import rwkv as rwkv_mod
from .common import TensorSpec
from .layers import mlp_apply, mlp_init, rms_norm

__all__ = ["block_init", "block_prefill", "block_train", "block_decode",
           "block_cache_spec"]

KINDS = ("attn", "local", "rec", "rwkv")


def _kind(kind: str):
    if kind not in KINDS:
        raise ValueError(kind)


def _ffn_init(generator, cfg, dtype, device):
    """Reference ``_ffn_init`` (blocks.py:24)."""
    if cfg.is_moe:
        return moe_mod.moe_init(generator, cfg, dtype, device=device)
    return mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype,
                    device=device)


def _ffn_apply(params, x, cfg, mesh=None, moe_impl=None):
    """Reference ``_ffn_apply`` (blocks.py:30): an MoE FFN takes
    ``moe_apply``'s form ``moe_impl`` over ``mesh``, the dense form with
    no mesh (prefill and decode pass none, as the reference's decode asks
    for ``moe_impl="dense"``)."""
    if cfg.is_moe:
        return moe_mod.moe_apply(params, x, cfg, impl=moe_impl, mesh=mesh,
                                 psum_late=cfg.moe_psum_late)
    return mlp_apply(params, x, cfg.mlp_kind)


def block_init(generator, cfg, kind: str, dtype, *, cross: bool = False,
               device=None):
    """Reference ``block_init`` (blocks.py:37)."""
    _kind(kind)
    d = cfg.d_model
    dev = device or generator.device
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=dev),
         "ln2": torch.zeros((d,), dtype=dtype, device=dev)}
    if kind in ("attn", "local"):
        p["attn"] = attn.attn_init(generator, cfg, dtype=dtype, device=dev)
        p["ffn"] = _ffn_init(generator, cfg, dtype, dev)
    elif kind == "rec":
        p["rec"] = rec.rglru_init(generator, cfg, dtype, device=dev)
        p["ffn"] = _ffn_init(generator, cfg, dtype, dev)
    else:
        p.update(rwkv_mod.rwkv_init(generator, cfg, dtype, device=dev))
    if cross:
        p["ln_cross"] = torch.zeros((d,), dtype=dtype, device=dev)
        p["cross"] = attn.attn_init(generator, cfg, cross=True, dtype=dtype,
                                    device=dev)
    return p


def block_train(params, x, cfg, kind: str, *, mesh=None, moe_impl=None,
                enc=None, causal: bool = True):
    """Reference ``block_train`` (blocks.py:57), forward: x (B, T, d) →
    (B, T, d). ``causal=False`` is the encoder's bidirectional "attn";
    ``mesh`` and ``moe_impl`` go to an MoE FFN."""
    _kind(kind)
    eps = cfg.norm_eps
    if kind in ("attn", "local"):
        x = x + attn.attn_train(params["attn"],
                                rms_norm(x, params["ln1"], eps), cfg, kind,
                                causal=causal)
        if "cross" in params:
            c, _ = attn.cross_attn_train(
                params["cross"], rms_norm(x, params["ln_cross"], eps), enc,
                cfg)
            x = x + c
        return x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                              cfg, mesh, moe_impl)
    if kind == "rec":
        h, _ = rec.rglru_train(params["rec"], rms_norm(x, params["ln1"], eps),
                               cfg)
        x = x + h
        return x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                              cfg, mesh, moe_impl)
    h, _ = rwkv_mod.rwkv_time_mix(params, rms_norm(x, params["ln1"], eps), cfg)
    x = x + h
    h, _ = rwkv_mod.rwkv_channel_mix(params, rms_norm(x, params["ln2"], eps),
                                     cfg)
    return x + h


def block_cache_spec(cfg, kind: str, batch: int, cache_len: int, dtype,
                     *, cross_len: int = 0):
    """Reference ``block_cache_spec`` (blocks.py:89): the KV cache of an
    attention kind or the state of a recurrent one, plus the cross cache
    of ``cross_len`` encoder positions."""
    _kind(kind)
    if kind in ("attn", "local"):
        spec = attn.cache_spec(cfg, kind, batch, cache_len, dtype)
    elif kind == "rec":
        spec = rec.rglru_state_spec(cfg, batch, dtype)
    else:
        spec = rwkv_mod.rwkv_state_spec(cfg, batch, dtype)
    if cross_len:
        shp = (batch, cross_len, cfg.n_kv_heads, cfg.d_head)
        spec = dict(spec)
        spec["cross"] = {"k": TensorSpec(shp, dtype),
                         "v": TensorSpec(shp, dtype)}
    return spec


def block_prefill(params, x, cfg, kind: str, cache_len: int, *, enc=None):
    """Reference ``block_prefill`` (blocks.py:107): (x, the block's cache)."""
    _kind(kind)
    eps = cfg.norm_eps
    if kind in ("attn", "local"):
        h, cache = attn.attn_prefill(params["attn"],
                                     rms_norm(x, params["ln1"], eps), cfg,
                                     kind, cache_len)
        x = x + h
        if "cross" in params:
            c, cache["cross"] = attn.cross_attn_train(
                params["cross"], rms_norm(x, params["ln_cross"], eps), enc,
                cfg)
            x = x + c
        x = x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                           cfg)
        return x, cache
    if kind == "rec":
        h, state = rec.rglru_train(params["rec"],
                                   rms_norm(x, params["ln1"], eps), cfg)
        x = x + h
        x = x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                           cfg)
        return x, state
    h, st_att = rwkv_mod.rwkv_time_mix(params, rms_norm(x, params["ln1"], eps),
                                       cfg)
    x = x + h
    h, st_ffn = rwkv_mod.rwkv_channel_mix(
        params, rms_norm(x, params["ln2"], eps), cfg)
    return x + h, {**st_att, **st_ffn}


def block_decode(params, x, cache, pos: int, cfg, kind: str):
    """Reference ``block_decode`` (blocks.py:137): one token x (B, 1, d) at
    absolute position ``pos`` → (x, the block's new cache). An MoE FFN
    takes the dense form. The cross cache is passed through unchanged."""
    _kind(kind)
    eps = cfg.norm_eps
    if kind in ("attn", "local"):
        h, new_cache = attn.attn_decode(params["attn"],
                                        rms_norm(x, params["ln1"], eps),
                                        cache, pos, cfg, kind)
        x = x + h
        if "cross" in params:
            x = x + attn.cross_attn_decode(
                params["cross"], rms_norm(x, params["ln_cross"], eps),
                cache["cross"], cfg)
            new_cache["cross"] = cache["cross"]
        x = x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                           cfg)
        return x, new_cache
    if kind == "rec":
        h, state = rec.rglru_decode(params["rec"],
                                    rms_norm(x, params["ln1"], eps), cache,
                                    cfg)
        x = x + h
        x = x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                           cfg)
        return x, state
    h, st_att = rwkv_mod.rwkv_time_mix(
        params, rms_norm(x, params["ln1"], eps), cfg,
        state={"s": cache["s"], "x_att": cache["x_att"]})
    x = x + h
    h, st_ffn = rwkv_mod.rwkv_channel_mix(
        params, rms_norm(x, params["ln2"], eps), cfg,
        state={"x_ffn": cache["x_ffn"]})
    return x + h, {**st_att, **st_ffn}
