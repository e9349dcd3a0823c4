"""Port of ``src/repro/models/blocks.py``: per-kind transformer blocks with
pre-norm residual wiring, for the training forward, prefill and decode.

Kinds "attn" (full attention), "local" (sliding window), "rec" (RG-LRU)
and "rwkv" (RWKV-6 time and channel mix); the FFN of the attention and
"rec" kinds is the MoE FFN in an MoE config. The encoder-decoder adds
cross-attention with ``cross=True``. Each kind has the reference's uniform
cache interface; the training forward's backward is autograd (K4′ on the
full-attention route, ``kernels/attn/attn.py::FlashAttention``).

Every block function takes the reference's ``mesh`` and ``moe_impl``: an
MoE FFN takes ``moe_apply``'s form ``moe_impl`` over ``mesh``, and over a
mesh with a ``model`` axis of several ranks the dense layers compute in
their split forms (``distributed/sharding.py::tp_plan``), in the training
forward, prefill and decode alike.

The training forward takes two more layouts of the reference's
``optimized`` cells, read from its rules by ``models/model.py`` and
handed down: ``sp`` (Megatron-SP, ``seq_sp`` → ``model``: the residual is
the rank's block of the sequence; the norms run on the block, and each
split region gathers its normed input, ``TPPlan.enter``, and leaves by
``TPPlan.leave``) and ``fsdp`` (ZeRO-3: the MoE expert stacks are stored
split over those data axes and gathered here, one layer at a time,
``moe.gather_experts``). Prefill and decode take ``fsdp`` too, and ``kv``
(``distributed/sharding.py::KVSplit``, ``seq_kv``): the KV caches hold
every KV head for the rank's block of the slots.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import tp_plan
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


def _ffn_apply(params, x, cfg, mesh=None, moe_impl=None, tp=None,
               fsdp=()):
    """Reference ``_ffn_apply`` (blocks.py:30): an MoE FFN takes
    ``moe_apply``'s form ``moe_impl`` over ``mesh`` (the dense form with no
    mesh), its experts first gathered over the ``fsdp`` axes; a dense FFN
    its split form under the plan ``tp``."""
    if cfg.is_moe:
        if fsdp:
            params = moe_mod.gather_experts(params, cfg, mesh, fsdp,
                                            moe_impl)
        return moe_mod.moe_apply(params, x, cfg, impl=moe_impl, mesh=mesh,
                                 psum_late=cfg.moe_psum_late,
                                 sp=tp is not None and tp.sp)
    return mlp_apply(params, x if tp is None else tp.enter(x), cfg.mlp_kind,
                     tp=tp)


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
                enc=None, causal: bool = True, sp: bool = False, fsdp=()):
    """Reference ``block_train`` (blocks.py:57), forward: x (B, T, d) →
    (B, T, d), under ``sp`` the rank's block (B, T / n, d) of each.
    ``causal=False`` is the encoder's bidirectional "attn"; ``mesh``,
    ``moe_impl``, ``sp`` and ``fsdp`` as the module says."""
    _kind(kind)
    eps = cfg.norm_eps
    tp = tp_plan(cfg, mesh, sp=sp)

    def entry(h):
        return h if tp is None else tp.enter(h)

    def ffn(h):
        return _ffn_apply(params["ffn"], rms_norm(h, params["ln2"], eps),
                          cfg, mesh, moe_impl, tp, fsdp)
    if kind in ("attn", "local"):
        x = x + attn.attn_train(params["attn"],
                                entry(rms_norm(x, params["ln1"], eps)), cfg,
                                kind, causal=causal, tp=tp)
        if "cross" in params:
            c, _ = attn.cross_attn_train(
                params["cross"], entry(rms_norm(x, params["ln_cross"], eps)),
                enc, cfg, tp)
            x = x + c
        return x + ffn(x)
    if kind == "rec":
        h, _ = rec.rglru_train(params["rec"],
                               entry(rms_norm(x, params["ln1"], eps)), cfg,
                               tp=tp)
        x = x + h
        return x + ffn(x)
    h, _ = rwkv_mod.rwkv_time_mix(
        params, entry(rms_norm(x, params["ln1"], eps)), cfg, tp=tp)
    x = x + h
    h, _ = rwkv_mod.rwkv_channel_mix(
        params, entry(rms_norm(x, params["ln2"], eps)), cfg, tp=tp)
    return x + h


def block_cache_spec(cfg, kind: str, batch: int, cache_len: int, dtype,
                     *, cross_len: int = 0, tp=None, kv=None):
    """Reference ``block_cache_spec`` (blocks.py:89): the KV cache of an
    attention kind or the state of a recurrent one, plus the cross cache
    of ``cross_len`` encoder positions; this rank's heads and channels
    under the plan ``tp``, and under ``kv`` its block of the KV caches'
    slots for every KV head."""
    _kind(kind)
    if kind in ("attn", "local"):
        spec = attn.cache_spec(cfg, kind, batch, cache_len, dtype, tp, kv)
    elif kind == "rec":
        spec = rec.rglru_state_spec(cfg, batch, dtype, tp)
    else:
        spec = rwkv_mod.rwkv_state_spec(cfg, batch, dtype, tp)
    if cross_len:
        if kv is not None:
            heads, cross_len = cfg.n_kv_heads, kv.span(cross_len)[1]
        else:
            heads = cfg.n_kv_heads if tp is None else tp.kv_heads
        shp = (batch, cross_len, heads, cfg.d_head)
        spec = dict(spec)
        spec["cross"] = {"k": TensorSpec(shp, dtype),
                         "v": TensorSpec(shp, dtype)}
    return spec


def block_prefill(params, x, cfg, kind: str, cache_len: int, *, mesh=None,
                  moe_impl=None, enc=None, fsdp=(), kv=None):
    """Reference ``block_prefill`` (blocks.py:104): (x, the block's
    cache)."""
    _kind(kind)
    eps = cfg.norm_eps
    tp = tp_plan(cfg, mesh)
    if kind in ("attn", "local"):
        h, cache = attn.attn_prefill(params["attn"],
                                     rms_norm(x, params["ln1"], eps), cfg,
                                     kind, cache_len, tp, kv)
        x = x + h
        if "cross" in params:
            c, cross = attn.cross_attn_train(
                params["cross"], rms_norm(x, params["ln_cross"], eps), enc,
                cfg, tp)
            cache["cross"] = cross if kv is None \
                else attn.kv_block(cross, cfg, tp, kv, kv.enc_len)
            x = x + c
        x = x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                           cfg, mesh, moe_impl, tp, fsdp)
        return x, cache
    if kind == "rec":
        h, state = rec.rglru_train(params["rec"],
                                   rms_norm(x, params["ln1"], eps), cfg,
                                   tp=tp)
        x = x + h
        x = x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                           cfg, mesh, moe_impl, tp, fsdp)
        return x, state
    h, st_att = rwkv_mod.rwkv_time_mix(params, rms_norm(x, params["ln1"], eps),
                                       cfg, tp=tp)
    x = x + h
    h, st_ffn = rwkv_mod.rwkv_channel_mix(
        params, rms_norm(x, params["ln2"], eps), cfg, tp=tp)
    return x + h, {**st_att, **st_ffn}


def block_decode(params, x, cache, pos: int, cfg, kind: str, *, mesh=None,
                 moe_impl="dense", fsdp=(), kv=None):
    """Reference ``block_decode`` (blocks.py:137): one token x (B, 1, d) at
    absolute position ``pos`` → (x, the block's new cache). An MoE FFN
    takes the form ``moe_impl``, the dense form by default. The cross
    cache is passed through unchanged."""
    _kind(kind)
    eps = cfg.norm_eps
    tp = tp_plan(cfg, mesh)
    if kind in ("attn", "local"):
        h, new_cache = attn.attn_decode(params["attn"],
                                        rms_norm(x, params["ln1"], eps),
                                        cache, pos, cfg, kind, tp, kv)
        x = x + h
        if "cross" in params:
            x = x + attn.cross_attn_decode(
                params["cross"], rms_norm(x, params["ln_cross"], eps),
                cache["cross"], cfg, tp, kv)
            new_cache["cross"] = cache["cross"]
        x = x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                           cfg, mesh, moe_impl, tp, fsdp)
        return x, new_cache
    if kind == "rec":
        h, state = rec.rglru_decode(params["rec"],
                                    rms_norm(x, params["ln1"], eps), cache,
                                    cfg, tp)
        x = x + h
        x = x + _ffn_apply(params["ffn"], rms_norm(x, params["ln2"], eps),
                           cfg, mesh, moe_impl, tp, fsdp)
        return x, state
    h, st_att = rwkv_mod.rwkv_time_mix(
        params, rms_norm(x, params["ln1"], eps), cfg,
        state={"s": cache["s"], "x_att": cache["x_att"]}, tp=tp)
    x = x + h
    h, st_ffn = rwkv_mod.rwkv_channel_mix(
        params, rms_norm(x, params["ln2"], eps), cfg,
        state={"x_ffn": cache["x_ffn"]}, tp=tp)
    return x + h, {**st_att, **st_ffn}
