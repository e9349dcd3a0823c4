"""Port of ``src/repro/launch/specs.py``: the per-(architecture × input
shape) dry-run cells.

For every cell this module builds the step function (the train step, the
prefill or one decode step), ``meta`` stand-ins for every input
(``param_specs``, ``cache_specs``: shapes and dtypes, no storage) and the
input shardings (:class:`~repro_torch.distributed.sharding.NamedSharding`
trees), spec for spec the reference's on the same mesh: the same
``SHAPES``, the same rules for the decode and ``long_500k`` cells, the
same ``_choose_moe_impl``, the same ``meta`` and ``tokens_per_step``.

Shape semantics (the reference's):
  train_4k     seq 4096,   global_batch 256  → train step
  prefill_32k  seq 32768,  global_batch 32   → prefill
  decode_32k   seq 32768,  global_batch 128  → one decode step (KV = seq)
  long_500k    seq 524288, global_batch 1    → one decode step; only the
               sub-quadratic archs (the others are skipped)

Whisper (enc-dec, stub frontend): the shape's seq is the encoder's frame
count; the decoder's length is seq // 8.

``mesh`` is a ``DeviceMesh`` (the step can then run on it) or a
``MeshShape`` (names and sizes only, for the specs). ``optimized=True``
is the reference's optimized cell: Megatron-SP (``seq_sp`` → ``model``)
for train cells, ZeRO-3 of the MoE expert stacks (``fsdp`` → the data
axes, ``param_shardings(..., moe_fsdp=True)``), ``moe_psum_late`` for a
``tp``-form MoE config, and for the train step the ZeRO layout of the
moments as the gradient's, the parameters written back to their storage
layout (the compute layout of the dense leaves, the ZeRO-3 split of the
experts) and a bf16 gradient accumulator. Every cell's step is handed
its ``rules`` (``rules=``), from which the model code reads ``seq_sp``,
``fsdp`` and the decode cells' ``seq_kv`` (the cache split by sequence).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs import ARCHS, get_config, long_context_ok
from ..distributed.sharding import (batch_axes, compute_shardings,
                                    mesh_shape,
                                    named_sharding_for, param_shardings)
from ..models import cache_specs, decode_step, param_specs, prefill
from ..training.optimizer import OptConfig, make_train_step, opt_init
from ..tree import tree_map

__all__ = ["SHAPES", "CellSpec", "all_cells", "build_cell"]

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, mode="train"),
    "prefill_32k": dict(seq=32768, batch=32, mode="prefill"),
    "decode_32k": dict(seq=32768, batch=128, mode="decode"),
    "long_500k": dict(seq=524288, batch=1, mode="decode"),
}


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    mode: str
    fn: Callable | None          # the step function
    args: tuple                  # meta-tensor trees
    in_shardings: tuple
    donate: tuple
    tokens_per_step: int
    meta: dict
    rules: dict
    skipped: str | None = None   # reason if the cell is skipped


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _n_data(mesh) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def _choose_moe_impl(cfg, mode: str, batch: int, mesh) -> str | None:
    """Reference ``_choose_moe_impl`` (specs.py:62)."""
    if not cfg.is_moe:
        return None
    if mode in ("train", "prefill"):
        return cfg.moe_impl
    # decode: the tp dispatch if the batch shards over the data axes, else
    # the dense form (tiny token counts)
    return "tp" if batch % _n_data(mesh) == 0 else "dense"


def _cache_shardings(cache, mesh, rules):
    """Reference ``_cache_shardings``: logical axes per cache leaf, by the
    leaf's name."""
    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(walk(v, name) for v in tree)
        nd = len(tree.shape)
        if name in ("k", "v") and nd == 5:
            logical = (None, "batch", "seq_kv", "kv", None)
        elif name == "s":                       # rwkv state (R,B,H,N,N)
            logical = (None, "batch", "heads", None, None)
        elif name in ("x_att", "x_ffn"):
            logical = (None, "batch", "embed")
        elif name == "h":                       # rg-lru (R,B,dr)
            logical = (None, "batch", "rnn")
        elif name == "conv":
            logical = (None, "batch", None, "rnn")
        else:
            logical = (None,) * nd
        return named_sharding_for(tree.shape, logical, mesh, rules)
    return walk(cache)


def _batch(cfg, batch: int, dec_len: int, seq: int, mesh, rules, *,
           labels: bool):
    tokens = _meta((batch, dec_len), torch.int32)
    args: dict[str, Any] = {"tokens": tokens}
    shard = {"tokens": named_sharding_for(tokens.shape, ("batch", None),
                                          mesh, rules)}
    if labels:
        args["labels"] = tokens
        shard["labels"] = shard["tokens"]
    if cfg.is_encdec:
        enc = _meta((batch, seq, cfg.d_model), torch.bfloat16)
        args["enc_input"] = enc
        shard["enc_input"] = named_sharding_for(
            enc.shape, ("batch", None, None), mesh, rules)
    return args, shard


def build_cell(arch: str, shape: str, mesh, *, rules: dict | None = None,
               optimized: bool = False) -> CellSpec:
    """Reference ``build_cell`` (specs.py:97): the cell of ``arch`` ×
    ``shape`` on ``mesh``; ``optimized`` as the module says."""
    cfg = get_config(arch)
    if optimized and cfg.is_moe and cfg.moe_impl != "ep":
        cfg = dataclasses.replace(cfg, moe_psum_late=True)
    info = SHAPES[shape]
    seq, batch, mode = info["seq"], info["batch"], info["mode"]

    if shape == "long_500k" and not long_context_ok(arch):
        return CellSpec(arch, shape, mode, None, (), (), (), 0, {},
                        rules or {},
                        skipped="pure full attention — long_500k n/a "
                                "(DESIGN.md §Arch-applicability)")

    rules = dict(rules or {})
    if optimized and mode == "train":
        # Megatron-SP targets the remat-saved residual: a training memory
        # concern (the reference keeps it off prefill)
        rules.setdefault("seq_sp", "model")
    if optimized:
        rules.setdefault("fsdp", ("pod", "data"))
    if shape == "long_500k":
        # a batch of 1 cannot shard; the reference shards the KV/sequence
        # axis instead
        rules.setdefault("batch", None)
        rules.setdefault("seq_kv", ("data", "model"))
    elif mode == "decode":
        rules.setdefault("seq_kv", "model")

    moe_impl = _choose_moe_impl(cfg, mode, batch, mesh)
    p_specs = param_specs(cfg)
    p_shard = param_shardings(p_specs, mesh, cfg, rules, moe_fsdp=optimized)
    meta = dict(params=cfg.param_count(),
                active_params=cfg.active_param_count(), moe_impl=moe_impl,
                seq=seq, batch=batch, optimized=optimized)
    dec_len = seq // 8 if cfg.is_encdec else seq

    if mode == "train":
        opt_specs = opt_init(p_specs)
        opt_shard = param_shardings(opt_specs, mesh, cfg, rules,
                                    extra_batch_dim=True, moe_fsdp=optimized)
        batch_args, batch_shard = _batch(cfg, batch, dec_len, seq, mesh,
                                         rules, labels=True)
        n_micro = max(1, batch // _n_data(mesh))  # 1 sample a rank a micro
        meta["n_microbatches"] = n_micro
        # ZeRO-2: each microbatch's gradient reduce-scattered into the
        # moments' layout; under optimized the parameters are written back
        # to their storage layout and the accumulator is bf16
        step = make_train_step(
            cfg, OptConfig(), mesh=mesh, moe_impl=moe_impl,
            n_microbatches=n_micro, grad_shardings=opt_shard["m"],
            param_out_shardings=compute_shardings(
                p_specs, mesh, cfg, moe_impl, moe_fsdp=True, rules=rules)
            if optimized else None,
            accum_dtype=torch.bfloat16 if optimized else torch.float32,
            rules=rules)

        return CellSpec(arch, shape, mode, step,
                        (p_specs, opt_specs, batch_args),
                        (p_shard, opt_shard, batch_shard), donate=(0, 1),
                        tokens_per_step=batch * dec_len, meta=meta,
                        rules=rules)

    if mode == "prefill":
        batch_args, batch_shard = _batch(cfg, batch, dec_len, seq, mesh,
                                         rules, labels=False)

        def fn(params, b):
            return prefill(params, b, cfg, cache_len=dec_len, mesh=mesh,
                           moe_impl=moe_impl, rules=rules)

        return CellSpec(arch, shape, mode, fn, (p_specs, batch_args),
                        (p_shard, batch_shard), donate=(),
                        tokens_per_step=batch * dec_len, meta=meta,
                        rules=rules)

    # decode
    specs = cache_specs(cfg, batch, dec_len,
                        enc_len=seq if cfg.is_encdec else 0)
    cache = tree_map(lambda s: _meta(s.shape, s.dtype), specs)
    cache_shard = _cache_shardings(cache, mesh, rules)
    tok = _meta((batch,), torch.int32)
    pos = _meta((), torch.int32)
    tok_shard = named_sharding_for(tok.shape, ("batch",), mesh, rules)
    pos_shard = named_sharding_for((), (), mesh, rules)

    def fn(params, c, t, p):
        return decode_step(params, c, t, p, cfg, mesh=mesh,
                           moe_impl=moe_impl or "dense", rules=rules,
                           cache_len=dec_len,
                           enc_len=seq if cfg.is_encdec else 0)

    return CellSpec(arch, shape, mode, fn, (p_specs, cache, tok, pos),
                    (p_shard, cache_shard, tok_shard, pos_shard),
                    donate=(1,), tokens_per_step=batch, meta=meta,
                    rules=rules)


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
