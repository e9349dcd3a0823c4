"""Port of ``src/repro/models/model.py``: parameters, caches, the training
forward and loss, prefill and decode of the composable model stack,
decoder-only or encoder-decoder.

The parameter tree is the reference's: ``embed``, ``final_ln``,
``scan.pos{i}`` (each leaf stacked over a leading ``n_repeats`` axis),
``rem`` (the remainder layers, a tuple), ``lm_head`` unless the
embeddings are tied, and for an encoder-decoder ``enc_in_proj`` and
``enc`` (``scan.pos0`` over the encoder layers, ``final_ln``) — so
``repro_torch.convert.lm_params`` maps a reference tree leaf for leaf. The
reference's ``lax.scan`` over repeats is a Python loop here; a stacked
leaf is read one repeat at a time (``leaf[r]``), so the training step may
hand in a sequence of per-repeat tensors instead
(``training/optimizer.py::split_repeats``). The training forward's
backward is autograd: each repeat's body is checkpointed as the reference
wraps its scan body (``_maybe_remat``), and K4's gradient is K4′
(``kernels/attn/attn.py::FlashAttention``). ``param_specs`` is
``init_params`` on the ``meta`` device.

Over a ``DeviceMesh`` (``mesh=``) the parameters and the batch are this
rank's shards: its rows of the batch (split over the data axes) and its
parameters in the compute layout
(``distributed/sharding.py::compute_shardings``). With a ``model`` axis of
several ranks the dense layers compute in their split forms
(``tp_plan``), and the vocabulary splits when the axis divides it: the
embedding looks up the rank's rows (ids outside them read zeros) and sums
over ``model``, the head computes the rank's columns, the loss is the
vocab-parallel cross-entropy, and the logits that ``forward_train``,
``prefill`` and ``decode_step`` return are whole on every rank (the sum of
the ranks' zero-padded blocks).

The entry points take the reference's axis ``rules`` (``rules=``, the
mapping its ``axis_rules`` context holds, as ``launch/specs.py``'s cells
set them) and hand what they decide down: ``seq_sp`` → ``model`` puts the
training forward's residual in Megatron-SP's layout (each rank its block
of the sequence; the embedding leaves by ``seq_exit``, the head gathers
after the final norm; the encoder keeps ``seq``), ``fsdp`` names the data
axes the MoE expert stacks are stored split over (ZeRO-3), and
``seq_kv`` puts the decode cache in the sequence-split layout
(``KVSplit``: every KV head, the rank's block of the slots).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..distributed.collectives import all_reduce
from ..distributed.sharding import fsdp_axes, kv_split, seq_parallel, tp_plan
from ..tree import tree_map
from . import blocks
from .layers import cross_entropy_sums, dense_init, rms_norm, softcap

__all__ = ["cache_specs", "decode_step", "forward_train", "init_cache",
           "init_params", "loss_fn", "loss_sums", "param_specs", "prefill"]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stack_init(generator, cfg, kinds, dtype, n: int, device, *,
                cross: bool = False):
    """Stacked params for n repeats of the given pattern positions, drawn
    repeat by repeat into the stacked tensors (so the peak is the stack
    plus one repeat, not twice the stack)."""
    stacked = None
    for r in range(n):
        rep = {f"pos{i}": blocks.block_init(generator, cfg, kind, dtype,
                                            cross=cross, device=device)
               for i, kind in enumerate(kinds)}
        if stacked is None:
            stacked = tree_map(
                lambda t: t.new_empty((n,) + tuple(t.shape)), rep)
        tree_map(lambda dst, src, r=r: dst[r].copy_(src), stacked, rep)
    return stacked


def init_params(generator, cfg, device=None):
    """Random parameters of ``cfg`` drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, which defaults to the generator's).
    Reference ``init_params`` (model.py:49)."""
    dtype = _dtype(cfg)
    device = torch.device(device) if device is not None else generator.device
    d = cfg.d_model
    params = {
        "embed": dense_init(generator, (cfg.vocab_size, d), scale=0.02,
                            dtype=dtype, device=device),
        "final_ln": torch.zeros((d,), dtype=dtype, device=device),
    }
    cross = cfg.is_encdec
    params["scan"] = _stack_init(generator, cfg, cfg.block_pattern, dtype,
                                 cfg.n_repeats, device, cross=cross)
    rem = cfg.remainder_kinds
    if rem:
        params["rem"] = tuple(
            blocks.block_init(generator, cfg, kind, dtype, cross=cross,
                              device=device)
            for kind in rem)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (d, cfg.vocab_size),
                                       scale=0.02, dtype=dtype, device=device)
    if cfg.is_encdec:
        params["enc_in_proj"] = dense_init(generator, (d, d), dtype=dtype,
                                           device=device)
        params["enc"] = {
            "scan": _stack_init(generator, cfg, ("attn",), dtype,
                                cfg.encoder_layers, device),
            "final_ln": torch.zeros((d,), dtype=dtype, device=device),
        }
    return params


def param_specs(cfg):
    """Reference ``param_specs`` (model.py:80): the parameter tree of
    ``cfg`` as ``meta`` tensors — shapes and dtypes, nothing allocated."""
    return init_params(torch.Generator(), cfg, device="meta")


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------

def _repeat(stack, r: int):
    """Repeat ``r`` of a stacked subtree: every leaf indexed ``[r]`` (a
    stacked tensor, or a sequence of per-repeat tensors)."""
    if isinstance(stack, dict):
        return {k: _repeat(v, r) for k, v in stack.items()}
    return stack[r]


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """``"dots_no_batch"``: keep the 2-D matrix products (the projections
    and FFNs, JAX's dots with no batch dimensions) and recompute the rest,
    batched products (attention's einsums) included."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg):
    """Reference ``_maybe_remat`` (model.py:90): with ``cfg.remat``, ``fn``
    (one repeat's body) under ``torch.utils.checkpoint`` (non-reentrant),
    so the backward recomputes it. ``remat_policy="nothing"`` saves only
    its inputs, the layer-boundary residual stream; ``"dots_no_batch"``
    also saves its 2-D matrix products. Without grad mode ``fn`` runs as
    it is."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "dots_no_batch":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_matmuls)
    elif cfg.remat_policy == "nothing":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def body(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return body


def _encode(params, enc_input, cfg, mesh=None, fsdp=()):
    """Reference ``_encode`` (model.py:102): the stub frame embeddings
    through the input adapter, the bidirectional "attn" stack (RoPE,
    ``causal=False``) and the encoder's final norm. Its sequence stays
    whole under Megatron-SP (``seq``, as the reference constrains it)."""
    x = enc_input.to(_dtype(cfg)) @ params["enc_in_proj"]

    def body(h, rep):
        return blocks.block_train(rep, h, cfg, "attn", mesh=mesh,
                                  causal=False, fsdp=fsdp)
    body = _maybe_remat(body, cfg)
    stack = params["enc"]["scan"]["pos0"]
    for r in range(cfg.encoder_layers):
        x = body(x, _repeat(stack, r))
    return rms_norm(x, params["enc"]["final_ln"], cfg.norm_eps)


def _vocab(tp) -> bool:
    return tp is not None and tp.vocab


def _embed(params, tokens, cfg, tp=None):
    """The token embeddings (``jnp.take`` in the reference). Its gradient is
    ``F.embedding``'s: each row's contributions summed in float32 in a
    fixed order, where ``index_select``'s backward adds them with atomics
    in the table's type (bf16 at full width, where a frequent token's row
    sums thousands of contributions). Vocab-parallel under the plan ``tp``:
    ids outside the rank's rows read zeros (and add nothing to the
    gradient), and the ranks' lookups are summed over ``model``, one
    nonzero term an element. Under Megatron-SP the rank keeps its block of
    the sequence (``TPPlan.leave``)."""
    tokens = tokens.long()
    if not _vocab(tp):
        x = F.embedding(tokens, params["embed"])
        return x if tp is None else tp.leave(x, False)
    rows = params["embed"].shape[0]
    local = tokens - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(mine, local, 0), params["embed"])
    return tp.leave(x * mine[..., None].to(x.dtype), True)


def _head(params, x, cfg, tp=None):
    """The final norm, the tied or untied head and the soft cap (the
    rank's block of the vocabulary where its head is a block). Under
    Megatron-SP the norm runs on the rank's block of the sequence, which
    is then gathered."""
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    if tp is not None:
        x = tp.enter(x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.logit_softcap)


def _whole(logits, tp):
    """The whole vocabulary's logits from each rank's block: the sum over
    ``model`` of the blocks zero-padded to their places (exact, in
    float32; ``all_gather`` would do, but gloo carries only sums on CUDA
    tensors). Differentiable."""
    if not _vocab(tp):
        return logits
    v = logits.shape[-1]
    full = F.pad(logits.float(), (tp.rank * v, (tp.n - 1 - tp.rank) * v))
    return all_reduce(full, tp.mesh, "model").to(logits.dtype)


def _frames(params, batch, cfg, mesh=None, fsdp=()):
    """An encoder-decoder's encoded ``batch["enc_input"]``, else None."""
    if not cfg.is_encdec:
        return None
    if "enc_input" not in batch:
        raise ValueError(f"{cfg.name} is an encoder-decoder: it needs "
                         "batch['enc_input'], the (B, frames, d_model) "
                         "frame embeddings")
    return _encode(params, batch["enc_input"], cfg, mesh, fsdp)


def _logits(params, batch, cfg, mesh, moe_impl, rules):
    """The training forward to the head: (this rank's logits, the plan).
    Under Megatron-SP the residual, and so the remat-saved carry, is the
    rank's block of the sequence."""
    sp = seq_parallel(mesh, rules)
    tp = tp_plan(cfg, mesh, sp=sp)
    fsdp = fsdp_axes(mesh, rules)
    t = batch["tokens"].shape[1]
    if sp and t % tp.n:
        raise ValueError(f"Megatron-SP splits the sequence over the "
                         f"{tp.n}-way model axis: T = {t} does not divide")
    enc = _frames(params, batch, cfg, mesh, fsdp)
    x = _embed(params, batch["tokens"], cfg, tp)

    def body(h, rep):
        for i, kind in enumerate(cfg.block_pattern):
            h = blocks.block_train(rep[f"pos{i}"], h, cfg, kind, mesh=mesh,
                                   moe_impl=moe_impl, enc=enc, sp=sp,
                                   fsdp=fsdp)
        return h
    body = _maybe_remat(body, cfg)
    for r in range(cfg.n_repeats):
        x = body(x, _repeat(params["scan"], r))
    for p, kind in zip(params.get("rem", ()), cfg.remainder_kinds):
        x = blocks.block_train(p, x, cfg, kind, mesh=mesh, moe_impl=moe_impl,
                               enc=enc, sp=sp, fsdp=fsdp)
    return _head(params, x, cfg, tp), tp


def forward_train(params, batch, cfg, *, mesh=None, moe_impl=None,
                  rules=None):
    """Reference ``forward_train`` (model.py:116): the logits (B, T, vocab)
    of ``batch["tokens"]`` (B, T) at every position, differentiable. An
    encoder-decoder first encodes ``batch["enc_input"]``. Each repeat of
    the block pattern is one ``_maybe_remat`` body. With no mesh an MoE
    FFN is the dense form, as the reference's on one device; over a
    ``DeviceMesh`` ``params`` and ``batch`` are this rank's shards, an
    MoE FFN takes the form ``moe_impl`` (``models/moe.py::moe_apply``),
    the dense layers their split forms, and the logits are whole.
    ``rules`` as the module says (``seq_sp``, ``fsdp``)."""
    logits, tp = _logits(params, batch, cfg, mesh, moe_impl, rules)
    return _whole(logits, tp)


def loss_sums(params, batch, cfg, *, mesh=None, moe_impl=None, rules=None):
    """The token CE of ``batch`` summed over its labels that are not -100,
    and their count (``layers.py::cross_entropy_sums``), float32 0-d; over
    a mesh the vocab-parallel CE of this rank's rows, the same on every
    rank of ``model``."""
    logits, tp = _logits(params, batch, cfg, mesh, moe_impl, rules)
    return cross_entropy_sums(logits, batch["labels"], tp=tp)


def loss_fn(params, batch, cfg, *, mesh=None, moe_impl=None, rules=None):
    """Reference ``loss_fn`` (model.py:145): the token CE of
    :func:`forward_train`'s logits against ``batch["labels"]`` → (loss,
    {"loss": loss}); the mean over the labels that are not -100 (0 when
    all are)."""
    total, count = loss_sums(params, batch, cfg, mesh=mesh,
                             moe_impl=moe_impl, rules=rules)
    loss = total / torch.clamp(count, min=1.0)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

def cache_specs(cfg, batch: int, cache_len: int, *, enc_len: int = 0,
                mesh=None, rules=None):
    """Shape/dtype tree of the KV and state cache (``TensorSpec`` leaves);
    an encoder-decoder's blocks add the cross cache of ``enc_len`` encoder
    positions. Reference ``cache_specs`` (model.py:155). With ``mesh``, the
    cache of ``batch`` rows as this rank holds it: its KV heads, RG-LRU
    channels and RWKV heads (``distributed/sharding.py::tp_plan``); where
    ``rules`` map ``seq_kv`` to the mesh, every KV head for its block of
    the KV caches' slots (``KVSplit``)."""
    dtype = _dtype(cfg)
    cross_len = enc_len if cfg.is_encdec else 0
    tp = tp_plan(cfg, mesh)
    kv = kv_split(mesh, rules, cache_len, cross_len)

    def stack(spec):
        return tree_map(lambda s: type(s)((cfg.n_repeats,) + s.shape,
                                           s.dtype), spec)

    cache = {"scan": {
        f"pos{i}": stack(blocks.block_cache_spec(cfg, kind, batch, cache_len,
                                                 dtype, cross_len=cross_len,
                                                 tp=tp, kv=kv))
        for i, kind in enumerate(cfg.block_pattern)}}
    rem = cfg.remainder_kinds
    if rem:
        cache["rem"] = tuple(
            blocks.block_cache_spec(cfg, kind, batch, cache_len, dtype,
                                    cross_len=cross_len, tp=tp, kv=kv)
            for kind in rem)
    return cache


def init_cache(cfg, batch: int, cache_len: int, *, enc_len: int = 0,
               device="cuda", mesh=None, rules=None):
    """Reference ``init_cache`` (model.py:178): the zero cache (this rank's
    with ``mesh``, laid out as ``rules`` say)."""
    specs = cache_specs(cfg, batch, cache_len, enc_len=enc_len, mesh=mesh,
                        rules=rules)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                           device=device), specs)


def prefill(params, batch, cfg, cache_len: int, *, mesh=None,
            moe_impl=None, rules=None):
    """Full forward over the prompt; returns (last-token logits, cache).
    Reference ``prefill`` (model.py:183): an encoder-decoder first encodes
    ``batch["enc_input"]`` (B, frames, d) and its decoder blocks attend to
    that. With no mesh an MoE FFN is the dense form, as the reference's on
    one device; over a ``DeviceMesh`` ``params`` and ``batch`` are this
    rank's shards, an MoE FFN takes the form ``moe_impl``, the dense layers
    their split forms, the cache is this rank's (``cache_specs(...,
    mesh=, rules=)``) and the logits are whole."""
    tp = tp_plan(cfg, mesh)
    fsdp = fsdp_axes(mesh, rules)
    enc = _frames(params, batch, cfg, mesh, fsdp)
    kv = kv_split(mesh, rules, cache_len,
                  enc.shape[1] if enc is not None else 0)
    x = _embed(params, batch["tokens"], cfg, tp)
    per_rep = []
    for r in range(cfg.n_repeats):
        caches = {}
        for i, kind in enumerate(cfg.block_pattern):
            rep = _repeat(params["scan"][f"pos{i}"], r)
            x, caches[f"pos{i}"] = blocks.block_prefill(
                rep, x, cfg, kind, cache_len, mesh=mesh, moe_impl=moe_impl,
                enc=enc, fsdp=fsdp, kv=kv)
        per_rep.append(caches)
    cache = {"scan": tree_map(lambda *xs: torch.stack(xs), *per_rep)}
    if params.get("rem"):
        rem_caches = []
        for p, kind in zip(params["rem"], cfg.remainder_kinds):
            x, c = blocks.block_prefill(p, x, cfg, kind, cache_len,
                                        mesh=mesh, moe_impl=moe_impl,
                                        enc=enc, fsdp=fsdp, kv=kv)
            rem_caches.append(c)
        cache["rem"] = tuple(rem_caches)
    return _whole(_head(params, x[:, -1:], cfg), tp)[:, 0], cache


def decode_step(params, cache, tokens, pos: int, cfg, *, mesh=None,
                moe_impl="dense", rules=None, cache_len: int | None = None,
                enc_len: int = 0):
    """One decode step. Reference ``decode_step`` (model.py:216): tokens
    (B,) at absolute position ``pos`` (an int) → (logits (B, vocab), new
    cache). Each repeat's blocks decode against that repeat's cache, and
    the new caches are stacked again; then the remainder layers. The
    caller's cache is unchanged. An MoE FFN takes the form ``moe_impl``,
    the dense form by default, as the reference's decode does; over a
    ``DeviceMesh`` the arguments are this rank's shards (the cache as
    :func:`prefill` returns it there with the same ``rules``) and the
    logits are whole. Where ``rules`` split the cache by sequence
    (``seq_kv``), ``cache_len`` and an encoder-decoder's ``enc_len`` are
    the whole caches' lengths, which a rank's block does not tell."""
    tp = tp_plan(cfg, mesh)
    fsdp = fsdp_axes(mesh, rules)
    kv = kv_split(mesh, rules, cache_len, enc_len)
    x = _embed(params, tokens[:, None], cfg, tp)
    per_rep = []
    for r in range(cfg.n_repeats):
        new = {}
        for i, kind in enumerate(cfg.block_pattern):
            rep, rc = tree_map(lambda t, r=r: t[r],
                                (params["scan"][f"pos{i}"],
                                 cache["scan"][f"pos{i}"]))
            x, new[f"pos{i}"] = blocks.block_decode(
                rep, x, rc, pos, cfg, kind, mesh=mesh, moe_impl=moe_impl,
                fsdp=fsdp, kv=kv)
        per_rep.append(new)
    new_cache = {"scan": tree_map(lambda *xs: torch.stack(xs), *per_rep)}
    if params.get("rem"):
        rem_new = []
        for p, kind, c in zip(params["rem"], cfg.remainder_kinds,
                              cache["rem"]):
            x, nc = blocks.block_decode(p, x, c, pos, cfg, kind, mesh=mesh,
                                        moe_impl=moe_impl, fsdp=fsdp, kv=kv)
            rem_new.append(nc)
        new_cache["rem"] = tuple(rem_new)
    return _whole(_head(params, x, cfg), tp)[:, 0], new_cache
