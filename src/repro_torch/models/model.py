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
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..tree import tree_map
from . import blocks
from .layers import cross_entropy, dense_init, rms_norm, softcap

__all__ = ["cache_specs", "decode_step", "forward_train", "init_cache",
           "init_params", "loss_fn", "param_specs", "prefill"]


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


def _encode(params, enc_input, cfg):
    """Reference ``_encode`` (model.py:102): the stub frame embeddings
    through the input adapter, the bidirectional "attn" stack (RoPE,
    ``causal=False``) and the encoder's final norm."""
    x = enc_input.to(_dtype(cfg)) @ params["enc_in_proj"]

    def body(h, rep):
        return blocks.block_train(rep, h, cfg, "attn", causal=False)
    body = _maybe_remat(body, cfg)
    stack = params["enc"]["scan"]["pos0"]
    for r in range(cfg.encoder_layers):
        x = body(x, _repeat(stack, r))
    return rms_norm(x, params["enc"]["final_ln"], cfg.norm_eps)


def _embed(params, tokens, cfg):
    """The token embeddings (``jnp.take`` in the reference). Its gradient is
    ``F.embedding``'s: each row's contributions summed in float32 in a
    fixed order, where ``index_select``'s backward adds them with atomics
    in the table's type (bf16 at full width, where a frequent token's row
    sums thousands of contributions)."""
    return F.embedding(tokens.long(), params["embed"])


def _head(params, x, cfg):
    """The final norm, the tied or untied head and the soft cap."""
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap(x @ head, cfg.logit_softcap)


def _frames(params, batch, cfg):
    """An encoder-decoder's encoded ``batch["enc_input"]``, else None."""
    if not cfg.is_encdec:
        return None
    if "enc_input" not in batch:
        raise ValueError(f"{cfg.name} is an encoder-decoder: it needs "
                         "batch['enc_input'], the (B, frames, d_model) "
                         "frame embeddings")
    return _encode(params, batch["enc_input"], cfg)


def forward_train(params, batch, cfg, *, mesh=None, moe_impl=None):
    """Reference ``forward_train`` (model.py:116): the logits (B, T, vocab)
    of ``batch["tokens"]`` (B, T) at every position, differentiable. An
    encoder-decoder first encodes ``batch["enc_input"]``. Each repeat of
    the block pattern is one ``_maybe_remat`` body. With no mesh an MoE
    FFN is the dense form, as the reference's on one device; over a
    ``DeviceMesh`` ``params`` and ``batch`` are this rank's shards and an
    MoE FFN takes the form ``moe_impl`` (``models/moe.py::moe_apply``)."""
    enc = _frames(params, batch, cfg)
    x = _embed(params, batch["tokens"], cfg)

    def body(h, rep):
        for i, kind in enumerate(cfg.block_pattern):
            h = blocks.block_train(rep[f"pos{i}"], h, cfg, kind, mesh=mesh,
                                   moe_impl=moe_impl, enc=enc)
        return h
    body = _maybe_remat(body, cfg)
    for r in range(cfg.n_repeats):
        x = body(x, _repeat(params["scan"], r))
    for p, kind in zip(params.get("rem", ()), cfg.remainder_kinds):
        x = blocks.block_train(p, x, cfg, kind, mesh=mesh, moe_impl=moe_impl,
                               enc=enc)
    return _head(params, x, cfg)


def loss_fn(params, batch, cfg, *, mesh=None, moe_impl=None):
    """Reference ``loss_fn`` (model.py:145): the token CE of
    :func:`forward_train`'s logits against ``batch["labels"]`` → (loss,
    {"loss": loss})."""
    loss = cross_entropy(forward_train(params, batch, cfg, mesh=mesh,
                                       moe_impl=moe_impl), batch["labels"])
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

def cache_specs(cfg, batch: int, cache_len: int, *, enc_len: int = 0):
    """Shape/dtype tree of the KV and state cache (``TensorSpec`` leaves);
    an encoder-decoder's blocks add the cross cache of ``enc_len`` encoder
    positions. Reference ``cache_specs`` (model.py:155)."""
    dtype = _dtype(cfg)
    cross_len = enc_len if cfg.is_encdec else 0

    def stack(spec):
        return tree_map(lambda s: type(s)((cfg.n_repeats,) + s.shape,
                                           s.dtype), spec)

    cache = {"scan": {
        f"pos{i}": stack(blocks.block_cache_spec(cfg, kind, batch, cache_len,
                                                 dtype, cross_len=cross_len))
        for i, kind in enumerate(cfg.block_pattern)}}
    rem = cfg.remainder_kinds
    if rem:
        cache["rem"] = tuple(
            blocks.block_cache_spec(cfg, kind, batch, cache_len, dtype,
                                    cross_len=cross_len)
            for kind in rem)
    return cache


def init_cache(cfg, batch: int, cache_len: int, *, enc_len: int = 0,
               device="cuda"):
    """Reference ``init_cache`` (model.py:178): the zero cache."""
    specs = cache_specs(cfg, batch, cache_len, enc_len=enc_len)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                           device=device), specs)


def prefill(params, batch, cfg, cache_len: int):
    """Full forward over the prompt; returns (last-token logits, cache).
    Reference ``prefill`` (model.py:183): an encoder-decoder first encodes
    ``batch["enc_input"]`` (B, frames, d) and its decoder blocks attend to
    that. On one device, as the reference without a mesh: an MoE FFN is
    the dense form."""
    enc = _frames(params, batch, cfg)
    x = _embed(params, batch["tokens"], cfg)
    per_rep = []
    for r in range(cfg.n_repeats):
        caches = {}
        for i, kind in enumerate(cfg.block_pattern):
            rep = _repeat(params["scan"][f"pos{i}"], r)
            x, caches[f"pos{i}"] = blocks.block_prefill(rep, x, cfg, kind,
                                                        cache_len, enc=enc)
        per_rep.append(caches)
    cache = {"scan": tree_map(lambda *xs: torch.stack(xs), *per_rep)}
    if params.get("rem"):
        rem_caches = []
        for p, kind in zip(params["rem"], cfg.remainder_kinds):
            x, c = blocks.block_prefill(p, x, cfg, kind, cache_len, enc=enc)
            rem_caches.append(c)
        cache["rem"] = tuple(rem_caches)
    return _head(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params, cache, tokens, pos: int, cfg):
    """One decode step. Reference ``decode_step`` (model.py:216): tokens
    (B,) at absolute position ``pos`` (an int) → (logits (B, vocab), new
    cache). Each repeat's blocks decode against that repeat's cache, and
    the new caches are stacked again; then the remainder layers. The
    caller's cache is unchanged. An MoE FFN takes the dense form, as the
    reference's decode does."""
    x = _embed(params, tokens[:, None], cfg)
    per_rep = []
    for r in range(cfg.n_repeats):
        new = {}
        for i, kind in enumerate(cfg.block_pattern):
            rep, rc = tree_map(lambda t, r=r: t[r],
                                (params["scan"][f"pos{i}"],
                                 cache["scan"][f"pos{i}"]))
            x, new[f"pos{i}"] = blocks.block_decode(rep, x, rc, pos, cfg,
                                                    kind)
        per_rep.append(new)
    new_cache = {"scan": tree_map(lambda *xs: torch.stack(xs), *per_rep)}
    if params.get("rem"):
        rem_new = []
        for p, kind, c in zip(params["rem"], cfg.remainder_kinds,
                              cache["rem"]):
            x, nc = blocks.block_decode(p, x, c, pos, cfg, kind)
            rem_new.append(nc)
        new_cache["rem"] = tuple(rem_new)
    return _head(params, x, cfg)[:, 0], new_cache
