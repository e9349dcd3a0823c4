"""Port of ``src/repro/models/model.py``: parameters, caches, the training
forward and loss, prefill and decode of the composable model stack,
decoder-only or encoder-decoder.

The parameter tree is the reference's: ``embed``, ``final_ln``,
``scan.pos{i}`` (each leaf stacked over a leading ``n_repeats`` axis),
``rem`` (the remainder layers, a tuple), ``lm_head`` unless the
embeddings are tied, and for an encoder-decoder ``enc_in_proj`` and
``enc`` (``scan.pos0`` over the encoder layers, ``final_ln``) — so
``repro_torch.convert.lm_params`` maps a reference tree leaf for leaf. The
reference's ``lax.scan`` over repeats is a Python loop here. The
training forward is without its backward, ``_maybe_remat`` and
``param_specs`` (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from . import blocks
from .layers import cross_entropy, dense_init, rms_norm, softcap

__all__ = ["cache_specs", "decode_step", "forward_train", "init_cache",
           "init_params", "loss_fn", "prefill"]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


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
            stacked = _tree_map(
                lambda t: t.new_empty((n,) + tuple(t.shape)), rep)
        _tree_map(lambda dst, src, r=r: dst[r].copy_(src), stacked, rep)
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


def _encode(params, enc_input, cfg):
    """Reference ``_encode`` (model.py:102): the stub frame embeddings
    through the input adapter, the bidirectional "attn" stack (RoPE,
    ``causal=False``) and the encoder's final norm."""
    x = enc_input.to(_dtype(cfg)) @ params["enc_in_proj"]
    stack = params["enc"]["scan"]["pos0"]
    for r in range(cfg.encoder_layers):
        rep = _tree_map(lambda t, r=r: t[r], stack)
        x = blocks.block_train(rep, x, cfg, "attn", causal=False)
    return rms_norm(x, params["enc"]["final_ln"], cfg.norm_eps)


def _embed(params, tokens, cfg):
    return params["embed"].index_select(0, tokens.reshape(-1)).reshape(
        tuple(tokens.shape) + (cfg.d_model,))


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


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------

def forward_train(params, batch, cfg):
    """Reference ``forward_train`` (model.py:116), forward: the logits (B,
    T, vocab) of ``batch["tokens"]`` (B, T) at every position. An
    encoder-decoder first encodes ``batch["enc_input"]``. On one device, as
    the reference without a mesh: an MoE FFN is the dense form."""
    enc = _frames(params, batch, cfg)
    x = _embed(params, batch["tokens"], cfg)
    for r in range(cfg.n_repeats):
        for i, kind in enumerate(cfg.block_pattern):
            rep = _tree_map(lambda t, r=r: t[r], params["scan"][f"pos{i}"])
            x = blocks.block_train(rep, x, cfg, kind, enc=enc)
    for p, kind in zip(params.get("rem", ()), cfg.remainder_kinds):
        x = blocks.block_train(p, x, cfg, kind, enc=enc)
    return _head(params, x, cfg)


def loss_fn(params, batch, cfg):
    """Reference ``loss_fn`` (model.py:145), forward value: the token CE of
    :func:`forward_train`'s logits against ``batch["labels"]`` → (loss,
    {"loss": loss})."""
    loss = cross_entropy(forward_train(params, batch, cfg), batch["labels"])
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
        return _tree_map(lambda s: type(s)((cfg.n_repeats,) + s.shape,
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
    return _tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
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
            rep = _tree_map(lambda t, r=r: t[r], params["scan"][f"pos{i}"])
            x, caches[f"pos{i}"] = blocks.block_prefill(rep, x, cfg, kind,
                                                        cache_len, enc=enc)
        per_rep.append(caches)
    cache = {"scan": _tree_map(lambda *xs: torch.stack(xs), *per_rep)}
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
            rep, rc = _tree_map(lambda t, r=r: t[r],
                                (params["scan"][f"pos{i}"],
                                 cache["scan"][f"pos{i}"]))
            x, new[f"pos{i}"] = blocks.block_decode(rep, x, rc, pos, cfg,
                                                    kind)
        per_rep.append(new)
    new_cache = {"scan": _tree_map(lambda *xs: torch.stack(xs), *per_rep)}
    if params.get("rem"):
        rem_new = []
        for p, kind, c in zip(params["rem"], cfg.remainder_kinds,
                              cache["rem"]):
            x, nc = blocks.block_decode(p, x, c, pos, cfg, kind)
            rem_new.append(nc)
        new_cache["rem"] = tuple(rem_new)
    return _head(params, x, cfg)[:, 0], new_cache
