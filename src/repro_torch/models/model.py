"""Port of ``src/repro/models/model.py``: parameters, caches and prefill of
the composable model stack.

The parameter tree is the reference's: ``embed``, ``final_ln``,
``scan.pos{i}`` (each leaf stacked over a leading ``n_repeats`` axis),
``rem`` (the remainder layers, a tuple) and ``lm_head`` unless the
embeddings are tied — so ``repro_torch.convert.lm_params`` maps a reference
tree leaf for leaf. The reference's ``lax.scan`` over repeats is a Python
loop here. ``forward_train``, ``loss_fn``, ``decode_step`` and the
encoder-decoder stack wait (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from . import blocks
from .layers import dense_init, rms_norm, softcap

__all__ = ["cache_specs", "init_cache", "init_params", "prefill"]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _no_encdec(cfg):
    if cfg.is_encdec:
        raise NotImplementedError(
            f"the encoder-decoder stack {blocks.WAITS}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stack_init(generator, cfg, kinds, dtype, n: int, device):
    """Stacked params for n repeats of the given pattern positions."""
    reps = [{f"pos{i}": blocks.block_init(generator, cfg, kind, dtype,
                                          device=device)
             for i, kind in enumerate(kinds)} for _ in range(n)]
    return _tree_map(lambda *xs: torch.stack(xs), *reps)


def init_params(generator, cfg, device=None):
    """Random parameters of ``cfg`` drawn from ``generator`` (a
    ``torch.Generator`` on ``device``, which defaults to the generator's)."""
    _no_encdec(cfg)
    dtype = _dtype(cfg)
    device = torch.device(device) if device is not None else generator.device
    d = cfg.d_model
    params = {
        "embed": dense_init(generator, (cfg.vocab_size, d), scale=0.02,
                            dtype=dtype, device=device),
        "final_ln": torch.zeros((d,), dtype=dtype, device=device),
    }
    params["scan"] = _stack_init(generator, cfg, cfg.block_pattern, dtype,
                                 cfg.n_repeats, device)
    rem = cfg.remainder_kinds
    if rem:
        params["rem"] = tuple(
            blocks.block_init(generator, cfg, kind, dtype, device=device)
            for kind in rem)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (d, cfg.vocab_size),
                                       scale=0.02, dtype=dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# serving: prefill
# ---------------------------------------------------------------------------

def cache_specs(cfg, batch: int, cache_len: int):
    """Shape/dtype tree of the KV cache (``TensorSpec`` leaves)."""
    _no_encdec(cfg)
    dtype = _dtype(cfg)

    def stack(spec):
        return {k: type(s)((cfg.n_repeats,) + s.shape, s.dtype)
                for k, s in spec.items()}

    cache = {"scan": {
        f"pos{i}": stack(blocks.block_cache_spec(cfg, kind, batch, cache_len,
                                                 dtype))
        for i, kind in enumerate(cfg.block_pattern)}}
    rem = cfg.remainder_kinds
    if rem:
        cache["rem"] = tuple(
            blocks.block_cache_spec(cfg, kind, batch, cache_len, dtype)
            for kind in rem)
    return cache


def init_cache(cfg, batch: int, cache_len: int, *, device="cuda"):
    specs = cache_specs(cfg, batch, cache_len)
    return _tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                           device=device), specs)


def prefill(params, batch, cfg, cache_len: int):
    """Full forward over the prompt; returns (last-token logits, cache)."""
    _no_encdec(cfg)
    tokens = batch["tokens"]
    x = params["embed"].index_select(0, tokens.reshape(-1)).reshape(
        tuple(tokens.shape) + (cfg.d_model,))
    per_rep = []
    for r in range(cfg.n_repeats):
        caches = {}
        for i, kind in enumerate(cfg.block_pattern):
            rep = _tree_map(lambda t, r=r: t[r], params["scan"][f"pos{i}"])
            x, caches[f"pos{i}"] = blocks.block_prefill(rep, x, cfg, kind,
                                                        cache_len)
        per_rep.append(caches)
    cache = {"scan": _tree_map(lambda *xs: torch.stack(xs), *per_rep)}
    if params.get("rem"):
        rem_caches = []
        for p, kind in zip(params["rem"], cfg.remainder_kinds):
            x, c = blocks.block_prefill(p, x, cfg, kind, cache_len)
            rem_caches.append(c)
        cache["rem"] = tuple(rem_caches)
    x = rms_norm(x[:, -1:], params["final_ln"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = softcap(x @ head, cfg.logit_softcap)
    return logits[:, 0], cache
