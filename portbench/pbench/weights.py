"""The benchmark's weights, inputs and decode caches, drawn from the seed
on the device. Both the program and the plain reference take them from
here; nothing is read from the program.

The parameter tree is the port's layout (``models/model.py``: ``embed``,
``final_ln``, ``scan.pos0`` stacked over the layers, ``lm_head``), written
out from the configuration alone so that the reference can draw the same
tree without importing the program; the harness holds it against the
program's ``param_specs`` before a run. Each leaf is one call of the
generator, seeded by the run's seed and the leaf's place, in the type the
model is served in.
"""

from __future__ import annotations

import numpy as np
import torch

_MIX = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit seed for leaf ``index`` of a run seeded ``seed``."""
    return ((seed * _MIX) ^ (index + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)


def _attn_layout(c: dict) -> dict:
    d, dh, ff, v = c["d_model"], c["d_head"], c["d_ff"], c["vocab_size"]
    hq, hkv = c["n_heads"], c["n_kv_heads"]
    return {
        "embed": ((v, d), ("normal", 0.02)),
        "final_ln": ((d,), ("normal", 0.1)),
        "lm_head": ((d, v), ("normal", 0.02)),
        "scan.pos0.ln1": ((d,), ("normal", 0.1)),
        "scan.pos0.ln2": ((d,), ("normal", 0.1)),
        "scan.pos0.attn.wq": ((d, hq * dh), ("fan_in",)),
        "scan.pos0.attn.wk": ((d, hkv * dh), ("fan_in",)),
        "scan.pos0.attn.wv": ((d, hkv * dh), ("fan_in",)),
        "scan.pos0.attn.wo": ((hq * dh, d), ("fan_in",)),
        "scan.pos0.ffn.w_gate": ((d, ff), ("fan_in",)),
        "scan.pos0.ffn.w_up": ((d, ff), ("fan_in",)),
        "scan.pos0.ffn.w_down": ((ff, d), ("fan_in",)),
    }


def _rwkv_layout(c: dict) -> dict:
    d, ff, v = c["d_model"], c["d_ff"], c["vocab_size"]
    n = c["rwkv_head_dim"]
    t, ch = "scan.pos0.time.", "scan.pos0.channel."
    out = {
        "embed": ((v, d), ("normal", 0.02)),
        "final_ln": ((d,), ("normal", 0.1)),
        "lm_head": ((d, v), ("normal", 0.02)),
        "scan.pos0.ln1": ((d,), ("normal", 0.1)),
        "scan.pos0.ln2": ((d,), ("normal", 0.1)),
        t + "w0": ((d,), ("uniform", -6.0, -1.0)),
        t + "w_lora_a": ((d, 64), ("fan_in",)),
        t + "w_lora_b": ((64, d), ("normal", 0.01)),
        t + "u": ((d // n, n), ("normal", 0.5)),
        t + "ln_x": ((d,), ("uniform", 0.5, 1.5)),
        ch + "w_k": ((d, ff), ("fan_in",)),
        ch + "w_v": ((ff, d), ("fan_in",)),
        ch + "w_r": ((d, d), ("fan_in",)),
    }
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        out[t + name] = ((d,), ("uniform", 0.0, 1.0))
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        out[t + name] = ((d, d), ("fan_in",))
    for name in ("mu_k", "mu_r"):
        out[ch + name] = ((d,), ("uniform", 0.0, 1.0))
    return out


def layout(c: dict) -> dict:
    """``{dotted path: (shape, draw)}`` of the port's parameter tree for
    the configuration ``c`` (its ``port`` keys); a leaf under ``scan`` has
    a leading axis of ``n_layers`` more."""
    if tuple(c["block_pattern"]) == ("rwkv",):
        return _rwkv_layout(c)
    if tuple(c["block_pattern"]) == ("attn",):
        return _attn_layout(c)
    raise ValueError(f"no weight layout for the pattern "
                     f"{c['block_pattern']!r}")


def _draw(shape, how, gen, dtype, device):
    if how[0] == "uniform":
        lo, hi = how[1], how[2]
        x = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return (x * (hi - lo) + lo).to(dtype)
    x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    scale = shape[-2] ** -0.5 if how[0] == "fan_in" else how[1]
    return x.mul_(scale)


def draw_params(c: dict, seed: int, device, dtype=None) -> dict:
    """The parameter tree of ``c`` drawn from ``seed`` on ``device``, in
    ``c["param_dtype"]`` (or ``dtype``)."""
    dtype = dtype or getattr(torch, c["param_dtype"])
    tree: dict = {}
    for i, (path, (shape, how)) in enumerate(sorted(layout(c).items())):
        if path.startswith("scan."):
            shape = (c["n_layers"],) + shape
        gen = torch.Generator(device=device)
        gen.manual_seed(leaf_seed(seed, i))
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _draw(shape, how, gen, dtype, device)
    return tree


def flat(tree, prefix: str = "") -> dict:
    """``{dotted path: tensor}`` of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, p + "."))
        else:
            out[p] = v
    return out


# ---------------------------------------------------------------- inputs

def zipf_tokens(seed: int, stream: int, rows: int, t: int, vocab: int,
                a: float) -> np.ndarray:
    """(rows, t) int64 token ids drawn from a Zipf law of exponent ``a``
    folded onto [1, vocab - 1), as ``data/pipeline.py::TokenStream``
    draws them (without its copy task); pure in (seed, stream)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, stream]))
    z = rng.zipf(a, size=(rows, t))
    return ((z % (vocab - 2)) + 1).astype(np.int64)


def draw_kv_cache(c: dict, seed: int, batch: int, cache_len: int, device,
                  dtype=None) -> dict:
    """A full attention cache ``{"k", "v"}`` of (n_layers, B, cache_len,
    n_kv_heads, d_head), unit normal from ``seed``, one generator call a
    leaf."""
    dtype = dtype or getattr(torch, c["param_dtype"])
    shape = (c["n_layers"], batch, cache_len, c["n_kv_heads"], c["d_head"])
    out = {}
    for i, name in enumerate(("k", "v")):
        gen = torch.Generator(device=device)
        gen.manual_seed(leaf_seed(seed, 1000 + i))
        out[name] = torch.randn(shape, generator=gen, device=device,
                                dtype=dtype)
    return out
