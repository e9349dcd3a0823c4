"""Port of ``src/repro/models/layers.py``: norms, MLPs, rotary embeddings.

Initialisers draw from an explicit ``torch.Generator`` on the target device
(the counterpart of a ``jax.random`` key); the two frameworks give different
numbers from one seed, so tests carry weights across with
``repro_torch.convert.lm_params``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "rms_norm", "mlp_init", "mlp_apply",
           "rotary_cos_sin", "apply_rotary", "softcap", "cross_entropy",
           "cross_entropy_sums"]


def dense_init(generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None):
    """Truncated-normal fan-in init (LeCun-style) used for all projections:
    a standard normal cut at ±2 (no variance correction), drawn in float32,
    times ``scale``, then cast — as ``jax.random.truncated_normal``."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
    w = torch.empty(shape, dtype=torch.float32,
                    device=device or generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm in float32 with a ``(1 + w)`` weight, cast back to x's type."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + weight.float())).to(dt)


# --- gated / plain MLPs -----------------------------------------------------

def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_init(generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32, device=None):
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, (d_model, d_ff), dtype=dtype,
                                 device=device),
            "w_up": dense_init(generator, (d_model, d_ff), dtype=dtype,
                               device=device),
            "w_down": dense_init(generator, (d_ff, d_model), dtype=dtype,
                                 device=device),
        }
    return {
        "w_up": dense_init(generator, (d_model, d_ff), dtype=dtype,
                           device=device),
        "w_down": dense_init(generator, (d_ff, d_model), dtype=dtype,
                             device=device),
    }


def mlp_apply(params, x, kind: str):
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    return _gelu(x @ params["w_up"]) @ params["w_down"]


# --- rotary position embeddings ----------------------------------------------

def rotary_cos_sin(positions, d_rot: int, theta: float):
    """cos/sin tables for rotary dims. positions (...,) → (..., d_rot/2)."""
    inv = 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                        device=positions.device) / d_rot))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin, fraction: float = 1.0):
    """x (..., T, H, Dh); cos/sin (..., T, d_rot/2) broadcast over heads.

    ``fraction < 1`` rotates only the first ``fraction·Dh`` dims (chatglm3's
    2d-RoPE keeps half of the head dims position-free). Pairs are
    interleaved (dims 0::2 with 1::2); cos and sin are cast to the
    activation type before the products.
    """
    dh = x.shape[-1]
    d_rot = int(dh * fraction) // 2 * 2
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., None, :].to(x.dtype)     # add head axis; keep activation dtype
    s = sin[..., None, :].to(x.dtype)
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    out = torch.cat([rot, xp], dim=-1) if d_rot < dh else rot
    return out.to(x.dtype)


def softcap(logits, cap: float):
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits


def cross_entropy_sums(logits, labels, ignore_id: int = -100):
    """The two sums of :func:`cross_entropy`: (the token CE summed over the
    labels that are not ``ignore_id``, their count), float32 0-d. A
    data-parallel step sums both over its ranks."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vocab == labels[..., None], logits, 0.0).sum(-1)
    mask = (labels != ignore_id).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def cross_entropy(logits, labels, ignore_id: int = -100):
    """Reference ``cross_entropy`` (layers.py:89): token-level CE in float32,
    the mean over the labels that are not ``ignore_id`` (0 when all are).
    The gold logit is the reference's mask reduction over the vocabulary,
    so a label outside it reads 0 rather than raising."""
    total, count = cross_entropy_sums(logits, labels, ignore_id)
    return total / torch.clamp(count, min=1.0)
