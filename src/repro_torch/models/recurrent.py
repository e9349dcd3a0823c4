"""Port of ``src/repro/models/recurrent.py``: the RG-LRU recurrent block
(Griffin / RecurrentGemma) in chunked form, for prefill.

The diagonal linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t`` is evaluated
as the reference evaluates it: an associative scan within each chunk (the
same odd/even recursion as ``jax.lax.associative_scan``, for all chunks at
once), then a sequential pass over the chunks carrying the state. Block
structure (Griffin Fig. 2): a gate branch GeLU(W_y x) and a value branch
(width-4 causal conv → RG-LRU), merged multiplicatively and projected back
by W_o. Decode is the single-step update. Plain PyTorch, as the reference
is jnp outside any Pallas kernel.

Under dense tensor parallelism (a ``TPPlan`` ``tp`` whose ``rnn`` is set)
``w_x`` and ``w_y`` are this rank's columns of the recurrence width and
``w_o`` its rows; the per-channel leaves (the conv weights, the gates and
Λ) are whole, and the rank computes with its slice of them, so its
gradient of such a leaf is zero outside that slice and the step's sum of
the ranks' shares is the whole gradient. The state holds the rank's
channels; ``w_o``'s partial outputs are summed over ``model``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import TensorSpec
from .layers import _gelu, dense_init

__all__ = ["rglru_init", "rglru_train", "rglru_decode", "rglru_state_spec"]

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness constant


def rglru_init(generator, cfg, dtype=torch.float32, device=None):
    """Reference ``rglru_init`` (recurrent.py:28). Λ is uniform in
    (0.001, 0.1), so a = exp(-c·softplus(Λ)·σ(r)) spans about
    (0.9, 0.999)."""
    d, dr = cfg.d_model, cfg.d_rnn or cfg.d_model
    dev = device or generator.device
    lam = 0.001 + (0.1 - 0.001) * torch.rand(
        (dr,), generator=generator, dtype=torch.float32, device=dev)

    def zeros():
        return torch.zeros((dr,), dtype=dtype, device=dev)
    return {
        "w_x": dense_init(generator, (d, dr), dtype=dtype, device=dev),
        "w_y": dense_init(generator, (d, dr), dtype=dtype, device=dev),
        "w_o": dense_init(generator, (dr, d), dtype=dtype, device=dev),
        "conv_w": dense_init(generator, (cfg.conv_width, dr), dtype=dtype,
                             device=dev),
        "conv_b": zeros(),
        "gate_r_w": zeros(), "gate_r_b": zeros(),
        "gate_i_w": zeros(), "gate_i_b": zeros(),
        "lam": lam.to(dtype),
    }


def _rglru_coeffs(params, u):
    """Reference ``_rglru_coeffs`` (recurrent.py:45): per-step decay a_t and
    input b_t (float32) from the conv output u (..., dr). ``jax.nn.
    softplus`` has no threshold; ``F.softplus``'s (20) is never reached
    by Λ ∈ (0.001, 0.1)."""
    uf = u.float()
    r = torch.sigmoid(uf * params["gate_r_w"] + params["gate_r_b"])
    i = torch.sigmoid(uf * params["gate_i_w"] + params["gate_i_b"])
    log_a = -_C_RGLRU * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * uf)
    return a, b


def _conv_causal(u, w, b, carry=None):
    """Reference ``_conv_causal`` (recurrent.py:56): causal temporal conv of
    width W. u (B, T, dr); carry (B, W-1, dr) or None → (out, new carry)."""
    width = w.shape[0]
    if carry is None:
        carry = u.new_zeros((u.shape[0], width - 1, u.shape[2]))
    ext = torch.cat([carry, u], dim=1)
    out = sum(ext[:, width - 1 - j: ext.shape[1] - j] * w[width - 1 - j]
              for j in range(width))
    return out + b, ext[:, -(width - 1):]


def _combine(lhs, rhs):
    (a1, b1), (a2, b2) = lhs, rhs
    return a1 * a2, b1 * a2 + b2


def _interleave(even, odd, dim: int, n: int):
    """even[0], odd[0], even[1], ... along ``dim``: ``n`` elements (even
    has as many as odd, or one more)."""
    if odd.shape[dim] < even.shape[dim]:
        pad = list(odd.shape)
        pad[dim] = 1
        odd = torch.cat([odd, odd.new_zeros(pad)], dim=dim)
    return torch.stack([even, odd], dim=dim + 1).flatten(
        dim, dim + 1).narrow(dim, 0, n)


def _assoc_scan(a, b, dim: int):
    """Inclusive scan of (a, b) under :func:`_combine` along ``dim``, by
    the odd/even recursion of ``jax.lax.associative_scan`` (the same
    combines in the same order)."""
    n = a.shape[dim]
    if n < 2:
        return a, b

    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]
    ra, rb = _combine((sl(a, 0, -1, 2), sl(b, 0, -1, 2)),
                      (sl(a, 1, None, 2), sl(b, 1, None, 2)))
    oa, ob = _assoc_scan(ra, rb, dim)
    if n % 2 == 0:
        ea, eb = _combine((sl(oa, 0, -1), sl(ob, 0, -1)),
                          (sl(a, 2, None, 2), sl(b, 2, None, 2)))
    else:
        ea, eb = _combine((oa, ob), (sl(a, 2, None, 2), sl(b, 2, None, 2)))
    ea = torch.cat([sl(a, 0, 1), ea], dim=dim)
    eb = torch.cat([sl(b, 0, 1), eb], dim=dim)
    return _interleave(ea, oa, dim, n), _interleave(eb, ob, dim, n)


def _linear_scan_chunked(a, b, h0, chunk: int):
    """Reference ``_linear_scan_chunked`` (recurrent.py:67): h_t = a_t ⊙
    h_{t-1} + b_t. a, b (B, T, D) float32, h0 (B, D) → h (B, T, D), h_T
    (B, D). The tail is padded with a = 1, b = 0, which carries h_T
    through. Within a chunk :func:`_assoc_scan` gives the prefix (pa, pb)
    of every chunk at once; a chunk's states are then ``pa · h + pb`` from
    the state h it starts with, and its last one starts the next chunk."""
    bsz, t, d = a.shape
    c = min(chunk, t)
    n = -(-t // c)
    tp = n * c
    if tp != t:
        a = F.pad(a, (0, 0, 0, tp - t), value=1.0)
        b = F.pad(b, (0, 0, 0, tp - t))
    pa, pb = _assoc_scan(a.reshape(bsz, n, c, d), b.reshape(bsz, n, c, d), 2)
    starts = []
    h = h0
    for k in range(n):
        starts.append(h)
        h = pa[:, k, -1] * h + pb[:, k, -1]
    hs = pa * torch.stack(starts, dim=1)[:, :, None, :] + pb
    return hs.reshape(bsz, tp, d)[:, :t], h


def _split(tp) -> bool:
    return tp is not None and tp.rnn


def _channels(params, tp):
    """The per-channel leaves as this rank computes with them: its slice of
    each under the plan ``tp``, else the leaves."""
    if not _split(tp):
        return params
    sl = tp.part(params["lam"].shape[0])
    out = dict(params)
    out["conv_w"] = params["conv_w"][:, sl]
    for k in ("conv_b", "gate_r_w", "gate_r_b", "gate_i_w", "gate_i_b",
              "lam"):
        out[k] = params[k][sl]
    return out


def _exit(y, tp):
    return y if tp is None else tp.leave(y, tp.rnn)


def rglru_state_spec(cfg, batch: int, dtype, tp=None):
    """Reference ``rglru_state_spec`` (recurrent.py:95): the float32 state
    h and the conv carry of the last W-1 inputs (of this rank's channels
    under the plan ``tp``)."""
    dr = cfg.d_rnn or cfg.d_model
    if _split(tp):
        dr //= tp.n
    return {
        "h": TensorSpec((batch, dr), torch.float32),
        "conv": TensorSpec((batch, cfg.conv_width - 1, dr), dtype),
    }


def rglru_train(params, x, cfg, state=None, tp=None):
    """Reference ``rglru_train`` (recurrent.py:103), forward: x (B, T, d) →
    (y (B, T, d), state). ``state=None`` starts from zeros."""
    bsz = x.shape[0]
    params = _channels(params, tp)
    dr = params["lam"].shape[0]
    gate = _gelu(x @ params["w_y"])
    u = x @ params["w_x"]
    u, conv_carry = _conv_causal(u, params["conv_w"], params["conv_b"],
                                 None if state is None else state["conv"])
    a, b = _rglru_coeffs(params, u)
    h0 = (torch.zeros((bsz, dr), dtype=torch.float32, device=x.device)
          if state is None else state["h"].float())
    h, h_last = _linear_scan_chunked(a, b, h0, cfg.chunk_rec)
    y = _exit((h.to(x.dtype) * gate) @ params["w_o"], tp)
    return y, {"h": h_last, "conv": conv_carry}


def rglru_decode(params, x, state, cfg, tp=None):
    """Reference ``rglru_decode`` (recurrent.py:121): one token x (B, 1, d)
    → (y (B, 1, d), new state). The width-W conv over the carried W-1
    inputs and this one, summed in the reference's order; h stays
    float32."""
    params = _channels(params, tp)
    gate = _gelu(x @ params["w_y"])[:, 0]
    u = (x @ params["w_x"])[:, 0]                         # (B, dr)
    ext = torch.cat([state["conv"], u[:, None, :]], dim=1)
    w = params["conv_w"]
    width = w.shape[0]
    u_c = sum(ext[:, width - 1 - j] * w[width - 1 - j]
              for j in range(width)) + params["conv_b"]
    a, b = _rglru_coeffs(params, u_c)
    h = a * state["h"].float() + b
    y = _exit((h.to(x.dtype) * gate) @ params["w_o"], tp)
    return y[:, None, :], {"h": h, "conv": ext[:, 1:]}
