"""Port of ``src/repro/models/moe.py``: the Mixture-of-Experts FFN with
token-choice top-k routing, on one device.

* ``dense`` (:func:`_moe_dense`): every expert computes every token, and
  the outputs are gate-weighted. ``moe_apply`` with no mesh takes it, as
  the reference does on one device; it is the main path of both MoE
  configs.
* the sort-based dispatch of the reference's ``tp`` and ``ep`` forms on
  one shard (:func:`_moe_local` with no collective): a stable sort by
  expert into fixed-capacity buckets, one batched SwiGLU over the
  buckets, and a combine. Tokens over a bucket's capacity drop to zero.

The reference computes all of it in jnp, outside any Pallas kernel, so
the port's counterpart is plain PyTorch with ``torch.matmul`` for the
products. The mesh forms (``all_to_all`` and ``psum`` over a training
mesh) wait for ``distributed/``: ROADMAP.md queue 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import dense_init

__all__ = ["moe_init", "moe_apply"]

MESH_WAITS = ("the MoE's expert- and tensor-parallel forms over a mesh "
              "wait for distributed/: ROADMAP.md queue 1, item 6")


def moe_init(generator, cfg, dtype=torch.float32, device=None):
    """Reference ``moe_init`` (moe.py:33). The router stays float32 in a
    model of any type; the 3-D expert weights take the reference's fan-in,
    ``shape[0]`` (the expert count)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    return {
        "router": dense_init(generator, (d, e), dtype=torch.float32,
                             device=device),
        "w_gate": dense_init(generator, (e, d, f), dtype=dtype,
                             device=device),
        "w_up": dense_init(generator, (e, d, f), dtype=dtype, device=device),
        "w_down": dense_init(generator, (e, f, d), dtype=dtype,
                             device=device),
    }


def _top_k(logits, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no tie
    order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, x, cfg):
    """Reference ``_route`` (moe.py:44): top-k routing in float32.
    x (..., d) → gates (..., k) float32 (softmax over the top k), idx
    (..., k) int64."""
    logits = x.float() @ params["router"].float()
    gates, idx = _top_k(logits, cfg.top_k)
    return torch.softmax(gates, dim=-1), idx


def _expert_ffn(w_gate, w_up, w_down, xb):
    """Reference ``_expert_ffn`` (moe.py:52): batched SwiGLU over expert
    buckets, xb (E, C, d) → (E, C, d)."""
    h = F.silu(torch.bmm(xb, w_gate)) * torch.bmm(xb, w_up)
    return torch.bmm(h, w_down)


def _dispatch_sort(e_flat, n_experts: int, capacity: int):
    """Reference ``_dispatch_sort`` (moe.py:59). e_flat (a,) expert per
    assignment → (order, expert_sorted, slot_sorted, valid_sorted): the
    assignments in expert-sorted order (stable), each with its bucket slot
    and whether it fits the capacity. The run start is the reference's
    associative max-scan, here ``torch.cummax``."""
    a = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    idx = torch.arange(a, device=e_flat.device)
    is_start = torch.ones(a, dtype=torch.bool, device=e_flat.device)
    is_start[1:] = e_sorted[1:] != e_sorted[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, -1), dim=0).values
    slot = idx - run_start
    return order, e_sorted, slot, slot < capacity


def _scatter_combine(x_flat, gates_flat, tok_flat, order, e_sorted, slot,
                     valid, n_experts, capacity, expert_fn):
    """Reference ``_scatter_combine`` (moe.py:78): dispatch into (E, C, d)
    buckets, ``expert_fn``, combine. The reference's ``.at[].add``
    scatters are ``index_put_(accumulate=True)``; a dropped assignment
    adds zero to slot (0, 0)."""
    d = x_flat.shape[-1]
    tok_sorted = tok_flat[order]
    gate_sorted = gates_flat[order]
    e_safe = torch.where(valid, e_sorted, 0)
    slot_safe = torch.where(valid, slot, 0)
    xb = x_flat.new_zeros((n_experts, capacity, d))
    vals = torch.where(valid[:, None], x_flat[tok_sorted], 0)
    xb.index_put_((e_safe, slot_safe), vals, accumulate=True)
    yb = expert_fn(xb)
    y_sorted = yb[e_safe, slot_safe] \
        * torch.where(valid, gate_sorted, 0.0)[:, None]
    out = torch.zeros_like(x_flat)
    out.index_put_((tok_sorted,), y_sorted.to(x_flat.dtype), accumulate=True)
    return out


def _moe_local(params, x, cfg, *, capacity_scale: float = 1.0):
    """Reference ``_moe_local`` (moe.py:95) on one shard
    (``psum_axis=None``, ``ep_axis=None``): sort-based dispatch into
    buckets of capacity ``max(8, ceil(n_tok · top_k · capacity_factor ·
    capacity_scale / E))``, the expert FFN on the buckets, and the
    combine."""
    b, t, d = x.shape
    n_tok = b * t
    e = cfg.n_experts
    gates, idx = _route(params, x, cfg)
    capacity = max(8, int(math.ceil(
        n_tok * cfg.top_k * cfg.capacity_factor * capacity_scale / e)))
    e_flat = idx.reshape(n_tok * cfg.top_k)
    tok_flat = torch.arange(n_tok, device=x.device).repeat_interleave(
        cfg.top_k)
    order, e_sorted, slot, valid = _dispatch_sort(e_flat, e, capacity)

    def expert_fn(xb):
        return _expert_ffn(params["w_gate"], params["w_up"],
                           params["w_down"], xb)

    out = _scatter_combine(x.reshape(n_tok, d),
                           gates.reshape(n_tok * cfg.top_k), tok_flat,
                           order, e_sorted, slot, valid, e, capacity,
                           expert_fn)
    return out.reshape(b, t, d)


def _moe_dense(params, x, cfg):
    """Reference ``_moe_dense`` (moe.py:149): every expert on every token,
    combined with the gates scattered to (b, t, e) and cast to x's type.

    One expert at a time: its SwiGLU on all b·t tokens in x's type, then
    its output times its combine weight added into a float32 sum, rounded
    to x's type at the end: the reference's last einsum (bf16 products are
    exact in float32) without its (b, t, e, f) and (b, t, e, d)
    transients."""
    b, t, d = x.shape
    n = b * t
    gates, idx = _route(params, x, cfg)
    w = torch.zeros((n, cfg.n_experts), dtype=torch.float32, device=x.device)
    w.scatter_add_(-1, idx.reshape(n, -1), gates.reshape(n, -1))
    w = w.to(x.dtype).float()
    x2 = x.reshape(n, d)
    out = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for e in range(cfg.n_experts):
        h = F.silu(x2 @ params["w_gate"][e]) * (x2 @ params["w_up"][e])
        out += (h @ params["w_down"][e]).float() * w[:, e, None]
    return out.to(x.dtype).reshape(b, t, d)


def moe_apply(params, x, cfg, *, impl: str | None = None, mesh=None):
    """Reference ``moe_apply`` (moe.py:159). With ``impl == "dense"`` or
    no mesh this is :func:`_moe_dense`, as the reference computes on one
    device. A mesh with the ``tp`` or ``ep`` form raises: those forms wait
    for ``distributed/`` (ROADMAP.md queue 1, item 6)."""
    impl = impl or cfg.moe_impl
    if impl == "dense" or mesh is None:
        return _moe_dense(params, x, cfg)
    if impl in ("tp", "ep"):
        raise NotImplementedError(MESH_WAITS)
    raise ValueError(impl)
