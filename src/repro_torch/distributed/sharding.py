"""Port of ``src/repro/distributed/sharding.py``: logical-axis sharding
rules and the parameter shardings derived from path names (MaxText-style).

A spec is the reference's ``PartitionSpec`` as a plain tuple: one entry a
dimension, each ``None`` (replicated), a mesh-axis name, or a tuple of
names (the dimension split over those axes, the first major). A
:class:`NamedSharding` pairs a spec with its mesh, as the reference's
does. The spec functions need only the mesh's axis names and sizes, so
they take a ``DeviceMesh``, a :class:`MeshShape` (a mesh with no
devices, the reference's ``AbstractMesh``), or anything with
``axis_names`` and a ``shape`` mapping of names to sizes.
:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh``.

Model code may call :func:`constrain` with logical axis names; an active
:func:`axis_rules` context maps them to mesh axes and redistributes a
DTensor to that layout. With no context, or on a plain tensor, it is a
no-op, as the reference's is with no context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import threading

__all__ = ["DEFAULT_RULES", "MeshShape", "NamedSharding", "axis_rules",
           "batch_axes", "block", "compute_shardings", "constrain",
           "current_mesh", "logical_to_spec", "mesh_shape",
           "named_sharding_for", "param_shardings", "shard_of", "spec_axes",
           "to_placements"]

_state = threading.local()

# logical axis name → mesh axis (or tuple of mesh axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_kv": None,          # flipped to "data" for SP long-context decode
    "embed": None,
    "heads": "model",
    "kv": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "rnn": "model",
    "seq_sp": None,          # → "model" under Megatron-SP
    "fsdp": None,            # → ("pod", "data") for ZeRO-3 MoE weights
    "cells": "cells",        # metro sharded solve: the cells mesh's axis
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices."""

    sizes: tuple[int, ...]
    names: tuple[str, ...]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.names, self.sizes))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: tuple


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a named-shape mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _size(mesh, entry) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in spec_axes(entry))


def batch_axes(mesh) -> tuple[str, ...]:
    names = tuple(mesh_shape(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


def _filter_rule(rule, mesh):
    if rule is None:
        return None
    names = tuple(mesh_shape(mesh))
    kept = tuple(a for a in spec_axes(rule) if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def _rules(mesh, rules):
    return {k: _filter_rule(v, mesh)
            for k, v in {**DEFAULT_RULES, **(rules or {})}.items()}


@contextlib.contextmanager
def axis_rules(mesh, rules: dict | None = None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, _rules(mesh, rules))
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def logical_to_spec(logical: tuple, mesh, rules: dict) -> tuple:
    return tuple(rules.get(a) if a is not None else None for a in logical)


def _fit(shape, entries, mesh) -> tuple:
    """``entries`` with each that does not divide its dimension dropped to
    ``None`` (the reference's divisibility fallback)."""
    return tuple(None if e is None or dim % _size(mesh, e) else e
                 for dim, e in zip(shape, entries))


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: a
    dimension over several mesh axes is ``Shard(d)`` on each of them; they
    must come in the mesh's order (DTensor shards the mesh dims left to
    right)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for i in where:
            out[i] = Shard(d)
    return tuple(out)


def block(t, mesh, dim: int, axis: str):
    """This rank's block of ``t``'s dimension ``dim`` split over mesh axis
    ``axis`` of a ``DeviceMesh`` (a view)."""
    from .collectives import axis_index, axis_size
    n = t.shape[dim] // axis_size(mesh, axis)
    return t.narrow(dim, axis_index(mesh, axis) * n, n)


def shard_of(t, sharding: NamedSharding):
    """This rank's shard of the whole tensor ``t`` under ``sharding`` (a
    view): each dimension cut by its axes, major first, as DTensor's
    ``Shard`` places the blocks."""
    for d, entry in enumerate(sharding.spec):
        for ax in spec_axes(entry):
            t = block(t, sharding.mesh, d, ax)
    return t


def constrain(x, *logical):
    """Redistribute the DTensor ``x`` to the layout its logical axis names
    map to under the active :func:`axis_rules` (divisibility fallback
    included); a plain tensor, or any tensor with no context, is returned
    as it is."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = _fit(x.shape, [rules.get(n) if n else None for n in logical],
                mesh)
    return x.redistribute(mesh, to_placements(spec, mesh))


def named_sharding_for(shape, logical: tuple, mesh,
                       rules: dict | None = None) -> NamedSharding:
    """NamedSharding from logical axis names with divisibility fallback."""
    rules = _rules(mesh, rules)
    return NamedSharding(mesh, _fit(
        shape, [rules.get(n) if n else None for n in logical], mesh))


# ---------------------------------------------------------------------------
# parameter shardings by path-name pattern
# ---------------------------------------------------------------------------

# (regex over "/"-joined param path, logical spec). First match wins.
_PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    (r"embed$", ("vocab", "embed")),
    (r"lm_head$", ("embed", "vocab")),
    (r"enc_in_proj$", ("embed", None)),
    (r"(wq|wk|wv)$", ("embed", "heads")),
    (r"wo$", ("heads", "embed")),
    (r"(w_gate|w_up)$", ("embed", "ff")),
    (r"w_down$", ("ff", "embed")),
    (r"router$", ("embed", "experts")),
    (r"time/(w_r|w_k|w_v|w_g)$", ("embed", "heads")),
    (r"time/w_o$", ("heads", "embed")),
    (r"time/w_lora_a$", ("embed", None)),
    (r"time/w_lora_b$", (None, "embed")),
    (r"channel/w_k$", ("embed", "ff")),
    (r"channel/w_v$", ("ff", "embed")),
    (r"channel/w_r$", ("embed", None)),
    (r"(w_x|w_y)$", ("embed", "rnn")),
    (r"rec/w_o$", ("rnn", "embed")),
)

# MoE expert tensors are 3-D; handled specially per impl. The *_FSDP
# variants additionally shard a free dim over the data axes (ZeRO-3 style
# weight sharding).
_MOE_EP = {
    "w_gate": ("experts", "embed", None), "w_up": ("experts", "embed", None),
    "w_down": ("experts", None, "embed"),
}
_MOE_TP = {
    "w_gate": (None, "embed", "ff"), "w_up": (None, "embed", "ff"),
    "w_down": (None, "ff", "embed"),
}
_MOE_EP_FSDP = {
    "w_gate": ("experts", None, "fsdp"), "w_up": ("experts", None, "fsdp"),
    "w_down": ("experts", "fsdp", None),
}
_MOE_TP_FSDP = {
    "w_gate": (None, "fsdp", "ff"), "w_up": (None, "fsdp", "ff"),
    "w_down": (None, "ff", "fsdp"),
}


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_with_path(fn, v, path + (str(i),))
                     for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _is_expert(name: str, leaf, cfg) -> bool:
    """An MoE expert stack: a leaf of rank 3 or more named like one, in an
    FFN of an MoE config."""
    return (leaf.ndim >= 3 and name.rsplit("/", 1)[-1] in _MOE_EP
            and cfg is not None and cfg.is_moe and "ffn" in name)


def param_shardings(params, mesh, cfg=None, rules: dict | None = None,
                    extra_batch_dim: bool = False, moe_fsdp: bool = False):
    """Tree of :class:`NamedSharding` matching ``params`` (any leaves with
    ``ndim`` and ``shape``: tensors, ``meta`` tensors, arrays).

    Stacked leaves have a leading repeat dim — detected by rank mismatch
    and padded with None. ``extra_batch_dim``: additionally shard the
    largest remaining free dim over the data axes (ZeRO-style, used for
    optimizer state)."""
    rules = _rules(mesh, rules)
    is_ep = cfg is not None and cfg.is_moe and cfg.moe_impl == "ep"
    if moe_fsdp:
        moe_rules = _MOE_EP_FSDP if is_ep else _MOE_TP_FSDP
    else:
        moe_rules = _MOE_EP if is_ep else _MOE_TP
    data_axes = batch_axes(mesh)
    sizes = mesh_shape(mesh)

    def one(name, leaf):
        logical = None
        if _is_expert(name, leaf, cfg):
            logical = moe_rules[name.rsplit("/", 1)[-1]]
        else:
            for pat, spec in _PARAM_RULES:
                if re.search(pat, name):
                    logical = spec
                    break
        rank = leaf.ndim
        if logical is None:
            entries = [None] * rank
        else:
            entries = [rules.get(a) if a else None for a in logical]
            entries = [None] * (rank - len(entries)) + entries
        entries = list(_fit(leaf.shape, entries, mesh))
        if extra_batch_dim and data_axes:
            used = {a for e in entries for a in spec_axes(e)}
            avail = tuple(a for a in data_axes if a not in used)
            if avail:
                n_data = math.prod(sizes[a] for a in avail)
                free = [i for i, e in enumerate(entries) if e is None
                        and leaf.shape[i] % n_data == 0
                        and leaf.shape[i] >= n_data]
                if free:
                    big = max(free, key=lambda i: leaf.shape[i])
                    entries[big] = avail if len(avail) > 1 else avail[0]
        return NamedSharding(mesh, tuple(entries))

    return _map_with_path(one, params)


def compute_shardings(params, mesh, cfg, moe_impl: str | None = None):
    """The layout the port's mesh train step computes in: each MoE expert
    stack split over the ``model`` axis as ``moe_apply``'s ``ep`` (experts)
    or ``tp`` (the FFN hidden dim) form splits it, every other leaf whole
    on every rank. Dense tensor parallelism is not ported, so the model
    axis carries only the MoE forms; the spec is
    :func:`param_shardings`' with every other entry dropped."""
    impl = moe_impl or (cfg.moe_impl if cfg is not None else "dense")
    if cfg is not None and cfg.is_moe and impl != cfg.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=impl)
    specs = param_shardings(params, mesh, cfg)

    def one(name, leaf):
        spec = _get(specs, name)
        if impl == "dense" or not _is_expert(name, leaf, cfg):
            return NamedSharding(mesh, (None,) * leaf.ndim)
        return NamedSharding(mesh, tuple(
            e if "model" in spec_axes(e) else None for e in spec.spec))

    return _map_with_path(one, params)


def _get(tree, name: str):
    for part in name.split("/"):
        tree = tree[part] if isinstance(tree, dict) else tree[int(part)]
    return tree
