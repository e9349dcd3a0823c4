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

__all__ = ["DEFAULT_RULES", "KVSplit", "MeshShape", "NamedSharding",
           "TPPlan", "active_axes", "axis_rules", "batch_axes", "block",
           "compute_shardings", "constrain", "current_mesh",
           "expert_fsdp_dim", "fsdp_axes", "kv_split", "logical_to_spec",
           "mesh_shape", "named_sharding_for", "param_shardings",
           "seq_parallel", "shard_of", "spec_axes", "to_placements",
           "tp_plan"]

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


def active_axes(name: str, mesh, rules: dict | None) -> tuple[str, ...]:
    """The axes of ``mesh`` that ``rules`` (over :data:`DEFAULT_RULES`) map
    the logical axis ``name`` to, major first (none with no mesh or no
    such axes). The model's entry points take the rules as an argument
    and hand what they decide down, so that the layout a caller stored
    (its cache, its shards) and the one the step computes in come from one
    object."""
    if mesh is None:
        return ()
    names = mesh_shape(mesh)
    return tuple(a for a in spec_axes(_rules(mesh, rules).get(name))
                 if a in names)


def seq_parallel(mesh, rules: dict | None) -> bool:
    """Whether ``rules`` map ``seq_sp`` to a ``model`` axis of several
    ranks (Megatron-SP, the reference's ``optimized`` train cells)."""
    return "model" in active_axes("seq_sp", mesh, rules) \
        and mesh_shape(mesh)["model"] > 1


def fsdp_axes(mesh, rules: dict | None) -> tuple[str, ...]:
    """The axes of several ranks that ``rules`` map ``fsdp`` to: those the
    MoE expert stacks are stored split over (ZeRO-3), gathered one layer
    at a time at use."""
    sizes = mesh_shape(mesh) if mesh is not None else {}
    return tuple(a for a in active_axes("fsdp", mesh, rules) if sizes[a] > 1)


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


def _spec_impl(cfg, impl: str | None) -> str:
    """The MoE form whose expert spec lays out the experts a form ``impl``
    computes with: its own, or for the dense form the config's (the
    reference's cells keep the config's spec whatever form they run)."""
    impl = impl or cfg.moe_impl
    return cfg.moe_impl if impl == "dense" else impl


def expert_fsdp_dim(cfg, leaf: str, impl: str | None = None) -> int:
    """The dimension of the expert stack ``leaf`` (``w_gate``, ``w_up`` or
    ``w_down``, rank 3) that ZeRO-3 splits over the data axes
    (``_MOE_EP_FSDP``, ``_MOE_TP_FSDP``) for the form ``impl``."""
    table = _MOE_EP_FSDP if _spec_impl(cfg, impl) == "ep" else _MOE_TP_FSDP
    return table[leaf].index("fsdp")


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


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What one rank of the ``model`` axis computes under dense tensor
    parallelism (:func:`tp_plan`): the axis's size ``n`` and the rank's
    coordinate ``rank`` on it, and which parts of the model split over it.

    * ``attn``: the query heads split, ``heads`` of them a rank (the rank's
      ``rank · heads`` onwards); ``kv_split``: the K/V projections split
      too, ``kv_heads`` a rank; otherwise each rank computes the one KV head
      its query heads read (``kv_heads`` = 1, global index ``kv_first``)
      from the whole ``wk`` and ``wv``, and its cache holds only that head.
      When ``attn`` is off, attention is whole on every rank (``heads``
      and ``kv_heads`` are the config's).
    * ``ff``: the dense FFN's hidden dimension (and RWKV's channel mix);
      ``rnn``: the RG-LRU's width; ``rwkv``: RWKV-6's time-mix heads;
      ``vocab``: the embedding's rows and the head's columns.

    ``sp`` (Megatron-SP, :func:`seq_parallel`): the residual stream
    between the split regions is this rank's block of the sequence, (B,
    T / n, d); a region gathers its normed input at entry
    (:meth:`enter`) and leaves by :meth:`leave`.

    ``mesh`` is the ``DeviceMesh`` whose ``model`` axis the split forms'
    collectives run over.
    """

    n: int
    rank: int
    attn: bool
    heads: int
    kv_split: bool
    kv_heads: int
    kv_first: int
    ff: bool
    rnn: bool
    rwkv: bool
    vocab: bool
    sp: bool = False
    mesh: object = dataclasses.field(default=None, compare=False,
                                     repr=False)

    def part(self, size: int) -> slice:
        """This rank's block of a dimension of ``size`` split over the
        ``n`` ranks."""
        k = size // self.n
        return slice(self.rank * k, (self.rank + 1) * k)

    def enter(self, x):
        """The input of a region, (B, T, d): under SP the ranks' blocks of
        the sequence gathered (its backward reduce-scatters the gradient
        shares), else ``x`` as it is, whole on every rank."""
        if not self.sp:
            return x
        from .collectives import all_gather
        return all_gather(x, self.mesh, "model", dim=1)

    def leave(self, y, split: bool):
        """The output of a region that computed ``y`` from its whole input.
        A ``split`` region's ``y`` is this rank's partial: summed over
        ``model`` in float32 (``tp_exit``), under SP of which the rank keeps
        its block of the sequence (``seq_exit``). A region the plan leaves
        whole computed the same ``y`` on every rank: it is the output, and
        under SP the rank keeps its block with no sum. That is still the
        share rule: the gradient below is zero outside the rank's block, so
        each rank's gradient of the region's whole leaves and of its
        gathered input is the share of its own block, and the step's sum
        and the gather's reduce-scatter add the shares to the whole."""
        from .collectives import seq_exit, tp_exit
        if self.sp:
            return seq_exit(y, self.mesh) if split \
                else y[:, self.part(y.shape[1])]
        return tp_exit(y, self.mesh) if split else y


def _tp_numbers(cfg, n: int, rank: int) -> TPPlan:
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    attn = n > 1 and hq % n == 0 and (hkv % n == 0 or n % hkv == 0)
    kv_split = attn and hkv % n == 0
    if kv_split:
        kv_heads, kv_first = hkv // n, rank * (hkv // n)
    elif attn:
        kv_heads, kv_first = 1, rank // (n // hkv)
    else:
        kv_heads, kv_first = hkv, 0
    d_rnn = cfg.d_rnn or cfg.d_model
    return TPPlan(
        n=n, rank=rank, attn=attn, heads=hq // n if attn else hq,
        kv_split=kv_split, kv_heads=kv_heads, kv_first=kv_first,
        ff=n > 1 and cfg.d_ff % n == 0, rnn=n > 1 and d_rnn % n == 0,
        rwkv=n > 1 and (cfg.d_model // cfg.rwkv_head_dim) % n == 0,
        vocab=n > 1 and cfg.vocab_size % n == 0)


def tp_plan(cfg, mesh, rank: int | None = None, *, sp: bool = False):
    """The :class:`TPPlan` of ``cfg`` on ``mesh``'s ``model`` axis for this
    rank (or for coordinate ``rank`` on that axis), or None where the mesh
    has no such axis or it has one rank: the meshless code runs then.
    ``sp``: the residual is split by sequence (Megatron-SP)."""
    if mesh is None:
        return None
    n = mesh_shape(mesh).get("model", 1)
    if n == 1:
        return None
    if rank is None:
        rank = mesh.get_local_rank("model")
    return dataclasses.replace(_tp_numbers(cfg, n, rank), sp=sp, mesh=mesh)


@dataclasses.dataclass(frozen=True)
class KVSplit:
    """The reference's ``seq_kv`` layout of a decode cache on one rank: the
    KV caches' slots split over the mesh axes ``axes`` (major first, ``n``
    ranks), this rank holding block ``index`` of the slots for every KV
    head (the reference's ``kv`` rule is None). A cache whose length ``n``
    does not divide stays whole on every rank, as ``named_sharding_for``'s
    fallback leaves it. ``cache_len`` and ``enc_len`` are the whole caches'
    lengths (the self-attention buffer and the encoder's), which a rank's
    block alone does not tell."""

    axes: tuple
    n: int
    index: int
    cache_len: int
    enc_len: int = 0
    mesh: object = dataclasses.field(default=None, compare=False,
                                     repr=False)

    def splits(self, length: int) -> bool:
        return length % self.n == 0

    def span(self, length: int) -> tuple[int, int]:
        """(first slot, slots) of this rank's block of a cache of
        ``length`` slots: its 1/n, or all of it where n does not divide
        ``length``."""
        if not self.splits(length):
            return 0, length
        k = length // self.n
        return self.index * k, k


def kv_split(mesh, rules: dict | None, cache_len: int | None,
             enc_len: int = 0):
    """The :class:`KVSplit` that ``rules`` ask for (``seq_kv`` mapped to
    axes of ``mesh`` with several ranks in all), or None."""
    axes = active_axes("seq_kv", mesh, rules)
    sizes = mesh_shape(mesh) if mesh is not None else {}
    n = math.prod(sizes[a] for a in axes)
    if n == 1:
        return None
    if cache_len is None:
        raise ValueError("a cache split by sequence (seq_kv) needs the "
                         "whole cache's length, cache_len: a rank's block "
                         "does not tell it")
    index = 0
    if hasattr(mesh, "get_local_rank"):
        for a in axes:
            index = index * sizes[a] + mesh.get_local_rank(a)
    return KVSplit(axes, n, index, cache_len, enc_len, mesh=mesh)


# leaf name (the path's last parts) → the plan's flag that splits it
_TP_LEAVES = (
    (r"(^|/)embed$", "vocab"), (r"lm_head$", "vocab"),
    (r"(^|/)(wq|wo)$", "attn"), (r"(^|/)(wk|wv)$", "kv_split"),
    (r"time/(w_r|w_k|w_v|w_g|w_o)$", "rwkv"),
    (r"channel/(w_k|w_v)$", "ff"),
    (r"(^|/)(w_gate|w_up|w_down)$", "ff"),
    (r"(^|/)(w_x|w_y)$", "rnn"), (r"rec/w_o$", "rnn"),
)


def _tp_split(name: str, plan) -> bool:
    if plan is None:
        return False
    for pat, flag in _TP_LEAVES:
        if re.search(pat, name):
            return getattr(plan, flag)
    return False


def compute_shardings(params, mesh, cfg, moe_impl: str | None = None, *,
                      moe_fsdp: bool = False, rules: dict | None = None):
    """The layout the port's mesh step, prefill and decode compute in: a
    leaf takes the ``model`` entry of the reference's
    :func:`param_shardings` spec where the port's split form computes in
    that split, and is whole on ``model`` otherwise; every other entry is
    dropped (data parallelism keeps every leaf whole on the data axes).

    * MoE expert stacks split as ``moe_apply``'s ``ep`` (experts) or ``tp``
      (the FFN hidden dim) form splits them, and the dense form over a mesh
      as the config's own spec does (``_MOE_EP``: the experts, ``_MOE_TP``:
      the hidden units); the router stays whole. With ``moe_fsdp`` (ZeRO-3,
      the reference's ``optimized`` cells) this is their storage layout:
      the ``_MOE_EP_FSDP`` or ``_MOE_TP_FSDP`` spec, split over the data
      axes too (``rules``' ``fsdp``), which the model gathers one layer at a
      time at use (``models/moe.py::gather_experts``).
    * Dense leaves split as :func:`tp_plan` says: ``wq``/``wo`` when the
      query heads divide the axis and each rank's heads read whole KV
      heads (the axis divides ``n_kv_heads``, or ``n_kv_heads`` divides
      the axis: one KV head a rank); ``wk``/``wv`` only when the axis
      divides ``n_kv_heads``; the FFN, RG-LRU and RWKV projections when
      ``d_ff``, ``d_rnn`` and the RWKV heads divide it; the embedding's rows
      and the head's columns when the vocabulary does.

    The reference's spec also splits columns that cut a head in pieces
    (whisper's ``wq`` over 16 ranks, granite's one KV head): GSPMD
    reshuffles those, local attention cannot use them, so they stay whole
    here and the ZeRO layout (``param_shardings(..., extra_batch_dim=True)``)
    alone splits them. Leaves that are whole in the spec but per channel or
    per head (conv weights, gates, RWKV's ``u``, decays and group-norm
    scale) stay whole: each rank computes with its slice of them."""
    if cfg is not None and cfg.is_moe:
        impl = _spec_impl(cfg, moe_impl)
        if impl != cfg.moe_impl:
            cfg = dataclasses.replace(cfg, moe_impl=impl)
    specs = param_shardings(params, mesh, cfg)
    stored = None
    if moe_fsdp:
        rules = {"fsdp": ("pod", "data"), **(rules or {})}
        stored = param_shardings(params, mesh, cfg, rules, moe_fsdp=True)
    n = mesh_shape(mesh).get("model", 1)
    plan = _tp_numbers(cfg, n, 0) if cfg is not None and n > 1 else None

    def one(name, leaf):
        spec = _get(specs, name)
        if _is_expert(name, leaf, cfg):
            if stored is not None:
                return _get(stored, name)
            keep = True
        else:
            keep = _tp_split(name, plan)
        if not keep:
            return NamedSharding(mesh, (None,) * leaf.ndim)
        return NamedSharding(mesh, tuple(
            e if "model" in spec_axes(e) else None for e in spec.spec))

    return _map_with_path(one, params)


def _get(tree, name: str):
    for part in name.split("/"):
        tree = tree[part] if isinstance(tree, dict) else tree[int(part)]
    return tree
