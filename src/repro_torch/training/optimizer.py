"""Port of ``src/repro/training/optimizer.py``: AdamW with global-norm
clipping and a warmup-cosine schedule, and the train step.

The arithmetic is the reference's: float32 moments whatever the parameter
type, the gradient clipped by its global norm, bias-corrected moments,
decoupled weight decay, the result cast back to the parameter's type.
Unlike the reference's functional update, the port updates the
parameters and moments in place (the reference donates them to its jitted
step, so neither keeps the old values), a stacked leaf one repeat at a
time and every piece cut to at most 2^26 elements: no float32 transient
of a whole stack exists, the counterpart of the reference's "no
full-size fp32 transient". The gradient comes one repeat at a time too
(:func:`split_repeats`).

Over a ``DeviceMesh`` the step is data-parallel over the data axes
(``pod``, ``data``), each rank taking its rows of the batch, and the
``model`` axis carries the MoE's ``ep`` and ``tp`` forms and dense tensor
parallelism: each leaf is split over ``model`` where the port's split
forms compute in that split, and whole on every rank otherwise
(``distributed.sharding.compute_shardings``). Each rank's gradient is its
share, and the shares are summed over the ranks that hold the leaf whole.
With ``grad_shardings`` (the reference's ZeRO layout,
``param_shardings(..., extra_batch_dim=True)``) that sum is a
reduce-scatter into the layout, once a microbatch (ZeRO-2); the float32
moments live as those shards and AdamW runs on them (ZeRO-1), and only
the result, in the parameter's type, is gathered back. A leaf stored split
over the data axes too (ZeRO-3 of the MoE experts, the reference's
``optimized`` cells: ``param_out_shardings`` is its storage layout) is
gathered by the model at use, whose backward reduce-scatters its gradient
over the data ranks: the layout then holds it over every axis, so the
step sums and scatters it no further, its moments are its block, and
nothing is gathered back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..distributed.collectives import (all_gather, axis_index, axis_size,
                                       reduce_scatter, sum_over)
from ..tree import leaves, rebuild, tree_map

__all__ = ["OptConfig", "global_norm", "loss_and_grads", "lr_schedule",
           "make_train_step", "opt_init", "opt_update", "recorded_reduced",
           "split_repeats"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _param_leaves(params, grads, stacked=False) -> list:
    """(leaf, ``grads``' node at that leaf, stacked) for each leaf of
    ``params`` in the flattening order; ``stacked`` for the leaves under a
    ``scan`` key, whose leading axis is the repeat. The gradient's node may
    be a tensor or a tuple of per-repeat tensors."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _param_leaves(
            params[k], grads[k], stacked or k == "scan")]
    if isinstance(params, (tuple, list)):
        return [x for p, g in zip(params, grads)
                for x in _param_leaves(p, g, stacked)]
    return [(params, grads, stacked)]


# float32 elements a transient of the update may hold at once (256 MB)
_PIECE = 1 << 26


def _pieces(shape) -> list:
    """Index prefixes that cut a tensor of ``shape`` along its leading axes
    into pieces of at most ``_PIECE`` elements."""
    n = math.prod(shape)
    if n <= _PIECE or not shape:
        return [()]
    per = n // shape[0]
    if per <= _PIECE:
        step = _PIECE // per
        return [(slice(i, i + step),) for i in range(0, shape[0], step)]
    return [(i,) + rest for i in range(shape[0]) for rest in
            _pieces(shape[1:])]


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(opt: OptConfig, step):
    """Reference ``lr_schedule`` (optimizer.py:37): linear warmup to
    ``opt.lr``, then a cosine down to ``min_lr_ratio`` of it, in float32.
    ``step`` is an integer tensor; returns a float32 0-d tensor."""
    step = step.to(torch.float32)
    warm = step / max(opt.warmup_steps, 1)
    t = (step - opt.warmup_steps) / max(opt.total_steps - opt.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = opt.min_lr_ratio + (1 - opt.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi, step) * t))
    return opt.lr * torch.where(step < opt.warmup_steps, warm, cos)


def _squares(g) -> list:
    """The float32 sum of squares of each piece of ``g``."""
    return [torch.sum(torch.square(g[idx].float()))
            for idx in _pieces(tuple(g.shape))]


def _sum_in_order(parts):
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    return total


def global_norm(tree):
    """Reference ``global_norm`` (optimizer.py:48): the float32 L2 norm of
    every leaf together (a tuple of per-repeat gradients is leaves too),
    summed a piece of at most 2^26 elements at a time."""
    return torch.sqrt(_sum_in_order([sq for g in leaves(tree)
                                     for sq in _squares(g)]))


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where one parameter leaf's gradient and moments live on a mesh, for
    one unit of it (a repeat of a stacked leaf, else the leaf): the axes
    over which the ranks' gradient shares are summed, the (dim, axis)
    splits of the ZeRO shard beyond the compute layout (major first), and
    the axes over which the shards tile the unit. Axes of one rank are
    left out of all three: a one-rank mesh moves and copies nothing."""

    mesh: object
    sum_axes: tuple
    zero: tuple
    tiled: tuple

    def shard(self, t):
        """This rank's ZeRO block of the unit ``t`` (a view)."""
        from ..distributed.sharding import block
        for dim, ax in self.zero:
            t = block(t, self.mesh, dim, ax)
        return t

    def reduce(self, g):
        """The sum of the ranks' gradient shares, this rank's block of it
        (a reduce-scatter over the ZeRO axes, a sum over the others)."""
        split = {ax for _, ax in self.zero}
        g = sum_over(g, self.mesh, [a for a in self.sum_axes
                                    if a not in split])
        for dim, ax in self.zero:
            g = reduce_scatter(g, self.mesh, ax, dim)
        return g

    def gather_(self, p):
        """Write every rank's updated block of the unit ``p`` into it,
        gathering in ``p``'s type."""
        from ..distributed.sharding import block
        views = [p]
        for dim, ax in self.zero:
            views.append(block(views[-1], self.mesh, dim, ax))
        for (dim, ax), outer, inner in reversed(list(zip(
                self.zero, views[:-1], views[1:]))):
            outer.copy_(all_gather(inner, self.mesh, ax, dim))


def _layouts(params, zero_shardings, out_shardings) -> list:
    """One :class:`_Layout` a leaf of ``params``, in the flattening order.
    ``out_shardings`` is the compute layout (whole on every rank where
    None), ``zero_shardings`` the ZeRO layout (the compute layout where
    None); both trees of ``distributed.sharding.NamedSharding``."""
    from ..distributed.sharding import mesh_shape, spec_axes
    zsh = leaves(zero_shardings if zero_shardings is not None
                  else out_shardings)
    osh = leaves(out_shardings) if out_shardings is not None \
        else [None] * len(zsh)
    out = []
    for (p, _, stacked), z, o in zip(_param_leaves(params, params), zsh, osh):
        zspec = z.spec
        ospec = o.spec if o is not None else (None,) * len(zspec)
        if stacked and (zspec[0] is not None or ospec[0] is not None):
            raise ValueError("the step splits a stacked leaf within each "
                             f"repeat, not over repeats: {zspec}")
        skip = 1 if stacked else 0
        held = {a for e in ospec for a in spec_axes(e)}
        names = tuple(a for a, n in mesh_shape(z.mesh).items() if n > 1)
        zero = tuple((d - skip, a) for d, e in enumerate(zspec)
                     for a in spec_axes(e) if a not in held and a in names)
        tiled = held | {a for e in zspec for a in spec_axes(e)}
        out.append(_Layout(z.mesh, tuple(a for a in names if a not in held),
                           zero, tuple(a for a in names if a in tiled)))
    return out


def _units(p, stacked):
    return [p[r] for r in range(p.shape[0])] if stacked else [p]


def opt_init(params, *, zero_shardings=None, out_shardings=None):
    """Reference ``opt_init`` (optimizer.py:54): float32 zero moments like
    every leaf, and the step count (an int32 0-d tensor). With
    ``zero_shardings`` (ZeRO-1) each moment is this rank's shard of the
    leaf as ``params`` holds it in ``out_shardings``' layout."""
    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    first = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if zero_shardings is None:
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": step}
    shards = [torch.zeros(((p.shape[0],) if st else ())
                          + tuple(lay.shard(p[0] if st else p).shape),
                          dtype=torch.float32, device=p.device)
              for (p, _, st), lay in zip(
                  _param_leaves(params, params),
                  _layouts(params, zero_shardings, out_shardings))]
    return {"m": rebuild(params, shards),
            "v": rebuild(params, [x.clone() for x in shards]),
            "step": step}


def _adamw_(opt: OptConfig, p, g, m, v, scale, lr, bc1, bc2):
    """AdamW on one piece in place, the reference's ``upd``
    (optimizer.py:72) with no sharding: float32 moments, the result cast to
    ``p``'s type."""
    g32 = g.float() * scale
    m.mul_(opt.b1).add_((1 - opt.b1) * g32)
    v.mul_(opt.b2).add_((1 - opt.b2) * g32 * g32)
    delta = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps) \
        + opt.weight_decay * p.float()
    p.copy_(p.float() - lr * delta)


def _sharded_norm(params, grads, layouts):
    """:func:`global_norm` of a gradient held as ZeRO shards: each piece's
    sum of squares summed over the axes its leaf's shards tile, one
    collective an axis, then the pieces added in the flattening order
    (on one rank exactly :func:`global_norm`)."""
    parts, axes = [], []
    for (p, g, stacked), lay in zip(_param_leaves(params, grads), layouts):
        units = list(g) if isinstance(g, (tuple, list)) \
            else _units(g, stacked)
        for unit in units:
            sq = _squares(unit)
            parts += sq
            axes += [lay.tiled] * len(sq)
    mesh = layouts[0].mesh
    for ax in dict.fromkeys(a for t in axes for a in t):
        where = [i for i, t in enumerate(axes) if ax in t]
        vec = sum_over(torch.stack([parts[i] for i in where]), mesh, (ax,))
        for j, i in enumerate(where):
            parts[i] = vec[j]
    return torch.sqrt(_sum_in_order(parts))


def opt_update(opt: OptConfig, params, grads, state, *, zero_shardings=None,
               out_shardings=None):
    """Reference ``opt_update`` (optimizer.py:60), in place: ``params`` and
    ``state``'s moments are updated where they lie and returned with the
    metrics ``{"lr", "grad_norm"}`` (float32 0-d tensors). ``grads`` has
    ``params``' structure; a stacked leaf's gradient may be the tuple of
    its per-repeat gradients, as :func:`loss_and_grads` gives it. Every
    leaf is updated a piece at a time: a stacked one a repeat at a time,
    and any piece cut to at most 2^26 elements, so no float32 transient
    of a whole stack exists.

    With ``zero_shardings`` (ZeRO-1; a tree of
    ``distributed.sharding.NamedSharding``) ``grads`` and the moments are
    this rank's shards of that layout, ``params`` is held in the layout
    ``out_shardings`` (whole where None): AdamW runs on the shard, on a
    view of the parameter's block, and the blocks are gathered back in
    the parameter's type. The gradient norm sums the shards' squares over
    the ranks."""
    step = state["step"] + 1
    lr = lr_schedule(opt, step)
    layouts = None if zero_shardings is None else _layouts(
        params, zero_shardings, out_shardings)
    gnorm = global_norm(grads) if layouts is None \
        else _sharded_norm(params, grads, layouts)
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - _f32(opt.b1, stepf) ** stepf
    bc2 = 1 - _f32(opt.b2, stepf) ** stepf
    with torch.no_grad():
        for i, ((p, g, stacked), m, v) in enumerate(zip(
                _param_leaves(params, grads), leaves(state["m"]),
                leaves(state["v"]))):
            units = [(p[r], g[r], m[r], v[r]) for r in range(p.shape[0])] \
                if stacked else [(p, g, m, v)]
            for pu, gu, mu, vu in units:
                block = pu if layouts is None else layouts[i].shard(pu)
                for idx in _pieces(tuple(block.shape)):
                    _adamw_(opt, block[idx], gu[idx], mu[idx], vu[idx],
                            scale, lr, bc1, bc2)
                if layouts is not None:
                    layouts[i].gather_(pu)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def split_repeats(params):
    """``params`` for a gradient: each stacked leaf (under ``scan``: the
    decoder's and the encoder's) becomes the tuple of its repeats, and every
    leaf a fresh tensor that requires grad and shares the parameter's
    storage. ``models.forward_train`` reads a stacked leaf one repeat at a
    time (``leaf[r]``), so autograd gives one gradient a repeat and never
    builds a whole stack's gradient from per-repeat slices."""
    def leaf(t):
        return t.detach().requires_grad_(True)

    def walk(tree, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, stacked or k == "scan")
                    for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return tuple(walk(v, stacked) for v in tree)
        if stacked:
            return tuple(leaf(tree[r]) for r in range(tree.shape[0]))
        return leaf(tree)
    return walk(params, False)


def loss_and_grads(params, batch, cfg):
    """The reference's ``jax.value_and_grad(models.loss_fn, has_aux=True)``
    by autograd: → (loss, metrics, grads). ``loss`` is a float32 0-d
    tensor; ``grads`` has ``params``' structure, with each stacked leaf's
    gradient the tuple of its per-repeat gradients, in the parameters'
    type."""
    from ..models import loss_fn
    split = split_repeats(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(split, batch, cfg)
        grads = torch.autograd.grad(loss, leaves(split))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        rebuild(split, grads)


def _micro(batch, m: int, i: int):
    return {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]
            for k, v in batch.items()}


def _data_rows(batch, mesh):
    """This rank's rows of the global ``batch``, split over the data axes
    (``pod`` major), as the reference's batch sharding places them."""
    from ..distributed.sharding import batch_axes
    k, n = 0, 1
    for ax in batch_axes(mesh):
        k = k * axis_size(mesh, ax) + axis_index(mesh, ax)
        n *= axis_size(mesh, ax)
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{n} data ranks")
    return _micro(batch, n, k)


def _mesh_loss_and_grads(params, batch, cfg, mesh, moe_impl=None,
                         rules=None):
    """:func:`loss_and_grads` of one rank of a ``DeviceMesh``: ``params``
    and ``batch`` are its shards → (the loss of the whole batch, this
    rank's gradient shares). The loss is the sum of the CE terms over the
    data ranks over their count; every rank outside the data axes
    computes the same loss, so each weighs its gradient by one over
    their number, and a leaf's shares summed over the ranks that hold it
    whole are its gradient."""
    from ..distributed.sharding import batch_axes, mesh_shape
    from ..models import loss_sums
    data = batch_axes(mesh)
    copies = math.prod(n for a, n in mesh_shape(mesh).items()
                       if a not in data)
    split = split_repeats(params)
    with torch.enable_grad():
        total, count = loss_sums(split, batch, cfg, mesh=mesh,
                                 moe_impl=moe_impl, rules=rules)
        loss = total / torch.clamp(sum_over(count.detach(), mesh, data),
                                   min=1.0)
        grads = torch.autograd.grad(
            loss, leaves(split),
            grad_outputs=torch.full_like(loss, 1.0 / copies))
    return sum_over(loss.detach(), mesh, data), rebuild(split, grads)


# the lists that :func:`recorded_reduced` blocks are open for, with the
# device each keeps its copies on
_RECORDERS: list = []


@contextlib.contextmanager
def recorded_reduced(device=None):
    """Within the block, each mesh train step appends a copy (on
    ``device``, the block's own by default) of every reduced gradient
    block it hands the update to the list this yields: the leaves in
    order, a stacked leaf's repeats in turn, a microbatch after another.
    That is the step's own gradient, to be held against a meshless one
    without a second run; a copy in host memory leaves the card's peak
    as it was."""
    blocks: list = []
    _RECORDERS.append((blocks, device))
    try:
        yield blocks
    finally:
        _RECORDERS.pop()


def make_train_step(cfg, opt: OptConfig, *, mesh=None, moe_impl=None,
                    n_microbatches: int = 1, grad_shardings=None,
                    param_out_shardings=None, accum_dtype=torch.float32,
                    rules=None):
    """Reference ``make_train_step`` (optimizer.py:109): the train step
    (loss → grads → clip → AdamW) ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with metrics ``loss``, ``lr`` and
    ``grad_norm`` (float32 0-d tensors). ``params`` and ``opt_state`` are
    updated in place and returned.

    ``n_microbatches > 1`` accumulates the gradients of that many slices of
    the batch in ``accum_dtype`` (float32 by default), then takes their
    mean in float32, and the loss is the mean of the slices' losses, as the
    reference's scan does. The sums and the mean are taken in place on the
    accumulator, and each slice's gradient is dropped once added, so the
    loop holds the accumulator and at most one slice's gradient. With no
    mesh an MoE FFN is the dense form.

    Over a ``DeviceMesh`` ``mesh`` each rank passes the global batch and
    its own shards: ``params`` in the layout ``param_out_shardings``
    (``distributed.sharding.compute_shardings`` of ``moe_impl`` by
    default) and ``opt_state`` from ``opt_init`` with the same shardings.
    The step takes the rank's rows of the batch (:func:`_data_rows`). With
    ``grad_shardings`` (ZeRO-2; the reference's ``param_shardings(...,
    extra_batch_dim=True)``) each microbatch's gradient shares are
    reduce-scattered into that layout and accumulated there, and
    ``opt_update`` runs ZeRO-1 on it; without, the shares are summed
    whole (data parallelism) and the moments are whole. ``rules`` are the
    reference's axis rules the forward computes under (``models.loss_sums``:
    Megatron-SP with ``seq_sp``, the ZeRO-3 experts' ``fsdp``)."""
    if mesh is None:
        return _train_step(cfg, opt, n_microbatches, accum_dtype)
    if param_out_shardings is None:
        from ..distributed.sharding import compute_shardings
        from ..models import param_specs
        param_out_shardings = compute_shardings(param_specs(cfg), mesh, cfg,
                                                moe_impl)
    zero = grad_shardings if grad_shardings is not None \
        else param_out_shardings
    m = n_microbatches

    def train_step(params, opt_state, batch):
        layouts = _layouts(params, zero, param_out_shardings)
        rows = _data_rows(batch, mesh)
        gacc, losses = None, []
        for i in range(m):
            loss_i, g = _mesh_loss_and_grads(
                params, rows if m == 1 else _micro(rows, m, i), cfg, mesh,
                moe_impl, rules)
            red = [tuple(lay.reduce(u) for u in node)
                   if isinstance(node, tuple) else lay.reduce(node)
                   for (_, node, _), lay in zip(_param_leaves(params, g),
                                                layouts)]
            del g
            for blocks, device in _RECORDERS:
                blocks.extend(u.to(device or u.device, copy=True)
                              for node in red for u in (
                                  node if isinstance(node, tuple)
                                  else (node,)))
            if m > 1:
                gacc = _accumulate(gacc, red, accum_dtype)
                del red
            losses.append(loss_i)
        if m > 1:
            red = _mean_(gacc, m)
        loss = losses[0] if m == 1 else torch.stack(losses).mean()
        params, opt_state, opt_metrics = opt_update(
            opt, params, rebuild(params, red), opt_state,
            zero_shardings=zero, out_shardings=param_out_shardings)
        return params, opt_state, {"loss": loss, **opt_metrics}
    return train_step


def _accumulate(gacc, g, dtype):
    """Adds a microbatch's gradient ``g`` into the accumulator ``gacc`` in
    place and returns it; the first (``gacc`` None) is a copy of ``g`` in
    ``dtype``. The caller drops ``g`` after it, so that a step holds the
    accumulator and at most one microbatch's gradient."""
    if gacc is None:
        return tree_map(lambda x: x.to(dtype, copy=True), g)
    tree_map(lambda a, x: a.add_(x), gacc, g)
    return gacc


def _mean_(gacc, m: int):
    """The accumulated gradients' mean in float32, as the reference takes
    it (``g.astype(float32) / m``): in place on a float32 accumulator."""
    return tree_map(lambda a: a.float().div_(m), gacc)


def _train_step(cfg, opt, n_microbatches, accum_dtype):
    """The train step on one device."""
    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, batch, cfg)
        else:
            m = n_microbatches
            gacc, losses = None, []
            for i in range(m):
                loss_i, _, g = loss_and_grads(params, _micro(batch, m, i),
                                              cfg)
                gacc = _accumulate(gacc, g, accum_dtype)
                del g
                losses.append(loss_i)
            grads = _mean_(gacc, m)
            loss = torch.stack(losses).mean()
            metrics = {"loss": loss}
        params, opt_state, opt_metrics = opt_update(opt, params, grads,
                                                    opt_state)
        return params, opt_state, {**metrics, **opt_metrics}
    return train_step
