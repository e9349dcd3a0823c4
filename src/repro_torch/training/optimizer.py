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

The reference's ``zero_shardings``, ``out_shardings``, ``mesh`` and
``grad_shardings`` arguments (ZeRO-1/2 over a device mesh) wait for the
port's ``distributed/``; this step runs on one device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["OptConfig", "global_norm", "loss_and_grads", "lr_schedule",
           "make_train_step", "opt_init", "opt_update", "split_repeats"]


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


def _leaves(tree) -> list:
    """The leaves of a tree in the reference's flattening order: dict keys
    sorted, tuples and lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


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


def _map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return tuple(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


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


def global_norm(tree):
    """Reference ``global_norm`` (optimizer.py:48): the float32 L2 norm of
    every leaf together (a tuple of per-repeat gradients is leaves too),
    summed a piece of at most 2^26 elements at a time."""
    total = None
    for g in _leaves(tree):
        for idx in _pieces(tuple(g.shape)):
            sq = torch.sum(torch.square(g[idx].float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def opt_init(params):
    """Reference ``opt_init`` (optimizer.py:54): float32 zero moments like
    every leaf, and the step count (an int32 0-d tensor)."""
    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    first = _leaves(params)[0]
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


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


def opt_update(opt: OptConfig, params, grads, state):
    """Reference ``opt_update`` (optimizer.py:60), in place: ``params`` and
    ``state``'s moments are updated where they lie and returned with the
    metrics ``{"lr", "grad_norm"}`` (float32 0-d tensors). ``grads`` has
    ``params``' structure; a stacked leaf's gradient may be the tuple of
    its per-repeat gradients, as :func:`loss_and_grads` gives it. Every
    leaf is updated a piece at a time: a stacked one a repeat at a time,
    and any piece cut to at most 2^26 elements, so no float32 transient
    of a whole stack exists. The reference's ZeRO shardings wait for
    ``distributed/``."""
    step = state["step"] + 1
    lr = lr_schedule(opt, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - _f32(opt.b1, stepf) ** stepf
    bc2 = 1 - _f32(opt.b2, stepf) ** stepf
    with torch.no_grad():
        for (p, g, stacked), m, v in zip(_param_leaves(params, grads),
                                         _leaves(state["m"]),
                                         _leaves(state["v"])):
            units = [(p[r], g[r], m[r], v[r]) for r in range(p.shape[0])] \
                if stacked else [(p, g, m, v)]
            for pu, gu, mu, vu in units:
                for idx in _pieces(tuple(pu.shape)):
                    _adamw_(opt, pu[idx], gu[idx], mu[idx], vu[idx], scale,
                            lr, bc1, bc2)
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


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced, in the flattening
    order, by ``leaves``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return tuple(walk(v) for v in t)
        return next(it)
    return walk(tree)


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
        grads = torch.autograd.grad(loss, _leaves(split))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        _rebuild(split, grads)


def _micro(batch, m: int, i: int):
    return {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]
            for k, v in batch.items()}


def make_train_step(cfg, opt: OptConfig, *, n_microbatches: int = 1,
                    accum_dtype=torch.float32):
    """Reference ``make_train_step`` (optimizer.py:109): the train step
    (loss → grads → clip → AdamW) ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` with metrics ``loss``, ``lr`` and
    ``grad_norm`` (float32 0-d tensors). ``params`` and ``opt_state`` are
    updated in place and returned.

    ``n_microbatches > 1`` accumulates the gradients of that many slices of
    the batch in ``accum_dtype`` (float32 by default), then takes their
    mean in float32, and the loss is the mean of the slices' losses, as the
    reference's scan does. The reference's ``mesh``, ``moe_impl``,
    ``grad_shardings`` and ``param_out_shardings`` wait for the port's
    ``distributed/``: on one device an MoE FFN is the dense form."""
    def train_step(params, opt_state, batch):
        if n_microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, batch, cfg)
        else:
            m = n_microbatches
            gacc, losses = None, []
            for i in range(m):
                loss_i, _, g = loss_and_grads(params, _micro(batch, m, i),
                                              cfg)
                gacc = _map(lambda x: x.to(accum_dtype), g) if gacc is None \
                    else _map(lambda a, x: a + x.to(accum_dtype), gacc, g)
                losses.append(loss_i)
            grads = _map(lambda a: a.float() / m, gacc)
            loss = torch.stack(losses).mean()
            metrics = {"loss": loss}
        params, opt_state, opt_metrics = opt_update(opt, params, grads,
                                                    opt_state)
        return params, opt_state, {**metrics, **opt_metrics}
    return train_step
