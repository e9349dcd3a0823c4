"""Collectives over one axis of a ``DeviceMesh``, with autograd.

The reference writes its mesh forms as ``shard_map`` bodies and lets
``jax.value_and_grad`` differentiate through ``psum``, ``all_gather`` and
``all_to_all``. The port runs the same bodies on local shards, so its
collectives must carry the gradient themselves. Each function here is
the true adjoint pair: the backward of a sum over ranks is the sum of
the gradients over ranks, the backward of a gather is the reduce-scatter
of the gradient, and the backward of an all-to-all is the all-to-all of
the gradient. Under this rule a leaf held whole on several ranks gets,
on each, its share of the gradient, and the train step sums the shares
over those ranks (``training/optimizer.py``).

They are written here, not taken from ``torch.distributed.nn.functional``:
that module is deprecated (each call warns, pointing to the private
``torch.distributed._functional_collectives``), its one-tensor gather
``_all_gather_base`` raises in its backward on gloo, the backend of the
CPU tests, and its ``all_gather`` returns a tuple a rank whose gloo
backward scatters once a rank. :func:`sum_over` and
:func:`reduce_scatter` carry no autograd: the train step calls them on
gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_reduce", "all_to_all", "axis_index",
           "axis_size", "reduce_scatter", "sum_over"]


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along mesh axis ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis``."""
    return mesh.get_local_rank(axis)


def _gather(x, group, dim: int):
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _scatter_sum(x, group, dim: int):
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dimension {dim} of size {xm.shape[0]} does not "
                         f"split over {n} ranks")
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


def all_reduce(x, mesh, axis: str):
    """The sum of ``x`` over mesh axis ``axis`` (``jax.lax.psum``)."""
    return _AllReduce.apply(x, mesh.get_group(axis))


def all_gather(x, mesh, axis: str, dim: int):
    """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in rank
    order (``jax.lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, mesh.get_group(axis), dim)


def all_to_all(x, mesh, axis: str):
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``: dim 0 cut into
    one block a rank; rank j receives every rank's j-th block, in rank
    order."""
    return _AllToAll.apply(x, mesh.get_group(axis))


def reduce_scatter(x, mesh, axis: str, dim: int):
    """The sum of ``x`` over ``axis``, of which this rank keeps its block
    of ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``); no autograd."""
    return _scatter_sum(x, mesh.get_group(axis), dim)


def sum_over(t, mesh, axes):
    """``t`` summed over the ranks of mesh axes ``axes``, one
    all-reduce an axis (a new tensor; ``t`` itself where ``axes`` is
    empty); no autograd."""
    if not axes:
        return t
    t = t.clone(memory_format=torch.contiguous_format)
    for ax in axes:
        dist.all_reduce(t, group=mesh.get_group(ax))
    return t
