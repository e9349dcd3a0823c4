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

Dense tensor parallelism (``models/``, ``distributed/sharding.py::
tp_plan``) follows the same rule, so its split forms need one collective
each, at their exit, and none at their entry. A split region (a
column-parallel projection, then a row-parallel one) starts from an input
held whole on every rank and ends in :func:`tp_exit`, the sum of the
ranks' partial outputs, whose backward sums their gradient shares: below
it every rank holds the whole gradient of its own slice (its split leaves
need no further sum over ``model``), and the gradient it hands its whole
input is its slice's contribution, which the shares above add to the
right total. Megatron's pair (an identity whose backward sums at the
entry, a sum whose backward is the identity at the exit) assumes instead
that a whole tensor's gradient is the same on every rank; mixed with the
share rule it would count the region's input gradient ``n`` times and
its split leaves' ``1/n`` times.

Megatron-SP (the reference's ``seq_sp`` → ``model``) keeps that rule with
a pair of true collectives: a region gathers the ranks' blocks of the
sequence at entry (:func:`all_gather`, whose backward reduce-scatters the
gradient shares) and leaves by :func:`seq_exit` (the partials summed, of
which each rank keeps its block; its backward gathers). Below the exit
each rank owns a distinct block, so the gradient it holds there is whole,
not a share. On a gloo group a CUDA tensor's gather and reduce-scatter go
through sums, the only collective gloo carries on CUDA tensors besides
broadcast (``_by_sums``); every other group takes the true collectives.

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
           "axis_size", "max_over", "reduce_scatter", "seq_exit", "sum_over",
           "tp_exit"]


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along mesh axis ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along mesh axis ``axis``."""
    return mesh.get_local_rank(axis)


def _by_sums(group, x) -> bool:
    """Whether a gather or a reduce-scatter of ``x`` over ``group`` takes
    its form through sums: gloo carries only sums (and broadcasts) on CUDA
    tensors, so on a gloo group a CUDA tensor's gather is the sum of the
    ranks' blocks zero-padded to their places, and its reduce-scatter the
    sum of the whole, of which the rank keeps its block. Every other
    backend (NCCL, gloo on CPU tensors, the dry run's ``fake``) takes the
    true collectives, so the dry run counts them by their kind."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _gather(x, group, dim: int, sums: bool | None = None):
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if _by_sums(group, x) if sums is None else sums:
        k = xm.shape[0]
        r = dist.get_rank(group)
        out = xm.new_zeros((n * k,) + tuple(xm.shape[1:]))
        out[r * k:(r + 1) * k] = xm
        dist.all_reduce(out, group=group)
    else:
        out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
        dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _scatter_sum(x, group, dim: int, sums: bool | None = None):
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"dimension {dim} of size {xm.shape[0]} does not "
                         f"split over {n} ranks")
    k = xm.shape[0] // n
    if _by_sums(group, x) if sums is None else sums:
        r = dist.get_rank(group)
        xm = xm.clone()
        dist.all_reduce(xm, group=group)
        out = xm[r * k:(r + 1) * k]
    else:
        out = xm.new_empty((k,) + tuple(xm.shape[1:]))
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


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


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


def tp_exit(x, mesh, axis: str = "model"):
    """The exit of a split region: the ranks' partial outputs ``x`` summed
    over mesh axis ``axis`` in float32 and rounded once to ``x``'s type
    (a bf16 sum would round at every step of the reduction, a rounding
    the meshless product does not have); its backward sums the gradient
    shares, as :func:`all_reduce`'s."""
    return all_reduce(x.float(), mesh, axis).to(x.dtype)


def seq_exit(x, mesh, axis: str = "model", dim: int = 1):
    """The exit of a split region under sequence parallelism (Megatron-SP):
    the ranks' partial outputs ``x`` summed over mesh axis ``axis`` in
    float32, of which this rank keeps its block of the sequence dim
    ``dim``, rounded once to ``x``'s type (``jax.lax.psum_scatter``). Its
    backward is the all-gather of the gradient: below the exit each rank
    owns its block, so the gradient it holds there is whole, and every
    rank's partial reads all of them. The entry of such a region is
    :func:`all_gather`, whose backward reduce-scatters."""
    return _ScatterSum.apply(x.float(), mesh.get_group(axis), dim) \
        .to(x.dtype)


def max_over(t, mesh, axis: str = "model"):
    """The element-wise max of ``t`` over mesh axis ``axis`` (a new
    tensor); no autograd: a shift that cancels in what it feeds (the
    vocab-parallel log-sum-exp's) carries no gradient."""
    t = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return t
