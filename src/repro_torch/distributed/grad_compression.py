"""Port of ``src/repro/distributed/grad_compression.py``: int8
error-feedback gradient compression for the cross-pod all-reduce.

The scheme, in the reference's float32 arithmetic::

  g_eff = g + e_prev                (error feedback)
  q     = round(g_eff / s) ∈ int8,  s = max(max|g_eff|, 1e-12) / 127
  e     = g_eff - q·s               (residual carried to the next step)
  allreduce(q) over the pod axis    (int32 sum; the scale's max)

``torch.round`` rounds half to even, as ``jnp.round`` does, and the
quotient is a division (not a product with the reciprocal), so
:func:`compress` and :func:`decompress` are the reference's bit for bit.
The reference's docstring names a ``--grad-compression`` flag of its
launcher that the launcher never had; the port adds none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import leaves, rebuild, tree_map

__all__ = ["compress", "decompress", "ef_allreduce", "init_error"]


def init_error(grads):
    """Float32 zero residuals like every leaf of ``grads``."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress(g, err):
    """(q int8, scale float32 0-d, new residual float32) of ``g`` with the
    residual ``err`` fed back."""
    g_eff = g.float() + err
    scale = torch.clamp(g_eff.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g_eff / scale), -127, 127).to(torch.int8)
    return q, scale, g_eff - q.float() * scale


def decompress(q, scale):
    return q.float() * scale


def ef_allreduce(grads, errors, group_or_mesh, axis: str = "pod"):
    """Error-feedback int8 all-reduce of a gradient tree over one mesh
    axis: ``axis`` of a ``DeviceMesh``, or a process group as it is.
    Each leaf is compressed, its int8 codes summed over the ranks as int32
    and its scale replaced by the largest (a shared, conservative scale);
    the mean is ``summed · s_max / n``. Returns (the mean gradients
    float32, the new residuals)."""
    group = group_or_mesh.get_group(axis) \
        if hasattr(group_or_mesh, "get_group") else group_or_mesh
    n = dist.get_world_size(group)

    def one(g, e):
        q, scale, new_err = compress(g, e)
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        s_max = scale.clone()
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        return summed.float() * s_max / n, new_err

    pairs = [one(g, e) for g, e in zip(leaves(grads), leaves(errors))]
    return (rebuild(grads, [p[0] for p in pairs]),
            rebuild(grads, [p[1] for p in pairs]))
