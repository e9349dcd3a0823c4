"""Port of ``src/repro/launch/mesh.py``: the 1-D "cells" mesh of the
metro-scale sharded solve (``make_cells_mesh``).

A shard is a block of batch rows on one device. In the reference a mesh
axis names distinct devices, and its tests get eight of them by faking host
devices; here a :class:`CellsMesh` is a plain list of per-shard devices in
which a device may repeat, so the CPU and a single card run 1, 3 or 8
shards as well, and with several cards the same code places one shard per
card. Only ``make_cells_mesh`` is ported: ``make_production_mesh`` and
``make_test_mesh`` build the reference's (data, model) training meshes, and
``HW`` holds TPU roofline constants, which the port does not carry.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import resolve_device

__all__ = ["CellsMesh", "make_cells_mesh"]


@dataclasses.dataclass(frozen=True)
class CellsMesh:
    """A 1-D mesh: ``devices[s]`` is the device of shard ``s`` (repeats
    allowed). ``shape[axis]`` is the shard count, as on the reference's
    ``jax.sharding.Mesh``."""

    devices: tuple[torch.device, ...]
    axis: str = "cells"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a cells mesh needs at least one shard")

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices without repeats, in order of first use."""
        return tuple(dict.fromkeys(self.devices))


def make_cells_mesh(n_shards: int | None = None, *, devices=None,
                    axis: str = "cells") -> CellsMesh:
    """1-D mesh for the sharded coupled solve
    (``core/greedy.py::solve_greedy_sharded``): the batch axis is split
    over ``axis``, one block of coupling groups per shard.

    With no arguments: one shard per visible CUDA device (raises when there
    is none, as ``kernels.resolve_device`` does). ``devices`` names the
    devices to use (``["cpu"]`` for the tests); ``n_shards`` sets the shard
    count, the shards spread over ``devices`` in contiguous blocks, so
    ``make_cells_mesh(8, devices=["cpu"])`` is eight shards on the CPU.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_cells_mesh needs at least one device")
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    n = len(devs) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    return CellsMesh(tuple(devs[s * len(devs) // n] for s in range(n)),
                     axis)
