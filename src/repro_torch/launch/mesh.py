"""Port of ``src/repro/launch/mesh.py``: the production and test meshes of
the LM stack, the H100's roofline constants, and the 1-D "cells" mesh of
the metro-scale sharded solve.

``make_production_mesh`` is (data 16, model 16), 256 ranks, or (pod 2,
data 16, model 16), 512 ranks, the reference's shapes, so that every
dry-run cell's layout is spec for spec the reference's;
``make_test_mesh`` is a small (data, model) mesh. Both are a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, which the caller starts with as many ranks (a ``fake`` group for
the dry run, ``launch/dryrun.py``). They are functions, so importing this
module starts nothing.

:class:`HW` holds the per-card constants of the roofline terms for an
NVIDIA H100 80GB HBM3 at 700 W, named with the card.

For the metro solve a shard is a block of batch rows on one device. In the
reference a mesh axis names distinct devices, and its tests get eight of
them by faking host devices; here a :class:`CellsMesh` is a plain list of
per-shard devices in which a device may repeat, so the CPU and a single
card run 1, 3 or 8 shards as well, and with several cards the same code
places one shard per card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels import resolve_device

__all__ = ["CellsMesh", "HW", "make_cells_mesh", "make_production_mesh",
           "make_test_mesh"]


def _device_mesh(shape, names, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, device_type: str, multi_pod: bool = False):
    """Reference ``make_production_mesh`` (mesh.py:20): (data 16, model 16)
    or, with ``multi_pod``, (pod 2, data 16, model 16) over the default
    process group of 256 or 512 ranks; the ``pod`` axis is pure data
    parallelism. ``device_type`` is the group's (``cpu`` for the dry run:
    its tensors are ``meta``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, names, device_type)


def make_test_mesh(n_data: int = 2, n_model: int = 4, *, device_type: str):
    """Reference ``make_test_mesh`` (mesh.py:26): a small (data, model)
    mesh over a default group of ``n_data · n_model`` ranks."""
    return _device_mesh((n_data, n_model), ("data", "model"), device_type)


class HW:
    """Roofline constants of one NVIDIA H100 80GB HBM3 (SXM5, 700 W).

    Datasheet figures: the dense bf16 tensor-core peak (989 TFLOP/s, no
    sparsity) and float32's (67 TFLOP/s), the HBM3 rate (3.35 TB/s), NVLink
    4's 450 GB/s a direction (900 GB/s both ways) within a node of eight,
    and the 400 Gb/s (50 GB/s) NDR InfiniBand port a GPU has between
    nodes. ``HBM_BYTES`` is the memory the card reports
    (``torch.cuda.get_device_properties(0).total_memory``, 79.18 GiB),
    read on an H100 80GB HBM3.

    The collective term divides a step's collective operand bytes by
    ``COLLECTIVE_BW``, the InfiniBand port's rate: the production mesh's
    model axis of 16 spans two 8-GPU NVLink domains, and its data axis
    spans nodes, so every ring of either crosses a NIC.
    """

    CARD = "NVIDIA H100 80GB HBM3, 700 W"
    PEAK_FLOPS_BF16 = 989e12
    PEAK_FLOPS_F32 = 67e12
    HBM_BW = 3.35e12
    NVLINK_BW = 450e9
    IB_BW = 50e9
    COLLECTIVE_BW = IB_BW
    HBM_BYTES = 85_017_493_504


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
