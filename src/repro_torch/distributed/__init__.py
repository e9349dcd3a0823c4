"""Port of ``src/repro/distributed``: the training mesh's logical-axis
sharding rules, the compute layout and the dense tensor-parallel plan
(``sharding``), the int8 error-feedback all-reduce (``grad_compression``),
and the collectives with autograd that the mesh forms of the train step,
the dense split forms and the MoE run on local shards (``collectives``).

The reference's ``distributed/compat.py`` is a shim over JAX versions for
``shard_map``'s replication-check keyword (``shard_map_nocheck``); the port
has no ``shard_map`` to shim, so it has no counterpart. A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` (its process groups, one per
mesh axis), or a :class:`~repro_torch.distributed.sharding.MeshShape` where
only the axis names and sizes are needed.
"""

from .collectives import (all_gather, all_reduce, all_to_all, axis_index,
                          axis_size, tp_exit)
from .grad_compression import compress, decompress, ef_allreduce, init_error
from .sharding import (DEFAULT_RULES, MeshShape, NamedSharding, TPPlan,
                       axis_rules, batch_axes, compute_shardings, constrain,
                       current_mesh, logical_to_spec, named_sharding_for,
                       param_shardings, to_placements, tp_plan)

__all__ = [
    "DEFAULT_RULES", "MeshShape", "NamedSharding", "TPPlan", "all_gather",
    "all_reduce", "all_to_all", "axis_index", "axis_rules", "axis_size",
    "batch_axes", "compress", "compute_shardings", "constrain",
    "current_mesh", "decompress", "ef_allreduce", "init_error",
    "logical_to_spec", "named_sharding_for", "param_shardings",
    "to_placements", "tp_exit", "tp_plan",
]
