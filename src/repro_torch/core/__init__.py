"""Port of ``src/repro/core``: the SF-ESP data model, instance construction,
stacking cache, the single-instance and batched greedy solves, the paper's
baselines, the exact solver and the scenario library, on PyTorch."""

from .types import (CouplingSpec, ProblemInstance, ResourcePool, Solution,
                    StackedInstances, TaskSet, make_allocation_grid)
from .sfesp import (DeviceStack, ShardedStack, TaskRows, build_instance,
                    check_solution, default_z_grid, device_stack,
                    device_stack_sharded, empty_device_stack,
                    empty_sharded_stack, group_major_order, group_offsets_of,
                    lexicographic_cost, merge_coupling, next_pow2,
                    objective_value, restack, shard_plan, stack_instances,
                    task_feasibility_rows, task_link_load)
from .greedy import (dispatch_device_batch, dispatch_sharded_batch,
                     primal_gradient, resolve_inner, solve,
                     solve_device_batch, solve_greedy, solve_greedy_batch,
                     solve_greedy_many, solve_greedy_sharded,
                     solve_greedy_torch, solve_sharded_batch,
                     unpack_device_batch, unpack_sharded_batch)
from . import events
from .semantics import DEFAULT_MODEL, SemanticModel
from .exact import solve_exact
from .baselines import ALGORITHMS, run_algorithm, solve_coupled_ref
from . import latency, scenarios, semantics

__all__ = [
    "CouplingSpec", "DEFAULT_MODEL", "DeviceStack", "ProblemInstance",
    "ResourcePool", "SemanticModel", "ShardedStack", "Solution",
    "StackedInstances", "TaskRows", "TaskSet", "make_allocation_grid",
    "build_instance", "check_solution", "default_z_grid", "device_stack",
    "device_stack_sharded", "empty_device_stack", "empty_sharded_stack",
    "group_major_order", "group_offsets_of", "lexicographic_cost",
    "merge_coupling", "next_pow2", "objective_value", "restack",
    "shard_plan", "stack_instances", "task_feasibility_rows",
    "task_link_load",
    "dispatch_device_batch", "unpack_device_batch",
    "dispatch_sharded_batch", "unpack_sharded_batch",
    "primal_gradient", "resolve_inner", "solve", "solve_device_batch",
    "solve_greedy", "solve_greedy_batch", "solve_greedy_many",
    "solve_greedy_sharded", "solve_greedy_torch", "solve_sharded_batch",
    "solve_exact", "solve_coupled_ref", "ALGORITHMS", "run_algorithm",
    "events", "latency", "scenarios", "semantics",
]
