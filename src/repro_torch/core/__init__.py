"""Port of ``src/repro/core``: the SF-ESP data model, instance construction,
stacking cache and batched greedy solve, on PyTorch."""

from .types import (CouplingSpec, ProblemInstance, ResourcePool, Solution,
                    StackedInstances, TaskSet, make_allocation_grid)
from .sfesp import (DeviceStack, TaskRows, build_instance, check_solution,
                    default_z_grid, device_stack, empty_device_stack,
                    lexicographic_cost, merge_coupling, next_pow2,
                    objective_value, restack, stack_instances,
                    task_feasibility_rows, task_link_load)
from .greedy import (dispatch_device_batch, primal_gradient, resolve_inner,
                     solve, solve_device_batch, solve_greedy,
                     solve_greedy_batch, unpack_device_batch)
from . import events
from .semantics import DEFAULT_MODEL, SemanticModel
from . import latency, scenarios, semantics

__all__ = [
    "CouplingSpec", "DEFAULT_MODEL", "DeviceStack", "ProblemInstance",
    "ResourcePool", "SemanticModel", "Solution", "StackedInstances",
    "TaskRows", "TaskSet", "make_allocation_grid",
    "build_instance", "check_solution", "default_z_grid", "device_stack",
    "empty_device_stack", "lexicographic_cost", "merge_coupling",
    "next_pow2", "objective_value", "restack", "stack_instances",
    "task_feasibility_rows", "task_link_load",
    "dispatch_device_batch", "primal_gradient", "resolve_inner", "solve",
    "solve_device_batch", "solve_greedy", "solve_greedy_batch",
    "unpack_device_batch", "events", "latency", "scenarios", "semantics",
]
