"""Port of ``src/repro/core/exact.py``: exact SF-ESP solver for small
instances (greedy optimality-gap tests), copied from the JAX package.

The SF-ESP is NP-hard (paper Thm. 1, reduction from 0/1 d-KP), so exhaustive
search is only viable for tiny T·A. Once z*_τ is fixed by Eq. (2) — which is
optimal whenever l is monotone increasing in z, the paper's stated assumption —
the residual problem is exactly the multidimensional knapsack over (task,
allocation) pairs; we solve it by depth-first branch and bound with an
optimistic fractional bound.
"""

from __future__ import annotations

import numpy as np

from .greedy import _pack_solution, _select_tables
from .types import ProblemInstance, Solution

__all__ = ["solve_exact"]


def solve_exact(inst: ProblemInstance, *, semantic: bool = True,
                max_nodes: int = 2_000_000) -> Solution:
    lat, z_idx = _select_tables(inst, semantic)
    T, A = lat.shape
    S, p = inst.pool.capacity, inst.pool.price
    grid = inst.grid

    lat_ok = lat <= inst.tasks.max_latency[:, None]
    candidate = (z_idx >= 0) & lat_ok.any(axis=1)
    value = (p * (S - grid)).sum(axis=1)                   # (A,) Eq. (1a) term
    # per task: allocations sorted by value descending (best-first branching)
    task_allocs = [np.nonzero(lat_ok[t])[0][np.argsort(-value[lat_ok[t]])]
                   if candidate[t] else np.empty(0, np.int64)
                   for t in range(T)]
    vmax = np.array([value[a[0]] if len(a) else 0.0 for a in task_allocs])
    # process tasks in descending best-value order for tighter bounds
    order = np.argsort(-vmax)

    best = {"obj": -1.0, "choice": None, "nodes": 0}

    def dfs(pos: int, remaining: np.ndarray, obj: float, choice: list):
        if best["nodes"] >= max_nodes:
            return
        best["nodes"] += 1
        # optimistic bound: admit every later task at its best-value allocation
        bound = obj + vmax[order[pos:]].sum()
        if bound <= best["obj"] + 1e-12:
            return
        if pos == T:
            if obj > best["obj"]:
                best["obj"], best["choice"] = obj, list(choice)
            return
        t = order[pos]
        # branch 1..: admit with each feasible allocation (value-descending)
        for a in task_allocs[t]:
            s = grid[a]
            if (s <= remaining + 1e-9).all():
                choice.append((t, int(a)))
                dfs(pos + 1, remaining - s, obj + value[a], choice)
                choice.pop()
        # branch 0: reject
        dfs(pos + 1, remaining, obj, choice)
        # record leaf-free best (pos==T handles it; also record here so that
        # pruned-at-max_nodes runs still return the incumbent)
        if obj > best["obj"]:
            best["obj"], best["choice"] = obj, list(choice)

    dfs(0, S.astype(np.float64).copy(), 0.0, [])

    admitted = np.zeros(T, bool)
    alloc_idx = np.full(T, -1, np.int64)
    for t, a in (best["choice"] or []):
        admitted[t] = True
        alloc_idx[t] = a
    return _pack_solution(inst, semantic, admitted, alloc_idx, z_idx)
