"""Port of ``src/repro/core/baselines.py``: the five comparison baselines
of paper Section V-A, copied from the JAX package.

1. **SI-EDGE**      — state of the art [11]: semantics-agnostic ("All" curve),
                      minimum-resource allocation per task.
2. **MinRes-SEM**   — semantic z*, but minimum-resource allocation (no Eq. 3).
3. **FlexRes-N-SEM**— flexible allocation per Eq. (3), agnostic z*.
4. **HighComp**     — compress every task to 10 % of original size (mAP ≈ 0.25
                      on COCO), minimum resources; requirement-agnostic.
5. **HighRes**      — statically allocate 20 % of every resource per task, no
                      compression; requirement-agnostic.

SEM-O-RAN itself is (semantic=True, flexible=True). The requirement-aware
baselines 1-3 reuse the greedy skeleton with flags; 4-5 are separate because
they ignore the accuracy/latency requirements when allocating (their tasks can
be *allocated but unsatisfied* — exactly the failure mode Fig. 6/7 discusses).

``backend="torch"`` (the counterpart of the reference's ``"jax"``) runs the
four greedy algorithms through the single-instance device solve
``greedy.solve_greedy_torch`` on ``device``, whose rounds launch K2 on CUDA
(``inner`` as there); the numpy oracle stays the default. HighComp and
HighRes are host-side in either backend, as in the reference.
"""

from __future__ import annotations

import numpy as np

from . import latency as lat_mod
from . import semantics
from .greedy import (_pack_solution, _select_tables, lexicographic_cost,
                     primal_gradient, solve_greedy, solve_greedy_torch)
from .sfesp import merge_coupling, objective_value, task_link_load
from .types import CouplingSpec, ProblemInstance, Solution

__all__ = ["ALGORITHMS", "run_algorithm", "solve_coupled_ref"]

_BACKENDS = ("numpy", "torch")


def _greedy(inst, backend, inner, device, *, semantic, flexible):
    if backend == "torch":
        return solve_greedy_torch(inst, semantic=semantic, flexible=flexible,
                                  inner=inner, device=device)
    return solve_greedy(inst, semantic=semantic, flexible=flexible)


def _sem_o_ran(inst, backend="numpy", inner=None, device="cuda"):
    return _greedy(inst, backend, inner, device, semantic=True,
                   flexible=True)


def _si_edge(inst, backend="numpy", inner=None, device="cuda"):
    return _greedy(inst, backend, inner, device, semantic=False,
                   flexible=False)


def _minres_sem(inst, backend="numpy", inner=None, device="cuda"):
    return _greedy(inst, backend, inner, device, semantic=True,
                   flexible=False)


def _flexres_nsem(inst, backend="numpy", inner=None, device="cuda"):
    return _greedy(inst, backend, inner, device, semantic=False,
                   flexible=True)


def _fixed_z_solution(inst: ProblemInstance, z_fixed: np.ndarray,
                      alloc: np.ndarray, admitted: np.ndarray) -> Solution:
    t = inst.tasks
    a_true = semantics.resolve(inst.semantics).accuracy(t.app_idx, z_fixed)
    l_true = lat_mod.latency(lat_mod.LatencyParams(), t.bits_per_job,
                             t.jobs_per_sec, t.gpu_time_per_job, z_fixed, alloc)
    satisfied = admitted & (a_true + 1e-9 >= t.min_accuracy) \
        & (l_true <= t.max_latency + 1e-9)
    return Solution(admitted=admitted, alloc=alloc * admitted[:, None],
                    z=np.where(admitted, z_fixed, 1.0),
                    objective=objective_value(inst, admitted, alloc),
                    satisfied=satisfied)


def _high_comp(inst: ProblemInstance, backend="numpy", inner=None,
               device="cuda") -> Solution:
    """z = 0.10 for everyone; min-cost allocation meeting *latency only*
    (requirement-agnostic w.r.t. accuracy); greedy value-density admission."""
    T = inst.num_tasks
    t, grid, S, p = inst.tasks, inst.grid, inst.pool.capacity, inst.pool.price
    z = np.full(T, 0.10)
    lat = lat_mod.latency(
        lat_mod.LatencyParams(), t.bits_per_job[:, None],
        t.jobs_per_sec[:, None], t.gpu_time_per_job[:, None],
        z[:, None], grid[None])
    lat_ok = lat <= t.max_latency[:, None]
    cost = (grid * p).sum(axis=1)
    admitted = np.zeros(T, bool)
    alloc = np.zeros((T, inst.m))
    remaining = S.astype(float).copy()
    # admit cheapest-first (maximizes count for a requirement-agnostic scheme)
    best_a = np.where(lat_ok, cost[None, :], np.inf).argmin(axis=1)
    has = lat_ok.any(axis=1)
    for tau in np.argsort(np.where(has, cost[best_a], np.inf)):
        if not has[tau]:
            continue
        s = grid[best_a[tau]]
        if (s <= remaining + 1e-9).all():
            admitted[tau] = True
            alloc[tau] = s
            remaining -= s
    return _fixed_z_solution(inst, z, alloc, admitted)


def _high_res(inst: ProblemInstance, backend="numpy", inner=None,
              device="cuda") -> Solution:
    """Static 20 %-of-capacity slice per task, z = 1, admit in arrival order."""
    T = inst.num_tasks
    S = inst.pool.capacity
    # snap the 20% slice onto the discrete grid (ceil to available levels)
    want = 0.20 * S
    slice_ = np.array([
        lvls[min(np.searchsorted(lvls, w), len(lvls) - 1)]
        for lvls, w in zip(inst.pool.levels, want)])
    admitted = np.zeros(T, bool)
    alloc = np.zeros((T, inst.m))
    remaining = S.astype(float).copy()
    for tau in range(T):
        if (slice_ <= remaining + 1e-9).all():
            admitted[tau] = True
            alloc[tau] = slice_
            remaining -= slice_
    return _fixed_z_solution(inst, np.ones(T), alloc, admitted)


def solve_coupled_ref(insts, coupling: CouplingSpec | None = None, *,
                      semantic: bool = True, flexible: bool = True
                      ) -> list[Solution]:
    """Numpy oracle for backhaul-coupled multi-cell greedy admission.

    The reference semantics that ``solve_greedy_batch`` reproduces on a
    coupled batch (same float-precision tie-break caveat as every JAX
    backend): Alg. 1 run jointly over all cells of each coupling group —
    per round every cell scores its candidates with its OWN pool gradient,
    tasks whose network load ``b_τ·λ_τ·z*_τ`` no longer fits the remaining
    budget of every shared link their cell traverses are filtered, and only
    the first (cell-major) candidate attaining the group-wide best gradient
    is admitted, charging its load to the links of its cell. ``coupling``
    defaults to the merged per-instance specs; cells with all-zero incidence
    rows (or a ``None`` batch spec) degrade to independent per-cell greedy,
    bit-matching :func:`~repro_torch.core.greedy.solve_greedy` per instance.
    """
    insts = list(insts)
    coupling = merge_coupling(insts) if coupling is None else coupling
    B = len(insts)
    if coupling is None:
        coupling = CouplingSpec(np.zeros(0), np.zeros((B, 0), bool))
    if coupling.num_cells != B:
        raise ValueError(f"coupling has {coupling.num_cells} cells for "
                         f"{B} instances")
    group = coupling.groups()
    inc = coupling.incidence

    tables = [_select_tables(i, semantic) for i in insts]
    lat_ok = [lat <= i.tasks.max_latency[:, None]
              for i, (lat, _) in zip(insts, tables)]
    load = [task_link_load(i, semantic=semantic) for i in insts]
    cost = [lexicographic_cost(i.grid) for i in insts]
    alive = [(z_idx >= 0) & ok.any(axis=1)
             for (_, z_idx), ok in zip(tables, lat_ok)]
    admitted = [np.zeros(i.num_tasks, bool) for i in insts]
    alloc_idx = [np.full(i.num_tasks, -1, np.int64) for i in insts]
    occupied = [np.zeros(i.m) for i in insts]
    link_used = np.zeros(coupling.num_links)

    while any(a.any() for a in alive):
        rem_link = coupling.link_capacity - link_used
        # per-cell best candidate (V_b, tau_b, s*_b) under grid + link budgets
        best: dict[int, tuple[float, int, int]] = {}
        for b, inst in enumerate(insts):
            if not alive[b].any():
                continue
            headroom = rem_link[inc[b]].min() if inc[b].any() else np.inf
            link_ok = load[b] <= headroom + 1e-9
            S, p = inst.pool.capacity, inst.pool.price
            cap_ok = (inst.grid <= (S - occupied[b]) + 1e-9).all(axis=1)
            pg = primal_gradient(inst.grid, p, S, occupied[b])
            feas = lat_ok[b] & cap_ok[None, :] \
                & (alive[b] & link_ok)[:, None]
            has = feas.any(axis=1)
            # line 15: a task infeasible now is infeasible forever (grid and
            # link budgets only shrink), so drop it from the candidate set
            alive[b] &= has
            if not alive[b].any():
                continue
            sel = pg if flexible else -cost[b]
            score = np.where(feas, sel[None, :], -np.inf)
            best_a = score.argmax(axis=1)
            G = np.where(alive[b], pg[best_a], -np.inf)
            tau = int(G.argmax())
            best[b] = (float(G[tau]), tau, int(best_a[tau]))
        # joint selection: first cell-major candidate at each group's max.
        # Cross-cell V comparisons use a relative tolerance: mathematically
        # equal gradients (e.g. identical pools whose occupancy is
        # proportional to capacity, where pg_occ ≡ pg_uniform) differ by
        # O(1e-15) rounding in f64 and would otherwise flip the winner on
        # noise the f32 engine correctly treats as a tie.
        winners: dict[int, int] = {}
        for b in sorted(best):
            g = int(group[b])
            if g not in winners:
                winners[g] = b
                continue
            vw = best[winners[g]][0]
            if best[b][0] > vw + 1e-9 * max(1.0, abs(vw)):
                winners[g] = b
        for b in winners.values():
            _, tau, a = best[b]
            admitted[b][tau] = True
            alloc_idx[b][tau] = a
            occupied[b] = occupied[b] + insts[b].grid[a]
            link_used = link_used + load[b][tau] * inc[b]
            alive[b][tau] = False

    return [_pack_solution(inst, semantic, admitted[b], alloc_idx[b],
                           tables[b][1]) for b, inst in enumerate(insts)]


ALGORITHMS = {
    "sem-o-ran": _sem_o_ran,
    "si-edge": _si_edge,
    "minres-sem": _minres_sem,
    "flexres-n-sem": _flexres_nsem,
    "highcomp": _high_comp,
    "highres": _high_res,
}


def run_algorithm(name: str, inst: ProblemInstance, backend: str = "numpy",
                  *, inner: str | None = None, device="cuda") -> Solution:
    """Run algorithm ``name`` of :data:`ALGORITHMS` on ``inst``:
    ``backend="numpy"`` (the oracle) or ``"torch"`` (the device solve on
    ``device``; ``inner`` as in ``greedy.solve_greedy_torch``)."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    return ALGORITHMS[name](inst, backend=backend, inner=inner,
                            device=device)
