"""Port of ``src/repro/core/sfesp.py``: instance construction, stacking and
the device-resident halves of the stacking cache.

The host half (Eq. (2) min-z, latency tables, padded stacking, the
group-major layout, validation) stays numpy, value for value the
reference's. The device half holds the solver inputs as torch tensors on an
explicit device: :class:`DeviceStack`, :func:`device_stack` (memoized per
stacked batch) and :func:`empty_device_stack` with its delta scatters
(:meth:`DeviceStack.update_rows`, :meth:`~DeviceStack.update_link_budgets`,
:meth:`~DeviceStack.update_semantics`). The sharded half lays a group-major
batch out over a ``launch/mesh.py::CellsMesh``: :class:`ShardedStack`,
:func:`device_stack_sharded` and :func:`empty_sharded_stack`, with the
reference's shard plan (:func:`shard_plan`) number for number. It holds ONE
:class:`DeviceStack` per distinct device of the mesh, with the rows of
every shard placed there, so the batched solve (K1 on a card) reads it
unchanged.

Where JAX *rebinds* a donated buffer on every scatter, the port updates the
device tensors IN PLACE; :meth:`DeviceStack.inputs` says why a dispatched
solve still reads the rows it was dispatched with.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from . import latency as lat_mod
from . import semantics
from .types import (CouplingSpec, ProblemInstance, ResourcePool, Solution,
                    StackedInstances, TaskSet, make_allocation_grid)

__all__ = ["build_instance", "check_solution", "objective_value",
           "default_z_grid", "stack_instances", "restack", "next_pow2",
           "task_link_load", "merge_coupling", "lexicographic_cost",
           "group_major_order", "group_offsets_of",
           "TaskRows", "task_feasibility_rows",
           "DeviceStack", "GroupCSR", "group_csr", "device_stack",
           "empty_device_stack", "ShardedStack", "shard_plan",
           "device_stack_sharded", "empty_sharded_stack"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1) — the sweep engine's padding
    buckets: padding Tmax/B to buckets means fluctuating trace sizes hit a
    handful of cached device programs instead of recompiling per shape."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def default_z_grid(n: int = 64) -> np.ndarray:
    """Log-spaced compression factors in (0.02, 1] — covers the paper's range
    (Fig. 7 picks factors down to 0.04)."""
    return np.geomspace(0.02, 1.0, n)


def lexicographic_cost(grid) -> np.ndarray:
    """MinRes-* allocation preference: minimize the LAST resource type first
    (compute), then the previous, ... matching the paper's observed behaviour
    (Fig. 7(e): MinRes-SEM requests 8 RBG + 1 GPU where SEM-O-RAN picks
    6 RBG + 5 GPU — compute is treated as the precious resource and radio
    compensates). Encoded as Σ_k s_k · W^k with a large base W."""
    grid = np.asarray(grid)
    m = grid.shape[-1]
    weights = np.asarray([float(1000 ** k) for k in range(m)])
    return (grid * weights).sum(axis=-1)


@dataclasses.dataclass(frozen=True)
class TaskRows:
    """Output of :func:`task_feasibility_rows` — everything the per-task
    pipeline derives from the accuracy curves, for one solver mode."""

    z_idx: np.ndarray    # (T,) int — Eq. (2) z* index into z_grid, -1 pruned
    z_star: np.ndarray   # (T,) — z_grid[z_idx] (1.0 where pruned)
    lat: np.ndarray      # (T, A) — l_τ(z*, s_a) over the allocation grid
    lat_ok: np.ndarray   # (T, A) bool — meets L_c at that allocation
    alive: np.ndarray    # (T,) bool — Alg. 1 line-7 candidate filter
    load: np.ndarray     # (T,) — shared-link load b_τ·λ_τ·z*_τ


def task_feasibility_rows(tasks: TaskSet, z_grid: np.ndarray,
                          grid: np.ndarray,
                          lat_params: lat_mod.LatencyParams | None = None, *,
                          semantic: bool = True,
                          model=None) -> TaskRows:
    """Eq. (2) → latency table → candidate feasibility, per task.

    THE single implementation of the min-z pipeline: instance construction
    (:func:`build_instance`) and the serving delta path
    (``serving.admission.SESM._sync_rows``) both call it, so a drifted
    :class:`~repro_torch.core.semantics.SemanticModel` produces identical rows
    whether a stack is rebuilt from scratch or delta-scattered in place.
    ``semantic=False`` evaluates Eq. (2) on the service-wide 'All' fallback
    curve (``model.agnostic_app``) instead of each task's own.
    """
    model = semantics.resolve(model)
    lat_params = lat_params or lat_mod.LatencyParams()
    app = tasks.app_idx if semantic else model.agnostic_app(tasks.app_idx)
    z_idx = model.min_z_for_accuracy(app, tasks.min_accuracy, z_grid)
    # pruned tasks get z=1 rows; they are excluded by z_idx == -1 anyway
    z = _z_star_of(z_grid, z_idx)
    lat = lat_mod.latency_table(lat_params, tasks, z, grid)
    lat_ok = lat <= tasks.max_latency[:, None]
    alive = (z_idx >= 0) & lat_ok.any(axis=1)
    load = tasks.bits_per_job * tasks.jobs_per_sec * z
    return TaskRows(z_idx=z_idx, z_star=z, lat=lat, lat_ok=lat_ok,
                    alive=alive, load=load)


def build_instance(pool: ResourcePool, tasks: TaskSet,
                   lat_params: lat_mod.LatencyParams | None = None,
                   z_grid: np.ndarray | None = None,
                   coupling: CouplingSpec | None = None,
                   model=None) -> ProblemInstance:
    model = semantics.resolve(model)
    lat_params = lat_params or lat_mod.LatencyParams()
    z_grid = default_z_grid() if z_grid is None else np.asarray(z_grid)
    grid = make_allocation_grid(pool.levels)

    acc = model.accuracy_table(tasks.app_idx, z_grid)
    acc_agn = model.accuracy_table(model.agnostic_app(tasks.app_idx), z_grid)

    sem = task_feasibility_rows(tasks, z_grid, grid, lat_params,
                                semantic=True, model=model)
    agn = task_feasibility_rows(tasks, z_grid, grid, lat_params,
                                semantic=False, model=model)

    return ProblemInstance(
        pool=pool, tasks=tasks, z_grid=z_grid,
        acc=acc, acc_agnostic=acc_agn, grid=grid,
        lat=sem.lat, lat_agnostic=agn.lat,
        z_star_idx=sem.z_idx, z_star_idx_agnostic=agn.z_idx,
        coupling=coupling, semantics=model,
    )


def task_link_load(inst: ProblemInstance, *, semantic: bool = True
                   ) -> np.ndarray:
    """Per-task shared-link load ``b_τ · λ_τ · z*_τ`` (Mbit/s) → (T,).

    The network traffic an admitted task puts on every shared link its cell
    traverses — the quantity SEM-O-RAN's semantic compression shrinks, and the
    quantity a :class:`~repro_torch.core.types.CouplingSpec` budgets.
    """
    z_idx = inst.z_star_idx if semantic else inst.z_star_idx_agnostic
    z = _z_star_of(inst.z_grid, z_idx)
    return inst.tasks.bits_per_job * inst.tasks.jobs_per_sec * z


def merge_coupling(insts: Sequence[ProblemInstance]) -> CouplingSpec | None:
    """Merge per-instance single-cell coupling rows into one (B, L) spec.

    Every coupled instance must reference the SAME shared link set — the
    identical ``link_capacity`` array OBJECT (build all per-cell rows from
    one spec / one capacity array, as ``CouplingSpec.row`` and the scenario
    generators do). Identity rather than value equality is deliberate: two
    logically independent deployments can carry equal budget vectors, and
    merging them by value would silently charge both against one budget.
    Instances without a spec become all-zero (uncoupled) rows. Returns
    ``None`` when no instance is coupled.
    """
    specs = [inst.coupling for inst in insts]
    ref = next((s for s in specs if s is not None), None)
    if ref is None:
        return None
    inc = np.zeros((len(insts), ref.num_links), bool)
    for b, spec in enumerate(specs):
        if spec is None:
            continue
        if spec.incidence.shape != (1, ref.num_links) or \
                spec.link_capacity is not ref.link_capacity or \
                spec.names != ref.names:
            raise ValueError(
                "all coupled instances in a batch must reference one shared "
                "link set (the same link_capacity array object, single-row "
                "incidence) — build per-cell rows from one CouplingSpec")
        inc[b] = spec.incidence[0]
    return CouplingSpec(ref.link_capacity, inc, ref.names)


def group_major_order(insts: Sequence[ProblemInstance]) -> np.ndarray:
    """Permutation putting every coupling group's instances contiguous.

    The stable sort by group id (``CouplingSpec.groups`` on the merged batch
    spec): instances of one connected component become a contiguous span of
    the batch axis while their RELATIVE order — the cell-major order the
    coupled round's first-cell tie-break scans — is preserved, so solving
    the permuted batch yields bit-identical per-instance decisions.
    Uncoupled instances are singleton groups keyed by their own index.
    """
    insts = tuple(insts)
    coupling = merge_coupling(insts)
    if coupling is None:
        return np.arange(len(insts), dtype=np.int64)
    return np.argsort(coupling.groups(), kind="stable").astype(np.int64)


def group_offsets_of(coupling: CouplingSpec | None,
                     batch_size: int) -> np.ndarray:
    """Span boundaries (G+1,) of a GROUP-MAJOR batch's coupling groups.

    Requires the batch to already be in group-major order (each connected
    component contiguous — e.g. after :func:`group_major_order`); raises
    otherwise, because silently returning spans of an interleaved batch
    would let a sharded solve split a coupling group across shards.
    """
    if coupling is None:
        return np.arange(batch_size + 1, dtype=np.int64)
    gid = coupling.groups()
    changed = np.r_[True, gid[1:] != gid[:-1]]
    starts = np.flatnonzero(changed)
    if len(np.unique(gid)) != len(starts):
        raise ValueError(
            "batch is not group-major: a coupling group occupies "
            "non-contiguous rows; permute via group_major_order first")
    return np.r_[starts, batch_size].astype(np.int64)


def _check_shared_grid(insts: Sequence[ProblemInstance], grid: np.ndarray,
                       what: str):
    for inst in insts:
        if not np.array_equal(inst.grid, grid):
            raise ValueError(
                f"all {what} instances must share one allocation grid "
                "(identical pool.levels); mixed-grid sets are not ported yet")


def _shared_model(insts: Sequence[ProblemInstance], what: str):
    """The one SemanticModel of a batch (identity check, None = default).

    Mixing models in one stack would bake rows from different curve truths
    into one device program — a build error, not something to merge.
    """
    ref = semantics.resolve(insts[0].semantics)
    for inst in insts[1:]:
        if semantics.resolve(inst.semantics) is not ref:
            raise ValueError(
                f"all {what} instances must share one SemanticModel object; "
                "build every cell's instance from the same model")
    return ref


def _z_star_of(z_grid: np.ndarray, z_idx: np.ndarray) -> np.ndarray:
    return np.where(z_idx >= 0, z_grid[np.clip(z_idx, 0, None)], 1.0)


def _fill_stacked(st: StackedInstances, insts: tuple[ProblemInstance, ...],
                  n_tasks: np.ndarray):
    """Vectorized scatter of per-instance fields into the padded buffers.

    One concatenate + one fancy-index store per field instead of a B-fold
    Python copy loop — the stacking cost is dominated by the two (ΣT, A)
    latency-table writes, which run at memcpy speed.
    """
    B = len(insts)
    total = int(n_tasks.sum())
    rows = np.repeat(np.arange(B), n_tasks)
    starts = np.concatenate([[0], np.cumsum(n_tasks)[:-1]]).astype(np.int64)
    cols = np.arange(total) - np.repeat(starts, n_tasks)

    def cat(get):
        return np.concatenate([np.asarray(get(i)) for i in insts], axis=0)

    st.lat[rows, cols] = cat(lambda i: i.lat)
    st.lat_agnostic[rows, cols] = cat(lambda i: i.lat_agnostic)
    st.z_star_idx[rows, cols] = cat(lambda i: i.z_star_idx)
    st.z_star_idx_agnostic[rows, cols] = cat(lambda i: i.z_star_idx_agnostic)
    st.z_star[rows, cols] = cat(lambda i: _z_star_of(i.z_grid, i.z_star_idx))
    st.z_star_agnostic[rows, cols] = cat(
        lambda i: _z_star_of(i.z_grid, i.z_star_idx_agnostic))
    st.app_idx[rows, cols] = cat(lambda i: i.tasks.app_idx)
    st.min_accuracy[rows, cols] = cat(lambda i: i.tasks.min_accuracy)
    st.max_latency[rows, cols] = cat(lambda i: i.tasks.max_latency)
    if st.coupling is not None:
        # only coupled batches read the load tables; skipping them keeps the
        # uncoupled restack hot path free of two per-instance passes
        st.link_load[rows, cols] = cat(lambda i: task_link_load(i))
        st.link_load_agnostic[rows, cols] = cat(
            lambda i: task_link_load(i, semantic=False))
    st.task_mask[rows, cols] = True
    st.capacity[:] = [i.pool.capacity for i in insts]
    st.price[:] = [i.pool.price for i in insts]


def stack_instances(insts: Sequence[ProblemInstance], *,
                    tmax: int | None = None,
                    group_major: bool = False) -> StackedInstances:
    """Stack instances into one padded batch for the sweep engine.

    Instances must share the allocation grid (identical ``pool.levels``);
    capacities/prices may differ per instance (multi-cell pools). Tasks are
    padded to ``Tmax`` with never-feasible rows (lat=+inf, z*_idx=-1) so the
    batched solver's masked rounds ignore them. ``tmax`` overrides the
    natural padding target (must be >= the largest task count) — callers
    pass power-of-two buckets so repeated solves share one shape.

    ``group_major=True`` permutes the instances so every coupling group is a
    contiguous span of the batch axis (the sharded solve's layout),
    recording ``perm`` (stacked row → input index) and ``group_offsets`` on
    the result. Per-instance decisions are unaffected: the stable
    permutation keeps each group's internal cell order, hence the coupled
    tie-breaks.
    """
    insts = tuple(insts)
    if not insts:
        raise ValueError("stack_instances needs at least one instance")
    perm = None
    if group_major:
        perm = group_major_order(insts)
        insts = tuple(insts[i] for i in perm)
    grid = insts[0].grid
    _check_shared_grid(insts[1:], grid, "stacked")
    B = len(insts)
    A, m = grid.shape
    n_tasks = np.array([inst.num_tasks for inst in insts], np.int64)
    natural = max(1, int(n_tasks.max()))
    tmax = natural if tmax is None else int(tmax)
    if tmax < natural:
        raise ValueError(f"tmax={tmax} < largest task count {natural}")

    st = StackedInstances(
        instances=insts, grid=grid,
        capacity=np.zeros((B, m)), price=np.zeros((B, m)),
        lat=np.full((B, tmax, A), np.inf),
        lat_agnostic=np.full((B, tmax, A), np.inf),
        z_star_idx=np.full((B, tmax), -1, np.int64),
        z_star_idx_agnostic=np.full((B, tmax), -1, np.int64),
        z_star=np.ones((B, tmax)), z_star_agnostic=np.ones((B, tmax)),
        app_idx=np.zeros((B, tmax), np.int64),
        min_accuracy=np.full((B, tmax), np.inf),
        max_latency=np.zeros((B, tmax)),
        task_mask=np.zeros((B, tmax), bool), num_tasks=n_tasks,
        link_load=np.zeros((B, tmax)),
        link_load_agnostic=np.zeros((B, tmax)),
        coupling=merge_coupling(insts),
        semantics=_shared_model(insts, "stacked"),
    )
    if group_major:
        st = dataclasses.replace(
            st, perm=perm, group_offsets=group_offsets_of(st.coupling, B))
    _fill_stacked(st, insts, n_tasks)
    return st


def restack(stacked: StackedInstances,
            insts: Sequence[ProblemInstance]) -> StackedInstances:
    """Refill a stacked batch with new instances, REUSING the padded buffers.

    The closed-loop trace case: every step re-solves an admission problem
    whose grid and batch size are fixed while tasks and capacities change;
    reallocating the (B, Tmax, A) latency tables each step dominates the
    host-side cost. Contract: same allocation grid, same batch size, and
    every new instance's task count must fit the existing ``Tmax``
    (otherwise a ValueError asks the caller to re-stack at a larger bucket).

    The returned :class:`StackedInstances` SHARES the buffers of ``stacked``,
    which must not be used afterwards. A group-major batch stays group-major:
    the new instances are re-permuted against their OWN coupling topology
    (which may differ from the old batch's), and ``perm``/``group_offsets``
    are refreshed accordingly.
    """
    insts = tuple(insts)
    if len(insts) != stacked.batch_size:
        raise ValueError(
            f"restack needs the original batch size {stacked.batch_size}, "
            f"got {len(insts)} instances; re-stack instead")
    perm = None
    if stacked.group_major:
        perm = group_major_order(insts)
        insts = tuple(insts[i] for i in perm)
    _check_shared_grid(insts, stacked.grid, "restacked")
    n_tasks = np.array([inst.num_tasks for inst in insts], np.int64)
    if n_tasks.max(initial=0) > stacked.max_tasks:
        raise ValueError(
            f"instance with {int(n_tasks.max())} tasks does not fit the "
            f"stacked Tmax={stacked.max_tasks}; re-stack at a larger bucket")

    # reset padding values, then vectorized refill
    stacked.lat.fill(np.inf)
    stacked.lat_agnostic.fill(np.inf)
    stacked.z_star_idx.fill(-1)
    stacked.z_star_idx_agnostic.fill(-1)
    stacked.z_star.fill(1.0)
    stacked.z_star_agnostic.fill(1.0)
    stacked.app_idx.fill(0)
    stacked.min_accuracy.fill(np.inf)
    stacked.max_latency.fill(0.0)
    stacked.task_mask.fill(False)
    stacked.link_load.fill(0.0)
    stacked.link_load_agnostic.fill(0.0)
    coupling = merge_coupling(insts)
    st = dataclasses.replace(
        stacked, instances=insts, num_tasks=n_tasks, coupling=coupling,
        perm=perm,
        group_offsets=(group_offsets_of(coupling, len(insts))
                       if stacked.group_major else None),
        semantics=_shared_model(insts, "restacked"))
    _fill_stacked(st, insts, n_tasks)
    return st


# ---------------------------------------------------------------------------
# Device half of the stacking cache
#
# * CACHE KEYS — ``device_stack`` memoizes per stacked-batch OBJECT, keyed by
#   ``(semantic, pad_batch_to, semantic_signature, device)``; ``restack``
#   returns a NEW StackedInstances, so a refill drops the device halves.
# * DIRTY ROWS — ``DeviceStack.update_rows`` scatters exactly the rows it is
#   given, pow2-bucketed like the reference; a slot beyond the Tmax bucket
#   raises and the caller rebuilds at a larger bucket.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GroupCSR:
    """A coupled stack's coupling groups as compressed rows, for the
    one-launch solve (``kernels/pg/pg.py::batch_solve``): one thread-block
    cluster walks one group.

    ``rows[offsets[g]:offsets[g + 1]]`` are group g's batch rows in
    ascending order (the coupled solve's first-cell tie-break); groups come
    in the order of their smallest row, as ``CouplingSpec.groups`` names
    them. ``links[link_offsets[g]:link_offsets[g + 1]]`` are the links group
    g's cells traverse, ascending; ``cell_links[cell_link_offsets[b]:
    cell_link_offsets[b + 1]]`` are row b's links as indices into its
    group's span. All int32, views of one device tensor. The topology is
    invariant for a stack's life (``update_link_budgets`` moves budgets
    only), so this is built once, beside ``DeviceStack.group``.
    """

    rows: torch.Tensor
    offsets: torch.Tensor
    links: torch.Tensor
    link_offsets: torch.Tensor
    cell_links: torch.Tensor
    cell_link_offsets: torch.Tensor
    num_groups: int
    max_members: int
    max_links: int
    max_cell_links: int


def group_csr(incidence, group, device) -> GroupCSR:
    """The :class:`GroupCSR` of a (B', L) bool ``incidence`` and its (B',)
    group ids (``CouplingSpec.groups``), on ``device``."""
    incidence = np.asarray(incidence, bool)
    group = np.asarray(group, np.int64)
    order = np.argsort(group, kind="stable")
    ids, gidx, counts = np.unique(group, return_inverse=True,
                                  return_counts=True)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    g_links = np.zeros((len(ids), incidence.shape[1]), bool)
    np.logical_or.at(g_links, gidx, incidence)
    gi, links = np.nonzero(g_links)
    n_links = g_links.sum(axis=1)
    link_offsets = np.concatenate([[0], np.cumsum(n_links)])
    local = np.zeros(incidence.shape[1], np.int64)
    local[links] = np.arange(len(links)) - link_offsets[gi]
    _, cell_links = np.nonzero(incidence)
    cell_link_offsets = np.concatenate([[0],
                                        np.cumsum(incidence.sum(axis=1))])
    parts = (order, offsets, links, link_offsets, local[cell_links],
             cell_link_offsets)
    flat = torch.as_tensor(np.concatenate(parts).astype(np.int32),
                           device=device)
    views = flat.split([len(p) for p in parts])
    return GroupCSR(*views, num_groups=len(ids),
                    max_members=int(counts.max(initial=0)),
                    max_links=int(n_links.max(initial=0)),
                    max_cell_links=int(incidence.sum(axis=1).max(initial=0)))


def _f32(x, device) -> torch.Tensor:
    """Host float64 → device float32 (round to nearest, as ``jnp.asarray``
    does with x64 off)."""
    return torch.as_tensor(np.asarray(x, np.float64), dtype=torch.float32,
                           device=device)


@dataclasses.dataclass
class DeviceStack:
    """Device-resident half of a stacked batch, for ONE solver mode.

    Holds everything the batched greedy consumes as tensors on ``device``,
    so repeated solves re-upload nothing and a serving loop scatters only
    the task rows that changed (:meth:`update_rows`). Invariant tables — the
    allocation grid, the MinRes lexicographic cost, per-cell prices and
    capacities, the coupling topology — upload once at construction. Built
    by :func:`device_stack` (memoized per batch + mode) or as cleared rows by
    :func:`empty_device_stack` (the serving fast path).
    ``rows_scattered``/``scatter_calls`` count delta traffic.
    """

    grid: torch.Tensor                # (A, m) f32
    cost: torch.Tensor                # (A,) f32 lexicographic MinRes cost
    price: torch.Tensor               # (B', m) f32
    capacity: torch.Tensor            # (B', m) f32
    lat_ok: torch.Tensor              # (B', Tmax, A) bool
    alive0: torch.Tensor              # (B', Tmax) bool
    link_load: torch.Tensor           # (B', Tmax) f32 — zeros when uncoupled
    link_cap: torch.Tensor | None     # (L,) f32
    incidence: torch.Tensor | None    # (B', L) bool
    group: torch.Tensor | None        # (B',) int64
    semantic: bool
    batch_size: int                   # real B (B' may include inert padding)
    group_csr: GroupCSR | None = None  # the groups as rows (coupled)
    scatter_calls: int = 0
    rows_scattered: int = 0
    budget_updates: int = 0
    semantic_updates: int = 0         # update_semantics calls (drift traffic)
    semantic_rows: int = 0            # rows re-scattered because curves moved

    @property
    def coupled(self) -> bool:
        return self.link_cap is not None

    @property
    def max_tasks(self) -> int:
        return self.lat_ok.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lat_ok.device

    def inputs(self) -> tuple:
        """The solver's input bindings for one dispatch.

        The reference rebinds donated buffers on every scatter, so a solve
        dispatched earlier keeps the old arrays. Here the scatters of
        :meth:`update_rows` / :meth:`update_link_budgets` write these same
        tensors IN PLACE, and a dispatched solve still reads tick N's rows
        because of STREAM ORDER: on the card the flexible solve is ONE
        launch (``kernels/pg/pg.py::batch_solve``) that
        ``greedy.dispatch_device_batch`` enqueues on the tensors' one stream
        before it returns, and the torch rounds (the CPU, MinRes,
        ``inner="torch"``) are all enqueued before it returns too. So every
        read of these tensors by the solve precedes, in stream order, any
        scatter the serving loop enqueues afterwards for tick N+1, although
        the kernel route returns without waiting on the device. The pending
        handle holds only the solve's own output tensors.
        """
        return (self.lat_ok, self.grid, self.price, self.capacity,
                self.alive0, self.cost, self.link_load, self.link_cap,
                self.incidence, self.group)

    def update_rows(self, b_idx, t_idx, lat_ok_rows, alive_rows,
                    load_rows=None):
        """Delta-scatter changed task rows into the device tensors, in place.

        ``b_idx``/``t_idx`` (D,) address the rows; ``lat_ok_rows`` (D, A)
        bool, ``alive_rows`` (D,) bool, ``load_rows`` (D,) float (zeros when
        None). As in the reference the rows are padded on the host to a
        power-of-two bucket, so uploads come in a handful of shapes; the
        padding rows are dropped on the device (only the first D rows are
        scattered). A ``t_idx`` >= ``max_tasks`` is a bucket overflow: the
        caller must rebuild at a larger Tmax (ValueError).
        """
        b_idx = np.asarray(b_idx, np.int64)
        t_idx = np.asarray(t_idx, np.int64)
        d = len(t_idx)
        if d == 0:
            return
        if t_idx.max(initial=0) >= self.max_tasks:
            raise ValueError(
                f"slot {int(t_idx.max())} does not fit the device bucket "
                f"Tmax={self.max_tasks}; rebuild the stack at a larger "
                "bucket")
        nrows = self.alive0.shape[0]
        if b_idx.max(initial=0) >= nrows or b_idx.min(initial=0) < 0:
            raise ValueError(
                f"cell index {int(b_idx.max())} outside the stacked batch "
                f"of {nrows} rows")
        if load_rows is None:
            load_rows = np.zeros(d)
        pad = next_pow2(d) - d
        lat_ok_rows = np.asarray(lat_ok_rows, bool)
        alive_rows = np.asarray(alive_rows, bool)
        load_rows = np.asarray(load_rows, np.float64)
        if pad:
            b_idx = np.concatenate([b_idx, np.zeros(pad, np.int64)])
            t_idx = np.concatenate(
                [t_idx, np.full(pad, self.max_tasks, np.int64)])
            lat_ok_rows = np.concatenate(
                [lat_ok_rows, np.zeros((pad,) + lat_ok_rows.shape[1:], bool)])
            alive_rows = np.concatenate([alive_rows, np.zeros(pad, bool)])
            load_rows = np.concatenate([load_rows, np.zeros(pad)])
        dev = self.device
        bb = torch.as_tensor(b_idx, device=dev)[:d]
        tt = torch.as_tensor(t_idx, device=dev)[:d]
        self.lat_ok[bb, tt] = torch.as_tensor(lat_ok_rows, device=dev)[:d]
        self.alive0[bb, tt] = torch.as_tensor(alive_rows, device=dev)[:d]
        self.link_load[bb, tt] = _f32(load_rows, dev)[:d]
        self.scatter_calls += 1
        self.rows_scattered += d

    def update_semantics(self, b_idx, t_idx, lat_ok_rows, alive_rows,
                         load_rows=None):
        """Drift half of the delta path: the same scatter as
        :meth:`update_rows`, accounted apart (``semantic_updates`` /
        ``semantic_rows``) so drift traffic is observable apart from churn.
        """
        d = len(np.asarray(t_idx))
        if d == 0:
            return
        self.update_rows(b_idx, t_idx, lat_ok_rows, alive_rows, load_rows)
        self.semantic_updates += 1
        self.semantic_rows += d

    def update_link_budgets(self, budgets):
        """Refresh the (L,) per-link budgets on the device, in place.

        The link SET (incidence, groups) is invariant; changing it is a
        topology change and needs a rebuilt stack (ValueError here).
        """
        if not self.coupled:
            raise ValueError(
                "this stack is uncoupled (no link budgets to update); "
                "introducing links is a topology change — rebuild")
        new = np.asarray(budgets, np.float64)
        if new.shape != tuple(self.link_cap.shape):
            raise ValueError(
                f"budget shape {new.shape} != device link set "
                f"{tuple(self.link_cap.shape)}; changing the link set is a "
                "topology change — rebuild the stack")
        self.link_cap.copy_(_f32(new, self.device))
        self.budget_updates += 1


def _solver_tables(stacked: StackedInstances, semantic: bool):
    """Host-side solver inputs of a stacked batch: (lat_ok, alive0, load)."""
    if semantic:
        lat, z_idx = stacked.lat, stacked.z_star_idx
        load = stacked.link_load
    else:
        lat, z_idx = stacked.lat_agnostic, stacked.z_star_idx_agnostic
        load = stacked.link_load_agnostic
    lat_ok = lat <= stacked.max_latency[:, :, None]       # padded rows: False
    alive0 = (z_idx >= 0) & lat_ok.any(axis=2) & stacked.task_mask
    return lat_ok, alive0, load


def _link_tensors(coupling: CouplingSpec | None, incidence, device):
    if coupling is None:
        return None, None, None, None
    group = CouplingSpec(coupling.link_capacity, incidence).groups()
    return (_f32(coupling.link_capacity, device),
            torch.as_tensor(np.asarray(incidence, bool), device=device),
            torch.as_tensor(group, dtype=torch.int64, device=device),
            group_csr(incidence, group, device))


def device_stack(stacked: StackedInstances, *, semantic: bool = True,
                 pad_batch_to: int | None = None,
                 device="cuda") -> DeviceStack:
    """The memoized device half of ``stacked`` for one solver mode.

    Uploads the solver inputs once and caches the result ON the stacked
    batch (keyed by mode, padding, semantic signature and device); the
    stacked buffers must not be mutated after the first solve (``restack``
    returns a new batch). ``pad_batch_to`` pads the device batch with inert
    instances (never-alive, unit capacity).
    """
    from ..kernels import resolve_device
    dev = resolve_device(device)
    cache = stacked.__dict__.get("_device_half")
    if cache is None:
        cache = {}
        object.__setattr__(stacked, "_device_half", cache)
    key = (bool(semantic), pad_batch_to, stacked.semantic_signature, str(dev))
    if key in cache:
        return cache[key]

    lat_ok, alive0, load = _solver_tables(stacked, semantic)
    price, cap = stacked.price, stacked.capacity
    coupling = stacked.coupling
    coupled = coupling is not None and bool(coupling.incidence.any())
    inc = coupling.incidence if coupled else None
    B = stacked.batch_size
    if pad_batch_to is not None and pad_batch_to > B:
        pad = pad_batch_to - B
        m = stacked.m
        lat_ok = np.concatenate(
            [lat_ok, np.zeros((pad,) + lat_ok.shape[1:], bool)])
        alive0 = np.concatenate(
            [alive0, np.zeros((pad, alive0.shape[1]), bool)])
        # unit capacity keeps the gradient NaN-free; padded instances start
        # with no alive candidates, so they never admit
        price = np.concatenate([price, np.zeros((pad, m))])
        cap = np.concatenate([cap, np.ones((pad, m))])
        load = np.concatenate([load, np.zeros((pad, load.shape[1]))])
        if coupled:
            inc = np.concatenate([inc, np.zeros((pad, inc.shape[1]), bool)])
    link = _link_tensors(coupling if coupled else None, inc, dev)
    out = DeviceStack(
        grid=_f32(stacked.grid, dev),
        cost=_f32(lexicographic_cost(stacked.grid), dev),
        price=_f32(price, dev), capacity=_f32(cap, dev),
        lat_ok=torch.as_tensor(lat_ok, device=dev),
        alive0=torch.as_tensor(alive0, device=dev),
        link_load=_f32(load, dev),
        link_cap=link[0], incidence=link[1], group=link[2],
        semantic=bool(semantic), batch_size=B, group_csr=link[3],
    )
    cache[key] = out
    return out


def empty_device_stack(grid: np.ndarray, price: np.ndarray,
                       capacity: np.ndarray, tmax: int, *,
                       coupling: CouplingSpec | None = None,
                       semantic: bool = True, device="cuda") -> DeviceStack:
    """A device stack of CLEARED rows (never feasible, never alive).

    The serving fast path allocates one per (batch, Tmax bucket) and
    scatters live task rows in as they arrive or change
    (:meth:`DeviceStack.update_rows`); prices, capacities (B, m) and the
    coupling topology are the invariants uploaded here, once.
    """
    from ..kernels import resolve_device
    dev = resolve_device(device)
    price = np.asarray(price)
    B, A = price.shape[0], grid.shape[0]
    coupled = coupling is not None and bool(coupling.incidence.any())
    if coupled and coupling.num_cells != B:
        raise ValueError(
            f"coupling.incidence has {coupling.num_cells} rows for "
            f"{B} cells")
    link = _link_tensors(coupling if coupled else None,
                         coupling.incidence if coupled else None, dev)
    return DeviceStack(
        grid=_f32(grid, dev),
        cost=_f32(lexicographic_cost(grid), dev),
        price=_f32(price, dev), capacity=_f32(capacity, dev),
        lat_ok=torch.zeros((B, tmax, A), dtype=torch.bool, device=dev),
        alive0=torch.zeros((B, tmax), dtype=torch.bool, device=dev),
        link_load=torch.zeros((B, tmax), dtype=torch.float32, device=dev),
        link_cap=link[0], incidence=link[1], group=link[2],
        semantic=bool(semantic), batch_size=B, group_csr=link[3],
    )


# --------------------------------------------------------------- sharded half
#
# * CACHE KEY — ``device_stack_sharded`` memoizes per stacked-batch OBJECT,
#   keyed by ``(mesh, axis, semantic, semantic_signature)``, as the
#   reference does.
# * LAYOUT — the reference's: ``shard_plan`` packs whole coupling groups into
#   ``num_shards`` blocks of ``shard_rows`` rows (LPT), ``row_of`` maps a
#   padded row to its stacked row (-1: inert balance padding), ``padded_of``
#   is its inverse and ``group`` holds each row's shard-LOCAL group id.
# * PLACEMENT — one DeviceStack per DISTINCT device of the mesh, holding the
#   padded blocks of the shards placed there in shard order. Its group ids
#   are device-global (``k * shard_rows + local`` for the k-th shard on the
#   device): local ids repeat from shard to shard, and two shards on one
#   device must not merge into one coupling group of K1.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedStack:
    """Group-major device half laid out over a 1-D cells mesh.

    The metro-scale layout of the reference: the batch axis is split into
    ``num_shards`` equal blocks of ``shard_rows`` rows, and every coupling
    group lives WHOLLY inside one block (:func:`shard_plan`), so no shard's
    admission rounds depend on another's. Shard ``s`` lives on
    ``mesh.devices[s]``; ``stacks[i]`` is the :class:`DeviceStack` of the
    i-th distinct device (:attr:`devices`), holding the padded rows of its
    shards in shard order, which ``core/greedy.py::dispatch_sharded_batch``
    solves with one batched solve (one K1 launch on a card) per device.

    ``row_of``, ``padded_of``, ``shard_rows``, ``groups_per_shard`` and
    ``group`` (shard-LOCAL group ids) are the reference's arrays, value for
    value; ``dev_of`` / ``local_of`` (B',) address a padded row's device and
    its row in that device's stack. Built/memoized per stacked batch by
    :func:`device_stack_sharded`, or as cleared rows by
    :func:`empty_sharded_stack` (the metro serving session).
    """

    mesh: object                     # launch/mesh.py::CellsMesh
    axis: str                        # mesh axis the batch is split over
    stacks: tuple                    # one DeviceStack per distinct device
    group: np.ndarray                # (B',) shard-local group ids
    row_of: np.ndarray               # (B',) stacked row per padded row, -1 pad
    padded_of: np.ndarray            # (B,) padded row per stacked row
    dev_of: np.ndarray               # (B',) index into ``devices``
    local_of: np.ndarray             # (B',) row in that device's stack
    batch_size: int                  # real B
    shard_rows: int                  # rows per shard (B' / num_shards)
    groups_per_shard: np.ndarray     # (num_shards,) assigned group counts
    coupled: bool                    # the batch has shared links
    num_links: int                   # L (0 when uncoupled)
    scatter_calls: int = 0
    rows_scattered: int = 0
    budget_updates: int = 0
    semantic_updates: int = 0        # update_semantics calls (drift traffic)
    semantic_rows: int = 0           # rows re-scattered because curves moved

    @property
    def num_shards(self) -> int:
        return len(self.groups_per_shard)

    @property
    def devices(self) -> tuple:
        """The distinct devices, in mesh order (``stacks[i]`` is on
        ``devices[i]``)."""
        return self.mesh.distinct()

    @property
    def max_tasks(self) -> int:
        return self.stacks[0].max_tasks

    def inputs(self) -> tuple:
        """The solver's input bindings, one :meth:`DeviceStack.inputs`
        tuple per device.

        The scatters of :meth:`update_rows` / :meth:`update_link_budgets`
        write the device stacks IN PLACE, and the argument of
        :meth:`DeviceStack.inputs` holds for each device's stream apart: the
        sharded dispatch enqueues every read of a device's tensors (one K1
        launch on a card, or the whole torch loop) on that device's current
        stream before it returns, so any scatter the serving loop enqueues
        afterwards on that stream comes after them. Streams of different
        devices never touch each other's tensors. With one card this is the
        single-device argument.
        """
        return tuple(st.inputs() for st in self.stacks)

    def update_rows(self, b_idx, t_idx, lat_ok_rows, alive_rows,
                    load_rows=None):
        """Delta-scatter changed task rows into the sharded device tensors.

        The surface of :meth:`DeviceStack.update_rows`: ``b_idx`` addresses
        STACKED (input-order) rows, routed to (device, row) through
        ``padded_of``, the inverse of the shard plan's placement, so callers
        never see the padded layout. The same bucket-overflow and off-range
        ValueErrors; each device's rows go to its stack's scatter.
        """
        b_idx = np.asarray(b_idx, np.int64)
        t_idx = np.asarray(t_idx, np.int64)
        d = len(t_idx)
        if d == 0:
            return
        if t_idx.max(initial=0) >= self.max_tasks:
            raise ValueError(
                f"slot {int(t_idx.max())} does not fit the device bucket "
                f"Tmax={self.max_tasks}; rebuild the stack at a larger "
                "bucket")
        if b_idx.max(initial=0) >= self.batch_size or \
                b_idx.min(initial=0) < 0:
            raise ValueError(
                f"cell index {int(b_idx.max())} outside the stacked batch "
                f"of {self.batch_size} rows")
        p_idx = self.padded_of[b_idx]
        lat_ok_rows = np.asarray(lat_ok_rows, bool)
        alive_rows = np.asarray(alive_rows, bool)
        load_rows = np.zeros(d) if load_rows is None \
            else np.asarray(load_rows, np.float64)
        on = self.dev_of[p_idx]
        for i, st in enumerate(self.stacks):
            sel = np.flatnonzero(on == i)
            if len(sel):
                st.update_rows(self.local_of[p_idx[sel]], t_idx[sel],
                               lat_ok_rows[sel], alive_rows[sel],
                               load_rows[sel])
        self.scatter_calls += 1
        self.rows_scattered += d

    def update_semantics(self, b_idx, t_idx, lat_ok_rows, alive_rows,
                         load_rows=None):
        """Drift half of the sharded delta path: the scatter of
        :meth:`update_rows`, accounted apart (``semantic_updates`` /
        ``semantic_rows``) as :meth:`DeviceStack.update_semantics` is."""
        d = len(np.asarray(t_idx))
        if d == 0:
            return
        self.update_rows(b_idx, t_idx, lat_ok_rows, alive_rows, load_rows)
        self.semantic_updates += 1
        self.semantic_rows += d

    def update_link_budgets(self, budgets):
        """Refresh the (L,) link budgets on every device, in place.

        The link set and the shard plan are invariant (each link lives
        wholly inside one shard's groups); only capacities move — no
        replan. Changing the link set is a topology change (ValueError).
        """
        if not self.coupled:
            raise ValueError(
                "this stack is uncoupled (no link budgets to update); "
                "introducing links is a topology change — rebuild")
        new = np.asarray(budgets, np.float64)
        if new.shape != (self.num_links,):
            raise ValueError(
                f"budget shape {new.shape} != device link set "
                f"{(self.num_links,)}; changing the link set is a "
                "topology change — rebuild the stack")
        for st in self.stacks:
            if st.coupled:
                st.update_link_budgets(new)
        self.budget_updates += 1


def shard_plan(group_offsets: np.ndarray,
               n_shards: int) -> tuple[list[list[int]], np.ndarray]:
    """Balanced groups→shards assignment: largest group first, into the
    currently least-loaded shard (LPT scheduling). Returns the per-shard
    group-index lists and the per-shard row loads; the block size is
    ``loads.max()`` and lighter shards are padded with inert rows. Groups
    are never split — a coupling group is the atomic unit of parallelism.
    """
    sizes = np.diff(np.asarray(group_offsets, np.int64))
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, np.int64)
    for g in np.argsort(-sizes, kind="stable"):
        s = int(np.argmin(loads))
        shards[s].append(int(g))
        loads[s] += int(sizes[g])
    return shards, loads


def _plan_layout(order: np.ndarray, offsets: np.ndarray, n_shards: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int,
                            np.ndarray]:
    """Materialize a :func:`shard_plan` as row maps.

    Returns ``(row_of, local_gid, padded_of, rows, groups_per_shard)``:
    ``row_of`` (B',) maps padded row → stacked row (-1 = inert balance
    padding), ``local_gid`` (B',) holds shard-LOCAL group ids, ``padded_of``
    (B,) is the inverse map stacked row → padded row — the address
    translation the sharded delta scatters route through.
    """
    shards, loads = shard_plan(offsets, n_shards)
    rows = max(1, int(loads.max()))
    bp = n_shards * rows
    row_of = np.full(bp, -1, np.int64)
    local_gid = np.zeros(bp, np.int64)
    for s, group_list in enumerate(shards):
        pos = s * rows
        for g in group_list:
            span = order[offsets[g]:offsets[g + 1]]
            n = len(span)
            row_of[pos:pos + n] = span
            local_gid[pos:pos + n] = pos - s * rows
            pos += n
        # inert padding rows: singleton groups that never admit
        local_gid[pos:(s + 1) * rows] = \
            np.arange(pos, (s + 1) * rows) - s * rows
    live = row_of >= 0
    padded_of = np.empty(len(order), np.int64)
    padded_of[row_of[live]] = np.flatnonzero(live)
    return row_of, local_gid, padded_of, rows, \
        np.array([len(g) for g in shards], np.int64)


def _groups_in_order(gid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(order, offsets) of the stable sort by group id ``gid``."""
    order = np.argsort(gid, kind="stable").astype(np.int64)
    gs = gid[order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    return order, np.r_[starts, len(gid)].astype(np.int64)


def _group_major_view(stacked: StackedInstances
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(order, offsets) presenting ``stacked`` in group-major order.

    Identity order when the batch already carries the layout (or is
    uncoupled); otherwise the stable group permutation is derived on the
    fly so plainly-stacked batches can still dispatch sharded.
    """
    B = stacked.batch_size
    if stacked.group_major:
        return np.arange(B, dtype=np.int64), \
            np.asarray(stacked.group_offsets, np.int64)
    coupling = stacked.coupling
    if coupling is None or not bool(coupling.incidence.any()):
        return np.arange(B, dtype=np.int64), np.arange(B + 1, dtype=np.int64)
    return _groups_in_order(coupling.groups())


def _build_sharded(mesh, axis, order, offsets, *, grid, price, capacity,
                   tmax, coupling, semantic, tables=None) -> ShardedStack:
    """Plan ``order``/``offsets`` over ``mesh.shape[axis]`` shards and
    upload the padded rows, one :class:`DeviceStack` per distinct device.

    ``price``/``capacity`` (B, m) in stacked-row order; ``coupling`` the
    batch's (B, L) spec, None when uncoupled; ``tables`` is ``(lat_ok,
    alive0, load)`` of the stacked rows, or None for cleared rows (the
    serving session's empty stack). Inert padding rows get unit capacity (a
    NaN-free gradient), price 0, no link and nothing alive, as the
    reference's do.
    """
    n_shards = int(mesh.shape[axis])
    row_of, local_gid, padded_of, rows, gps = \
        _plan_layout(order, offsets, n_shards)
    devices = mesh.distinct()
    dev_idx = np.array([devices.index(d) for d in mesh.devices], np.int64)
    # k: a shard's position among the shards of its device
    k_of = np.array([int((dev_idx[:s] == dev_idx[s]).sum())
                     for s in range(n_shards)], np.int64)
    shard_of = np.repeat(np.arange(n_shards), rows)
    dev_of = dev_idx[shard_of]
    local_of = k_of[shard_of] * rows + np.tile(np.arange(rows), n_shards)
    live = row_of >= 0
    src = np.clip(row_of, 0, None)

    def pad(table, fill, sel):
        out = np.asarray(table)[src[sel]]
        out[~live[sel]] = fill
        return out

    A = grid.shape[0]
    stacks = []
    for i, dev in enumerate(devices):
        sel = np.flatnonzero(dev_of == i)          # ascending = shard order
        n = len(sel)
        link = (None, None, None, None)
        if coupling is not None:
            inc = pad(coupling.incidence, False, sel)
            if inc.any():
                # device-global group ids: the k-th shard's block offset
                # plus the reference's shard-local id
                gid = local_of[sel] - local_of[sel] % rows + local_gid[sel]
                link = (_f32(coupling.link_capacity, dev),
                        torch.as_tensor(inc, device=dev),
                        torch.as_tensor(gid, dtype=torch.int64, device=dev),
                        group_csr(inc, gid, dev))
        if tables is None:
            lat_ok = torch.zeros((n, tmax, A), dtype=torch.bool, device=dev)
            alive0 = torch.zeros((n, tmax), dtype=torch.bool, device=dev)
            load = torch.zeros((n, tmax), dtype=torch.float32, device=dev)
        else:
            lat_ok = torch.as_tensor(pad(tables[0], False, sel), device=dev)
            alive0 = torch.as_tensor(pad(tables[1], False, sel), device=dev)
            load = _f32(pad(tables[2], 0.0, sel), dev)
        stacks.append(DeviceStack(
            grid=_f32(grid, dev), cost=_f32(lexicographic_cost(grid), dev),
            price=_f32(pad(price, 0.0, sel), dev),
            capacity=_f32(pad(capacity, 1.0, sel), dev),
            lat_ok=lat_ok, alive0=alive0, link_load=load,
            link_cap=link[0], incidence=link[1], group=link[2],
            semantic=bool(semantic), batch_size=n, group_csr=link[3]))
    return ShardedStack(
        mesh=mesh, axis=axis, stacks=tuple(stacks),
        group=local_gid, row_of=row_of, padded_of=padded_of, dev_of=dev_of,
        local_of=local_of, batch_size=len(order), shard_rows=rows,
        groups_per_shard=gps, coupled=coupling is not None,
        num_links=0 if coupling is None else coupling.num_links)


def device_stack_sharded(stacked: StackedInstances, mesh, *,
                         semantic: bool = True,
                         axis: str = "cells") -> ShardedStack:
    """The memoized SHARDED device half of ``stacked`` for one solver mode.

    Same cache discipline as :func:`device_stack` (entry keyed by
    ``(mesh, axis, semantic, semantic_signature)`` on the stacked batch
    object; ``restack`` invalidates by returning a new object), but the batch
    axis is permuted group-major, balanced over ``mesh.shape[axis]`` blocks
    (:func:`shard_plan`), padded with inert rows to a uniform block size,
    and uploaded block by block to the shards' devices. An uncoupled batch
    shards as singleton groups with no link tensors (the device stacks'
    uncoupled form; the reference uses a dummy infinite link instead, with
    the same admissions).
    """
    cache = stacked.__dict__.get("_sharded_half")
    if cache is None:
        cache = {}
        object.__setattr__(stacked, "_sharded_half", cache)
    key = (mesh, axis, bool(semantic), stacked.semantic_signature)
    if key in cache:
        return cache[key]
    order, offsets = _group_major_view(stacked)
    coupling = stacked.coupling
    if coupling is not None and not bool(coupling.incidence.any()):
        coupling = None
    shd = _build_sharded(
        mesh, axis, order, offsets, grid=stacked.grid, price=stacked.price,
        capacity=stacked.capacity, tmax=stacked.max_tasks, coupling=coupling,
        semantic=semantic, tables=_solver_tables(stacked, semantic))
    cache[key] = shd
    return shd


def empty_sharded_stack(grid: np.ndarray, price: np.ndarray,
                        capacity: np.ndarray, tmax: int, mesh, *,
                        coupling: CouplingSpec | None = None,
                        semantic: bool = True,
                        axis: str | None = None) -> ShardedStack:
    """A MESH-RESIDENT stack of cleared rows — :func:`empty_device_stack`
    laid out over the mesh.

    The metro serving session allocates one per (batch, Tmax bucket): the
    coupling groups are LPT-packed over ``mesh.shape[axis]`` blocks once
    (:func:`shard_plan`), the invariants (grid, cost, prices, capacities,
    incidence, budgets) are uploaded once into that layout, and live task
    rows then arrive as perm-addressed delta scatters
    (:meth:`ShardedStack.update_rows`). A coupling-group membership change
    invalidates the plan itself — the session layer rebuilds; budget and
    semantic drift ride the in-place scatters.
    """
    if axis is None:
        axis = mesh.axis_names[0]
    price = np.asarray(price)
    B = price.shape[0]
    if coupling is not None and not bool(coupling.incidence.any()):
        coupling = None
    if coupling is not None:
        if coupling.num_cells != B:
            raise ValueError(
                f"coupling.incidence has {coupling.num_cells} rows for "
                f"{B} cells")
        order, offsets = _groups_in_order(coupling.groups())
    else:
        order = np.arange(B, dtype=np.int64)
        offsets = np.arange(B + 1, dtype=np.int64)
    return _build_sharded(
        mesh, axis, order, offsets, grid=grid, price=price,
        capacity=np.asarray(capacity), tmax=tmax, coupling=coupling,
        semantic=semantic)


def objective_value(inst: ProblemInstance, admitted: np.ndarray,
                    alloc: np.ndarray) -> float:
    """Paper Eq. (1a): Σ_τ Σ_k p_k (S_k - s_τk) x_τ."""
    p, S = inst.pool.price, inst.pool.capacity
    per_task = (p[None, :] * (S[None, :] - alloc)).sum(axis=1)
    return float((per_task * admitted).sum())


def check_solution(inst: ProblemInstance, sol: Solution,
                   lat_params: lat_mod.LatencyParams | None = None,
                   atol: float = 1e-9) -> dict:
    """Independent re-validation of a solution against constraints (1b)-(1f).

    Returns a report dict; ``report["valid"]`` means capacity is respected and
    every *admitted* task actually meets its accuracy and latency bounds when
    re-evaluated from first principles (not from the solver's own tables).
    """
    lat_params = lat_params or lat_mod.LatencyParams()
    t = inst.tasks
    x = sol.admitted.astype(bool)

    used = (sol.alloc * x[:, None]).sum(axis=0)
    cap_ok = bool((used <= inst.pool.capacity + atol).all())

    # validate on the curves that DEFINED the instance — under a drifted
    # model "first principles" means the drifted truth, not the paper default
    a = semantics.resolve(inst.semantics).accuracy(t.app_idx, sol.z)
    acc_ok = a + atol >= t.min_accuracy

    l = lat_mod.latency(lat_params, t.bits_per_job, t.jobs_per_sec,
                        t.gpu_time_per_job, sol.z, sol.alloc)
    lat_ok = l <= t.max_latency + atol

    admitted_ok = (~x) | (acc_ok & lat_ok)
    return {
        "valid": cap_ok and bool(admitted_ok.all()),
        "capacity_ok": cap_ok,
        "used": used,
        "accuracy_ok": acc_ok,
        "latency_ok": lat_ok,
        "latency": l,
        "accuracy": a,
        "objective": objective_value(inst, x, sol.alloc),
    }
