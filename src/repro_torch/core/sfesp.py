"""Port of ``src/repro/core/sfesp.py``: instance construction, stacking and
the device-resident half of the stacking cache.

The host half (Eq. (2) min-z, latency tables, padded stacking, validation)
stays numpy, value for value the reference's. The device half holds the
solver inputs as torch tensors on an explicit device: :class:`DeviceStack`,
:func:`device_stack` (memoized per stacked batch) and
:func:`empty_device_stack` with its delta scatters (:meth:`DeviceStack.
update_rows`, :meth:`~DeviceStack.update_link_budgets`,
:meth:`~DeviceStack.update_semantics`). The reference's group-major layout
and ``ShardedStack`` (the sharded metro solve) are not ported yet.

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
           "TaskRows", "task_feasibility_rows",
           "DeviceStack", "GroupCSR", "group_csr", "device_stack",
           "empty_device_stack"]


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
                    tmax: int | None = None) -> StackedInstances:
    """Stack instances into one padded batch for the sweep engine.

    Instances must share the allocation grid (identical ``pool.levels``);
    capacities/prices may differ per instance (multi-cell pools). Tasks are
    padded to ``Tmax`` with never-feasible rows (lat=+inf, z*_idx=-1) so the
    batched solver's masked rounds ignore them. ``tmax`` overrides the
    natural padding target (must be >= the largest task count) — callers
    pass power-of-two buckets so repeated solves share one shape. The
    group-major layout of the reference (``group_major=True``) belongs to the
    sharded solve and is not ported yet.
    """
    insts = tuple(insts)
    if not insts:
        raise ValueError("stack_instances needs at least one instance")
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
