"""Port of ``src/repro/core/types.py`` (the port's own numpy copy),
held against it value for value by ``tests/test_torch_core.py``.

Core data types for the Semantic Flexible Edge Slicing Problem (SF-ESP).

The SF-ESP (paper Eq. 1a-1f) decides, for a set of DL tasks ``τ = (c, d, t)``:

* admission            ``x_τ ∈ {0, 1}``
* compression factor   ``z_τ ∈ (0, 1]``   (bitrate scaling of the input stream)
* slice allocation     ``s_τ ∈ R+^m``     (one entry per edge resource type)

subject to capacity (1b), accuracy (1d) and latency (1e) constraints, maximizing
``Σ_τ Σ_k p_k (S_k - s_τk) x_τ`` (1a).

Everything downstream (greedy solver, baselines, exact solver, benchmarks,
serving admission) consumes the array-of-struct :class:`ProblemInstance` built
here, so the solvers stay pure-JAX-friendly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from . import semantics as _sem

# signature of the immutable paper calibration — what `semantics=None` means
_DEFAULT_SIG = _sem.DEFAULT_MODEL.signature

__all__ = [
    "ResourcePool",
    "TaskSet",
    "CouplingSpec",
    "ProblemInstance",
    "StackedInstances",
    "Solution",
    "make_allocation_grid",
]


@dataclasses.dataclass(frozen=True)
class ResourcePool:
    """The ``m`` edge resource types of the system model (Section IV-A).

    Attributes:
      names: human-readable resource names, e.g. ("rbg", "gpu").
      capacity: ``S_k`` — total units of each type. Shape (m,).
      price: ``p_k`` — cost coefficient of each type. Shape (m,).
      levels: per-resource list of allocatable discrete amounts (the paper
        enumerates the discrete solution space, Section IV-C). Each entry is a
        1-D ascending array of allowed per-task allocations (> 0).
    """

    names: tuple[str, ...]
    capacity: np.ndarray
    price: np.ndarray
    levels: tuple[np.ndarray, ...]

    def __post_init__(self):
        object.__setattr__(self, "capacity", np.asarray(self.capacity, np.float64))
        object.__setattr__(self, "price", np.asarray(self.price, np.float64))
        assert self.capacity.shape == self.price.shape == (len(self.names),)
        assert len(self.levels) == len(self.names)

    @property
    def m(self) -> int:
        return len(self.names)


@dataclasses.dataclass(frozen=True)
class TaskSet:
    """Array-of-struct description of all submitted tasks ``T``.

    Every field has leading dimension T. ``app_idx`` indexes into the semantic
    application registry (core.semantics) used to evaluate ``a_τ(z)``.
    """

    app_idx: np.ndarray        # (T,) int — application class of each task
    min_accuracy: np.ndarray   # (T,) float — A_c
    max_latency: np.ndarray    # (T,) float — L_c (seconds)
    bits_per_job: np.ndarray   # (T,) float — uncompressed job size b_τ (Mbit)
    jobs_per_sec: np.ndarray   # (T,) float — per-task job arrival rate λ
    gpu_time_per_job: np.ndarray  # (T,) float — seconds on one reference GPU, z=1
    n_ues: np.ndarray          # (T,) int — UEs multiplexed in the slice

    def __post_init__(self):
        t = len(self.app_idx)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            object.__setattr__(self, f.name, np.asarray(v))
            assert getattr(self, f.name).shape == (t,), f.name

    @property
    def num_tasks(self) -> int:
        return len(self.app_idx)


@dataclasses.dataclass(frozen=True)
class CouplingSpec:
    """Shared midhaul/backhaul links coupling the cells of a multi-cell batch.

    SEM-O-RAN's networking-load minimization only pays off system-wide if the
    *shared* transport between cells and the edge cluster is itself a budgeted
    resource: cells that solve their SF-ESP independently can jointly
    over-admit a midhaul/backhaul link (cf. joint communication+computation
    slicing, arXiv:2202.06439 / arXiv:1911.01904). A ``CouplingSpec``
    describes that transport topology:

    Attributes:
      link_capacity: (L,) float — per-link budget on the summed *admitted*
        network load, in the same unit as the per-task load
        ``b_τ · λ_τ · z*_τ`` (Mbit/s of compressed traffic).
      incidence: (C, L) bool — one row per cell; ``incidence[c, l]`` means
        cell ``c``'s traffic traverses shared link ``l``. On a single
        :class:`ProblemInstance` the spec carries that cell's own row
        (C == 1); :func:`repro_torch.core.sfesp.stack_instances` merges the rows of
        a batch into the (B, L) spec the coupled solver consumes. Cells whose
        rows are all-zero are uncoupled (their group is a singleton and they
        admit exactly as the link-free path).
      names: optional human-readable link names.
    """

    link_capacity: np.ndarray
    incidence: np.ndarray
    names: tuple[str, ...] | None = None

    def __post_init__(self):
        cap = np.asarray(self.link_capacity, np.float64)
        inc = np.asarray(self.incidence, bool)
        object.__setattr__(self, "link_capacity", cap)
        object.__setattr__(self, "incidence", inc)
        assert cap.ndim == 1
        assert inc.ndim == 2 and inc.shape[1] == cap.shape[0], inc.shape
        if self.names is not None:
            assert len(self.names) == cap.shape[0]

    @property
    def num_links(self) -> int:
        return self.link_capacity.shape[0]

    @property
    def num_cells(self) -> int:
        return self.incidence.shape[0]

    def row(self, c: int) -> "CouplingSpec":
        """The single-cell view of cell ``c`` (incidence row, same links)."""
        return CouplingSpec(self.link_capacity, self.incidence[c:c + 1],
                            self.names)

    def set_budgets(self, budgets) -> None:
        """Overwrite the per-link budgets IN PLACE (same (L,) shape).

        Time-varying link degradation must mutate the existing
        ``link_capacity`` buffer rather than build a new spec: both
        :func:`repro_torch.core.sfesp.merge_coupling` (shared-link identification)
        and the serving fast path's session guard compare the ARRAY OBJECT,
        so a new array would read as a topology change and force a full
        session rebuild where only an (L,)-sized device refresh is needed
        (``repro_torch.core.sfesp.DeviceStack.update_link_budgets``).
        """
        b = np.asarray(budgets, np.float64)
        if b.shape != self.link_capacity.shape:
            raise ValueError(
                f"budget shape {b.shape} != link set shape "
                f"{self.link_capacity.shape}; changing the LINK SET is a "
                "topology change — build a new CouplingSpec for that")
        self.link_capacity[:] = b

    def groups(self) -> np.ndarray:
        """Connected components of the cell–link graph → (C,) group ids.

        Cells sharing a link (transitively) must admit jointly — one
        global-max pick per group per round — so both the numpy oracle and
        the batched engine derive their group structure from this single
        implementation. Ids are the smallest cell index of each component.
        """
        c = self.num_cells
        parent = np.arange(c)

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for link in range(self.num_links):
            users = np.nonzero(self.incidence[:, link])[0]
            for other in users[1:]:
                ra, rb = find(int(users[0])), find(int(other))
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
        return np.array([find(i) for i in range(c)], np.int64)


def make_allocation_grid(levels: Sequence[np.ndarray]) -> np.ndarray:
    """Cartesian product of per-resource allocation levels → grid (A, m).

    The paper solves Eqs. (2)-(3) "through the enumeration of the resource
    allocation solution space"; this is that enumerated space.
    """
    mesh = np.meshgrid(*[np.asarray(l, np.float64) for l in levels], indexing="ij")
    return np.stack([g.reshape(-1) for g in mesh], axis=-1)


@dataclasses.dataclass(frozen=True)
class ProblemInstance:
    """A fully discretized SF-ESP instance, ready for the solvers.

    Attributes:
      pool: the resource pool (capacities S, prices p).
      tasks: the task set.
      z_grid: (Z,) ascending compression factors in (0, 1].
      acc: (T, Z) — a_τ(z) evaluated on the z grid (task's own class curve).
      acc_agnostic: (T, Z) — a(z) on the dataset-wide "All" curve; what a
        semantics-agnostic algorithm (SI-EDGE / FlexRes-N-SEM) believes.
      grid: (A, m) — enumerated candidate allocations.
      lat: (T, A) — l_τ(z*_τ, s_a) with z* from the *semantic* curve.
      lat_agnostic: (T, A) — latency with z* from the agnostic curve.
      z_star_idx: (T,) int — index into z_grid of z*_τ (semantic); -1 if the
        accuracy bound is unreachable on the task's own curve.
      z_star_idx_agnostic: (T,) int — same for the agnostic curve.
      coupling: optional single-cell :class:`CouplingSpec` view (incidence
        shape (1, L)) — the shared links this cell's admitted traffic loads.
      semantics: the :class:`repro_torch.core.semantics.SemanticModel` whose curves
        baked ``acc`` / ``z_star_idx``; ``None`` means the immutable paper
        calibration (``DEFAULT_MODEL``). Its ``signature`` keys every cache
        derived from this instance, so drifted curves can't serve stale rows.
    """

    pool: ResourcePool
    tasks: TaskSet
    z_grid: np.ndarray
    acc: np.ndarray
    acc_agnostic: np.ndarray
    grid: np.ndarray
    lat: np.ndarray
    lat_agnostic: np.ndarray
    z_star_idx: np.ndarray
    z_star_idx_agnostic: np.ndarray
    coupling: CouplingSpec | None = None
    semantics: object | None = None   # SemanticModel (None = DEFAULT_MODEL)

    @property
    def semantic_signature(self) -> tuple[int, int]:
        """Cache-key component of the model that baked this instance's
        tables — ``(model uid, curve version)`` captured at build time."""
        return self.semantics.signature if self.semantics is not None \
            else _DEFAULT_SIG

    @property
    def num_tasks(self) -> int:
        return self.tasks.num_tasks

    @property
    def num_allocs(self) -> int:
        return self.grid.shape[0]

    @property
    def m(self) -> int:
        return self.pool.m


@dataclasses.dataclass(frozen=True)
class StackedInstances:
    """A batch of SF-ESP instances padded to a common task count.

    The batched sweep engine (``greedy.solve_greedy_batch``) solves all B
    instances in ONE device program, so every per-task table is stacked with
    leading dimension B and padded to ``Tmax = max_b T_b``:

      * latency tables are padded with ``+inf`` (a padded row is never
        feasible for any allocation),
      * ``z_star_idx`` is padded with ``-1`` (padded tasks are pruned by the
        Alg. 1 line-7 candidate filter),
      * ``max_latency`` is padded with ``0`` and ``task_mask`` marks real rows.

    All instances must share one enumerated allocation grid — i.e. identical
    ``pool.levels`` — but capacities and prices MAY differ per instance
    (multi-cell pools with heterogeneous loads are the intended use); sets
    with mixed grids dispatch per group via ``greedy.solve_greedy_many``.
    Build via :func:`repro_torch.core.sfesp.stack_instances`; refill in place with
    :func:`repro_torch.core.sfesp.restack` (same grid/batch size, task counts
    within ``Tmax`` — the refilled batch shares these buffers and the old
    object must not be used afterwards).

    **Group-major layout** (``stack_instances(..., group_major=True)``): the
    instances are permuted so every coupling group (connected component of
    the cell–link graph, ``CouplingSpec.groups``) occupies a CONTIGUOUS span
    of the batch axis. ``group_offsets`` carries the span boundaries and
    ``perm`` maps each stacked row back to its position in the caller's
    input order. The permutation is the stable sort by group id, so the
    within-group (cell-major) order — and therefore the coupled round's
    first-cell tie-break — is preserved: decisions per instance are
    bit-identical to the unpermuted layout. This is the layout the sharded
    metro-scale solve (``greedy.solve_greedy_sharded``) consumes: a
    contiguous group is a shardable unit, so independent groups dispatch to
    different devices of a mesh without any cross-device traffic.
    """

    instances: tuple[ProblemInstance, ...]
    grid: np.ndarray                  # (A, m) — shared allocation grid
    capacity: np.ndarray              # (B, m) — S_k per instance
    price: np.ndarray                 # (B, m) — p_k per instance
    lat: np.ndarray                   # (B, Tmax, A) — +inf padded
    lat_agnostic: np.ndarray          # (B, Tmax, A) — +inf padded
    z_star_idx: np.ndarray            # (B, Tmax) int — -1 padded
    z_star_idx_agnostic: np.ndarray   # (B, Tmax) int — -1 padded
    z_star: np.ndarray                # (B, Tmax) — z_grid[z*_idx], 1.0 padded
    z_star_agnostic: np.ndarray       # (B, Tmax) — agnostic z*, 1.0 padded
    app_idx: np.ndarray               # (B, Tmax) int — 0 padded
    min_accuracy: np.ndarray          # (B, Tmax) — +inf padded
    max_latency: np.ndarray           # (B, Tmax) — 0 padded
    task_mask: np.ndarray             # (B, Tmax) bool — True on real tasks
    num_tasks: np.ndarray             # (B,) int — T_b of each instance
    # per-task shared-link load b_τ·λ_τ·z*_τ at the semantic / agnostic z*,
    # 0-padded; consumed by the coupled admission rounds when `coupling` is set
    link_load: np.ndarray | None = None           # (B, Tmax)
    link_load_agnostic: np.ndarray | None = None  # (B, Tmax)
    coupling: CouplingSpec | None = None          # merged (B, L) batch view
    # group-major layout metadata (None on plainly-stacked batches):
    # perm[b] = input-order index of the instance stored at stacked row b;
    # group_offsets (G+1,) = contiguous [start, end) span of each coupling
    # group along the batch axis, ascending, group_offsets[-1] == B
    perm: np.ndarray | None = None                # (B,) int
    group_offsets: np.ndarray | None = None       # (G+1,) int
    # the SemanticModel shared by every instance of the batch (None = paper
    # DEFAULT_MODEL); mixing models in one stack is a build error upstream
    semantics: object | None = None

    @property
    def semantic_signature(self) -> tuple[int, int]:
        """(model uid, curve version) — part of the device-half memo key, so
        a drifted model can never silently reuse a stale device upload."""
        return self.semantics.signature if self.semantics is not None \
            else _DEFAULT_SIG

    @property
    def batch_size(self) -> int:
        return len(self.instances)

    @property
    def max_tasks(self) -> int:
        return self.lat.shape[1]

    @property
    def num_allocs(self) -> int:
        return self.grid.shape[0]

    @property
    def m(self) -> int:
        return self.grid.shape[1]

    @property
    def group_major(self) -> bool:
        return self.group_offsets is not None

    @property
    def num_groups(self) -> int:
        """Coupling groups of the batch (B when no layout metadata)."""
        if self.group_offsets is None:
            return self.batch_size
        return len(self.group_offsets) - 1


@dataclasses.dataclass(frozen=True)
class Solution:
    """Solver output: (x, s, z) per paper Alg. 1 line 20, plus diagnostics."""

    admitted: np.ndarray       # (T,) bool — x_τ
    alloc: np.ndarray          # (T, m) — s_τ (zero rows for rejected tasks)
    z: np.ndarray              # (T,) — z_τ (1.0 for rejected tasks)
    objective: float           # Eq. (1a) value
    satisfied: np.ndarray      # (T,) bool — admitted AND meets A_c and L_c
    # (the paper's HighComp / HighRes baselines allocate tasks that then fail
    # their requirements; `satisfied` is what Fig. 6's discussion checks.)

    @property
    def num_allocated(self) -> int:
        return int(self.admitted.sum())

    @property
    def num_satisfied(self) -> int:
        return int(self.satisfied.sum())
