"""Port of ``src/repro/serving/admission.py``: the Semantic Edge Slicing
Module (SESM) — the Near-real-time RIC xApp.

Runs the SF-ESP greedy (core.greedy; on a CUDA device its flexible rounds run
the K1 kernel)
over the current request set + edge status and emits the three-fold output of
paper Section III-B: (i) admitted tasks, (ii) per-task compression level,
(iii) per-task resource slices. Re-slicing is full (new and running tasks are
equally considered — already-running tasks may be evicted, Section III-C).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core import latency as lat_mod
from ..core import semantics
from ..core.greedy import (dispatch_device_batch, solve, solve_greedy_batch,
                           unpack_device_batch)
from ..core.sfesp import (DeviceStack, check_solution, default_z_grid,
                          empty_device_stack, next_pow2, restack,
                          stack_instances, task_feasibility_rows)
from ..core.types import CouplingSpec, ResourcePool, make_allocation_grid
from ..kernels import resolve_device
from .request import SliceRequest
from .sdla import SDLA

__all__ = ["PendingSolve", "SliceDecision", "SESM"]


class PendingSolve:
    """Handle to a dispatched, not-yet-awaited re-slice solve.

    Returned by ``SESM.solve_slots(..., wait=False)``: the device program is
    launched and the host mirrors it unpacks against are snapshotted (the
    back buffer), so the serving loop can keep mutating its slot tables —
    ingesting tick N+1's events — while tick N solves. :meth:`wait` blocks
    on the device result exactly once and returns the per-cell decisions;
    repeat calls return the same list.
    """

    def __init__(self, resolve):
        self._resolve = resolve
        self._result = None

    def wait(self):
        if self._resolve is not None:
            self._result = self._resolve()
            self._resolve = None
        return self._result

    @classmethod
    def ready(cls, decisions) -> "PendingSolve":
        """An already-resolved handle (empty ticks, host-blocking solves)."""
        p = cls(None)
        p._result = decisions
        return p


@dataclasses.dataclass
class SliceDecision:
    """One task's re-slice outcome: admission, compression z, slice."""

    request: SliceRequest
    admitted: bool
    z: float
    alloc: dict[str, float]
    expected_latency_s: float
    expected_accuracy: float
    # control-plane plumbing for cell-indexed decision sets: which cell of a
    # multi-cell re-slice this decision belongs to, and whether a rejection
    # evicted a previously-RUNNING task (vs turning away a pending request)
    cell: int | None = None
    evicted: bool = False


@dataclasses.dataclass
class _ServeSession:
    """Device-resident serving state persisted across re-slice ticks.

    One per (batch size, Tmax bucket, algorithm, latency-scale epoch): the
    :class:`~repro_torch.core.sfesp.DeviceStack` holds the solver inputs on device,
    the host mirrors hold the per-slot scalars the decision unpack needs
    (compression, app class, stream rate), and ``pending`` accumulates dirty
    slots until a live solve consumes them — deltas reported on a tick whose
    solve is skipped (transiently all-empty batch) must survive to the next.

    """

    dev: DeviceStack
    grid: np.ndarray                 # host copy, for alloc unpack
    z_grid: np.ndarray
    names: list[tuple[str, ...]]     # per-cell resource names
    pools_ref: object                # identity guards: the engine passes the
    coupling_ref: object             # same objects every tick
    pool_state: np.ndarray           # (B, 2m) price|capacity VALUE snapshot —
    # ResourcePool is frozen but its arrays are not; an in-place capacity
    # edit must invalidate the session, not silently solve stale pools
    link_cap_state: np.ndarray | None  # (L,) link-budget VALUE snapshot —
    # unlike a pool edit, an in-place budget edit (CouplingSpec.set_budgets:
    # link degradation) does NOT invalidate the session: the link set is
    # unchanged, so the delta is one (L,) device refresh
    # (DeviceStack.update_link_budgets), counted in ``sesm.link_updates``
    sem_ref: object                  # the SDLA's SemanticModel — identity
    # guard: swapping in a DIFFERENT model object rebuilds the session
    sem_version: int                 # model-version snapshot — an IN-PLACE
    # drift of the same model (version bump) does NOT invalidate: the changed
    # apps' live rows re-run the min-z pipeline and delta-scatter
    # (DeviceStack.update_semantics), counted in ``sesm.semantic_updates``
    scale: float
    semantic: bool
    flexible: bool
    # host mirrors, (B, Tmax) each
    z_star: np.ndarray
    has_z: np.ndarray
    app_idx: np.ndarray
    bits: np.ndarray
    rate: np.ndarray
    gpu_t: np.ndarray
    pending: set[tuple[int, int]]

    @property
    def batch_size(self) -> int:
        return self.z_star.shape[0]

    @property
    def max_tasks(self) -> int:
        return self.z_star.shape[1]


class SESM:
    """The SESM xApp: SF-ESP admission over live request sets.

    Front doors: :meth:`slice` (one cell, one solve), :meth:`solve_batch`
    (many request sets — what-if studies or the cells of one coupled
    deployment — in ONE device program, restack-cached across calls) and
    :meth:`solve_slots` (the device-resident delta fast path over sticky
    solver-row slots). The reference's metro mode (a sharded serve session
    over a device mesh) is not ported yet.

    ``device`` is where the solves run (``"cuda"`` by default; raises when
    no card is visible). ``inner`` picks the flexible round (``"kernel"`` =
    K1, ``"torch"`` = the plain bit-domain round); ``None`` follows the
    device. It is a plain attribute: a twin engine may set it per tick.
    """

    def __init__(self, pool: ResourcePool, sdla: SDLA | None = None,
                 backend: str = "numpy", inner: str | None = None,
                 device="cuda"):
        self.pool = pool
        self.sdla = sdla or SDLA()
        self.backend = backend
        self.inner = inner
        self.device = resolve_device(device)
        self.algorithm = {"semantic": True, "flexible": True}
        # padded stacking buffers reused across solve_batch calls (the
        # closed-loop re-slice case: only tasks/capacities change per call)
        self._batch_cache = None
        # device-resident serving session reused across solve_slots ticks
        self._serve_session: _ServeSession | None = None
        # stacking-cache telemetry: fresh_stacks counts (re)allocations of the
        # padded buffers, restacks counts in-place refills — a healthy closed
        # loop shows fresh_stacks == 1 after the first tick (zero cache
        # misses). On the fast path a "refill" is a delta sync; delta_rows
        # counts the task rows actually recomputed + scattered (zero per
        # steady-state tick).
        self.fresh_stacks = 0
        self.restacks = 0
        self.delta_rows = 0
        # fault-plane telemetry: session_rebuilds counts LIVE serve sessions
        # torn down by an invalidating change (batch/bucket/pools/coupling
        # identity/latency scale — first-ever builds are not rebuilds);
        # link_updates counts budget-only coupling refreshes that kept the
        # session alive (the degradation fast path)
        self.session_rebuilds = 0
        self.link_updates = 0
        # semantic-drift telemetry: ticks whose model-version bump was
        # absorbed as dirty-row delta scatters with the session kept alive
        # (the drift fast path; rows counted on dev.semantic_rows)
        self.semantic_updates = 0

    def slice(self, requests: list[SliceRequest]) -> list[SliceDecision]:
        if not requests:
            return []
        inst = self.sdla.build_instance(requests, self.pool)
        sol = solve(inst, backend=self.backend, **self.algorithm)
        return self._decisions(requests, inst, sol)

    def solve_batch(self, request_sets: list[list[SliceRequest]],
                    coupling: CouplingSpec | None = None,
                    pools: Sequence[ResourcePool] | None = None
                    ) -> list[list[SliceDecision]]:
        """Evaluate many candidate re-slice decisions in ONE device program.

        Each element of ``request_sets`` is one hypothetical request mix —
        e.g. the projected task sets over a re-slicing horizon, or the
        alternatives of a what-if admission study. All sets share this SESM's
        pool, so they stack onto one allocation grid and solve via the
        batched sweep engine; decisions per set match calling :meth:`slice`
        on it (up to the float32 gradient-tie caveat of the JAX backends vs
        the numpy default — see ``solve_greedy_batch``).

        ``coupling`` treats the request sets as CELLS of one multi-cell
        deployment instead of independent what-ifs: ``coupling.incidence``
        must have one row per request set, and sets routed through a common
        shared link admit jointly under its budget (the coupled sweep
        engine; reference semantics in ``core.baselines.solve_coupled_ref``).
        Empty request sets keep their (vacuous) incidence row.

        ``pools`` gives each request set its own resource pool (a multi-cell
        deployment with heterogeneous capacities); all pools must share one
        enumerated allocation grid (identical ``levels``). ``None`` keeps this
        SESM's pool for every set.

        Stacking buffers are padded to a power-of-two ``Tmax`` bucket and
        reused (``restack``) across calls with the same number of request
        sets, so a closed-loop horizon evaluation neither reallocates the
        (B, Tmax, A) host tables nor recompiles the device program per step.
        """
        if coupling is not None and \
                coupling.num_cells != len(request_sets):
            raise ValueError(
                f"coupling.incidence has {coupling.num_cells} rows for "
                f"{len(request_sets)} request sets")
        if pools is not None and len(pools) != len(request_sets):
            raise ValueError(
                f"got {len(pools)} pools for {len(request_sets)} request sets")
        out: list[list[SliceDecision]] = [[] for _ in request_sets]
        if not any(request_sets):
            return out
        # EMPTY sets stay in the batch as zero-task rows (task_mask all
        # False, never-alive padding): a transiently-empty cell in a closed
        # loop must not shrink the batch, which would miss the restack cache
        # and recompile the device program for the new shape
        insts = [self.sdla.build_instance(
            rs, self.pool if pools is None else pools[i])
            for i, rs in enumerate(request_sets)]
        if coupling is not None:
            insts = [dataclasses.replace(inst, coupling=coupling.row(i))
                     for i, inst in enumerate(insts)]
        cache = self._batch_cache
        tneed = max(inst.num_tasks for inst in insts)
        if (cache is not None and cache.batch_size == len(insts)
                and cache.max_tasks >= tneed
                and np.array_equal(cache.grid, insts[0].grid)):
            stacked = restack(cache, insts)
            self.restacks += 1
        else:
            stacked = stack_instances(insts, tmax=next_pow2(tneed))
            self.fresh_stacks += 1
        self._batch_cache = stacked
        sols = solve_greedy_batch(stacked, inner=self.inner,
                                  device=self.device, **self.algorithm)
        for i, (rs, inst, sol) in enumerate(zip(request_sets, insts, sols)):
            out[i] = self._decisions(rs, inst, sol, cell=i)
        return out

    # ------------------------------------------------- delta fast path
    def solve_slots(self, slot_rows: list[list[SliceRequest | None]],
                    dirty: list[list[int]],
                    coupling: CouplingSpec | None = None,
                    pools: Sequence[ResourcePool] | None = None,
                    wait: bool = True):
        """Device-resident re-slice: solve the slotted candidate sets,
        recomputing and re-uploading ONLY the dirty rows.

        The fast-path twin of :meth:`solve_batch` for a closed serving loop:
        ``slot_rows[b]`` is cell ``b``'s candidate set in stable slot order
        (``None`` = cleared row; see ``CellRuntime.sync_slots``) and
        ``dirty[b]`` the slots whose content changed since the previous call.
        Invariant tables (grid, lexicographic cost, prices, capacities,
        coupling topology) upload once per session; per-tick work is one
        bucketed scatter of the dirty rows plus ONE fused device program that
        returns the packed decisions (admitted bitmask, s*, residual
        capacities, link loads) in a single small buffer. Decisions per live
        slot are identical to :meth:`solve_batch` on the compacted request
        sets (cleared rows are never feasible and cannot shift tie-breaks).

        The session rebuilds (a fresh stack) when the Tmax bucket overflows,
        the batch size / algorithm / coupling / pools change, or the SDLA
        latency scale moves (every cached row depends on it); ``pools`` and
        ``coupling`` are identity-compared — pass the same objects per tick,
        as :class:`~repro_torch.serving.multicell.MultiCellEngine` does. TWO
        in-place mutations are sanctioned and keep the session alive:
        ``CouplingSpec.set_budgets`` (link degradation — same coupling
        object, new budget VALUES, detected by value snapshot, applied as a
        single (L,) device refresh, ``sesm.link_updates``) and a
        ``SemanticModel`` drift (same model object, bumped version —
        detected by version snapshot, applied as dirty-row scatters of just
        the live slots whose curves moved, ``sesm.semantic_updates`` /
        ``DeviceStack.update_semantics``). Swapping in a DIFFERENT coupling
        or model object is a rebuild.

        The admission rounds run as the solve is dispatched (see
        ``core.greedy.dispatch_device_batch``); ``wait=False`` defers the
        read-back and the unpack of the decisions.

        ``wait=False`` returns a :class:`PendingSolve` instead of decisions:
        the dirty rows are consumed, the device program launches, and the
        per-slot host mirrors the unpack needs are snapshotted into the
        handle (the double-buffered back buffer) — the caller blocks only at
        ``PendingSolve.wait()``, typically after ingesting the next tick's
        events. Decisions are identical either way.
        """
        B = len(slot_rows)
        if coupling is not None and coupling.num_cells != B:
            raise ValueError(
                f"coupling.incidence has {coupling.num_cells} rows for "
                f"{B} slot sets")
        if pools is not None and len(pools) != B:
            raise ValueError(
                f"got {len(pools)} pools for {B} slot sets")
        out: list[list[SliceDecision]] = [[] for _ in range(B)]
        live = any(r is not None for rows in slot_rows for r in rows)
        tneed = max([len(rows) for rows in slot_rows] + [1])
        scale = self.sdla.latency_scale
        semantic = bool(self.algorithm["semantic"])
        flexible = bool(self.algorithm["flexible"])
        model = self.sdla.semantics
        sess = self._serve_session
        if sess is not None and (
                sess.batch_size != B or tneed > sess.max_tasks
                or sess.scale != scale or sess.semantic != semantic
                or sess.flexible != flexible
                or sess.coupling_ref is not coupling
                or sess.pools_ref is not pools
                or sess.sem_ref is not model
                or not np.array_equal(sess.pool_state,
                                      self._pool_state(B, pools))):
            sess = self._serve_session = None
            self.session_rebuilds += 1
        if sess is None:
            if not live:
                return out if wait else PendingSolve.ready(out)
            sess = self._build_session(slot_rows, coupling, pools, scale)
            self._serve_session = sess
            self.fresh_stacks += 1
        else:
            for b, d in enumerate(dirty):
                sess.pending.update((b, t) for t in d)
            if coupling is not None and not np.array_equal(
                    sess.link_cap_state, coupling.link_capacity):
                # budget-only degradation: the coupling OBJECT (and with it
                # the link set) is unchanged — only the budgets moved
                # (CouplingSpec.set_budgets). One (L,) device refresh keeps
                # the whole session alive.
                if sess.dev.coupled:
                    sess.dev.update_link_budgets(coupling.link_capacity)
                sess.link_cap_state = coupling.link_capacity.copy()
                self.link_updates += 1
            if model.version != sess.sem_version:
                # semantic drift: the SAME model object moved in place
                # (version bump). The delta is the live rows whose EFFECTIVE
                # curve changed — re-run the shared min-z pipeline on just
                # those and scatter (DeviceStack.update_semantics); the
                # session stays alive.
                self._refresh_semantics(sess, slot_rows, model)
            if not live:
                return out if wait else PendingSolve.ready(out)
            self.restacks += 1
        self._sync_rows(sess, slot_rows)
        dispatched = dispatch_device_batch(sess.dev, flexible=flexible,
                                           inner=self.inner)
        unpack = self._slot_unpacker(sess, slot_rows, out)
        if wait:
            return unpack(unpack_device_batch(dispatched))
        return PendingSolve(lambda: unpack(unpack_device_batch(dispatched)))

    def ready_solve(self, request_sets, coupling=None,
                    pools=None) -> PendingSolve:
        """:meth:`solve_batch` wrapped as an already-resolved
        :class:`PendingSolve` — the dispatch-shaped front door for paths
        that solve host-blocking (what-if studies, rebuild comparisons)."""
        return PendingSolve.ready(self.solve_batch(
            request_sets, coupling=coupling, pools=pools))

    def _pool_state(self, B: int, pools) -> np.ndarray:
        cell_pools = [self.pool] * B if pools is None else pools
        return np.concatenate(
            [np.stack([p.price for p in cell_pools]),
             np.stack([p.capacity for p in cell_pools])], axis=1)

    def _build_session(self, slot_rows, coupling, pools,
                       scale) -> _ServeSession:
        B = len(slot_rows)
        cell_pools = [self.pool] * B if pools is None else list(pools)
        for pool in cell_pools[1:]:
            # the same stacking contract solve_batch enforces: one shared
            # enumerated allocation grid, capacities may differ per cell
            if len(pool.levels) != len(cell_pools[0].levels) or not all(
                    np.array_equal(a, b)
                    for a, b in zip(pool.levels, cell_pools[0].levels)):
                raise ValueError(
                    "all slotted cells must share one allocation grid "
                    "(identical pool.levels); capacities may differ")
        grid = make_allocation_grid(cell_pools[0].levels)
        tmax = next_pow2(max([len(rows) for rows in slot_rows] + [1]))
        price = np.stack([p.price for p in cell_pools])
        cap = np.stack([p.capacity for p in cell_pools])
        dev = empty_device_stack(
            grid, price, cap, tmax, coupling=coupling,
            semantic=bool(self.algorithm["semantic"]), device=self.device)
        return _ServeSession(
            dev=dev, grid=grid, z_grid=default_z_grid(),
            names=[p.names for p in cell_pools],
            pools_ref=pools, coupling_ref=coupling,
            pool_state=self._pool_state(B, pools),
            link_cap_state=None if coupling is None
            else coupling.link_capacity.copy(),
            sem_ref=self.sdla.semantics,
            sem_version=self.sdla.semantics.version, scale=scale,
            semantic=bool(self.algorithm["semantic"]),
            flexible=bool(self.algorithm["flexible"]),
            z_star=np.ones((B, tmax)), has_z=np.zeros((B, tmax), bool),
            app_idx=np.zeros((B, tmax), np.int64),
            bits=np.zeros((B, tmax)), rate=np.zeros((B, tmax)),
            gpu_t=np.zeros((B, tmax)),
            pending={(b, t) for b, rows in enumerate(slot_rows)
                     for t, r in enumerate(rows) if r is not None},
        )

    def _sync_rows(self, sess: _ServeSession, slot_rows):
        """Recompute + scatter the pending dirty rows (host AND device)."""
        if not sess.pending:
            return
        items = sorted(sess.pending)
        reqs, live_pos = [], []
        for i, (b, t) in enumerate(items):
            rows = slot_rows[b]
            r = rows[t] if t < len(rows) else None
            if r is not None:
                live_pos.append(i)
                reqs.append(r)
        d = len(items)
        A = sess.grid.shape[0]
        # cleared-row defaults: never feasible, never alive, padding scalars
        lat_ok = np.zeros((d, A), bool)
        alive = np.zeros(d, bool)
        load = np.zeros(d)
        z = np.ones(d)
        has_z = np.zeros(d, bool)
        app = np.zeros(d, np.int64)
        bits = np.zeros(d)
        rate = np.zeros(d)
        gpu_t = np.zeros(d)
        if reqs:
            # the ONE per-task min-z pipeline (sfesp.task_feasibility_rows),
            # shared with sdla.build_instance and restricted to the changed
            # rows (unchanged requests cost zero recompute)
            ts = self.sdla.task_set(reqs)
            rows = task_feasibility_rows(
                ts, sess.z_grid, sess.grid, self.sdla.lat_params,
                semantic=sess.semantic, model=self.sdla.semantics)
            li = np.asarray(live_pos, np.int64)
            lat_ok[li] = rows.lat_ok
            alive[li] = rows.alive
            load[li] = rows.load
            z[li] = rows.z_star
            has_z[li] = rows.z_idx >= 0
            app[li] = ts.app_idx
            bits[li] = ts.bits_per_job
            rate[li] = ts.jobs_per_sec
            gpu_t[li] = ts.gpu_time_per_job
        bb = np.fromiter((b for b, _ in items), np.int64, d)
        tt = np.fromiter((t for _, t in items), np.int64, d)
        sess.z_star[bb, tt] = z
        sess.has_z[bb, tt] = has_z
        sess.app_idx[bb, tt] = app
        sess.bits[bb, tt] = bits
        sess.rate[bb, tt] = rate
        sess.gpu_t[bb, tt] = gpu_t
        sess.dev.update_rows(bb, tt, lat_ok, alive, load)
        self.delta_rows += d
        sess.pending.clear()

    def _refresh_semantics(self, sess: _ServeSession, slot_rows, model):
        """Absorb an in-place model drift as dirty-row delta scatters.

        The drifted apps come from the model's change log
        (``changed_since``); only LIVE slots whose effective curve — the
        task's own app, or its service-wide 'All' fallback in agnostic mode —
        actually moved are recomputed (through the same shared pipeline as
        :meth:`_sync_rows`) and scattered via
        :meth:`~repro_torch.core.sfesp.DeviceStack.update_semantics`. Everything
        else (app/bits/rate mirrors, pins, the session itself) is untouched:
        ``session_rebuilds`` stays 0 across drifts.
        """
        changed = model.changed_since(sess.sem_version)
        sess.sem_version = model.version
        if not changed:
            return
        items: list[tuple[int, int]] = []
        reqs: list[SliceRequest] = []
        for b, rows in enumerate(slot_rows):
            for t, r in enumerate(rows):
                if r is None:
                    continue
                a = semantics.APP_INDEX[r.app_class]
                eff = a if sess.semantic else int(model.agnostic_app(a))
                if eff in changed:
                    items.append((b, t))
                    reqs.append(r)
        if not items:
            return
        ts = self.sdla.task_set(reqs)
        rows_ = task_feasibility_rows(
            ts, sess.z_grid, sess.grid, self.sdla.lat_params,
            semantic=sess.semantic, model=model)
        d = len(items)
        bb = np.fromiter((b for b, _ in items), np.int64, d)
        tt = np.fromiter((t for _, t in items), np.int64, d)
        # only the curve-derived mirrors move; the request-derived ones
        # (app_idx, bits, rate, gpu_t) are drift-invariant
        sess.z_star[bb, tt] = rows_.z_star
        sess.has_z[bb, tt] = rows_.z_idx >= 0
        sess.dev.update_semantics(bb, tt, rows_.lat_ok, rows_.alive,
                                  rows_.load)
        self.semantic_updates += 1

    def _slot_unpacker(self, sess: _ServeSession, slot_rows, out):
        """Build the decision unpacker for one dispatched slot solve.

        Snapshots everything the unpack needs from the session's host
        mirrors AT DISPATCH TIME — live positions, per-row z*/app/stream
        scalars, request objects, resource names, latency params — so the
        returned closure depends only on the device result. That snapshot is
        the host half of the double buffer: a ``wait=False`` caller keeps
        ingesting events (which may dirty rows and later overwrite the
        mirrors) while the solve is in flight, and the unpack still reports
        against the state that was actually solved.
        """
        pos = [(b, t) for b, rows in enumerate(slot_rows)
               for t, r in enumerate(rows) if r is not None]
        if not pos:
            return lambda res: out
        bb = np.fromiter((b for b, _ in pos), np.int64, len(pos))
        tt = np.fromiter((t for _, t in pos), np.int64, len(pos))
        # fancy indexing copies: these are value snapshots, not views
        has_z = sess.has_z[bb, tt]
        z_star = sess.z_star[bb, tt]
        app_idx = sess.app_idx[bb, tt]
        bits = sess.bits[bb, tt]
        rate = sess.rate[bb, tt]
        gpu_t = sess.gpu_t[bb, tt]
        reqs = [slot_rows[b][t] for b, t in pos]
        names = list(sess.names)
        grid = sess.grid
        lat_params = self.sdla.lat_params
        # curve snapshot at dispatch: a model drift landing while the solve
        # is in flight must not change what the unpack reports (the accuracy
        # half of the double buffer)
        model = self.sdla.semantics.snapshot()

        def unpack(res):
            adm = res["admitted"][bb, tt]
            safe = np.clip(res["alloc_idx"][bb, tt], 0, None)
            z = np.where(adm & has_z, z_star, 1.0)
            alloc = grid[safe] * adm[:, None]
            # the identical first-principles report as
            # _decisions/check_solution
            lat = lat_mod.latency(lat_params, bits, rate, gpu_t, z, alloc)
            acc = model.accuracy(app_idx, z)
            for i, (b, t) in enumerate(pos):
                out[b].append(SliceDecision(
                    request=reqs[i],
                    admitted=bool(adm[i]),
                    z=float(z[i]),
                    alloc={n: float(alloc[i, k])
                           for k, n in enumerate(names[b])},
                    expected_latency_s=float(lat[i]),
                    expected_accuracy=float(acc[i]),
                    cell=b,
                ))
            return out

        return unpack

    def _decisions(self, requests, inst, sol,
                   cell: int | None = None) -> list[SliceDecision]:
        report = check_solution(inst, sol, lat_params=self.sdla.lat_params)
        out = []
        for i, r in enumerate(requests):
            alloc = {n: float(sol.alloc[i, k])
                     for k, n in enumerate(inst.pool.names)}
            out.append(SliceDecision(
                request=r,
                admitted=bool(sol.admitted[i]),
                z=float(sol.z[i]),
                alloc=alloc,
                expected_latency_s=float(report["latency"][i]),
                expected_accuracy=float(report["accuracy"][i]),
                cell=cell,
            ))
        return out
