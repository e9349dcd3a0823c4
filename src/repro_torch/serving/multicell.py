"""Port of ``src/repro/serving/multicell.py``: the multi-cell serving control
loop, joint re-slicing across coupled cells.

The paper's system-wide claim (Section III: joint admission across cells
sharing transport) lands in the data plane here. A :class:`MultiCellEngine`
owns N per-cell :class:`~repro_torch.serving.engine.CellRuntime` data planes plus
an optional :class:`~repro_torch.core.types.CouplingSpec` for the shared
midhaul/backhaul links, and every :meth:`MultiCellEngine.reslice` gathers ALL
cells' running + pending requests into ONE coupled
``SESM.solve_batch(request_sets, coupling=..., pools=...)`` call — one device
program per re-slice. The SESM's pow2-bucket ``restack`` cache persists
across ticks, so the closed loop neither re-stacks the padded host buffers
nor recompiles the device program after the first tick (``sesm.fresh_stacks``
/ ``sesm.restacks`` expose the hit rate).

Reference semantics: the admitted set per re-slice equals
``core.baselines.solve_coupled_ref`` on the gathered per-cell instances
(asserted in tests and the sweep benchmark). Retry and handover behavior
ports ``core.scenarios.closed_loop_trace``: rejected requests re-offer from a
bounded retry queue (drop after ``max_retries`` rejections), and
:meth:`handover` moves a running task between cells with its achieved ``z``
pinned as a warm-start accuracy bound. Enforcing solver decisions in a live
loop rather than per-snapshot follows the O-RAN slicing-enforcement
literature (arXiv:2103.10277, arXiv:2202.06439).

Cache lifecycle (what persists across ticks, and what invalidates it):

* ``SESM._batch_cache`` — the padded HOST stack of the previous
  :meth:`MultiCellEngine.reslice_rebuild`. Key: (batch size, pow2 Tmax
  bucket). Refilled in place via ``core.sfesp.restack`` when the key
  matches (counter ``sesm.restacks``); rebuilt fresh — and therefore with
  fresh device halves — when the batch size changes or a cell's task count
  overflows the bucket (``sesm.fresh_stacks``).
* The DEVICE half — ``core.sfesp.device_stack`` — is memoized ON the host
  stack object, so a restack (a NEW object sharing the old buffers)
  implicitly drops it; see the "Device half" section of ``core/sfesp.py``
  for the cache keys.
* ``SESM._serve_session`` — the fully device-resident state of the
  :meth:`MultiCellEngine.reslice` fast path. Dirty slot indices reported by
  ``CellRuntime.sync_slots(consume=True)`` ACCUMULATE in
  ``_ServeSession.pending`` until a live solve consumes them (a tick with
  zero live requests keeps them pending); only those rows are recomputed on
  the host and scattered into the device tables (``sesm.delta_rows``). The
  session rebuilds when the batch size / Tmax bucket / algorithm / coupling
  / pools identity / SDLA latency scale changes.

The engine runs on one ``device`` (``"cuda"`` by default): the serve
session's tables live there, the re-slice's admission rounds run there (K1
on a card) and so do the cells' vision jobs (K3). The reference's METRO mode
(a mesh-resident sharded session) is not ported yet.

FAULT PLANE. The engine degrades gracefully instead of assuming healthy
topologies:

* :meth:`MultiCellEngine.fail_cell` / :meth:`MultiCellEngine.recover_cell`
  — a dying cell's running tasks AND retry queue drain into live coupled
  neighbors (accuracy pins and remaining retry budgets carried, exactly as
  :meth:`MultiCellEngine.handover` does); with no live target they drop
  (``drain_drops``). The dead cell stays IN the batch as zero-task rows —
  its vacated slots are cleared by the ordinary dirty-row delta, so neither
  the pow2 restack cache nor the device ``_ServeSession`` is invalidated.
* time-varying link budgets — ``CouplingSpec.set_budgets`` mutates the
  budget values in place (same array object = same link set), and
  :meth:`MultiCellEngine.set_link_budgets` is the engine-level entry; the
  session survives via one (L,) device refresh (``sesm.link_updates``).
* time-varying SEMANTICS — :meth:`MultiCellEngine.shift_semantics` (the
  ``SemanticShift`` event) moves the SDLA's accuracy curves in place: the
  model keeps its identity, bumps its version, and the next re-slice
  rescatters only the rows of tasks whose effective app changed
  (``sesm.semantic_updates``); handover pins stay at their recorded values.
* heartbeats — every :meth:`MultiCellEngine.process` tick stamps
  ``repro_torch.runtime.fault_tolerance.HeartbeatMonitor`` per live cell (and
  feeds ``repro_torch.runtime.fault_tolerance.StragglerMitigator`` the measured
  tick time); a cell silent for ``heartbeat_timeout`` ticks is auto-failed
  and drained on the next re-slice (:meth:`MultiCellEngine.check_faults`).
* priority tiers — :class:`TierPolicy` sheds LOW-priority queued requests
  first when a cell's retry queue exceeds its pressure threshold, within
  per-tier drop budgets, BEFORE the solve (the solver stays SLA-blind).
* tier-aware PREEMPTION (``preempt=True``) — AFTER the solve, a rejected
  candidate whose coupling group still runs a strictly lower-priority task
  preempts it and the freed rows re-solve as a delta; only the second
  round applies (:meth:`MultiCellEngine._preempt_pass`).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from ..core.events import (Arrival, CellFault, Departure, Handover,
                           LinkScale, SemanticShift, Tick)
from ..core.latency import LatencyParams
from ..core.types import CouplingSpec, ResourcePool
from ..kernels import resolve_device
from ..runtime.fault_tolerance import HeartbeatMonitor, StragglerMitigator
from .admission import SESM, SliceDecision
from .engine import CellRuntime, TaskRuntime, pinned_accuracy_at
from .request import SliceRequest
from .sdla import SDLA

__all__ = ["MultiCellEngine", "TierPolicy"]


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Graceful-degradation policy over request priority tiers.

    A cell whose retry/pending queue grows past ``queue_threshold`` is under
    pressure: before the next solve the engine sheds queued requests —
    lowest-priority tier first, newest first within a tier — until the queue
    is back at the threshold or the per-tier budgets are spent.

    Attributes:
      queue_threshold: max queue depth a cell tolerates before shedding.
      drop_budgets: tier → max sheds per cell per re-slice. Tiers ABSENT
        from the map are never shed, so the high-priority tier 0 is
        protected unless explicitly budgeted.
    """

    queue_threshold: int = 4
    drop_budgets: dict[int, int] = dataclasses.field(default_factory=dict)


class MultiCellEngine:
    """N coupled cell runtimes re-sliced jointly through one SESM batch.

    Args:
      pools: one :class:`ResourcePool` per cell. Capacities/prices may
        differ; ``levels`` must be identical (one shared allocation grid —
        the batched sweep engine's stacking contract).
      coupling: optional shared-link topology; ``incidence`` needs one row
        per cell. ``None`` re-slices the cells as independent what-ifs
        (still one device program).
      max_retries: per-request rejection budget of every cell's retry queue.
      preempt: enable the tier-aware POST-SOLVE preemption pass: when a
        re-slice rejects a candidate while a strictly lower-priority task
        keeps running in its coupling group, the engine preempts the
        lowest-priority (newest-first) running victim and re-solves the
        freed rows as a delta — the solver itself stays SLA-blind, and only
        the second round's decisions are applied. See :meth:`_preempt_pass`.
      device: where the serve session, the admission solve and the vision
        jobs run; ``"cuda"`` by default (raises when no card is visible).
    """

    def __init__(self, pools: list[ResourcePool], *,
                 coupling: CouplingSpec | None = None, lat_params=None,
                 max_batch: int = 8, max_retries: int = 2,
                 solver_backend: str = "numpy",
                 tier_policy: TierPolicy | None = None,
                 preempt: bool = False, heartbeat_timeout: int = 3,
                 device="cuda"):
        self.device = resolve_device(device)
        pools = list(pools)
        if not pools:
            raise ValueError("MultiCellEngine needs at least one cell pool")
        for pool in pools[1:]:
            if len(pool.levels) != len(pools[0].levels) or not all(
                    np.array_equal(a, b)
                    for a, b in zip(pool.levels, pools[0].levels)):
                raise ValueError(
                    "all cell pools must share one allocation grid "
                    "(identical pool.levels); capacities may differ")
        if coupling is not None and coupling.num_cells != len(pools):
            raise ValueError(
                f"coupling.incidence has {coupling.num_cells} rows for "
                f"{len(pools)} cells")
        self.pools = pools
        self.coupling = coupling
        self.sdla = SDLA(lat_params or LatencyParams())
        self.sesm = SESM(pools[0], self.sdla, backend=solver_backend,
                         device=self.device)
        # shared request-id → cell index, maintained by every CellRuntime
        # enter/leave path (submit, hand-in/out, departure, drop, shed,
        # drain) — the O(1) locate() the event stream routes through
        self._cell_of: dict[int, int] = {}
        self.cells = [CellRuntime(p, self.sdla, max_batch=max_batch,
                                  max_retries=max_retries, cell=c,
                                  registry=self._cell_of,
                                  device=self.device)
                      for c, p in enumerate(pools)]
        self.handovers = 0
        # ----------------------------------------------------- fault plane
        self.tier_policy = tier_policy
        self.preempt = preempt
        # candidates rejected by round 1 and admitted by the post-preemption
        # re-solve — the lift the preemption pass buys, by RESCUED tier
        self.preempt_rescued = 0
        self.preempt_rescued_by_tier: collections.Counter = \
            collections.Counter()
        self.dead: set[int] = set()            # failed cells (zero-task rows)
        self._silent: set[int] = set()         # injected hangs (skip process)
        self.tick = 0                          # process() counter = heartbeat
        self.monitor = HeartbeatMonitor(len(pools),
                                        timeout_steps=heartbeat_timeout)
        self.stragglers = StragglerMitigator(len(pools))
        self._nominal_budgets = None if coupling is None \
            else coupling.link_capacity.copy()
        self._drain_rr = 0                     # round-robin drain cursor
        self.drained = 0                       # tasks re-homed by fail_cell
        self.drain_drops = 0                   # tasks lost (no live target)
        self.drain_drops_by_tier: collections.Counter = collections.Counter()
        self.recoveries = 0
        self.degraded_ticks = 0                # re-slices run while degraded
        self.sheds = 0                         # TierPolicy pressure sheds
        self.fault_log: list[dict] = []        # fail/recover events, in order

    @property
    def num_cells(self) -> int:
        return len(self.cells)

    @property
    def live_cells(self) -> list[int]:
        """Cell indices currently serving (not failed)."""
        return [c for c in range(self.num_cells) if c not in self.dead]

    @property
    def degraded(self) -> bool:
        """True while any cell is failed or any link budget is below its
        nominal (construction-time) value."""
        if self.dead:
            return True
        return self.coupling is not None and bool(
            (self.coupling.link_capacity < self._nominal_budgets).any())

    # --------------------------------------------------------- fault plane
    def _check_cell(self, cell: int):
        if not 0 <= cell < self.num_cells:
            raise ValueError(
                f"cell {cell} outside this engine's {self.num_cells} cells")

    def _drain_targets(self, cell: int) -> list[int]:
        """Live drain destinations for ``cell``'s tasks: coupled neighbors
        (same coupling group) first, any live cell as fallback."""
        live = [c for c in range(self.num_cells)
                if c not in self.dead and c != cell]
        if self.coupling is not None and live:
            groups = self.coupling.groups()
            peers = [c for c in live if groups[c] == groups[cell]]
            if peers:
                return peers
        return live

    def fallback_cell(self, cell: int) -> int | None:
        """Where traffic aimed at ``cell`` goes while it is failed: the
        first drain target (coupled neighbor preferred), ``None`` if no
        cell is live. Drivers use this to re-home arrivals during outages."""
        self._check_cell(cell)
        targets = self._drain_targets(cell)
        return targets[0] if targets else None

    def fail_cell(self, cell: int,
                  reason: str = "operator") -> dict[int, int | None]:
        """Declare ``cell`` dead and drain its candidate set into live
        coupled neighbors.

        Running tasks drain with their achieved-``z`` accuracy pin and
        runtime carried (the :meth:`handover` semantics); queued requests
        keep their existing pin/runtime, and every drained request keeps its
        REMAINING retry budget — a request one rejection from dropping is
        still one rejection from dropping in its new cell. Re-homing is
        deterministic: highest-priority tier first, round-robin over the
        targets. With no live target, tasks drop (``drain_drops``).

        The dead cell stays in the coupled batch as zero-task rows: its
        vacated solver-row slots are reported dirty by the next
        ``sync_slots`` and cleared by the ordinary delta scatter, so the
        restack cache and the device session survive the outage. Until
        :meth:`recover_cell`, submitting to the cell raises and
        :meth:`process` skips it.

        Returns ``{request_id: target_cell | None}`` (``None`` = dropped) so
        drivers can re-point departure schedules.
        """
        self._check_cell(cell)
        if cell in self.dead:
            raise ValueError(f"cell {cell} is already failed")
        self.dead.add(cell)
        items = self.cells[cell].drain()
        # stable by tier: high-priority tasks grab drain capacity first and
        # keep the running-first order within their tier
        items.sort(key=lambda it: it[0].tier)
        targets = self._drain_targets(cell)
        moves: dict[int, int | None] = {}
        dropped = 0
        for i, (req, rt, retries, pin) in enumerate(items):
            if not targets:
                moves[req.request_id] = None
                dropped += 1
                self.drain_drops += 1
                self.drain_drops_by_tier[req.tier] += 1
                continue
            dst = targets[(self._drain_rr + i) % len(targets)]
            self.cells[dst].hand_in(req, rt, retries, pin)
            moves[req.request_id] = dst
            self.drained += 1
        self._drain_rr += len(items)
        self.fault_log.append(dict(
            tick=self.tick, cell=cell, event="fail", reason=reason,
            moved=len(items) - dropped, dropped=dropped))
        return moves

    def recover_cell(self, cell: int):
        """Bring a failed cell back: it rejoins the batch empty (its tasks
        stayed where they drained to) and its heartbeat window restarts —
        a recovered cell must not be instantly re-declared dead off its
        stale pre-outage heartbeat."""
        self._check_cell(cell)
        if cell not in self.dead:
            raise ValueError(f"cell {cell} is not failed")
        self.dead.discard(cell)
        self._silent.discard(cell)
        self.monitor.revive(cell)
        self.stragglers.reset(cell)
        self.recoveries += 1
        self.fault_log.append(dict(tick=self.tick, cell=cell,
                                   event="recover"))

    def silence_cell(self, cell: int):
        """Fault injection: the cell hangs — it stops processing AND stops
        stamping heartbeats, so :meth:`check_faults` auto-fails it after the
        monitor's timeout (cleared by :meth:`recover_cell`)."""
        self._check_cell(cell)
        self._silent.add(cell)

    def check_faults(self) -> dict[int, dict[int, int | None]]:
        """Auto-fail cells the heartbeat monitor declares dead (silent for
        ``heartbeat_timeout`` process ticks); runs at the top of every
        re-slice. Returns ``{cell: drain moves}`` for newly failed cells."""
        failed = {}
        for h in self.monitor.dead_hosts():
            if h not in self.dead:
                failed[h] = self.fail_cell(h, reason="heartbeat")
        return failed

    def set_link_budgets(self, budgets=None, *, scale: float | None = None):
        """Degrade (or restore) the shared-link budgets IN PLACE — the
        budget-only coupling change the device session survives.

        Pass explicit per-link ``budgets`` (L,) or a ``scale`` factor
        applied to the NOMINAL (construction-time) budgets. The coupling
        object is mutated via ``CouplingSpec.set_budgets`` so its array
        identity — what the session's topology guard compares — is
        preserved; the next re-slice refreshes the (L,) device buffer
        without rebuilding (``sesm.link_updates``)."""
        if self.coupling is None:
            raise ValueError(
                "engine has no coupling: no link budgets to degrade")
        if (budgets is None) == (scale is None):
            raise ValueError("pass exactly one of budgets= or scale=")
        if scale is not None:
            budgets = self._nominal_budgets * float(scale)
        self.coupling.set_budgets(budgets)

    def shift_semantics(self, app_idx=None, *, params=None, scale=None):
        """Semantic drift entry (the :class:`SemanticShift` event): move the
        SDLA's accuracy curves IN PLACE — the model-only change the device
        session survives.

        Exactly one of ``scale`` (asymptotes to ``scale ×`` nominal) or
        ``params`` (explicit ``(K, 3)`` rows). The SDLA's model object keeps
        its identity and bumps its version, so the next re-slice refreshes
        only the rows of tasks whose EFFECTIVE app changed — host recompute
        plus a dirty-row device scatter (``sesm.semantic_updates``), never a
        session rebuild. Accuracy pins recorded by earlier handovers are
        values, not curve lookups: they do not move. Returns the model's new
        signature."""
        return self.sdla.recalibrate(app_idx, params=params, scale=scale)

    def _shed_pressure(self) -> int:
        """Apply the TierPolicy: shed low-tier queued requests from cells
        whose queues exceed the pressure threshold (before the solve)."""
        pol = self.tier_policy
        if pol is None:
            return 0
        total = 0
        for c in self.live_cells:
            cell = self.cells[c]
            over = cell.queue_depth - pol.queue_threshold
            if over <= 0:
                continue
            budget = dict(pol.drop_budgets)
            # lowest-priority tier first; newest arrival first within a tier
            cands = sorted(
                ((cell.tier_of(rid), pos, rid)
                 for pos, rid in enumerate(cell.queued_ids())),
                key=lambda x: (-x[0], -x[1]))
            for tier, _, rid in cands:
                if over <= 0:
                    break
                if budget.get(tier, 0) <= 0:
                    continue
                budget[tier] -= 1
                cell.shed(rid)
                over -= 1
                total += 1
        self.sheds += total
        return total

    def _pre_reslice(self):
        """Per-re-slice fault preamble: promote heartbeat silence to
        failures, shed queue pressure, count degraded ticks."""
        self.check_faults()
        self._shed_pressure()
        if self.degraded:
            self.degraded_ticks += 1

    # --------------------------------------------------------- event stream
    def ingest(self, events) -> dict:
        """Consume a stream of typed events (``repro_torch.core.events``) between
        re-slice ticks — the serving plane's unified ingestion API.

        Every mutation the positional methods expose routes through here:
        ``submit``/``remove`` are one-event wrappers, the closed-loop driver
        and the fault schedules in ``core.scenarios`` are event generators.
        Stream semantics are TOLERANT where the positional methods are
        strict, because events are asynchronous with the engine state they
        race (drains, auto-failovers, departures):

        * an :class:`Arrival` aimed at a failed cell re-homes to its
          ``fallback_cell`` (counted ``rehomed``) or, with no live cell,
          is counted ``lost`` — unless the event says ``fallback=False``
          (the strict ``submit`` contract), which raises;
        * a :class:`Departure` with ``cell=None`` locates the request
          first; a departure for an id that already left counts ``missing``;
        * a :class:`Handover` that is no longer feasible (task departed,
          drained elsewhere, not running, endpoint dead) is skipped and
          counted (``handovers_skipped``);
        * a :class:`CellFault` that is already satisfied (failing a dead
          cell, recovering a live one) is a no-op.

        Duplicate live request ids always raise — that is a caller bug, not
        an event race. Returns a summary dict of what the batch did.
        """
        s = dict(arrivals=0, placed=0, rehomed=0, lost=0, departures=0,
                 missing=0, handovers=0, handovers_skipped=0, failed=[],
                 recovered=[], moves={}, link_updates=0, semantic_shifts=0,
                 ticks=0)
        for event in events:
            if type(event) is Arrival:
                s["arrivals"] += 1
                cell = event.cell
                self._check_cell(cell)
                if cell in self.dead:
                    if not event.fallback:
                        raise ValueError(
                            f"cell {cell} is failed; recover_cell({cell}) "
                            f"first, or submit to fallback_cell({cell})")
                    cell = self.fallback_cell(event.cell)
                    if cell is None:
                        s["lost"] += 1
                        continue
                    s["rehomed"] += 1
                request = event.request
                rid = request.request_id
                live_in = self._cell_of.get(rid)
                if live_in is not None:
                    # one stream must load the shared transport once: a live
                    # cross-cell duplicate would be admitted (and budgeted)
                    # twice
                    raise ValueError(
                        f"request {rid} is already live in cell {live_in}; "
                        "use handover() to move it, or clone with a fresh "
                        "request_id")
                self.cells[cell].submit(request)
                s["placed"] += 1
            elif type(event) is Departure:
                cell = self._cell_of.get(event.request_id) \
                    if event.cell is None else event.cell
                if cell is None \
                        or not self.cells[cell].is_live(event.request_id):
                    s["missing"] += 1
                    continue
                self.cells[cell].remove(event.request_id)
                s["departures"] += 1
            elif type(event) is Handover:
                rid = event.request_id
                feasible = (event.src != event.dst
                            and event.src not in self.dead
                            and event.dst not in self.dead
                            and self._cell_of.get(rid) == event.src
                            and rid in self.cells[event.src].tasks)
                if not feasible:
                    s["handovers_skipped"] += 1
                    continue
                self.handover(rid, event.src, event.dst)
                s["handovers"] += 1
            elif type(event) is CellFault:
                self._check_cell(event.cell)
                if event.failed and event.cell not in self.dead:
                    s["moves"].update(self.fail_cell(event.cell,
                                                     reason=event.reason))
                    s["failed"].append(event.cell)
                elif not event.failed and event.cell in self.dead:
                    self.recover_cell(event.cell)
                    s["recovered"].append(event.cell)
            elif type(event) is LinkScale:
                self.set_link_budgets(event.budgets, scale=event.scale)
                s["link_updates"] += 1
            elif type(event) is SemanticShift:
                self.shift_semantics(event.app_idx, params=event.params,
                                     scale=event.scale)
                s["semantic_shifts"] += 1
            elif type(event) is Tick:
                self.process(event.wall_dt)
                s["ticks"] += 1
            else:
                raise TypeError(
                    f"not a serving event: {event!r} (expected one of "
                    "repro_torch.core.events.Event)")
        return s

    # ------------------------------------------------------------- control
    def submit(self, request: SliceRequest, cell: int):
        """One-event wrapper: a strict (``fallback=False``) :class:`Arrival`
        through :meth:`ingest` — raises on failed cells and duplicates."""
        self.ingest([Arrival(request, cell, fallback=False)])

    def remove(self, request_id: int,
               cell: int | None = None) -> TaskRuntime | None:
        """Withdraw a departed task (no retry/drop accounting): the
        :class:`Departure` event, plus the legacy return of the withdrawn
        runtime. ``cell=None`` locates the request first."""
        if cell is None:
            cell = self.locate(request_id)
            if cell is None:
                return None
        return self.cells[cell].remove(request_id)

    def locate(self, request_id: int) -> int | None:
        """The cell a request is currently live in (running or queued),
        ``None`` if it left the system — an O(1) lookup in the shared
        registry every CellRuntime enter/leave path maintains. Drains and
        auto-failovers move requests without their submitter's knowledge —
        departure logic should locate before removing."""
        return self._cell_of.get(request_id)

    def gather(self) -> list[list[SliceRequest]]:
        """Every cell's candidate set (running + retry queue, pins applied),
        in the STABLE SLOT ORDER the fast-path re-slice solves (see
        ``CellRuntime.sync_slots``; cleared slots are dropped).

        Idempotent — tests re-gather the same sets to assert the engine's
        admissions against ``solve_coupled_ref`` on the gathered instances.
        """
        return [[r for r in cell.sync_slots()[0] if r is not None]
                for cell in self.cells]

    def reslice(self) -> list[list[SliceDecision]]:
        """One joint re-slice: sync every cell's solver-row slots → ONE
        coupled device program over the DEVICE-RESIDENT session (only dirty
        rows are recomputed and scattered — a steady tick re-uploads
        nothing) → apply per-cell (evictions flagged, rejected requests
        re-queued). Decisions are identical to the full-rebuild
        :meth:`reslice_rebuild` path; ``sesm.fresh_stacks``/``restacks``/
        ``delta_rows`` expose the session-cache health."""
        return self.reslice_commit(self.reslice_dispatch())

    def reslice_dispatch(self):
        """First half of :meth:`reslice` — the DOUBLE-BUFFERED tick.

        Runs the fault preamble, consumes every cell's dirty slots into the
        device session and LAUNCHES the coupled solve without awaiting its
        result: the returned handle owns the back buffer (this tick's host
        mirror snapshot plus the in-flight device arrays), while the live
        slot tables remain the front buffer. Until
        :meth:`reslice_commit` is called the engine keeps ingesting events —
        slot-table writes for tick N+1 overlap the device solve of tick N.
        Events that land in the window get the same semantics the positional
        API gave calls between ``gather()`` and ``apply()``: new arrivals
        stay queued for the next round, and decisions for requests that
        departed meanwhile are dropped as stale at commit.
        """
        self._pre_reslice()
        rows, dirty = [], []
        for cell in self.cells:
            r, d = cell.sync_slots(consume=True)
            rows.append(r)
            dirty.append(d)
        return self.sesm.solve_slots(rows, dirty, coupling=self.coupling,
                                     pools=self.pools, wait=False)

    def reslice_commit(self, pending) -> list[list[SliceDecision]]:
        """Second half of :meth:`reslice`: await the dispatched solve's
        device arrays, unpack them against the back-buffer host mirrors
        captured at dispatch, and apply the decisions per cell. With
        ``preempt=True`` the awaited decisions first run the tier-aware
        preemption pass — which may replace them with a re-solve's — so the
        per-tier offered/admitted counters always see exactly ONE round."""
        decisions = pending.wait()
        if self.preempt:
            decisions = self._preempt_pass(decisions)
        return [cell.apply(ds) for cell, ds in zip(self.cells, decisions)]

    def _preempt_pass(self, decisions: list[list[SliceDecision]]
                      ) -> list[list[SliceDecision]]:
        """Tier-aware post-solve preemption: arbitration the solver never
        sees.

        For every candidate round 1 rejected while a STRICTLY lower-priority
        task (greater tier number) kept running in its coupling group, one
        victim is preempted — lowest priority first, newest arrival first
        within a tier, then by cell index — and the freed rows re-solve as
        an ordinary dirty-row delta on the live device session. Victims pay
        the
        standard eviction price (one retry consumed, pin cleared, re-queued
        or dropped; ``CellRuntime.preempt``); a surviving victim's row is
        hidden from the re-solve only — its slot re-dirties afterwards, so
        it re-offers next tick. Round-1 decisions are DISCARDED unapplied;
        the caller applies only the returned round."""
        groups = self.coupling.groups() if self.coupling is not None \
            else list(range(self.num_cells))
        admitted: list[set[int]] = [set() for _ in self.cells]
        rejected: list[tuple[int, int, int, int]] = []
        for c, ds in enumerate(decisions):
            for i, d in enumerate(ds):
                rid = d.request.request_id
                if d.admitted:
                    admitted[c].add(rid)
                else:
                    rejected.append((d.request.tier, c, i, rid))
        if not rejected:
            return decisions
        # the preemptible pool: tasks RUNNING before this tick that round 1
        # would keep running (a task round 1 already rejected frees its
        # capacity anyway — preempting it would punish it twice)
        pool: list[tuple[int, int, int, int]] = []
        for c, cell in enumerate(self.cells):
            for rid in cell.tasks:
                if rid in admitted[c]:
                    slot = cell._slot_of[rid]
                    pool.append((int(cell._tier[slot]),
                                 int(cell._gen[slot]), c, rid))
        if not pool:
            return decisions
        pool.sort(key=lambda v: (-v[0], -v[1], v[2]))
        rejected.sort()                      # highest-priority claims first
        victims: list[tuple[int, int]] = []
        used: set[int] = set()
        for tier, c, _, _rid in rejected:
            grp = groups[c]
            pick = next((i for i, v in enumerate(pool)
                         if i not in used and v[0] > tier
                         and groups[v[2]] == grp), None)
            if pick is not None:
                used.add(pick)
                victims.append((pool[pick][2], pool[pick][3]))
        if not victims:
            return decisions
        # evict: standard eviction bookkeeping + preemption attribution; a
        # surviving (re-queued) victim keeps its slot — hide it this round
        hidden: list[list[int]] = [[] for _ in self.cells]
        for c, rid in victims:
            cell = self.cells[c]
            slot = cell._slot_of[rid]
            if cell.preempt(rid):
                hidden[c].append(slot)
        rows2, dirty2 = [], []
        for c, cell in enumerate(self.cells):
            r, d = cell.sync_slots(consume=True)
            r = list(r)
            for s in hidden[c]:
                r[s] = None
                d.append(s)
            rows2.append(r)
            dirty2.append(sorted(set(d)))
        redo = self.sesm.solve_slots(rows2, dirty2,
                                     coupling=self.coupling,
                                     pools=self.pools, wait=False)
        decisions2 = redo.wait()
        # surviving victims re-offer NEXT tick: re-dirty the hidden slots so
        # the next consuming sync rescatters the real rows
        for c, slots in enumerate(hidden):
            for s in slots:
                self.cells[c]._dirty[s] = True
        rejected_ids = [{rid for _t, cc, _i, rid in rejected if cc == c}
                        for c in range(self.num_cells)]
        for c, ds in enumerate(decisions2):
            for d in ds:
                if d.admitted and d.request.request_id in rejected_ids[c]:
                    self.preempt_rescued += 1
                    self.preempt_rescued_by_tier[d.request.tier] += 1
        return decisions2

    def reslice_rebuild(self) -> list[list[SliceDecision]]:
        """The pre-fast-path re-slice: rebuild every cell's instance and
        restack the full host tables through ``SESM.solve_batch``. Kept as
        the reference implementation the fast path is tested (and benched)
        against."""
        self._pre_reslice()
        decisions = self.sesm.solve_batch(self.gather(),
                                          coupling=self.coupling,
                                          pools=self.pools)
        return [cell.apply(ds) for cell, ds in zip(self.cells, decisions)]

    def handover(self, request_id: int, src: int, dst: int) -> float:
        """Move a RUNNING task from cell ``src`` to cell ``dst``.

        The stream is already encoded at the task's admitted ``z``, so it
        re-arrives in ``dst`` with its accuracy bound pinned to the level
        achieved at that ``z`` (warm start — Eq. (2) re-derives at most the
        same compression instead of renegotiating the stream; the
        ``closed_loop_trace`` handover semantics). The task's runtime (job
        and latency history) carries over and resumes if the next re-slice
        admits it; its remaining retry budget travels with it. Returns the
        pinned accuracy bound.
        """
        if src == dst:
            raise ValueError("handover requires distinct src and dst cells")
        if dst in self.dead or src in self.dead:
            raise ValueError(
                f"handover {src}->{dst}: cell "
                f"{dst if dst in self.dead else src} is failed")
        req, rt, retries = self.cells[src].hand_out(request_id)
        pin = pinned_accuracy_at(req, rt.decision.z,
                                 model=self.sdla.semantics)
        self.cells[dst].hand_in(req, rt, retries, pin)
        self.handovers += 1
        return pin

    # --------------------------------------------------------------- data
    def process(self, wall_dt: float = 1.0):
        """One engine tick: every LIVE cell runs its admitted tasks' jobs,
        stamps its heartbeat and feeds the straggler EWMA its measured tick
        time. Failed and silenced cells skip — which is exactly how a hung
        cell becomes heartbeat-silent and gets auto-failed."""
        self.tick += 1
        for c, cell in enumerate(self.cells):
            if c in self.dead or c in self._silent:
                continue
            t0 = time.perf_counter()
            cell.process(wall_dt)
            self.stragglers.record(c, time.perf_counter() - t0)
            self.monitor.beat(c, self.tick)

    def metrics(self) -> dict:
        """Per-cell metrics keyed by cell index (see CellRuntime.metrics),
        plus a ``"totals"`` entry aggregating the engine-wide SLA counters:
        retry-queue depth, drops/evictions/sheds (overall and per tier),
        drain and fault-plane state, and the session-cache health counters
        the degradation fast path is asserted on."""
        out: dict = {c: cell.metrics() for c, cell in enumerate(self.cells)}

        def merged(name: str) -> dict[int, int]:
            total: collections.Counter = collections.Counter()
            for cell in self.cells:
                total.update(getattr(cell, name))
            return dict(total)

        out["totals"] = dict(
            running=sum(len(cell.tasks) for cell in self.cells),
            retry_depth=sum(cell.queue_depth for cell in self.cells),
            drops=sum(cell.drops for cell in self.cells),
            evictions=sum(cell.evictions for cell in self.cells),
            sheds=sum(cell.sheds for cell in self.cells),
            preemptions=sum(cell.preemptions for cell in self.cells),
            preempt_rescued=self.preempt_rescued,
            handovers=self.handovers,
            drained=self.drained,
            drain_drops=self.drain_drops,
            recoveries=self.recoveries,
            dead_cells=sorted(self.dead),
            degraded=self.degraded,
            degraded_ticks=self.degraded_ticks,
            link_updates=self.sesm.link_updates,
            semantic_updates=self.sesm.semantic_updates,
            session_rebuilds=self.sesm.session_rebuilds,
            stragglers=sorted(self.stragglers.chronic()),
            offered_by_tier=merged("offered_by_tier"),
            admitted_by_tier=merged("admitted_by_tier"),
            evictions_by_tier=merged("evictions_by_tier"),
            drops_by_tier=merged("drops_by_tier"),
            sheds_by_tier=merged("sheds_by_tier"),
            preemptions_by_tier=merged("preemptions_by_tier"),
            preempt_rescued_by_tier=dict(self.preempt_rescued_by_tier),
            drain_drops_by_tier=dict(self.drain_drops_by_tier),
        )
        return out
