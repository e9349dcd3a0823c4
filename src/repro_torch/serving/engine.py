"""Port of ``src/repro/serving/engine.py``: the SEM-O-RAN edge serving
engine's per-cell data plane.

Ties the paper's control plane (SDLA + SESM admission) to an execution data
plane: per admitted task, input streams are compressed by the slicer-chosen
factor z (the K3 bilinear-resize kernel on a CUDA device, for frame
streams), batched, and run with the sliced accelerator share. Frames are
generated on the host exactly as in the reference and uploaded to the
engine's device. LM-service tasks (``_run_lm_job``) run the registered
model's infer function — a prefill, whose full-causal attention is the K4
flash-attention kernel on a CUDA device — on the reference's token draw.

Resource mapping (DESIGN.md §4): the "gpu" resource type is a count of
accelerator slices; on the emulated runtime each slice contributes a fixed
service rate, and the engine enforces the radio share by throttling ingest
bitrate — so the end-to-end latency accounting mirrors core.latency.

The module is split control/data:

* :class:`CellRuntime` is the per-cell DATA plane — admitted task runtimes,
  the pending/retry queue (rejected requests re-offer up to ``max_retries``
  times before dropping, the ``closed_loop_trace`` semantics), handover
  warm-start pins, job execution, metrics. It never talks to a solver.
* :class:`EdgeServingEngine` is a deprecated thin 1-cell view over
  :class:`repro_torch.serving.multicell.MultiCellEngine` (kept as a shim).
* The multi-cell control loop lives in
  :class:`repro_torch.serving.multicell.MultiCellEngine`, which syncs N cell
  runtimes' solver-row slots into ONE coupled device program per re-slice.

STRUCT-OF-ARRAYS DATA PLANE. ``CellRuntime`` stores per-request state in
slot-indexed numpy tables that mirror the solver rows one-to-one: ``_rid``
(request id, -1 = free), ``_state`` (free/queued/running), ``_tier``,
``_retries_left``, ``_pin`` (handover warm-start accuracy bound, 0.0 =
unpinned), ``_gen`` (per-arrival generation), ``_deadline`` / ``_bits``
(SLA deadline and resolved stream size), ``_dirty`` (accumulated
changed-row bits) and the ``_sig_gen`` / ``_sig_pin`` signatures of the
last consumed sync. A request is seated in the lowest free slot at the
first :meth:`CellRuntime.sync_slots` after it arrives (a min-heap of freed
slots keeps assignment identical to the old candidate-order walk), keeps
that slot for as long as it stays a candidate, and frees it on departure/
drop/handover — so slot sync is a vectorized signature compare over the
tables plus a ``flatnonzero`` of the dirty bits instead of a Python loop
over request objects, and event ingestion between ticks costs O(1) numpy
scalar writes per event. Three slot-indexed object tables ride along for
the parts that are inherently per-object: ``_req`` (the original request),
``_row`` (the solver-row view with the pin applied — what ``sync_slots``
returns without re-deriving), and ``_rt`` (the live or parked
:class:`TaskRuntime`).

The FIFO queue is a list of ``(rid, gen)`` entries with LAZY deletion: a
departure of a queued request only detaches its id from the tables (O(1));
the stale queue entry is skipped by generation mismatch wherever the queue
is read and physically purged by the per-tick rebuild in :meth:`apply` —
so a churn-heavy event window never pays O(queue) per departure.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import time

import numpy as np
import torch

from ..core import semantics
from ..core.latency import latency as latency_model
from ..core.types import ResourcePool
from ..data.pipeline import FrameStream
from ..kernels import resolve_device
from ..kernels.resize import ops as resize_ops
from .admission import SliceDecision
from .request import SliceRequest
from .sdla import SDLA

__all__ = ["CellRuntime", "EdgeServingEngine", "TaskRuntime",
           "pinned_accuracy_at"]

# slot states
_FREE, _QUEUED, _RUNNING = 0, 1, 2


@dataclasses.dataclass
class TaskRuntime:
    decision: SliceDecision
    jobs_done: int = 0
    jobs_dropped: int = 0
    latencies: list = dataclasses.field(default_factory=list)


class CellRuntime:
    """Per-cell serving data plane: tasks, retry queue, execution, metrics.

    Decision application follows the closed-loop trace semantics
    (``core.scenarios.closed_loop_trace``): a rejected request — new OR
    previously running (an eviction, surfaced as ``decision.evicted``) — goes
    back onto the bounded retry queue and re-offers on the next re-slice,
    until its ``max_retries`` budget is exhausted and it drops. A handed-over
    task re-arrives with its accuracy bound pinned at the level achieved at
    its admitted ``z`` (the stream is already encoded — warm start); the pin
    clears on rejection, since an unserved task has no encoded stream to
    warm-start from.

    ``registry`` is an optional shared ``{request_id: cell}`` index (the
    engine-level O(1) ``locate``): every path a request enters or leaves the
    cell through keeps it consistent — submit, hand-in, departure, handover,
    drain, shed, retry-exhaustion drop. ``device`` is where the cell's vision
    jobs compress their frames and its LM jobs run their prompts.
    """

    def __init__(self, pool: ResourcePool, sdla: SDLA, *, max_batch: int = 8,
                 max_retries: int = 2, cell: int | None = None,
                 registry: dict[int, int] | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.pool = pool
        self.sdla = sdla
        self.cell = cell
        self.max_batch = max_batch
        self.max_retries = max_retries
        self.tasks: dict[int, TaskRuntime] = {}
        # drop accounting: `drops` is the monotone event count (what loops
        # should diff); `dropped` is a bounded log of recent drop EVENTS for
        # inspection — an id may reappear if resubmitted and dropped again
        self.drops = 0
        self.dropped: collections.deque[SliceRequest] = \
            collections.deque(maxlen=256)
        # SLA accounting: monotone event counts overall and per priority
        # tier (request.tier; the scorecard's per-class axis). `sheds` are
        # POLICY drops (TierPolicy pressure shedding) — a subset of `drops`.
        self.evictions = 0
        self.sheds = 0
        # `preemptions` are tier-policy force-evictions of RUNNING tasks
        # (MultiCellEngine's post-solve preemption pass) — a subset of
        # `evictions`, attributed to the EVICTED task's tier
        self.preemptions = 0
        self.offered_by_tier: collections.Counter = collections.Counter()
        self.admitted_by_tier: collections.Counter = collections.Counter()
        self.evictions_by_tier: collections.Counter = collections.Counter()
        self.drops_by_tier: collections.Counter = collections.Counter()
        self.sheds_by_tier: collections.Counter = collections.Counter()
        self.preemptions_by_tier: collections.Counter = collections.Counter()
        # ------------------------------------------------ SoA slot tables
        # numpy halves (slot index == solver row; see the module docstring)
        cap = 8
        self._cap = cap
        self._hi = 0                              # slot high-watermark
        self._rid = np.full(cap, -1, np.int64)
        self._state = np.zeros(cap, np.int8)
        self._tier = np.zeros(cap, np.int32)
        self._retries_left = np.zeros(cap, np.int32)
        self._pin = np.zeros(cap)                 # 0.0 = unpinned
        self._gen = np.zeros(cap, np.int64)
        self._deadline = np.zeros(cap)            # request.max_latency_s
        self._bits = np.zeros(cap)                # resolved stream Mbit/job
        self._dirty = np.zeros(cap, bool)
        self._sig_gen = np.full(cap, -1, np.int64)
        self._sig_pin = np.full(cap, -1.0)
        # object halves (slot-indexed)
        self._req: list[SliceRequest | None] = [None] * cap
        self._row: list[SliceRequest | None] = [None] * cap
        self._rt: list[TaskRuntime | None] = [None] * cap
        # maps / queues
        self._slot_of: dict[int, int] = {}        # rid → seated slot
        self._free_slots: list[int] = []          # min-heap of freed slots
        # arrivals not yet seated: rid → (req, retries, pin, runtime, gen)
        self._pending_in: dict[int, tuple] = {}
        self._queue: list[tuple[int, int]] = []   # FIFO of (rid, gen)
        self._registry = registry
        self._arrivals = 0
        self.frames = FrameStream()
        self._models: dict[str, tuple] = {}
        self.step = 0

    # ------------------------------------------------------- SoA plumbing
    def _grow(self, need: int):
        new = max(self._cap * 2, need)
        for name in ("_rid", "_state", "_tier", "_retries_left", "_pin",
                     "_gen", "_deadline", "_bits", "_dirty", "_sig_gen",
                     "_sig_pin"):
            old = getattr(self, name)
            arr = np.zeros(new, old.dtype)
            arr[:self._cap] = old
            if name == "_rid" or name == "_sig_gen":
                arr[self._cap:] = -1
            elif name == "_sig_pin":
                arr[self._cap:] = -1.0
            setattr(self, name, arr)
        pad = [None] * (new - self._cap)
        self._req += pad
        self._row += pad
        self._rt += pad
        self._cap = new

    def _free_slot(self, slot: int):
        """Detach a slot: cleared row, dirty, signatures reset so a future
        re-seating re-dirties it even across a consuming sync."""
        self._rid[slot] = -1
        self._state[slot] = _FREE
        self._pin[slot] = 0.0
        self._dirty[slot] = True
        self._sig_gen[slot] = -1
        self._sig_pin[slot] = -1.0
        self._req[slot] = None
        self._row[slot] = None
        self._rt[slot] = None
        heapq.heappush(self._free_slots, slot)

    def _enter(self, request: SliceRequest, retries: int, pin: float,
               runtime: TaskRuntime | None):
        """Shared admission-to-the-cell path of submit/hand_in: park the
        request as a pending (unseated) arrival; the next sync seats it."""
        rid = request.request_id
        if rid in self._slot_of or rid in self._pending_in:
            raise ValueError(
                f"request {rid} is already live in cell {self.cell} "
                "(running or queued); clone it with a fresh request_id to "
                "submit a second instance")
        self._arrivals += 1
        gen = self._arrivals
        self._pending_in[rid] = (request, retries, pin, runtime, gen)
        self._queue.append((rid, gen))
        if self._registry is not None:
            self._registry[rid] = self.cell
        return gen

    def _leave(self, rid: int):
        if self._registry is not None:
            self._registry.pop(rid, None)

    def queued_ids(self) -> list[int]:
        """The LIVE queue in FIFO order (stale lazy-deleted entries skipped
        by generation mismatch; see the module docstring)."""
        out = []
        pend = self._pending_in
        slot_of = self._slot_of
        for rid, gen in self._queue:
            p = pend.get(rid)
            if p is not None:
                if p[4] == gen:
                    out.append(rid)
                continue
            slot = slot_of.get(rid)
            if slot is not None and self._gen[slot] == gen \
                    and self._state[slot] == _QUEUED:
                out.append(rid)
        return out

    # ---------------------------------------------------------- accessors
    def is_live(self, rid: int) -> bool:
        """True while the request is a candidate here (running or queued)."""
        return rid in self._slot_of or rid in self._pending_in

    def live_ids(self) -> list[int]:
        """All live request ids: running first (task order), then queue."""
        return list(self.tasks) + self.queued_ids()

    def request_of(self, rid: int) -> SliceRequest:
        """The ORIGINAL (unpinned) request of a live id."""
        p = self._pending_in.get(rid)
        if p is not None:
            return p[0]
        return self._req[self._slot_of[rid]]

    def tier_of(self, rid: int) -> int:
        p = self._pending_in.get(rid)
        if p is not None:
            return p[0].tier
        return int(self._tier[self._slot_of[rid]])

    def pin_of(self, rid: int) -> float | None:
        """The handover warm-start accuracy bound, ``None`` if unpinned."""
        p = self._pending_in.get(rid)
        pin = p[2] if p is not None else float(self._pin[self._slot_of[rid]])
        return pin if pin > 0.0 else None

    def retries_left(self, rid: int) -> int:
        p = self._pending_in.get(rid)
        if p is not None:
            return p[1]
        return int(self._retries_left[self._slot_of[rid]])

    def carried(self, rid: int) -> TaskRuntime | None:
        """The live (running) or parked (carry) runtime of a request."""
        p = self._pending_in.get(rid)
        if p is not None:
            return p[3]
        return self._rt[self._slot_of[rid]]

    # ------------------------------------------------------------- control
    @property
    def pending(self) -> tuple[SliceRequest, ...]:
        """Read-only view of the retry/pending queue (a tuple on purpose:
        appending to it would silently go nowhere — use :meth:`submit`)."""
        return tuple(self.request_of(rid) for rid in self.queued_ids())

    @property
    def queue_depth(self) -> int:
        """Current retry/pending queue length (the shedding pressure signal)."""
        return len(self.queued_ids())

    def register_model(self, name: str, cfg, params, infer_fn):
        """infer_fn(params, inputs) → outputs; used for LM-service tasks.
        ``params`` lie on the engine's device."""
        self._models[name] = (cfg, params, infer_fn)

    def submit(self, request: SliceRequest):
        self._enter(request, self.max_retries, 0.0, None)

    def remove(self, request_id: int) -> TaskRuntime | None:
        """Withdraw a task (departure): no retry, no drop accounting."""
        p = self._pending_in.pop(request_id, None)
        if p is not None:
            self._leave(request_id)
            return p[3]
        slot = self._slot_of.pop(request_id, None)
        if slot is None:
            return None
        rt = self._rt[slot]
        if self._state[slot] == _RUNNING:
            self.tasks.pop(request_id, None)
        self._free_slot(slot)
        self._leave(request_id)
        return rt

    def gather(self) -> list[SliceRequest]:
        """The cell's current candidate set: running tasks first, then the
        pending/retry queue, with handover pins applied (idempotent)."""
        out = []
        for rid in self.live_ids():
            req = self.request_of(rid)
            pin = self.pin_of(rid)
            out.append(req if pin is None
                       else dataclasses.replace(req, min_accuracy=pin))
        return out

    def _seat_one(self, rid: int, entry: tuple) -> int:
        """Seat one pending arrival in the lowest free slot; returns it."""
        req, retries, pin, rt, gen = entry
        free = self._free_slots
        slot = heapq.heappop(free) if free else self._hi
        if slot == self._hi:
            self._hi += 1
            if self._hi > self._cap:
                self._grow(self._hi)
        self._rid[slot] = rid
        self._state[slot] = _QUEUED
        self._tier[slot] = req.tier
        self._retries_left[slot] = retries
        self._pin[slot] = pin
        self._gen[slot] = gen
        self._deadline[slot] = req.max_latency_s
        self._bits[slot] = self.sdla.bits_per_job(req)
        self._req[slot] = req
        self._row[slot] = req if pin == 0.0 \
            else dataclasses.replace(req, min_accuracy=pin)
        self._rt[slot] = rt
        self._slot_of[rid] = slot
        return slot

    def _seat_pending(self):
        """Seat every pending arrival in the lowest free slot, in arrival
        order (the old candidate-order walk seated unseated candidates —
        which are exactly the arrivals since the last sync — the same way)."""
        if not self._pending_in:
            return
        for rid, entry in self._pending_in.items():
            self._seat_one(rid, entry)
        self._pending_in.clear()

    def sync_slots(self, consume: bool = False
                   ) -> tuple[list[SliceRequest | None], list[int]]:
        """Seat pending arrivals and report which solver-row slots changed
        since the last CONSUMING sync — as a vectorized signature compare
        over the slot tables.

        The delta re-slice fast path keeps the stacked solver tables
        device-resident across ticks, so a task's row only needs host
        recompute + device scatter when the task itself changed. Slots are
        sticky: a request keeps its row for as long as it stays a candidate
        (running OR queued), a departure clears its row, and new candidates
        fill the lowest free slots in arrival order. A slot is dirty when
        it was cleared, newly assigned, its handover pin changed, or its id
        was reused by a NEW submission (the per-arrival generation in the
        signature — row-id reuse must never alias the predecessor's row).

        Returns ``(rows, dirty)``: ``rows`` is the per-slot request list
        (pins applied, ``None`` = cleared row), ``dirty`` the sorted indices
        of changed slots. Dirty slots ACCUMULATE across non-consuming syncs
        (``gather``-style introspection must not eat deltas the next
        re-slice still needs) and clear only when ``consume=True`` — the
        re-slice that actually delivers them to the solver session.
        """
        self._seat_pending()
        hi = self._hi
        occ = self._state[:hi] != _FREE
        changed = occ & ((self._gen[:hi] != self._sig_gen[:hi])
                         | (self._pin[:hi] != self._sig_pin[:hi]))
        if changed.any():
            np.copyto(self._sig_gen[:hi], self._gen[:hi], where=changed)
            np.copyto(self._sig_pin[:hi], self._pin[:hi], where=changed)
            self._dirty[:hi] |= changed
        dirty_now = np.flatnonzero(self._dirty[:hi]).tolist()
        if consume:
            self._dirty[:hi] = False
        return self._row[:hi], dirty_now

    def apply(self, decisions: list[SliceDecision]) -> list[SliceDecision]:
        """Apply one re-slice round's decisions (for this cell's gather set).

        Admitted tasks keep (or gain) a runtime; rejected requests are NOT
        discarded — they consume one retry and re-queue, dropping only once
        the budget is exhausted. A rejection of a task that was RUNNING in
        this cell right before the re-slice is an eviction and is flagged on
        the returned decision (exactly once — later rejections of the same
        task while it is merely queued are plain rejections). Requests
        submitted after the slot sync that produced ``decisions`` are
        untouched: they stay queued for the next round, and decisions for
        requests withdrawn (``remove()``) in the meantime are ignored.
        """
        prev = self.tasks
        decided = {d.request.request_id for d in decisions}
        # running tasks / queued requests the decisions do not cover (e.g.
        # submitted between sync and apply) are carried forward untouched;
        # this rebuild also purges the queue's lazy-deleted stale entries
        self.tasks = {rid: rt for rid, rt in prev.items()
                      if rid not in decided}
        requeued: list[tuple[int, int]] = []
        for rid in self.queued_ids():
            if rid not in decided:
                p = self._pending_in.get(rid)
                gen = p[4] if p is not None \
                    else int(self._gen[self._slot_of[rid]])
                requeued.append((rid, gen))
        self._queue = requeued
        for d in decisions:
            rid = d.request.request_id
            slot = self._slot_of.get(rid)
            if slot is None:
                p = self._pending_in.pop(rid, None)
                if p is None:
                    # departed (remove()d) between sync and apply: the
                    # decision is stale — do not resurrect or re-queue
                    continue
                # decided while still unseated (an apply without a prior
                # slot sync — the gather()-based solve paths): seat now
                slot = self._seat_one(rid, p)
            tier = int(self._tier[slot])
            self.offered_by_tier[tier] += 1
            if d.admitted:
                self.admitted_by_tier[tier] += 1
                rt = self._rt[slot] or TaskRuntime(d)
                rt.decision = d
                self.tasks[rid] = rt
                self._rt[slot] = rt
                self._state[slot] = _RUNNING
                continue
            if rid in prev:
                d.evicted = True
                self.evictions += 1
                self.evictions_by_tier[tier] += 1
            # no served stream to warm-start from: a rejected task re-offers
            # at its class threshold, not the pinned one
            if self._pin[slot] != 0.0:
                self._pin[slot] = 0.0
                self._row[slot] = self._req[slot]
            left = int(self._retries_left[slot]) - 1
            self._retries_left[slot] = left
            if left >= 0:
                self._state[slot] = _QUEUED
                self._queue.append((rid, int(self._gen[slot])))
                # the task stays in the system: its job/latency history
                # (kept in _rt as the parked carry) resumes on re-admission
            else:
                self.drops += 1
                self.drops_by_tier[tier] += 1
                self.dropped.append(self._req[slot])
                self._slot_of.pop(rid)
                self._free_slot(slot)
                self._leave(rid)
        return decisions

    def preempt(self, request_id: int) -> bool:
        """Force-evict a RUNNING task (the post-solve preemption pass).

        Tier policy lives OUTSIDE the solver (mirror of :meth:`shed`): when a
        higher-tier arrival is rejected for lack of capacity, the engine
        preempts a lower-tier running task and re-solves the freed rows —
        the solver itself stays SLA-blind. Bookkeeping is identical to a
        solver eviction surfaced by :meth:`apply` — one retry consumed, the
        warm-start pin cleared (an evicted task has no served stream), the
        task re-queued or dropped on an exhausted budget — plus separate
        ``preemptions``/``preemptions_by_tier`` attribution (the EVICTED
        task's tier). Returns ``True`` if the victim re-queued, ``False`` if
        it dropped. A re-queued victim keeps its slot (it is still a
        candidate); the caller excludes that row from its delta re-solve and
        re-dirties it so the next consuming sync rescatters the real row.
        """
        if request_id not in self.tasks:
            raise KeyError(
                f"request {request_id} is not running in cell {self.cell}")
        self.tasks.pop(request_id)
        slot = self._slot_of[request_id]
        tier = int(self._tier[slot])
        self.evictions += 1
        self.evictions_by_tier[tier] += 1
        self.preemptions += 1
        self.preemptions_by_tier[tier] += 1
        if self._pin[slot] != 0.0:
            self._pin[slot] = 0.0
            self._row[slot] = self._req[slot]
        left = int(self._retries_left[slot]) - 1
        self._retries_left[slot] = left
        if left >= 0:
            self._state[slot] = _QUEUED
            self._queue.append((request_id, int(self._gen[slot])))
            return True
        self.drops += 1
        self.drops_by_tier[tier] += 1
        self.dropped.append(self._req[slot])
        self._slot_of.pop(request_id)
        self._free_slot(slot)
        self._leave(request_id)
        return False

    def shed(self, request_id: int) -> SliceRequest:
        """Policy-drop a QUEUED request immediately (tier-based shedding).

        Graceful-degradation path: under pressure the engine sheds
        low-priority queued requests BEFORE the solve, so the solver never
        arbitrates between SLA classes it cannot see. Counted as a drop
        (``drops``/``dropped``, so loops that diff drops see it) and
        separately as a shed (``sheds``/``sheds_by_tier``) for attribution.
        Running tasks cannot be shed — evicting them is the solver's call.
        """
        p = self._pending_in.pop(request_id, None)
        if p is not None:
            req = p[0]
        else:
            slot = self._slot_of.get(request_id)
            if slot is None or self._state[slot] != _QUEUED:
                raise KeyError(
                    f"request {request_id} is not queued in cell {self.cell} "
                    "(running tasks are evicted by the solver, not shed)")
            req = self._req[slot]
            self._slot_of.pop(request_id)
            self._free_slot(slot)
        self._leave(request_id)
        self.drops += 1
        self.drops_by_tier[req.tier] += 1
        self.sheds += 1
        self.sheds_by_tier[req.tier] += 1
        self.dropped.append(req)
        return req

    def drain(self) -> list[tuple[SliceRequest, TaskRuntime | None, int,
                                  float | None]]:
        """Release the cell's ENTIRE candidate set for re-homing (outage).

        Returns ``(request, runtime, retries_left, pinned_accuracy)`` tuples
        in deterministic order — running tasks first (task order), then the
        queue FIFO — with the same carry semantics as :meth:`hand_out`:
        running tasks pin their achieved-``z`` accuracy bound and carry
        their runtime; queued requests keep whatever pin/runtime they
        already carried. No drop accounting here — the FAILED cell did not
        drop anything; what cannot be re-homed is dropped by the caller.
        Every vacated slot is reported dirty exactly once by the next
        :meth:`sync_slots`, so the device session sees the dead cell as
        cleared rows instead of a rebuild.
        """
        items: list[tuple[SliceRequest, TaskRuntime | None, int,
                          float | None]] = []
        for rid in list(self.tasks):
            req, rt, retries = self.hand_out(rid)
            items.append((req, rt, retries,
                          pinned_accuracy_at(req, rt.decision.z,
                                             model=self.sdla.semantics)))
        for rid in self.queued_ids():
            p = self._pending_in.pop(rid, None)
            if p is not None:
                req, retries, pin, rt, _ = p
            else:
                slot = self._slot_of.pop(rid)
                req = self._req[slot]
                retries = int(self._retries_left[slot])
                pin = float(self._pin[slot])
                rt = self._rt[slot]
                self._free_slot(slot)
            self._leave(rid)
            items.append((req, rt, retries, pin if pin > 0.0 else None))
        self._queue.clear()
        return items

    # ------------------------------------------------------ handover hooks
    def hand_out(self, request_id: int) -> tuple[SliceRequest, TaskRuntime,
                                                 int]:
        """Release a RUNNING task for handover: (request, runtime, retries)."""
        if request_id not in self.tasks:
            raise KeyError(
                f"request {request_id} is not running in cell {self.cell}")
        rt = self.tasks.pop(request_id)
        slot = self._slot_of.pop(request_id)
        req = self._req[slot]
        retries = int(self._retries_left[slot])
        self._free_slot(slot)
        self._leave(request_id)
        return req, rt, retries

    def hand_in(self, request: SliceRequest, runtime: TaskRuntime | None,
                retries: int, pinned_accuracy: float | None):
        """Accept a handed-over (or outage-drained) task: queue it with its
        warm-start pin; the runtime (job/latency history) resumes if the next
        re-slice admits. ``runtime``/``pinned_accuracy`` are ``None`` for a
        request that was merely QUEUED in the source cell (a drained retry
        has no encoded stream or job history to carry)."""
        try:
            self._enter(request, retries,
                        0.0 if pinned_accuracy is None else pinned_accuracy,
                        runtime)
        except ValueError:
            raise ValueError(
                f"request {request.request_id} is already live in cell "
                f"{self.cell}; cannot hand in a duplicate") from None

    # --------------------------------------------------------------- data
    def _run_vision_job(self, rt: TaskRuntime, batch: int):
        """Frame ingest path: upload, compress by z (resize kernel), then
        'infer'. Reading the result back waits for the kernel, as the
        reference's ``np.asarray`` does, so the measured compute time
        covers it."""
        frames = torch.from_numpy(self.frames.frames(self.step, batch))
        z = max(rt.decision.z, 0.02)
        compressed = resize_ops.compress_frames(frames.to(self.device), z,
                                                use_kernel=True)
        return compressed.cpu().numpy()

    def _run_lm_job(self, rt: TaskRuntime, batch: int):
        """LM-service path: the reference's token draw for this step, on the
        engine's device, through the registered infer function. The logits
        are read back (as float32 numpy), so the measured compute time
        covers the prefill — the reference returns an un-awaited array."""
        cfg, params, infer_fn = self._models[rt.decision.request.model]
        rng = np.random.default_rng(self.step)
        toks = rng.integers(0, cfg.vocab_size, size=(batch, 16), dtype=np.int32)
        out = infer_fn(params, {"tokens": torch.from_numpy(toks).to(
            self.device)})
        return out.float().cpu().numpy()

    def process(self, wall_dt: float = 1.0):
        """One engine tick: run the admitted tasks' arrived jobs."""
        self.step += 1
        for rt in self.tasks.values():
            req = rt.decision.request
            n_jobs = max(1, int(round(req.jobs_per_sec * req.n_ues * wall_dt)))
            done = 0
            while done < n_jobs:
                b = min(self.max_batch, n_jobs - done)
                t0 = time.time()
                if req.model in self._models:
                    self._run_lm_job(rt, b)
                else:
                    self._run_vision_job(rt, b)
                compute_s = (time.time() - t0) / b
                # end-to-end accounting: modeled network + sched latency with
                # the sliced radio share, plus the measured compute time. The
                # stream size resolves through the SAME SDLA resolver used at
                # admission time (an explicit bits_per_job=0.0 stays 0.0).
                alloc = np.array([rt.decision.alloc[n]
                                  for n in self.pool.names])
                modeled = latency_model(
                    self.sdla.lat_params, self.sdla.bits_per_job(req),
                    req.jobs_per_sec * req.n_ues, 0.0,  # compute term measured
                    rt.decision.z, alloc)
                rt.latencies.append(float(modeled) + compute_s)
                rt.jobs_done += b
                done += b

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        out = {}
        for rid, rt in self.tasks.items():
            rec = {
                "app": rt.decision.request.app_class,
                "z": rt.decision.z,
                "alloc": rt.decision.alloc,
                "jobs_done": rt.jobs_done,
                "deadline_s": rt.decision.request.max_latency_s,
            }
            if rt.latencies:
                lat = np.array(rt.latencies)
                rec.update(
                    p50_latency_s=float(np.median(lat)),
                    p99_latency_s=float(np.quantile(lat, 0.99)),
                    meets_deadline=bool(
                        np.median(lat)
                        <= rt.decision.request.max_latency_s),
                    no_data=False,
                )
            else:
                # an idle/starved task has no latency evidence: report that,
                # never a vacuous 0.0-latency "meets deadline"
                rec.update(p50_latency_s=None, p99_latency_s=None,
                           meets_deadline=False, no_data=True)
            out[rid] = rec
        return out


class EdgeServingEngine:
    """DEPRECATED shim: a thin 1-cell view over
    :class:`repro_torch.serving.multicell.MultiCellEngine`.

    Kept so single-cell callers continue to work, but there is ONE code
    path now: process/metrics/retry live in the shared :class:`CellRuntime`
    and ``reslice()`` routes through the multi-cell engine's device-resident
    fast path. New code should construct ``MultiCellEngine([pool])`` (or use
    the event-stream ``ingest`` API) directly.
    """

    def __init__(self, pool: ResourcePool, *, lat_params=None,
                 max_batch: int = 8, max_retries: int = 2,
                 solver_backend: str = "numpy", device="cuda"):
        from .multicell import MultiCellEngine   # avoid an import cycle
        self.pool = pool
        self._multi = MultiCellEngine(
            [pool], lat_params=lat_params, max_batch=max_batch,
            max_retries=max_retries, solver_backend=solver_backend,
            device=device)

    # thin delegation — the multi-cell engine owns all serving state
    @property
    def sdla(self) -> SDLA:
        return self._multi.sdla

    @property
    def sesm(self):
        return self._multi.sesm

    @property
    def runtime(self) -> CellRuntime:
        return self._multi.cells[0]

    @property
    def tasks(self) -> dict[int, TaskRuntime]:
        return self.runtime.tasks

    @property
    def pending(self) -> tuple[SliceRequest, ...]:
        return self.runtime.pending

    @property
    def dropped(self) -> tuple[SliceRequest, ...]:
        """Recent drop events (bounded log; diff ``runtime.drops`` counts)."""
        return tuple(self.runtime.dropped)

    def register_model(self, name: str, cfg, params, infer_fn):
        self.runtime.register_model(name, cfg, params, infer_fn)

    def submit(self, request: SliceRequest):
        self._multi.submit(request, 0)

    def reslice(self) -> list[SliceDecision]:
        """Run SESM over pending + running requests (full re-slice: running
        tasks may be evicted — paper Section III-C; rejected requests stay on
        the bounded retry queue instead of being discarded)."""
        return self._multi.reslice()[0]

    def process(self, wall_dt: float = 1.0):
        self._multi.process(wall_dt)

    def metrics(self) -> dict:
        return self.runtime.metrics()


def pinned_accuracy_at(request: SliceRequest, z: float,
                       model: semantics.SemanticModel | None = None) -> float:
    """The warm-start accuracy bound of a stream already encoded at ``z`` —
    Eq. (2) then re-derives (at most) that compression in the target cell.
    (Request-level wrapper over the single-source pin in core.semantics.)

    ``model`` selects whose curves price the pin — the engine passes its
    SDLA's live (possibly drifted) model, so a pin records the accuracy the
    stream achieves UNDER THE CURVES IT WAS ENCODED UNDER; once recorded it
    is a value, unaffected by later drift."""
    return semantics.resolve(model).warm_start_accuracy(
        semantics.APP_INDEX[request.app_class], z)
