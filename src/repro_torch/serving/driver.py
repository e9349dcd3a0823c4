"""Port of ``src/repro/serving/driver.py``: drive a MultiCellEngine from the
scenario library.

``core.scenarios.closed_loop_trace`` evaluates the closed loop OFFLINE (build
instances, solve, feed decisions back). This module runs the same traffic
model through the live serving engine instead — as a thin EVENT-STREAM
generator over :meth:`MultiCellEngine.ingest`: arrivals become typed
:class:`~repro_torch.core.events.Arrival` events carrying a :class:`SliceRequest`,
departures :class:`~repro_torch.core.events.Departure` events, mobility
:class:`~repro_torch.core.events.Handover` events, the data-plane tick a
:class:`~repro_torch.core.events.Tick` — and every step is one joint coupled
re-slice. The driver's only jobs are realizing the traffic model (RNG draws,
departure schedules) and bookkeeping the per-step records; every engine
mutation flows through the one ingestion API.

The fault plane plugs in here too: a ``faults=`` schedule (built by the
``repro_torch.core.scenarios`` fault generators — cell outage windows, stepped
link degradation, flash-crowd overlays) is a ``{step: [event, ...]}`` map of
the SAME typed events, ingested at the top of each step; arrivals aimed at a
failed cell re-home to the engine's fallback cell, and :func:`sla_scorecard`
reduces a run to the per-tier SLA report operators actually track (admission
rate, deadline-hit rate, eviction/drop/shed counts, degraded-tick totals).
"""

from __future__ import annotations

import itertools

import numpy as np

from ..core import scenarios
from ..core.events import Arrival, Departure, Handover, Tick
from .multicell import MultiCellEngine
from .request import SliceRequest

__all__ = ["drive_closed_loop", "sla_scorecard"]

_SERVICE_LABEL = {"detection": "object-recognition",
                  "segmentation": "segmentation", "lm": "lm-serving"}


def _request_of(ev: dict, tier: int) -> SliceRequest:
    """Resolve a scenarios traffic-event dict into a submittable request."""
    return SliceRequest(
        service=_SERVICE_LABEL.get(ev["service"], ev["service"]),
        model="yolox" if ev["service"] == "detection" else "bisenetv2",
        app_class=ev["app_class"],
        max_latency_s=ev["max_latency_s"],
        min_accuracy=ev["min_accuracy"],
        jobs_per_sec=ev["jobs_per_sec"],
        tier=tier)


def drive_closed_loop(engine: MultiCellEngine, horizon: int, *,
                      arrival_rate: float = 4.0, mean_holding: float = 5.0,
                      handover_prob: float = 0.0, acc: str = "med",
                      lat: str = "high", seed: int = 0,
                      process: bool = False,
                      wall_dt: float = 1.0,
                      faults: dict[int, list] | None = None,
                      tiers=None) -> list[dict]:
    """Run ``horizon`` closed-loop steps of Poisson traffic through ``engine``.

    Per step, the driver generates one event batch per phase and feeds it to
    :meth:`MultiCellEngine.ingest`: (i) this step's fault events (see below),
    (ii) :class:`Departure` events for tasks whose holding time expired —
    with ``cell=None``, since drains move tasks between cells without the
    driver's knowledge, (iii) a :class:`Handover` to a random other LIVE
    cell for each admitted task with probability ``handover_prob``
    (achieved-z accuracy pin — see :meth:`MultiCellEngine.handover`), (iv)
    :class:`Arrival` events for fresh
    :func:`repro_torch.core.scenarios.closed_loop_arrivals` traffic — arrivals
    aimed at a failed cell re-home to its fallback cell, or count as
    ``lost`` when no cell is live, (v) the engine re-slices jointly, and
    optionally (vi) a :class:`Tick` runs the admitted jobs for ``wall_dt``
    seconds of wall time.

    ``faults`` is a ``{step: [event, ...]}`` schedule of typed
    ``repro_torch.core.events`` events (the ``repro_torch.core.scenarios`` fault
    generators): :class:`CellFault` toggles cell outages — drain moves
    re-point the driver's departure schedules — :class:`LinkScale` degrades
    the shared links in place, and :class:`Arrival` events with raw traffic
    dicts overlay extra traffic (flash crowds; the driver resolves them into
    requests with tier draws and departure schedules like base traffic).

    ``tiers`` assigns each submitted request a priority tier drawn uniformly
    from the given sequence (dedicated RNG at ``seed + 23``, so the base
    traffic realization is unchanged vs. ``tiers=None``, which keeps every
    request at tier 0).

    Returns one record per (step, cell): ``{"step", "cell", "offered",
    "admitted", "evicted", "retrying", "dropped", "shed", "handovers",
    "lost", "dead", "degraded", "restacked"}`` — ``restacked`` flags steps
    whose re-slice allocated fresh stacking buffers (the first step, or a
    bucket overflow; a healthy loop shows it only on step 0), ``shed``
    counts TierPolicy pressure drops (a subset of ``dropped``), ``lost``
    arrivals that found no live cell, and ``dead``/``degraded`` snapshot the
    fault-plane state after the step's events.
    """
    events = scenarios.closed_loop_arrivals(
        engine.num_cells, horizon, arrival_rate=arrival_rate,
        mean_holding=mean_holding, acc=acc, lat=lat, seed=seed)
    rng = np.random.default_rng(seed + 17)
    tier_rng = np.random.default_rng(seed + 23)
    tier_choices = None if tiers is None else list(tiers)

    def draw_tier() -> int:
        if tier_choices is None:
            return 0
        return int(tier_choices[tier_rng.integers(len(tier_choices))])

    faults = faults or {}
    depart: dict[int, tuple[float, int]] = {}   # rid → (depart step, cell)
    records = []
    for step in range(horizon):
        # (i) fault events; flash-crowd Arrival overlays (raw traffic dicts)
        # are deferred to the arrivals phase, after the base traffic
        overlay = [f for f in faults.get(step, ()) if type(f) is Arrival]
        summary = engine.ingest(
            f for f in faults.get(step, ()) if type(f) is not Arrival)
        for rid, dst in summary["moves"].items():
            if rid in depart:
                if dst is None:
                    del depart[rid]
                else:
                    depart[rid] = (depart[rid][0], dst)
        # (ii) departures — located by the engine (cell=None), since
        # heartbeat auto-failovers drain without telling the driver
        due = [rid for rid, (d, _) in depart.items() if d <= step]
        engine.ingest(Departure(rid) for rid in due)
        for rid in due:
            del depart[rid]
        # (iii) mobility
        handed_in = [0] * engine.num_cells
        if handover_prob > 0.0 and engine.num_cells > 1:
            moves = []
            for c, cell in enumerate(engine.cells):
                for rid in list(cell.tasks):
                    if rng.random() < handover_prob:
                        target = int(rng.integers(0, engine.num_cells - 1))
                        target += target >= c
                        if target in engine.dead:
                            continue       # no live neighbor drawn: stay put
                        moves.append(Handover(rid, c, target))
                        # tasks submitted outside the driver have no departure
                        # schedule — they just move cells
                        if rid in depart:
                            depart[rid] = (depart[rid][0], target)
                        handed_in[target] += 1
            engine.ingest(moves)
        # (iv) arrivals: base traffic first, then flash-crowd overlays, one
        # resolved Arrival event each (engine-side fallback re-homing)
        offered = [(c, ev) for c, evs in enumerate(events[step])
                   for ev in evs]
        offered += [(a.cell, a.request) for a in overlay]
        batch = [(c, ev, _request_of(ev, draw_tier())) for c, ev in offered]
        engine.ingest(Arrival(req, c) for c, ev, req in batch)
        lost = [0] * engine.num_cells
        for c, ev, req in batch:
            where = engine.locate(req.request_id)
            if where is None:
                lost[c] += 1               # no live cell to re-home to
            else:
                depart[req.request_id] = (ev["depart"], where)
        # (v) one joint re-slice
        fresh_before = engine.sesm.fresh_stacks
        drops_before = [cell.drops for cell in engine.cells]
        sheds_before = [cell.sheds for cell in engine.cells]
        decisions = engine.reslice()
        restacked = engine.sesm.fresh_stacks > fresh_before
        for c, (cell, ds) in enumerate(zip(engine.cells, decisions)):
            n_dropped = cell.drops - drops_before[c]
            # this step's drop events sit at the tail of the bounded log;
            # forget their departure schedules (remove() is tolerant, so a
            # log overflow here is harmless)
            for req in itertools.islice(reversed(cell.dropped), n_dropped):
                depart.pop(req.request_id, None)
            # solve_batch emits exactly one decision per gathered request,
            # so the offered count is free — no second gather needed
            records.append(dict(
                step=step, cell=c, offered=len(ds),
                admitted=sum(d.admitted for d in ds),
                evicted=sum(d.evicted for d in ds),
                retrying=len(cell.pending),
                dropped=n_dropped,
                shed=cell.sheds - sheds_before[c],
                handovers=handed_in[c], lost=lost[c],
                dead=c in engine.dead, degraded=engine.degraded,
                restacked=restacked))
        # (vi) the data-plane tick
        if process:
            engine.ingest([Tick(wall_dt)])
    return records


def sla_scorecard(engine: MultiCellEngine,
                  records: list[dict] | None = None) -> dict:
    """Reduce a scenario run to the per-class SLA report operators track.

    Returns ``{"tiers": {tier: {...}}, "run": {...}}``. Per tier:
    ``offered``/``admitted`` (per-re-slice decision counts) and the derived
    ``admission_rate``, ``evictions``/``drops``/``sheds``/``preemptions``
    (tier-policy force-evictions suffered, victim side) /
    ``preempt_rescued`` (rejections overturned by the preemption re-solve,
    beneficiary side) / ``drain_drops`` event counts, and — over the live
    tasks' measured end-to-end latency samples — ``deadline_hit_rate``,
    ``p95_latency_s`` and ``latency_samples`` (``None``/0 when nothing ran,
    never a vacuous 100 %). The ``run`` section aggregates the fault plane:
    degraded ticks, dead cells, drain/recovery counts, retry depth, and the
    session-cache health counters (``link_updates``, ``semantic_updates``,
    ``session_rebuilds``). With the driver's ``records``, ``steps`` and
    ``degraded_steps`` are included too.
    """
    totals = engine.metrics()["totals"]
    lat_by_tier: dict[int, list[tuple[float, float]]] = {}
    for cell in engine.cells:
        for rt in cell.tasks.values():
            t = rt.decision.request.tier
            dl = rt.decision.request.max_latency_s
            lat_by_tier.setdefault(t, []).extend(
                (float(s), dl) for s in rt.latencies)
    tier_ids = set(lat_by_tier)
    for key in ("offered_by_tier", "admitted_by_tier", "evictions_by_tier",
                "drops_by_tier", "sheds_by_tier", "preemptions_by_tier",
                "preempt_rescued_by_tier", "drain_drops_by_tier"):
        tier_ids |= set(totals[key])
    tiers = {}
    for t in sorted(tier_ids):
        offered = totals["offered_by_tier"].get(t, 0)
        admitted = totals["admitted_by_tier"].get(t, 0)
        samples = lat_by_tier.get(t, [])
        tiers[t] = dict(
            offered=offered, admitted=admitted,
            admission_rate=admitted / offered if offered else None,
            evictions=totals["evictions_by_tier"].get(t, 0),
            drops=totals["drops_by_tier"].get(t, 0),
            sheds=totals["sheds_by_tier"].get(t, 0),
            preemptions=totals["preemptions_by_tier"].get(t, 0),
            preempt_rescued=totals["preempt_rescued_by_tier"].get(t, 0),
            drain_drops=totals["drain_drops_by_tier"].get(t, 0),
            deadline_hit_rate=float(np.mean([s <= dl for s, dl in samples]))
            if samples else None,
            p95_latency_s=float(np.quantile([s for s, _ in samples], 0.95))
            if samples else None,
            latency_samples=len(samples),
        )
    run = dict(
        degraded=totals["degraded"],
        degraded_ticks=totals["degraded_ticks"],
        dead_cells=totals["dead_cells"],
        drained=totals["drained"], drain_drops=totals["drain_drops"],
        recoveries=totals["recoveries"], handovers=totals["handovers"],
        evictions=totals["evictions"], drops=totals["drops"],
        sheds=totals["sheds"], preemptions=totals["preemptions"],
        preempt_rescued=totals["preempt_rescued"],
        retry_depth=totals["retry_depth"],
        running=totals["running"],
        link_updates=totals["link_updates"],
        semantic_updates=totals["semantic_updates"],
        session_rebuilds=totals["session_rebuilds"],
    )
    if records:
        run["steps"] = max(r["step"] for r in records) + 1
        run["degraded_steps"] = len(
            {r["step"] for r in records if r.get("degraded")})
        run["lost_arrivals"] = sum(r.get("lost", 0) for r in records)
    return {"tiers": tiers, "run": run}
