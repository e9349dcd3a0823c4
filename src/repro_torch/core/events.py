"""Port of ``src/repro/core/events.py`` (the port's own numpy copy),
held against it value for value by ``tests/test_torch_core.py``.

Typed serving-plane events — the unified ingestion API's vocabulary.

The serving data plane consumes ONE kind of input: a stream of these events,
fed to ``repro_torch.serving.multicell.MultiCellEngine.ingest`` between re-slice
ticks. Traffic generators (``repro_torch.core.scenarios``), fault schedules and
live drivers (``repro_torch.serving.driver.drive_closed_loop``) all speak this
union instead of calling engine methods positionally, so a metro-scale trace
is just an iterable of events and the engine's legacy ``submit``/``remove``
methods are one-event wrappers.

The types live in ``repro_torch.core`` (not ``repro_torch.serving``) on purpose: the
scenario library emits them and must not import the serving stack. They are
plain frozen dataclasses with ``slots`` — an event is immutable wire data,
and the high-throughput ingest path allocates hundreds of thousands of them
per second.

Payload conventions:

* :class:`Arrival` carries either a fully-formed
  ``repro_torch.serving.request.SliceRequest`` (what ``ingest`` accepts) or — when
  emitted by a scenario generator that cannot build requests — the raw
  traffic-event dict of ``repro_torch.core.scenarios.closed_loop_arrivals``; the
  driver resolves dict payloads (tier draw + departure schedule) before
  feeding the engine.
* :class:`CellFault` covers both directions: ``failed=True`` fails (and
  drains) the cell, ``failed=False`` recovers it.
* :class:`LinkScale` degrades the shared links: exactly one of ``scale``
  (factor on the NOMINAL budgets) or ``budgets`` (explicit (L,) array).
* :class:`SemanticShift` recalibrates accuracy curves: exactly one of
  ``scale`` (factor on the NOMINAL asymptotes of ``app_idx``) or ``params``
  (explicit (K, 3) ``[M, γ, H]`` rows). The engine turns it into an in-place
  ``SemanticModel`` bump + dirty-row delta scatters — never a rebuild.
* :class:`Tick` advances the data plane (``process(wall_dt)``): job
  execution, heartbeats, straggler EWMAs.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Arrival", "CellFault", "Departure", "Event", "Handover",
           "LinkScale", "SemanticShift", "Tick"]


@dataclasses.dataclass(frozen=True, slots=True)
class Arrival:
    """A new request enters the system, aimed at ``cell``.

    ``fallback=True`` (the stream default) re-homes an arrival aimed at a
    failed cell to its ``fallback_cell`` — or counts it lost when no cell is
    live; ``fallback=False`` (the strict ``submit`` wrapper) raises instead.
    """

    request: object            # SliceRequest, or a scenarios traffic dict
    cell: int
    fallback: bool = True


@dataclasses.dataclass(frozen=True, slots=True)
class Departure:
    """A request leaves the system (no retry/drop accounting).

    ``cell=None`` locates the request first — drains and auto-failovers move
    requests without their submitter's knowledge. A departure for an id that
    already left is counted, not an error (events are asynchronous)."""

    request_id: int
    cell: int | None = None


@dataclasses.dataclass(frozen=True, slots=True)
class Handover:
    """Move a RUNNING task ``src`` → ``dst`` (achieved-z accuracy pinned).

    Through ``ingest`` an infeasible handover (task gone, cell dead, task
    not running) is SKIPPED and counted — the event raced a drain or
    departure; the legacy :meth:`MultiCellEngine.handover` method raises."""

    request_id: int
    src: int
    dst: int


@dataclasses.dataclass(frozen=True, slots=True)
class CellFault:
    """Fail (``failed=True``, drains the cell) or recover a cell."""

    cell: int
    failed: bool = True
    reason: str = "operator"


@dataclasses.dataclass(frozen=True, slots=True)
class LinkScale:
    """Degrade/restore shared-link budgets in place (session survives)."""

    scale: float | None = None
    budgets: object = None     # explicit (L,) budgets array


@dataclasses.dataclass(frozen=True, slots=True)
class SemanticShift:
    """Semantic drift: the accuracy curves of ``app_idx`` move.

    ``app_idx=None`` shifts every registered app. Exactly one of ``scale``
    (sets the asymptotes to ``scale ×`` their NOMINAL calibration — absolute
    level, so composed/stepped schedules don't compound; ``scale=1``
    restores) or ``params`` (explicit ``(len(app_idx), 3)`` ``[M, γ, H]``
    rows — a full recalibration that re-anchors the nominal too). Already-
    pinned handover accuracies are values, not curve lookups: they stay at
    their recorded level when the curves move under them."""

    app_idx: tuple[int, ...] | None = None
    scale: float | None = None
    params: object = None      # explicit (K, 3) [M, γ, H] rows


@dataclasses.dataclass(frozen=True, slots=True)
class Tick:
    """Advance the data plane by ``wall_dt`` seconds (run jobs, heartbeat)."""

    wall_dt: float = 1.0


Event = Arrival | Departure | Handover | CellFault | LinkScale \
    | SemanticShift | Tick
