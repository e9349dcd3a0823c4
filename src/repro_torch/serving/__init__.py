"""Port of ``src/repro/serving``: the serving plane's public surface (one
ingestion API, one event union, one closed-loop driver, one scorecard)."""

from ..core.events import (Arrival, CellFault, Departure, Event, Handover,
                           LinkScale, SemanticShift, Tick)

from .request import SliceRequest
from .sdla import SDLA
from .admission import SESM, PendingSolve, SliceDecision
from .engine import (CellRuntime, EdgeServingEngine, TaskRuntime,
                     pinned_accuracy_at)
from .multicell import MultiCellEngine, TierPolicy
from .driver import drive_closed_loop, sla_scorecard

__all__ = [
    "Arrival", "CellFault", "Departure", "Event", "Handover", "LinkScale",
    "SemanticShift", "Tick",
    "SliceRequest", "SDLA", "SESM", "PendingSolve", "SliceDecision",
    "CellRuntime", "EdgeServingEngine", "TaskRuntime", "pinned_accuracy_at",
    "MultiCellEngine", "TierPolicy",
    "drive_closed_loop", "sla_scorecard",
]
