"""Port of ``src/repro/runtime``: heartbeats, straggler detection, elastic
re-meshing and the step clock."""

from .fault_tolerance import (ElasticMesh, HeartbeatMonitor, StepClock,
                              StragglerMitigator)

__all__ = ["ElasticMesh", "HeartbeatMonitor", "StepClock",
           "StragglerMitigator"]
