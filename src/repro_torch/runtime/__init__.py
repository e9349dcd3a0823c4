"""Port of ``src/repro/runtime``: heartbeats and straggler detection."""

from .fault_tolerance import HeartbeatMonitor, StragglerMitigator

__all__ = ["HeartbeatMonitor", "StragglerMitigator"]
