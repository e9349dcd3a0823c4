"""Port of ``src/repro/serving/request.py`` (the port's own numpy copy),
held against it value for value by ``tests/test_torch_core.py``.

O-RAN Slice Requests (paper Section III-B).

An OSR = Task Description (TD) + Task Requirements (TR):
  TD: DL service, DL model, target object classes
  TR: max latency, min accuracy, number of UEs, jobs/s per UE
"""

from __future__ import annotations

import dataclasses
import itertools

__all__ = ["SliceRequest"]

_ids = itertools.count()


@dataclasses.dataclass(slots=True)
class SliceRequest:
    # --- Task Description ---
    service: str                  # e.g. "object-recognition", "lm-serving"
    model: str                    # DL model name (arch id or CV model)
    app_class: str                # semantic application (core.semantics name)
    # --- Task Requirements ---
    max_latency_s: float
    min_accuracy: float
    n_ues: int = 1
    jobs_per_sec: float = 5.0
    # --- SLA class (serving fault plane) ---
    # priority tier for graceful degradation: 0 = highest priority; larger
    # tiers are shed first under pressure (see serving.multicell.TierPolicy).
    # Solver semantics are tier-blind — tiers act at the queue, not in SF-ESP.
    tier: int = 0
    # --- stream characteristics (filled by the SDLA if left None) ---
    bits_per_job: float | None = None      # Mbit
    gpu_time_per_job: float | None = None  # s on one reference accelerator
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
