"""Port of ``src/repro/serving/sdla.py`` (the port's own numpy copy),
held against it value for value by ``tests/test_torch_core.py``.

Semantic Deep Learning Analyzer (SDLA) — the Non-real-time RIC rApp.

Builds the accuracy function a_τ(z) and latency function l_τ(z, s) for each
Task Description (paper Section III-B, Steps 1-2): accuracy from the semantic
application registry (representative-dataset curves), latency from the
calibrated Colosseum regression. Functions are cached per TD and refreshed
with radio/edge status updates (Step 7) via the ``latency_scale`` knob.

The accuracy side is a first-class, *mutable*
:class:`~repro_torch.core.semantics.SemanticModel` owned by the SDLA (a fresh
paper-calibration copy by default): :meth:`recalibrate` is the rApp's
semantic-drift entry — curves move in place, the model version bumps, and
every consumer keyed on the model signature refreshes only its dirty rows.
"""

from __future__ import annotations

import numpy as np

from ..core import semantics
from ..core.latency import LatencyParams
from ..core.sfesp import build_instance
from ..core.types import ResourcePool, TaskSet
from .request import SliceRequest

__all__ = ["SDLA"]

# single source in core.semantics, shared with the scenario library
_DEFAULT_BITS = semantics.SERVICE_BITS_PER_JOB
_DEFAULT_GPU_TIME = semantics.SERVICE_GPU_TIME


class SDLA:
    def __init__(self, lat_params: LatencyParams | None = None,
                 model: semantics.SemanticModel | None = None):
        self.lat_params = lat_params or LatencyParams()
        self.latency_scale = 1.0            # refined from radio status (Step 7)
        # a PRIVATE mutable copy of the paper calibration (bit-identical
        # values), so recalibrating this SDLA never moves global state
        self.semantics = model if model is not None \
            else semantics.SemanticModel.paper_default()

    def update_radio_status(self, scale: float):
        """Step 7: refine the latency function from observed channel state."""
        self.latency_scale = scale

    def recalibrate(self, app_idx=None, *, params=None, scale=None):
        """Semantic drift entry: move the accuracy curves of ``app_idx``.

        Exactly one of ``params`` (explicit (K, 3) ``[M, γ, H]`` rows — a
        full recalibration, re-anchoring the nominal) or ``scale`` (set the
        asymptotes to ``scale ×`` nominal — the transient-drift convention of
        :class:`~repro_torch.core.events.SemanticShift`). Bumps the model version;
        returns the new signature.
        """
        if (params is None) == (scale is None):
            raise ValueError("recalibrate needs exactly one of params=/scale=")
        if params is not None:
            if app_idx is None:
                app_idx = np.arange(self.semantics.n_apps)
            return self.semantics.update(app_idx, params)
        return self.semantics.scale_asymptotes(app_idx, scale)

    def bits_per_job(self, request: SliceRequest) -> float:
        """Resolve the per-job stream size (Mbit) of a request.

        Single resolver shared by admission (:meth:`task_set`) and the serving
        data plane — an explicit ``bits_per_job`` (including ``0.0``) is
        honored verbatim; only ``None`` falls back to the service-aware
        default, so the latency a task is served under is the latency it was
        admitted under.
        """
        if request.bits_per_job is not None:
            return float(request.bits_per_job)
        service = semantics.APPS[semantics.APP_INDEX[request.app_class]].service
        return float(_DEFAULT_BITS.get(service, 0.8))

    def gpu_time_per_job(self, request: SliceRequest) -> float:
        """Resolve per-job reference-accelerator seconds (same contract as
        :meth:`bits_per_job`: explicit values win, ``None`` → service default)."""
        if request.gpu_time_per_job is not None:
            return float(request.gpu_time_per_job)
        service = semantics.APPS[semantics.APP_INDEX[request.app_class]].service
        return float(_DEFAULT_GPU_TIME.get(service, 0.06))

    def task_set(self, requests: list[SliceRequest]) -> TaskSet:
        apps, accs, lats, bits, rates, gpu_t, ues = [], [], [], [], [], [], []
        for r in requests:
            app_idx = semantics.APP_INDEX[r.app_class]
            apps.append(app_idx)
            accs.append(r.min_accuracy)
            lats.append(r.max_latency_s)
            bits.append(self.bits_per_job(r))
            rates.append(r.jobs_per_sec * r.n_ues)
            gpu_t.append(self.gpu_time_per_job(r))
            ues.append(r.n_ues)
        # explicit dtypes so an EMPTY request list still builds a well-typed
        # (0,)-task instance (zero-task cells ride multi-cell batches)
        return TaskSet(
            app_idx=np.array(apps, np.int64),
            min_accuracy=np.array(accs, np.float64),
            max_latency=np.array(lats, np.float64) / self.latency_scale,
            bits_per_job=np.array(bits, np.float64),
            jobs_per_sec=np.array(rates, np.float64),
            gpu_time_per_job=np.array(gpu_t, np.float64),
            n_ues=np.array(ues, np.int64),
        )

    def build_instance(self, requests: list[SliceRequest], pool: ResourcePool):
        return build_instance(pool, self.task_set(requests),
                              lat_params=self.lat_params,
                              model=self.semantics)
