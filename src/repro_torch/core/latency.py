"""Port of ``src/repro/core/latency.py`` (the port's own numpy copy),
held against it value for value by ``tests/test_torch_core.py``.

End-to-end latency model l_τ(z, s) — calibrated to paper Fig. 2-right.

The paper builds the latency function empirically on Colosseum and treats it as
problem input (Section IV-A: "we consider a data-driven approach where the
accuracy and latency functions can be constructed through a regression model").
We provide the closed-form family the SDLA would regress to, with queueing-aware
radio and compute terms, calibrated so the paper's reported operating points
hold:

  * Fig. 2-right (10 jobs/s, z = 1): both (6 RBG, 3 GPU) and (10 RBG, 2 GPU)
    give ≈ 0.40 s end-to-end latency — the "flexibility" anchor of Section II.
  * Lower fps → higher latency (Section V-C: LTE uplink scheduling-request
    overhead dominates at low utilization) via the T_sched term.

Model (per task τ, allocation s, compression z):

  l = T_up + T_sched + T_proc [+ T_pre + RAM gate] + T_fixed

  T_up    = (B·z / R(s_rbg)) / (1 - ρ_r)+      ρ_r = λ·B·z / R(s_rbg)
  T_sched = SCHED_MAX / (1 + fps/F0)           (grant latency, fps-dependent)
  T_proc  = (P(z) / s_gpu) / (1 - ρ_g)+        ρ_g = λ·P(z) / s_gpu
  P(z)    = P₁·(α + (1-α)·z)                   (input pixels scale ∝ bitrate z)
  T_pre   = C_PRE / s_cpu / (1 - ρ_c)+         (4-resource scenario only)
  RAM     = l → ∞ if s_ram < model footprint   (4-resource scenario only)

Allocations with utilization ≥ 1 on any queue are infeasible (∞ latency).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LatencyParams", "latency", "latency_table"]

INF = np.inf


@dataclasses.dataclass(frozen=True)
class LatencyParams:
    """Calibrated constants. Defaults reproduce Fig. 2-right (see tests)."""

    rate_per_rbg: float = 2.2      # Mbit/s of uplink throughput per RBG
    sched_max: float = 0.08        # s — max uplink scheduling-request latency
    sched_f0: float = 5.0          # jobs/s at which grant latency halves
    gpu_alpha: float = 0.2         # z-independent fraction of GPU time
    t_fixed: float = 0.148         # s — compression + postproc + downlink
    cpu_pre: float = 0.030         # s of single-core preprocessing per job
    ram_per_model: float = 4.0     # GB footprint an admitted model needs
    util_cap: float = 0.999        # queues at/above this utilization → ∞

    # resource column roles, by index into the allocation vector. The paper's
    # 2-resource scenario is (rbg, gpu); the 4-resource scenario (Fig. 6b)
    # appends (cpu, ram).
    idx_rbg: int = 0
    idx_gpu: int = 1
    idx_cpu: int = 2
    idx_ram: int = 3


def latency(params: LatencyParams,
            bits_per_job, jobs_per_sec, gpu_time_per_job,
            z, alloc) -> np.ndarray:
    """Evaluate l_τ(z, s). All task args broadcast; ``alloc`` has shape
    (..., m) with m ∈ {2, 4}. Returns latency in seconds (∞ = infeasible)."""
    alloc = np.asarray(alloc, np.float64)
    m = alloc.shape[-1]
    b = np.asarray(bits_per_job, np.float64)
    lam = np.asarray(jobs_per_sec, np.float64)
    p1 = np.asarray(gpu_time_per_job, np.float64)
    z = np.asarray(z, np.float64)

    s_rbg = alloc[..., params.idx_rbg]
    s_gpu = alloc[..., params.idx_gpu]

    with np.errstate(divide="ignore", invalid="ignore"):
        # --- radio uplink ---
        rate = s_rbg * params.rate_per_rbg                  # Mbit/s
        rho_r = lam * b * z / np.maximum(rate, 1e-12)
        t_tx = (b * z) / np.maximum(rate, 1e-12)
        t_up = np.where(rho_r < params.util_cap,
                        t_tx / np.maximum(1.0 - rho_r, 1e-9), INF)
        t_sched = params.sched_max / (1.0 + lam / params.sched_f0)

        # --- edge compute ---
        p_z = p1 * (params.gpu_alpha + (1.0 - params.gpu_alpha) * z)
        rho_g = lam * p_z / np.maximum(s_gpu, 1e-12)
        t_srv = p_z / np.maximum(s_gpu, 1e-12)
        t_proc = np.where(rho_g < params.util_cap,
                          t_srv / np.maximum(1.0 - rho_g, 1e-9), INF)

        total = t_up + t_sched + t_proc + params.t_fixed

        if m >= 4:
            s_cpu = alloc[..., params.idx_cpu]
            s_ram = alloc[..., params.idx_ram]
            rho_c = lam * params.cpu_pre / np.maximum(s_cpu, 1e-12)
            t_pre = np.where(rho_c < params.util_cap,
                             (params.cpu_pre / np.maximum(s_cpu, 1e-12))
                             / np.maximum(1.0 - rho_c, 1e-9), INF)
            total = total + t_pre
            total = np.where(s_ram >= params.ram_per_model, total, INF)

    # allocations must be strictly positive on every vital resource
    vital = (s_rbg > 0) & (s_gpu > 0)
    if m >= 4:
        vital = vital & (alloc[..., params.idx_cpu] > 0)
    return np.where(vital, total, INF)


def latency_table(params: LatencyParams, tasks, z_per_task: np.ndarray,
                  grid: np.ndarray) -> np.ndarray:
    """(T, A) table of l_τ(z*_τ, s_a) over the enumerated allocation grid."""
    return latency(
        params,
        tasks.bits_per_job[:, None],
        tasks.jobs_per_sec[:, None],
        tasks.gpu_time_per_job[:, None],
        np.asarray(z_per_task)[:, None],
        grid[None, :, :],
    )
