"""Port of ``src/repro/core/scenarios.py``: the generators the serving slice
drives, copied draw for draw so equal seeds give equal traffic in both
packages.

* :func:`numerical_pool` — the 2- or 4-resource pool of paper Fig. 6.
* :func:`multi_cell_pools` — heterogeneous-capacity cells on one grid.
* :func:`metro_diurnal_trace` — hundreds of cells in disjoint backhaul
  domains under a diurnal load curve (the metro day batch).
* :func:`closed_loop_arrivals` — the closed loop's exogenous traffic as an
  event stream (what ``serving.driver.drive_closed_loop`` consumes).

The rest of the reference's library (Fig. 6/7 sweeps, Poisson and
multi-cell traces, fault schedules, the offline closed loop) is queued in
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import semantics
from .sfesp import build_instance
from .types import CouplingSpec, ProblemInstance, ResourcePool, TaskSet

__all__ = ["ACC_THRESHOLDS", "LAT_THRESHOLDS", "numerical_pool",
           "multi_cell_pools", "metro_diurnal_trace", "closed_loop_arrivals"]

# paper Section V-B threshold definitions ("lm" extends them to the
# beyond-paper prompt-compression workload; quality metric in [0, 1])
ACC_THRESHOLDS = {
    "low": {"detection": 0.20, "segmentation": 0.35, "lm": 0.40},
    "med": {"detection": 0.35, "segmentation": 0.50, "lm": 0.55},
    "high": {"detection": 0.55, "segmentation": 0.70, "lm": 0.72},
}
LAT_THRESHOLDS = {"low": 0.2, "high": 0.7}

# per-service stream characteristics — single source in core.semantics,
# shared with the serving SDLA
_BITS_PER_JOB = semantics.SERVICE_BITS_PER_JOB
_GPU_TIME = semantics.SERVICE_GPU_TIME


def numerical_pool(m: int = 2) -> ResourcePool:
    """2-resource (RBG, GPU) or 4-resource (RBG, GPU, CPU, RAM) pool."""
    if m == 2:
        return ResourcePool(
            names=("rbg", "gpu"),
            capacity=np.array([15.0, 20.0]),
            price=np.array([1.0 / 15.0, 1.0 / 20.0]),   # normalized prices
            levels=(np.arange(1.0, 16.0), np.arange(1.0, 21.0)),
        )
    if m == 4:
        return ResourcePool(
            names=("rbg", "gpu", "cpu", "ram"),
            capacity=np.array([15.0, 20.0, 32.0, 128.0]),
            price=np.array([1 / 15.0, 1 / 20.0, 1 / 32.0, 1 / 128.0]),
            levels=(np.arange(1.0, 16.0, 2.0),           # coarser grid keeps
                    np.arange(1.0, 21.0, 2.0),           # A = |grid| tractable
                    np.array([1.0, 2.0, 4.0, 8.0]),
                    np.array([4.0, 8.0, 16.0, 32.0])),
        )
    raise ValueError(f"unsupported m={m}")


def _tasks_from_apps(app_idx: np.ndarray, acc: str, lat: str,
                     jobs_per_sec: np.ndarray,
                     min_accuracy: np.ndarray | None = None) -> TaskSet:
    n = len(app_idx)
    services = np.array([semantics.APPS[i].service for i in app_idx])
    if min_accuracy is None:
        min_accuracy = np.array([ACC_THRESHOLDS[acc][s] for s in services])
    return TaskSet(
        app_idx=app_idx,
        min_accuracy=np.asarray(min_accuracy, np.float64),
        max_latency=np.full(n, LAT_THRESHOLDS[lat]),
        bits_per_job=np.array([_BITS_PER_JOB[s] for s in services]),
        jobs_per_sec=np.asarray(jobs_per_sec, np.float64),
        gpu_time_per_job=np.array([_GPU_TIME[s] for s in services]),
        n_ues=np.ones(n, np.int64),
    )



def multi_cell_pools(n_cells: int, m: int = 2, seed: int = 0,
                     n_grids: int = 1) -> list[ResourcePool]:
    """Heterogeneous-capacity cells, optionally with heterogeneous grids.

    Capacity varies ±40 % around the numerical pool — a small O-RAN
    deployment where each cell's RIC solves its own SF-ESP yet the operator
    sweeps all cells in one device program. With ``n_grids == 1`` (default)
    every cell keeps the canonical level sets, so instances stack into ONE
    batch; ``n_grids > 1`` cycles cells through coarsened ``pool.levels``
    (cell c keeps every ``(c % n_grids) + 1``-th level) — macro vs small
    cells exposing different allocation granularities. Mixed-grid traces
    dispatch through the reference's ``solve_greedy_many`` (not ported yet).
    """
    rng = np.random.default_rng(seed)
    base = numerical_pool(m)
    pools = []
    for c in range(n_cells):
        scale = rng.uniform(0.6, 1.4, size=base.m)
        cap = np.maximum(np.round(base.capacity * scale), 2.0)
        stride = (c % n_grids) + 1
        levels = tuple(np.asarray(lv)[::stride] for lv in base.levels)
        pools.append(dataclasses.replace(
            base, capacity=cap, price=1.0 / cap, levels=levels))
    return pools


def metro_diurnal_trace(n_cells: int = 256, *, n_domains: int = 32,
                        hours=None, days: int = 1, m: int = 2,
                        acc: str = "med", lat: str = "high", seed: int = 0,
                        base_rate: float = 2.0, peak_rate: float = 8.0,
                        backhaul_per_cell: float = 1.2,
                        ) -> tuple[list[ProblemInstance], list[dict]]:
    """Metro-scale deployment: hundreds of cells in disjoint backhaul
    domains under a diurnal load curve — the workload of the sharded solve.

    The metro is ``n_cells`` heterogeneous cells (``multi_cell_pools``,
    shared allocation grid) partitioned into ``n_domains`` CONTIGUOUS
    aggregation domains (cell ``c`` belongs to domain
    ``c * n_domains // n_cells`` — a ring deployment where neighboring cells
    share a metro-aggregation link). Each domain owns one backhaul link per
    hour with budget ``backhaul_per_cell * domain_size``; domains never share
    links, so the coupling groups of one hour are exactly the domains —
    ``len(hours) * n_domains`` independent groups a mesh can solve in
    parallel (the reference's ``greedy.solve_greedy_sharded``).

    Traffic follows a sinusoidal day curve: each cell's Poisson arrival rate
    ramps from ``base_rate`` (night) to ``peak_rate`` over a 12 h daytime
    window whose start is offset by a per-cell phase in [-2 h, +4 h)
    (business districts peak around noon, residential cells toward the
    evening), so domains hit their backhaul ceilings at different hours.

    ``hours`` defaults to the full horizon — ``range(24 * days)`` — so
    ``days=2`` yields a 48 h trace whose diurnal curve repeats (the sinusoid
    wraps hours mod 24 internally); pass e.g. ``(13,)`` for one near-peak
    snapshot (the ``sweep/metro_256cell`` benchmark). Hours past 23 are kept
    verbatim in the metadata so multi-day steps stay distinguishable, and
    every step still owns its own link block. Returns hour-major instances
    (cells adjacent within an hour — group-major up to domain order) and
    matching ``{"step", "hour", "cell", "domain", "link"}`` metadata.
    """
    hours = list(range(24 * days)) if hours is None else [int(h) for h in hours]
    if n_cells < n_domains:
        raise ValueError(f"n_cells={n_cells} < n_domains={n_domains}")
    pools = multi_cell_pools(n_cells, m=m, seed=seed)
    rng = np.random.default_rng(seed + 7)
    domain = (np.arange(n_cells) * n_domains) // n_cells
    dom_size = np.bincount(domain, minlength=n_domains)
    # one shared link_capacity array: merge_coupling identifies a common
    # link set by array identity, so every instance must reference THIS one
    link_cap = np.tile(dom_size * float(backhaul_per_cell), len(hours))
    L = len(link_cap)
    phase = rng.uniform(-2.0, 4.0, size=n_cells)
    n_paper = len(semantics.PAPER_APPS)
    insts, meta = [], []
    for step, h in enumerate(hours):
        day = np.sin(np.pi * ((h - 6.0 - phase) % 24.0) / 12.0)
        rate = base_rate + (peak_rate - base_rate) * np.maximum(0.0, day)
        for c in range(n_cells):
            k = int(rng.poisson(rate[c]))
            app_idx = rng.integers(0, n_paper, size=k)
            link = step * n_domains + int(domain[c])
            row = np.zeros((1, L), bool)
            row[0, link] = True
            insts.append(build_instance(
                pools[c], _tasks_from_apps(app_idx, acc, lat,
                                           np.full(k, 5.0)),
                coupling=CouplingSpec(link_cap, row)))
            meta.append(dict(step=step, hour=h, cell=c,
                             domain=int(domain[c]), link=link))
    return insts, meta


def closed_loop_arrivals(n_cells: int, horizon: int, *,
                         arrival_rate: float = 4.0, mean_holding: float = 5.0,
                         acc: str = "med", lat: str = "high",
                         jobs_per_sec: float = 5.0,
                         seed: int = 0) -> list[list[list[dict]]]:
    """The closed loop's exogenous traffic as an engine-drivable event stream.

    Same traffic MODEL as :func:`closed_loop_trace` — per cell and step,
    ``Poisson(arrival_rate)`` tasks arrive, each drawn uniformly from the
    paper's Tab. II applications with an ``Exp(mean_holding)`` holding time —
    but emitted as plain events instead of being solved in place, so a
    serving engine (``repro_torch.serving.multicell.MultiCellEngine``, via
    ``repro_torch.serving.driver.drive_closed_loop``) can be driven by the same
    generators the offline trace uses. (Same distribution, NOT the same
    random realization: the offline trace interleaves its arrival draws with
    handover draws on one stream, so equal seeds do not reproduce its exact
    per-step counts.) Returns
    ``events[step][cell] = [event, ...]`` with each event::

        {"app": int,            # semantics.APPS index
         "app_class": str,      # registry name (SliceRequest.app_class)
         "service": str,        # "detection" | "segmentation"
         "min_accuracy": float, # ACC_THRESHOLDS[acc][service]
         "max_latency_s": float,
         "jobs_per_sec": float,
         "depart": float}       # step at which the task leaves the system
    """
    rng = np.random.default_rng(seed)
    n_paper = len(semantics.PAPER_APPS)
    events: list[list[list[dict]]] = []
    for step in range(horizon):
        per_cell = []
        for _ in range(n_cells):
            evs = []
            for _ in range(rng.poisson(arrival_rate)):
                app = int(rng.integers(0, n_paper))
                cls = semantics.APPS[app]
                evs.append(dict(
                    app=app, app_class=cls.name, service=cls.service,
                    min_accuracy=ACC_THRESHOLDS[acc][cls.service],
                    max_latency_s=LAT_THRESHOLDS[lat],
                    jobs_per_sec=float(jobs_per_sec),
                    depart=step + float(rng.exponential(mean_holding))))
            per_cell.append(evs)
        events.append(per_cell)
    return events
