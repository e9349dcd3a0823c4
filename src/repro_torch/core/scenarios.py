"""Port of ``src/repro/core/scenarios.py``: the paper's evaluation setups
plus the dynamic library, copied draw for draw so equal seeds give equal
instances and traffic in both packages.

Static (paper Section V):

* :func:`numerical_pool` / :func:`numerical_tasks` — Fig. 6 numerical analysis:
  2 or 4 edge/network resource types; accuracy thresholds {low, med, high} =
  {0.20, 0.35, 0.55} mAP (detection) / {0.35, 0.50, 0.70} mIoU (segmentation);
  latency thresholds {low, high} = {0.2 s, 0.7 s}; tasks equally distributed
  over the Tab. II applications.
* :func:`colosseum_pool` / :func:`colosseum_tasks` — Section V-C prototype:
  15 RBGs available for slicing (17 total, 2 reserved for iperf traffic),
  20 GPUs; three slices (Bags, Animals, Flat) with time-varying fps.

Dynamic (feed the batched sweep engine, ``greedy.solve_greedy_batch``): each
generator yields a time-indexed list of :class:`ProblemInstance` sharing one
allocation grid, so a whole trace/sweep solves as ONE stacked device program.

* :func:`fig6_sweep` — the full Fig. 6 grid (task counts x accuracy x latency
  x seeds) as a flat instance list.
* :func:`poisson_trace` — Poisson task arrivals with exponential holding
  times (DRL-slicing style dynamic traffic, cf. arXiv:2103.10277).
* :func:`fps_trace` / :func:`fps_trace_instances` — Fig. 7-style piecewise-
  constant per-UE fps periods.
* :func:`multi_cell_pools` / :func:`multi_cell_trace` — several cells with
  heterogeneous capacities but a shared allocation grid; with
  ``shared_backhaul=...`` each step's cells are coupled through one shared
  backhaul link (solved jointly by the coupled sweep engine).
* :func:`mixed_workload_tasks` — detection + segmentation + LM task mixes.
* :func:`closed_loop_trace` — decisions feed back into the trace; optional
  ``handover_prob`` mobility (warm-start z pinning) and ``shared_backhaul``.
* :func:`closed_loop_arrivals` — the closed loop's exogenous traffic as a
  plain event stream, so the SERVING engine can be driven by the same
  generators (``repro_torch.serving.driver.drive_closed_loop`` consumes it).

Fault schedules (the serving engine's fault plane, ``faults=`` of
``repro_torch.serving.driver.drive_closed_loop``): a schedule is a plain
``{step: [event, ...]}`` dict whose events are the TYPED serving events of
``repro_torch.core.events`` — :class:`~repro_torch.core.events.CellFault` for
outage/recovery, :class:`~repro_torch.core.events.LinkScale` for link
degradation, and :class:`~repro_torch.core.events.Arrival` (with a raw
:func:`closed_loop_arrivals` traffic dict as payload) for traffic overlays
— so a schedule is directly feedable to ``MultiCellEngine.ingest``. Build
them with :func:`outage_schedule` / :func:`random_outage_schedule` (cell
outage + recovery windows), :func:`stepped_link_degradation` (staircase
budget squeeze), :func:`flash_crowd` (burst overlay) and
:func:`arrival_events` (the base traffic itself, as events); overlay
independently-built schedules with :func:`compose_faults`. All generators
are deterministic per seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import latency as lat_mod
from . import semantics
from .events import Arrival, CellFault, LinkScale, SemanticShift
from .greedy import solve_greedy_batch
from .sfesp import build_instance, next_pow2, restack, stack_instances
from .types import CouplingSpec, ProblemInstance, ResourcePool, TaskSet

__all__ = [
    "ACC_THRESHOLDS", "LAT_THRESHOLDS",
    "numerical_pool", "numerical_tasks", "colosseum_pool", "colosseum_tasks",
    "fig6_sweep", "poisson_trace", "fps_trace", "fps_trace_instances",
    "multi_cell_pools", "multi_cell_trace", "metro_diurnal_trace",
    "mixed_workload_tasks", "closed_loop_trace", "closed_loop_arrivals",
    "arrival_events", "outage_schedule", "random_outage_schedule",
    "stepped_link_degradation", "semantic_drift_schedule", "flash_crowd",
    "compose_faults",
]

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


def numerical_tasks(n_tasks: int, acc: str, lat: str,
                    seed: int = 0, jobs_per_sec: float = 5.0) -> TaskSet:
    """Tasks equally distributed across the 10 Tab. II applications."""
    rng = np.random.default_rng(seed)
    app_idx = np.arange(n_tasks) % len(semantics.PAPER_APPS)
    rng.shuffle(app_idx)
    services = np.array([semantics.APPS[i].service for i in app_idx])
    min_acc = np.array([ACC_THRESHOLDS[acc][s] for s in services])
    max_lat = np.full(n_tasks, LAT_THRESHOLDS[lat])
    bits = np.array([_BITS_PER_JOB[s] for s in services])
    gpu_t = np.array([_GPU_TIME[s] for s in services])
    return TaskSet(
        app_idx=app_idx, min_accuracy=min_acc, max_latency=max_lat,
        bits_per_job=bits, jobs_per_sec=np.full(n_tasks, jobs_per_sec),
        gpu_time_per_job=gpu_t, n_ues=np.ones(n_tasks, np.int64),
    )


def colosseum_pool() -> ResourcePool:
    """Section V-C: 15 sliceable RBGs, 20 Tesla-class GPUs."""
    return ResourcePool(
        names=("rbg", "gpu"),
        capacity=np.array([15.0, 20.0]),
        price=np.array([1.0 / 15.0, 1.0 / 20.0]),
        levels=(np.arange(1.0, 16.0), np.arange(1.0, 21.0)),
    )


def colosseum_tasks(fps: float, min_acc: float = 0.30,
                    max_lat: float = 0.7) -> TaskSet:
    """The three Fig. 7 slices (Bags, Animals, Flat) at a given frame rate.

    Fig. 7 varies the per-UE fps every 25 s period while keeping the accuracy
    and latency requirements constant.
    """
    apps = ["coco_bags", "coco_animals", "cityscapes_flat"]
    app_idx = np.array([semantics.APP_INDEX[a] for a in apps])
    services = np.array([semantics.APPS[i].service for i in app_idx])
    # Animals' Fig. 7(f) threshold is 0.50 mAP; Bags/Flat use the base bound.
    min_accs = np.array([min_acc, 0.50, min_acc])
    return TaskSet(
        app_idx=app_idx,
        min_accuracy=min_accs,
        max_latency=np.full(3, max_lat),
        bits_per_job=np.array([_BITS_PER_JOB[s] for s in services]),
        jobs_per_sec=np.full(3, float(fps)),
        gpu_time_per_job=np.array([_GPU_TIME[s] for s in services]),
        n_ues=np.ones(3, np.int64),
    )


# ---------------------------------------------------------------------------
# Dynamic scenario library — every generator below returns a list of
# ProblemInstances over one shared allocation grid, ready for stack_instances
# ---------------------------------------------------------------------------

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


def fig6_sweep(m: int = 2, n_tasks=(10, 20, 30, 40, 50),
               acc_levels=("low", "med", "high"), lat_levels=("low", "high"),
               seeds=(0, 1, 2)) -> tuple[list[ProblemInstance], list[dict]]:
    """The Fig. 6 evaluation grid as a flat instance list + cell metadata.

    All cells share ``numerical_pool(m)``, hence one allocation grid — the
    whole sweep (default 5x3x2x3 = 90 instances) solves as a single batch.
    """
    pool = numerical_pool(m)
    insts, meta = [], []
    for acc in acc_levels:
        for lat in lat_levels:
            for n in n_tasks:
                for seed in seeds:
                    insts.append(build_instance(
                        pool, numerical_tasks(n, acc, lat, seed=seed)))
                    meta.append(dict(m=m, acc=acc, lat=lat, n=n, seed=seed))
    return insts, meta


def mixed_workload_tasks(n_tasks: int, acc: str = "med", lat: str = "high",
                         seed: int = 0, lm_fraction: float = 0.3,
                         jobs_per_sec: float = 5.0) -> TaskSet:
    """Mixed detection / segmentation / LM task set.

    ``lm_fraction`` of the tasks are prompt-compression LM requests; the rest
    split evenly over the paper's vision apps (Tab. II).
    """
    rng = np.random.default_rng(seed)
    n_lm = int(round(n_tasks * lm_fraction))
    n_paper = len(semantics.PAPER_APPS)
    vision = np.arange(n_tasks - n_lm) % n_paper
    lm = n_paper + rng.integers(0, len(semantics.LM_APPS), n_lm)
    app_idx = np.concatenate([vision, lm])
    rng.shuffle(app_idx)
    # LM requests arrive faster than video frames (chat turns vs fps)
    rates = np.where(
        np.array([semantics.APPS[i].service for i in app_idx]) == "lm",
        2.0 * jobs_per_sec, jobs_per_sec)
    return _tasks_from_apps(app_idx, acc, lat, rates)


def poisson_trace(horizon: int, *, pool: ResourcePool | None = None,
                  arrival_rate: float = 4.0, mean_holding: float = 5.0,
                  acc: str = "med", lat: str = "high", seed: int = 0,
                  lm_fraction: float = 0.0,
                  lat_params: lat_mod.LatencyParams | None = None,
                  ) -> tuple[list[ProblemInstance], list[np.ndarray]]:
    """Dynamic traffic: Poisson arrivals, exponential holding times.

    At each of ``horizon`` steps, ``Poisson(arrival_rate)`` new tasks arrive
    and live for ``Exp(mean_holding)`` steps; the active set at each step
    forms one ProblemInstance (the admission problem the RIC re-solves on
    every slicing window — the trace evaluation style of the DRL slicing
    literature). Returns (instances, active-app-index arrays per step).
    """
    rng = np.random.default_rng(seed)
    pool = pool or numerical_pool(2)
    n_paper = len(semantics.PAPER_APPS)
    n_apps = len(semantics.APPS) if lm_fraction > 0 else n_paper
    active: list[tuple[int, float]] = []       # (app_idx, departure_step)
    insts, apps_per_step = [], []
    for step in range(horizon):
        active = [(a, d) for a, d in active if d > step]
        for _ in range(rng.poisson(arrival_rate)):
            if lm_fraction > 0 and rng.random() < lm_fraction:
                app = int(rng.integers(n_paper, n_apps))
            else:
                app = int(rng.integers(0, n_paper))
            active.append((app, step + rng.exponential(mean_holding)))
        app_idx = np.array([a for a, _ in active], np.int64)
        rates = np.full(len(app_idx), 5.0)
        insts.append(build_instance(pool, _tasks_from_apps(
            app_idx, acc, lat, rates), lat_params=lat_params))
        apps_per_step.append(app_idx)
    return insts, apps_per_step


def fps_trace(n_periods: int = 4, fps_levels=(10.0, 7.0, 5.0, 3.0),
              seed: int | None = None) -> np.ndarray:
    """Fig. 7-style piecewise-constant per-UE fps trace (one value/period).

    With ``seed=None`` returns the paper's deterministic 4-period trace;
    otherwise samples uniformly from ``fps_levels``.
    """
    if seed is None:
        reps = -(-n_periods // len(fps_levels))
        return np.tile(np.asarray(fps_levels, np.float64), reps)[:n_periods]
    rng = np.random.default_rng(seed)
    return rng.choice(np.asarray(fps_levels, np.float64), size=n_periods)


def fps_trace_instances(trace: np.ndarray, *, min_acc: float = 0.30,
                        max_lat: float = 0.7) -> list[ProblemInstance]:
    """One colosseum instance per fps period — the Fig. 7 re-slicing sequence
    as a batch (all periods share the colosseum pool/grid)."""
    pool = colosseum_pool()
    return [build_instance(pool, colosseum_tasks(float(fps), min_acc=min_acc,
                                                 max_lat=max_lat))
            for fps in np.asarray(trace)]


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
    dispatch through :func:`repro_torch.core.greedy.solve_greedy_many`.
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


def multi_cell_trace(n_cells: int, horizon: int, *, m: int = 2,
                     acc: str = "med", lat: str = "high", seed: int = 0,
                     arrival_rate: float = 4.0, mean_holding: float = 5.0,
                     n_grids: int = 1, shared_backhaul: float | None = None,
                     ) -> tuple[list[ProblemInstance], list[dict]]:
    """Per-cell Poisson traffic over a horizon, flattened time-major.

    Returns ``horizon * n_cells`` instances (cell-adjacent within a step) and
    matching ``{"step", "cell"}`` metadata. With the default ``n_grids=1``
    the full trace stacks into one batch (shared level grid); ``n_grids > 1``
    yields per-cell allocation grids — solve via ``solve_greedy_many``.

    ``shared_backhaul`` models the transport between the cells and the edge
    cluster: the cells of each step share ONE backhaul link with that budget
    (Mbit/s of admitted compressed traffic). Steps are independent admission
    problems, so the trace's :class:`~repro_torch.core.types.CouplingSpec` carries
    one link PER STEP (L = horizon) and instance (step, cell) loads only its
    step's link — the whole trace still solves as one coupled batch, with one
    coupling group per step.
    """
    if shared_backhaul is not None and n_grids != 1:
        raise ValueError(
            "shared_backhaul requires n_grids=1: cells coupled through a "
            "link must share one allocation grid (no solver path accepts a "
            "link spanning grid groups)")
    pools = multi_cell_pools(n_cells, m=m, seed=seed, n_grids=n_grids)
    link_cap = None if shared_backhaul is None \
        else np.full(horizon, float(shared_backhaul))
    insts, meta = [], []
    per_cell = [poisson_trace(horizon, pool=p, acc=acc, lat=lat,
                              seed=seed + 1000 * c,
                              arrival_rate=arrival_rate,
                              mean_holding=mean_holding)[0]
                for c, p in enumerate(pools)]
    for step in range(horizon):
        for cell in range(n_cells):
            inst = per_cell[cell][step]
            if link_cap is not None:
                row = np.zeros((1, horizon), bool)
                row[0, step] = True
                inst = dataclasses.replace(
                    inst, coupling=CouplingSpec(link_cap, row))
            insts.append(inst)
            meta.append(dict(step=step, cell=cell) if link_cap is None
                        else dict(step=step, cell=cell, link=step))
    return insts, meta


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
    parallel (the reference's ``greedy.solve_greedy_sharded``; the port's
    sharded layer is queued in ROADMAP.md).

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


# ---------------------------------------------------------------------------
# Fault schedules — disturbance event streams for the serving fault plane
# ---------------------------------------------------------------------------

def arrival_events(n_cells: int, horizon: int, *,
                   arrival_rate: float = 4.0, mean_holding: float = 5.0,
                   acc: str = "med", lat: str = "high",
                   jobs_per_sec: float = 5.0,
                   seed: int = 0) -> dict[int, list[Arrival]]:
    """:func:`closed_loop_arrivals` as a typed event schedule.

    The same traffic realization (identical draws per seed), emitted as
    ``{step: [Arrival, ...]}`` with the raw traffic dict as each event's
    payload — the event-stream shape fault schedules use, so base traffic
    composes with outages and link squeezes via :func:`compose_faults`.
    Payload dicts are resolved into :class:`~repro_torch.serving.request.
    SliceRequest` objects by the consumer (the driver draws the tier and
    books the departure).
    """
    base = closed_loop_arrivals(
        n_cells, horizon, arrival_rate=arrival_rate,
        mean_holding=mean_holding, acc=acc, lat=lat,
        jobs_per_sec=jobs_per_sec, seed=seed)
    sched: dict[int, list[Arrival]] = {}
    for step, per_cell in enumerate(base):
        evs = [Arrival(request=e, cell=c)
               for c, cell_evs in enumerate(per_cell) for e in cell_evs]
        if evs:
            sched[step] = evs
    return sched


def outage_schedule(windows) -> dict[int, list[CellFault]]:
    """Explicit cell outage/recovery windows as a fault schedule.

    ``windows`` is an iterable of ``(cell, start, end)``: the cell fails at
    step ``start`` and recovers at step ``end`` (exclusive — an ``end`` past
    the driving horizon simply never recovers). Emitted as typed
    :class:`~repro_torch.core.events.CellFault` events.
    """
    sched: dict[int, list[CellFault]] = {}
    for cell, start, end in windows:
        if end <= start:
            raise ValueError(
                f"outage window ({cell}, {start}, {end}) is empty")
        sched.setdefault(int(start), []).append(
            CellFault(int(cell), failed=True, reason="scheduled"))
        sched.setdefault(int(end), []).append(
            CellFault(int(cell), failed=False))
    return sched


def random_outage_schedule(n_cells: int, horizon: int, *,
                           n_outages: int = 2, duration: int = 3,
                           seed: int = 0,
                           spare_cells=()) -> dict[int, list[dict]]:
    """``n_outages`` non-overlapping random cell outages over the horizon.

    Each outage picks a uniformly-random victim cell (never one of
    ``spare_cells``, and never a cell already down) and a uniformly-random
    start such that the ``duration``-step window fits the horizon.
    Deterministic per seed.
    """
    eligible = [c for c in range(n_cells) if c not in set(spare_cells)]
    if not eligible:
        raise ValueError("every cell is spared: nothing to fail")
    if duration >= horizon:
        raise ValueError(f"duration {duration} >= horizon {horizon}")
    rng = np.random.default_rng(seed)
    windows, down = [], []        # down: (cell, start, end) already placed
    for _ in range(n_outages):
        for _attempt in range(64):
            cell = int(rng.choice(eligible))
            start = int(rng.integers(0, horizon - duration))
            end = start + duration
            if all(c != cell or end <= s or e <= start
                   for c, s, e in down):
                windows.append((cell, start, end))
                down.append((cell, start, end))
                break
    return outage_schedule(windows)


def stepped_link_degradation(horizon: int, *, start: int = 0,
                             n_steps: int = 3, floor: float = 0.5,
                             recover: bool = True) -> dict[int, list[dict]]:
    """Staircase link-budget squeeze: scale the nominal budgets down in
    ``n_steps`` equal steps from step ``start``, to ``floor`` of nominal,
    then (optionally) restore to nominal one step after the last squeeze.

    Emits ``link_scale`` events — the engine applies the factor to its
    NOMINAL budgets, so schedules compose without compounding.
    """
    if not 0.0 <= floor < 1.0:
        raise ValueError(f"floor {floor} outside [0, 1)")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    sched: dict[int, list[LinkScale]] = {}
    for k in range(n_steps):
        step = start + k
        if step >= horizon:
            break
        scale = 1.0 - (1.0 - floor) * (k + 1) / n_steps
        sched.setdefault(step, []).append(LinkScale(scale=float(scale)))
    if recover and start + n_steps < horizon:
        sched.setdefault(start + n_steps, []).append(LinkScale(scale=1.0))
    return sched


def semantic_drift_schedule(horizon: int, *, apps=None, start: int = 0,
                            n_steps: int = 3, floor: float = 0.8,
                            recover: bool = True
                            ) -> dict[int, list[SemanticShift]]:
    """Staircase semantic drift: the accuracy asymptotes of ``apps`` (app
    registry indices; default all) degrade in ``n_steps`` equal steps from
    step ``start`` down to ``floor ×`` nominal — the scene drifting away from
    the classifiers' calibration — then (optionally) recover one step after
    the last squeeze (the SDLA ships a recalibrated model).

    Emits typed :class:`~repro_torch.core.events.SemanticShift` events whose
    ``scale`` is applied against the engine model's NOMINAL curves, the same
    absolute-level convention as :func:`stepped_link_degradation`, so drift
    schedules compose via :func:`compose_faults` without compounding.
    """
    if not 0.0 < floor < 1.0:
        raise ValueError(f"floor {floor} outside (0, 1)")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    apps = None if apps is None else tuple(int(a) for a in apps)
    sched: dict[int, list[SemanticShift]] = {}
    for k in range(n_steps):
        step = start + k
        if step >= horizon:
            break
        scale = 1.0 - (1.0 - floor) * (k + 1) / n_steps
        sched.setdefault(step, []).append(
            SemanticShift(app_idx=apps, scale=float(scale)))
    if recover and start + n_steps < horizon:
        sched.setdefault(start + n_steps, []).append(
            SemanticShift(app_idx=apps, scale=1.0))
    return sched


def flash_crowd(n_cells: int, horizon: int, *, step: int, duration: int = 2,
                cells=None, arrival_rate: float = 8.0, acc: str = "med",
                lat: str = "high", jobs_per_sec: float = 5.0,
                mean_holding: float = 5.0,
                seed: int = 0) -> dict[int, list[dict]]:
    """A localized traffic burst (stadium event) as an arrivals overlay.

    For ``duration`` steps from ``step``, the affected ``cells`` (default:
    all) receive EXTRA ``Poisson(arrival_rate)`` arrivals on top of the
    driver's base traffic — typed :class:`~repro_torch.core.events.Arrival` events
    carrying :func:`closed_loop_arrivals` traffic dicts as payloads.
    Deterministic per seed, independent of the base trace's stream.
    """
    cells = list(range(n_cells)) if cells is None else [int(c) for c in cells]
    rng = np.random.default_rng(seed)
    n_paper = len(semantics.PAPER_APPS)
    sched: dict[int, list[Arrival]] = {}
    for s in range(step, min(step + duration, horizon)):
        for c in cells:
            for _ in range(rng.poisson(arrival_rate)):
                app = int(rng.integers(0, n_paper))
                cls = semantics.APPS[app]
                sched.setdefault(s, []).append(Arrival(request=dict(
                    app=app, app_class=cls.name, service=cls.service,
                    min_accuracy=ACC_THRESHOLDS[acc][cls.service],
                    max_latency_s=LAT_THRESHOLDS[lat],
                    jobs_per_sec=float(jobs_per_sec),
                    depart=s + float(rng.exponential(mean_holding))),
                    cell=c))
    return sched


def compose_faults(*schedules: dict[int, list]) -> dict[int, list]:
    """Overlay fault schedules into one ``{step: [event, ...]}`` dict.

    Events of one step concatenate in argument order (earlier schedules
    apply first), so e.g. an outage schedule composes with a link-degradation
    staircase and a flash crowd into one scenario.
    """
    out: dict[int, list] = {}
    for sched in schedules:
        for step, events in sched.items():
            out.setdefault(int(step), []).extend(events)
    return out


def closed_loop_trace(n_cells: int, horizon: int, *, m: int = 2,
                      acc: str = "med", lat: str = "high", seed: int = 0,
                      arrival_rate: float = 4.0, mean_holding: float = 5.0,
                      max_retries: int = 2, semantic: bool = True,
                      flexible: bool = True, handover_prob: float = 0.0,
                      shared_backhaul: float | None = None,
                      device="cuda") -> list[dict]:
    """Closed-loop multi-cell admission: decisions feed back into the trace.

    Unlike :func:`multi_cell_trace` (open loop — every step's task set is
    exogenous), each step's candidate set per cell is (i) tasks admitted last
    step that have not yet departed, plus (ii) fresh Poisson arrivals, plus
    (iii) rejected tasks retrying up to ``max_retries`` times before leaving
    (the ROADMAP closed-loop case: admitted tasks persist, evicted ones
    retry). Every step solves one batch (one instance per cell) through the
    batched sweep engine; :func:`repro_torch.core.sfesp.restack` reuses ONE set of
    padded host buffers across the whole horizon, re-stacking only when a
    step outgrows the current power-of-two ``Tmax`` bucket.

    ``handover_prob`` adds mobility: each step, an ADMITTED task hands over
    to a uniformly-random other cell with this probability, its compression
    retained as a warm start — the stream is already encoded at its admitted
    ``z``, so the task re-arrives in the target cell with its accuracy bound
    pinned to the level achieved at that ``z`` (Eq. 2 then re-derives the
    same compression instead of renegotiating the stream).

    ``shared_backhaul`` couples each step's cells through one shared
    backhaul link with that budget (see :func:`multi_cell_trace`); the
    per-step batch then solves through the coupled sweep engine.

    Every step solves on ``device`` (on CUDA the batched solve is one K1
    launch).

    Returns one record per (step, cell):
    ``{"step", "cell", "offered", "admitted", "objective", "restacked",
    "handovers"}`` where ``restacked`` flags steps that allocated fresh
    buffers and ``handovers`` counts tasks that re-arrived in this cell via
    handover this step.
    """
    pools = multi_cell_pools(n_cells, m=m, seed=seed)
    coupling_row = None
    if shared_backhaul is not None:
        link_cap = np.array([float(shared_backhaul)])
        coupling_row = CouplingSpec(link_cap, np.ones((1, 1), bool))
    rng = np.random.default_rng(seed + 17)
    n_paper = len(semantics.PAPER_APPS)
    # per-cell live tasks: app index, departure step, retries left, pinned
    # accuracy bound (None until first handover) and last admitted z
    active: list[list[dict]] = [[] for _ in range(n_cells)]
    stacked = None
    records = []
    for step in range(horizon):
        handed_in = [0] * n_cells
        # departures first: a task whose holding time expired must not hand
        # over (or consume rng draws) as a phantom
        for c in range(n_cells):
            active[c] = [t for t in active[c] if t["depart"] > step]
        if handover_prob > 0.0 and n_cells > 1:
            # mobility: admitted tasks may hand over before this step's
            # arrivals; the warm-start pin keeps their stream's compression
            moved: list[tuple[int, dict]] = []
            for c in range(n_cells):
                stay = []
                for task in active[c]:
                    if task["z"] is not None and rng.random() < handover_prob:
                        target = int(rng.integers(0, n_cells - 1))
                        target += target >= c
                        task["min_acc"] = semantics.warm_start_accuracy(
                            task["app"], task["z"])
                        moved.append((target, task))
                    else:
                        stay.append(task)
                active[c] = stay
            for target, task in moved:
                active[target].append(task)
                handed_in[target] += 1
        for c in range(n_cells):
            for _ in range(rng.poisson(arrival_rate)):
                active[c].append(dict(
                    app=int(rng.integers(0, n_paper)),
                    depart=step + rng.exponential(mean_holding),
                    retries=max_retries, min_acc=None, z=None))
        insts = []
        for c in range(n_cells):
            app_idx = np.array([t["app"] for t in active[c]], np.int64)
            services = [semantics.APPS[i].service for i in app_idx]
            min_acc = np.array([
                t["min_acc"] if t["min_acc"] is not None
                else ACC_THRESHOLDS[acc][s]
                for t, s in zip(active[c], services)])
            insts.append(build_instance(pools[c], _tasks_from_apps(
                app_idx, acc, lat, np.full(len(active[c]), 5.0),
                min_accuracy=min_acc), coupling=coupling_row))
        tneed = max(len(a) for a in active)
        fresh = stacked is None or tneed > stacked.max_tasks
        if fresh:
            stacked = stack_instances(insts, tmax=next_pow2(tneed))
        else:
            stacked = restack(stacked, insts)
        sols = solve_greedy_batch(stacked, semantic=semantic,
                                  flexible=flexible, device=device)
        for c, sol in enumerate(sols):
            keep = []
            for t, task in enumerate(active[c]):
                if sol.admitted[t]:
                    task["z"] = float(sol.z[t])
                    keep.append(task)
                else:
                    task["retries"] -= 1
                    # not served → no encoded stream to warm-start from: the
                    # task retries at its class threshold, not the pinned one
                    task["z"] = None
                    task["min_acc"] = None
                    if task["retries"] >= 0:   # max_retries re-offers total
                        keep.append(task)
            offered = len(active[c])
            active[c] = keep
            records.append(dict(step=step, cell=c, offered=offered,
                                admitted=int(sol.num_allocated),
                                objective=sol.objective,
                                restacked=bool(fresh),
                                handovers=handed_in[c]))
    return records
