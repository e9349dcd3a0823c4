"""The port's evaluation path against the JAX reference, on the CPU.

The paper's evaluation front doors — the single-instance solve
(``solve_greedy_torch``, the counterpart of ``solve_greedy_jax``), the six
algorithms of ``run_algorithm``, the coupled oracle ``solve_coupled_ref``,
the mixed-grid dispatcher ``solve_greedy_many``, the exact solver,
``SESM.slice`` and the scenario library — are handed the same seeds in both
packages and must produce equal instances and equal decisions (admitted,
alloc, z, satisfied). K2's round runs here through its plain version;
``tests/test_torch_cuda.py`` holds the CUDA kernel against it on a card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import run_algorithm as j_run  # noqa: E402
from repro.core import scenarios as JS  # noqa: E402
from repro.core import solve_coupled_ref as j_coupled_ref  # noqa: E402
from repro.core import solve_exact as j_exact  # noqa: E402
from repro.core import solve_greedy_jax as j_single  # noqa: E402
from repro.core import solve_greedy_many as j_many  # noqa: E402
from repro.core import CouplingSpec as JCouplingSpec  # noqa: E402
from repro.core import ResourcePool as JResourcePool  # noqa: E402
from repro.core import build_instance as j_build  # noqa: E402
from repro.serving import SESM as JSESM  # noqa: E402
from repro.serving import SliceRequest as JRequest  # noqa: E402

from repro_torch.core import (ALGORITHMS, CouplingSpec,  # noqa: E402
                              ResourcePool, build_instance, greedy,
                              run_algorithm, scenarios, solve,
                              solve_coupled_ref, solve_exact,
                              solve_greedy_batch, solve_greedy_many,
                              solve_greedy_torch, stack_instances)
from repro_torch.serving import SESM, SliceRequest  # noqa: E402

QUADRANTS = [(True, True), (True, False), (False, True), (False, False)]


def _same(ref, out, what=""):
    assert np.array_equal(ref.admitted, out.admitted), what
    assert np.array_equal(ref.alloc, out.alloc), what
    assert np.array_equal(ref.z, out.z), what
    assert np.array_equal(ref.satisfied, out.satisfied), what
    assert ref.objective == out.objective, what


def _same_instance(ref, out):
    for f in dataclasses.fields(ref.tasks):
        assert np.array_equal(getattr(ref.tasks, f.name),
                              getattr(out.tasks, f.name)), f.name
    assert ref.pool.names == out.pool.names
    assert np.array_equal(ref.pool.capacity, out.pool.capacity)
    assert np.array_equal(ref.pool.price, out.pool.price)
    assert all(np.array_equal(a, b)
               for a, b in zip(ref.pool.levels, out.pool.levels))
    for f in ("z_grid", "acc", "acc_agnostic", "grid", "lat",
              "lat_agnostic", "z_star_idx", "z_star_idx_agnostic"):
        assert np.array_equal(getattr(ref, f), getattr(out, f)), f
    if ref.coupling is None:
        assert out.coupling is None
    else:
        assert np.array_equal(ref.coupling.incidence, out.coupling.incidence)
        assert np.array_equal(ref.coupling.link_capacity,
                              out.coupling.link_capacity)


def _fig6(m, n_tasks=(10, 30), seeds=(0, 1)):
    kw = dict(n_tasks=n_tasks, acc_levels=("med",), lat_levels=("high",),
              seeds=seeds)
    return JS.fig6_sweep(m, **kw)[0], scenarios.fig6_sweep(m, **kw)[0]


@pytest.fixture
def k2_route(monkeypatch):
    """Route ``solve_greedy_torch`` through K2's admission round
    (``kernels/pg/pg.py::bind_round``) on the CPU, where the round takes its
    plain version ``admission_round_ref``: ``inner="kernel"`` needs a card,
    so the test swaps the inner resolution itself."""
    monkeypatch.setattr(greedy, "resolve_inner", lambda inner, dev: "kernel")


# ------------------------------------------------------ single instance

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("semantic,flexible", QUADRANTS)
def test_single_solve_matches_reference(m, semantic, flexible):
    jinsts, insts = _fig6(m)
    for jinst, inst in zip(jinsts, insts):
        ref = j_single(jinst, semantic=semantic, flexible=flexible,
                       inner="jnp")
        _same(ref, j_single(jinst, semantic=semantic, flexible=flexible,
                            inner="pallas"))
        _same(ref, solve_greedy_torch(inst, semantic=semantic,
                                      flexible=flexible, inner="torch",
                                      device="cpu"), inst.num_tasks)


@pytest.mark.parametrize("m", [2, 4])
def test_single_solve_on_the_k2_round_matches_reference(m, k2_route):
    jinsts, insts = _fig6(m, n_tasks=(20, 50), seeds=(2,))
    for jinst, inst in zip(jinsts, insts):
        for semantic, flexible in QUADRANTS:
            _same(j_single(jinst, semantic=semantic, flexible=flexible),
                  solve_greedy_torch(inst, semantic=semantic,
                                     flexible=flexible, device="cpu"))


def test_solve_front_door_backends():
    inst = scenarios.fig6_sweep(2, n_tasks=(20,), acc_levels=("low",),
                                lat_levels=("high",), seeds=(3,))[0][0]
    _same(greedy.solve_greedy(inst), solve(inst))
    _same(solve_greedy_torch(inst, device="cpu"),
          solve(inst, backend="torch", device="cpu"))
    with pytest.raises(ValueError, match="backend"):
        solve(inst, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        run_algorithm("sem-o-ran", inst, backend="jax", device="cpu")


# ----------------------------------------------------------- baselines

@pytest.mark.parametrize("m", [2, 4])
def test_run_algorithm_all_six_match_reference(m):
    jinsts, insts = _fig6(m, n_tasks=(15, 40), seeds=(1,))
    assert sorted(ALGORITHMS) == sorted(
        ["sem-o-ran", "si-edge", "minres-sem", "flexres-n-sem", "highcomp",
         "highres"])
    for jinst, inst in zip(jinsts, insts):
        for name in ALGORITHMS:
            _same(j_run(name, jinst, backend="jax"),
                  run_algorithm(name, inst, backend="torch", device="cpu"),
                  name)
            _same(j_run(name, jinst), run_algorithm(name, inst), name)


def _coupled(pkg, n_cells=4, seed=0, link_caps=(4.0, 6.0)):
    """``tests/test_sfesp_coupled.py``'s random link topology, built by
    either package from the same draws."""
    scen, build, spec = pkg
    rng = np.random.default_rng(seed)
    pools = scen.multi_cell_pools(n_cells, seed=seed)
    cap = np.asarray(link_caps, float)
    inc = np.zeros((n_cells, len(cap)), bool)
    for link in range(len(cap)):
        users = rng.choice(n_cells - 1, size=rng.integers(1, n_cells - 1),
                           replace=False)
        inc[users, link] = True
    insts = []
    for c, pool in enumerate(pools):
        tasks = scen.numerical_tasks(
            int(rng.integers(4, 30)), ("low", "med", "high")[c % 3], "high",
            seed=seed + 31 * c)
        insts.append(build(pool, tasks, coupling=spec(cap, inc[c:c + 1])))
    return insts


_PORT = (scenarios, build_instance, CouplingSpec)
_REF = (JS, j_build, JCouplingSpec)


@pytest.mark.parametrize("semantic,flexible", QUADRANTS)
def test_coupled_oracle_matches_reference_and_the_coupled_batch(semantic,
                                                                flexible):
    for seed in (0, 2):
        jinsts, insts = _coupled(_REF, seed=seed), _coupled(_PORT, seed=seed)
        kw = dict(semantic=semantic, flexible=flexible)
        refs = solve_coupled_ref(insts, **kw)
        for r, o in zip(j_coupled_ref(jinsts, **kw), refs):
            _same(r, o)
        # the port's coupled batch against its own oracle, as the reference
        # suite holds its batch (f32 engine vs f64 oracle: allclose)
        for sol, ref in zip(solve_greedy_batch(stack_instances(insts),
                                               device="cpu", **kw), refs):
            assert np.array_equal(sol.admitted, ref.admitted)
            assert np.allclose(sol.alloc, ref.alloc)
            assert np.allclose(sol.z, ref.z)
            assert sol.objective == pytest.approx(ref.objective)


def test_coupled_oracle_rejects_a_mismatched_spec():
    insts = _coupled(_PORT)
    with pytest.raises(ValueError, match="cells"):
        solve_coupled_ref(insts, CouplingSpec(np.ones(1),
                                              np.ones((2, 1), bool)))


@pytest.mark.parametrize("flexible", [True, False])
def test_solve_greedy_many_mixed_grids_matches_reference(flexible):
    jinsts, _ = JS.multi_cell_trace(4, 8, seed=1, n_grids=2)
    insts, _ = scenarios.multi_cell_trace(4, 8, seed=1, n_grids=2)
    assert len({i.grid.shape for i in insts}) == 2
    refs = j_many(jinsts, flexible=flexible)
    outs = solve_greedy_many(insts, flexible=flexible, device="cpu")
    for jinst, inst, r, o in zip(jinsts, insts, refs, outs):
        _same_instance(jinst, inst)
        _same(r, o)


def test_solve_greedy_many_rejects_links_across_grids():
    pools = scenarios.multi_cell_pools(2, seed=0, n_grids=2)
    spec = CouplingSpec(np.array([3.0]), np.ones((2, 1), bool))
    insts = [build_instance(p, scenarios.numerical_tasks(5, "med", "high",
                                                         seed=i),
                            coupling=spec.row(i))
             for i, p in enumerate(pools)]
    with pytest.raises(ValueError, match="grid"):
        solve_greedy_many(insts, device="cpu")


# --------------------------------------------------------------- exact

def _small_pool(cls, seed):
    rng = np.random.default_rng(seed)
    cap = rng.integers(4, 9, size=2).astype(float)
    return cls(names=("rbg", "gpu"), capacity=cap, price=1.0 / cap,
               levels=(np.arange(1.0, cap[0] + 1), np.arange(1.0, cap[1] + 1)))


@pytest.mark.parametrize("seed", range(3))
def test_solve_exact_matches_reference(seed):
    kw = dict(seed=seed, jobs_per_sec=3.0)
    jinst = j_build(_small_pool(JResourcePool, seed),
                    JS.numerical_tasks(6, "med", "high", **kw))
    inst = build_instance(_small_pool(ResourcePool, seed),
                          scenarios.numerical_tasks(6, "med", "high", **kw))
    for semantic in (True, False):
        ref = j_exact(jinst, semantic=semantic)
        out = solve_exact(inst, semantic=semantic)
        _same(ref, out)
        greedy_obj = greedy.solve_greedy(inst, semantic=semantic).objective
        assert out.objective + 1e-9 >= greedy_obj


# ---------------------------------------------------------- SESM.slice

def _requests(cls, fps_levels=(10.0, 7.0, 5.0, 3.0)):
    """Fig. 7's three slices at each fps period, plus a mixed cell."""
    periods = [[cls("object-recognition", "yolox", app, max_latency_s=0.7,
                    min_accuracy=acc, jobs_per_sec=fps)
                for app, acc in (("coco_bags", 0.30), ("coco_animals", 0.50),
                                 ("cityscapes_flat", 0.30))]
               for fps in fps_levels]
    mix = [("coco_person", 0.2, 5.0), ("cityscapes_vehicles", 0.35, 8.0),
           ("cityscapes_person", 0.5, 4.0), ("coco_bags", 0.35, 6.0)]
    periods.append([cls("object-recognition", "yolox", app,
                        max_latency_s=0.7, min_accuracy=acc,
                        jobs_per_sec=fps) for app, acc, fps in mix * 3])
    return periods


@pytest.mark.parametrize("semantic,flexible", QUADRANTS)
def test_sesm_slice_matches_reference(semantic, flexible):
    jsesm = JSESM(JS.colosseum_pool(), backend="jax")
    sesm = SESM(scenarios.colosseum_pool(), backend="torch", device="cpu")
    jnp_sesm = SESM(scenarios.colosseum_pool(), device="cpu")
    for s in (jsesm, sesm, jnp_sesm):
        s.algorithm = {"semantic": semantic, "flexible": flexible}
    for jreqs, reqs in zip(_requests(JRequest), _requests(SliceRequest)):
        ref = jsesm.slice(jreqs)
        for out in (sesm.slice(reqs), jnp_sesm.slice(reqs)):
            assert len(out) == len(ref)
            for r, o in zip(ref, out):
                assert (r.admitted, r.z, r.alloc, r.expected_latency_s,
                        r.expected_accuracy) == \
                    (o.admitted, o.z, o.alloc, o.expected_latency_s,
                     o.expected_accuracy)


# ------------------------------------------------------------ scenarios

def test_static_and_sweep_generators_match_reference():
    for args in ((13, "low", "high", 0), (40, "high", "low", 5)):
        r, o = JS.numerical_tasks(*args), scenarios.numerical_tasks(*args)
        for f in dataclasses.fields(r):
            assert np.array_equal(getattr(r, f.name), getattr(o, f.name))
    for r, o in zip(JS.fig6_sweep(4, n_tasks=(10, 20), seeds=(0, 2))[0],
                    scenarios.fig6_sweep(4, n_tasks=(10, 20),
                                         seeds=(0, 2))[0]):
        _same_instance(r, o)
    assert JS.fig6_sweep(2)[1] == scenarios.fig6_sweep(2)[1]
    for fps in (10.0, 3.0):
        _same_instance(j_build(JS.colosseum_pool(), JS.colosseum_tasks(fps)),
                       build_instance(scenarios.colosseum_pool(),
                                      scenarios.colosseum_tasks(fps)))
    for seed in (None, 4):
        tr = scenarios.fps_trace(6, seed=seed)
        assert np.array_equal(tr, JS.fps_trace(6, seed=seed))
        for r, o in zip(JS.fps_trace_instances(tr, min_acc=0.35),
                        scenarios.fps_trace_instances(tr, min_acc=0.35)):
            _same_instance(r, o)
    for kw in (dict(seed=1), dict(seed=2, lm_fraction=0.5)):
        r = JS.mixed_workload_tasks(30, **kw)
        o = scenarios.mixed_workload_tasks(30, **kw)
        for f in dataclasses.fields(r):
            assert np.array_equal(getattr(r, f.name), getattr(o, f.name))


def test_trace_generators_match_reference():
    for kw in (dict(seed=3), dict(seed=4, lm_fraction=0.3)):
        (ri, ra), (oi, oa) = (JS.poisson_trace(8, **kw),
                              scenarios.poisson_trace(8, **kw))
        assert all(np.array_equal(a, b) for a, b in zip(ra, oa))
        for r, o in zip(ri, oi):
            _same_instance(r, o)
    for kw in (dict(seed=2, n_grids=2), dict(seed=5, shared_backhaul=3.0)):
        (ri, rm), (oi, om) = (JS.multi_cell_trace(3, 4, **kw),
                              scenarios.multi_cell_trace(3, 4, **kw))
        assert rm == om
        for r, o in zip(ri, oi):
            _same_instance(r, o)


def test_closed_loop_trace_matches_reference():
    kw = dict(seed=6, handover_prob=0.3, shared_backhaul=4.0)
    assert scenarios.closed_loop_trace(3, 5, device="cpu", **kw) == \
        JS.closed_loop_trace(3, 5, **kw)
    assert scenarios.closed_loop_trace(2, 4, seed=1, flexible=False,
                                       device="cpu") == \
        JS.closed_loop_trace(2, 4, seed=1, flexible=False)


def _events(sched):
    return {step: [(type(e).__name__, dataclasses.asdict(e)) for e in evs]
            for step, evs in sched.items()}


def test_fault_schedules_match_reference():
    pairs = [
        ("arrival_events", (4, 6), dict(seed=2)),
        ("outage_schedule", ([(0, 1, 3), (2, 2, 9)],), {}),
        ("random_outage_schedule", (5, 12),
         dict(n_outages=3, seed=4, spare_cells=(1,))),
        ("stepped_link_degradation", (10,), dict(start=2, floor=0.4)),
        ("semantic_drift_schedule", (10,), dict(apps=[1, 3], start=1)),
        ("flash_crowd", (3, 8), dict(step=2, cells=[0, 2], seed=5)),
    ]
    built = {}
    for name, args, kw in pairs:
        ref, out = (_events(getattr(JS, name)(*args, **kw)),
                    _events(getattr(scenarios, name)(*args, **kw)))
        assert ref == out, name
        built[name] = (getattr(JS, name)(*args, **kw),
                       getattr(scenarios, name)(*args, **kw))
    names = ("outage_schedule", "stepped_link_degradation", "flash_crowd")
    assert _events(JS.compose_faults(*(built[n][0] for n in names))) == \
        _events(scenarios.compose_faults(*(built[n][1] for n in names)))
    with pytest.raises(ValueError):
        scenarios.outage_schedule([(0, 3, 3)])
