"""The PyTorch port's core against the JAX reference, on the CPU.

Every input is built by the reference (``repro.core.scenarios``) or from
seeded numpy, handed to the port through ``repro_torch.convert``, and the
port must reproduce the reference's host tables value for value and its
solver decisions (admitted, alloc, z) exactly, in all four (semantic ×
flexible) quadrants, coupled and uncoupled.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (CouplingSpec as JCouplingSpec,  # noqa: E402
                        TaskSet as JTaskSet, build_instance as j_build,
                        empty_device_stack as j_empty, scenarios as JS,
                        semantics as JSem, solve_device_batch as j_solve_dev,
                        solve_greedy as j_oracle,
                        solve_greedy_batch as j_batch,
                        stack_instances as j_stack)
from repro.core.sfesp import _solver_tables as j_tables  # noqa: E402
from repro.core import latency as JLat  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import (CouplingSpec, TaskSet,  # noqa: E402
                              build_instance, device_stack,
                              dispatch_device_batch, empty_device_stack,
                              restack, run_algorithm, scenarios, semantics,
                              solve, solve_device_batch, solve_greedy,
                              solve_greedy_batch, solve_greedy_many,
                              solve_greedy_torch, stack_instances,
                              unpack_device_batch)
from repro_torch.core import latency as PLat  # noqa: E402
from repro_torch.core.sfesp import _solver_tables  # noqa: E402


@pytest.fixture
def rng():
    """A generator seeded in each test: ``tests/conftest.py``'s ``rng`` is
    shared by the session, so its draws would depend on which tests ran
    before in the same worker."""
    return np.random.default_rng(0)


def record(inst):
    """A reference ProblemInstance as the plain arrays ``convert`` takes."""
    p, t, c = inst.pool, inst.tasks, inst.coupling
    return dict(
        pool=dict(names=p.names, capacity=p.capacity, price=p.price,
                  levels=p.levels),
        tasks={f.name: getattr(t, f.name) for f in dataclasses.fields(t)},
        z_grid=inst.z_grid, acc=inst.acc, acc_agnostic=inst.acc_agnostic,
        grid=inst.grid, lat=inst.lat, lat_agnostic=inst.lat_agnostic,
        z_star_idx=inst.z_star_idx,
        z_star_idx_agnostic=inst.z_star_idx_agnostic,
        coupling=None if c is None else dict(
            link_capacity=c.link_capacity, incidence=c.incidence,
            names=c.names),
        model_source=inst.semantics,
        model_params=None if inst.semantics is None
        else inst.semantics.params)


def to_port(insts):
    conv = convert.Converter()
    return [conv.instance(**record(i)) for i in insts]


def _scenario(name):
    if name == "fig6":
        return JS.fig6_sweep(2, n_tasks=(10, 30, 50), seeds=(0, 1))[0]
    if name == "fig6_m4":
        return JS.fig6_sweep(4, n_tasks=(10, 30), seeds=(0,))[0]
    if name == "poisson":
        return JS.poisson_trace(10, seed=2, arrival_rate=5.0)[0]
    if name == "multicell_coupled":
        return JS.multi_cell_trace(4, 5, seed=3, shared_backhaul=2.0)[0]
    raise KeyError(name)


def _same_solutions(ref, out):
    assert len(ref) == len(out)
    for i, (r, o) in enumerate(zip(ref, out)):
        assert np.array_equal(r.admitted, o.admitted), i
        assert np.array_equal(r.alloc, o.alloc), i
        assert np.array_equal(r.z, o.z), i
        assert np.array_equal(r.satisfied, o.satisfied), i
        assert r.objective == o.objective, i


# ------------------------------------------------------------ host tables

def test_semantic_tables_match_reference():
    assert np.array_equal(semantics.DEFAULT_MODEL.params,
                          JSem.DEFAULT_MODEL.params)
    assert [a.name for a in semantics.APPS] == [a.name for a in JSem.APPS]
    z = np.geomspace(0.02, 1.0, 64)
    apps = np.arange(len(JSem.APPS))
    assert np.array_equal(semantics.DEFAULT_MODEL.accuracy_table(apps, z),
                          JSem.DEFAULT_MODEL.accuracy_table(apps, z))
    acc = np.linspace(0.1, 0.8, len(apps))
    assert np.array_equal(
        semantics.DEFAULT_MODEL.min_z_for_accuracy(apps, acc, z),
        JSem.DEFAULT_MODEL.min_z_for_accuracy(apps, acc, z))
    m, jm = semantics.SemanticModel.paper_default(), \
        JSem.SemanticModel.paper_default()
    m.scale_asymptotes([1, 3], 0.8)
    jm.scale_asymptotes([1, 3], 0.8)
    assert np.array_equal(m.params, jm.params)
    assert m.changed_since(0) == jm.changed_since(0)
    assert semantics.SERVICE_BITS_PER_JOB == JSem.SERVICE_BITS_PER_JOB
    assert semantics.SERVICE_GPU_TIME == JSem.SERVICE_GPU_TIME


def test_latency_and_groups_match_reference(rng):
    alloc = rng.uniform(0, 16, (50, 4))
    args = (rng.uniform(0.1, 1, 50), rng.uniform(1, 10, 50),
            rng.uniform(0.02, 0.2, 50), rng.uniform(0.02, 1, 50))
    for m in (2, 4):
        assert np.array_equal(
            PLat.latency(PLat.LatencyParams(), *args, alloc[:, :m]),
            JLat.latency(JLat.LatencyParams(), *args, alloc[:, :m]))
    inc = rng.random((12, 5)) < 0.2
    assert np.array_equal(CouplingSpec(np.ones(5), inc).groups(),
                          JCouplingSpec(np.ones(5), inc).groups())


@pytest.mark.parametrize("name", ["fig6", "poisson", "multicell_coupled"])
def test_stacked_tables_match_reference(name):
    insts = _scenario(name)
    ref = j_stack(insts, tmax=64)
    out = stack_instances(to_port(insts), tmax=64)
    for f in ("grid", "capacity", "price", "lat", "lat_agnostic",
              "z_star_idx", "z_star_idx_agnostic", "z_star",
              "z_star_agnostic", "app_idx", "min_accuracy", "max_latency",
              "task_mask", "num_tasks", "link_load", "link_load_agnostic"):
        assert np.array_equal(getattr(ref, f), getattr(out, f)), f
    if ref.coupling is None:
        assert out.coupling is None
    else:
        assert np.array_equal(ref.coupling.incidence, out.coupling.incidence)
        assert np.array_equal(ref.coupling.link_capacity,
                              out.coupling.link_capacity)
    for r, o in zip(j_tables(ref, True), _solver_tables(out, True)):
        assert np.array_equal(r, o)


def test_build_instance_matches_reference():
    pool = JS.numerical_pool(2)
    tasks = JS.numerical_tasks(25, "med", "low", seed=4)
    ref = j_build(pool, tasks)
    out = build_instance(
        convert.resource_pool(pool.names, pool.capacity, pool.price,
                              pool.levels),
        convert.task_set(**{f.name: getattr(tasks, f.name)
                            for f in dataclasses.fields(tasks)}))
    for f in ("z_grid", "acc", "acc_agnostic", "grid", "lat",
              "lat_agnostic", "z_star_idx", "z_star_idx_agnostic"):
        assert np.array_equal(getattr(ref, f), getattr(out, f)), f


# ----------------------------------------------------------------- solver

def test_numpy_oracle_matches_reference():
    insts = _scenario("fig6")[::5]
    for inst, pinst in zip(insts, to_port(insts)):
        for sem in (True, False):
            for flex in (True, False):
                _same_solutions(
                    [j_oracle(inst, semantic=sem, flexible=flex)],
                    [solve_greedy(pinst, semantic=sem, flexible=flex)])


@pytest.mark.parametrize("name", ["fig6", "fig6_m4", "poisson",
                                  "multicell_coupled"])
@pytest.mark.parametrize("semantic,flexible", [(True, True), (True, False),
                                               (False, True),
                                               (False, False)])
def test_batch_solve_matches_reference(name, semantic, flexible):
    insts = _scenario(name)
    ref = j_batch(insts, semantic=semantic, flexible=flexible)
    out = solve_greedy_batch(to_port(insts), semantic=semantic,
                             flexible=flexible, device="cpu")
    _same_solutions(ref, out)


def test_batch_solve_padded_batch_matches_reference():
    insts = _scenario("multicell_coupled")
    ref = j_batch(insts, pad_batch_to=32)
    out = solve_greedy_batch(to_port(insts), pad_batch_to=32, device="cpu")
    _same_solutions(ref, out)


def test_solve_reports_rounds_and_syncs():
    st = stack_instances(to_port(_scenario("fig6")))
    res = solve_device_batch(device_stack(st, device="cpu"))
    # one convergence test per _SYNC_EVERY rounds, plus the read-back
    from repro_torch.core.greedy import _SYNC_EVERY
    assert res["rounds"] % _SYNC_EVERY == 0 and res["rounds"] > 0
    assert res["syncs"] == res["rounds"] // _SYNC_EVERY + 2


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA default does not raise")
    insts = to_port(_scenario("fig6")[:2])
    st = stack_instances(insts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_greedy_batch(st)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_stack(st)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_greedy_torch(insts[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve(insts[0], backend="torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_algorithm("sem-o-ran", insts[0], backend="torch")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve_greedy_many(insts)


# ------------------------------------------------------------ device stack

TMAX = 16
_APPS = ["coco_bags", "coco_animals", "cityscapes_flat", "coco_person"]


def _task_bag(rng, n=40):
    return [dict(app=_APPS[int(rng.integers(len(_APPS)))],
                 acc=float(rng.uniform(0.2, 0.55)),
                 lat=float(rng.uniform(0.5, 0.9)),
                 fps=float(rng.uniform(3.0, 9.0)))
            for _ in range(n)]


def _task_set(tasks, cls, sem):
    return cls(
        app_idx=np.array([sem.APP_INDEX[t["app"]] for t in tasks], np.int64),
        min_accuracy=np.array([t["acc"] for t in tasks]),
        max_latency=np.array([t["lat"] for t in tasks]),
        bits_per_job=np.full(len(tasks), 0.8),
        jobs_per_sec=np.array([t["fps"] for t in tasks]),
        gpu_time_per_job=np.full(len(tasks), 0.06),
        n_ues=np.ones(len(tasks), np.int64))


_PORT = (TaskSet, semantics, build_instance, stack_instances, _solver_tables)
_REF = (JTaskSet, JSem, j_build, j_stack, j_tables)


def _scatter_dirty(dev, pools, slots, dirty, pkg):
    """Recompute only the dirty rows with ``pkg``'s own pipeline and
    delta-scatter them (the serving ``_sync_rows`` path)."""
    ts_cls, sem, build, stack, tables = pkg
    A = dev.grid.shape[0]
    bb, tt, lat_ok, alive, load = [], [], [], [], []
    for b, t in dirty:
        bb.append(b)
        tt.append(t)
        task = slots[b][t]
        if task is None:
            lat_ok.append(np.zeros(A, bool))
            alive.append(False)
            load.append(0.0)
            continue
        inst = build(pools[b], _task_set([task], ts_cls, sem))
        lok, alv, _ = tables(stack([inst]), True)
        lat_ok.append(lok[0, 0])
        alive.append(bool(alv[0, 0]))
        zi = int(inst.z_star_idx[0])
        load.append(0.8 * task["fps"] * (inst.z_grid[zi] if zi >= 0 else 1.0))
    dev.update_rows(np.array(bb), np.array(tt), np.stack(lat_ok),
                    np.array(alive), np.array(load))


@pytest.mark.parametrize("coupled", [False, True])
def test_update_rows_churn_matches_fresh_stack_and_reference(coupled):
    """Randomized arrival/departure/handover churn, scattered into the
    port's and the reference's device stacks alike: after every step the
    port's delta-scattered stack solves exactly as a fresh port stack of the
    compacted sets AND as the reference's delta-scattered stack."""
    rng = np.random.default_rng(7)
    jpools = JS.multi_cell_pools(4, seed=1)
    pools = scenarios.multi_cell_pools(4, seed=1)
    spec = CouplingSpec(np.array([4.0]), np.ones((4, 1), bool)) \
        if coupled else None
    jspec = JCouplingSpec(np.array([4.0]), np.ones((4, 1), bool)) \
        if coupled else None
    bag = _task_bag(rng)
    slots = [[None] * TMAX for _ in range(4)]
    price = np.stack([p.price for p in pools])
    cap = np.stack([p.capacity for p in pools])
    grid = build_instance(pools[0], _task_set(bag[:1], TaskSet,
                                              semantics)).grid
    dev = empty_device_stack(grid, price, cap, TMAX, coupling=spec,
                             device="cpu")
    jdev = j_empty(grid, price, cap, TMAX, coupling=jspec)

    def place(b, task):
        t = slots[b].index(None)
        slots[b][t] = task
        return (b, t)

    dirty = [place(b, bag[int(rng.integers(len(bag)))])
             for b in range(4) for _ in range(4)]
    for step in range(6):
        _scatter_dirty(dev, pools, slots, dirty, _PORT)
        _scatter_dirty(jdev, jpools, slots, dirty, _REF)
        res = solve_device_batch(dev)
        jres = j_solve_dev(jdev)
        assert np.array_equal(res["admitted"], jres["admitted"]), step
        adm = res["admitted"]
        assert np.array_equal(res["alloc_idx"][adm], jres["alloc_idx"][adm])
        assert np.array_equal(res["link_used"], np.asarray(jres["link_used"]))
        insts = []
        for b, pool in enumerate(pools):
            inst = build_instance(pool, _task_set(
                [t for t in slots[b] if t is not None], TaskSet, semantics))
            if spec is not None:
                inst = dataclasses.replace(inst, coupling=spec.row(b))
            insts.append(inst)
        fresh = solve_greedy_batch(stack_instances(insts, tmax=TMAX),
                                   device="cpu")
        for b in range(4):
            live = [t for t, task in enumerate(slots[b]) if task is not None]
            assert np.array_equal(res["admitted"][b, live],
                                  fresh[b].admitted), (step, b)
        dirty = []
        for b in range(4):
            live = [t for t, task in enumerate(slots[b]) if task is not None]
            if len(live) > 2 and rng.random() < 0.8:
                t = live[int(rng.integers(len(live)))]
                slots[b][t] = None
                dirty.append((b, t))
            if rng.random() < 0.8:
                dirty.append(place(b, bag[int(rng.integers(len(bag)))]))
        src = int(rng.integers(4))
        live = [t for t, task in enumerate(slots[src]) if task is not None]
        if live:
            t = live[0]
            task, slots[src][t] = slots[src][t], None
            dirty.append((src, t))
            dirty.append(place((src + 1) % 4, task))
    assert dev.rows_scattered == jdev.rows_scattered
    assert dev.scatter_calls == jdev.scatter_calls


def test_unpack_sees_the_rows_it_was_dispatched_with():
    """dispatch → scatter → unpack: the in-place scatter of tick N+1 lands
    after the dispatched solve in stream order, so the unpack reports the
    pre-scatter rows."""
    rng = np.random.default_rng(11)
    pools = scenarios.multi_cell_pools(2, seed=0)
    bag = _task_bag(rng, 12)
    slots = [[bag[i], bag[i + 1], bag[i + 2], None] for i in (0, 3)]
    price = np.stack([p.price for p in pools])
    cap = np.stack([p.capacity for p in pools])
    grid = build_instance(pools[0], _task_set(bag[:1], TaskSet,
                                              semantics)).grid
    dev = empty_device_stack(grid, price, cap, 4, device="cpu")
    every = [(b, t) for b in range(2) for t in range(4)]
    _scatter_dirty(dev, pools, slots, every, _PORT)
    before = solve_device_batch(dev)
    handle = dispatch_device_batch(dev)
    slots = [[None, None, bag[9], bag[10]], [bag[11], None, None, None]]
    _scatter_dirty(dev, pools, slots, every, _PORT)
    late = unpack_device_batch(handle)
    assert np.array_equal(late["admitted"], before["admitted"])
    assert before["admitted"][:, :3].any()
    after = solve_device_batch(dev)
    assert not after["admitted"][0, :2].any()


def test_update_rows_rejects_bucket_overflow_and_bad_cells():
    pools = scenarios.multi_cell_pools(1, seed=0)
    grid = build_instance(pools[0], _task_set(
        _task_bag(np.random.default_rng(0), 1), TaskSet, semantics)).grid
    dev = empty_device_stack(grid, pools[0].price[None],
                             pools[0].capacity[None], 4, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        dev.update_rows(np.array([0]), np.array([4]),
                        np.zeros((1, grid.shape[0]), bool), np.zeros(1, bool))
    with pytest.raises(ValueError, match="outside"):
        dev.update_rows(np.array([1]), np.array([0]),
                        np.zeros((1, grid.shape[0]), bool), np.zeros(1, bool))
    with pytest.raises(ValueError, match="uncoupled"):
        dev.update_link_budgets(np.ones(1))


def test_device_half_memoized_and_invalidated_by_restack():
    insts = to_port(JS.fig6_sweep(2, n_tasks=(6, 8), acc_levels=("low",),
                                  lat_levels=("low",), seeds=(0,))[0])
    st = stack_instances(insts)
    d1 = device_stack(st, device="cpu")
    assert device_stack(st, device="cpu") is d1
    assert device_stack(st, semantic=False, device="cpu") is not d1
    st2 = restack(st, insts[::-1])
    assert device_stack(st2, device="cpu") is not d1
    for inst, sol in zip(insts[::-1], solve_greedy_batch(st2, device="cpu")):
        assert np.array_equal(sol.admitted, solve_greedy(inst).admitted)


def test_update_link_budgets_in_place():
    insts = _scenario("multicell_coupled")
    st = stack_instances(to_port(insts))
    dev = device_stack(st, device="cpu")
    buf = dev.link_cap
    dev.update_link_budgets(np.full(buf.shape[0], 0.5))
    assert dev.link_cap is buf and dev.budget_updates == 1
    jst = j_stack(insts)
    from repro.core import device_stack as j_device_stack
    jdev = j_device_stack(jst)
    jdev.update_link_budgets(np.full(buf.shape[0], 0.5))
    res, jres = solve_device_batch(dev), j_solve_dev(jdev)
    assert np.array_equal(res["admitted"], jres["admitted"])


# -------------------------------------------------------------- scenarios

def test_scenario_generators_match_reference():
    for m in (2, 4):
        p, jp = scenarios.numerical_pool(m), JS.numerical_pool(m)
        assert p.names == jp.names
        assert np.array_equal(p.capacity, jp.capacity)
        assert all(np.array_equal(a, b) for a, b in zip(p.levels, jp.levels))
    for seed in (0, 1):
        for p, jp in zip(scenarios.multi_cell_pools(9, seed=seed),
                         JS.multi_cell_pools(9, seed=seed)):
            assert np.array_equal(p.capacity, jp.capacity)
            assert np.array_equal(p.price, jp.price)
    assert scenarios.closed_loop_arrivals(5, 6, seed=3) == \
        JS.closed_loop_arrivals(5, 6, seed=3)
    assert scenarios.ACC_THRESHOLDS == JS.ACC_THRESHOLDS
    assert scenarios.LAT_THRESHOLDS == JS.LAT_THRESHOLDS


def test_metro_diurnal_trace_matches_reference():
    kw = dict(n_domains=4, hours=(3, 13), seed=5)
    insts, meta = scenarios.metro_diurnal_trace(16, **kw)
    jinsts, jmeta = JS.metro_diurnal_trace(16, **kw)
    assert meta == jmeta
    st = stack_instances(insts)
    jst = j_stack(jinsts)
    for f in ("lat", "z_star_idx", "min_accuracy", "task_mask", "link_load",
              "capacity"):
        assert np.array_equal(getattr(st, f), getattr(jst, f)), f
    assert np.array_equal(st.coupling.incidence, jst.coupling.incidence)
    assert np.array_equal(st.coupling.link_capacity,
                          jst.coupling.link_capacity)
    _same_solutions(j_batch(jst), solve_greedy_batch(st, device="cpu"))
