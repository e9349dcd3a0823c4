"""The port's sharded layer and metro serving mode against the JAX
reference, on the CPU.

A shard is a block of batch rows on one device; the port's cells mesh
(``launch/mesh.py::make_cells_mesh``) may repeat a device, so the CPU runs
1, 3 and 8 shards. Held here: the group-major layout and the shard plan,
array for array against the reference's own functions; the sharded solve,
bit for bit against the port's single-device solve, the reference's jitted
batch solve and ``solve_coupled_ref``; two shards on one device, pushed
through the group-by-group model of K1 (``tests/test_torch_solve.py``), so
the group ids K1 would read are checked without a card; the sharded
stack's guards; and the mesh-resident metro session against the port's
meshless engine and the reference's meshless engine (the reference's own
mesh session fails on this jax) through churn, an outage, budget drift and
semantic drift, counters included. One subprocess with eight fake host
devices holds the port's layout and decisions against the reference's
``device_stack_sharded`` / ``solve_greedy_sharded`` on 3 and 8 devices.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro.core import scenarios as JS  # noqa: E402
from repro.core import sfesp as JF  # noqa: E402
from repro.serving import MultiCellEngine as JEngine  # noqa: E402
from repro.serving import SliceRequest as JRequest  # noqa: E402

from repro_torch.core import (CouplingSpec, device_stack,  # noqa: E402
                              device_stack_sharded, empty_device_stack,
                              empty_sharded_stack, group_major_order,
                              group_offsets_of, restack, scenarios,
                              shard_plan, solve_coupled_ref,
                              solve_device_batch, solve_greedy_batch,
                              solve_greedy_sharded, solve_sharded_batch,
                              stack_instances)
from repro_torch.core import sfesp as PF  # noqa: E402
from repro_torch.core.sfesp import _solver_tables, group_csr  # noqa: E402
from repro_torch.launch.mesh import CellsMesh, make_cells_mesh  # noqa: E402
from repro_torch.serving import MultiCellEngine, SliceRequest  # noqa: E402
from repro_torch.serving.admission import SESM  # noqa: E402

from test_torch_solve import _cluster_model  # noqa: E402

SHARDS = (1, 3, 8)


def _metro(pkg, seed=0):
    """The issue's metro trace: 32 cells in 4 domains of 8 at 13:00."""
    return pkg.metro_diurnal_trace(32, n_domains=4, hours=(13,),
                                   seed=seed)


def _batch(pkg, kind):
    if kind == "metro":
        return _metro(pkg)[0]
    return pkg.multi_cell_trace(4, 3, seed=7)[0]        # uncoupled


def _mesh(n):
    return make_cells_mesh(n, devices=["cpu"])


def _same(a, b):
    assert np.array_equal(a.admitted, b.admitted)
    assert np.array_equal(a.alloc, b.alloc)
    assert np.array_equal(a.z, b.z)
    # the sharded front door stacks at a pow2 Tmax, which regroups numpy's
    # objective sum over the padded task axis (the reference's own test
    # of this comparison allows the same)
    assert abs(a.objective - b.objective) < 1e-9


# ------------------------------------------------------------------ mesh

def test_make_cells_mesh_repeats_devices_and_needs_a_card_by_default():
    mesh = _mesh(8)
    assert isinstance(mesh, CellsMesh)
    assert mesh.shape["cells"] == 8 and mesh.axis_names == ("cells",)
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.distinct() == (torch.device("cpu"),)
    assert make_cells_mesh(devices=["cpu"]).shape["cells"] == 1
    assert hash(mesh) == hash(_mesh(8)) and mesh == _mesh(8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_cells_mesh()
    with pytest.raises(ValueError):
        make_cells_mesh(0, devices=["cpu"])


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("kind", ["metro", "uncoupled"])
def test_group_major_order_and_offsets_match_reference(kind):
    ref, port = _batch(JS, kind), _batch(scenarios, kind)
    order = group_major_order(port)
    assert np.array_equal(order, J.group_major_order(ref))
    regrouped = stack_instances([port[i] for i in order])
    j_regrouped = J.stack_instances([ref[i] for i in order])
    assert np.array_equal(
        group_offsets_of(regrouped.coupling, len(port)),
        J.group_offsets_of(j_regrouped.coupling, len(ref)))


def test_group_offsets_rejects_an_interleaved_batch():
    ref, _ = JS.multi_cell_trace(2, 2, seed=11, shared_backhaul=2.0)
    port, _ = scenarios.multi_cell_trace(2, 2, seed=11, shared_backhaul=2.0)
    idx = [0, 2, 1, 3]                                  # groups 0, 1, 0, 1
    st = stack_instances([port[i] for i in idx])
    with pytest.raises(ValueError, match="not group-major"):
        group_offsets_of(st.coupling, 4)
    with pytest.raises(ValueError, match="not group-major"):
        J.group_offsets_of(J.stack_instances([ref[i] for i in idx])
                           .coupling, 4)


@pytest.mark.parametrize("kind", ["metro", "uncoupled"])
@pytest.mark.parametrize("n", SHARDS)
def test_shard_plan_and_layout_match_reference(kind, n):
    jst = J.stack_instances(_batch(JS, kind), group_major=True)
    st = stack_instances(_batch(scenarios, kind), group_major=True)
    order, offsets = PF._group_major_view(st)
    j_order, j_offsets = JF._group_major_view(jst)
    assert np.array_equal(order, j_order)
    assert np.array_equal(offsets, j_offsets)
    shards, loads = shard_plan(offsets, n)
    j_shards, j_loads = J.shard_plan(j_offsets, n)
    assert shards == j_shards and np.array_equal(loads, j_loads)
    got = PF._plan_layout(order, offsets, n)
    want = JF._plan_layout(j_order, j_offsets, n)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # the port's sharded stack carries exactly those arrays
    shd = device_stack_sharded(st, _mesh(n))
    for g, w in zip((shd.row_of, shd.group, shd.padded_of, shd.shard_rows,
                     shd.groups_per_shard), want):
        assert np.array_equal(g, w)
    assert shd.num_shards == n and len(shd.stacks) == 1
    # a plainly stacked batch presents the same view
    plain = stack_instances(_batch(scenarios, kind))
    assert np.array_equal(PF._group_major_view(plain)[1], offsets)


def test_issue_layout_numbers_for_three_shards():
    shd = device_stack_sharded(
        stack_instances(_metro(scenarios)[0], group_major=True), _mesh(3))
    assert list(shd.row_of[:12]) == list(range(8)) + [24, 25, 26, 27]
    assert shd.shard_rows == 16
    assert list(shd.groups_per_shard) == [2, 1, 1]


def _host_tables(st):
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
            if isinstance(getattr(st, f.name), np.ndarray)}


def test_group_major_stack_and_restack_match_reference():
    ref, port = _metro(JS)[0], _metro(scenarios)[0]
    jst = J.stack_instances(ref, group_major=True)
    st = stack_instances(port, group_major=True)
    assert st.group_major and st.num_groups == 4
    want = _host_tables(jst)
    got = _host_tables(st)
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert np.array_equal(st.coupling.incidence, jst.coupling.incidence)
    # restack with a batch of another topology: the layout is re-derived
    ref2, _ = JS.metro_diurnal_trace(32, n_domains=8, hours=(9,), seed=4)
    port2, _ = scenarios.metro_diurnal_trace(32, n_domains=8, hours=(9,),
                                             seed=4)
    tmax = max(st.max_tasks, max(i.num_tasks for i in port2))
    st = stack_instances(port, group_major=True, tmax=tmax)
    jst = J.stack_instances(ref, group_major=True, tmax=tmax)
    st2, jst2 = restack(st, port2), J.restack(jst, ref2)
    assert st2.group_major and st2.num_groups == 8
    want, got = _host_tables(jst2), _host_tables(st2)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    # the old batch's layout is gone: perm follows the NEW topology
    assert np.array_equal(st2.perm, group_major_order(port2))


def test_device_stack_sharded_matches_the_reference_on_a_jax_mesh():
    from repro.launch.mesh import make_cells_mesh as j_mesh
    jst = J.stack_instances(_metro(JS)[0], group_major=True)
    jshd = J.device_stack_sharded(jst, j_mesh(1))
    shd = device_stack_sharded(
        stack_instances(_metro(scenarios)[0], group_major=True), _mesh(1))
    assert np.array_equal(shd.row_of, jshd.row_of)
    assert np.array_equal(shd.group, np.asarray(jshd.group))
    assert np.array_equal(shd.padded_of, jshd.padded_of)
    assert shd.shard_rows == jshd.shard_rows
    assert np.array_equal(shd.groups_per_shard, jshd.groups_per_shard)
    dev = shd.stacks[0]
    assert np.array_equal(dev.lat_ok.numpy(), np.asarray(jshd.lat_ok))
    assert np.array_equal(dev.incidence.numpy(), np.asarray(jshd.incidence))
    assert np.array_equal(dev.capacity.numpy(),
                          np.asarray(jshd.capacity, np.float32))


# ----------------------------------------------------------------- solve

@pytest.mark.parametrize("kind", ["metro", "uncoupled"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_solve_matches_batch_reference_and_oracle(kind, n):
    ref, port = _batch(JS, kind), _batch(scenarios, kind)
    got = solve_greedy_sharded(port, mesh=_mesh(n))
    for a, b in zip(solve_greedy_batch(port, device="cpu"), got):
        _same(a, b)
    for a, b in zip(J.solve_greedy_batch(ref), got):
        assert np.array_equal(a.admitted, b.admitted)
        assert np.array_equal(a.alloc, b.alloc)
        assert np.array_equal(a.z, b.z)
    if kind == "metro":
        meta = _metro(scenarios)[1]
        for d in (0, 3):                                # sampled domains
            idxs = [i for i, m in enumerate(meta) if m["domain"] == d]
            for i, r in zip(idxs, solve_coupled_ref([port[i]
                                                     for i in idxs])):
                assert np.array_equal(got[i].admitted, r.admitted)
            for i, r in zip(idxs, J.solve_coupled_ref([ref[i]
                                                       for i in idxs])):
                assert np.array_equal(got[i].admitted, r.admitted)
        assert sum(int(s.admitted.sum()) for s in got) == 62


def test_sharded_solve_keeps_memo_and_routes_the_kernel(monkeypatch):
    """The sharded half is memoized on the batch; with the kernel route
    forced (CUDA's default) a flexible sharded solve is ONE ``batch_solve``
    call per distinct device, here one for eight shards."""
    from repro_torch.core import greedy
    from repro_torch.kernels.pg import pg as PK
    st = stack_instances(_metro(scenarios)[0], group_major=True)
    want = solve_greedy_sharded(st, mesh=_mesh(8))
    assert "_sharded_half" in st.__dict__
    shd = device_stack_sharded(st, _mesh(8))
    assert device_stack_sharded(st, _mesh(8)) is shd
    calls = []
    real = PK.batch_solve

    def counted(stack, **kw):
        calls.append(stack)
        return real(stack, **kw)
    monkeypatch.setattr(PK, "batch_solve", counted)
    monkeypatch.setattr(greedy, "resolve_inner", lambda inner, d: "kernel")
    got = solve_greedy_sharded(st, mesh=_mesh(8))
    assert len(calls) == 1 and calls[0] is shd.stacks[0]
    for a, b in zip(want, got):
        _same(a, b)
    res = solve_sharded_batch(shd)
    assert res["syncs"] == 1                    # one read-back a device
    assert len(calls) == 2


def test_two_shards_on_one_device_keep_their_groups_apart():
    """Local group ids repeat from shard to shard (each shard's first group
    is local 0); on a shared device the stack must hold device-global ids,
    or ``group_csr`` would merge groups of different shards into one K1
    cluster. The ids K1 would read go through the kernel's group-by-group
    model and decide as the single-device stack."""
    st = stack_instances(_metro(scenarios)[0], group_major=True)
    shd = device_stack_sharded(st, _mesh(3))
    dev = shd.stacks[0]
    rows = shd.shard_rows
    live = shd.row_of >= 0
    firsts = shd.group[np.arange(0, len(shd.group), rows)]
    assert (firsts == 0).all()                           # the collision
    gid = dev.group.numpy()
    assert np.array_equal(gid, (np.arange(len(gid)) // rows) * rows
                          + shd.group)
    assert np.array_equal(gid, CouplingSpec(
        dev.link_cap.numpy(), dev.incidence.numpy()).groups())
    merged = group_csr(dev.incidence.numpy(), shd.group, "cpu")
    assert dev.group_csr.num_groups == \
        len(np.unique(gid)) > merged.num_groups
    assert dev.group_csr.num_groups == 4 + int((~live).sum())
    # the kernel's model on the sharded stack against the meshless stack
    flat = device_stack(st, device="cpu")
    m_adm, m_alloc, m_occ, m_used, m_rounds = _cluster_model(dev)
    f_adm, f_alloc, f_occ, f_used, f_rounds = _cluster_model(flat)
    src = np.flatnonzero(live)
    dst = shd.row_of[live]
    assert torch.equal(m_adm[src], f_adm[dst])
    assert torch.equal(m_alloc[src], f_alloc[dst])
    assert torch.equal(m_occ[src], f_occ[dst])
    assert torch.equal(m_used, f_used)
    assert sorted(r for r in m_rounds if r) == sorted(f_rounds)
    # and the whole sharded solve agrees with it
    res = solve_sharded_batch(shd)
    assert np.array_equal(res["admitted"][dst], m_adm.numpy()[src])
    assert np.array_equal(res["link_used"], m_used.numpy())


# ------------------------------------------------------- stack surface

def _metro_spec(n_cells=4):
    half = n_cells // 2
    inc = np.zeros((n_cells, 2), bool)
    inc[:half, 0] = True
    inc[half:, 1] = True
    return CouplingSpec(np.array([1.0, 1.2]), inc)


def _req(cls, app, acc=0.30, fps=5.0):
    return cls("object-recognition", "yolox", app, max_latency_s=0.7,
               min_accuracy=acc, jobs_per_sec=fps)


def test_sharded_stack_update_guards():
    pools = scenarios.multi_cell_pools(4, seed=2)
    sesm = SESM(pools[0], device="cpu")
    grid = sesm.sdla.build_instance([_req(SliceRequest, "coco_bags")],
                                    pools[0]).grid
    price = np.stack([p.price for p in pools])
    cap = np.stack([p.capacity for p in pools])
    shd = empty_sharded_stack(grid, price, cap, 4, _mesh(3),
                              coupling=_metro_spec(4))
    A = grid.shape[0]
    row = (np.zeros((1, A), bool), np.zeros(1, bool), np.zeros(1))
    with pytest.raises(ValueError, match="larger"):
        shd.update_rows(np.array([0]), np.array([4]), *row)
    with pytest.raises(ValueError, match="outside"):
        shd.update_rows(np.array([4]), np.array([0]), *row)
    with pytest.raises(ValueError, match="outside"):
        shd.update_rows(np.array([-1]), np.array([0]), *row)
    with pytest.raises(ValueError, match="topology"):
        shd.update_link_budgets(np.ones(3))
    uncoupled = empty_sharded_stack(grid, price, cap, 4, _mesh(3))
    with pytest.raises(ValueError, match="uncoupled"):
        uncoupled.update_link_budgets(np.ones(2))
    assert shd.scatter_calls == 0 and shd.budget_updates == 0
    # round-trip address translation: every stacked row is reachable
    assert sorted(shd.row_of[shd.padded_of]) == list(range(4))


@pytest.mark.parametrize("n", SHARDS)
def test_empty_sharded_stack_scatter_matches_device_stack(n):
    """An empty ShardedStack filled by perm-addressed delta scatters solves
    as the single-device DeviceStack fed the same rows — row clears,
    budget updates and drift accounting included."""
    insts, _ = scenarios.multi_cell_trace(6, 2, seed=3, shared_backhaul=6.0)
    stacked = stack_instances(insts)
    spec = stacked.coupling
    shd = empty_sharded_stack(stacked.grid, stacked.price, stacked.capacity,
                              stacked.max_tasks, _mesh(n), coupling=spec)
    dev = empty_device_stack(stacked.grid, stacked.price, stacked.capacity,
                             stacked.max_tasks, coupling=spec, device="cpu")
    lat_ok, alive0, load = _solver_tables(stacked, True)
    bb, tt = np.nonzero(stacked.task_mask)

    def both(fn):
        fn(shd)
        fn(dev)
        a, b = solve_sharded_batch(shd), solve_device_batch(dev)
        for key in ("admitted", "alloc_idx", "residual", "link_used"):
            assert np.array_equal(a[key], b[key]), key
        return a

    a = both(lambda s: s.update_rows(bb, tt, lat_ok[bb, tt], alive0[bb, tt],
                                     load[bb, tt]))
    assert a["admitted"].any()
    assert shd.scatter_calls == 1 and shd.rows_scattered == len(bb)
    A = stacked.grid.shape[0]
    both(lambda s: s.update_rows(
        np.array([0, 3, 5]), np.zeros(3, np.int64),
        np.zeros((3, A), bool), np.zeros(3, bool), np.zeros(3)))
    both(lambda s: s.update_link_budgets(
        np.asarray(spec.link_capacity) * 0.5))
    assert shd.budget_updates == 1
    shd.update_semantics(bb[:2], tt[:2], lat_ok[bb[:2], tt[:2]],
                         alive0[bb[:2], tt[:2]], load[bb[:2], tt[:2]])
    assert shd.semantic_updates == 1 and shd.semantic_rows == 2


# ---------------------------------------------------------- metro session

def _counters(eng):
    s = eng.sesm
    return (s.fresh_stacks, s.session_rebuilds, s.delta_rows,
            s.link_updates, s.semantic_updates)


def _build16(engine_cls, spec_cls, scen, request_cls, **kw):
    pools = scen.multi_cell_pools(16, seed=2)
    inc = np.zeros((16, 4), bool)
    inc[np.arange(16), np.arange(16) // 4] = True
    eng = engine_cls(pools, coupling=spec_cls(np.array([1.0, 1.2, 0.9, 1.5]),
                                              inc), max_retries=3, **kw)
    for c in range(16):
        eng.submit(_req(request_cls, "coco_bags", 0.35, 8.0), c)
        eng.submit(_req(request_cls, "coco_animals", 0.50, 6.0), c)
    return eng


def test_metro_session_decides_as_both_meshless_engines():
    """A 16-cell engine on an 8-shard CPU mesh, the port's meshless engine
    and the reference's meshless engine, through churn, an outage, budget
    drift and semantic drift: the same decisions (admitted, z) at every
    tick and the same session counters; the metro session is
    mesh-resident and replans exactly once per fresh stack."""
    metro = _build16(MultiCellEngine, CouplingSpec, scenarios, SliceRequest,
                     mesh=_mesh(8))
    plain = _build16(MultiCellEngine, CouplingSpec, scenarios, SliceRequest,
                     device="cpu")
    ref = _build16(JEngine, J.CouplingSpec, JS, JRequest)
    engines = (metro, plain, ref)

    def tick():
        outs = [e.reslice() for e in engines]
        for cells in zip(*outs):
            want = [(d.admitted, d.z) for d in cells[-1]]
            for ds in cells[:-1]:
                assert [(d.admitted, d.z) for d in ds] == want
        return outs[0]

    first = tick()
    assert any(d.admitted for ds in first for d in ds)
    for e in engines:
        e.submit(_req(JRequest if e is ref else SliceRequest,
                      "coco_person"), 5)
    tick()
    for e in engines:
        e.fail_cell(9)
    tick()
    for e in engines:
        e.recover_cell(9)
        e.set_link_budgets(scale=0.6)
    tick()
    for e in engines:
        e.shift_semantics(scale=0.8)
    tick()
    sess = metro.sesm._serve_session
    assert isinstance(sess.dev, PF.ShardedStack)
    assert sess.dev.num_shards == 8 and len(sess.dev.stacks) == 1
    assert _counters(metro) == _counters(plain) == _counters(ref)
    assert metro.sesm.shard_replans == metro.sesm.fresh_stacks >= 1
    assert plain.sesm.shard_replans == 0
    assert metro.sesm.link_updates >= 1
    assert metro.sesm.semantic_updates >= 1
    assert metro.device == torch.device("cpu")


def test_metro_fastpath_matches_rebuild_and_oracle():
    """The 4-cell twin of the reference's metro test on a 3-shard mesh:
    the mesh-resident fast path == the meshless engine == the sharded
    rebuild path == the coupled oracle, decision for decision."""
    def build(mesh):
        pools = scenarios.multi_cell_pools(4, seed=2)
        spec = _metro_spec(4)
        kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
        eng = MultiCellEngine(pools, coupling=spec, max_retries=3, **kw)
        for c in range(4):
            eng.submit(_req(SliceRequest, "coco_bags", 0.35, 8.0), c)
            eng.submit(_req(SliceRequest, "coco_animals", 0.50, 6.0), c)
            eng.submit(_req(SliceRequest, "cityscapes_flat", 0.35, 5.0), c)
        return eng, pools, spec

    metro, pools, spec = build(_mesh(3))
    plain, _, _ = build(None)
    rebuild, _, _ = build(_mesh(3))

    def tick():
        sets = metro.gather()
        insts = [dataclasses.replace(
            metro.sdla.build_instance(rs, pools[i]), coupling=spec.row(i))
            for i, rs in enumerate(sets)]
        oracle = [[bool(a) for a in r.admitted]
                  for r in solve_coupled_ref(insts)]
        md, pd, rd = metro.reslice(), plain.reslice(), \
            rebuild.reslice_rebuild()
        for c, (m_ds, p_ds, r_ds) in enumerate(zip(md, pd, rd)):
            adm = [d.admitted for d in m_ds]
            assert adm == [d.admitted for d in p_ds]
            assert adm == [d.admitted for d in r_ds]
            assert [d.z for d in m_ds] == [d.z for d in p_ds]
            assert adm == oracle[c]

    tick()
    for eng in (metro, plain, rebuild):
        eng.submit(_req(SliceRequest, "coco_person", acc=0.30, fps=4.0), 1)
    tick()
    for eng in (metro, plain, rebuild):
        eng.fail_cell(3)
    tick()
    for eng in (metro, plain, rebuild):
        eng.recover_cell(3)
        eng.set_link_budgets(scale=0.6)
    tick()
    for eng in (metro, plain, rebuild):
        eng.shift_semantics(scale=0.8)
    tick()
    assert metro.sesm.shard_replans == metro.sesm.fresh_stacks
    assert metro.sesm.session_rebuilds == plain.sesm.session_rebuilds
    assert rebuild.sesm.fresh_stacks >= 1


def test_shard_plan_invalidation():
    """A coupling-group MEMBERSHIP change is one replan + rebuild; budget-
    and semantics-only drift ride the in-place sharded scatters."""
    pools = scenarios.multi_cell_pools(4, seed=2)
    sesm = SESM(pools[0], mesh=_mesh(3))
    rows = [[_req(SliceRequest, "coco_bags", 0.35, 8.0),
             _req(SliceRequest, "coco_animals", 0.50, 6.0)]
            for _ in range(4)]
    none = [[] for _ in range(4)]
    spec_a = _metro_spec(4)
    d0 = sesm.solve_slots(rows, [[0, 1]] * 4, coupling=spec_a, pools=pools)
    assert (sesm.shard_replans, sesm.fresh_stacks,
            sesm.session_rebuilds) == (1, 1, 0)
    spec_a.set_budgets(spec_a.link_capacity * 0.5)
    d1 = sesm.solve_slots(rows, none, coupling=spec_a, pools=pools)
    assert sesm.link_updates == 1 and sesm.session_rebuilds == 0
    assert sesm.shard_replans == 1
    assert sum(d.admitted for ds in d1 for d in ds) <= \
        sum(d.admitted for ds in d0 for d in ds)
    sesm.sdla.recalibrate(scale=0.85)
    sesm.solve_slots(rows, none, coupling=spec_a, pools=pools)
    assert sesm.semantic_updates == 1 and sesm.session_rebuilds == 0
    assert sesm.shard_replans == 1
    spec_b = CouplingSpec(np.array([2.0]), np.ones((4, 1), bool))
    d3 = sesm.solve_slots(rows, none, coupling=spec_b, pools=pools)
    assert sesm.session_rebuilds == 1
    assert sesm.shard_replans == 2 and sesm.fresh_stacks == 2
    insts = [dataclasses.replace(
        sesm.sdla.build_instance(rs, pools[i]), coupling=spec_b.row(i))
        for i, rs in enumerate(rows)]
    for ds, r in zip(d3, solve_coupled_ref(insts)):
        assert [d.admitted for d in ds] == [bool(a) for a in r.admitted]
    # dropping the mesh turns the session back into a meshless one
    sesm.mesh = None
    sesm.solve_slots(rows, none, coupling=spec_b, pools=pools)
    assert sesm.session_rebuilds == 2 and sesm.shard_replans == 2
    assert not isinstance(sesm._serve_session.dev, PF.ShardedStack)


def test_solve_batch_routes_through_the_sharded_solve():
    pools = scenarios.multi_cell_pools(4, seed=2)
    spec = _metro_spec(4)
    rows = [[_req(SliceRequest, "coco_bags", 0.35, 8.0),
             _req(SliceRequest, "coco_animals", 0.50, 6.0)]
            for _ in range(4)]
    metro = SESM(pools[0], mesh=_mesh(8)).solve_batch(rows, coupling=spec,
                                                      pools=pools)
    plain = SESM(pools[0], device="cpu").solve_batch(rows, coupling=spec,
                                                      pools=pools)
    assert [[(d.admitted, d.z, d.alloc) for d in ds] for ds in metro] == \
        [[(d.admitted, d.z, d.alloc) for d in ds] for ds in plain]


# ------------------------------------------- the reference's real meshes

def test_layout_and_decisions_match_the_reference_on_fake_devices(
        run_with_fake_devices):
    """On 3 and 8 fake host devices the reference's ``device_stack_sharded``
    builds the port's layout array for array, and its ``shard_map`` solve
    admits what the port's sharded solve admits on as many CPU shards."""
    out = run_with_fake_devices(8, """
        from repro_torch.core import scenarios as PS
        from repro_torch.core import device_stack_sharded as p_sharded
        from repro_torch.core import solve_greedy_sharded as p_solve
        from repro_torch.core import stack_instances as p_stack
        from repro_torch.launch.mesh import make_cells_mesh as p_mesh
        ref, _ = scenarios.metro_diurnal_trace(32, n_domains=4, hours=(13,))
        port, _ = PS.metro_diurnal_trace(32, n_domains=4, hours=(13,))
        jst = stack_instances(ref, group_major=True)
        st = p_stack(port, group_major=True)
        for n in (3, 8):
            jmesh = make_cells_mesh(n)
            j = device_stack_sharded(jst, jmesh)
            p = p_sharded(st, p_mesh(n, devices=["cpu"]))
            assert np.array_equal(j.row_of, p.row_of), n
            assert np.array_equal(np.asarray(j.group), p.group), n
            assert np.array_equal(j.padded_of, p.padded_of), n
            assert j.shard_rows == p.shard_rows, n
            assert np.array_equal(j.groups_per_shard, p.groups_per_shard)
            js = solve_greedy_sharded(ref, mesh=jmesh)
            ps = p_solve(port, mesh=p_mesh(n, devices=["cpu"]))
            for a, b in zip(js, ps):
                assert np.array_equal(a.admitted, b.admitted), n
                assert np.array_equal(a.alloc, b.alloc), n
            print(n, sum(int(s.admitted.sum()) for s in ps))
    """)
    assert out.split() == ["3", "62", "8", "62"]
