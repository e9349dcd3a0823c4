"""K1's one-launch batched solve (``batch_solve``) and the lifted shape
limits, against the JAX reference, on the CPU.

``repro_torch/kernels/pg/pg.py::batch_solve`` on CPU tensors is its plain
version ``batch_solve_ref``: ``core/greedy.py``'s host loop over the torch
round (a CUDA kernel has no host mode; ``tests/test_torch_cuda.py`` holds
the kernel against it on a card). Here the plain version is held against
the reference's batched solve, and a group-by-group model of the kernel's
loop (one coupling group at a time, its own round count, the link budget
updated by one add a round) against the plain version, bit for bit, so the
kernel's decomposition is checked where it can run. Also: a nine-resource
pool decides as the reference through every route of the port, the kernel
wrappers accept m = 9 and A = 19200, the group CSR, and K4's plain version
at Dh = 320.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import scenarios as JS  # noqa: E402
from repro.kernels.attn.attn import flash_attention_fwd as j_flash  # noqa: E402

from repro_torch.core import (CouplingSpec, ResourcePool,  # noqa: E402
                              build_instance, device_stack,
                              dispatch_device_batch, greedy, scenarios,
                              solve_device_batch, solve_greedy_torch,
                              stack_instances, unpack_device_batch)
from repro_torch.core.sfesp import group_csr  # noqa: E402
from repro_torch.kernels.attn import attn as PA  # noqa: E402
from repro_torch.kernels.pg import pg as PK  # noqa: E402

from test_torch_core import to_port  # noqa: E402

NEG = float("-inf")


@pytest.fixture
def rng():
    """A generator seeded in each test: ``tests/conftest.py``'s ``rng`` is
    shared by the session, so its draws would depend on which tests ran
    before in the same worker."""
    return np.random.default_rng(0)


def _pool9(cls, p4):
    """The m = 4 numerical pool plus five unit resources of capacity 12 (one
    with two levels): nine resources, A = 1280 · 2 = 2560."""
    extra = 5
    return cls(names=p4.names + tuple(f"unit{i}" for i in range(extra)),
               capacity=np.concatenate([p4.capacity, np.full(extra, 12.0)]),
               price=np.concatenate([p4.price, np.full(extra, 1 / 12)]),
               levels=tuple(p4.levels) + (np.array([1.0]),) * 4
               + (np.array([1.0, 2.0]),))


def _m9_instances(seeds=(3,)):
    jp = _pool9(J.ResourcePool, JS.numerical_pool(4))
    pp = _pool9(ResourcePool, scenarios.numerical_pool(4))
    jinsts = [J.build_instance(jp, JS.numerical_tasks(30, "med", "high",
                                                      seed=s)) for s in seeds]
    insts = [build_instance(pp, scenarios.numerical_tasks(30, "med", "high",
                                                          seed=s))
             for s in seeds]
    return jinsts, insts


def test_m9_pool_decides_as_the_reference(monkeypatch):
    """The nine-resource pool (A = 2560, 30 tasks, seed 3) through the
    port's torch round and through K2's round (its plain version) decides
    as the reference's ``solve_greedy_jax``; the unit resources bind."""
    (jinst,), (inst,) = _m9_instances()
    assert inst.grid.shape == (2560, 9)
    ref = J.solve_greedy_jax(jinst)
    out = solve_greedy_torch(inst, device="cpu")
    assert np.array_equal(ref.admitted, out.admitted)
    assert np.array_equal(ref.alloc, out.alloc)
    assert 0 < ref.admitted.sum() <= 12
    monkeypatch.setattr(greedy, "resolve_inner", lambda inner, dev: "kernel")
    k2 = solve_greedy_torch(inst, device="cpu")
    assert np.array_equal(ref.admitted, k2.admitted)
    assert np.array_equal(ref.alloc, k2.alloc)


def test_m9_batch_through_batch_solve_ref_matches_reference():
    """A two-row batch of the nine-resource pool through ``batch_solve_ref``
    (and ``batch_solve``, which is it on CPU tensors) against the
    reference's batched solve."""
    jinsts, insts = _m9_instances(seeds=(3, 4))
    ref = J.solve_device_batch(J.device_stack(J.stack_instances(jinsts)))
    dev = device_stack(stack_instances(insts), device="cpu")
    for fn in (PK.batch_solve_ref, PK.batch_solve):
        admitted, alloc_idx, occupied, used, _ = fn(dev)
        assert used is None
        assert np.array_equal(admitted.numpy(), ref["admitted"])
        adm = ref["admitted"]
        assert np.array_equal(alloc_idx.numpy()[adm], ref["alloc_idx"][adm])
        assert np.allclose(occupied.numpy(),
                           dev.capacity.numpy() - ref["residual"])


@pytest.mark.parametrize("m,a,t", [(9, 2560, 30), (4, 19200, 5)])
def test_wrappers_accept_any_m_and_a(m, a, t):
    """K1's ``_check`` and K2's ``_check_round`` take m = 9 and A = 19200
    (the 4-resource pool with 8 CPU and 8 RAM levels, 15·20·8·8)."""
    w = -(-a // 32)
    b = 2
    PK._check(torch.zeros((b, t, w), dtype=torch.int32),
              torch.zeros((b, t), dtype=torch.bool), torch.ones(a, m),
              torch.ones(b, m), torch.ones(b, m), torch.zeros(b, m))
    state = (torch.zeros(t, dtype=torch.bool),
             torch.full((t,), -1, dtype=torch.int32), torch.zeros(m),
             torch.zeros(t, dtype=torch.bool))
    PK._check_round(state, torch.zeros((t, a), dtype=torch.bool),
                    torch.ones(a, m), torch.ones(m), torch.ones(m),
                    torch.zeros(a))
    with pytest.raises(ValueError, match="does not fit"):
        PK._check(torch.zeros((b, t, w - 1), dtype=torch.int32),
                  torch.zeros((b, t), dtype=torch.bool), torch.ones(a, m),
                  torch.ones(b, m), torch.ones(b, m), torch.zeros(b, m))


def test_batch_round_plain_at_m9_and_a19200(rng):
    """``batch_round`` (its plain version on CPU tensors) at m = 9 and at
    A = 19200 against the dense oracle on the same inputs."""
    for b, t, a, m in ((3, 7, 2560, 9), (2, 3, 19200, 4)):
        grid = rng.integers(1, 6, (a, m)).astype(np.float32)
        price = rng.uniform(0.05, 0.3, (b, m)).astype(np.float32)
        cap = rng.integers(20, 40, (b, m)).astype(np.float32)
        occ = (cap * rng.uniform(0, 0.5, (b, m))).astype(np.float32)
        lat = rng.random((b, t, a)) < 0.1
        alive = rng.random((b, t)) < 0.8
        ins = [torch.from_numpy(x) for x in (lat, alive, grid, price, cap,
                                             occ)]
        want = PK.batch_round_ref(*ins)
        got = PK.batch_round(greedy._pack_bits(ins[0]), *ins[1:])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


# ---------------------------------------------------------------- groups

def _group20_with_singletons(pkg):
    """One coupling group of 20 cells (a shared backhaul link) beside six
    uncoupled cells on the same grid: singleton groups."""
    big, _ = pkg.multi_cell_trace(20, 1, seed=5, shared_backhaul=3.0)
    solo, _ = pkg.multi_cell_trace(6, 1, seed=6)
    return list(big) + list(solo)


def _stacks():
    """(name, reference instances, port device stack, batch padding) of
    small batches: coupled groups of 10 (two steps of a 10-cell trace), a
    group of 20 with singletons, padded to 32 rows, and an uncoupled
    trace."""
    out = []
    for name, insts, pad in (
            ("groups of 10", JS.multi_cell_trace(10, 2, seed=3,
                                                 shared_backhaul=2.0)[0],
             None),
            ("group of 20 + singletons", _group20_with_singletons(JS), 32),
            ("uncoupled", JS.multi_cell_trace(6, 3, seed=1)[0], None)):
        port = stack_instances(to_port(insts))
        out.append((name, insts, device_stack(port, pad_batch_to=pad,
                                              device="cpu"), pad))
    return out


def test_group_csr_matches_coupling_groups_and_survives_budget_updates():
    for _, _, dev, _ in _stacks():
        if not dev.coupled:
            assert dev.group_csr is None
            continue
        inc = dev.incidence.numpy()
        groups = CouplingSpec(dev.link_cap.numpy(), inc).groups()
        csr = dev.group_csr
        before = [x.clone() for x in (csr.rows, csr.offsets, csr.links,
                                      csr.link_offsets, csr.cell_links,
                                      csr.cell_link_offsets)]
        dev.update_link_budgets(dev.link_cap.numpy() * 0.5)
        assert dev.group_csr is csr
        assert all(torch.equal(x, y) for x, y in zip(
            before, (csr.rows, csr.offsets, csr.links, csr.link_offsets,
                     csr.cell_links, csr.cell_link_offsets)))
        rows, off = csr.rows.numpy(), csr.offsets.numpy()
        links, loff = csr.links.numpy(), csr.link_offsets.numpy()
        cl, cloff = csr.cell_links.numpy(), csr.cell_link_offsets.numpy()
        assert sorted(rows) == list(range(len(groups)))
        assert csr.num_groups == len(np.unique(groups))
        for g in range(csr.num_groups):
            members = rows[off[g]:off[g + 1]]
            assert (np.diff(members) > 0).all()
            assert (groups[members] == groups[members[0]]).all()
            assert groups[members[0]] == members[0]   # id = smallest row
            glinks = links[loff[g]:loff[g + 1]]
            assert np.array_equal(glinks,
                                  np.nonzero(inc[members].any(0))[0])
            for b in members:
                mine = glinks[cl[cloff[b]:cloff[b + 1]]]
                assert np.array_equal(mine, np.nonzero(inc[b])[0])
        assert csr.max_members == int((off[1:] - off[:-1]).max())
    assert group_csr(np.zeros((3, 0), bool), np.arange(3), "cpu") \
        .num_groups == 3


def _cluster_model(dev):
    """The kernel's loop, modelled group by group on the CPU: each group
    runs its own rounds until its pick is -inf everywhere; per round every
    cell picks alone (the torch round on its row), the first cell attaining
    the group max admits, a cell with V = -inf retires, and the group's
    links take one f32 add of the admitted load. Returns the kernel's
    outputs: (admitted, alloc_idx, occupied, used, rounds per group)."""
    (lat_ok, grid, price, cap, alive0, _, load, link_cap, incidence,
     _) = dev.inputs()
    rows, t, a = lat_ok.shape
    m = grid.shape[1]
    words = greedy._pack_bits(lat_ok)
    admitted = torch.zeros((rows, t), dtype=torch.bool)
    alloc_idx = torch.full((rows, t), -1, dtype=torch.int32)
    occupied = torch.zeros((rows, m))
    used = None if link_cap is None else torch.zeros_like(link_cap)
    if dev.coupled:
        csr = dev.group_csr
        off = csr.offsets.tolist()
        groups = [csr.rows[off[g]:off[g + 1]].tolist()
                  for g in range(csr.num_groups)]
    else:
        groups = [[b] for b in range(rows)]
    rounds = []
    for members in groups:
        alive = {b: alive0[b].clone() for b in members}
        real = 0
        while True:
            picks = []
            any_alive = False
            for b in members:
                thr = torch.tensor(float("inf"))
                if dev.coupled and incidence[b].any():
                    rem = link_cap[incidence[b]] - used[incidence[b]]
                    thr = rem.amin() + 1e-9
                cand = alive[b] & (load[b] <= thr)
                any_alive = any_alive or bool(alive[b].any())
                v, tau, best = greedy._flex_round_fn(
                    words[b:b + 1], grid, price[b:b + 1], cap[b:b + 1], a)(
                    occupied[b:b + 1], cand[None])
                if not v[0] > NEG:
                    alive[b][:] = False
                picks.append((float(v[0]), int(tau[0]), int(best[0])))
            real += any_alive
            vmax = max(p[0] for p in picks)
            if not vmax > NEG:
                break
            j = next(i for i, p in enumerate(picks) if p[0] == vmax)
            b, (_, tau, best) = members[j], picks[j]
            admitted[b, tau] = True
            alloc_idx[b, tau] = best
            occupied[b] = occupied[b] + grid[best]
            alive[b][tau] = False
            if dev.coupled:
                used[incidence[b]] = used[incidence[b]] + load[b, tau]
        rounds.append(real)
    return admitted, alloc_idx, occupied, used, rounds


def test_batch_solve_ref_matches_the_reference_and_the_kernel_model():
    """On every small stack (a group larger than 8 among them): the plain
    version decides as the reference's ``solve_device_batch``, leaves the
    state the torch dispatch leaves, and equals the group-by-group model of
    the kernel bit for bit, whose largest round count rounded up to the
    loop's convergence period is the loop's."""
    for name, insts, dev, pad in _stacks():
        jdev = J.device_stack(J.stack_instances(insts), pad_batch_to=pad)
        ref = J.solve_device_batch(jdev)
        admitted, alloc_idx, occupied, used, rounds = PK.batch_solve_ref(dev)
        b = len(insts)
        assert np.array_equal(admitted.numpy()[:b], ref["admitted"]), name
        adm = ref["admitted"]
        assert np.array_equal(alloc_idx.numpy()[:b][adm],
                              ref["alloc_idx"][adm]), name
        host = solve_device_batch(dev, inner="torch")
        assert np.array_equal(host["admitted"], admitted.numpy()[:b])
        assert host["rounds"] == int(rounds[0])
        model = _cluster_model(dev)
        assert torch.equal(model[0], admitted), name
        assert torch.equal(model[1], alloc_idx), name
        assert torch.equal(model[2].view(torch.int32),
                           occupied.view(torch.int32)), name
        if dev.coupled:
            assert torch.equal(model[3].view(torch.int32),
                               used.view(torch.int32)), name
            assert np.allclose(used.numpy(), ref["link_used"])
        period = greedy._SYNC_EVERY
        assert int(rounds[0]) == period * -(-max(model[4]) // period), name


def test_dispatch_routes_the_flexible_solve_to_one_batch_solve(monkeypatch):
    """With the kernel route (forced here; CUDA's default), every flexible
    batched solve is one ``batch_solve`` call with one host sync (the
    read-back), and decides as the torch route; MinRes stays on the torch
    rounds. The stand-in counts as the card's launch count would."""
    calls = []
    real = PK.batch_solve

    def counted(stack, **kw):
        calls.append(stack)
        return real(stack, **kw)
    monkeypatch.setattr(PK, "batch_solve", counted)
    for name, _, dev, _ in _stacks():
        want = solve_device_batch(dev, inner="torch")
        monkeypatch.setattr(greedy, "resolve_inner",
                            lambda inner, d: "kernel")
        got = unpack_device_batch(dispatch_device_batch(dev))
        minres = solve_device_batch(dev, flexible=False)
        monkeypatch.undo()
        monkeypatch.setattr(PK, "batch_solve", counted)
        assert len(calls) == 1 and calls.pop() is dev, name
        assert got["syncs"] == 1, name
        assert np.array_equal(got["admitted"], want["admitted"]), name
        assert np.array_equal(got["alloc_idx"], want["alloc_idx"]), name
        assert np.array_equal(got["link_used"], want["link_used"]), name
        assert minres["syncs"] > 1


# -------------------------------------------------------------------- K4

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_at_dh320_matches_reference(dtype, rng):
    """K4's plain version takes Dh > 256 on CPU tensors (on the card
    ``route`` sends it to the CUDA-core kernel's Dh ≤ 512 tile) and matches
    the reference's Pallas kernel in interpret mode within today's
    tolerances (2e-5 in float32, 3e-2 in bfloat16)."""
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 2e-5),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype]
    qkv = []
    for shape in ((1, 24, 4, 320), (1, 24, 2, 320), (1, 24, 2, 320)):
        j = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
        qkv.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(tdt)))
    (jq, q), (jk, k), (jv, v) = qkv
    assert PA.route(q.dtype, 320) == "cuda_cores"
    got = PA.flash_attention_fwd(q, k, v).float().numpy()
    want = np.asarray(j_flash(jq, jk, jv, block_q=8, block_k=8), np.float32)
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=tol, rtol=0), \
        float(np.abs(got - want).max())
