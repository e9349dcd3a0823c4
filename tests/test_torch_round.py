"""K2's single-instance admission round against the torch round and the JAX
reference, on the CPU.

The round kernel (``repro_torch/kernels/pg/pg.py::bind_round``) runs here
through its plain version ``admission_round_ref`` — a CUDA kernel has no
host mode — which writes one round into the solve's state in place. Stepped
round by round it must leave every state tensor bit for bit where
``core/greedy.py::_round`` over ``_inner_torch`` (the ``inner="torch"``
twin) and the reference's ``_round`` run eagerly leave theirs; a whole solve
through it must decide as the jitted ``solve_greedy_jax`` with its Pallas
inner step (interpret mode). ``tests/test_torch_cuda.py`` holds the CUDA
kernel against the plain version on a card.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import greedy as JG  # noqa: E402
from repro.core import scenarios as JS  # noqa: E402
from repro.core import solve_greedy_jax as j_single  # noqa: E402

from repro_torch.core import greedy, scenarios, solve_greedy_torch  # noqa: E402
from repro_torch.core.sfesp import _f32, lexicographic_cost  # noqa: E402
from repro_torch.kernels.pg import pg as PK  # noqa: E402

QUADRANTS = [(True, True), (True, False), (False, True), (False, False)]


def _solve_tables(inst, semantic):
    """The single solve's tables and initial state, as
    ``solve_greedy_torch`` builds them on the CPU."""
    lat, z_idx = greedy._select_tables(inst, semantic)
    lat_ok = lat <= inst.tasks.max_latency[:, None]
    alive0 = (z_idx >= 0) & lat_ok.any(axis=1)
    tables = (torch.from_numpy(lat_ok), _f32(inst.grid, "cpu"),
              _f32(inst.pool.price, "cpu"), _f32(inst.pool.capacity, "cpu"),
              _f32(lexicographic_cost(inst.grid), "cpu"))
    return tables, alive0


def _state(alive0, m):
    t = len(alive0)
    return (torch.zeros(t, dtype=torch.bool),
            torch.full((t,), -1, dtype=torch.int32),
            torch.zeros(m, dtype=torch.float32),
            torch.from_numpy(np.array(alive0, bool)))


def _same_state(a, b, what):
    admitted, alloc_idx, occupied, alive = a
    assert torch.equal(admitted, b[0]), what
    assert torch.equal(alloc_idx, b[1]), what
    assert torch.equal(occupied.view(torch.int32),
                       torch.as_tensor(np.asarray(b[2], np.float32))
                       .view(torch.int32)), what
    assert torch.equal(alive, b[3]), what


def _step_both(tables, alive0, flexible, reference=False):
    """Run the plain round (through ``bind_round``) and the torch round from
    the same start until convergence and one no-op round past it, comparing
    every state tensor after every round; with ``reference``, the
    reference's ``_round`` (eager, its own inner step) too. Returns the
    rounds run."""
    lat_ok, grid, price, cap, cost = tables
    m = grid.shape[1]
    plain = _state(alive0, m)
    step = PK.bind_round(plain, lat_ok, grid, price, cap, cost,
                         flexible=flexible)
    twin = _state(alive0, m)
    inner = functools.partial(greedy._inner_torch, flexible=flexible)
    if reference:
        jt = [jnp.asarray(x.numpy()) for x in tables]
        jstate = (jnp.zeros(len(alive0), bool),
                  jnp.full(len(alive0), -1, jnp.int32),
                  jnp.zeros(m, jnp.float32), jnp.asarray(alive0))
    rounds = 0
    while True:
        done = not bool(plain[3].any())
        step()
        twin = greedy._round(twin, lat_ok, grid, price, cap, cost, inner)
        rounds += 1
        _same_state(plain, twin, f"round {rounds}")
        if reference:
            with jax.disable_jit():
                jstate = JG._round(jstate, *jt, flexible, None)
            _same_state(plain, [torch.from_numpy(np.array(x))
                                for x in jstate], f"reference round {rounds}")
        if done:
            return rounds


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("semantic,flexible", QUADRANTS)
def test_round_plain_matches_torch_round_on_fig6(m, semantic, flexible):
    insts = scenarios.fig6_sweep(m, n_tasks=(10, 40), acc_levels=("med",),
                                 lat_levels=("low", "high"),
                                 seeds=(0,))[0]
    for inst in insts:
        tables, alive0 = _solve_tables(inst, semantic)
        assert _step_both(tables, alive0, flexible) >= 1


def _planted(rng, t, a, m):
    """Round tables with planted ties: duplicated grid rows (equal PG and
    cost), duplicated task rows, all-zero prices on request, rows with
    nothing feasible and tasks that start dead."""
    grid = rng.integers(1, 8, (a, m)).astype(np.float32)
    grid[a // 2:a // 2 + 8] = grid[:8]
    price = rng.uniform(0.05, 0.3, m).astype(np.float32)
    cap = rng.integers(10, 30, m).astype(np.float32)
    lat = rng.random((t, a)) < 0.3
    lat[1::4] = lat[0::4][:len(lat[1::4])]           # identical task rows
    lat[2::7] = False                                # nothing feasible
    alive0 = lat.any(1)
    alive0[3::11] = False                            # dead from the start
    cost = grid @ (1000.0 ** np.arange(m)).astype(np.float32)
    tables = tuple(torch.from_numpy(np.ascontiguousarray(x))
                   for x in (lat, grid, price, cap, cost.astype(np.float32)))
    return tables, alive0


@pytest.mark.parametrize("flexible", [True, False])
@pytest.mark.parametrize("zero_price", [False, True])
def test_round_plain_planted_ties_and_infeasible_rows(flexible, zero_price):
    """Planted G ties (duplicated allocations and task rows; zero prices
    make every gradient equal) and rows with nothing feasible: the plain
    round, the torch round and the reference's eager ``_round`` agree bit
    for bit on every state tensor after every round."""
    rng = np.random.default_rng(11)
    tables, alive0 = _planted(rng, 37, 150, 2)
    if zero_price:
        tables = tables[:2] + (torch.zeros_like(tables[2]),) + tables[3:]
    assert _step_both(tables, alive0, flexible, reference=True) >= 2


def test_round_plain_with_nothing_feasible_is_a_no_op():
    """Every row infeasible (no allocation fits the capacity): one round
    retires every task and changes nothing else, then rounds are no-ops."""
    rng = np.random.default_rng(12)
    tables, alive0 = _planted(rng, 9, 40, 4)
    tables = tables[:3] + (torch.full_like(tables[3], 0.5),) + tables[4:]
    assert alive0.any()
    state = _state(alive0, 4)
    step = PK.bind_round(state, *tables, flexible=True)
    for _ in range(3):
        step()
        assert not state[0].any() and not state[3].any()
        assert (state[1] == -1).all() and (state[2] == 0).all()


@pytest.mark.parametrize("m", [2, 4])
def test_single_solve_through_the_plain_round_matches_pallas(m, monkeypatch):
    """The whole single solve routed to the round (``inner="kernel"``,
    which is the plain round on CPU tensors) decides as the jitted
    reference with its Pallas inner step, in interpret mode."""
    monkeypatch.setattr(greedy, "resolve_inner", lambda inner, dev: "kernel")
    kw = dict(n_tasks=(20, 50), acc_levels=("med",), lat_levels=("high",),
              seeds=(4,))
    for jinst, inst in zip(JS.fig6_sweep(m, **kw)[0],
                           scenarios.fig6_sweep(m, **kw)[0]):
        for semantic, flexible in QUADRANTS:
            ref = j_single(jinst, semantic=semantic, flexible=flexible,
                           inner="pallas")
            out = solve_greedy_torch(inst, semantic=semantic,
                                     flexible=flexible, device="cpu")
            assert np.array_equal(ref.admitted, out.admitted)
            assert np.array_equal(ref.alloc, out.alloc)
            assert np.array_equal(ref.z, out.z)


def test_bind_round_checks_its_inputs():
    rng = np.random.default_rng(13)
    tables, alive0 = _planted(rng, 5, 20, 2)
    state = _state(alive0, 2)
    with pytest.raises(TypeError, match="grid"):
        PK.bind_round(state, tables[0], tables[1].double(), *tables[2:],
                      flexible=True)
    with pytest.raises(TypeError, match="alive"):
        PK.bind_round(state[:3] + (state[3].to(torch.uint8),), *tables,
                      flexible=True)
    with pytest.raises(ValueError, match="does not fit"):
        PK.bind_round(state, tables[0], tables[1][:-1], *tables[2:],
                      flexible=True)
    # any m: nine resources bind (the kernel's pool terms are sized by m)
    wide = torch.ones(20, 9)
    PK.bind_round(state[:2] + (torch.zeros(9),) + state[3:], tables[0],
                  wide, torch.ones(9), torch.full((9,), 4.0), tables[4],
                  flexible=True)()
    before = PK.ADMIT_KERNEL.launches
    PK.bind_round(state, *tables, flexible=True)()
    assert PK.ADMIT_KERNEL.launches == before      # the CPU runs no kernel
