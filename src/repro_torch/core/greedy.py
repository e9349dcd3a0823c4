"""Port of ``src/repro/core/greedy.py``: paper Algorithm 1 (primal effective
gradient greedy), as a numpy oracle and as device solves.

* :func:`solve_greedy` — the readable numpy reference of Alg. 1, copied from
  the JAX package; the oracle of the tests.
* :func:`solve_greedy_torch` — the single-instance device solve, the
  counterpart of the reference's ``solve_greedy_jax``: front door of
  :func:`solve` (``backend="torch"``), ``baselines.run_algorithm`` and
  ``SESM.slice``.
* :func:`solve_greedy_batch` / :func:`solve_device_batch` /
  :func:`dispatch_device_batch` — the batched sweep and serving engine over
  a :class:`~repro_torch.core.sfesp.DeviceStack`, uncoupled and coupled, in
  all four (semantic × flexible) quadrants; :func:`solve_greedy_many` groups
  mixed-grid instance sets into one batch per grid.
* :func:`solve_greedy_sharded` / :func:`solve_sharded_batch` /
  :func:`dispatch_sharded_batch` — the metro-scale solve over a
  :class:`~repro_torch.core.sfesp.ShardedStack`: one batched solve per
  distinct device of the mesh (one K1 launch on a card), decisions
  gathered back to input order.

Each device solve has two interchangeable inner steps, named as in the
serving tick: ``inner="kernel"`` launches a hand-written CUDA kernel (the
counterpart of the reference's ``inner="pallas"``) and ``inner="torch"``
runs the same step as plain torch ops (the counterpart of ``"jnp"``). In
the batched flexible solve the kernel is K1's solve entry
(``kernels/pg/pg.py::batch_solve``): every round of the batch, coupled or
not, in ONE launch; the MinRes path stays the dense per-instance round, as
in the reference, which has no kernel there. In the single-instance solve
it is K2's admission round (``kernels/pg/pg.py::bind_round``: the whole of
:func:`_round` over the ``pg_argmax`` inner step in one launch, every
quadrant). ``inner=None`` follows the device, as the reference's
``resolve_interpret`` follows the backend: CUDA gets the kernel, the CPU
gets the torch step, and ``"kernel"`` on a CPU device raises. Both give the
same decisions.

The reference runs each admission loop as one ``lax.while_loop``. So does
the batched kernel route, inside its one launch: it returns without
waiting on the device, and the decision read-back is its only host sync.
The torch rounds (and the single solve, one launch a round) are driven
from the host; rounds after convergence are no-ops (every update is
masked), so that loop tests ``alive.any()`` — a host sync — only once every
``_SYNC_EVERY`` rounds without changing a decision. The batched result
dicts report ``rounds`` run (on the kernel route the largest coupling
group's real count; on the host loop a multiple of ``_SYNC_EVERY``) and
``syncs`` (device waits, including the decision read-back).

Two facts about the reference, so nobody chases a phantom mismatch:

* The JAX serving tick as shipped never runs K1, and its ``run_algorithm``
  never runs K2: ``MultiCellEngine`` builds its ``SESM`` without ``inner``
  and ``baselines`` calls ``solve_greedy_jax`` without it, so both default
  to ``"jnp"``. The port puts its kernels on those paths whenever the device
  is CUDA.
* Under ``jax.jit`` on the CPU, XLA contracts the m-term sums of
  ``primal_gradient`` into FMAs (``acc = p_0·d_0; acc = fma(p_k, d_k,
  acc)``), so the jitted gradient differs by an ulp from eager JAX, numpy
  and this port on a share of the lanes. The port's :func:`_batch_pg` is the
  plain formula in its left-to-right order — bit-identical to the reference
  run eagerly (``jax.disable_jit()``) — and K1 evaluates exactly that
  formula, with no FMA. Decisions agree with the jitted reference on the
  scenario library all the same; the tests hold gradients against the eager
  reference and decisions against the jitted one.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..kernels import resolve_device
from . import semantics
from .sfesp import (DeviceStack, ShardedStack, _f32, device_stack,
                    device_stack_sharded, lexicographic_cost, next_pow2,
                    objective_value, stack_instances)
from .types import ProblemInstance, Solution, StackedInstances

__all__ = ["primal_gradient", "solve_greedy", "solve_greedy_torch",
           "solve_greedy_batch", "solve_greedy_many", "solve",
           "solve_device_batch", "dispatch_device_batch",
           "unpack_device_batch", "resolve_inner", "lexicographic_cost",
           "dispatch_sharded_batch", "unpack_sharded_batch",
           "solve_sharded_batch", "solve_greedy_sharded"]

_EPS_DEN = 1e-9
# admission rounds between two convergence tests (host syncs) of the loop
_SYNC_EVERY = 4
_NEG = float("-inf")


# ---------------------------------------------------------------------------
# Primal effective gradient (paper lines 21-25, after Toyoda 1975)
# ---------------------------------------------------------------------------

def _fold(terms):
    """Left-to-right sum ``((0 + t0) + t1) + ...`` — the order in which the
    reference's eager ``sum`` reduces its m terms from XLA's +0 init, written
    out so no backend reorders it (the +0 start only fixes the sign of an
    all-negative-zero sum)."""
    acc = 0.0
    for t in terms:
        acc = acc + t
    return acc


def _sqrt_rn(x):
    """Correctly rounded float32 square root: torch's vectorized CPU sqrt
    can miss by an ulp, where numpy, XLA and CUDA's ``__fsqrt_rn`` round
    correctly; the float64 root of a float32 value rounds back exactly."""
    return torch.sqrt(x.double()).to(x.dtype)


def _batch_pg(grid, price, cap, occupied):
    """Batched primal gradient: grid (A, m), price/cap/occupied (B, m) f32
    tensors → (B, A). The formula of :func:`primal_gradient`, operation for
    operation, in float32 — what K1 evaluates per lane."""
    m = grid.shape[1]
    g = grid[None]                                               # (1, A, m)
    p, c = price[:, None, :], cap[:, None, :]                    # (B, 1, m)
    value = _fold(p[..., k] * (c[..., k] - g[..., k]) for k in range(m))
    norm_use = _fold(g[..., k] / c[..., k] for k in range(m))
    sqrt_m = _sqrt_rn(torch.tensor(float(m), dtype=grid.dtype,
                                   device=grid.device))
    pg_uniform = value * sqrt_m / torch.clamp_min(norm_use, _EPS_DEN)
    o_norm = _sqrt_rn(_fold(occupied[:, k] * occupied[:, k]
                            for k in range(m)))[:, None]         # (B, 1)
    ratio = occupied / cap                                       # (B, m)
    weighted = _fold(g[..., k] * ratio[:, None, k] for k in range(m))
    pg_occ = value * o_norm / torch.clamp_min(weighted, _EPS_DEN)
    return torch.where((occupied > 0).any(-1, keepdim=True), pg_occ,
                       pg_uniform)


def primal_gradient(grid, price, capacity, occupied):
    """PG(s) for every allocation s in ``grid`` (A, m) → (A,).

    Line 23 (no resources occupied yet — penalize usage uniformly):
        PG = Σ_k p_k (S_k - s_k) · m^{1/2} / Σ_k (s_k / S_k)
    Line 25 (penalize according to occupancy o):
        PG = Σ_k p_k (S_k - s_k) · ‖o‖₂ / Σ_k (s_k·o_k / S_k)

    numpy inputs (the oracle) take the reference's numpy expression verbatim;
    torch tensors take :func:`_batch_pg` on a batch of one. The occupied-
    branch denominator is clamped to a tiny ε (an allocation touching only
    unused resources is maximally attractive, and stays finite).
    """
    if isinstance(grid, torch.Tensor):
        return _batch_pg(grid, price[None], capacity[None], occupied[None])[0]
    grid = np.asarray(grid)
    m = grid.shape[-1]
    value = (price * (capacity - grid)).sum(axis=-1)          # Σ p_k (S_k-s_k)
    norm_use = (grid / capacity).sum(axis=-1)                 # Σ s_k/S_k
    pg_uniform = value * np.sqrt(float(m)) / np.maximum(norm_use, _EPS_DEN)
    o_norm = np.sqrt((occupied * occupied).sum())
    weighted = (grid * (occupied / capacity)).sum(axis=-1)    # Σ s_k o_k / S_k
    pg_occ = value * o_norm / np.maximum(weighted, _EPS_DEN)
    return np.where((occupied > 0).any(), pg_occ, pg_uniform)


# ---------------------------------------------------------------------------
# numpy reference (Alg. 1 structure)
# ---------------------------------------------------------------------------

def _select_tables(inst: ProblemInstance, semantic: bool):
    if semantic:
        return inst.lat, inst.z_star_idx
    return inst.lat_agnostic, inst.z_star_idx_agnostic


def solve_greedy(inst: ProblemInstance, *, semantic: bool = True,
                 flexible: bool = True) -> Solution:
    """Numpy reference of Alg. 1.

    ``flexible=False`` replaces the PG-maximizing allocation of Eq. (3) with
    the minimum-cost feasible allocation (MinRes-* behaviour); task priority is
    still the gradient evaluated at that fixed allocation.
    """
    lat, z_idx = _select_tables(inst, semantic)
    T, A = lat.shape
    S, p = inst.pool.capacity, inst.pool.price
    grid = inst.grid
    max_lat = inst.tasks.max_latency

    lat_ok = lat <= max_lat[:, None]                       # (T, A) static
    admitted = np.zeros(T, bool)
    alloc_idx = np.full(T, -1, np.int64)
    # line 1/7: candidates = tasks whose accuracy bound is reachable (Eq. 2)
    alive = (z_idx >= 0) & lat_ok.any(axis=1)
    occupied = np.zeros_like(S)
    cost = lexicographic_cost(grid)                        # for MinRes mode

    while alive.any():                                      # lines 8-19
        remaining = S - occupied
        cap_ok = (grid <= remaining + 1e-9).all(axis=1)     # s ≤ S - o
        pg = primal_gradient(grid, p, S, occupied)          # (A,)
        feas = lat_ok & cap_ok[None, :] & alive[:, None]
        has = feas.any(axis=1)
        alive &= has                                        # line 15: discard
        if not alive.any():
            break
        if flexible:                                        # Eq. (3)
            score = np.where(feas, pg[None, :], -np.inf)
        else:                                               # min-cost alloc
            score = np.where(feas, -cost[None, :], -np.inf)
        best_a = score.argmax(axis=1)                       # per-task s*
        G = pg[best_a]                                      # task gradient
        G = np.where(alive, G, -np.inf)
        tau = int(G.argmax())                               # line 16
        admitted[tau] = True                                # line 17
        alloc_idx[tau] = best_a[tau]
        occupied = occupied + grid[best_a[tau]]
        alive[tau] = False                                  # line 18

    return _pack_solution(inst, semantic, admitted, alloc_idx, z_idx)


def _pack_solution(inst, semantic, admitted, alloc_idx, z_idx) -> Solution:
    grid = inst.grid
    T = inst.num_tasks
    alloc = np.zeros((T, inst.m))
    alloc[admitted] = grid[alloc_idx[admitted]]
    z = np.where(admitted & (z_idx >= 0),
                 inst.z_grid[np.clip(z_idx, 0, None)], 1.0)
    # true satisfaction: re-check accuracy on the task's OWN curve (agnostic
    # algorithms may have picked a z that the real class cannot tolerate),
    # under the model that defined the instance (drifted curves included).
    a_true = semantics.resolve(inst.semantics).accuracy(inst.tasks.app_idx, z)
    lat_tbl = inst.lat if semantic else inst.lat_agnostic
    l_val = np.where(admitted & (alloc_idx >= 0),
                     lat_tbl[np.arange(T), np.clip(alloc_idx, 0, None)], np.inf)
    satisfied = admitted & (a_true + 1e-9 >= inst.tasks.min_accuracy) \
        & (l_val <= inst.tasks.max_latency + 1e-9)
    return Solution(
        admitted=admitted, alloc=alloc, z=z,
        objective=objective_value(inst, admitted, alloc),
        satisfied=satisfied,
    )


# ---------------------------------------------------------------------------
# Device backends
# ---------------------------------------------------------------------------

def resolve_inner(inner: str | None, device) -> str:
    """``None`` → ``"kernel"`` on CUDA, ``"torch"`` on the CPU; ``"kernel"``
    on a CPU device raises (the kernel has no host mode)."""
    device = torch.device(device)
    if inner is None:
        return "kernel" if device.type == "cuda" else "torch"
    if inner not in ("kernel", "torch"):
        raise ValueError(f"inner must be 'kernel', 'torch' or None, "
                         f"got {inner!r}")
    if inner == "kernel" and device.type != "cuda":
        raise ValueError(
            "inner='kernel' launches a CUDA kernel (K1 or K2) and needs a "
            f"CUDA device (got {device}); use inner='torch' or None on the "
            "CPU")
    return inner


# ---------------------------------------------------------------------------
# Single-instance device solve (the reference's solve_greedy_jax)
# ---------------------------------------------------------------------------

def _inner_torch(grid, price, cap, occupied, remaining, lat_ok, alive, cost,
                 flexible: bool):
    """One admission round as plain torch ops (the reference's
    ``_inner_jnp``): per-task best allocation and gradient.

    Returns (G (T,), best_a (T,), has_feasible (T,)); the contract of
    ``kernels/pg/ops.py::pg_argmax``, the inner step of K2's round.
    """
    cap_ok = (grid <= remaining[None, :] + 1e-9).all(dim=1)         # (A,)
    pg = primal_gradient(grid, price, cap, occupied)                # (A,)
    feas = lat_ok & cap_ok[None, :] & alive[:, None]                # (T, A)
    sel = pg if flexible else -cost
    score = torch.where(feas, sel[None, :], _NEG)
    best_a = score.argmax(dim=1)
    has = feas.any(dim=1)
    G = torch.where(has, pg[best_a], _NEG)
    return G, best_a, has


def _round(state, lat_ok, grid, price, cap, cost, inner_fn):
    """One admission round (Alg. 1 lines 8-19) as a masked state update.

    A no-op once nothing is alive: ``admit`` is False, every update keeps
    its old value, so the host loop may run past convergence. ``tau`` stays
    a one-element tensor, so no index forces a host sync.
    """
    admitted, alloc_idx, occupied, alive = state
    remaining = cap - occupied
    G, best_a, has = inner_fn(grid, price, cap, occupied, remaining,
                              lat_ok, alive, cost)
    alive = alive & has                                  # drop infeasible
    G = torch.where(alive, G, _NEG)
    tau = torch.argmax(G).reshape(1)
    admit = alive.any().reshape(1)
    pick = best_a[tau]
    admitted[tau] |= admit
    alloc_idx[tau] = torch.where(admit, pick.to(torch.int32), alloc_idx[tau])
    occupied = occupied + torch.where(admit, grid[pick], 0.0)[0]
    alive[tau] = False
    return admitted, alloc_idx, occupied, alive


def solve_greedy_torch(inst: ProblemInstance, *, semantic: bool = True,
                       flexible: bool = True, inner: str | None = None,
                       device="cuda") -> Solution:
    """Single-instance device solve of Alg. 1 (the reference's
    ``solve_greedy_jax``): float32 tables on ``device``, one host-driven
    loop of admission rounds. ``inner="kernel"`` runs each round as one
    launch of K2's round kernel (``kernels/pg/pg.py::bind_round``, which
    updates the state in place; its plain version on CPU tensors),
    ``"torch"`` as :func:`_round` over :func:`_inner_torch`; ``None``
    follows the device. Decisions equal :func:`solve_greedy` up to float32
    argmax ties (both take the first maximum)."""
    dev = resolve_device(device)
    inner = resolve_inner(inner, dev)
    lat, z_idx = _select_tables(inst, semantic)
    lat_ok = lat <= inst.tasks.max_latency[:, None]
    alive0 = (z_idx >= 0) & lat_ok.any(axis=1)
    lat_ok_t = torch.from_numpy(lat_ok).to(dev)
    grid = _f32(inst.grid, dev)
    price = _f32(inst.pool.price, dev)
    cap = _f32(inst.pool.capacity, dev)
    cost = _f32(lexicographic_cost(inst.grid), dev)
    T = lat.shape[0]
    init = (torch.zeros(T, dtype=torch.bool, device=dev),
            torch.full((T,), -1, dtype=torch.int32, device=dev),
            torch.zeros(inst.m, dtype=torch.float32, device=dev),
            torch.from_numpy(alive0).to(dev))
    if inner == "kernel":
        from ..kernels.pg import pg as pg_kernel
        step = pg_kernel.bind_round(init, lat_ok_t, grid, price, cap, cost,
                                    flexible=flexible)

        def body(state):
            step()                                  # in place on ``init``
            return state
    else:
        inner_fn = functools.partial(_inner_torch, flexible=flexible)

        def body(state):
            return _round(state, lat_ok_t, grid, price, cap, cost, inner_fn)
    (admitted, alloc_idx, _, _), _, _ = _run_rounds(body, init, 3)
    return _pack_solution(inst, semantic, admitted.cpu().numpy(),
                          alloc_idx.cpu().numpy().astype(np.int64), z_idx)


# ---------------------------------------------------------------------------
# Batched device solve
# ---------------------------------------------------------------------------

def _pack_bits(mask):
    """Pack a boolean (..., A) mask into 32-bit words (..., ceil(A/32)).

    Same word layout as the reference (bit k of word w is column 32·w + k);
    the words are int32 tensors holding the uint32 bit pattern, because
    torch's CPU kernels do not shift or sum ``uint32``.
    """
    a = mask.shape[-1]
    w = -(-a // 32)
    pad = torch.zeros(mask.shape[:-1] + (w * 32 - a,), dtype=torch.bool,
                      device=mask.device)
    words = torch.cat([mask, pad], dim=-1).reshape(
        mask.shape[:-1] + (w, 32)).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) \
        << torch.arange(32, dtype=torch.int64, device=mask.device)
    u = (words * weights).sum(-1)                   # [0, 2^32) in int64
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _unpack_bits(bits, a):
    """Inverse of :func:`_pack_bits`: (..., W) int32 → (..., A) bool. An
    arithmetic shift of a negative word still leaves bit k in place 0."""
    idx = torch.arange(a, device=bits.device)
    return ((bits[..., idx // 32] >> (idx % 32).to(torch.int32)) & 1) > 0


def _or_tasks(words):
    """Bitwise OR over the task axis of (B, T, W) words → (B, W), as a
    log-depth tree (torch has no OR reduction)."""
    while words.shape[1] > 1:
        if words.shape[1] % 2:
            words = torch.cat([words, torch.zeros_like(words[:, :1])], 1)
        words = words[:, 0::2] | words[:, 1::2]
    return words[:, 0]


def _flex_round_fn(lat_bits, grid, price, cap, A):
    """The flexible-mode batched round as torch ops: (occupied, alive) →
    (V, tau, s*), the reference's bit-domain jnp round: V = max PG over
    cap-feasible columns feasible for an alive task, tau = first alive task
    whose row intersects {PG == V}, s* = tau's first-max allocation. The
    coupled solve folds its link feasibility into ``alive``, so the round
    knows nothing of coupling. K1 (``kernels/pg/pg.py``) runs this
    algorithm word-parallel on the card, one round (``batch_round``) or
    all of them (``batch_solve``).
    """
    def round_fn(occupied, alive):
        remaining = cap - occupied
        cap_ok = (grid[None] <= remaining[:, None, :] + 1e-9).all(-1)
        pg = _batch_pg(grid, price, cap, occupied)                 # (B, A)
        rows = torch.where(alive[:, :, None], lat_bits, 0)
        col_any = _unpack_bits(_or_tasks(rows), A)                 # (B, A)
        pgm = torch.where(cap_ok & col_any, pg, _NEG)
        v = pgm.amax(-1)                                           # (B,)
        hit_bits = _pack_bits(cap_ok & (pgm == v[:, None]))        # (B, W)
        t_hit = ((lat_bits & hit_bits[:, None, :]) != 0).any(-1) & alive
        tau = torch.argmax(t_hit.to(torch.int32), dim=1)           # (B,)
        lat_tau = _unpack_bits(
            torch.take_along_dim(lat_bits, tau[:, None, None], 1)[:, 0], A)
        cap_pgm = torch.where(cap_ok, pg, _NEG)
        best_a = torch.where(lat_tau, cap_pgm, _NEG).argmax(-1)
        return v, tau, best_a

    return round_fn


def _minres_dense(lat_ok, grid, price, cap, cost, occupied, alive):
    """Per-task min-cost round of every instance (the reference's vmapped
    ``_inner_jnp`` with ``flexible=False``): (G (B,T), best_a (B,T),
    has (B,T)), G the gradient at each task's own min-cost allocation."""
    remaining = cap - occupied
    cap_ok = (grid[None] <= remaining[:, None, :] + 1e-9).all(-1)  # (B, A)
    pg = _batch_pg(grid, price, cap, occupied)                     # (B, A)
    feas = lat_ok & cap_ok[:, None, :] & alive[:, :, None]         # (B,T,A)
    best_a = torch.where(feas, -cost, _NEG).argmax(-1)             # (B, T)
    has = feas.any(-1)
    G = torch.where(has, torch.take_along_dim(pg, best_a, 1), _NEG)
    return G, best_a, has


def _run_rounds(body, state, alive_at: int):
    """Host-driven admission loop: test convergence (``any alive``, one
    host sync), then run ``_SYNC_EVERY`` rounds; rounds past convergence
    are no-ops. Returns (state, rounds, syncs)."""
    rounds = syncs = 0
    while True:
        syncs += 1
        if not bool(state[alive_at].any()):
            return state, rounds, syncs
        for _ in range(_SYNC_EVERY):
            state = body(state)
            rounds += 1


def _init_state(alive0, m, dtype):
    B, tmax = alive0.shape
    dev = alive0.device
    return (torch.zeros((B, tmax), dtype=torch.bool, device=dev),
            torch.full((B, tmax), -1, dtype=torch.int32, device=dev),
            torch.zeros((B, m), dtype=dtype, device=dev),
            alive0.clone())


def _batch_solve(lat_ok, grid, price, cap, alive0, cost, flexible: bool):
    """Uncoupled batched solve on the torch rounds, driven from the host:
    (admitted, alloc_idx, occupied, rounds, syncs). ``lat_ok`` (B, Tmax,
    A), ``price``/``cap`` (B, m), ``alive0`` (B, Tmax); ``grid``/``cost``
    shared (A, m)/(A,). Finished instances run masked no-op rounds until
    the whole batch converges."""
    B, tmax, A = lat_ok.shape
    m = grid.shape[1]
    bidx = torch.arange(B, device=lat_ok.device)
    zero = torch.zeros((), dtype=grid.dtype, device=grid.device)

    if not flexible:
        def body(state):
            admitted, alloc_idx, occupied, alive = state
            G, best_a, has = _minres_dense(lat_ok, grid, price, cap, cost,
                                           occupied, alive)
            alive = alive & has                           # drop infeasible
            G = torch.where(alive, G, _NEG)
            tau = torch.argmax(G, dim=1)
            admit = alive.any(1)
            pick = best_a[bidx, tau]
            admitted[bidx, tau] |= admit
            alloc_idx[bidx, tau] = torch.where(
                admit, pick.to(torch.int32), alloc_idx[bidx, tau])
            occupied = occupied + torch.where(admit[:, None], grid[pick],
                                              zero)
            alive[bidx, tau] = False
            return admitted, alloc_idx, occupied, alive
    else:
        round_fn = _flex_round_fn(_pack_bits(lat_ok), grid, price, cap, A)

        def body(state):
            admitted, alloc_idx, occupied, alive = state
            v, tau, best_a = round_fn(occupied, alive)
            tau, best_a = tau.long(), best_a.long()
            admit = v > _NEG
            admitted[bidx, tau] |= admit
            alloc_idx[bidx, tau] = torch.where(
                admit, best_a.to(torch.int32), alloc_idx[bidx, tau])
            occupied = occupied + torch.where(admit[:, None], grid[best_a],
                                              zero)
            # the admitted task leaves the candidate set; a round with
            # nothing feasible retires the whole instance
            alive[bidx, tau] = False
            alive &= admit[:, None]
            return admitted, alloc_idx, occupied, alive

    state, rounds, syncs = _run_rounds(
        body, _init_state(alive0, m, grid.dtype), 3)
    return state[0], state[1], state[2], rounds, syncs


def _batch_solve_coupled(lat_ok, grid, price, cap, alive0, cost, load,
                         link_cap, incidence, group, flexible: bool):
    """Coupled batched solve on the torch rounds, driven from the host:
    cells sharing backhaul links admit JOINTLY.

    Each round: (1) a task is a candidate only if its load fits the
    remaining budget of every link its cell traverses (folded into
    ``alive``); (2) every cell yields (V_b, tau_b, s*_b) as uncoupled; (3)
    per coupling GROUP only the first cell attaining the group max admits —
    the reference's ``segment_max``/``segment_min`` as ``scatter_reduce``
    amax/amin; (4) the admitted load is charged to the cell's links. A cell
    with V = -inf retires. Returns (admitted, alloc_idx, occupied, used,
    rounds, syncs).
    """
    B, tmax, A = lat_ok.shape
    m = grid.shape[1]
    dev = lat_ok.device
    bidx = torch.arange(B, device=dev)
    inc_f = incidence.to(grid.dtype)
    zero = torch.zeros((), dtype=grid.dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=grid.dtype, device=dev)
    neg_b = torch.full((B,), _NEG, dtype=grid.dtype, device=dev)
    big_b = torch.full((B,), B, dtype=torch.int64, device=dev)

    if flexible:
        round_fn = _flex_round_fn(_pack_bits(lat_ok), grid, price, cap, A)
    else:
        def round_fn(occupied, alive):
            G, best_a, _ = _minres_dense(lat_ok, grid, price, cap, cost,
                                         occupied, alive)
            G = torch.where(alive, G, _NEG)
            tau = torch.argmax(G, dim=1)
            return G[bidx, tau], tau, best_a[bidx, tau]

    def body(state):
        admitted, alloc_idx, occupied, alive, used = state
        rem = link_cap - used                                       # (L,)
        headroom = torch.where(incidence, rem[None, :], inf).amin(-1)
        link_ok = load <= headroom[:, None] + 1e-9                  # (B, T)
        v, tau, best_a = round_fn(occupied, alive & link_ok)
        tau, best_a = tau.long(), best_a.long()
        gmax = neg_b.scatter_reduce(0, group, v, "amax")
        att = (v > _NEG) & (v == gmax[group])
        first = big_b.scatter_reduce(0, group, torch.where(att, bidx, B),
                                     "amin")
        admit = att & (bidx == first[group])
        admitted[bidx, tau] |= admit
        alloc_idx[bidx, tau] = torch.where(
            admit, best_a.to(torch.int32), alloc_idx[bidx, tau])
        occupied = occupied + torch.where(admit[:, None], grid[best_a], zero)
        used = used + (torch.where(admit, load[bidx, tau], zero)[:, None]
                       * inc_f).sum(0)
        alive[bidx, tau] &= ~admit
        alive &= (v > _NEG)[:, None]
        return admitted, alloc_idx, occupied, alive, used

    init = _init_state(alive0, m, grid.dtype) + (torch.zeros_like(link_cap),)
    state, rounds, syncs = _run_rounds(body, init, 3)
    return state[0], state[1], state[2], state[4], rounds, syncs


# ---------------------------------------------------------------------------
# Fused serving entry points: device-resident inputs, packed decision output
# ---------------------------------------------------------------------------

def _extract_packed(admitted, alloc_idx, occupied, cap):
    """Pack each batch row's decision into one int32 row ``[admitted
    bitmask (ceil(T/32) words) | alloc_idx]`` plus the (B, m) residual
    capacities, so the host reads back one small buffer per solve."""
    packed = torch.cat([_pack_bits(admitted), alloc_idx.to(torch.int32)],
                       dim=1)
    return packed, cap - occupied


def dispatch_device_batch(dev: DeviceStack, *, flexible: bool = True,
                          inner: str | None = None) -> tuple:
    """Run the device solve of a :class:`DeviceStack` up to its packed
    decisions, without reading them back.

    With ``inner="kernel"`` (CUDA's default) the flexible solve, coupled or
    not, is ONE launch of K1's solve entry (``kernels/pg/pg.py::
    batch_solve``), enqueued without a host sync; otherwise (MinRes,
    ``inner="torch"``) the torch rounds are driven from the host, which
    waits on the device every ``_SYNC_EVERY`` rounds to test convergence.
    The packed decision buffers stay on the device until
    :func:`unpack_device_batch`. Returns a handle that captures the batch
    shape at dispatch, so the unpack does not depend on the (mutable) stack.
    Reads the bindings of ``DeviceStack.inputs()``; see its docstring for
    why later in-place scatters cannot reach this solve.
    """
    inner = resolve_inner(inner, dev.device)
    (lat_ok, grid, price, cap, alive0, cost,
     link_load, link_cap, incidence, group) = dev.inputs()
    if flexible and inner == "kernel":
        from ..kernels.pg import pg as pg_kernel
        admitted, alloc_idx, occupied, used, rounds = \
            pg_kernel.batch_solve(dev)
        syncs = 0
    elif dev.coupled:
        admitted, alloc_idx, occupied, used, rounds, syncs = \
            _batch_solve_coupled(lat_ok, grid, price, cap, alive0, cost,
                                 link_load, link_cap, incidence, group,
                                 flexible)
    else:
        admitted, alloc_idx, occupied, rounds, syncs = _batch_solve(
            lat_ok, grid, price, cap, alive0, cost, flexible)
        used = None
    packed, residual = _extract_packed(admitted, alloc_idx, occupied, cap)
    return (packed, residual, used, dev.batch_size, dev.max_tasks,
            rounds, syncs)


def unpack_device_batch(dispatched: tuple) -> dict:
    """Read a :func:`dispatch_device_batch` handle back to the host (the
    last sync) and unpack it: ``admitted`` (B, Tmax) bool, ``alloc_idx``
    (B, Tmax) int (-1 where never admitted; only ``admitted`` rows are
    meaningful), ``residual`` (B, m), ``link_used`` (L,) (empty when
    uncoupled), and the solve's ``rounds`` and ``syncs``."""
    packed, residual, used, B, tmax, rounds, syncs = dispatched
    packed = packed.cpu().numpy()[:B]    # drop inert pad_batch_to rows
    if isinstance(rounds, torch.Tensor):  # per coupling group, on the device
        rounds = int(rounds.cpu().numpy().max(initial=0))
    wt = -(-tmax // 32)
    bits = packed[:, :wt].astype(np.uint32)
    idx = np.arange(tmax)
    admitted = (bits[:, idx // 32] >> (idx % 32).astype(np.uint32)) & 1 > 0
    return {
        "admitted": admitted,
        "alloc_idx": packed[:, wt:].astype(np.int64),
        "residual": residual.cpu().numpy()[:B],
        "link_used": (np.zeros(0) if used is None
                      else used.cpu().numpy()),
        "rounds": rounds,
        "syncs": syncs + 1,
    }


def solve_device_batch(dev: DeviceStack, *, flexible: bool = True,
                       inner: str | None = None) -> dict:
    """Solve a device-resident stacked batch: dispatch, then unpack."""
    return unpack_device_batch(dispatch_device_batch(
        dev, flexible=flexible, inner=inner))


def solve_greedy_batch(insts, *, semantic: bool = True, flexible: bool = True,
                       inner: str | None = None,
                       pad_batch_to: int | None = None,
                       device="cuda") -> list[Solution]:
    """Batched sweep engine: solve many instances in one batched device solve.

    ``insts`` is a sequence of :class:`ProblemInstance` (stacked on the fly)
    or a pre-built :class:`StackedInstances` sharing one allocation grid.
    Decisions equal the reference's ``solve_greedy_batch``; coupled batches
    (a :class:`~repro_torch.core.types.CouplingSpec` on the stack) admit
    jointly per coupling group. Returns one :class:`Solution` per instance.
    """
    stacked = insts if isinstance(insts, StackedInstances) \
        else stack_instances(insts)
    dev = device_stack(stacked, semantic=semantic, pad_batch_to=pad_batch_to,
                       device=device)
    res = solve_device_batch(dev, flexible=flexible, inner=inner)
    return _pack_batch_solutions(stacked, res["admitted"], res["alloc_idx"],
                                 semantic)


def _pack_batch_solutions(stacked: StackedInstances, admitted: np.ndarray,
                          alloc_idx: np.ndarray,
                          semantic: bool) -> list[Solution]:
    """Vectorized _pack_solution over a whole batch (per-instance Python
    packing would dwarf the device solve at sweep sizes). ``admitted`` /
    ``alloc_idx`` are host (B, Tmax) decision tables in STACKED row order;
    returns one :class:`Solution` per stacked instance, same order."""
    if semantic:
        lat, z_idx = stacked.lat, stacked.z_star_idx
        z_star = stacked.z_star
    else:
        lat, z_idx = stacked.lat_agnostic, stacked.z_star_idx_agnostic
        z_star = stacked.z_star_agnostic
    grid = stacked.grid
    safe_idx = np.clip(alloc_idx, 0, None)
    alloc = grid[safe_idx] * admitted[:, :, None]                 # (B, T, m)
    z = np.where(admitted & (z_idx >= 0), z_star, 1.0)
    a_true = semantics.resolve(stacked.semantics).accuracy(stacked.app_idx, z)
    l_val = np.take_along_axis(lat, safe_idx[:, :, None], axis=2)[:, :, 0]
    l_val = np.where(admitted & (alloc_idx >= 0), l_val, np.inf)
    satisfied = admitted & (a_true + 1e-9 >= stacked.min_accuracy) \
        & (l_val <= stacked.max_latency + 1e-9)
    per_task = (stacked.price[:, None, :]
                * (stacked.capacity[:, None, :] - alloc)).sum(axis=2)
    objective = (per_task * admitted).sum(axis=1)                 # (B,)

    out = []
    for b, inst in enumerate(stacked.instances):
        t = inst.num_tasks
        out.append(Solution(
            admitted=admitted[b, :t], alloc=alloc[b, :t], z=z[b, :t],
            objective=float(objective[b]), satisfied=satisfied[b, :t]))
    return out


# ---------------------------------------------------------------------------
# Sharded (metro-scale) entry points
#
# The reference jits one ``shard_map`` program per (mesh, mode) and caches it
# (``_sharded_solve_fn``, ``_sharded_serve_fn``, ``clear_sharded_caches``).
# The port has no traced program to cache: a sharded solve is one batched
# solve per device, each a K1 launch (or the torch loop) on that device's
# stream, so those three have no counterpart here.
# ---------------------------------------------------------------------------

def _to_input_order(stacked: StackedInstances, sols: list) -> list:
    """Undo a group-major stacking permutation: ``out[perm[b]] = sols[b]``."""
    if stacked.perm is None:
        return sols
    out = [None] * len(sols)
    for b, sol in enumerate(sols):
        out[int(stacked.perm[b])] = sol
    return out


def dispatch_sharded_batch(shd: ShardedStack, *, flexible: bool = True,
                           inner: str | None = None) -> tuple:
    """Run the sharded solve up to its packed decisions, without reading
    them back.

    The mesh-resident sibling of :func:`dispatch_device_batch`: each
    distinct device's stack (``ShardedStack.inputs``) is solved by
    :func:`dispatch_device_batch`, so with ``inner="kernel"`` (CUDA's
    default) a flexible solve enqueues ONE K1 ``batch_solve`` launch per
    device on that device's current stream, with no host sync; the devices
    then solve concurrently. Otherwise each device runs the host loop of
    the torch rounds. The row maps are captured at dispatch, so a session
    replan cannot skew an in-flight tick.
    """
    handles = []
    for st in shd.stacks:
        # a kernel launches on the current device's stream
        with torch.cuda.device(st.device) if st.device.type == "cuda" \
                else contextlib.nullcontext():
            handles.append(dispatch_device_batch(st, flexible=flexible,
                                                 inner=inner))
    return (tuple(handles), shd.dev_of, shd.local_of, shd.row_of,
            shd.batch_size, shd.max_tasks, shd.coupled)


def unpack_sharded_batch(dispatched: tuple) -> dict:
    """Read a :func:`dispatch_sharded_batch` handle back (one read-back per
    device) and unpack it into the :func:`unpack_device_batch` dict, in
    STACKED (input) row order.

    ``row_of`` gathers the live rows back, so callers (the serving session's
    slot unpacker, the twin-engine tests) never see the plan; inert padding
    rows never admit and are dropped. ``link_used`` is the sum of the
    devices' (L,) blocks: each link lives in one shard, hence on one device,
    so the sum is exact; it is empty when the batch is uncoupled.
    ``rounds`` is the largest device's, ``syncs`` the sum over devices.
    """
    handles, dev_of, local_of, row_of, B, tmax, coupled = dispatched
    parts = [unpack_device_batch(h) for h in handles]
    live = row_of >= 0
    src = np.flatnonzero(live)
    dst = row_of[live]
    m = parts[0]["residual"].shape[1]
    admitted = np.zeros((B, tmax), bool)
    alloc_idx = np.full((B, tmax), -1, np.int64)
    residual = np.zeros((B, m), parts[0]["residual"].dtype)
    for i, part in enumerate(parts):
        mine = dev_of[src] == i
        rows = local_of[src[mine]]
        admitted[dst[mine]] = part["admitted"][rows]
        alloc_idx[dst[mine]] = part["alloc_idx"][rows]
        residual[dst[mine]] = part["residual"][rows]
    used = np.zeros(0)
    if coupled:
        blocks = [p["link_used"] for p in parts if p["link_used"].size]
        used = np.sum(blocks, axis=0, dtype=blocks[0].dtype)
    return {
        "admitted": admitted,
        "alloc_idx": alloc_idx,
        "residual": residual,
        "link_used": used,
        "rounds": max(p["rounds"] for p in parts),
        "syncs": sum(p["syncs"] for p in parts),
    }


def solve_sharded_batch(shd: ShardedStack, *, flexible: bool = True,
                        inner: str | None = None) -> dict:
    """Solve a mesh-resident stack: :func:`solve_device_batch` for a
    :class:`~repro_torch.core.sfesp.ShardedStack`. Decisions equal the
    single-device solve on the same rows."""
    return unpack_sharded_batch(dispatch_sharded_batch(
        shd, flexible=flexible, inner=inner))


def solve_greedy_sharded(insts, *, mesh=None, semantic: bool = True,
                         flexible: bool = True, inner: str | None = None,
                         axis: str = "cells") -> list[Solution]:
    """Metro-scale front door: the coupled batched solve sharded over a
    cells mesh, one block of coupling groups per shard.

    ``insts`` is a sequence of :class:`ProblemInstance` (stacked group-major
    on the fly, Tmax padded to a power of two) or a pre-built
    :class:`StackedInstances` (any layout — the sharded device half permutes
    group-major itself). ``mesh`` is a ``launch/mesh.py::CellsMesh``;
    ``None`` builds one shard per visible CUDA device. Solutions come back
    in INPUT order regardless of layout.

    Decisions are bit-identical to :func:`solve_greedy_batch` on the same
    instances: the group-major permutation is stable, so within-group cell
    order — the coupled tie-break — is preserved, and each device runs the
    same batched solve on its groups. A 1-shard mesh IS the single-device
    solve (on the mesh's device), reordered.
    """
    stacked = insts if isinstance(insts, StackedInstances) \
        else stack_instances(
            insts, group_major=True,
            tmax=next_pow2(max((i.num_tasks for i in insts), default=1)))
    if mesh is None:
        from ..launch.mesh import make_cells_mesh
        mesh = make_cells_mesh(axis=axis)
    if int(mesh.shape[axis]) == 1:
        sols = solve_greedy_batch(stacked, semantic=semantic,
                                  flexible=flexible, inner=inner,
                                  device=mesh.devices[0])
        return _to_input_order(stacked, sols)
    shd = device_stack_sharded(stacked, mesh, semantic=semantic, axis=axis)
    res = solve_sharded_batch(shd, flexible=flexible, inner=inner)
    sols = _pack_batch_solutions(stacked, res["admitted"], res["alloc_idx"],
                                 semantic)
    return _to_input_order(stacked, sols)


def solve_greedy_many(insts, *, semantic: bool = True, flexible: bool = True,
                      inner: str | None = None,
                      device="cuda") -> list[Solution]:
    """Grid-grouped sweep dispatcher: batch-solve instances with MIXED grids.

    Groups the instances by grid identity and solves each group through
    :func:`solve_greedy_batch`, padding ``Tmax`` and the batch to
    power-of-two buckets, as the reference does. Returns one
    :class:`Solution` per instance, in input order; decisions are those of
    :func:`solve_greedy_batch` on each group. Backhaul-coupled cells are
    solved jointly within their grid group, so cells of one coupling group
    must share an allocation grid (a link spanning grid groups would have
    its budget double-counted — rejected up front).
    """
    insts = list(insts)
    groups: dict[bytes, list[int]] = {}
    keys: list[bytes] = []
    for i, inst in enumerate(insts):
        key = np.ascontiguousarray(inst.grid).tobytes() \
            + repr(inst.grid.shape).encode()
        keys.append(key)
        groups.setdefault(key, []).append(i)
    link_users: dict[tuple, set] = {}
    for i, inst in enumerate(insts):
        spec = inst.coupling
        if spec is None:
            continue
        for link in np.nonzero(spec.incidence[0])[0]:
            # link sets are identified by capacity-array identity, matching
            # the merge_coupling contract
            lid = (id(spec.link_capacity), int(link))
            link_users.setdefault(lid, set()).add(keys[i])
    if any(len(g) > 1 for g in link_users.values()):
        raise ValueError(
            "backhaul-coupled cells must share one allocation grid "
            "(identical pool.levels); a shared link cannot span grid groups")
    out: list[Solution | None] = [None] * len(insts)
    for idxs in groups.values():
        sub = [insts[i] for i in idxs]
        tmax = next_pow2(max(inst.num_tasks for inst in sub))
        stacked = stack_instances(sub, tmax=tmax)
        sols = solve_greedy_batch(stacked, semantic=semantic,
                                  flexible=flexible, inner=inner,
                                  pad_batch_to=next_pow2(len(sub)),
                                  device=device)
        for i, sol in zip(idxs, sols):
            out[i] = sol
    return out


def solve(inst: ProblemInstance, *, semantic: bool = True,
          flexible: bool = True, backend: str = "numpy",
          inner: str | None = None, device="cuda") -> Solution:
    """Front door used by serving admission (``SESM.slice``) and the
    evaluation: ``backend="numpy"`` is the oracle, ``"torch"`` the
    single-instance device solve :func:`solve_greedy_torch` on ``device``
    (``inner`` as there)."""
    if backend == "numpy":
        return solve_greedy(inst, semantic=semantic, flexible=flexible)
    if backend != "torch":
        raise ValueError(f"backend must be 'numpy' or 'torch', got "
                         f"{backend!r}")
    return solve_greedy_torch(inst, semantic=semantic, flexible=flexible,
                              inner=inner, device=device)
