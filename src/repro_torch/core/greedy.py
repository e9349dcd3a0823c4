"""Port of ``src/repro/core/greedy.py``: paper Algorithm 1 (primal effective
gradient greedy), as a numpy oracle and as the batched device solve.

* :func:`solve_greedy` — the readable numpy reference of Alg. 1, copied from
  the JAX package; the oracle of the tests.
* :func:`solve_greedy_batch` / :func:`solve_device_batch` /
  :func:`dispatch_device_batch` — the batched sweep and serving engine over
  a :class:`~repro_torch.core.sfesp.DeviceStack`, uncoupled and coupled, in
  all four (semantic × flexible) quadrants.

The flexible round (Eq. 3) has two interchangeable implementations:
``inner="kernel"`` launches K1 (``kernels/pg/pg.py::batch_round``, the CUDA
counterpart of the reference's ``inner="pallas"``) and ``inner="torch"`` runs
the bit-domain round of the reference's ``_flex_round_fn`` as torch ops (the
counterpart of ``inner="jnp"``). ``inner=None`` follows the device, as the
reference's ``resolve_interpret`` follows the backend: CUDA gets the kernel,
the CPU gets the torch round, and ``"kernel"`` on a CPU device raises. Both
give the same decisions. The MinRes path (``flexible=False``) stays the dense
per-instance round, as in the reference, which has no kernel there.

The reference runs the admission loop as one ``lax.while_loop``; the port
drives it from the host, one device round at a time. Rounds after
convergence are no-ops (every update is masked by ``v > -inf``), so the loop
tests ``alive.any()`` — a host sync — only once every ``_SYNC_EVERY`` rounds
without changing a decision. The result dicts report ``rounds`` run and
``syncs`` (device waits, including the decision read-back).

Two facts about the reference, so nobody chases a phantom mismatch:

* The JAX serving tick as shipped never runs K1: ``MultiCellEngine`` builds
  its ``SESM`` without ``inner``, which defaults to ``"jnp"``, so
  ``dispatch_device_batch`` runs the jnp bit-domain round. K1 runs only
  through ``SESM(inner="pallas")`` or ``solve_greedy_batch(inner="pallas")``.
  The port puts K1 on the tick whenever the device is CUDA.
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

import numpy as np
import torch

from . import semantics
from .sfesp import (DeviceStack, device_stack, lexicographic_cost,
                    objective_value, stack_instances)
from .types import ProblemInstance, Solution, StackedInstances

__all__ = ["primal_gradient", "solve_greedy", "solve_greedy_batch", "solve",
           "solve_device_batch", "dispatch_device_batch",
           "unpack_device_batch", "resolve_inner", "lexicographic_cost"]

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
# Device backend: host-driven rounds over device tensors
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
            "inner='kernel' launches the CUDA kernel K1 and needs a CUDA "
            f"device (got {device}); use inner='torch' or None on the CPU")
    return inner


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


def _flex_round_fn(inner: str, lat_bits, grid, price, cap, A):
    """The flexible-mode batched round: (occupied, alive) → (V, tau, s*).

    ``"kernel"`` is K1; ``"torch"`` is the reference's bit-domain jnp round:
    V = max PG over cap-feasible columns feasible for an alive task, tau =
    first alive task whose row intersects {PG == V}, s* = tau's first-max
    allocation. The coupled solve folds its link feasibility into ``alive``,
    so neither round knows about coupling.
    """
    if inner == "kernel":
        from ..kernels.pg import pg as pg_kernel

        def round_fn(occupied, alive):
            return pg_kernel.batch_round(lat_bits, alive, grid, price, cap,
                                         occupied)
        return round_fn

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


def _batch_solve(lat_ok, grid, price, cap, alive0, cost, flexible: bool,
                 inner: str):
    """Uncoupled batched solve: (admitted, alloc_idx, occupied, rounds,
    syncs). ``lat_ok`` (B, Tmax, A), ``price``/``cap`` (B, m), ``alive0``
    (B, Tmax); ``grid``/``cost`` shared (A, m)/(A,). Finished instances run
    masked no-op rounds until the whole batch converges."""
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
        round_fn = _flex_round_fn(inner, _pack_bits(lat_ok), grid, price,
                                  cap, A)

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
                         link_cap, incidence, group, flexible: bool,
                         inner: str):
    """Coupled batched solve: cells sharing backhaul links admit JOINTLY.

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
        round_fn = _flex_round_fn(inner, _pack_bits(lat_ok), grid, price,
                                  cap, A)
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

    The admission rounds are driven from the host (the loop waits on the
    device every ``_SYNC_EVERY`` rounds to test convergence); the packed
    decision buffers stay on the device until :func:`unpack_device_batch`.
    Returns a handle that captures the batch shape at dispatch, so the
    unpack does not depend on the (mutable) stack. Reads the bindings of
    ``DeviceStack.inputs()``; see its docstring for why later in-place
    scatters cannot reach this solve.
    """
    inner = resolve_inner(inner, dev.device)
    (lat_ok, grid, price, cap, alive0, cost,
     link_load, link_cap, incidence, group) = dev.inputs()
    if dev.coupled:
        admitted, alloc_idx, occupied, used, rounds, syncs = \
            _batch_solve_coupled(lat_ok, grid, price, cap, alive0, cost,
                                 link_load, link_cap, incidence, group,
                                 flexible, inner)
    else:
        admitted, alloc_idx, occupied, rounds, syncs = _batch_solve(
            lat_ok, grid, price, cap, alive0, cost, flexible, inner)
        used = None
    packed, residual = _extract_packed(admitted, alloc_idx, occupied, cap)
    return (packed, residual, used, dev.batch_size, dev.max_tasks,
            rounds, syncs)


def unpack_device_batch(dispatched: tuple) -> dict:
    """Read a :func:`dispatch_device_batch` handle back to the host (the
    last sync) and unpack it: ``admitted`` (B, Tmax) bool, ``alloc_idx``
    (B, Tmax) int (-1 where never admitted; only ``admitted`` rows are
    meaningful), ``residual`` (B, m), ``link_used`` (L,) (empty when
    uncoupled), and the loop's ``rounds`` and ``syncs``."""
    packed, residual, used, B, tmax, rounds, syncs = dispatched
    packed = packed.cpu().numpy()[:B]    # drop inert pad_batch_to rows
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




def solve(inst: ProblemInstance, *, semantic: bool = True,
          flexible: bool = True, backend: str = "numpy") -> Solution:
    """Front door of single-cell serving admission (``SESM.slice``).

    ``backend="numpy"`` is the oracle. The reference's device backend is
    ``solve_greedy_jax``, the single-instance solve over kernel K2, which is
    not ported yet (ROADMAP.md, queue 1 item 4 and queue 2)."""
    if backend == "numpy":
        return solve_greedy(inst, semantic=semantic, flexible=flexible)
    raise NotImplementedError(
        f"backend {backend!r}: the single-instance device solve needs "
        "kernel K2, not ported yet (ROADMAP.md queue 2)")
