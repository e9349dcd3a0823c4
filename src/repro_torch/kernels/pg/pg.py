"""K1 and K2, the admission rounds' kernels, and their plain PyTorch
versions.

Port of ``src/repro/kernels/pg/pg.py`` (the Pallas kernels) and
``src/repro/kernels/pg/ref.py`` (their oracles):

* K1, two entries of ``csrc/pg_round.cu`` over one word-parallel round
  (its design note explains the layout that replaces the TPU's sequential
  T-block carry):

  - :func:`batch_solve` — the path's: ALL flexible rounds of a
    :class:`~repro_torch.core.sfesp.DeviceStack`, coupled or not, to
    convergence, in one launch (one thread-block cluster per coupling
    group), counted in ``SOLVE_KERNEL``; its plain version
    :func:`batch_solve_ref` is ``core/greedy.py``'s host loop over the
    torch round.
  - :func:`batch_round` — the Pallas kernel's contract, one round, counted
    in ``ROUND_KERNEL``; on no path. Packed latency words are ``int32``
    tensors holding the reference's ``uint32`` bit pattern (bit k of word w
    is allocation 32·w + k — ``greedy._pack_bits``); the kernel reads them
    as ``uint32``.

* K2, two entries of ``csrc/masked_argmax.cu`` over one row reduction (one
  warp per task row): :func:`masked_argmax`, the Pallas kernel's contract
  (sel given), and :func:`bind_round`, the single-instance solve's whole
  admission round in one launch — gradient, capacity mask, per-row first
  max, the pick of tau and the state update.

Each wrapper launches its kernel for CUDA tensors and computes its plain
version (``*_ref``) for CPU tensors, and counts its launches on its
:class:`~repro_torch.kernels._build.CudaKernel`. No shape limit: any m
(the gradient's pool terms sit in shared memory sized by m) and any A
(what does not fit shared memory goes to a scratch read through L2).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import CudaKernel, current_stream

__all__ = ["ADMIT_KERNEL", "ARGMAX_KERNEL", "ROUND_KERNEL", "SOLVE_KERNEL",
           "admission_round_ref", "batch_round", "batch_round_ref",
           "batch_solve", "batch_solve_ref", "bind_round", "masked_argmax",
           "masked_argmax_ref", "solve_info"]

_P = ctypes.c_void_p
_I = ctypes.c_int
ROUND_KERNEL = CudaKernel(
    "pg_round.cu", "pg_round_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P])
SOLVE_KERNEL = CudaKernel("pg_round.cu", "pg_solve_launch", [_P, _P])
ARGMAX_KERNEL = CudaKernel(
    "masked_argmax.cu", "masked_argmax_launch",
    [_P, _P, _P, _P, _I, _I, _P, _P, _P])
ADMIT_KERNEL = CudaKernel(
    "masked_argmax.cu", "admission_round_launch", [_P, _P])
# a coupling group's cluster: min(the largest group, the portable size)
CLUSTER_MAX = 8
TRACE_POINTS = 5   # kTracePoints in csrc/pg_round.cu: stamps a traced round


def batch_round_ref(lat_ok, alive, grid, price, cap, occupied):
    """Dense plain version of one flexible round (``pg/ref.py:35``).

    lat_ok (B, T, A) bool; alive (B, T) bool; grid (A, m) f32;
    price/cap/occupied (B, m) f32. Materializes the (B, T, A) score tensor:
    V = max feasible PG per instance, tau = first alive task attaining it,
    best_a = tau's first-max allocation; V = -inf, tau = best_a = 0 when
    nothing is feasible. The gradient is :func:`repro_torch.core.greedy.
    _batch_pg`, the same formula the kernel evaluates.
    """
    from ...core.greedy import _batch_pg

    remaining = cap - occupied
    cap_ok = (grid[None] <= remaining[:, None, :] + 1e-9).all(-1)     # (B, A)
    pg = _batch_pg(grid, price, cap, occupied)                        # (B, A)
    feas = lat_ok & cap_ok[:, None, :] & alive[:, :, None]            # (B,T,A)
    neg = torch.tensor(float("-inf"), dtype=pg.dtype, device=pg.device)
    score = torch.where(feas, pg[:, None, :], neg)
    row_max = score.amax(dim=2)                                       # (B, T)
    v = row_max.amax(dim=1)
    tau = torch.argmax(row_max, dim=1)
    sel = torch.take_along_dim(score, tau[:, None, None], dim=1)[:, 0]
    best_a = torch.argmax(sel, dim=1)
    return v, tau.to(torch.int32), best_a.to(torch.int32)


def _check(lat_bits, alive, grid, price, cap, occupied):
    b, t, w = lat_bits.shape
    a, m = grid.shape
    if lat_bits.dtype != torch.int32:
        raise TypeError(f"lat_bits must be int32 words, got {lat_bits.dtype}")
    if alive.dtype != torch.bool or alive.shape != (b, t):
        raise TypeError(f"alive must be bool ({b}, {t}), got "
                        f"{alive.dtype} {tuple(alive.shape)}")
    for name, x, shape in (("grid", grid, (a, m)), ("price", price, (b, m)),
                           ("cap", cap, (b, m)),
                           ("occupied", occupied, (b, m))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise TypeError(f"{name} must be float32 {shape}, got "
                            f"{x.dtype} {tuple(x.shape)}")
    if m < 1 or not 1 <= a <= w * 32:
        raise ValueError(f"grid ({a}, {m}) does not fit W={w} words")
    dev = lat_bits.device
    for x in (alive, grid, price, cap, occupied):
        if x.device != dev:
            raise ValueError("batch_round inputs must share one device")


@functools.lru_cache(maxsize=64)
def _round_needs_scratch(t: int, w: int, a: int, m: int) -> bool:
    fn = ROUND_KERNEL.library().pg_round_needs_scratch
    fn.argtypes = [_I, _I, _I, _I]
    fn.restype = _I
    return bool(fn(t, w, a, m))


def batch_round(lat_bits, alive, grid, price, cap, occupied):
    """One fused flexible admission round for a stacked batch.

    Args:
      lat_bits: (B, T, W) int32 — packed latency feasibility (uint32 bits).
      alive: (B, T) bool — the round's candidate mask.
      grid: (A, m) float32 — shared allocation grid.
      price, cap, occupied: (B, m) float32 — per-instance pool state.

    Returns ``(v (B,) f32, tau (B,) i32, best_a (B,) i32)``. A CUDA tensor
    launches ``csrc/pg_round.cu``'s one-round entry (counted in
    ``ROUND_KERNEL.launches``; where the (A,) scores do not fit shared
    memory they go to a (B, A) scratch); a CPU tensor computes
    :func:`batch_round_ref` on the unpacked bits.
    """
    _check(lat_bits, alive, grid, price, cap, occupied)
    if lat_bits.device.type == "cpu":
        from ...core.greedy import _unpack_bits
        return batch_round_ref(_unpack_bits(lat_bits, grid.shape[0]), alive,
                               grid, price, cap, occupied)
    if lat_bits.device.type != "cuda":
        raise ValueError(f"unsupported device {lat_bits.device}")
    b, t, w = lat_bits.shape
    a, m = grid.shape
    bits, alive, grid, price, cap, occupied = (
        x.contiguous() for x in (lat_bits, alive, grid, price, cap, occupied))
    v = price.new_empty(b)
    tau = bits.new_empty(b)
    best_a = bits.new_empty(b)
    scratch = price.new_empty((b, a)) if _round_needs_scratch(t, w, a, m) \
        else None
    ROUND_KERNEL(bits.data_ptr(), alive.data_ptr(), grid.data_ptr(),
                 price.data_ptr(), cap.data_ptr(), occupied.data_ptr(),
                 b, t, w, a, m, v.data_ptr(), tau.data_ptr(),
                 best_a.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 current_stream(bits.get_device()))
    return v, tau, best_a


# ------------------------------------------------- K1's whole batched solve

def batch_solve_ref(stack):
    """Plain version of :func:`batch_solve`: ``core/greedy.py``'s host loop
    over the torch round (``_batch_solve`` / ``_batch_solve_coupled``,
    ``flexible=True``) on the stack's tensors. Returns ``(admitted (B', T)
    bool, alloc_idx (B', T) int32, occupied (B', m) f32, used (L,) f32 or
    None, rounds)``, ``rounds`` a one-element int32 tensor: the loop's
    rounds, a multiple of its convergence test's period."""
    from ...core import greedy

    (lat_ok, grid, price, cap, alive0, cost,
     load, link_cap, incidence, group) = stack.inputs()
    if stack.coupled:
        admitted, alloc_idx, occupied, used, rounds, _ = \
            greedy._batch_solve_coupled(lat_ok, grid, price, cap, alive0,
                                        cost, load, link_cap, incidence,
                                        group, flexible=True)
    else:
        admitted, alloc_idx, occupied, rounds, _ = greedy._batch_solve(
            lat_ok, grid, price, cap, alive0, cost, flexible=True)
        used = None
    return (admitted, alloc_idx, occupied, used,
            torch.tensor([rounds], dtype=torch.int32, device=grid.device))


class _SolveArgs(ctypes.Structure):
    """``SolveArgs`` of ``csrc/pg_round.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lat_ok", "alive0", "load", "grid", "price", "cap", "link_cap",
        "grp_rows", "grp_off", "lnk_ids", "lnk_off", "cell_lnk",
        "cell_lnk_off", "admitted", "alloc_idx", "occupied", "used",
        "rounds", "score_scratch", "word_scratch", "info", "trace")] + [
        (name, ctypes.c_int) for name in (
            "B", "T", "A", "m", "W", "G", "coupled", "cluster",
            "max_members", "max_links", "max_cell_links", "trace_rounds")]


_INFO = ("smem_bytes", "cluster", "cells_per_cta", "place",
         "max_active_clusters", "blocks", "registers", "local_bytes",
         "static_smem_bytes", "smem_budget")
_info = (ctypes.c_longlong * 12)()


def solve_info() -> dict:
    """The plan of the last :func:`batch_solve` launch (or plan), as the
    launcher wrote it: dynamic shared memory, cluster size, cells a CTA,
    what sits in shared memory (``place``: 1 scores, 2 words, 4 grid), the
    clusters that fit at once, blocks, and the kernel's registers, local
    (spill) bytes and static shared memory."""
    return {k: int(v) for k, v in zip(_INFO, _info)}


def _solve_args(stack):
    (lat_ok, grid, price, cap, alive0, _, load, link_cap,
     _, _) = stack.inputs()
    rows, t, a = lat_ok.shape
    m = grid.shape[1]
    csr = stack.group_csr
    if stack.coupled and csr is None:
        raise ValueError("a coupled stack needs its group_csr")
    for name, x, dtype in (("lat_ok", lat_ok, torch.bool),
                           ("alive0", alive0, torch.bool),
                           ("load", load, torch.float32),
                           ("grid", grid, torch.float32),
                           ("price", price, torch.float32),
                           ("capacity", cap, torch.float32)):
        if x.dtype != dtype or not x.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dtype} tensor")
    args = _SolveArgs()
    ptrs = dict(lat_ok=lat_ok, alive0=alive0, load=load, grid=grid,
                price=price, cap=cap)
    if stack.coupled:
        ptrs.update(link_cap=link_cap, grp_rows=csr.rows,
                    grp_off=csr.offsets, lnk_ids=csr.links,
                    lnk_off=csr.link_offsets, cell_lnk=csr.cell_links,
                    cell_lnk_off=csr.cell_link_offsets)
    for name, x in ptrs.items():
        setattr(args, name, x.data_ptr())
    args.info = ctypes.addressof(_info)
    args.B, args.T, args.A, args.m, args.W = rows, t, a, m, -(-a // 32)
    args.coupled = int(stack.coupled)
    args.G = csr.num_groups if stack.coupled else rows
    args.max_members = csr.max_members if stack.coupled else 1
    args.max_links = csr.max_links if stack.coupled else 0
    args.max_cell_links = csr.max_cell_links if stack.coupled else 0
    args.cluster = min(CLUSTER_MAX, args.max_members) if stack.coupled else 1
    return args


@functools.lru_cache(maxsize=64)
def _solve_place(key) -> int:
    """Placement bits of the solve's plan for a shape (``pg_solve_plan``):
    what the launch keeps in shared memory, hence which scratch it needs."""
    (rows, t, a, m, coupled, cluster, max_members, max_links,
     max_cell_links) = key
    args = _SolveArgs(info=ctypes.addressof(_info), B=rows, T=t, A=a, m=m,
                      W=-(-a // 32), G=1, coupled=coupled, cluster=cluster,
                      max_members=max_members, max_links=max_links,
                      max_cell_links=max_cell_links)
    fn = SOLVE_KERNEL.library().pg_solve_plan
    fn.argtypes = [_P]
    fn.restype = _I
    code = fn(ctypes.addressof(args))
    if code != 0:
        raise RuntimeError(f"pg_solve_plan: CUDA error {code}")
    return int(_info[3])


def batch_solve(stack, *, trace=None):
    """All flexible admission rounds of a stacked batch, to convergence.

    ``stack`` is a :class:`~repro_torch.core.sfesp.DeviceStack`, coupled or
    not. Returns ``(admitted (B', T) bool, alloc_idx (B', T) int32,
    occupied (B', m) f32, used (L,) f32 or None, rounds)``: the final state
    of ``greedy._batch_solve`` / ``_batch_solve_coupled`` with
    ``flexible=True``, bit for bit. On CUDA tensors it is one launch of
    ``csrc/pg_round.cu``'s solve entry (counted in
    ``SOLVE_KERNEL.launches``), a cluster of min(``CLUSTER_MAX``, the
    largest group) CTAs per coupling group, and ``rounds`` is each group's
    round count (G,) int32; nothing waits on the device. On CPU tensors it is
    :func:`batch_solve_ref`. A launch the card refuses (a cluster whose
    shared memory does not fit) raises with the launch plan; there is no
    other route.

    ``trace`` (a diagnostic, CUDA only): an int64 tensor of 2 + 5·R
    elements on the card that receives CTA 0's ``%globaltimer`` (ns) at
    entry, after the prologue, and in each of its first R rounds at its
    start, after the candidates' barrier, before and after the group's
    pick (cluster barrier and reduction) and after the admission.
    """
    lat_ok = stack.lat_ok
    if lat_ok.device.type == "cpu":
        return batch_solve_ref(stack)
    if lat_ok.device.type != "cuda":
        raise ValueError(f"unsupported device {lat_ok.device}")
    args = _solve_args(stack)
    rows, t, a, m = args.B, args.T, args.A, args.m
    place = _solve_place((rows, t, a, m, args.coupled, args.cluster,
                          args.max_members, args.max_links,
                          args.max_cell_links))
    grid = stack.grid
    admitted = torch.empty((rows, t), dtype=torch.bool, device=grid.device)
    alloc_idx = torch.empty((rows, t), dtype=torch.int32, device=grid.device)
    occupied = grid.new_empty((rows, m))
    rounds = alloc_idx.new_empty(args.G)
    used = torch.zeros_like(stack.link_cap) if stack.coupled else None
    outs = dict(admitted=admitted, alloc_idx=alloc_idx, occupied=occupied,
                rounds=rounds)
    if used is not None:
        outs["used"] = used
    if not place & 1:
        outs["score_scratch"] = grid.new_empty((rows, 3 * a))
    if not place & 2:
        outs["word_scratch"] = alloc_idx.new_empty((rows, t, args.W))
    if trace is not None:
        if trace.dtype != torch.int64 or trace.device != grid.device \
                or trace.numel() < 2:
            raise TypeError("trace must be an int64 tensor on the card")
        outs["trace"] = trace
        args.trace_rounds = (trace.numel() - 2) // TRACE_POINTS
    for name, x in outs.items():
        setattr(args, name, x.data_ptr())
    try:
        SOLVE_KERNEL(ctypes.addressof(args), current_stream(grid.get_device()))
    except RuntimeError as e:
        raise RuntimeError(f"{e}; launch plan {solve_info()}") from None
    return admitted, alloc_idx, occupied, used, rounds


# ------------------------------------------------------------------- K2

_MASKS = (torch.bool, torch.uint8, torch.int8)
_NEG = float("-inf")


def masked_argmax_ref(sel, lat_ok, cap_ok, alive):
    """Plain version of K2 (``pg/ref.py:24``): materializes the (T, A)
    score ``sel[a]`` where ``lat_ok[t, a] ∧ cap_ok[a] ∧ alive[t]``, else
    -inf, and returns ``(g (T,) f32, idx (T,) i32)``: each row's first
    argmax and the value there. A row with nothing feasible, or whose max is
    -inf, gets g = -inf and idx = 0. ``g`` is read at ``idx`` (not reduced
    separately), so it is the very value the kernel copies."""
    feas = (lat_ok != 0) & (cap_ok != 0)[None, :] & (alive != 0)[:, None]
    neg = torch.tensor(_NEG, dtype=torch.float32, device=sel.device)
    score = torch.where(feas, sel.to(torch.float32)[None, :], neg)
    idx = torch.argmax(score, dim=1)
    g = torch.take_along_dim(score, idx[:, None], dim=1)[:, 0]
    return g, idx.to(torch.int32)


def _check_argmax(sel, lat_ok, cap_ok, alive):
    """The guards against a misread, on cheap attributes: the common case
    is one combined test; a failing input is explained on the slow path."""
    if lat_ok.dim() != 2:
        raise TypeError(f"lat_ok must be (T, A), got {tuple(lat_ok.shape)}")
    t, a = lat_ok.shape
    if not (a >= 1 and sel.dtype == torch.float32 and sel.shape == (a,)
            and lat_ok.dtype in _MASKS and cap_ok.dtype in _MASKS
            and alive.dtype in _MASKS and cap_ok.shape == (a,)
            and alive.shape == (t,)):
        _explain_argmax(sel, lat_ok, cap_ok, alive)
    if not (sel.get_device() == lat_ok.get_device() == cap_ok.get_device()
            == alive.get_device()):
        raise ValueError("masked_argmax inputs must share one device")


def _explain_argmax(sel, lat_ok, cap_ok, alive):
    t, a = lat_ok.shape
    if a < 1:
        raise ValueError("masked_argmax needs at least one allocation")
    if sel.dtype != torch.float32 or sel.shape != (a,):
        raise TypeError(f"sel must be float32 ({a},), got {sel.dtype} "
                        f"{tuple(sel.shape)}")
    for name, x, shape in (("lat_ok", lat_ok, (t, a)),
                           ("cap_ok", cap_ok, (a,)),
                           ("alive", alive, (t,))):
        if x.dtype not in _MASKS or x.shape != shape:
            raise TypeError(f"{name} must be a bool/uint8/int8 mask {shape}, "
                            f"got {x.dtype} {tuple(x.shape)}")


def masked_argmax(sel, lat_ok, cap_ok, alive):
    """Masked row max / first argmax against a shared per-allocation score.

    Args:
      sel: (A,) float32 — the score (primal gradient, or -cost for MinRes).
      lat_ok: (T, A) bool/uint8/int8 — per-task latency feasibility.
      cap_ok: (A,) bool/uint8/int8 — allocation fits the remaining capacity.
      alive: (T,) bool/uint8/int8 — the round's candidate mask.

    Returns ``(g (T,) f32, idx (T,) i32)`` as :func:`masked_argmax_ref`.
    A CUDA tensor launches ``csrc/masked_argmax.cu``'s ``masked_argmax``
    entry (counted in ``ARGMAX_KERNEL.launches``); a CPU tensor computes
    the plain version.
    """
    _check_argmax(sel, lat_ok, cap_ok, alive)
    if not sel.is_cuda:
        if sel.device.type != "cpu":
            raise ValueError(f"unsupported device {sel.device}")
        return masked_argmax_ref(sel, lat_ok, cap_ok, alive)
    if not (sel.is_contiguous() and lat_ok.is_contiguous()
            and cap_ok.is_contiguous() and alive.is_contiguous()):
        sel, lat_ok, cap_ok, alive = (
            x.contiguous() for x in (sel, lat_ok, cap_ok, alive))
    t, a = lat_ok.shape
    out = sel.new_empty((2, t), dtype=torch.int32)   # one allocation
    g, idx = out.unbind(0)
    g = g.view(torch.float32)
    ARGMAX_KERNEL(sel.data_ptr(), lat_ok.data_ptr(), cap_ok.data_ptr(),
                  alive.data_ptr(), t, a, g.data_ptr(), idx.data_ptr(),
                  current_stream(sel.get_device()))
    return g, idx


# ---------------------------------------------- K2's single-instance round

def admission_round_ref(state, lat_ok, grid, price, cap, cost, flexible):
    """Plain version of the round kernel: one admission round of the
    single-instance solve, written into ``state`` in place.

    ``state`` is the solve's ``(admitted (T,) bool, alloc_idx (T,) int32,
    occupied (m,) f32, alive (T,) bool)``; ``lat_ok`` (T, A) bool, ``grid``
    (A, m), ``price``/``cap`` (m,) and ``cost`` (A,) float32. The inner step
    is ``kernels/pg/ops.py::pg_argmax``'s on K2's plain version — the
    gradient, the capacity mask, each row's first max of sel (PG, or -cost
    in MinRes mode), ``has`` = any feasible column and G = PG at the pick —
    and the update is ``core/greedy.py::_round``'s.
    """
    from ...core.greedy import _round, primal_gradient

    def inner(grid, price, cap, occupied, remaining, lat_ok, alive, cost):
        cap_ok = (grid <= remaining[None, :] + 1e-9).all(dim=1)      # (A,)
        pg = primal_gradient(grid, price, cap, occupied)             # (A,)
        _, best_a = masked_argmax_ref(pg if flexible else -cost, lat_ok,
                                      cap_ok, alive)
        best_a = best_a.long()
        has = (lat_ok & cap_ok[None, :] & alive[:, None]).any(dim=1)
        return torch.where(has, pg[best_a], _NEG), best_a, has

    new = _round(state, lat_ok, grid, price, cap, cost, inner)
    for old, value in zip(state, new):
        if value is not old:
            old.copy_(value)


class _RoundArgs(ctypes.Structure):
    """``RoundArgs`` of ``csrc/masked_argmax.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lat_ok", "grid", "price", "cap", "cost", "admitted", "alloc_idx",
        "occupied", "alive", "g", "best_a", "ticket")] + [
        (name, ctypes.c_int) for name in ("T", "A", "m", "flexible")]


class _BoundRound:
    """One solve's round kernel: the tables, the state and a scratch (G,
    best_a, the ticket) bound once; each call is one launch on the caller's
    current stream, with no allocation."""

    def __init__(self, state, lat_ok, grid, price, cap, cost, flexible):
        t, a = lat_ok.shape
        self._keep = (state, lat_ok, grid, price, cap, cost)
        self._scratch = grid.new_zeros(2 * t + 1, dtype=torch.int32)
        g, best_a, ticket = (self._scratch[:t], self._scratch[t:2 * t],
                             self._scratch[2 * t:])
        admitted, alloc_idx, occupied, alive = state
        self._args = _RoundArgs(
            *(x.data_ptr() for x in (lat_ok, grid, price, cap, cost,
                                     admitted, alloc_idx, occupied, alive,
                                     g, best_a, ticket)),
            t, a, grid.shape[1], int(flexible))
        self._ptr = ctypes.addressof(self._args)
        self._device = grid.get_device()

    def __call__(self) -> None:
        ADMIT_KERNEL(self._ptr, current_stream(self._device))


def _check_round(state, lat_ok, grid, price, cap, cost):
    admitted, alloc_idx, occupied, alive = state
    if lat_ok.dim() != 2 or grid.dim() != 2:
        raise TypeError("lat_ok must be (T, A) and grid (A, m)")
    t, a = lat_ok.shape
    m = grid.shape[1]
    if a < 1 or grid.shape[0] != a or m < 1:
        raise ValueError(f"grid {tuple(grid.shape)} does not fit A={a} "
                         "(or has no resource)")
    for name, x, dtype, shape in (
            ("lat_ok", lat_ok, torch.bool, (t, a)),
            ("grid", grid, torch.float32, (a, m)),
            ("price", price, torch.float32, (m,)),
            ("cap", cap, torch.float32, (m,)),
            ("cost", cost, torch.float32, (a,)),
            ("admitted", admitted, torch.bool, (t,)),
            ("alloc_idx", alloc_idx, torch.int32, (t,)),
            ("occupied", occupied, torch.float32, (m,)),
            ("alive", alive, torch.bool, (t,))):
        if x.dtype != dtype or x.shape != shape:
            raise TypeError(f"{name} must be {dtype} {shape}, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != grid.device:
            raise ValueError("the round's state and tables must share one "
                             "device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous: the round writes "
                             "the state in place")


def bind_round(state, lat_ok, grid, price, cap, cost, *, flexible: bool):
    """Bind one single-instance solve's admission round; returns a callable
    that runs one round, in place on ``state`` (arguments as
    :func:`admission_round_ref`).

    On CUDA tensors each call launches ``csrc/masked_argmax.cu``'s
    ``admission_round`` entry once (counted in ``ADMIT_KERNEL.launches``);
    the tables, the state and a scratch are bound here, once per solve. On
    CPU tensors each call runs :func:`admission_round_ref`.
    """
    _check_round(state, lat_ok, grid, price, cap, cost)
    if grid.is_cuda:
        return _BoundRound(state, lat_ok, grid, price, cap, cost, flexible)
    if grid.device.type != "cpu":
        raise ValueError(f"unsupported device {grid.device}")
    return functools.partial(admission_round_ref, state, lat_ok, grid, price,
                             cap, cost, flexible)
