"""K1 and K2, the admission rounds' kernels, and their plain PyTorch
versions.

Port of ``src/repro/kernels/pg/pg.py`` (the Pallas kernels) and
``src/repro/kernels/pg/ref.py`` (their oracles):

* K1, :func:`batch_round` — one fused flexible round of the batched solve
  (``csrc/pg_round.cu``; its design note explains the one-block-per-instance
  layout that replaces the TPU's sequential T-block carry). Packed latency
  words are ``int32`` tensors holding the reference's ``uint32`` bit pattern
  (bit k of word w is allocation 32·w + k — ``greedy._pack_bits``); the
  kernel reads them as ``uint32``.
* K2, two entries of ``csrc/masked_argmax.cu`` over one row reduction (one
  warp per task row): :func:`masked_argmax`, the Pallas kernel's contract
  (sel given), and :func:`bind_round`, the single-instance solve's whole
  admission round in one launch — gradient, capacity mask, per-row first
  max, the pick of tau and the state update.

Each wrapper launches its kernel for CUDA tensors and computes its plain
version (``*_ref``) for CPU tensors, and counts its launches on its
:class:`~repro_torch.kernels._build.CudaKernel`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import CudaKernel, current_stream

__all__ = ["ADMIT_KERNEL", "ARGMAX_KERNEL", "ROUND_KERNEL",
           "admission_round_ref", "batch_round", "batch_round_ref",
           "bind_round", "masked_argmax", "masked_argmax_ref"]

_P = ctypes.c_void_p
_I = ctypes.c_int
ROUND_KERNEL = CudaKernel(
    "pg_round.cu", "pg_round_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P])
ARGMAX_KERNEL = CudaKernel(
    "masked_argmax.cu", "masked_argmax_launch",
    [_P, _P, _P, _P, _I, _I, _P, _P, _P])
ADMIT_KERNEL = CudaKernel(
    "masked_argmax.cu", "admission_round_launch", [_P, _P])
_MAX_M = 8                  # kPgMaxM in pg_grad.cuh
_MAX_LANES = 48 * 1024 // 4  # (A,) f32 scores in default shared memory


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
    if not 1 <= m <= _MAX_M:
        raise ValueError(f"m={m} outside the kernel's 1..{_MAX_M}")
    if a > w * 32 or a > _MAX_LANES:
        raise ValueError(f"A={a} does not fit W={w} words or shared memory")
    dev = lat_bits.device
    for x in (alive, grid, price, cap, occupied):
        if x.device != dev:
            raise ValueError("batch_round inputs must share one device")


def batch_round(lat_bits, alive, grid, price, cap, occupied):
    """One fused flexible admission round for a stacked batch.

    Args:
      lat_bits: (B, T, W) int32 — packed latency feasibility (uint32 bits).
      alive: (B, T) bool — the round's candidate mask.
      grid: (A, m) float32 — shared allocation grid.
      price, cap, occupied: (B, m) float32 — per-instance pool state.

    Returns ``(v (B,) f32, tau (B,) i32, best_a (B,) i32)``. A CUDA tensor
    launches ``csrc/pg_round.cu`` (counted in ``ROUND_KERNEL.launches``); a
    CPU tensor computes :func:`batch_round_ref` on the unpacked bits.
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
    ROUND_KERNEL(bits.data_ptr(), alive.data_ptr(), grid.data_ptr(),
                 price.data_ptr(), cap.data_ptr(), occupied.data_ptr(),
                 b, t, w, a, m, v.data_ptr(), tau.data_ptr(),
                 best_a.data_ptr(), current_stream(bits.get_device()))
    return v, tau, best_a


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
    if a < 1 or grid.shape[0] != a or not 1 <= m <= _MAX_M:
        raise ValueError(f"grid {tuple(grid.shape)} does not fit A={a} or "
                         f"m outside 1..{_MAX_M}")
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
