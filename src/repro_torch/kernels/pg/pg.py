"""K1, the fused flexible admission round, and its plain PyTorch version.

Port of ``src/repro/kernels/pg/pg.py::batch_round`` (the Pallas kernel) and
``src/repro/kernels/pg/ref.py::batch_round_ref`` (its dense oracle). The CUDA
kernel is ``csrc/pg_round.cu``; its design note explains the one-block-per-
instance layout that replaces the TPU's sequential T-block carry.

:func:`batch_round` launches the kernel for CUDA tensors and computes
:func:`batch_round_ref` for CPU tensors. Packed latency words are ``int32``
tensors holding the reference's ``uint32`` bit pattern (bit k of word w is
allocation 32·w + k — ``greedy._pack_bits``); the kernel reads them as
``uint32``.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel

__all__ = ["ROUND_KERNEL", "batch_round", "batch_round_ref"]

_P = ctypes.c_void_p
_I = ctypes.c_int
ROUND_KERNEL = CudaKernel(
    "pg_round.cu", "pg_round_launch",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P])
_MAX_M = 8                  # kMaxM in pg_round.cu
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
    v = torch.empty(b, dtype=torch.float32, device=bits.device)
    tau = torch.empty(b, dtype=torch.int32, device=bits.device)
    best_a = torch.empty(b, dtype=torch.int32, device=bits.device)
    stream = torch.cuda.current_stream(bits.device).cuda_stream
    ROUND_KERNEL(bits.data_ptr(), alive.data_ptr(), grid.data_ptr(),
                 price.data_ptr(), cap.data_ptr(), occupied.data_ptr(),
                 b, t, w, a, m, v.data_ptr(), tau.data_ptr(),
                 best_a.data_ptr(), stream)
    return v, tau, best_a
