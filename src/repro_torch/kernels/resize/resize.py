"""K3, the semantic-compression bilinear resize, and its plain version.

Port of ``src/repro/kernels/resize/resize.py::resize_bilinear`` (the Pallas
kernel) and ``src/repro/kernels/resize/ref.py`` (``resize_matrix``,
``out_size_for_z``, ``resize_ref``). The CUDA kernel is ``csrc/resize.cu``:
a 4-tap gather over the taps of the same 2-banded interpolation matrices.

:func:`resize_bilinear` launches the kernel for CUDA tensors and computes
:func:`resize_bilinear_ref` — the reference's matrix form, rebuilt from the
same taps — for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._build import CudaKernel

__all__ = ["RESIZE_KERNEL", "device_taps", "matrix_from_taps",
           "out_size_for_z", "resize_bilinear", "resize_bilinear_ref",
           "resize_matrix", "resize_ref", "resize_taps"]

_P = ctypes.c_void_p
_I = ctypes.c_int
RESIZE_KERNEL = CudaKernel(
    "resize.cu", "resize_launch",
    [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def out_size_for_z(h: int, w: int, z: float) -> tuple[int, int]:
    """Output resolution for compression factor z (pixel count ∝ bitrate)."""
    s = float(np.sqrt(z))
    return max(1, int(round(h * s))), max(1, int(round(w * s)))


def _lo_index(n_out: int, n_in: int):
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    return src, lo


def resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, half-pixel centers.

    Row i holds the two source weights for output sample i:
      src = (i + 0.5) · n_in/n_out − 0.5, clamped to [0, n_in−1].
    """
    src, lo = _lo_index(n_out, n_in)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    R = np.zeros((n_out, n_in), np.float32)
    R[np.arange(n_out), lo] += (1.0 - frac).astype(np.float32)
    R[np.arange(n_out), hi] += frac.astype(np.float32)
    return R


def resize_taps(n_out: int, n_in: int) -> tuple[np.ndarray, np.ndarray]:
    """The two taps of every :func:`resize_matrix` row: ``idx`` (2, n_out)
    int32 ``[lo; hi]`` and ``wt`` (2, n_out) float32, the weights read off
    the matrix itself (``hi == lo`` at the clamped edge, with weight 0), so
    :func:`matrix_from_taps` rebuilds the matrix exactly."""
    R = resize_matrix(n_out, n_in)
    _, lo = _lo_index(n_out, n_in)
    has_hi = lo + 1 < n_in
    hi = np.where(has_hi, lo + 1, lo)
    rows = np.arange(n_out)
    idx = np.stack([lo, hi]).astype(np.int32)
    wt = np.stack([R[rows, lo], np.where(has_hi, R[rows, hi], 0.0)]
                  ).astype(np.float32)
    return idx, wt


@functools.lru_cache(maxsize=128)
def _device_taps(n_out: int, n_in: int, device: torch.device):
    idx, wt = resize_taps(n_out, n_in)
    return (torch.tensor(idx, device=device), torch.tensor(wt, device=device))


def device_taps(n_out: int, n_in: int, device) -> tuple:
    """:func:`resize_taps` as tensors on ``device``, uploaded once per shape."""
    return _device_taps(n_out, n_in, torch.device(device))


def matrix_from_taps(taps, n_in: int) -> torch.Tensor:
    """The (n_out, n_in) interpolation matrix the taps describe."""
    idx, wt = taps
    n_out = idx.shape[1]
    R = torch.zeros(n_out, n_in, dtype=torch.float32, device=wt.device)
    rows = torch.arange(n_out, device=wt.device)
    R.index_put_((rows, idx[0].long()), wt[0], accumulate=True)
    R.index_put_((rows, idx[1].long()), wt[1], accumulate=True)
    return R


def resize_ref(img, r_h, r_w):
    """img (B, H, W, C); r_h (h, H); r_w (w, W) → (B, h, w, C) — the
    reference's einsum, accumulated in float32, cast to ``img``'s type."""
    r_h = torch.as_tensor(r_h, dtype=torch.float32, device=img.device)
    r_w = torch.as_tensor(r_w, dtype=torch.float32, device=img.device)
    return torch.einsum("hH,bHWc,wW->bhwc", r_h, img.float(), r_w
                        ).to(img.dtype)


def resize_bilinear_ref(img, taps_h, taps_w):
    """Plain version of :func:`resize_bilinear`: the matrix form on the
    matrices the taps describe."""
    return resize_ref(img, matrix_from_taps(taps_h, img.shape[1]),
                      matrix_from_taps(taps_w, img.shape[2]))


def resize_bilinear(img, taps_h, taps_w):
    """img (B, H, W, C) float32 or bfloat16; ``taps_h``/``taps_w`` the
    (idx, wt) taps of the row/column interpolation matrices on ``img``'s
    device → (B, h, w, C) in ``img``'s type, float32 arithmetic.

    A CUDA tensor launches ``csrc/resize.cu`` (counted in
    ``RESIZE_KERNEL.launches``); a CPU tensor computes
    :func:`resize_bilinear_ref`.
    """
    if img.dim() != 4:
        raise ValueError(f"img must be (B, H, W, C), got {tuple(img.shape)}")
    if img.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {img.dtype}")
    b, hin, win, c = img.shape
    (ih, wh), (iw, ww) = taps_h, taps_w
    for idx, wt, n_in in ((ih, wh, hin), (iw, ww, win)):
        if idx.dtype != torch.int32 or wt.dtype != torch.float32 \
                or idx.shape != wt.shape or idx.shape[0] != 2:
            raise TypeError("taps must be ((2, n) int32, (2, n) float32)")
        if idx.device != img.device or wt.device != img.device:
            raise ValueError("taps must lie on img's device")
    if img.device.type == "cpu":
        return resize_bilinear_ref(img, taps_h, taps_w)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    h, w = ih.shape[1], iw.shape[1]
    img = img.contiguous()
    out = torch.empty((b, h, w, c), dtype=img.dtype, device=img.device)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    RESIZE_KERNEL(img.data_ptr(), _DTYPE_CODE[img.dtype], b, hin, win, c, h,
                  w, ih.data_ptr(), wh.data_ptr(), iw.data_ptr(),
                  ww.data_ptr(), out.data_ptr(), stream)
    return out
