"""K3, the semantic-compression bilinear resize, and its plain version.

Port of ``src/repro/kernels/resize/resize.py::resize_bilinear`` (the Pallas
kernel) and ``src/repro/kernels/resize/ref.py`` (``resize_matrix``,
``out_size_for_z``, ``resize_ref``). The CUDA kernel is ``csrc/resize.cu``:
a 4-tap gather whose taps it derives itself from the sizes, with the float64
arithmetic of :func:`resize_taps` (bit for bit), so a call passes only the
image and the output size.

:func:`resize_bilinear` launches the kernel for CUDA tensors and computes
:func:`resize_bilinear_ref` — the reference's matrix form on
:func:`resize_matrix` — for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .._build import CudaKernel, current_stream

__all__ = ["RESIZE_KERNEL", "out_size_for_z", "resize_bilinear",
           "resize_bilinear_ref", "resize_matrix", "resize_ref",
           "resize_taps"]

_P = ctypes.c_void_p
_I = ctypes.c_int
RESIZE_KERNEL = CudaKernel(
    "resize.cu", "resize_launch", [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1024)
def out_size_for_z(h: int, w: int, z: float) -> tuple[int, int]:
    """Output resolution for compression factor z (pixel count ∝ bitrate);
    cached, as the serving engine asks for the same few sizes per job."""
    s = math.sqrt(z)
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
    they rebuild the matrix exactly. The CUDA kernel derives these taps in
    its own float64 arithmetic, bit for bit."""
    R = resize_matrix(n_out, n_in)
    _, lo = _lo_index(n_out, n_in)
    has_hi = lo + 1 < n_in
    hi = np.where(has_hi, lo + 1, lo)
    rows = np.arange(n_out)
    idx = np.stack([lo, hi]).astype(np.int32)
    wt = np.stack([R[rows, lo], np.where(has_hi, R[rows, hi], 0.0)]
                  ).astype(np.float32)
    return idx, wt


def resize_ref(img, r_h, r_w):
    """img (B, H, W, C); r_h (h, H); r_w (w, W) → (B, h, w, C) — the
    reference's einsum, accumulated in float32, cast to ``img``'s type."""
    r_h = torch.as_tensor(r_h, dtype=torch.float32, device=img.device)
    r_w = torch.as_tensor(r_w, dtype=torch.float32, device=img.device)
    return torch.einsum("hH,bHWc,wW->bhwc", r_h, img.float(), r_w
                        ).to(img.dtype)


def resize_bilinear_ref(img, h: int, w: int):
    """Plain version of :func:`resize_bilinear`: the reference's einsum on
    ``resize_matrix(h, H)`` and ``resize_matrix(w, W)``."""
    return resize_ref(img, resize_matrix(h, img.shape[1]),
                      resize_matrix(w, img.shape[2]))


def resize_bilinear(img, h: int, w: int):
    """img (B, H, W, C) float32 or bfloat16 → (B, h, w, C) in ``img``'s type,
    float32 arithmetic: the bilinear resample to ``h × w`` (half-pixel
    centres, clamped; the reference's ``resize_matrix`` taps).

    A CUDA tensor launches ``csrc/resize.cu`` (counted in
    ``RESIZE_KERNEL.launches``); a CPU tensor computes
    :func:`resize_bilinear_ref`.
    """
    code = _DTYPE_CODE.get(img.dtype)
    if code is None or img.dim() != 4 or h < 1 or w < 1:
        _check(img, h, w)
    if not img.is_cuda:
        if img.device.type != "cpu":
            raise ValueError(f"unsupported device {img.device}")
        return resize_bilinear_ref(img, h, w)
    if not img.is_contiguous():
        img = img.contiguous()
    b, hin, win, c = img.shape
    out = img.new_empty((b, h, w, c))
    RESIZE_KERNEL(img.data_ptr(), code, b, hin, win, c, h, w, out.data_ptr(),
                  current_stream(img.get_device()))
    return out


def _check(img, h, w):
    if img.dim() != 4:
        raise ValueError(f"img must be (B, H, W, C), got {tuple(img.shape)}")
    if img.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {img.dtype}")
    if h < 1 or w < 1:
        raise ValueError(f"output size must be positive, got {h}x{w}")
