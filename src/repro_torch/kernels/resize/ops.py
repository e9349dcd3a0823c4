"""Port of ``src/repro/kernels/resize/ops.py``: apply a compression factor z
to a batch of frames."""

from __future__ import annotations

from .resize import (device_taps, out_size_for_z, resize_bilinear,
                     resize_matrix, resize_ref)

__all__ = ["compress_frames"]


def compress_frames(img, z: float, *, use_kernel: bool = True):
    """Resize (B, H, W, C) frames to the resolution implied by compression
    factor ``z`` (output pixel count = z · input pixel count).

    ``img`` is a tensor on the device the caller runs on (the serving engine
    uploads its frames to its own device). ``use_kernel=True`` resamples
    through :func:`~repro_torch.kernels.resize.resize.resize_bilinear` — the
    K3 kernel on a CUDA tensor, its plain version on a CPU tensor — over taps
    uploaded once per shape; ``False`` evaluates the reference einsum.
    """
    _, h, w, _ = img.shape
    ho, wo = out_size_for_z(h, w, float(z))
    if use_kernel:
        return resize_bilinear(img, device_taps(ho, h, img.device),
                               device_taps(wo, w, img.device))
    return resize_ref(img, resize_matrix(ho, h), resize_matrix(wo, w))
