"""Pieces the plain references share: float32 products with TF32 off, the
control's lower precision, norms and rotary angles.

A reference runs in float32 on the weights the benchmark drew (upcast
from the type they are served in). Its control, ``precision="fp8"``,
is the same computation with both operands of every product rounded to
float8 e4m3 first (a scale per tensor for weights, per row for
activations), the step below the bf16 a served configuration states.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN, restored
    on exit."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def fp8(x: torch.Tensor, per_row: bool = True) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale per row of its last
    dimension (or per tensor), returned in float32. Under autograd the
    rounding passes the gradient through unchanged."""
    with torch.no_grad():
        a = x.abs().amax(dim=-1, keepdim=True) if per_row \
            else x.abs().amax()
        scale = torch.clamp(a, min=1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach() if x.requires_grad else q


class Precision:
    """The products of one reference run: float32, or the fp8 control."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.low = precision == "fp8"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight as the products take it."""
        t = t.float()
        return fp8(t, per_row=False) if self.low else t

    def a(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as the products take it."""
        t = t.float()
        return fp8(t) if self.low else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w with a weight ``w`` already through :meth:`w`."""
        return self.a(x) @ w


def rms_norm(x, w, eps: float):
    """RMS norm with a (1 + w) scale, in float32."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rotary_tables(positions, d_rot: int, theta: float):
    """cos, sin (T, d_rot / 2) in float32: the inverse frequencies
    1 / theta^(k / d_rot) with each float32 step (the exponent, the power,
    the reciprocal) correctly rounded, the angle their float32 product
    with the position."""
    k = torch.arange(0, d_rot, 2, dtype=torch.float64,
                     device=positions.device)
    e = (k / d_rot).float().double()
    inv = (1.0 / (theta ** e).float().double()).float()
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin, d_rot: int):
    """Interleaved rotary on the first ``d_rot`` dims of x (B, T, H, Dh)."""
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    rot = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], -1)
    return torch.cat([rot.reshape(xr.shape), xp], -1)
