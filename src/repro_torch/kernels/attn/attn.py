"""K4, the flash-attention forward of the LM prefill, and its plain version.

Port of ``src/repro/kernels/attn/attn.py::flash_attention_fwd`` (the Pallas
kernel with its epilogue); its plain version is the counterpart of
``src/repro/kernels/attn/ref.py``. Two hand-written CUDA kernels compute it,
chosen by :func:`route`:

- ``"tensor_cores"`` (``csrc/flash_attn_tc.cu``): bf16 with ``Dh % 8 == 0``
  and ``Dh <= 256``. ``wgmma`` products with K/V tiles loaded by TMA; P is
  rounded to bf16 before the second product, as in every bf16 flash
  attention.
- ``"cuda_cores"`` (``csrc/flash_attn.cu``): float32, bf16 of any other
  head width, and every ``Dh > 256`` up to 512. f32 FMAs on the CUDA cores,
  the reference's arithmetic.

:func:`flash_attention_fwd` launches the routed kernel for CUDA tensors and
computes :func:`flash_attention_fwd_ref` for CPU tensors, at any head
width. On the card ``Dh > 512`` raises: no kernel has a tile for it.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel, current_stream

__all__ = ["FLASH_CORE_KERNEL", "FLASH_KERNEL", "FLASH_TC_KERNEL",
           "MAX_HEAD_DIM", "NEG", "TC_MAX_HEAD_DIM",
           "flash_attention_fwd", "flash_attention_fwd_ref", "launch",
           "route", "tc_head_width"]

NEG = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
FLASH_CORE_KERNEL = CudaKernel(
    "flash_attn.cu", "flash_attn_launch",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P])
FLASH_TC_KERNEL = CudaKernel(
    "flash_attn_tc.cu", "flash_attn_tc_launch",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the widest head each kernel has a tile for: the CUDA-core kernel's widest
# instantiation is Dh 512 (32 x 16, 135 KB of the 227 KB a block may use);
# the tensor-core kernel pads Dh to 64, 128 or 256
MAX_HEAD_DIM = 512
TC_MAX_HEAD_DIM = 256
# TMA takes 16-byte-aligned bases and row strides: Dh % 8 bf16
TC_HEAD_MULTIPLE = 8


class _K4Launches:
    """Every launch of K4, on either route: ``launches`` is the sum of the
    two kernels' counts, and setting it to 0 zeroes both."""

    kernels = (FLASH_CORE_KERNEL, FLASH_TC_KERNEL)

    @property
    def launches(self) -> int:
        return sum(k.launches for k in self.kernels)

    @launches.setter
    def launches(self, value: int) -> None:
        if value != 0:
            raise ValueError("K4's launch count can only be reset to 0")
        for k in self.kernels:
            k.launches = 0


FLASH_KERNEL = _K4Launches()


def route(dtype: torch.dtype, dh: int) -> str:
    """Which kernel computes K4 for ``dtype`` at head width ``dh``, chosen
    by shape alone: ``"tensor_cores"`` for bf16 with ``dh % 8 == 0`` and
    ``dh <= 256``; ``"cuda_cores"`` for float32, for other bf16 widths and
    for every ``dh > 256`` (its Dh ≤ 512 tile; the tensor-core kernel's
    tiles stop at 256). Not a fallback: no route is taken because another
    failed."""
    if dtype == torch.bfloat16 and dh % TC_HEAD_MULTIPLE == 0 \
            and dh <= TC_MAX_HEAD_DIM:
        return "tensor_cores"
    return "cuda_cores"


def tc_head_width(dh: int) -> int:
    """The head width the tensor-core kernel computes at: ``dh`` padded to
    64, 128 or 256 (whole 64-column TMA boxes; the padding reads as zeros)."""
    if not TC_HEAD_MULTIPLE <= dh <= TC_MAX_HEAD_DIM \
            or dh % TC_HEAD_MULTIPLE != 0:
        raise ValueError(f"Dh={dh} is not a tensor-core head width")
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, T, H, Dh)")
    b, _, hq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv != 0:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if dh < 1:
        raise ValueError(f"Dh={dh} is not a head width")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True):
    """Plain version of K4: an unblocked masked softmax in float32 with the
    kernel's scale, NEG, padding mask, GQA map (KV head = h // G) and
    epilogue ``acc / max(l, 1e-30)``, cast to q's type."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qh = (q.float() * dh ** -0.5).reshape(b, tq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float())
    kpos = torch.arange(tk, device=q.device)
    valid = (kpos < tk)[None, :]
    if causal:
        valid = valid & (kpos[None, :]
                         <= torch.arange(tq, device=q.device)[:, None])
    s = torch.where(valid, s, torch.tensor(NEG, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]       # (B, Tq, Hkv, G, 1)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, tq, hq, dh).to(q.dtype)


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q (B, Tq, Hq, Dh); k, v (B, Tk, Hkv, Dh), contiguous, float32 or
    bfloat16, Hq a multiple of Hkv → (B, Tq, Hq, Dh) in q's type, float32
    sums. Any Dh on the CPU; Dh ≤ 512 on the card.

    A CUDA tensor launches the kernel :func:`route` names (counted in
    ``FLASH_TC_KERNEL`` or ``FLASH_CORE_KERNEL``, both in
    ``FLASH_KERNEL.launches``); the tensor-core route needs 16-byte-aligned
    q, k and v. A CPU tensor computes :func:`flash_attention_fwd_ref`,
    with its autograd. The kernels have no backward yet, so a CUDA input
    that requires grad under grad mode raises rather than return an output
    that carries no gradient to it.
    """
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_fwd_ref(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "K4 has no backward yet (an autograd Function for it is "
            "ROADMAP.md queue 1, item 4): call it under torch.no_grad() or "
            "on inputs that do not require grad")
    return launch(route(q.dtype, q.shape[-1]), q, k, v, causal=causal)


def launch(kernel: str, q, k, v, *, causal: bool = True):
    """Launch K4's ``kernel`` (a :func:`route` name) on CUDA tensors,
    checked as :func:`flash_attention_fwd` checks them. That function is
    the entry point; this is also how a bf16 call is held on the CUDA-core
    kernel to compare the two."""
    if kernel not in ("tensor_cores", "cuda_cores"):
        raise ValueError(f"unknown K4 kernel {kernel!r}")
    _check(q, k, v)
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if kernel == "tensor_cores" and route(q.dtype, dh) != kernel:
        raise ValueError(f"{q.dtype} at Dh={dh} is not a tensor-core input")
    if dh > MAX_HEAD_DIM:
        raise ValueError(
            f"Dh={dh} > {MAX_HEAD_DIM}: K4 has no tile for it (the CUDA-core "
            f"kernel's widest instantiation is Dh {MAX_HEAD_DIM}, the "
            f"tensor-core kernel's {TC_MAX_HEAD_DIM}); no model of the "
            "repository has a head wider than 256")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous (B, T, H, Dh) tensors")
    if kernel == "tensor_cores" \
            and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("the tensor-core route needs 16-byte-aligned q, k "
                         "and v")
    out = torch.empty_like(q)
    stream = current_stream(q.get_device())
    if kernel == "tensor_cores":
        FLASH_TC_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, tq, tk, hq, hkv, dh, dh ** -0.5,
                        int(causal), stream)
    else:
        FLASH_CORE_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), _DTYPE_CODE[q.dtype], b, tq, tk,
                          hq, hkv, dh, dh ** -0.5, int(causal), stream)
    return out
