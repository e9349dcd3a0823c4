"""K4, the flash-attention forward of the LM prefill, and its plain version.

Port of ``src/repro/kernels/attn/attn.py::flash_attention_fwd`` (the Pallas
kernel with its epilogue); its plain version is the counterpart of
``src/repro/kernels/attn/ref.py``. The CUDA kernel is ``csrc/flash_attn.cu``:
one block per (batch, query head, query tile) that streams over the KV
tiles itself.

:func:`flash_attention_fwd` launches the kernel for CUDA tensors and
computes :func:`flash_attention_fwd_ref` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import CudaKernel

__all__ = ["FLASH_KERNEL", "NEG", "flash_attention_fwd",
           "flash_attention_fwd_ref"]

NEG = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
FLASH_KERNEL = CudaKernel(
    "flash_attn.cu", "flash_attn_launch",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


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
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"Dh={dh} is outside 1..{MAX_HEAD_DIM}")
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
    bfloat16, Hq a multiple of Hkv, Dh ≤ 256 → (B, Tq, Hq, Dh) in q's type,
    float32 arithmetic.

    A CUDA tensor launches ``csrc/flash_attn.cu`` (counted in
    ``FLASH_KERNEL.launches``); a CPU tensor computes
    :func:`flash_attention_fwd_ref`.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous (B, T, H, Dh) tensors")
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    FLASH_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPE_CODE[q.dtype], b, tq, tk, hq, hkv, dh, dh ** -0.5,
                 int(causal), stream)
    return out
