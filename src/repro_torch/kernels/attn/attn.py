"""K4, the flash-attention forward of the LM prefill and training, its
gradient K4′, and their plain versions.

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

Both kernels write each row's log-sum-exp on request (``launch(...,
with_lse=True)``), as the reference's Pallas kernel returns its m and l;
the plain version computes it too (``with_lse=True``).

:func:`flash_attention_fwd` goes through :class:`FlashAttention`, an
autograd Function: its forward launches the routed kernel for CUDA tensors
and computes :func:`flash_attention_fwd_ref` for CPU tensors, at any head
width; its backward is :func:`flash_attention_bwd`, K4′, and
:func:`flash_attention_bwd_ref` on CPU tensors. K4′ has two kernels, chosen
by :func:`route` as K4's are, and both take P from the forward's
log-sum-exp, which they require:

- ``"tensor_cores"`` (``csrc/flash_attn_bwd_tc.cu``): bf16 with
  ``Dh % 8 == 0`` and ``Dh <= 256``, the forward's tensor-core inputs.
  ``wgmma`` products on TMA tiles. At Dh 129–256 (padded to 256: gemma3's
  global layers) its dK/dV pass splits the head's columns over two
  warpgroups.
- ``"cuda_cores"`` (``csrc/flash_attn_bwd.cu``): float32, bf16 with
  ``Dh % 8 != 0`` and Dh 257–512. f32 FMAs.

Each makes a launch a pass (``BWD_PASSES``: 3 on both: dQ with D, dK/dV
into float32 partials of ``bwd_groups(G)`` query-head groups, their
reduce), counted in
``FLASH_BWD_TC_KERNEL`` or ``FLASH_BWD_CORE_KERNEL``, both in
``FLASH_BWD_KERNEL.launches``. The reference has no kernel there: its
training attention is the jnp chunked flash attention, differentiated by
recompute (``src/repro/models/attention.py:79-174``). On the card
``Dh > 512`` raises: no kernel has a tile for it.

A real CUDA tensor calls :func:`launch` and :func:`bwd_launch` as
routed. A ``meta`` tensor, or a fake CUDA tensor under
``FakeTensorMode``, goes through operators registered with
``torch.library.custom_op`` (``repro_torch::flash_attn_fwd`` and
``repro_torch::flash_attn_bwd``; their CUDA implementation is the same
routed launch), whose fake implementations return tensors of the right
shapes and launch nothing, so the dry run (``launch/dryrun.py``) traces a
step through K4 and K4′ without a card and without the plain version's
(T × T) scores. The card skips the operators' dispatch, which costs 20–40
µs of host time a call (``chip_smoke.py`` phase 10). Their flop formulas
(``torch.utils.flop_counter``) count the products as the reference's
attention computes them, causal or not: every query against every key
(its chunked attention masks the causal half, it does not skip it), 2
products of 2·B·Hq·Tq·Tk·Dh flops forward and 5 backward (S recomputed,
dV, dP, dQ, dK).
"""

from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from .._build import CudaKernel, current_stream

__all__ = ["BWD_PASSES", "FLASH_BWD_CORE_KERNEL",
           "FLASH_BWD_KERNEL", "FLASH_BWD_TC_KERNEL", "FLASH_CORE_KERNEL",
           "FLASH_KERNEL", "FLASH_TC_KERNEL", "FlashAttention",
           "MAX_HEAD_DIM", "NEG", "TC_MAX_HEAD_DIM", "bwd_groups",
           "bwd_launch", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_fwd",
           "flash_attention_fwd_ref", "launch", "route", "scratch_bytes",
           "tc_head_width"]

NEG = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int
FLASH_CORE_KERNEL = CudaKernel(
    "flash_attn.cu", "flash_attn_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I,
     _P])
FLASH_TC_KERNEL = CudaKernel(
    "flash_attn_tc.cu", "flash_attn_tc_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P])
# K4′: one launcher a route, called once a pass — dQ (and D), dK/dV,
# reduce on both
FLASH_BWD_CORE_KERNEL = CudaKernel(
    "flash_attn_bwd.cu", "flash_attn_bwd_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _I, _I, _I, ctypes.c_float, _I, _I, _P])
FLASH_BWD_TC_KERNEL = CudaKernel(
    "flash_attn_bwd_tc.cu", "flash_attn_bwd_tc_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _I, _I, ctypes.c_float, _I, _P])
BWD_PASSES = {"tensor_cores": 3, "cuda_cores": 3}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the widest head each kernel has a tile for: the CUDA-core kernel's widest
# instantiation is Dh 512 (32 x 16, 135 KB of the 227 KB a block may use);
# the tensor-core kernels (K4's and K4′'s) pad Dh to 64, 128 or 256 (at 256
# K4′'s dK/dV pass splits the head's columns over two warpgroups: one
# thread's dK and dV of the whole head would be 256 registers, over the 255
# it may hold)
MAX_HEAD_DIM = 512
TC_MAX_HEAD_DIM = 256
# TMA takes 16-byte-aligned bases and row strides: Dh % 8 bf16
TC_HEAD_MULTIPLE = 8


class _Launches:
    """Every launch of a kernel with two routes: ``launches`` is the sum of
    the two kernels' counts, and setting it to 0 zeroes both."""

    def __init__(self, *kernels):
        self.kernels = kernels

    @property
    def launches(self) -> int:
        return sum(k.launches for k in self.kernels)

    @launches.setter
    def launches(self, value: int) -> None:
        if value != 0:
            raise ValueError("a launch count can only be reset to 0")
        for k in self.kernels:
            k.launches = 0


FLASH_KERNEL = _Launches(FLASH_CORE_KERNEL, FLASH_TC_KERNEL)
FLASH_BWD_KERNEL = _Launches(FLASH_BWD_CORE_KERNEL, FLASH_BWD_TC_KERNEL)


def route(dtype: torch.dtype, dh: int) -> str:
    """Which kernel computes K4, and K4′, for ``dtype`` at head width
    ``dh``, chosen by shape alone: ``"tensor_cores"`` for bf16 with
    ``dh % 8 == 0`` and ``dh <= 256``; ``"cuda_cores"`` for float32, for
    other bf16 widths and for every ``dh > 256`` (its Dh ≤ 512 tile; the
    tensor-core kernels' tiles stop at 256). Not a fallback: no route is
    taken because another failed."""
    if dtype == torch.bfloat16 and dh % TC_HEAD_MULTIPLE == 0 \
            and dh <= TC_MAX_HEAD_DIM:
        return "tensor_cores"
    return "cuda_cores"


def bwd_groups(g: int) -> int:
    """How many groups K4′'s dK/dV pass (either route) splits a KV head's
    ``g`` query heads into: the largest divisor of ``g`` that is at most 4
    (each group's float32 dK/dV partials are written and summed in order;
    ``csrc/flash_attn_bwd_tc.cu`` gives the reason for 4)."""
    return max(d for d in range(1, min(g, 4) + 1) if g % d == 0)


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


def _acc_dtype(dtype):
    """The plain versions' arithmetic: float32, or float64 for float64
    inputs (``torch.autograd.gradcheck``'s)."""
    return torch.promote_types(dtype, torch.float32)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            with_lse: bool = False):
    """Plain version of K4: an unblocked masked softmax in float32 with the
    kernel's scale, NEG, padding mask, GQA map (KV head = h // G) and
    epilogue ``acc / max(l, 1e-30)``, cast to q's type (float64 inputs
    compute in float64). With ``with_lse`` it returns ``(out, lse)``, lse
    each row's ``m + log(max(l, 1e-30))`` of the scaled, masked scores,
    float32 (B, Hq, Tq): the m and l the reference's Pallas kernel returns
    beside its accumulator."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    acc = _acc_dtype(q.dtype)
    qh = (q.to(acc) * dh ** -0.5).reshape(b, tq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.to(acc))
    kpos = torch.arange(tk, device=q.device)
    valid = (kpos < tk)[None, :]
    if causal:
        valid = valid & (kpos[None, :]
                         <= torch.arange(tq, device=q.device)[:, None])
    s = torch.where(valid, s, torch.tensor(NEG, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    pv = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(acc))
    l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]       # (B, Tq, Hkv, G, 1)
    out = pv / torch.clamp(l, min=1e-30)
    out = out.reshape(b, tq, hq, dh).to(q.dtype)
    if not with_lse:
        return out
    lse = m[..., 0] + torch.log(torch.clamp(l[..., 0].permute(0, 2, 3, 1),
                                            min=1e-30))
    return out, lse.reshape(b, hq, tq)


def flash_attention_bwd_ref(q, k, v, out, dout, *, causal: bool = True,
                            lse=None):
    """Plain version of K4′, in float32: P recomputed with K4's scale, NEG
    and GQA map — the row softmax, or ``exp(S − lse)`` when the forward's
    log-sum-exp ``lse`` (B, Hq, Tq) is given; D = rowsum(dO∘O) from ``out``
    as given (the bf16 output on the bf16 route); dV = Pᵀ dO;
    dS = P∘(dO Vᵀ − D); dQ = scale·dS K; dK = scale·dSᵀ Q; dK and dV summed
    over the G query heads of each KV head. Returns float32 (dq, dk, dv)
    (float64 for float64 inputs)."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh ** -0.5
    acc = _acc_dtype(q.dtype)
    qf = q.to(acc).reshape(b, tq, hkv, g, dh)
    kf, vf = k.to(acc), v.to(acc)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf * scale, kf)
    if causal:
        valid = torch.arange(tk, device=q.device)[None, :] \
            <= torch.arange(tq, device=q.device)[:, None]
        s = torch.where(valid, s, torch.tensor(NEG, device=q.device))
    if lse is None:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    else:
        p = torch.exp(s - lse.to(acc).reshape(b, hkv, g, tq, 1))
    do = dout.to(acc).reshape(b, tq, hkv, g, dh)
    d = (do * out.to(acc).reshape(b, tq, hkv, g, dh)).sum(-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = scale * torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
    dk = scale * torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq.reshape(b, tq, hq, dh), dk, dv


@torch.library.custom_op("repro_torch::flash_attn_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 as an operator: the routed kernel's output and, with
    ``with_lse``, its log-sum-exp (else an empty float32 tensor)."""
    got = launch(route(q.dtype, q.shape[-1]), q, k, v, causal=causal,
                 with_lse=with_lse)
    if with_lse:
        return got
    return got, torch.empty((0,), dtype=torch.float32, device=q.device)


@_fwd_op.register_fake
def _(q, k, v, causal, with_lse):
    b, tq, hq, _ = q.shape
    lse = q.new_empty((b, hq, tq) if with_lse else (0,),
                      dtype=torch.float32)
    return torch.empty_like(q), lse


@torch.library.custom_op("repro_torch::flash_attn_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor | None,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4′ as an operator: the routed kernel's (dq, dk, dv)."""
    return bwd_launch(route(q.dtype, q.shape[-1]), q, k, v, out, dout,
                      causal=causal, lse=lse)


@_bwd_op.register_fake
def _(q, k, v, out, dout, lse, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def scratch_bytes(op: str, q, k, *rest) -> int:
    """The device bytes the kernel behind operator ``op``
    (``"flash_attn_fwd"`` or ``"flash_attn_bwd"``, given its arguments)
    allocates for its own use beyond its outputs: K4′'s float32 partials
    of dK and dV (``bwd_groups(G)`` of each) and D, on either route; K4
    none (its LSE is an output). The dry run adds them at the call
    (``launch/cost.py``)."""
    if op != "flash_attn_bwd":
        return 0
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    return 2 * bwd_groups(hq // hkv) * b * tk * hkv * dh * 4 + b * hq * tq * 4


def _products(q_shape, k_shape) -> int:
    """2·B·Hq·Tq·Tk·Dh: the flops of one of attention's products."""
    b, tq, hq, dh = q_shape
    return 2 * b * hq * tq * k_shape[1] * dh


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attn_fwd)
    def _(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
        return 2 * _products(q_shape, k_shape)

    @register_flop_formula(torch.ops.repro_torch.flash_attn_bwd)
    def _(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
        return 5 * _products(q_shape, k_shape)


_register_flops()


def _on_card(t) -> bool:
    """A real CUDA tensor (not ``meta``, not fake): the kernels launch."""
    return t.device.type == "cuda" and not is_fake(t)


def _forward(q, k, v, causal: bool, with_lse: bool = False):
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal=causal,
                                       with_lse=with_lse)
    if _on_card(q):
        return launch(route(q.dtype, q.shape[-1]), q, k, v, causal=causal,
                      with_lse=with_lse)
    out, lse = _fwd_op(q, k, v, causal, with_lse)
    return (out, lse) if with_lse else out


class FlashAttention(torch.autograd.Function):
    """K4 with its gradient: the forward is :func:`flash_attention_fwd`'s
    route (the routed kernel on the card, the plain version on the host),
    saving q, k, v and the output — and, when ``with_lse``, K4's
    log-sum-exp, which K4′ requires on the card; the backward is
    :func:`flash_attention_bwd` (K4′ on the card, its plain version on the
    host), given that LSE. A recompute under ``torch.utils.checkpoint``
    runs the forward again, so a checkpointed layer launches K4 twice a
    step."""

    @staticmethod
    def forward(ctx, q, k, v, causal, with_lse=False):
        if with_lse:
            out, lse = _forward(q, k, v, causal, with_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = _forward(q, k, v, causal)
            ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, *lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         causal=ctx.causal,
                                         lse=lse[0] if lse else None)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """q (B, Tq, Hq, Dh); k, v (B, Tk, Hkv, Dh), contiguous, float32 or
    bfloat16, Hq a multiple of Hkv → (B, Tq, Hq, Dh) in q's type, float32
    sums. Any Dh on the CPU; Dh ≤ 512 on the card.

    A CUDA tensor launches the kernel :func:`route` names (counted in
    ``FLASH_TC_KERNEL`` or ``FLASH_CORE_KERNEL``, both in
    ``FLASH_KERNEL.launches``); the tensor-core route needs 16-byte-aligned
    q, k and v. A CPU tensor computes :func:`flash_attention_fwd_ref`. Both
    go through :class:`FlashAttention`, so an input that requires grad gets
    K4′'s gradient (the kernel on the card, its plain version on the host).
    K4 writes its log-sum-exp only for a backward that takes it: grad mode
    on and an input that requires grad, on the card (either route). (The
    first pass of a non-reentrant ``torch.utils.checkpoint`` writes it
    too: it must save the tensors its recompute saves.) Prefill, decode
    and other calls without a backward launch K4 with no LSE.
    """
    _check(q, k, v)
    with_lse = q.device.type != "cpu" and torch.is_grad_enabled() \
        and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, with_lse)


def _check_bwd(q, k, v, out, dout, lse):
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} and dout "
                         f"{tuple(dout.shape)} {dout.dtype} must be like q "
                         f"{tuple(q.shape)} {q.dtype}")
    b, tq, hq, _ = q.shape
    if lse is not None and (lse.shape != (b, hq, tq)
                            or lse.dtype != _acc_dtype(q.dtype)):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} must be "
                         f"{_acc_dtype(q.dtype)} {(b, hq, tq)}")


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True,
                        lse=None):
    """K4′: the gradient of :func:`flash_attention_fwd` → (dq, dk, dv) in
    q's type. ``out`` is the forward's output and ``dout`` its gradient
    (both (B, Tq, Hq, Dh), q's type); ``lse`` the forward's log-sum-exp,
    float32 (B, Hq, Tq) (``launch(..., with_lse=True)``).

    A CUDA tensor launches the kernel :func:`route` names
    (:func:`bwd_launch`), which requires ``lse`` and raises without it
    (neither route recomputes the LSE). A ``meta`` tensor (or a fake one)
    takes the operator's fake implementation under the same precondition,
    and launches nothing. A CPU tensor
    computes :func:`flash_attention_bwd_ref` (with ``lse`` when given) and
    casts it to q's type (float64 too, for ``torch.autograd.gradcheck``)."""
    _check_bwd(q, k, v, out, dout, lse)
    if q.device.type == "cpu":
        return tuple(t.to(q.dtype) for t in flash_attention_bwd_ref(
            q, k, v, out, dout, causal=causal, lse=lse))
    kernel = route(q.dtype, q.shape[-1])
    if lse is None:
        raise ValueError(_NEEDS_LSE)
    if _on_card(q):
        return bwd_launch(kernel, q, k, v, out, dout, causal=causal, lse=lse)
    return _bwd_op(q, k, v, out, dout, lse, causal)


_NEEDS_LSE = ("K4′ needs the forward's log-sum-exp (lse=, from "
              "launch(..., with_lse=True))")


def bwd_launch(kernel: str, q, k, v, out, dout, *, causal: bool = True,
               lse=None):
    """Launch K4′'s ``kernel`` (a :func:`route` name) on CUDA tensors,
    checked as :func:`flash_attention_bwd` checks them, one launch a pass
    (``BWD_PASSES[kernel]``). That function is the entry point; this is
    also how a bf16 call is held on the CUDA-core kernel (given that
    kernel's K4's LSE) to compare the two. Every argument is checked
    before any CUDA call."""
    if kernel not in BWD_PASSES:
        raise ValueError(f"unknown K4′ kernel {kernel!r}")
    _check_bwd(q, k, v, out, dout, lse)
    _check(q, k, v)
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if kernel == "tensor_cores" and route(q.dtype, dh) != kernel:
        raise ValueError(f"{q.dtype} at Dh={dh} is not a tensor-core input "
                         "of K4′")
    if lse is None:
        raise ValueError(_NEEDS_LSE)
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"Dh={dh} > {MAX_HEAD_DIM}: K4′ has no tile for it")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    ts = (q, k, v, out, dout, lse)
    if not all(t.is_contiguous() for t in ts) \
            or any(t.device != q.device for t in ts):
        raise ValueError("q, k, v, out, dout and lse must be contiguous "
                         "tensors on one device")
    if kernel == "tensor_cores" and any(t.data_ptr() % 16 for t in ts[:5]):
        raise ValueError("K4′'s tensor-core route needs 16-byte-aligned q, "
                         "k, v, out and dout")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if min(b, tq, tk, hq) == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, hq, tq), **f32)
    groups = bwd_groups(hq // hkv)
    dk_part = torch.empty((groups, b, tk, hkv, dh), **f32)
    dv_part = torch.empty_like(dk_part)
    stream = current_stream(q.get_device())
    scale = dh ** -0.5
    if kernel == "tensor_cores":
        ptrs = [t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq,
                                       dk, dv, dk_part, dv_part)]
        for p in range(BWD_PASSES[kernel]):
            FLASH_BWD_TC_KERNEL(p, *ptrs, b, tq, tk, hq, hkv, dh, groups,
                                scale, int(causal), stream)
        return dq, dk, dv
    ptrs = [t.data_ptr() for t in (q, k, v, out, dout, dq, dk, dv, lse,
                                   delta, dk_part, dv_part)]
    vec = _vec(q, ptrs[:5])
    for p in range(BWD_PASSES[kernel]):
        FLASH_BWD_CORE_KERNEL(p, *ptrs, _DTYPE_CODE[q.dtype], b, tq, tk, hq,
                              hkv, dh, groups, scale, int(causal), vec,
                              stream)
    return dq, dk, dv


def _vec(q, ptrs) -> int:
    """Whether the CUDA-core kernels may move their tiles 16 bytes a copy:
    Dh a whole number of 16-byte units and every pointer 16-byte aligned,
    so that every row starts aligned."""
    return int(q.shape[-1] % (16 // q.element_size()) == 0
               and not any(p % 16 for p in ptrs))


def launch(kernel: str, q, k, v, *, causal: bool = True,
           with_lse: bool = False):
    """Launch K4's ``kernel`` (a :func:`route` name) on CUDA tensors,
    checked as :func:`flash_attention_fwd` checks them. That function is
    the entry point; this is also how a bf16 call is held on the CUDA-core
    kernel to compare the two. With ``with_lse`` (either kernel) it
    returns ``(out, lse)``, lse each row's log-sum-exp in float32
    (B, Hq, Tq); ``out`` is bit for bit the same either way."""
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
    lse = torch.empty((b, hq, tq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    ptrs = [t.data_ptr() for t in (q, k, v, out)] \
        + [None if lse is None else lse.data_ptr()]
    stream = current_stream(q.get_device())
    if kernel == "tensor_cores":
        FLASH_TC_KERNEL(*ptrs, b, tq, tk, hq, hkv, dh, dh ** -0.5,
                        int(causal), stream)
    else:
        FLASH_CORE_KERNEL(*ptrs, _DTYPE_CODE[q.dtype], b, tq, tk, hq, hkv,
                          dh, dh ** -0.5, int(causal), _vec(q, ptrs[:4]),
                          stream)
    return (out, lse) if with_lse else out
