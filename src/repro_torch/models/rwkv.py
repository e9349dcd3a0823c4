"""Port of ``src/repro/models/rwkv.py``: the RWKV-6 ("Finch") block, time
mix with data-dependent decay and channel mix, for prefill.

The WKV state ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ`` (per head, N × N) is
read by the receptance r_t with a current-token bonus u, and evaluated in
the reference's chunked linear-attention form: a loop over chunks carries
the float32 state, and within a chunk every contribution is a product of
dense tensors. Every exponent is a difference of cumulative log-decays in
the past → present direction, hence ≤ 0. Token shift uses static learned
mixes μ, as the reference does. Decode is the same time and channel mix
at T = 1: the shift reads the stored previous activation and the WKV runs
one chunk of length 1. Plain PyTorch, as the reference is jnp outside any
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import TensorSpec
from .layers import dense_init

__all__ = ["rwkv_init", "rwkv_time_mix", "rwkv_channel_mix", "rwkv_decode",
           "rwkv_state_spec"]

_LORA_RANK = 64


def rwkv_init(generator, cfg, dtype=torch.float32, device=None):
    """Reference ``rwkv_init`` (rwkv.py:32)."""
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    dev = device or generator.device

    def full(value):
        return torch.full((d,), value, dtype=dtype, device=dev)

    def dense(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dtype,
                          device=dev)
    return {
        "time": {
            "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
            "mu_g": full(0.5), "mu_w": full(0.5),
            "w_r": dense((d, d)), "w_k": dense((d, d)), "w_v": dense((d, d)),
            "w_g": dense((d, d)), "w_o": dense((d, d)),
            # data-dependent decay: ω + B·tanh(A·x)
            "w0": full(-6.0),
            "w_lora_a": dense((d, _LORA_RANK)),
            "w_lora_b": dense((_LORA_RANK, d), scale=0.01),
            "u": dense((h, n), scale=0.5),
            "ln_x": full(1.0),   # per-head group-norm scale
        },
        "channel": {
            "mu_k": full(0.5), "mu_r": full(0.5),
            "w_k": dense((d, cfg.d_ff)), "w_v": dense((cfg.d_ff, d)),
            "w_r": dense((d, d)),
        },
    }


def _shift(x, prev):
    """Token shift: x_{t-1} with prev (B, d) as position -1."""
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _mix(x, x_prev, mu):
    return x * mu + x_prev * (1.0 - mu)


def _group_norm(x, scale, n: int, eps: float = 1e-5):
    """Reference ``_group_norm`` (rwkv.py:73): LayerNorm of each group of n
    channels of (..., H·N), in float32 with the population variance
    (``jnp.var``), cast back to x's type."""
    shp = x.shape
    xh = x.reshape(shp[:-1] + (shp[-1] // n, n)).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(shp) * scale.float()).to(x.dtype)


def _wkv_chunk(s, rr, kk, vv, lw, u):
    """One chunk of the reference's ``chunk_step`` (rwkv.py:101): float32
    r, k, v, logw (B, H, C, N) and state s (B, H, N, N) → (s_new, o)."""
    c = rr.shape[2]
    lcum = torch.cumsum(lw, dim=2)                    # L_j (inclusive)
    lprev = lcum - lw                                 # L_{j-1} (exclusive)
    # inter-chunk: the state read, decayed to just before each step
    o_inter = (rr * torch.exp(lprev)) @ s
    # intra-chunk, strictly lower triangular: exp(L_{i-1} - L_j), exponent
    # ≤ 0 where the mask keeps it
    delta = lprev[:, :, :, None, :] - lcum[:, :, None, :, :]   # (B,H,C,C,N)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=s.device),
                      -1)[None, None, :, :, None]
    p = torch.where(mask, torch.exp(torch.clamp(delta, max=0.0)), 0.0)
    att = torch.einsum("bhin,bhjn,bhijn->bhij", rr, kk, p)
    o_intra = att @ vv
    # current-token bonus
    o_diag = (rr * u * kk).sum(-1, keepdim=True) * vv
    # state update: decay to the end of the chunk
    d_out = torch.exp(lcum[:, :, -1:, :] - lcum)       # ≤ 1
    s_new = torch.exp(lcum[:, :, -1])[..., None] * s \
        + (kk * d_out).transpose(-1, -2) @ vv
    return s_new, o_inter + o_intra + o_diag


def _wkv_chunked(r, k, v, logw, u, s0, chunk: int):
    """Reference ``_wkv_chunked`` (rwkv.py:83): r, k, v, logw (B, T, H, N)
    with logw ≤ 0; u (H, N); s0 (B, H, N, N) float32 → (o (B, T, H, N)
    float32, s_last). The tail is padded with logw = 0 (w = 1), which
    keeps the state; each chunk's (B, H, C, C, N) decay tensor is built
    for that chunk alone."""
    bsz, t, h, n = r.shape
    c = min(chunk, t)
    nc = -(-t // c)
    tp = nc * c

    def chunks(x):
        x = x.float()
        if tp != t:
            x = F.pad(x, (0, 0, 0, 0, 0, tp - t))
        return x.reshape(bsz, nc, c, h, n).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(logw)
    uf = u.float()[None, :, None, :]
    s = s0.float()
    outs = []
    for i in range(nc):
        s, o = _wkv_chunk(s, rc[i], kc[i], vc[i], lwc[i], uf)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(bsz, tp, h, n)
    return o[:, :t], s


def rwkv_state_spec(cfg, batch: int, dtype):
    """Reference ``rwkv_state_spec`` (rwkv.py:131)."""
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    return {
        "s": TensorSpec((batch, d // n, n, n), torch.float32),
        "x_att": TensorSpec((batch, d), dtype),
        "x_ffn": TensorSpec((batch, d), dtype),
    }


def _time_mix_proj(p, x, x_prev, cfg):
    """Reference ``_time_mix_proj`` (rwkv.py:141): r, k, v, logw (float32)
    per head and the gate g. With T = 1 the shifted input is the stored
    previous activation."""
    n = cfg.rwkv_head_dim
    h = cfg.d_model // n
    xs = _shift(x, x_prev) if x.shape[1] > 1 else x_prev[:, None, :]
    r = _mix(x, xs, p["mu_r"]) @ p["w_r"]
    k = _mix(x, xs, p["mu_k"]) @ p["w_k"]
    v = _mix(x, xs, p["mu_v"]) @ p["w_v"]
    g = F.silu(_mix(x, xs, p["mu_g"]) @ p["w_g"])
    xw = _mix(x, xs, p["mu_w"])
    logw = -torch.exp(p["w0"].float()
                      + torch.tanh(xw.float() @ p["w_lora_a"].float())
                      @ p["w_lora_b"].float())
    shp = tuple(x.shape[:-1]) + (h, n)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp),
            logw.reshape(shp), g)


def rwkv_time_mix(params, x, cfg, state=None):
    """Reference ``rwkv_time_mix`` (rwkv.py:165): x (B, T, d) → (y, {"s",
    "x_att"}); ``state`` (``s``, ``x_att``) or None for zeros."""
    bsz, t, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    if state is None:
        x_prev = x.new_zeros((bsz, d))
        s0 = torch.zeros((bsz, h, n, n), dtype=torch.float32,
                         device=x.device)
    else:
        x_prev, s0 = state["x_att"], state["s"]
    p = params["time"]
    r, k, v, logw, g = _time_mix_proj(p, x, x_prev, cfg)
    o, s_last = _wkv_chunked(r, k, v, logw, p["u"], s0, cfg.chunk_rec)
    o = _group_norm(o.reshape(bsz, t, d).to(x.dtype), p["ln_x"], n)
    y = (o * g) @ p["w_o"]
    return y, {"s": s_last, "x_att": x[:, -1, :]}


def rwkv_channel_mix(params, x, cfg, state=None):
    """Reference ``rwkv_channel_mix`` (rwkv.py:181): x (B, T, d) → (y,
    {"x_ffn"}); ``state`` (``x_ffn``) or None for zeros."""
    bsz, t, d = x.shape
    x_prev = x.new_zeros((bsz, d)) if state is None else state["x_ffn"]
    p = params["channel"]
    xs = _shift(x, x_prev) if t > 1 else x_prev[:, None, :]
    k = torch.square(torch.relu(_mix(x, xs, p["mu_k"]) @ p["w_k"]))
    r = torch.sigmoid(_mix(x, xs, p["mu_r"]) @ p["w_r"])
    return r * (k @ p["w_v"]), {"x_ffn": x[:, -1, :]}


def rwkv_decode(params, x, state, cfg):
    """Reference ``rwkv_decode`` (rwkv.py:191), as it is: the time mix of
    one token x (B, 1, d) with ``state`` → (y, {"s", "x_att"}). The block's
    decode calls the time and channel mix itself."""
    return rwkv_time_mix(params, x, cfg, state)
