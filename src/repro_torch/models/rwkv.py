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

Under dense tensor parallelism (a ``TPPlan`` ``tp``) the time mix splits
by heads when ``tp.rwkv`` is set: ``w_r``, ``w_k``, ``w_v`` and ``w_g``
are this rank's columns, ``w_o`` its rows, and the per-channel or
per-head leaves (the decay's ``w0`` and ``w_lora_b`` columns, ``u``, the
group norm's scale) are whole, the rank computing with its slice; the
channel mix splits ``w_k``'s columns and ``w_v``'s rows when ``tp.ff`` is
set. Each rank's gradient of a whole leaf is then zero outside its slice,
and the step's sum of the ranks' shares is the whole gradient. Both
mixes sum their partial outputs over ``model`` (``collectives.tp_exit``);
the state holds the rank's heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import TensorSpec
from .layers import dense_init

__all__ = ["rwkv_init", "rwkv_time_mix", "rwkv_channel_mix", "rwkv_decode",
           "rwkv_state_spec"]

_LORA_RANK = 64
# the bytes of one group's (g, B, H, C, C, N) float32 intra-chunk decays in
# ``_wkv_chunked`` (each of ``delta`` and ``p``; a few such tensors are
# live at once): at rwkv6-1.6b's widths, B = 2 and T = 2048 its 64 chunks
# are exactly 1 GiB, one group; at T = 32768 the 1024 chunks would be
# 17.2 GB a tensor, and 16 groups keep the prefill within the card
WKV_GROUP_BYTES = 1 << 30


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


def _wkv_chunked(r, k, v, logw, u, s0, chunk: int):
    """Reference ``_wkv_chunked`` (rwkv.py:83): r, k, v, logw (B, T, H, N)
    with logw ≤ 0; u (H, N); s0 (B, H, N, N) float32 → (o (B, T, H, N)
    float32, s_last). The tail is padded with logw = 0 (w = 1), which
    keeps the state.

    The reference's ``chunk_step`` computes every term of a chunk from the
    chunk alone but the inter-chunk read, which takes the state the chunk
    starts with. So the chunk-local terms — the cumulative log-decays, the
    intra-chunk (B, H, C, C, N) decay and its products, the current-token
    bonus, each chunk's own k vᵀ update — are computed for all chunks at
    once (the same products, with a leading chunk axis), and only the
    state's recurrence ``s ← exp(L_C) s + Σ_j k_j d_j v_jᵀ`` loops over the
    chunks, two operations a chunk; the inter-chunk reads then take the
    stacked chunk-start states in one product. (A loop of whole chunk
    steps made ~165 launches a chunk under autograd: rwkv6-1.6b's training
    step at T = 2048 was 254,000 launches, host-bound.) The intra-chunk
    decays, (B, H, C, C, N) float32 a chunk, are formed for a group of
    chunks at a time, as many as fit ``WKV_GROUP_BYTES``: the same
    products a chunk, in as many groups as the length needs."""
    bsz, t, h, n = r.shape
    c = min(chunk, t)
    nc = -(-t // c)
    tp = nc * c

    def chunks(x):
        x = x.float()
        if tp != t:
            x = F.pad(x, (0, 0, 0, 0, 0, tp - t))
        return x.reshape(bsz, nc, c, h, n).permute(1, 0, 3, 2, 4)

    # (nc, B, H, C, N)
    rr, kk, vv, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    lcum = torch.cumsum(lw, dim=3)                    # L_j (inclusive)
    lprev = lcum - lw                                 # L_{j-1} (exclusive)
    # intra-chunk, strictly lower triangular: exp(L_{i-1} - L_j), exponent
    # ≤ 0 where the mask keeps it; (g, B, H, C, C, N) decays for a group of
    # g chunks at a time, within WKV_GROUP_BYTES
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      -1)[:, :, None]
    g = max(1, WKV_GROUP_BYTES // (bsz * h * c * c * n * 4))
    o_intra = []
    for z in range(0, nc, g):
        # one group takes the whole tensors: no slice, so autograd records
        # no slice backward
        part = (lambda x: x) if g >= nc else (lambda x, z=z: x[z:z + g])
        lp, lc = part(lprev), part(lcum)
        delta = lp[..., :, None, :] - lc[..., None, :, :]
        p = torch.where(mask, torch.exp(torch.clamp(delta, max=0.0)), 0.0)
        att = torch.einsum("zbhin,zbhjn,zbhijn->zbhij", part(rr), part(kk),
                           p)
        o_intra.append(att @ part(vv))
    o_intra = o_intra[0] if len(o_intra) == 1 else torch.cat(o_intra)
    # current-token bonus
    o_diag = (rr * u.float()[None, None, :, None, :] * kk).sum(
        -1, keepdim=True) * vv
    # each chunk's state update: decay to the end of the chunk (≤ 1), and
    # the state carried through the chunks
    d_out = torch.exp(lcum[..., -1:, :] - lcum)
    kv = (kk * d_out).transpose(-1, -2) @ vv         # (nc, B, H, N, N)
    decay = torch.exp(lcum[..., -1, :])[..., None]    # (nc, B, H, N, 1)
    s = s0.float()
    starts = []
    for i in range(nc):
        starts.append(s)
        s = decay[i] * s + kv[i]
    # inter-chunk: the state read, decayed to just before each step
    o_inter = (rr * torch.exp(lprev)) @ torch.stack(starts)
    o = o_inter + o_intra + o_diag
    o = o.permute(1, 0, 3, 2, 4).reshape(bsz, tp, h, n)
    return o[:, :t], s


def rwkv_state_spec(cfg, batch: int, dtype, tp=None):
    """Reference ``rwkv_state_spec`` (rwkv.py:131); the WKV state of this
    rank's heads under the plan ``tp``."""
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n // (tp.n if tp is not None and tp.rwkv else 1)
    return {
        "s": TensorSpec((batch, h, n, n), torch.float32),
        "x_att": TensorSpec((batch, d), dtype),
        "x_ffn": TensorSpec((batch, d), dtype),
    }


def _heads(p, tp):
    """The time mix's per-channel and per-head leaves as this rank computes
    with them: its slice of each when the plan ``tp`` splits the heads."""
    if tp is None or not tp.rwkv:
        return p
    sl, hs = tp.part(p["w0"].shape[0]), tp.part(p["u"].shape[0])
    return dict(p, w0=p["w0"][sl], w_lora_b=p["w_lora_b"][:, sl],
                u=p["u"][hs], ln_x=p["ln_x"][sl])


def _time_mix_proj(p, x, x_prev, cfg):
    """Reference ``_time_mix_proj`` (rwkv.py:141): r, k, v, logw (float32)
    per head and the gate g. With T = 1 the shifted input is the stored
    previous activation."""
    n = cfg.rwkv_head_dim
    xs = _shift(x, x_prev) if x.shape[1] > 1 else x_prev[:, None, :]
    r = _mix(x, xs, p["mu_r"]) @ p["w_r"]
    k = _mix(x, xs, p["mu_k"]) @ p["w_k"]
    v = _mix(x, xs, p["mu_v"]) @ p["w_v"]
    g = F.silu(_mix(x, xs, p["mu_g"]) @ p["w_g"])
    xw = _mix(x, xs, p["mu_w"])
    logw = -torch.exp(p["w0"].float()
                      + torch.tanh(xw.float() @ p["w_lora_a"].float())
                      @ p["w_lora_b"].float())
    shp = tuple(x.shape[:-1]) + (r.shape[-1] // n, n)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp),
            logw.reshape(shp), g)


def rwkv_time_mix(params, x, cfg, state=None, tp=None):
    """Reference ``rwkv_time_mix`` (rwkv.py:165): x (B, T, d) → (y, {"s",
    "x_att"}); ``state`` (``s``, ``x_att``) or None for zeros."""
    bsz, t, d = x.shape
    n = cfg.rwkv_head_dim
    p = _heads(params["time"], tp)
    h = p["u"].shape[0]
    if state is None:
        x_prev = x.new_zeros((bsz, d))
        s0 = torch.zeros((bsz, h, n, n), dtype=torch.float32,
                         device=x.device)
    else:
        x_prev, s0 = state["x_att"], state["s"]
    r, k, v, logw, g = _time_mix_proj(p, x, x_prev, cfg)
    o, s_last = _wkv_chunked(r, k, v, logw, p["u"], s0, cfg.chunk_rec)
    o = _group_norm(o.reshape(bsz, t, h * n).to(x.dtype), p["ln_x"], n)
    y = (o * g) @ p["w_o"]
    if tp is not None:
        y = tp.leave(y, tp.rwkv)
    return y, {"s": s_last, "x_att": x[:, -1, :]}


def rwkv_channel_mix(params, x, cfg, state=None, tp=None):
    """Reference ``rwkv_channel_mix`` (rwkv.py:181): x (B, T, d) → (y,
    {"x_ffn"}); ``state`` (``x_ffn``) or None for zeros."""
    bsz, t, d = x.shape
    x_prev = x.new_zeros((bsz, d)) if state is None else state["x_ffn"]
    p = params["channel"]
    xs = _shift(x, x_prev) if t > 1 else x_prev[:, None, :]
    k = torch.square(torch.relu(_mix(x, xs, p["mu_k"]) @ p["w_k"]))
    r = torch.sigmoid(_mix(x, xs, p["mu_r"]) @ p["w_r"])
    kv = k @ p["w_v"]
    if tp is not None:
        # under Megatron-SP both factors are the rank's block of the
        # sequence: ``r`` (``w_r`` whole) keeps its block with no sum
        kv, r = tp.leave(kv, tp.ff), tp.leave(r, False)
    return r * kv, {"x_ffn": x[:, -1, :]}


def rwkv_decode(params, x, state, cfg, tp=None):
    """Reference ``rwkv_decode`` (rwkv.py:191), as it is: the time mix of
    one token x (B, 1, d) with ``state`` → (y, {"s", "x_att"}). The block's
    decode calls the time and channel mix itself."""
    return rwkv_time_mix(params, x, cfg, state, tp)
