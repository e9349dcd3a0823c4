"""Port of ``src/repro/models/attention.py``: GQA/MQA attention for the
training forward, prefill and decode, full (causal or not) and
sliding-window, and the encoder-decoder's cross-attention.

Full attention with no window and no query offset is kernel K4
(``kernels/attn/attn.py::flash_attention_fwd``), causal or not and with
Tq != Tk for cross-attention: the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor. That is the function the reference computes there
with its chunked streaming softmax in jnp. Full attention with an offset
(a prefill continuation; no caller of the reference passes one) takes that
chunked streaming softmax in plain PyTorch, since K4, like the reference's
Pallas kernel, has no offset. The sliding-window kind keeps the
reference's banded plain path: per query chunk one KV slice of width
window + chunk, masked softmax in float32.

Sliding-window layers use a rolling (ring) KV cache of length ``window``
(Mistral-style): slot ``i`` holds the newest position ≡ i (mod window).
The one-token decode (``attn_decode``, ``cross_attn_decode``) is the
reference's plain einsums with float32 accumulation, outside any Pallas
kernel there and any hand-written kernel here; it returns a new cache and
leaves the caller's unchanged, as the reference's functional update does.
The training forward's backward is autograd, through K4's gradient K4′
(``kernels/attn/attn.py::FlashAttention``) on the full-attention route
and PyTorch's own on the plain paths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.attn import attn as attn_kernel
from .common import TensorSpec
from .layers import apply_rotary, dense_init, rms_norm, rotary_cos_sin

__all__ = ["attn_decode", "attn_init", "attn_prefill", "attn_train",
           "cache_spec", "cross_attn_decode", "cross_attn_train",
           "flash_attention"]

NEG = -1e30


def attn_init(generator, cfg, *, cross: bool = False, dtype=torch.float32,
              device=None):
    d, dh = cfg.d_model, cfg.d_head
    p = {
        "wq": dense_init(generator, (d, cfg.n_heads * dh), dtype=dtype,
                         device=device),
        "wk": dense_init(generator, (d, cfg.n_kv_heads * dh), dtype=dtype,
                         device=device),
        "wv": dense_init(generator, (d, cfg.n_kv_heads * dh), dtype=dtype,
                         device=device),
        "wo": dense_init(generator, (cfg.n_heads * dh, d), dtype=dtype,
                         device=device),
    }
    if cfg.qk_norm and not cross:
        dev = device or generator.device
        p["q_scale"] = torch.zeros((dh,), dtype=dtype, device=dev)
        p["k_scale"] = torch.zeros((dh,), dtype=dtype, device=dev)
    return p


def _project(params, x, cfg, positions, *, rope: bool = True):
    b, t, _ = x.shape
    dh = cfg.d_head
    q = (x @ params["wq"]).reshape(b, t, cfg.n_heads, dh)
    k = (x @ params["wk"]).reshape(b, t, cfg.n_kv_heads, dh)
    v = (x @ params["wv"]).reshape(b, t, cfg.n_kv_heads, dh)
    if cfg.qk_norm and "q_scale" in params:
        q = rms_norm(q, params["q_scale"], cfg.norm_eps)
        k = rms_norm(k, params["k_scale"], cfg.norm_eps)
    if rope:
        cos, sin = rotary_cos_sin(positions, int(dh * cfg.rope_fraction),
                                  cfg.rope_theta)
        q = apply_rotary(q, cos, sin, cfg.rope_fraction)
        k = apply_rotary(k, cos, sin, cfg.rope_fraction)
    return q, k, v


def _banded(q, k, v, *, window: int, chunk_q: int, q_offset: int):
    """The reference's sliding-window path: per query chunk one KV slice of
    static width window + chunk (front padding makes every slice start
    valid; 2·chunk of end padding keeps the last one in bounds), masked
    softmax in float32."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    cq = min(chunk_q, tq)
    n_q = -(-tq // cq)
    if n_q * cq != tq:
        q = F.pad(q, (0, 0, 0, 0, 0, n_q * cq - tq))
    qc = (q * dh ** -0.5).reshape(b, n_q, cq, hkv, g, dh)
    span = window + cq
    k_pad = F.pad(k, (0, 0, 0, 0, span, 2 * cq))
    v_pad = F.pad(v, (0, 0, 0, 0, span, 2 * cq))
    neg = torch.tensor(NEG, device=q.device)
    outs = []
    for qi in range(n_q):
        q_start = qi * cq + q_offset
        # dynamic_slice clamps its start into bounds; so does this
        k_start = min(max(q_start - window + 1 + span, 0),
                      k_pad.shape[1] - span)
        k_blk = k_pad[:, k_start:k_start + span]
        v_blk = v_pad[:, k_start:k_start + span]
        qpos = q_start + torch.arange(cq, device=q.device)
        kpos = q_start - window + 1 + torch.arange(span, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] >= 0) \
            & (kpos[None, :] < tk) \
            & (kpos[None, :] > qpos[:, None] - window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc[:, qi].float(),
                         k_blk.float())
        p = torch.softmax(torch.where(mask, s, neg), dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", p, v_blk.float()))
    out = torch.cat(outs, dim=1).reshape(b, n_q * cq, hq, dh)
    return out[:, :tq].to(v.dtype)


def _chunked(q, k, v, *, causal: bool, chunk_q: int, chunk_k: int,
             q_offset: int):
    """The reference's full-attention path (attention.py:130-167): per
    query chunk a streaming softmax over KV chunks, float32 running max m,
    sum l and accumulator, query positions shifted by ``q_offset``."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    cq = min(chunk_q, tq)
    n_q = -(-tq // cq)
    if n_q * cq != tq:
        q = F.pad(q, (0, 0, 0, 0, 0, n_q * cq - tq))
    qc = (q * dh ** -0.5).reshape(b, n_q, cq, hkv, g, dh).float()
    ck = min(chunk_k, tk)
    n_k = -(-tk // ck)
    if n_k * ck != tk:
        k = F.pad(k, (0, 0, 0, 0, 0, n_k * ck - tk))
        v = F.pad(v, (0, 0, 0, 0, 0, n_k * ck - tk))
    kf, vf = k.float(), v.float()
    neg = torch.tensor(NEG, device=q.device)
    outs = []
    for qi in range(n_q):
        qpos = qi * cq + q_offset + torch.arange(cq, device=q.device)
        m = torch.full((b, hkv, g, cq), NEG, device=q.device)
        l = torch.zeros((b, hkv, g, cq), device=q.device)
        acc = torch.zeros((b, hkv, g, cq, dh), device=q.device)
        for kj in range(n_k):
            kpos = kj * ck + torch.arange(ck, device=q.device)
            mask = kpos[None, :] < tk
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc[:, qi],
                             kf[:, kj * ck:(kj + 1) * ck])
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, kj * ck:(kj + 1) * ck])
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4))            # (B, cq, Hkv, G, Dh)
    out = torch.cat(outs, dim=1).reshape(b, n_q * cq, hq, dh)
    return out[:, :tq].to(v.dtype)


def flash_attention(q, k, v, *, causal: bool, window: int | None,
                    chunk_q: int, chunk_k: int, q_offset: int = 0):
    """q (B,Tq,Hq,Dh); k,v (B,Tk,Hkv,Dh) → (B,Tq,Hq,Dh).

    ``window`` (if set) restricts each query to the previous ``window`` keys
    (inclusive of self) — the sliding-window kind, on the banded plain path.
    ``q_offset`` is the absolute position of q[0] relative to k[0]. With no
    window and no offset the attention is K4's function and goes through
    K4's wrapper (``chunk_k`` is the reference's KV chunk, which K4 tiles
    on its own); with an offset, the reference's chunked streaming softmax.
    """
    if window is not None:
        return _banded(q, k, v, window=window, chunk_q=chunk_q,
                       q_offset=q_offset)
    if q_offset != 0:
        return _chunked(q, k, v, causal=causal, chunk_q=chunk_q,
                        chunk_k=chunk_k, q_offset=q_offset)
    return attn_kernel.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                           v.contiguous(), causal=causal)


def _attend_one(q, k, v, valid=None):
    """One query token per head against a whole cache, the reference's
    decode products (``preferred_element_type=float32``): q (B, Hkv, G,
    Dh) scaled, k, v (B, L, Hkv, Dh), ``valid`` (L,) or None → (B, Hkv, G,
    Dh) float32. Both operands are upcast before each product, so bf16
    scores and probabilities are not rounded to bf16."""
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float())
    if valid is not None:
        s = torch.where(valid, s, torch.tensor(NEG, device=s.device))
    return torch.einsum("bhgk,bkhd->bhgd", torch.softmax(s, dim=-1),
                        v.float())


def _write_slot(buf, new, slot: int):
    """``buf`` (B, L, ...) with position ``slot`` replaced by ``new`` (B, 1,
    ...), as a new tensor (the caller's is unchanged). ``slot`` is clamped
    into [0, L - 1], as ``jax.lax.dynamic_update_slice`` clamps its start:
    a full cache's last slot takes every position past its end."""
    slot = min(max(slot, 0), buf.shape[1] - 1)
    return torch.cat([buf[:, :slot], new, buf[:, slot + 1:]], dim=1)


# ---------------------------------------------------------------------------
# train (forward) and prefill entry points
# ---------------------------------------------------------------------------

def attn_train(params, x, cfg, kind: str, *, rope: bool = True,
               causal: bool = True):
    """Reference ``attn_train`` (attention.py:177), forward: x (B, T, d) →
    (B, T, d). The whisper encoder calls it with ``causal=False``; with no
    window that is K4, non-causal."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project(params, x, cfg, positions, rope=rope)
    window = cfg.window if kind == "local" else None
    o = flash_attention(q, k, v, causal=causal, window=window,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    return o.reshape(b, t, -1) @ params["wo"]


def cache_spec(cfg, kind: str, batch: int, seq_len: int, dtype):
    """Shape of the KV cache for one attention layer of the given kind."""
    length = min(cfg.window, seq_len) if kind == "local" else seq_len
    shp = (batch, length, cfg.n_kv_heads, cfg.d_head)
    return {"k": TensorSpec(shp, dtype), "v": TensorSpec(shp, dtype)}


def attn_prefill(params, x, cfg, kind: str, cache_len: int):
    """Full-sequence pass that also returns the populated KV cache.

    For "local" layers the cache is the rolling window (last ``window``
    positions, ring-aligned); otherwise the full ``cache_len`` buffer with the
    first T slots filled.
    """
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project(params, x, cfg, positions)
    window = cfg.window if kind == "local" else None
    o = flash_attention(q, k, v, causal=True, window=window,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    y = o.reshape(b, t, -1) @ params["wo"]

    if kind == "local":
        w = min(cfg.window, cache_len)
        k_tail, v_tail = k[:, -w:], v[:, -w:]
        if t >= w:
            shift = t % w
            k_c = torch.roll(k_tail, shift, dims=1)
            v_c = torch.roll(v_tail, shift, dims=1)
        else:
            k_c = k.new_zeros((b, w) + tuple(k.shape[2:]))
            v_c = v.new_zeros((b, w) + tuple(v.shape[2:]))
            k_c[:, :t] = k_tail
            v_c[:, :t] = v_tail
    else:
        k_c = k.new_zeros((b, cache_len) + tuple(k.shape[2:]))
        v_c = v.new_zeros((b, cache_len) + tuple(v.shape[2:]))
        k_c[:, :t] = k
        v_c[:, :t] = v
    return y, {"k": k_c, "v": v_c}


def attn_decode(params, x, cache, pos: int, cfg, kind: str):
    """Reference ``attn_decode`` (attention.py:231): one token x (B, 1, d)
    at absolute position ``pos``. Its K/V go into a new cache: slot ``pos
    % length`` of a "local" ring, else slot ``pos`` (clamped to the last,
    as the reference's update clamps). The query scores the whole cache
    under the reference's ``valid`` mask: the ring's slots hold positions
    ``pos - age``, valid while ≥ 0 and inside the window. Returns (y (B,
    1, d), {"k", "v"})."""
    b = x.shape[0]
    dh = cfg.d_head
    positions = torch.full((b, 1), pos, device=x.device)
    q, k_new, v_new = _project(params, x, cfg, positions)
    length = cache["k"].shape[1]
    slots = torch.arange(length, device=x.device)
    if kind == "local":
        slot = pos % length
        abs_pos = pos - (pos - slots) % length
        valid = (abs_pos >= 0) & (abs_pos > pos - cfg.window)
    else:
        slot = pos
        valid = slots <= pos
    k_c = _write_slot(cache["k"], k_new, slot)
    v_c = _write_slot(cache["v"], v_new, slot)
    g = cfg.n_heads // cfg.n_kv_heads
    qh = (q * dh ** -0.5).reshape(b, cfg.n_kv_heads, g, dh)
    o = _attend_one(qh, k_c, v_c, valid).to(x.dtype)
    y = o.reshape(b, 1, cfg.n_heads * dh) @ params["wo"]
    return y, {"k": k_c, "v": v_c}


# --- cross attention (whisper decoder) --------------------------------------

def cross_attn_train(params, x, enc, cfg):
    """Reference ``cross_attn_train`` (attention.py:266): x (B, Td, d)
    queries, enc (B, Te, d) keys and values; no RoPE, no qk-norm, no mask.
    K4 with ``causal=False`` and Tq != Tk. Returns (y, the ``{"k", "v"}``
    cross cache)."""
    b, t, _ = x.shape
    te = enc.shape[1]
    dh = cfg.d_head
    q = (x @ params["wq"]).reshape(b, t, cfg.n_heads, dh)
    k = (enc @ params["wk"]).reshape(b, te, cfg.n_kv_heads, dh)
    v = (enc @ params["wv"]).reshape(b, te, cfg.n_kv_heads, dh)
    o = flash_attention(q, k, v, causal=False, window=None,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    return o.reshape(b, t, -1) @ params["wo"], {"k": k, "v": v}


def cross_attn_decode(params, x, cross_cache, cfg):
    """Reference ``cross_attn_decode`` (attention.py:280): one decoder
    token x (B, 1, d) against the prefill's cross cache; no RoPE, no
    mask."""
    b = x.shape[0]
    dh = cfg.d_head
    g = cfg.n_heads // cfg.n_kv_heads
    q = (x @ params["wq"]).reshape(b, cfg.n_kv_heads, g, dh) * dh ** -0.5
    o = _attend_one(q, cross_cache["k"], cross_cache["v"]).to(x.dtype)
    return o.reshape(b, 1, cfg.n_heads * dh) @ params["wo"]
