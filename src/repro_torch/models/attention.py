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

Under dense tensor parallelism (a ``TPPlan`` ``tp`` whose ``attn`` is
set, ``distributed/sharding.py::tp_plan``) each rank computes its own
query heads: ``wq`` is its block of columns and ``wo`` its block of rows,
and the partial outputs of ``wo`` are summed over ``model``
(``collectives.tp_exit``). Where the K/V projections split too, ``wk`` and
``wv`` are the rank's blocks; where they do not (fewer KV heads than
ranks), the rank's query heads all read one KV head, and the rank computes
that head's columns alone from the whole ``wk`` and ``wv``. Every shape
here is read from the tensors, so K4 and K4′ run on the rank's (B, T,
heads, Dh) and (B, T, KV heads, Dh) as they are, and the cache holds the
rank's KV heads.

Under the reference's ``seq_kv`` layout (a ``KVSplit`` ``kv``,
``distributed/sharding.py::kv_split``) the decode cache holds every KV
head for the rank's block of the slots instead. A decode step makes the
new token's K/V and every query head whole on each rank (gathered over
``model`` where the plan splits them), the rank that holds the token's
slot writes it, and each rank scores its block: its float32 max, sum and
weighted values are combined over the cache's axes (``_attend_split``)
into the whole softmax; the out projection stays row-parallel on the
rank's heads. Under Megatron-SP the plan's ``enter`` has gathered the
input's sequence before these functions, and ``_out``'s ``leave`` keeps
the rank's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import all_gather, max_over, sum_over
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


def _kv_weight(w, cfg, tp):
    """``wk`` or ``wv`` as this rank computes with it: the whole leaf, its
    block (the plan splits the KV heads), or the columns of the one KV head
    its query heads read."""
    if tp is None or not tp.attn or tp.kv_split:
        return w
    dh = cfg.d_head
    return w[:, tp.kv_first * dh:(tp.kv_first + tp.kv_heads) * dh]


def _out(o, params, tp):
    """``o`` (B, T, heads, Dh) through ``wo``, summed over ``model`` when
    the heads are split (``TPPlan.leave``)."""
    y = o.reshape(o.shape[0], o.shape[1], -1) @ params["wo"]
    return y if tp is None else tp.leave(y, tp.attn)


def _project(params, x, cfg, positions, *, rope: bool = True, tp=None):
    b, t, _ = x.shape
    dh = cfg.d_head
    q = (x @ params["wq"]).reshape(b, t, -1, dh)
    k = (x @ _kv_weight(params["wk"], cfg, tp)).reshape(b, t, -1, dh)
    v = (x @ _kv_weight(params["wv"], cfg, tp)).reshape(b, t, -1, dh)
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


def _all_heads(t, cfg, tp, kv_heads: bool = True):
    """``t`` (B, T, this rank's heads, Dh) — K or V, or with
    ``kv_heads=False`` the queries — with every head of the layer:
    gathered over ``model`` where the plan splits the heads. K/V computed
    one KV head a rank (the KV heads do not divide the axis) gather one
    head a rank, of which every (n / n_kv)-th rank's is a distinct one."""
    if tp is None or not tp.attn:
        return t
    g = all_gather(t, tp.mesh, "model", dim=2)
    if not kv_heads or tp.kv_split:
        return g
    return g[:, :, ::tp.n // cfg.n_kv_heads]


def kv_block(cache, cfg, tp, kv, length: int):
    """A cache ``{"k", "v"}`` of (B, ``length``, this rank's KV heads, Dh)
    in the ``seq_kv`` layout: every KV head, this rank's block of the
    slots (fresh tensors)."""
    start, size = kv.span(length)
    return {n: _all_heads(c, cfg, tp).narrow(1, start, size).clone()
            for n, c in cache.items()}


def _attend_split(q, k, v, valid, kv, length: int):
    """:func:`_attend_one` over a cache split by slots: q (B, Hkv, G, Dh)
    scaled, with every query head; k, v (B, L_block, Hkv, Dh) this rank's
    block of a cache of ``length`` slots, ``valid`` its mask. Each rank
    keeps its float32 max m, sum l and weighted values; M is their max
    over the cache's axes, and the sums of l·e^(m−M) and of the values
    times e^(m−M) over the axes (one all-reduce of both) give the softmax.
    A rank whose block holds no valid slot adds zeros. A cache the axes do
    not split is whole on every rank: :func:`_attend_one`."""
    if not kv.splits(length):
        return _attend_one(q, k, v, valid)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float())
    neg = torch.tensor(NEG, device=s.device)
    if valid is not None:
        s = torch.where(valid, s, neg)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    big = m
    for ax in kv.axes:
        big = max_over(big, kv.mesh, ax)
    scale = torch.exp(m - big)[..., None]
    both = sum_over(torch.cat([acc * scale, p.sum(-1, keepdim=True)
                               * scale], dim=-1), kv.mesh, kv.axes)
    return both[..., :-1] / both[..., -1:]


def _local_heads(o, tp):
    """o (B, T, every head, Dh) → this rank's query heads under the plan
    ``tp``."""
    if tp is None or not tp.attn:
        return o
    return o[:, :, tp.rank * tp.heads:(tp.rank + 1) * tp.heads]


# ---------------------------------------------------------------------------
# train (forward) and prefill entry points
# ---------------------------------------------------------------------------

def attn_train(params, x, cfg, kind: str, *, rope: bool = True,
               causal: bool = True, tp=None):
    """Reference ``attn_train`` (attention.py:177), forward: x (B, T, d) →
    (B, T, d). The whisper encoder calls it with ``causal=False``; with no
    window that is K4, non-causal."""
    t = x.shape[1]
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project(params, x, cfg, positions, rope=rope, tp=tp)
    window = cfg.window if kind == "local" else None
    o = flash_attention(q, k, v, causal=causal, window=window,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    return _out(o, params, tp)


def cache_spec(cfg, kind: str, batch: int, seq_len: int, dtype, tp=None,
               kv=None):
    """Shape of the KV cache for one attention layer of the given kind (of
    this rank's KV heads under the plan ``tp``; under ``kv`` every KV head
    for the rank's block of the slots)."""
    length = min(cfg.window, seq_len) if kind == "local" else seq_len
    heads = cfg.n_kv_heads if tp is None else tp.kv_heads
    if kv is not None:
        heads, length = cfg.n_kv_heads, kv.span(length)[1]
    shp = (batch, length, heads, cfg.d_head)
    return {"k": TensorSpec(shp, dtype), "v": TensorSpec(shp, dtype)}


def attn_prefill(params, x, cfg, kind: str, cache_len: int, tp=None,
                 kv=None):
    """Full-sequence pass that also returns the populated KV cache.

    For "local" layers the cache is the rolling window (last ``window``
    positions, ring-aligned); otherwise the full ``cache_len`` buffer with the
    first T slots filled. Under ``kv`` the rank keeps every KV head for its
    block of the slots.
    """
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project(params, x, cfg, positions, tp=tp)
    window = cfg.window if kind == "local" else None
    o = flash_attention(q, k, v, causal=True, window=window,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    y = _out(o, params, tp)

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
    cache = {"k": k_c, "v": v_c}
    if kv is not None:
        cache = kv_block(cache, cfg, tp, kv, k_c.shape[1])
    return y, cache


def attn_decode(params, x, cache, pos: int, cfg, kind: str, tp=None,
                kv=None):
    """Reference ``attn_decode`` (attention.py:231): one token x (B, 1, d)
    at absolute position ``pos``. Its K/V go into a new cache: slot ``pos
    % length`` of a "local" ring, else slot ``pos`` (clamped to the last,
    as the reference's update clamps). The query scores the whole cache
    under the reference's ``valid`` mask: the ring's slots hold positions
    ``pos - age``, valid while ≥ 0 and inside the window. Returns (y (B,
    1, d), {"k", "v"}).

    Under ``kv`` the cache is the rank's block of the slots for every KV
    head: the new K/V and every query head are made whole on each rank,
    the rank whose block holds the (global, clamped) slot writes it, the
    mask is cut to the block, the scores are combined over the cache's
    axes (:func:`_attend_split`), and the rank's heads go through the
    row-parallel ``wo``."""
    b = x.shape[0]
    dh = cfg.d_head
    positions = torch.full((b, 1), pos, device=x.device)
    q, k_new, v_new = _project(params, x, cfg, positions, tp=tp)
    if kv is None:
        length = cache["k"].shape[1]
        start, size = 0, length
    else:
        q = _all_heads(q, cfg, tp, kv_heads=False)
        k_new, v_new = _all_heads(k_new, cfg, tp), _all_heads(v_new, cfg, tp)
        length = min(cfg.window, kv.cache_len) if kind == "local" \
            else kv.cache_len
        start, size = kv.span(length)
        if cache["k"].shape[1] != size:
            raise ValueError(f"the rank's cache holds {cache['k'].shape[1]}"
                             f" slots, not its {size} of {length}")
    slots = start + torch.arange(size, device=x.device)
    if kind == "local":
        slot = pos % length
        abs_pos = pos - (pos - slots) % length
        valid = (abs_pos >= 0) & (abs_pos > pos - cfg.window)
    else:
        slot = pos
        valid = slots <= pos
    slot = min(max(slot, 0), length - 1) - start
    if 0 <= slot < size:
        k_c = _write_slot(cache["k"], k_new, slot)
        v_c = _write_slot(cache["v"], v_new, slot)
    else:
        k_c, v_c = cache["k"], cache["v"]
    hkv = k_new.shape[2]
    qh = (q * dh ** -0.5).reshape(b, hkv, q.shape[2] // hkv, dh)
    if kv is None:
        o = _attend_one(qh, k_c, v_c, valid)
    else:
        o = _attend_split(qh, k_c, v_c, valid, kv, length)
    o = _local_heads(o.to(x.dtype).reshape(b, 1, -1, dh),
                     None if kv is None else tp)
    return _out(o, params, tp), {"k": k_c, "v": v_c}


# --- cross attention (whisper decoder) --------------------------------------

def cross_attn_train(params, x, enc, cfg, tp=None):
    """Reference ``cross_attn_train`` (attention.py:266): x (B, Td, d)
    queries, enc (B, Te, d) keys and values; no RoPE, no qk-norm, no mask.
    K4 with ``causal=False`` and Tq != Tk. Returns (y, the ``{"k", "v"}``
    cross cache)."""
    b, t, _ = x.shape
    te = enc.shape[1]
    dh = cfg.d_head
    q = (x @ params["wq"]).reshape(b, t, -1, dh)
    k = (enc @ _kv_weight(params["wk"], cfg, tp)).reshape(b, te, -1, dh)
    v = (enc @ _kv_weight(params["wv"], cfg, tp)).reshape(b, te, -1, dh)
    o = flash_attention(q, k, v, causal=False, window=None,
                        chunk_q=cfg.chunk_q, chunk_k=cfg.chunk_k)
    return _out(o, params, tp), {"k": k, "v": v}


def cross_attn_decode(params, x, cross_cache, cfg, tp=None, kv=None):
    """Reference ``cross_attn_decode`` (attention.py:280): one decoder
    token x (B, 1, d) against the prefill's cross cache; no RoPE, no
    mask. Under ``kv`` the cross cache is the rank's block of the encoder
    positions for every KV head, as :func:`attn_decode`'s."""
    b = x.shape[0]
    dh = cfg.d_head
    hkv = cross_cache["k"].shape[2]
    if kv is None:
        q = (x @ params["wq"]).reshape(b, hkv, -1, dh) * dh ** -0.5
        o = _attend_one(q, cross_cache["k"], cross_cache["v"]).to(x.dtype)
        return _out(o.reshape(b, 1, -1, dh), params, tp)
    q = _all_heads((x @ params["wq"]).reshape(b, 1, -1, dh), cfg, tp,
                   kv_heads=False)
    q = q.reshape(b, hkv, -1, dh) * dh ** -0.5
    o = _attend_split(q, cross_cache["k"], cross_cache["v"], None, kv,
                      kv.enc_len).to(x.dtype)
    return _out(_local_heads(o.reshape(b, 1, -1, dh), tp), params, tp)
