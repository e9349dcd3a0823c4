"""Plain float32 reference of the attention models the benchmark runs
(ChatGLM's family): pre-norm blocks of grouped-query attention with
rotary on a fraction of each head, a SwiGLU FFN, RMS norms with a
(1 + w) scale, an untied head. Written from the configuration; imports
nothing of the program.

One pass, :func:`forward`, serves prefill, decode and training: tokens
(B, T) at positions ``pos0 ...``, attending to ``past`` keys and values of
the first ``pos0`` positions. Each layer's new keys and values go to
``on_layer`` as they are made. The products run in row blocks so that a
32k prompt fits beside the program's outputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision, rms_norm, rotary_tables, rotate

ROWS = 8192          # tokens a block of the FFN and projections
Q_BLOCK = 1024       # queries a block of the attention


def _rows(x, fn, rows=ROWS):
    """fn over blocks of ``rows`` tokens of x (N, d)."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def attention(q, k, v, pos0: int, prec: Precision):
    """Causal attention of q (B, Tq, Hq, Dh) at positions pos0 ... over
    k, v (B, pos0 + Tq, Hkv, Dh), in float32, a KV head and a block of
    queries at a time."""
    b, tq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    out = torch.empty((b, tq, hq, dh), dtype=torch.float32,
                      device=q.device)
    for bi in range(b):
        for h in range(hkv):
            kh = prec.a(k[bi, :, h])                  # (Tk, Dh)
            vh = v[bi, :, h].float()
            qh = q[bi, :, h * g:(h + 1) * g].float() * dh ** -0.5
            for s in range(0, tq, Q_BLOCK):
                e = min(s + Q_BLOCK, tq)
                span = pos0 + e
                qb = prec.a(qh[s:e]).transpose(0, 1)  # (G, cq, Dh)
                sc = qb @ kh[:span].T                 # (G, cq, span)
                qpos = pos0 + torch.arange(s, e, device=q.device)
                keep = torch.arange(span, device=q.device)[None, :] \
                    <= qpos[:, None]
                sc = torch.where(keep, sc, float("-inf"))
                p = torch.softmax(sc, dim=-1)
                o = prec.a(p) @ prec.a(vh[:span])
                out[bi, s:e, h * g:(h + 1) * g] = o.transpose(0, 1)
    return out


def layer(p, x, c: dict, pos0: int, past, prec: Precision):
    """One block on x (B, T, d) float32 → (x, k, v), k and v this layer's
    keys and values of the T new positions."""
    b, t, d = x.shape
    dh = c["d_head"]
    eps = c["norm_eps"]
    d_rot = int(dh * c["rope_fraction"]) // 2 * 2
    cos, sin = rotary_tables(pos0 + torch.arange(t, device=x.device), d_rot,
                             c["rope_theta"])
    wq, wk, wv, wo = (prec.w(p["attn"][n]) for n in ("wq", "wk", "wv", "wo"))
    h = rms_norm(x, p["ln1"], eps).reshape(b * t, d)
    q = _rows(h, lambda r: prec.mm(r, wq)).reshape(b, t, -1, dh)
    k = _rows(h, lambda r: prec.mm(r, wk)).reshape(b, t, -1, dh)
    v = _rows(h, lambda r: prec.mm(r, wv)).reshape(b, t, -1, dh)
    del h
    q = rotate(q, cos, sin, d_rot)
    k = rotate(k, cos, sin, d_rot)
    if past is not None:
        pk, pv = past
        kk = torch.cat([pk.float(), k], 1)
        vv = torch.cat([pv.float(), v], 1)
    else:
        kk, vv = k, v
    o = attention(q, kk, vv, pos0, prec).reshape(b * t, -1)
    del q, kk, vv
    x = x + _rows(o, lambda r: prec.mm(r, wo)).reshape(b, t, d)
    del o
    wg, wu, wd = (prec.w(p["ffn"][n]) for n in ("w_gate", "w_up", "w_down"))
    h = rms_norm(x, p["ln2"], eps).reshape(b * t, d)

    def ffn(r):
        return prec.mm(F.silu(prec.mm(r, wg)) * prec.mm(r, wu), wd)
    x = x + _rows(h, ffn, ROWS // 4).reshape(b, t, d)
    return x, k, v


def forward(params, tokens, c: dict, *, precision: str = "f32", pos0=0,
            past=None, logits: str = "last", on_layer=None):
    """The model over ``tokens`` (B, T) at positions pos0 ... →
    logits, float32: of the last position (B, V) or of all (B, T, V).
    ``past(l)`` gives layer l's keys and values of the first ``pos0``
    positions, (B, pos0, Hkv, Dh) each; ``on_layer(l, k, v)`` takes each
    layer's new ones."""
    prec = Precision(precision)
    x = F.embedding(tokens, params["embed"]).float()
    scan = params["scan"]["pos0"]
    for li in range(c["n_layers"]):
        p = {"ln1": scan["ln1"][li], "ln2": scan["ln2"][li],
             "attn": {n: w[li] for n, w in scan["attn"].items()},
             "ffn": {n: w[li] for n, w in scan["ffn"].items()}}
        x, k, v = layer(p, x, c, pos0, None if past is None else past(li),
                        prec)
        if on_layer is not None:
            on_layer(li, k, v)
        del k, v
    if logits == "last":
        x = x[:, -1:]
    x = rms_norm(x, params["final_ln"], c["norm_eps"])
    head = prec.w(params["lm_head"])
    b, t, d = x.shape
    out = _rows(x.reshape(b * t, d), lambda r: prec.mm(r, head), 1024)
    out = out.reshape(b, t, -1)
    return out[:, 0] if logits == "last" else out
