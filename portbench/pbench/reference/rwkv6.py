"""Plain float32 reference of the RWKV-6 ("Finch") models the benchmark
runs, in the port's form: pre-norm blocks of a time mix (static token
shift mixes, data-dependent decay w = exp(-exp(w0 + tanh(x A) B)), the
WKV state S_t = diag(w_t) S_{t-1} + k_t v_tᵀ read as
o_t = r_tᵀ S_{t-1} + (r_t · (u ⊙ k_t)) v_t, a group norm per head and a
SiLU gate) and a channel mix (squared ReLU, sigmoid receptance), RMS
norms with a (1 + w) scale, an untied head. Written from the
configuration; imports nothing of the program.

The WKV runs in chunks of ``CHUNK`` tokens: within a chunk every term is
a product of the chunk's own tensors (decays as differences of
cumulative log-decays, never positive), and the state is carried from
chunk to chunk in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Precision, rms_norm

CHUNK = 16
ROWS = 8192


def _rows(x, fn, rows=ROWS):
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def _shift(x, prev):
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    mu = mu.float()
    return x * mu + xs * (1.0 - mu)


def wkv(r, k, v, logw, u, s0):
    """r, k, v, logw (B, H, T, N) float32, u (H, N), s0 (B, H, N, N) →
    (o (B, H, T, N), the last state)."""
    b, h, t, n = r.shape
    s = s0
    outs = []
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=r.device), -1)
    uu = u.float()[None, :, None, :]
    for c0 in range(0, t, CHUNK):
        rc, kc, vc, lw = (z[:, :, c0:c0 + CHUNK] for z in (r, k, v, logw))
        c = rc.shape[2]
        lc = torch.cumsum(lw, dim=2)
        lp = lc - lw
        o = (rc * torch.exp(lp)) @ s
        dec = lp[:, :, :, None, :] - lc[:, :, None, :, :]   # (B,H,i,j,N)
        dec = torch.where(tri[:c, :c, None], torch.exp(torch.clamp(dec,
                                                                    max=0.0)),
                          0.0)
        att = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * dec).sum(-1)
        o = o + att @ vc
        o = o + (rc * uu * kc).sum(-1, keepdim=True) * vc
        outs.append(o)
        last = lc[:, :, -1:, :]
        s = torch.exp(last[:, :, 0, :, None]) * s \
            + (kc * torch.exp(last - lc)).transpose(-1, -2) @ vc
    return torch.cat(outs, dim=2), s


def _group_norm(o, scale, n: int, eps: float = 1e-5):
    shp = o.shape
    oh = o.reshape(shp[:-1] + (shp[-1] // n, n))
    mean = oh.mean(-1, keepdim=True)
    var = oh.var(-1, keepdim=True, correction=0)
    return ((oh - mean) * torch.rsqrt(var + eps)).reshape(shp) \
        * scale.float()


def time_mix(p, x, c: dict, prec: Precision):
    """x (B, T, d) float32, the normed input → (y, state)."""
    b, t, d = x.shape
    n = c["rwkv_head_dim"]
    h = d // n
    xs = _shift(x, torch.zeros_like(x[:, 0]))

    def proj(mu, w):
        return _rows(_mix(x, xs, p[mu]).reshape(b * t, d),
                     lambda r: prec.mm(r, prec.w(p[w]))).reshape(b, t, -1)
    r, k, v = proj("mu_r", "w_r"), proj("mu_k", "w_k"), proj("mu_v", "w_v")
    g = F.silu(proj("mu_g", "w_g"))
    xw = _mix(x, xs, p["mu_w"])
    logw = -torch.exp(p["w0"].float() + torch.tanh(
        prec.mm(xw, prec.w(p["w_lora_a"]))) @ p["w_lora_b"].float())

    def heads(z):
        return prec.a(z).reshape(b, t, h, n).transpose(1, 2)
    o, s = wkv(heads(r), heads(k), heads(v),
               logw.reshape(b, t, h, n).transpose(1, 2), p["u"],
               torch.zeros((b, h, n, n), device=x.device))
    o = _group_norm(o.transpose(1, 2).reshape(b, t, d), p["ln_x"], n)
    y = _rows((o * g).reshape(b * t, d),
              lambda r: prec.mm(r, prec.w(p["w_o"]))).reshape(b, t, d)
    return y, {"s": s, "x_att": x[:, -1]}


def channel_mix(p, x, c: dict, prec: Precision):
    b, t, d = x.shape
    xs = _shift(x, torch.zeros_like(x[:, 0]))
    wk, wv, wr = prec.w(p["w_k"]), prec.w(p["w_v"]), prec.w(p["w_r"])
    xk = _mix(x, xs, p["mu_k"]).reshape(b * t, d)
    xr = _mix(x, xs, p["mu_r"]).reshape(b * t, d)
    kv = _rows(xk, lambda r: prec.mm(torch.relu(prec.mm(r, wk)) ** 2, wv),
               ROWS // 4)
    r = torch.sigmoid(_rows(xr, lambda z: prec.mm(z, wr)))
    return (r * kv).reshape(b, t, d), {"x_ffn": x[:, -1]}


def forward(params, tokens, c: dict, *, precision: str = "f32",
            on_layer=None):
    """The model over ``tokens`` (B, T) from a zero state → the last
    position's logits (B, V) float32; ``on_layer(l, state)`` takes each
    layer's state after the prompt: {"s", "x_att", "x_ffn"}."""
    prec = Precision(precision)
    eps = c["norm_eps"]
    x = F.embedding(tokens, params["embed"]).float()
    scan = params["scan"]["pos0"]
    for li in range(c["n_layers"]):
        tp = {n: w[li] for n, w in scan["time"].items()}
        cp = {n: w[li] for n, w in scan["channel"].items()}
        y, st = time_mix(tp, rms_norm(x, scan["ln1"][li], eps), c, prec)
        x = x + y
        y, st2 = channel_mix(cp, rms_norm(x, scan["ln2"][li], eps), c, prec)
        x = x + y
        if on_layer is not None:
            on_layer(li, {**st, **st2})
        del y, st, st2
    x = rms_norm(x[:, -1:], params["final_ln"], eps)
    return prec.mm(x[:, 0], prec.w(params["lm_head"]))
