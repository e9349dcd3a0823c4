"""Plain float32 reference of a training step of the attention models:
the token cross-entropy of :mod:`.transformer`'s forward, its gradient
by autograd (each layer recomputed in the backward), accumulated over
microbatches and averaged, clipped by its global norm, and AdamW
(bias-corrected float32 moments, decoupled weight decay, a linear-warmup
cosine schedule) on float32 parameters. Imports nothing of the program.

It follows the first two steps (its time stays near the window's): for
that, step 2's moments are worked out from the two steps' clipped
gradients, so only the parameters, the first step's clipped gradient and
the gradient being accumulated live at once (three float32 copies of the
model). Every layer's leaves are leaves of their own ("units"), named
``path#layer``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Precision, rms_norm
from .transformer import layer


def units(params) -> dict:
    """``{unit: float32 leaf requiring grad}``: each layer of a stacked
    leaf (``scan.…#l``) and each other leaf."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            p = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, p + ".")
            elif p.startswith("scan."):
                for li in range(v.shape[0]):
                    out[f"{p}#{li}"] = v[li].float().requires_grad_(True)
            else:
                out[p] = v.float().requires_grad_(True)
    walk(params, "")
    return out


def _layer_params(u: dict, li: int) -> dict:
    p = {"attn": {}, "ffn": {}}
    for name, t in u.items():
        if not name.endswith(f"#{li}"):
            continue
        keys = name.split("#")[0].split(".")[2:]       # drop scan.pos0
        if len(keys) == 1:
            p[keys[0]] = t
        else:
            p[keys[0]][keys[1]] = t
    return p


def loss(u: dict, tokens, labels, c: dict, prec: Precision):
    """Mean token cross-entropy of ``tokens`` (B, T) against ``labels``
    (-100 ignored), float32, each layer checkpointed."""
    x = F.embedding(tokens, u["embed"])
    for li in range(c["n_layers"]):
        p = _layer_params(u, li)
        x = checkpoint(lambda x, p=p: layer(p, x, c, 0, None, prec)[0], x,
                       use_reentrant=False)
    x = rms_norm(x, u["final_ln"], c["norm_eps"])
    logits = prec.mm(x, prec.w(u["lm_head"]))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), ignore_index=-100)


def lr_at(opt: dict, step: int) -> float:
    """The schedule: linear warmup to ``lr``, then a cosine down to
    ``min_lr_ratio`` of it at ``total_steps``."""
    w = opt["warmup_steps"]
    if step < w:
        return opt["lr"] * step / max(w, 1)
    t = min(max((step - w) / max(opt["total_steps"] - w, 1), 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.detach().float()))
            for k, t in tensors.items()}


def steps(params, batches, c: dict, opt: dict, precision: str = "f32"):
    """The first ``len(batches)`` (at most 2) steps from ``params`` (the
    drawn tree) on ``batches`` (each ``(tokens, labels)`` of (M, T), one
    row a microbatch) → {"losses": [...], "grad": {unit: norm of step 1's
    mean gradient}, "params": {unit: float32 leaf after the steps}}."""
    if len(batches) > 2:
        raise ValueError("the reference follows at most two steps")
    prec = Precision(precision)
    u = units(params)
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    first, out = None, {"losses": []}
    for k, (tokens, labels) in enumerate(batches, 1):
        for t in u.values():
            t.grad = None
        m = tokens.shape[0]
        total = 0.0
        for i in range(m):
            li = loss(u, tokens[i:i + 1], labels[i:i + 1], c, prec)
            li.backward()
            total += float(li.detach())
        out["losses"].append(total / m)
        with torch.no_grad():
            for t in u.values():
                t.grad.div_(m)
            if k == 1:
                out["grad"] = norms({n: t.grad for n, t in u.items()})
            gnorm = math.sqrt(sum(float(torch.sum(t.grad * t.grad))
                                  for t in u.values()))
            scale = min(1.0, opt["clip_norm"] / max(gnorm, 1e-12))
            lr = lr_at(opt, k)
            bc1, bc2 = 1 - b1 ** k, 1 - b2 ** k
            for name, t in u.items():
                g = t.grad.mul_(scale)
                if k == 1:
                    mom, vel = (1 - b1) * g, (1 - b2) * g * g
                else:
                    g1 = first[name]
                    mom = b1 * (1 - b1) * g1 + (1 - b1) * g
                    vel = b2 * (1 - b2) * g1 * g1 + (1 - b2) * g * g
                delta = (mom / bc1) / (torch.sqrt(vel / bc2) + eps) \
                    + opt["weight_decay"] * t
                t.sub_(lr * delta)
                del mom, vel, delta
            if k == 1:
                first = {n: t.grad for n, t in u.items()}
            for t in u.values():
                t.grad = None
    out["params"] = {n: t.detach() for n, t in u.items()}
    return out
