"""K4′'s tensor-core route on a training step's own inputs, against the
float64 plain version: the kernel, an exact emulation of its roundings (P
from K4's log-sum-exp, P and dS rounded to bf16 before the products that
sum them into dv, dq and dk) and SDPA's backward (a yardstick), each as a
share of ``chip_smoke.py``'s K4′ tolerance for the route without and with
its ``K4B_TC_RSS`` term, and the kernel's distance to the emulation.

The inputs are every K4′ call of chatglm3-6b's meshless ``loss_and_grads``
at 4 layers (B 2, T 2048, remat, seeded weights and batch), each cut to
one KV head and its 16 query heads: the call a rank of phase 23's tp = 2
Megatron-SP step makes.

Run on a machine with a card: ``python3 tools/k4b_rounding_probe.py``
(about a minute, kernels built included); ``--cpu`` runs the same code at
a tiny size on the CPU, where K4′ is its plain version.
"""
import dataclasses
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
import chip_smoke as CS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.attn import attn as PA  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402


def setup(cpu: bool):
    """→ (device, T, config): the card at chatglm3-6b's full width and 4
    layers (the kernels built first), or with ``cpu`` a tiny bf16
    config of the same family on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if not cpu:
        CS.build_kernels()
        return torch.device("cuda"), 2048, dataclasses.replace(
            get_config("chatglm3-6b"), n_layers=4, remat=True)
    from repro_torch.configs.base import reduce_for_smoke
    for f in ("synchronize", "empty_cache"):
        setattr(torch.cuda, f, lambda *a, **k: None)
    return torch.device("cpu"), 32, dataclasses.replace(reduce_for_smoke(
        get_config("chatglm3-6b"), param_dtype="bfloat16"), remat=True)


def plain_lse(q, k):
    """K4's causal log-sum-exp in float32 (the CPU path writes none)."""
    b, tq, hq, dh = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, tq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * dh ** -0.5
    valid = torch.arange(k.shape[1])[None, :] <= torch.arange(tq)[:, None]
    s = s.masked_fill(~valid, float("-inf"))
    return torch.logsumexp(s, -1).reshape(b, hq, tq)


def emulate(q, k, v, out, dout, lse):
    """K4′ of the tensor-core route's design in float64: P = exp(S c -
    lse) from the given LSE, D = rowsum(dO o O), dS = P o (dO V^T - D);
    P and dS rounded to bf16 before dV = P^T dO, dQ = c dS K and
    dK = c dS^T Q (causal)."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g, c = hq // hkv, dh ** -0.5
    qf = q.double().reshape(b, tq, hkv, g, dh)
    kf, vf = k.double(), v.double()
    valid = torch.arange(tk, device=q.device)[None, :] \
        <= torch.arange(tq, device=q.device)[:, None]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * c
    p = torch.where(valid, torch.exp(
        s - lse.double().reshape(b, hkv, g, tq, 1)), 0.0)
    del s
    do = dout.double().reshape(b, tq, hkv, g, dh)
    d = (do * out.double().reshape(b, tq, hkv, g, dh)).sum(-1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", do, vf)
              - d.permute(0, 2, 3, 1)[..., None])
    ds = ds.to(torch.bfloat16).double()
    dq = c * torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
    dk = c * torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    del ds
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(torch.bfloat16).double(),
                      do)
    return dq.reshape(q.shape), dk, dv


def sdpa_grads(q, k, v, dout):
    qq, kk, vv = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                       enable_gqa=True)
    return tuple(t.transpose(1, 2) for t in torch.autograd.grad(
        o, (qq, kk, vv), dout.transpose(1, 2)))


def main():
    dev, T, cfg = setup("--cpu" in sys.argv)
    params = CS.lm_model(dev, cfg)
    batch = CS.train_batch(dev, cfg, 2, T)
    calls, bwd = [], PA.flash_attention_bwd

    def grab(q, k, v, out, dout, *, causal=True, lse=None):
        calls.append([t.detach().clone() for t in (
            q, k, v, out, dout, plain_lse(q, k) if lse is None else lse)])
        return bwd(q, k, v, out, dout, causal=causal, lse=lse)
    PA.flash_attention_bwd = grab
    O.loss_and_grads(params, batch, cfg)
    PA.flash_attention_bwd = bwd
    del params
    torch.cuda.empty_cache()
    print(f"{len(calls)} K4′ calls of {tuple(calls[0][0].shape)}, each cut "
          "to one KV head", flush=True)
    tol = CS.K4B_TC_TOL
    worst = {}
    for n, (q, k, v, out, dout, lse) in enumerate(calls):
        g = q.shape[2] // k.shape[2]
        for h in range(k.shape[2]):
            heads = slice(h * g, (h + 1) * g)
            ins = tuple(t[:, :, sl].contiguous() for t, sl in zip(
                (q, k, v, out, dout), (heads, slice(h, h + 1),
                                       slice(h, h + 1), heads, heads)))
            ls = lse[:, heads].contiguous()
            got = PA.flash_attention_bwd(*ins, causal=True, lse=ls)
            ref64 = PA.flash_attention_bwd_ref(*(t.double() for t in ins),
                                               causal=True)
            terms = CS.k4b_terms(*ins, True)
            rss = CS.k4b_rss(*ins, True)
            emu = emulate(*ins, ls)
            sdpa = sdpa_grads(ins[0], ins[1], ins[2], ins[4])
            for i, w in enumerate(("dq", "dk", "dv")):
                line = [f"call {n} kv head {h} {w}:"]
                for name, x in (("kernel", got), ("emulation", emu),
                                ("sdpa", sdpa)):
                    old = CS.k4b_terms_excess(x[i], ref64[i], terms[i], tol)
                    new = CS.k4b_terms_excess(x[i], ref64[i], terms[i], tol,
                                              rss[i])
                    for key, val in ((f"{name} {w}", old),
                                     (f"{name} {w} rss", new)):
                        worst[key] = max(worst.get(key, 0.0), val)
                    line.append(f"{name} {old:.3f} ({new:.3f} with the "
                                "rss term)")
                e, r = emu[i], ref64[i]
                rel = ((got[i].double() - e).abs()
                       / (e.abs() + r.pow(2).mean().sqrt())).max().item()
                worst[f"kernel-emulation {w}"] = max(
                    worst.get(f"kernel-emulation {w}", 0.0), rel)
                line.append(f"|kernel - emulation| / (|emulation| + "
                            f"rms(ref)) {rel:.3g}; terms / |ref| "
                            f"{(terms[i].mean() / r.abs().mean()).item():.1f}")
                print(line[0] + " " + "; ".join(line[1:]), flush=True)
            del got, ref64, terms, rss, emu, sdpa
            torch.cuda.empty_cache()
    print("worst: " + ", ".join(f"{k} {v:.4g}" for k, v in worst.items()))


if __name__ == "__main__":
    main()
