"""The closed loops that drive the program, one kind of traffic each, and
the answers they leave for the check.

A loop builds the program's state in :meth:`setup` (weights from the
seed, the traffic's inputs, one warm call of the shape the window runs),
makes one timed call in :meth:`call` (ending in a device synchronise),
keeps what the check needs, and after the window gives the program's
answers in one form for every kind (:meth:`answers`) beside the plain
reference's (:meth:`reference`). The program is reached through its
public entry points, looked up at each call: ``repro_torch.models.prefill``,
``decode_step`` and ``repro_torch.training.optimizer.make_train_step``.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from . import weights as W
from .reference import rwkv6 as ref_rwkv
from .reference import train as ref_train
from .reference import transformer as ref_attn
from .reference.common import strict_f32


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float32 (b the reference)."""
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def row_rel(a, b) -> float:
    """The largest :func:`rel` over the rows of (…, V) logits."""
    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    num = torch.linalg.vector_norm(a - b, dim=-1)
    den = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=1e-30)
    return float((num / den).max())


class Loop:
    """One cell's loop over the program under test (see the module)."""

    kind = ""

    def __init__(self, c: dict, cfg, traffic: dict, seed: int, device):
        self.c, self.cfg, self.traffic = c, cfg, traffic
        self.seed, self.device = seed, torch.device(device)
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0x5A3B1E]))

    def params(self):
        return W.draw_params(self.c, self.seed, self.device)

    def tokens(self, stream: int, rows: int, t: int):
        return torch.from_numpy(W.zipf_tokens(
            self.seed, stream, rows, t, self.c["vocab_size"],
            self.traffic.get("zipf_a", 1.3))).to(self.device)

    def release(self) -> None:
        """Drops the program's state (weights, inputs), keeping the
        answers for the check."""
        for name in ("p", "prompts", "cache", "last", "tok",
                     "opt_state", "step"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------- prefill

class Prefill(Loop):
    """Prefills of ``batch`` fresh prompts of ``prompt_len`` tokens into a
    cache of ``cache_len`` slots, one after another. The prompts cycle
    through ``distinct_prompts`` batches drawn from the seed. One call of
    the window, drawn from the seed as the window runs (a reservoir
    sample), keeps its logits and cache for the check."""

    kind = "prefill"

    def setup(self) -> None:
        tr = self.traffic
        self.b, self.t = tr["batch"], tr["prompt_len"]
        self.p = self.params()
        self.prompts = [self.tokens(i, self.b, self.t)
                        for i in range(tr["distinct_prompts"])]
        warm = self._run(self.tokens(1 << 20, self.b, self.t))
        del warm
        sync(self.device)
        self.kept = None

    def _run(self, toks):
        from repro_torch import models
        return models.prefill(self.p, {"tokens": toks}, self.cfg,
                              self.traffic["cache_len"])

    def call(self, i: int) -> int:
        out = self._run(self.prompts[i % len(self.prompts)])
        sync(self.device)
        if self.rng.integers(0, i + 1) == 0:
            self.kept = (i, out)
        del out
        return self.b * self.t

    def answers(self) -> dict:
        i, (logits, cache) = self.kept
        st = cache["scan"]["pos0"]
        if "k" in st:
            state = {n: [st[n][li, :, :self.t]
                         for li in range(st[n].shape[0])]
                     for n in ("k", "v")}
        else:
            state = {n: list(st[n]) for n in ("s", "x_att", "x_ffn")}
        return {"call": i, "logits": logits, "state": state}

    def reference(self, precision: str = "f32", ans=None) -> dict:
        i = self.kept[0]
        toks = self.tokens(i % self.traffic["distinct_prompts"], self.b,
                           self.t)
        params = self.params()
        state: dict = {}

        if tuple(self.c["block_pattern"]) == ("rwkv",):
            def keep(li, st):
                for n, x in st.items():
                    state.setdefault(n, []).append(x)
            with strict_f32(), torch.no_grad():
                logits = ref_rwkv.forward(params, toks, self.c,
                                          precision=precision,
                                          on_layer=keep)
        else:
            def keep(li, k, v):
                state.setdefault("k", []).append(k)
                state.setdefault("v", []).append(v)
            with strict_f32(), torch.no_grad():
                logits = ref_attn.forward(params, toks, self.c,
                                          precision=precision,
                                          on_layer=keep)
        return {"logits": logits, "state": state}

    @staticmethod
    def compare(ans: dict, ref: dict) -> dict:
        """The numbers the check holds: the worst row's logits and the
        worst layer's cache (each leaf) relative to the reference."""
        cache = max(rel(a, b) for n in ref["state"]
                    for a, b in zip(ans["state"][n], ref["state"][n]))
        return {"logits_rel": row_rel(ans["logits"], ref["logits"]),
                "cache_rel": cache}


# ---------------------------------------------------------------- decode

class Decode(Loop):
    """Greedy decode steps of ``batch`` rows against a cache of
    ``cache_len`` slots drawn from the seed, from position ``start_pos``:
    each step feeds the argmax of the last step's logits. When the slots
    are full the rows start again, with first tokens of the next segment,
    from the cache drawn afresh, so no step clamps and a program that
    writes into the cache it is handed never feeds a later segment what an
    earlier one wrote. The first segment's fed tokens, logits and last
    cache are kept for the check; its drawn slots are held against the
    cache drawn once more from the seed."""

    kind = "decode"

    def setup(self) -> None:
        tr = self.traffic
        self.b, self.start = tr["batch"], tr["start_pos"]
        self.seg_len = tr["cache_len"] - self.start
        self.p = self.params()
        # the first segment's cache; the warm step writes slot start_pos
        # at most, which the window's first step writes again
        self.cache = self._drawn()
        warm = self._run(self.cache, self._first(1 << 20), self.start)
        del warm
        sync(self.device)
        self.fed, self.logits, self.last = [], [], None

    def _drawn(self) -> dict:
        return {"scan": {"pos0": W.draw_kv_cache(
            self.c, self.seed, self.b, self.traffic["cache_len"],
            self.device)}}

    def _first(self, seg: int):
        return self.tokens(seg, 1, self.b)[0]

    def _run(self, cache, tok, pos):
        from repro_torch import models
        return models.decode_step(self.p, cache, tok, pos, self.cfg)

    def call(self, i: int) -> int:
        seg, j = divmod(i, self.seg_len)
        if j == 0:
            self.tok = self._first(seg)
            if seg > 0:
                self.cache = None
                self.cache = self._drawn()
        logits, self.cache = self._run(self.cache, self.tok, self.start + j)
        if seg == 0:
            self.fed.append(self.tok)
            self.logits.append(logits)
        self.tok = logits.argmax(-1)
        sync(self.device)
        if seg == 0:
            self.last = self.cache
        return self.b

    def answers(self) -> dict:
        n = len(self.fed)
        kv = self.last["scan"]["pos0"]
        s, e = self.start, self.start + n
        drawn = self._drawn()["scan"]["pos0"]
        changed = int(sum((kv[nm][:, :, :s] != drawn[nm][:, :, :s]).sum()
                          for nm in ("k", "v")))
        del drawn
        return {"tokens": torch.stack(self.fed, 1),
                "logits": torch.stack(self.logits, 1),
                "state": {nm: [kv[nm][li, :, s:e].clone()
                               for li in range(kv[nm].shape[0])]
                          for nm in ("k", "v")},
                "past_changed": changed}

    def reference(self, precision: str = "f32", ans=None) -> dict:
        """The reference fed the window's served tokens ``ans["tokens"]``
        (B, n) from ``start_pos``, over the drawn cache's first slots."""
        tokens = ans["tokens"]
        params = self.params()
        kv = W.draw_kv_cache(self.c, self.seed, self.b,
                             self.traffic["cache_len"], self.device)
        s = self.start
        state: dict = {}

        def keep(li, k, v):
            state.setdefault("k", []).append(k)
            state.setdefault("v", []).append(v)
        with strict_f32(), torch.no_grad():
            logits = ref_attn.forward(
                params, tokens, self.c, precision=precision, pos0=s,
                past=lambda li: (kv["k"][li, :, :s], kv["v"][li, :, :s]),
                logits="all", on_layer=keep)
        return {"logits": logits, "state": state}

    @staticmethod
    def compare(ans: dict, ref: dict) -> dict:
        """The worst step's logits, the widest gap by which a served
        token's reference logit lies below the reference's best, the
        worst layer's new keys and values, and the drawn slots changed."""
        lg = ref["logits"]
        served = ans["logits"].float().argmax(-1)
        gap = lg.max(-1).values - lg.gather(-1, served[..., None])[..., 0]
        cache = max(rel(a, b) for n in ref["state"]
                    for a, b in zip(ans["state"][n], ref["state"][n]))
        return {"logits_rel": row_rel(ans["logits"], lg),
                "token_gap": float(gap.max()),
                "cache_rel": cache,
                "past_changed": float(ans.get("past_changed", 0))}


# ---------------------------------------------------------------- train

def unit_norms(tree, of) -> dict:
    """``{unit: float32 norm of of(tensor, path, layer)}`` over a
    parameter-shaped tree: a stacked leaf a layer at a time (``path#l``),
    as the reference names its units."""
    out = {}
    for path, t in W.flat(tree).items():
        if path.startswith("scan."):
            for li in range(t.shape[0]):
                out[f"{path}#{li}"] = float(torch.linalg.vector_norm(
                    of(t[li], path, li).float()))
        else:
            out[path] = float(torch.linalg.vector_norm(
                of(t, path, None).float()))
    return out


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst unit's gap between the program's norm and the
    reference's, against the larger of the reference's norm of that unit
    and of the median unit."""
    keys = [k for k in ref if keep is None or k in keep]
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


class Train(Loop):
    """Training steps of ``microbatches`` sequences of ``seq_len`` tokens
    (one a microbatch; ``make_train_step(n_microbatches=...)``, bf16
    weights, float32 accumulator and AdamW moments, the traffic's
    ``opt``), each step's tokens drawn from the seed. Set-up builds the
    step and its state once and drives them through the
    ``checked_steps`` steps the reference follows, reading what the check
    compares: each step's loss, every unit's norm of step 1's gradient as
    the optimizer got it (from its first moment), and every unit's change
    after those steps. The window goes on with the same object."""

    kind = "train"

    def batch(self, k: int):
        tr = self.traffic
        tok = self.tokens(k, tr["microbatches"] * tr["micro_batch"],
                          tr["seq_len"])
        lab = torch.cat([tok[:, 1:], torch.full_like(tok[:, :1], -100)], 1)
        return tok, lab

    def setup(self) -> None:
        from repro_torch.training import optimizer as O
        tr, o = self.traffic, self.traffic["opt"]
        if tr.get("allocator") and self.device.type == "cuda":
            # the deployment's allocator: the step holds ~92 % of the
            # card, where split blocks left ~10 GiB unusable (out of
            # memory in the window's first step)
            torch.cuda.memory._set_allocator_settings(tr["allocator"])
        self.opt = o
        self.p = self.params()
        self.opt_state = O.opt_init(self.p)
        self.step = O.make_train_step(
            self.cfg, O.OptConfig(**o),
            n_microbatches=tr["microbatches"])
        self.ans = {"losses": []}
        for k in range(1, tr["checked_steps"] + 1):
            self._step(k)
            if k == 1:
                b1 = o["b1"]
                scale = min(1.0, o["clip_norm"] / max(self.gnorm, 1e-12))
                self.ans["grad"] = unit_norms(
                    self.opt_state["m"],
                    lambda t, p, li: t / ((1 - b1) * scale))
            if k == tr["checked_steps"]:
                p0 = self.params()
                p0f = W.flat(p0)
                self.ans["change"] = unit_norms(
                    self.p, lambda t, p, li: t.float() - (
                        p0f[p][li] if li is not None else p0f[p]).float())
                del p0, p0f
        self.done = tr["checked_steps"]

    def _step(self, k: int) -> None:
        tok, lab = self.batch(k)
        self.p, self.opt_state, met = self.step(
            self.p, self.opt_state, {"tokens": tok, "labels": lab})
        self.ans["losses"].append(float(met["loss"]))
        self.gnorm = float(met["grad_norm"])

    def call(self, i: int) -> int:
        tok, lab = self.batch(self.done + 1 + i)
        self.p, self.opt_state, _ = self.step(
            self.p, self.opt_state, {"tokens": tok, "labels": lab})
        sync(self.device)
        return tok.numel()

    def answers(self) -> dict:
        return self.ans

    def reference(self, precision: str = "f32", ans=None) -> dict:
        n = self.traffic["checked_steps"]
        batches = [self.batch(k) for k in range(1, n + 1)]
        with strict_f32():
            out = ref_train.steps(self.params(), batches, self.c, self.opt,
                                  precision)
        p0 = W.flat(self.params())
        after = out.pop("params")
        out["change"] = {}
        for u, t in after.items():
            path, _, li = u.partition("#")
            base = p0[path][int(li)] if li else p0[path]
            out["change"][u] = float(torch.linalg.vector_norm(
                t - base.float()))
        del after, p0
        return out

    @staticmethod
    def compare(ans: dict, ref: dict) -> dict:
        """Each followed step's loss relative to the reference's
        (``loss_gap.k``), and by the worst unit: step 1's gradient norm and
        the change's norm after the followed steps, the change over the units
        whose reference gradient is at least a thousandth of the median
        unit's (round-off alone moves the others under Adam)."""
        out = {f"loss_gap.{k}": abs(a - b) / abs(b) for k, (a, b) in
               enumerate(zip(ans["losses"], ref["losses"]), 1)}
        g = ref["grad"]
        med = sorted(g.values())[len(g) // 2]
        moved = {k for k, v in g.items() if v >= 1e-3 * med}
        out["grad_gap"] = norm_gap(ans["grad"], ref["grad"])
        out["change_gap"] = norm_gap(ans["change"], ref["change"], moved)
        return out


KINDS = {"prefill": Prefill, "decode": Decode, "train": Train}
