"""A whole run (the harness's look for a card skipped, tiny cells on the
CPU, each cell's own limits) with the timed path broken underneath must
read ``correct: false``: once for each fault the cell can have — a step
that returns its state unchanged, half of the batch left out (the mean
taken over the rest), a token or an answer altered where it is
produced. The cells run on one card: no exchange between cards to leave
out."""

import json
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import tiny  # noqa: E402
from pbench.harness import main  # noqa: E402


def _correct(root, cell, capsys):
    rc = main(["--workload", cell, "--seed", "424242424242", "--seconds",
               "0.2"], root=root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    return line["correct"]


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _halves(tree, n):
    """Each leaf's first n rows (batch axis 1 of a stacked cache, 0 else)
    repeated to the whole batch."""
    if isinstance(tree, dict):
        return {k: _halves(v, n) for k, v in tree.items()}
    return torch.cat([tree[:, :n]] * 2, 1) if tree.dim() > 2 \
        else torch.cat([tree[:n]] * 2, 0)


def prefill_faults(orig):
    def unchanged(params, batch, cfg, cache_len, **kw):
        logits, cache = orig(params, batch, cfg, cache_len, **kw)
        return logits, _zeros(cache)

    def half(params, batch, cfg, cache_len, **kw):
        n = batch["tokens"].shape[0] // 2
        logits, cache = orig(params, {"tokens": batch["tokens"][:n]}, cfg,
                             cache_len, **kw)
        return torch.cat([logits] * 2), {"scan": {
            "pos0": {k: torch.cat([v] * 2, 1)
                     for k, v in cache["scan"]["pos0"].items()}}}

    def altered(params, batch, cfg, cache_len, **kw):
        logits, cache = orig(params, batch, cfg, cache_len, **kw)
        return torch.cat([logits[:1].roll(1, -1), logits[1:]]), cache
    return {"state unchanged": unchanged, "half the batch": half,
            "answer altered": altered}


def decode_faults(orig):
    def unchanged(params, cache, tokens, pos, cfg, **kw):
        logits, _ = orig(params, cache, tokens, pos, cfg, **kw)
        return logits, cache

    def half(params, cache, tokens, pos, cfg, **kw):
        n = tokens.shape[0] // 2
        sub = {"scan": {"pos0": {k: v[:, :n] for k, v in
                                 cache["scan"]["pos0"].items()}}}
        logits, new = orig(params, sub, tokens[:n], pos, cfg, **kw)
        return torch.cat([logits] * 2), _halves(new, n)

    def altered(params, cache, tokens, pos, cfg, **kw):
        logits, new = orig(params, cache, tokens, pos, cfg, **kw)
        logits = logits.clone()
        logits[0, (pos * 7919) % logits.shape[-1]] += 100.0
        return logits, new
    return {"state unchanged": unchanged, "half the batch": half,
            "token altered": altered}


def train_faults(orig):
    def unchanged(cfg, opt, **kw):
        step = orig(cfg, opt, **kw)

        def run(params, state, batch):
            keep = [t.clone() for t in _leaves(params)]
            params, state, met = step(params, state, batch)
            for t, k in zip(_leaves(params), keep):
                t.copy_(k)
            return params, state, met
        return run

    def half(cfg, opt, n_microbatches=1, **kw):
        m = max(1, n_microbatches // 2)
        step = orig(cfg, opt, n_microbatches=m, **kw)

        def run(params, state, batch):
            rows = next(iter(batch.values())).shape[0] // 2
            return step(params, state, {k: v[:rows] for k, v in
                                        batch.items()})
        return run

    def altered(cfg, opt, **kw):
        step = orig(cfg, opt, **kw)

        def run(params, state, batch):
            params, state, met = step(params, state, batch)
            return params, state, dict(met, loss=met["loss"] * 1.05)
        return run
    return {"state unchanged": unchanged, "half the batch": half,
            "answer altered": altered}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


CASES = [("tiny-glm-prefill", "prefill", f) for f in
         ("state unchanged", "half the batch", "answer altered")] \
    + [("tiny-rwkv-prefill", "prefill", f) for f in
       ("state unchanged", "half the batch", "answer altered")] \
    + [("tiny-glm-decode", "decode_step", f) for f in
       ("state unchanged", "half the batch", "token altered")] \
    + [("tiny-glm-train", "make_train_step", f) for f in
       ("state unchanged", "half the batch", "answer altered")]


@pytest.mark.parametrize("cell,entry,fault", CASES)
def test_fault_reads_incorrect(tmp_path, capsys, monkeypatch, cell, entry,
                               fault):
    from repro_torch import models
    from repro_torch.training import optimizer
    root = tiny.make_root(tmp_path)
    assert _correct(root, cell, capsys) is True
    if entry == "make_train_step":
        mod, make = optimizer, train_faults
    else:
        mod = models
        make = prefill_faults if entry == "prefill" else decode_faults
    monkeypatch.setattr(mod, entry, make(getattr(mod, entry))[fault])
    assert _correct(root, cell, capsys) is False


def in_place_decode(orig, past_altered=False):
    """``decode_step`` as a program that keeps its cache in place: it
    writes the new slot into the cache it is handed and returns that
    cache. With ``past_altered`` it also writes into a drawn slot."""
    def step(params, cache, tokens, pos, cfg, **kw):
        logits, new = orig(params, cache, tokens, pos, cfg, **kw)
        for k, v in cache["scan"]["pos0"].items():
            v.copy_(new["scan"]["pos0"][k])
            if past_altered:
                v[:, :, 0] += 1.0
        return logits, cache
    return step


@pytest.mark.parametrize("past_altered", [False, True])
def test_in_place_cache_is_judged_by_what_it_holds(tmp_path, capsys,
                                                  monkeypatch, past_altered):
    """A decode program that writes into the cache it is handed, over a
    window of several segments (the tiny cell's 8 slots a segment), reads
    correct, and reads incorrect once it also alters a drawn slot."""
    from repro_torch import models
    root = tiny.make_root(tmp_path)
    monkeypatch.setattr(models, "decode_step", in_place_decode(
        models.decode_step, past_altered))
    assert _correct(root, "tiny-glm-decode", capsys) is (not past_altered)
