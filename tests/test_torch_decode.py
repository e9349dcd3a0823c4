"""The port's decode and training forward against the JAX reference, on the
CPU: ``attn_decode`` (full and ring), ``cross_attn_decode``,
``rglru_decode``, ``rwkv_decode``, full attention with a query offset,
``cross_entropy``, and for all ten smoke configs ``forward_train``,
``loss_fn``, ``prefill`` and ``decode_step`` (the prefill and decode also
at granite-34b's, chameleon-34b's and h2o-danube-3-4b's head geometries
at smoke width, ``test_torch_models.HEADS``).

The reference's ``init_params`` draws the weights and
``repro_torch.convert.lm_params`` carries them into the port; tokens,
frame embeddings, caches and states are seeded numpy draws handed to
both. Everything is float32. The model-level checks hold the reference's
own contract (``tests/test_decode_consistency.py``): prefill plus
``decode_step`` continues ``forward_train`` within 1e-4, on the port as
on the reference, and the port's logits and every cache leaf lie within
1e-4 of the reference's after the prefill and after each of 4 steps. A
fifth step at ``pos == cache_len`` meets the reference's clamp: the
reference's ``dynamic_update_slice`` writes a full cache's last slot. The
function-level checks hold 1e-5 (sums of products in another order).

The reference runs under ``jax.jit`` (the config static), which compiles
each decode step once instead of each call; its outputs are shared
through a module-scoped fixture.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward_train as j_forward_train  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models import rwkv as JW  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.models import (decode_step, forward_train,  # noqa: E402
                                loss_fn, prefill)
from repro_torch.models import attention as MA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import recurrent as MR  # noqa: E402
from repro_torch.models import rwkv as MW  # noqa: E402

from test_torch_attn import _attn_params  # noqa: E402
from test_torch_models import (SLICE17_HEADS, _flat, _np,  # noqa: E402
                               _port_cfg, heads_config)

ALL = list(TC.ARCHS)
B, T, EXTRA, ENC_LEN = 2, 24, 4, 16
CACHE_LEN = T + EXTRA
TOL = 1e-4          # the reference's own decode-consistency tolerance
FN_TOL = 1e-5       # one function, float32

_J_FORWARD = jax.jit(j_forward_train, static_argnums=2)
_J_LOSS = jax.jit(j_loss_fn, static_argnums=2)
_J_PREFILL = jax.jit(j_prefill, static_argnums=(2, 3))
_J_DECODE = jax.jit(j_decode_step, static_argnums=4)


@pytest.fixture
def rng():
    """A generator seeded in each test: ``tests/conftest.py``'s ``rng`` is
    shared by the session, so its draws would depend on which tests ran
    before in the same worker."""
    return np.random.default_rng(0)


def _apart(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def _tree_apart(got: dict, want: dict) -> float:
    assert list(got) == list(want)
    return max(_apart(got[p], want[p]) for p in want)


def _run(name):
    """The reference's and the port's forward_train, loss, prefill (T
    tokens, ``cache_len`` T + EXTRA) and EXTRA + 1 decode steps of smoke
    config ``name`` on the same weights and seeded inputs: steps 0..EXTRA-1
    take the next tokens at positions T..T+EXTRA-1, the last one sits at
    ``pos == cache_len``. ``name`` may name a head geometry of
    ``test_torch_models.HEADS`` at smoke width."""
    jcfg = heads_config(name)
    cfg = _port_cfg(jcfg)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    params = lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T + EXTRA), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    full = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        full["enc_input"] = np.random.default_rng(2).standard_normal(
            (B, ENC_LEN, cfg.d_model)).astype(np.float32)
    pre = {k: (v[:, :T] if k == "tokens" else v) for k, v in full.items()
           if k != "labels"}
    step_tokens = [toks[:, T + j] for j in range(EXTRA)] + [toks[:, 0]]

    jb = {k: jnp.asarray(v) for k, v in full.items()}
    ref = types.SimpleNamespace(
        full=np.asarray(_J_FORWARD(jparams, jb, jcfg)),
        loss=float(_J_LOSS(jparams, jb, jcfg)[0]), steps=[])
    lg, cache = _J_PREFILL(jparams, {k: jnp.asarray(v) for k, v in
                                     pre.items()}, jcfg, CACHE_LEN)
    ref.prefill = (np.asarray(lg), _flat(cache))
    for j, tok in enumerate(step_tokens):
        lg, cache = _J_DECODE(jparams, cache, jnp.asarray(tok), T + j, jcfg)
        ref.steps.append((np.asarray(lg), _flat(cache)))

    tb = {k: torch.from_numpy(v) for k, v in full.items()}
    port = types.SimpleNamespace(
        full=forward_train(params, tb, cfg).numpy(),
        loss=loss_fn(params, tb, cfg)[0], steps=[])
    lg, cache = prefill(params, {k: torch.from_numpy(v) for k, v in
                                 pre.items()}, cfg, CACHE_LEN)
    port.cache0 = cache
    port.prefill = (lg.numpy(), _flat(cache))
    for j, tok in enumerate(step_tokens):
        lg, cache = decode_step(params, cache, torch.from_numpy(tok), T + j,
                                cfg)
        port.steps.append((lg.numpy(), _flat(cache)))
    return types.SimpleNamespace(cfg=cfg, params=params, ref=ref, port=port,
                                 step_tokens=step_tokens)


@pytest.fixture(scope="module")
def runs():
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = _run(name)
        return memo[name]
    return get


# --- the model -------------------------------------------------------------

@pytest.mark.parametrize("name", ALL + SLICE17_HEADS)
def test_prefill_and_decode_match_reference(name, runs):
    r = runs(name)
    assert _apart(r.port.prefill[0], r.ref.prefill[0]) < TOL
    assert _tree_apart(r.port.prefill[1], r.ref.prefill[1]) < TOL
    for j in range(EXTRA):
        (tl, tc), (jl, jc) = r.port.steps[j], r.ref.steps[j]
        assert tl.shape == (B, r.cfg.vocab_size)
        assert _apart(tl, jl) < TOL, (name, j)
        assert _tree_apart(tc, jc) < TOL, (name, j)


@pytest.mark.parametrize("name", ALL)
def test_decode_continues_forward_train(name, runs):
    """The reference's contract on the port alone: its prefill's last
    logits and each decode step's are ``forward_train``'s at the same
    positions."""
    r = runs(name)
    assert _apart(r.port.prefill[0], r.port.full[:, T - 1]) < TOL
    for j in range(EXTRA):
        assert _apart(r.port.steps[j][0], r.port.full[:, T + j]) < TOL, \
            (name, j)


@pytest.mark.parametrize("name", ALL)
def test_forward_train_and_loss_match_reference(name, runs):
    """Logits at every position, and the token CE with ``ignore_id``
    labels masked out (the last column and three of the first row)."""
    r = runs(name)
    assert r.port.full.shape == (B, T + EXTRA, r.cfg.vocab_size)
    assert _apart(r.port.full, r.ref.full) < TOL
    assert r.port.loss.dtype == torch.float32 and r.port.loss.dim() == 0
    assert abs(r.port.loss.item() - r.ref.loss) < TOL


@pytest.mark.parametrize("name", ALL)
def test_decode_at_cache_len_matches_reference(name, runs):
    """A step at ``pos == cache_len``: a full attention cache's new K/V go
    to its last slot (the reference's clamped update) and every slot
    scores; a ring writes slot ``pos % window``; states just step."""
    r = runs(name)
    (tl, tc), (jl, jc) = r.port.steps[EXTRA], r.ref.steps[EXTRA]
    assert _apart(tl, jl) < TOL
    assert _tree_apart(tc, jc) < TOL
    kinds = r.cfg.block_pattern
    if "attn" in kinds:
        i = kinds.index("attn")
        k = tc[f"/scan/pos{i}/k"]
        assert k.shape[2] == CACHE_LEN
        # the last slot was overwritten: it no longer holds the step before
        assert not torch.equal(k[:, :, -1], r.port.steps[EXTRA - 1][1]
                               [f"/scan/pos{i}/k"][:, :, -1])


@pytest.mark.parametrize("name", ["chatglm3-6b", "gemma3-12b",
                                  "recurrentgemma-9b", "rwkv6-1.6b",
                                  "whisper-tiny", "qwen3-moe-235b-a22b"])
def test_decode_leaves_the_input_cache_unchanged(name, runs):
    """The reference's cache is functional; so is the port's: a step
    returns a new cache and the one passed in stays bit for bit."""
    r = runs(name)
    cache = r.port.cache0
    before = {p: t.clone() for p, t in _flat(cache).items()}
    lg, new = decode_step(r.params, cache, torch.from_numpy(
        r.step_tokens[0]), T, r.cfg)
    after = _flat(cache)
    assert all(torch.equal(after[p], before[p]) for p in before)
    assert np.array_equal(lg.numpy(), r.port.steps[0][0])
    assert _tree_apart(_flat(new), r.port.steps[0][1]) == 0.0


def test_ring_cache_window_positions():
    """The reference's ring test: h2o-danube-3-4b's smoke window is 16, the
    prompt 40 tokens, so the ring has wrapped twice; 3 steps continue
    ``forward_train``, the port's and the reference's."""
    jcfg = j_get_smoke("h2o-danube-3-4b")
    cfg = _port_cfg(jcfg)
    assert cfg.window == 16
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    params = lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 43),
                                             dtype=np.int32)
    want = np.asarray(_J_FORWARD(jparams, {"tokens": jnp.asarray(toks)},
                                 jcfg))
    full = forward_train(params, {"tokens": torch.from_numpy(toks)},
                         cfg).numpy()
    assert _apart(full, want) < TOL
    lg, cache = prefill(params, {"tokens": torch.from_numpy(toks[:, :40])},
                        cfg, cache_len=43)
    assert cache["scan"]["pos0"]["k"].shape[2] == 16
    for step in range(3):
        lg, cache = decode_step(params, cache,
                                torch.from_numpy(toks[:, 40 + step]),
                                40 + step, cfg)
        assert _apart(lg, full[:, 40 + step]) < TOL
        assert _apart(lg, want[:, 40 + step]) < TOL


# --- the functions -----------------------------------------------------------

def _pair(rng, shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("name,kind,length,pos", [
    ("chatglm3-6b", "attn", 12, 5),            # 2d-RoPE, half the dims
    ("chatglm3-6b", "attn", 12, 11),           # the last slot
    ("qwen3-moe-235b-a22b", "attn", 12, 7),    # qk-norm
    ("h2o-danube-3-4b", "local", 16, 9),       # ring not yet full
    ("h2o-danube-3-4b", "local", 16, 40),      # ring wrapped twice
    ("gemma3-12b", "local", 16, 16)])          # first slot overwritten
def test_attn_decode_matches_reference(name, kind, length, pos, rng):
    jcfg, cfg, jp, tp = _attn_params(name)
    x_j, x_t = _pair(rng, (2, 1, cfg.d_model))
    shp = (2, length, cfg.n_kv_heads, cfg.d_head)
    (kj, kt), (vj, vt) = _pair(rng, shp), _pair(rng, shp)
    keep = kt.clone(), vt.clone()
    y, cache = MA.attn_decode(tp, x_t, {"k": kt, "v": vt}, pos, cfg, kind)
    jy, jcache = JA.attn_decode(jp, x_j, {"k": kj, "v": vj}, pos, jcfg, kind)
    assert _apart(y, jy) < FN_TOL
    assert _apart(cache["k"], jcache["k"]) < FN_TOL
    assert _apart(cache["v"], jcache["v"]) < FN_TOL
    assert torch.equal(kt, keep[0]) and torch.equal(vt, keep[1])


@pytest.mark.parametrize("te", [50, 23])
def test_cross_attn_decode_matches_reference(te, rng):
    jcfg, cfg, jp, tp = _attn_params("whisper-tiny", cross=True)
    x_j, x_t = _pair(rng, (2, 1, cfg.d_model))
    shp = (2, te, cfg.n_kv_heads, cfg.d_head)
    (kj, kt), (vj, vt) = _pair(rng, shp), _pair(rng, shp)
    y = MA.cross_attn_decode(tp, x_t, {"k": kt, "v": vt}, cfg)
    jy = JA.cross_attn_decode(jp, x_j, {"k": kj, "v": vj}, jcfg)
    assert tuple(y.shape) == (2, 1, cfg.d_model)
    assert _apart(y, jy) < FN_TOL


def _noisy(tree, rng, scale=0.3):
    """The reference's initial tree with seeded noise on every leaf (its
    gates and biases start at zero), as (jax tree, port tree)."""
    if isinstance(tree, dict):
        pairs = {k: _noisy(v, rng, scale) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    a = (np.asarray(tree, np.float32)
         + scale * rng.standard_normal(tree.shape)).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrent_decode_matches_reference(name, rng):
    """``rglru_decode`` (the width-4 conv over the carried inputs, the
    float32 h) and ``rwkv_decode`` (the time mix at T = 1: the stored
    shift, one WKV chunk of length 1) on random states."""
    jcfg = j_get_smoke(name)
    cfg = _port_cfg(jcfg)
    x_j, x_t = _pair(rng, (2, 1, cfg.d_model))
    if name == "recurrentgemma-9b":
        jp, tp = _noisy(JR.rglru_init(jax.random.PRNGKey(4), jcfg), rng)
        dr = cfg.d_rnn
        state = {"h": _pair(rng, (2, dr)),
                 "conv": _pair(rng, (2, cfg.conv_width - 1, dr))}
        j_fn, t_fn = JR.rglru_decode, MR.rglru_decode
    else:
        jp, tp = _noisy(JW.rwkv_init(jax.random.PRNGKey(4), jcfg), rng)
        h, n = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        state = {"s": _pair(rng, (2, h, n, n)),
                 "x_att": _pair(rng, (2, cfg.d_model))}
        j_fn, t_fn = JW.rwkv_decode, MW.rwkv_decode
    y, st = t_fn(tp, x_t, {k: v[1] for k, v in state.items()}, cfg)
    jy, jst = j_fn(jp, x_j, {k: v[0] for k, v in state.items()}, jcfg)
    assert tuple(y.shape) == (2, 1, cfg.d_model)
    assert _apart(y, jy) < FN_TOL
    assert sorted(st) == sorted(jst)
    for k in st:
        assert st[k].dtype == torch.float32
        assert _apart(st[k], jst[k]) < FN_TOL, k


@pytest.mark.parametrize("tq,tk,chunk_q,chunk_k", [
    (1, 8, 16, 16), (5, 12, 4, 4), (20, 40, 8, 16), (37, 40, 16, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_with_offset_matches_reference(tq, tk, chunk_q,
                                                       chunk_k, causal, rng):
    """Full attention at ``q_offset=3``: the reference's chunked streaming
    softmax, not K4 (which has no offset and is never called)."""
    qj, qt = _pair(rng, (2, tq, 4, 16))
    kj, kt = _pair(rng, (2, tk, 2, 16))
    vj, vt = _pair(rng, (2, tk, 2, 16))
    got = MA.flash_attention(qt, kt, vt, causal=causal, window=None,
                             chunk_q=chunk_q, chunk_k=chunk_k, q_offset=3)
    want = JA.flash_attention(qj, kj, vj, causal=causal, window=None,
                              chunk_q=chunk_q, chunk_k=chunk_k, q_offset=3)
    assert _apart(got, want) < FN_TOL


def test_cross_entropy_matches_reference(rng):
    """Token CE in float32 over the labels that are not ``ignore_id``; all
    ignored gives 0 (the mean's denominator is at least 1)."""
    lj, lt = _pair(rng, (3, 7, 50), 3.0)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:] = -100
    for lab in (labels, np.full_like(labels, -100)):
        got = TL.cross_entropy(lt, torch.from_numpy(lab))
        want = JL.cross_entropy(lj, jnp.asarray(lab))
        assert got.dtype == torch.float32
        assert abs(got.item() - float(want)) < FN_TOL
    bf = TL.cross_entropy(lt.bfloat16(), torch.from_numpy(labels))
    assert bf.dtype == torch.float32
