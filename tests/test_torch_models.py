"""The port's model stack against the JAX reference, on the CPU: all ten
configs' prefill (dense and MoE FFNs, "attn", "local", "rec" and "rwkv"
blocks, the whisper encoder-decoder with its cross caches), and each
kind's block decode and training forward (``tests/test_torch_decode.py``
holds the decode and training forward of whole models).

The reference's ``init_params`` draws the weights; ``repro_torch.convert.
lm_params`` carries them into the port, and both ``prefill``s run the same
seeded tokens (whisper also the same seeded (2, 50, d) frame embeddings).
T = 37 with ``cache_len=40`` exceeds the smoke window of 16, so the
sliding-window kinds fill and rotate their ring caches, and is not a
multiple of the recurrent chunk (8), so the scans pad their tails.
Everything is float32: logits within 2e-5 and cache tensors within 5e-5
absolute plus 1e-5 relative (sums of products in another order through
each layer's projections, the cache being unnormalised projections of
width up to 8192 and float32 recurrent states).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.configs import long_context_ok as j_long_ok  # noqa: E402
from repro.configs.base import reduce_for_smoke as j_reduce  # noqa: E402
from repro.models import cache_specs as j_cache_specs  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.models import (ModelConfig, cache_specs,  # noqa: E402
                                init_cache, init_params, prefill)
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

DENSE = ["chatglm3-6b", "h2o-danube-3-4b", "gemma3-12b", "chameleon-34b",
         "granite-34b"]
ALL = list(TC.ARCHS)
# head geometries of eight configs at smoke width: (config, reductions) —
# granite-34b's 48 query heads on one KV head, chameleon-34b's qk-normed
# 64 on 8, h2o-danube-3-4b's Dh 120 with its own window of 4096 (longer
# than the tests' prompts, as at T = 2048 on the card)
HEADS = {
    "chatglm3-heads": ("chatglm3-6b", dict(n_heads=32, n_kv_heads=2,
                                           d_head=128)),
    "qwen3-heads": ("qwen3-moe-235b-a22b", dict(n_heads=64, n_kv_heads=4,
                                                d_head=128)),
    "whisper-heads": ("whisper-tiny", dict(n_heads=6, n_kv_heads=6,
                                           d_head=64)),
    "granite-heads": ("granite-34b", dict(n_heads=48, n_kv_heads=1,
                                          d_head=128)),
    "chameleon-heads": ("chameleon-34b", dict(n_heads=64, n_kv_heads=8,
                                              d_head=128)),
    "danube-heads": ("h2o-danube-3-4b", dict(n_heads=32, n_kv_heads=8,
                                             d_head=120, window=4096)),
    # qwen3-moe-235b-a22b's qk-normed 64 on 4 with its 128 experts, top-8,
    # on the dense form; recurrentgemma-9b's local layers' MQA 16 on 1 at
    # Dh 256 under its window of 2048; rwkv6-1.6b's WKV heads of 64 (two
    # of them at d_model 128)
    "qwen3-experts": ("qwen3-moe-235b-a22b", dict(
        n_heads=64, n_kv_heads=4, d_head=128, n_experts=128, top_k=8,
        d_expert=16, moe_impl="dense")),
    "recurrentgemma-heads": ("recurrentgemma-9b", dict(
        n_heads=16, n_kv_heads=1, d_head=256, window=2048)),
    "rwkv6-heads": ("rwkv6-1.6b", dict(rwkv_head_dim=64, d_model=128)),
}

# the head geometries of the configs that run on the card since slice 17,
# also held in the gradient and decode tests
SLICE17_HEADS = ["granite-heads", "chameleon-heads", "danube-heads"]
# ... and of the configs whose training runs on the card since slice 18,
# held in the gradient tests
SLICE18_HEADS = ["qwen3-experts", "recurrentgemma-heads", "rwkv6-heads"]


def heads_config(name):
    """The reference's config for ``name``: a ``HEADS`` entry (a config's
    head geometry at smoke width) or a smoke config."""
    if name in HEADS:
        arch, heads = HEADS[name]
        return j_reduce(j_get_config(arch), **heads)
    return j_get_smoke(name)


ENC_LEN = 50


@pytest.fixture
def rng():
    """A generator seeded in each test: ``tests/conftest.py``'s ``rng`` is
    shared by the session, so its draws would depend on which tests ran
    before in the same worker."""
    return np.random.default_rng(0)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _flat(tree, prefix=""):
    """{path: leaf} with dict keys in sorted order, as JAX flattens."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_configs_are_copies_of_the_reference():
    from repro.configs import ARCHS as J_ARCHS
    assert list(TC.ARCHS) == list(J_ARCHS)
    for name in J_ARCHS:
        assert dataclasses.asdict(TC.get_config(name)) \
            == dataclasses.asdict(j_get_config(name))
        assert dataclasses.asdict(TC.get_smoke_config(name)) \
            == dataclasses.asdict(j_get_smoke(name))
        assert TC.long_context_ok(name) == j_long_ok(name)
        assert TC.get_config(name).param_count() \
            == j_get_config(name).param_count()


def _batches(cfg, t=37):
    """The same seeded tokens (and, for an encoder-decoder, (2, ENC_LEN, d)
    frame embeddings) for the reference and the port."""
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, t),
                                             dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.is_encdec:
        e = np.random.default_rng(2).standard_normal(
            (2, ENC_LEN, cfg.d_model)).astype(np.float32)
        jb["enc_input"], tb["enc_input"] = jnp.asarray(e), torch.from_numpy(e)
    return jb, tb


@pytest.mark.parametrize("name", ALL + list(HEADS))
def test_prefill_matches_reference(name):
    jcfg = heads_config(name)
    cfg = _port_cfg(jcfg)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    params = lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    jb, tb = _batches(cfg)
    jl, jc = j_prefill(jparams, jb, jcfg, cache_len=40)
    tl, tc = prefill(params, tb, cfg, cache_len=40)
    assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32
    assert np.allclose(_np(tl), _np(jl), atol=2e-5, rtol=0)
    jflat, tflat = _flat(jc), _flat(tc)
    assert list(jflat) == list(tflat)
    for path in jflat:
        assert tflat[path].shape == jflat[path].shape, path
        assert np.allclose(_np(tflat[path]), _np(jflat[path]), atol=5e-5,
                           rtol=1e-5), path


def _dtype_name(dt):
    return str(dt).removeprefix("torch.")


@pytest.mark.parametrize("name", ALL)
def test_param_and_cache_trees_match_reference(name):
    """Keys, shapes and types of the parameter and cache trees (the MoE
    router float32, recurrent states float32, whisper's cross caches of
    ``enc_len`` positions)."""
    jcfg = j_get_smoke(name)
    cfg = _port_cfg(jcfg)
    jp = _flat(jax.eval_shape(lambda k: j_init(k, jcfg),
                              jax.random.PRNGKey(0)))
    tp = _flat(init_params(torch.Generator().manual_seed(0), cfg))
    assert list(jp) == list(tp)
    for path, spec in jp.items():
        assert tuple(tp[path].shape) == spec.shape, path
        assert _dtype_name(tp[path].dtype) == str(spec.dtype), path
    enc_len = 7 if cfg.is_encdec else 0
    jcs = _flat(j_cache_specs(jcfg, 3, 24, enc_len=enc_len))
    tcs = _flat(cache_specs(cfg, 3, 24, enc_len=enc_len))
    assert {p: (s.shape, str(s.dtype)) for p, s in jcs.items()} \
        == {p: (s.shape, _dtype_name(s.dtype)) for p, s in tcs.items()}
    assert any("cross" in p for p in tcs) == cfg.is_encdec
    zeros = _flat(init_cache(cfg, 3, 24, enc_len=enc_len, device="cpu"))
    assert all(not z.any() and tuple(z.shape) == tcs[p].shape
               and z.dtype == tcs[p].dtype for p, z in zeros.items())


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-9b", "rwkv6-1.6b",
                                  "whisper-tiny"])
def test_lm_params_carries_a_bf16_tree_as_it_is(name):
    """``lm_params`` maps the reference's tree generically: every new leaf
    arrives with its key, shape and type (the MoE router float32 in a
    bf16 model), bit for bit."""
    jcfg = dataclasses.replace(j_get_smoke(name), param_dtype="bfloat16")
    cfg = _port_cfg(jcfg)
    jflat = _flat(jax.tree.map(np.asarray,
                               j_init(jax.random.PRNGKey(0), jcfg)))
    tflat = _flat(lm_params(jax.tree.map(np.asarray,
                                         j_init(jax.random.PRNGKey(0), jcfg)),
                            cfg, "cpu"))
    assert list(jflat) == list(tflat)
    for path, a in jflat.items():
        t = tflat[path]
        assert _dtype_name(t.dtype) == str(a.dtype), path
        assert np.array_equal(t.float().numpy(), a.astype(np.float32)), path
    routers = [p for p in tflat if p.endswith("/router")]
    assert bool(routers) == cfg.is_moe
    assert all(tflat[p].dtype == torch.float32 for p in routers)


def test_full_width_params_keep_the_configured_type():
    cfg = TCB.reduce_for_smoke(TC.get_config("chatglm3-6b"),
                              param_dtype="bfloat16")
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in _flat(params).values())
    toks = torch.zeros(1, 5, dtype=torch.int32)
    logits, cache = prefill(params, {"tokens": toks}, cfg, cache_len=8)
    assert logits.dtype == torch.bfloat16 and torch.isfinite(
        logits.float()).all()


def test_dense_init_is_a_truncated_normal():
    g = torch.Generator().manual_seed(0)
    w = TL.dense_init(g, (256, 512))
    x = w.numpy() * np.sqrt(256)
    assert np.abs(x).max() <= 2.0 + 1e-6
    # a standard normal cut at ±2 has standard deviation 0.8796
    assert abs(x.std() - 0.8796) < 0.01 and abs(x.mean()) < 0.01
    assert TL.dense_init(g, (4, 8), dtype=torch.bfloat16).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("fraction,dh", [(1.0, 16), (0.5, 16), (0.5, 12)])
def test_rotary_matches_reference(fraction, dh, rng):
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    pos = np.arange(7)[None, :]
    jc, js = JL.rotary_cos_sin(jnp.asarray(pos), int(dh * fraction), 1e4)
    tc, ts = TL.rotary_cos_sin(torch.from_numpy(pos), int(dh * fraction), 1e4)
    assert np.allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    want = JL.apply_rotary(jnp.asarray(x), jc, js, fraction)
    got = TL.apply_rotary(torch.from_numpy(x), tc, ts, fraction)
    assert np.allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_and_norm_match_reference(kind, rng):
    """``jax.nn.gelu`` is the tanh approximation by default; so is the
    port's."""
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = {n: rng.standard_normal(s).astype(np.float32) * 0.3
         for n, s in (("w_gate", (16, 32)), ("w_up", (16, 32)),
                      ("w_down", (32, 16)))}
    if kind == "gelu":
        w.pop("w_gate")
    want = JL.mlp_apply({n: jnp.asarray(a) for n, a in w.items()},
                        jnp.asarray(x), kind)
    got = TL.mlp_apply({n: torch.from_numpy(a) for n, a in w.items()},
                       torch.from_numpy(x), kind)
    assert np.allclose(got.numpy(), np.asarray(want), atol=1e-5)
    scale = rng.standard_normal(16).astype(np.float32)
    assert np.allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6)
    assert np.allclose(TL.softcap(torch.from_numpy(x), 2.0).numpy(),
                       np.asarray(JL.softcap(jnp.asarray(x), 2.0)), atol=1e-6)


@pytest.mark.parametrize("kind", ["attn", "local", "rec", "rwkv"])
def test_decode_and_train_still_name_the_roadmap(kind, rng):
    """Each kind's one-token ``block_decode`` and training forward
    ``block_train`` against the reference's, on the reference's block
    weights, a seeded input and a seeded cache or state: outputs and new
    caches within 2e-5 plus 1e-5 relative (the MoE's expert weights take a
    fan-in of 4, so mixtral's block outputs reach tens). The "local" kind
    is mixtral's (an MoE FFN, the dense form at T = 1) with its ring
    wrapped; an unknown kind still raises. The name is kept from before
    decode and the recurrent kinds' training forward were ported, when
    both raised naming ROADMAP.md's queue 1 and this test held that they
    did."""
    from repro.models import blocks as JB
    name = {"attn": "chatglm3-6b", "local": "mixtral-8x7b",
            "rec": "recurrentgemma-9b", "rwkv": "rwkv6-1.6b"}[kind]
    jcfg = j_get_smoke(name)
    cfg = _port_cfg(jcfg)
    jp = JB.block_init(jax.random.PRNGKey(5), jcfg, kind, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    spec = TB.block_cache_spec(cfg, kind, 2, 12, torch.float32)
    cache = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in spec.items()}
    pos = 29 if kind == "local" else 7
    y, new = TB.block_decode(tp, torch.from_numpy(x[:, :1]),
                             {k: torch.from_numpy(a) for k, a in
                              cache.items()}, pos, cfg, kind)
    jy, jnew = JB.block_decode(jp, jnp.asarray(x[:, :1]),
                               {k: jnp.asarray(a) for k, a in cache.items()},
                               pos, jcfg, kind)
    assert np.allclose(_np(y), _np(jy), atol=2e-5, rtol=1e-5)
    assert sorted(new) == sorted(jnew)
    for k in new:
        assert np.allclose(_np(new[k]), _np(jnew[k]), atol=2e-5,
                           rtol=1e-5), k
    got = TB.block_train(tp, torch.from_numpy(x), cfg, kind)
    want = JB.block_train(jp, jnp.asarray(x), jcfg, kind)
    assert got.shape == x.shape
    assert np.allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        TB.block_init(torch.Generator(), cfg, "global", torch.float32)


def test_encoder_decoder_prefill_needs_its_frames():
    cfg = TC.get_smoke_config("whisper-tiny")
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.zeros(1, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_input"):
        prefill(params, {"tokens": toks}, cfg, cache_len=8)
    frames = torch.zeros(1, 9, cfg.d_model)
    logits, cache = prefill(params, {"tokens": toks, "enc_input": frames},
                            cfg, cache_len=8)
    assert logits.shape == (1, cfg.vocab_size)
    assert cache["scan"]["pos0"]["cross"]["k"].shape \
        == (cfg.n_repeats, 1, 9, cfg.n_kv_heads, cfg.d_head)
