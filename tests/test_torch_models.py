"""The port's dense attention stack against the JAX reference, on the CPU.

The reference's ``init_params`` draws the weights; ``repro_torch.convert.
lm_params`` carries them into the port, and both ``prefill``s run the same
seeded tokens. T = 37 with ``cache_len=40`` exceeds the smoke window of 16,
so the sliding-window kinds fill and rotate their ring caches. Everything
is float32: logits within 2e-5 and cache tensors within 5e-5 absolute plus
1e-5 relative (sums of products in another order through each layer's
projections, the cache being unnormalised projections of width up to 4096).
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


@pytest.mark.parametrize("name", DENSE + ["chatglm3-heads"])
def test_prefill_matches_reference(name):
    if name == "chatglm3-heads":   # chatglm3's head geometry at smoke width
        jcfg = j_reduce(j_get_config("chatglm3-6b"), n_heads=32,
                        n_kv_heads=2, d_head=128)
    else:
        jcfg = j_get_smoke(name)
    cfg = _port_cfg(jcfg)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    params = lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 37),
                                             dtype=np.int32)
    jl, jc = j_prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                       cache_len=40)
    tl, tc = prefill(params, {"tokens": torch.from_numpy(toks)}, cfg,
                     cache_len=40)
    assert tl.shape == (2, cfg.vocab_size) and tl.dtype == torch.float32
    assert np.allclose(_np(tl), _np(jl), atol=2e-5, rtol=0)
    jflat, tflat = _flat(jc), _flat(tc)
    assert list(jflat) == list(tflat)
    for path in jflat:
        assert tflat[path].shape == jflat[path].shape, path
        assert np.allclose(_np(tflat[path]), _np(jflat[path]), atol=5e-5,
                           rtol=1e-5), path


@pytest.mark.parametrize("name", DENSE)
def test_param_and_cache_trees_match_reference(name):
    jcfg = j_get_smoke(name)
    cfg = _port_cfg(jcfg)
    jp = _flat(jax.eval_shape(lambda k: j_init(k, jcfg),
                              jax.random.PRNGKey(0)))
    tp = _flat(init_params(torch.Generator().manual_seed(0), cfg))
    assert list(jp) == list(tp)
    for path, spec in jp.items():
        assert tuple(tp[path].shape) == spec.shape, path
        assert tp[path].dtype == torch.float32
    jcs = _flat(j_cache_specs(jcfg, 3, 24))
    tcs = _flat(cache_specs(cfg, 3, 24))
    assert {p: s.shape for p, s in jcs.items()} \
        == {p: s.shape for p, s in tcs.items()}
    zeros = _flat(init_cache(cfg, 3, 24, device="cpu"))
    assert all(not z.any() and tuple(z.shape) == tcs[p].shape
               for p, z in zeros.items())


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


@pytest.mark.parametrize("name", ["mixtral-8x7b", "recurrentgemma-9b",
                                  "rwkv6-1.6b", "whisper-tiny"])
def test_unported_kinds_name_the_roadmap(name):
    cfg = TC.get_smoke_config(name)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cache_specs(cfg, 1, 8)
    if not cfg.is_encdec:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TB.block_init(torch.Generator(), cfg, cfg.block_pattern[0],
                          torch.float32)
