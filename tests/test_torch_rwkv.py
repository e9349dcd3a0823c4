"""The port's RWKV-6 block (``repro_torch.models.rwkv``) against the JAX
reference (``repro.models.rwkv``), function by function, on the CPU in
float32, and the chunked WKV against the plain recurrence.

Inputs are numpy draws from a seeded generator, handed to both packages.
Tolerances: the group norm within 1e-5 (normalised values of order 1);
the chunked WKV within 2e-5 of the reference's (the same chunked algebra,
float32 sums of up to C·N products in another order) and within 5e-5 of
a float64 step-by-step recurrence (the chunked form's exp-of-differences
against products of decays); the mixes within 2e-5 (outputs of order 1
through d-wide projections).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import rwkv as JW  # noqa: E402

from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models import rwkv as TW  # noqa: E402


def _cfg(**kw):
    jcfg = dataclasses.replace(j_get_smoke("rwkv6-1.6b"), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=atol, rtol=0), \
        float(np.abs(got - want).max())


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _params(rng, cfg):
    """RWKV parameters with random mixes, decay and bonus (the init's are
    constants)."""
    d, n, f = cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff
    h = d // n
    s = d ** -0.5
    time = {f"mu_{c}": rng.uniform(0, 1, d).astype(np.float32)
            for c in "rkvgw"}
    time.update({f"w_{c}": _f32(rng, d, d, scale=s) for c in "rkvgo"})
    time.update(w0=rng.uniform(-7, -1, d).astype(np.float32),
                w_lora_a=_f32(rng, d, 64, scale=s),
                w_lora_b=_f32(rng, 64, d, scale=0.1),
                u=_f32(rng, h, n, scale=0.5),
                ln_x=rng.uniform(0.5, 1.5, d).astype(np.float32))
    channel = {"mu_k": rng.uniform(0, 1, d).astype(np.float32),
               "mu_r": rng.uniform(0, 1, d).astype(np.float32),
               "w_k": _f32(rng, d, f, scale=s),
               "w_v": _f32(rng, f, d, scale=f ** -0.5),
               "w_r": _f32(rng, d, d, scale=s)}
    p = {"time": time, "channel": channel}
    return _to(p, jnp.asarray), _to(p, torch.from_numpy)


def test_group_norm_matches_reference(rng):
    """The population variance (``jnp.var``; ``torch.var`` needs
    ``correction=0``)."""
    x = _f32(rng, 2, 5, 64, scale=3.0) + 1.0
    scale = _f32(rng, 64)
    want = JW._group_norm(jnp.asarray(x), jnp.asarray(scale), 16)
    got = TW._group_norm(torch.from_numpy(x), torch.from_numpy(scale), 16)
    _close(got, want, 1e-5)


def _wkv_inputs(rng, b, t, h, n):
    r, k, v = (_f32(rng, b, t, h, n) for _ in range(3))
    logw = -np.exp(rng.uniform(-4, 1, (b, t, h, n))).astype(np.float32)
    u = _f32(rng, h, n, scale=0.5)
    s0 = _f32(rng, b, h, n, n, scale=0.5)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("t,chunk", [(37, 8), (32, 8), (5, 8), (1, 8),
                                     (20, 32)])
def test_wkv_chunked_matches_reference(t, chunk, rng):
    """A padded tail (T not a multiple of the chunk) and s0 != 0."""
    args = _wkv_inputs(rng, 2, t, 3, 8)
    jo, js = JW._wkv_chunked(*(jnp.asarray(a) for a in args), chunk)
    to, ts = TW._wkv_chunked(*(torch.from_numpy(a) for a in args), chunk)
    assert to.dtype == ts.dtype == torch.float32
    _close(to, jo, 2e-5)
    _close(ts, js, 2e-5)


@pytest.mark.parametrize("t,chunk", [(37, 8), (16, 16)])
def test_wkv_chunked_is_the_recurrence(t, chunk, rng):
    """S_t = diag(w_t) S_{t-1} + k_t v_tᵀ, read as o_t = r_t·(S_{t-1} +
    diag(u) k_t v_tᵀ), step by step in float64."""
    r, k, v, logw, u, s0 = _wkv_inputs(rng, 2, t, 3, 8)
    to, ts = TW._wkv_chunked(*(torch.from_numpy(a) for a in
                               (r, k, v, logw, u, s0)), chunk)
    s = s0.astype(np.float64)
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]        # (B,H,N,N)
        outs.append(np.einsum("bhn,bhnm->bhm", r[:, i],
                              s + u[None, :, :, None] * kv))
        s = np.exp(logw[:, i])[..., None] * s + kv
    assert np.allclose(to.numpy(), np.stack(outs, 1), atol=5e-5)
    assert np.allclose(ts.numpy(), s, atol=5e-5)


@pytest.mark.parametrize("t", [37, 1])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_matches_reference(t, with_state, rng):
    """With T = 1 the token shift reads the stored previous activation."""
    jcfg, cfg = _cfg()
    jp, tp = _params(rng, cfg)
    d, n = cfg.d_model, cfg.rwkv_head_dim
    x = _f32(rng, 2, t, d)
    state = None
    if with_state:
        state = {"s": _f32(rng, 2, d // n, n, n, scale=0.5),
                 "x_att": _f32(rng, 2, d)}
    jy, js = JW.rwkv_time_mix(jp, jnp.asarray(x), jcfg,
                              None if state is None
                              else _to(state, jnp.asarray))
    ty, ts = TW.rwkv_time_mix(tp, torch.from_numpy(x), cfg,
                              None if state is None
                              else _to(state, torch.from_numpy))
    _close(ty, jy, 2e-5)
    assert ts["s"].dtype == torch.float32
    for key in ("s", "x_att"):
        _close(ts[key], js[key], 2e-5)


@pytest.mark.parametrize("t", [37, 1])
@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(t, with_state, rng):
    jcfg, cfg = _cfg()
    jp, tp = _params(rng, cfg)
    x = _f32(rng, 2, t, cfg.d_model)
    state = {"x_ffn": _f32(rng, 2, cfg.d_model)} if with_state else None
    jy, js = JW.rwkv_channel_mix(jp, jnp.asarray(x), jcfg,
                                 None if state is None
                                 else _to(state, jnp.asarray))
    ty, ts = TW.rwkv_channel_mix(tp, torch.from_numpy(x), cfg,
                                 None if state is None
                                 else _to(state, torch.from_numpy))
    _close(ty, jy, 2e-5)
    _close(ts["x_ffn"], js["x_ffn"], 0)


def test_time_mix_projections_match_reference(rng):
    jcfg, cfg = _cfg()
    jp, tp = _params(rng, cfg)
    x, prev = _f32(rng, 2, 9, cfg.d_model), _f32(rng, 2, cfg.d_model)
    want = JW._time_mix_proj(jp["time"], jnp.asarray(x), jnp.asarray(prev),
                             jcfg)
    got = TW._time_mix_proj(tp["time"], torch.from_numpy(x),
                            torch.from_numpy(prev), cfg)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    assert (got[3] <= 0).all()


def test_state_spec_and_init_match_reference():
    jcfg, cfg = _cfg(param_dtype="bfloat16")
    js = JW.rwkv_state_spec(jcfg, 3, jnp.bfloat16)
    ts = TW.rwkv_state_spec(cfg, 3, torch.bfloat16)
    assert {k: (s.shape, str(s.dtype)) for k, s in js.items()} \
        == {k: (s.shape, str(s.dtype).removeprefix("torch."))
            for k, s in ts.items()}
    p = TW.rwkv_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    jshapes = JW.rwkv_init(__import__("jax").random.PRNGKey(0), jcfg,
                           jnp.bfloat16)
    assert _to(jshapes, lambda a: a.shape) == _to(p, lambda a: tuple(a.shape))
