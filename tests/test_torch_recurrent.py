"""The port's RG-LRU block (``repro_torch.models.recurrent``) against the
JAX reference (``repro.models.recurrent``), function by function, on the
CPU in float32.

Inputs are numpy draws from a seeded generator, handed to both packages.
Tolerances: the conv within 1e-6 (the same float32 operations), the
coefficients against a float64 evaluation of the formula within a bound
that follows its conditioning (``_coeffs64``); the chunked scan within
1e-5 — the port repeats the odd/even recursion of
``jax.lax.associative_scan`` combine for combine, but XLA may
contract ``b1 * a2 + b2`` into one FMA, so the last bits differ, and the
states are sums of up to ~1/(1-a) terms of order 1; the whole block within
2e-5 (its output projection sums 64 products of those).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402

from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402


@pytest.fixture
def rng():
    """A generator seeded in each test: ``tests/conftest.py``'s ``rng`` is
    shared by the session, so its draws would depend on which tests ran
    before in the same worker."""
    return np.random.default_rng(0)


def _cfg(**kw):
    jcfg = dataclasses.replace(j_get_smoke("recurrentgemma-9b"), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=atol, rtol=0), \
        float(np.abs(got - want).max())


def _params(rng, cfg):
    """Random RG-LRU parameters, gates included (the init's are zero), Λ
    in its init range."""
    d, dr = cfg.d_model, cfg.d_rnn
    p = {"w_x": _f32(rng, d, dr, scale=d ** -0.5),
         "w_y": _f32(rng, d, dr, scale=d ** -0.5),
         "w_o": _f32(rng, dr, d, scale=dr ** -0.5),
         "conv_w": _f32(rng, cfg.conv_width, dr, scale=0.5),
         "conv_b": _f32(rng, dr, scale=0.1),
         "lam": rng.uniform(0.001, 0.1, dr).astype(np.float32)}
    for g in ("gate_r", "gate_i"):
        p[g + "_w"] = _f32(rng, dr)
        p[g + "_b"] = _f32(rng, dr, scale=0.5)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("carry", [False, True])
def test_conv_causal_matches_reference(carry, rng):
    u, w, b = _f32(rng, 2, 9, 16), _f32(rng, 4, 16), _f32(rng, 16)
    c = _f32(rng, 2, 3, 16) if carry else None
    want = JR._conv_causal(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
                           None if c is None else jnp.asarray(c))
    got = TR._conv_causal(torch.from_numpy(u), torch.from_numpy(w),
                          torch.from_numpy(b),
                          None if c is None else torch.from_numpy(c))
    for g, j in zip(got, want):
        _close(g, j, 1e-6)


def _coeffs64(p, u):
    """The reference's ``_rglru_coeffs`` in float64 on the same float32
    inputs → (a, b, and b's float32 error bound). Rounding in float32 is
    2^-24 relative an operation; two steps amplify it. The gap
    1 - exp(2·log_a) cancels when ``r`` is small: exp's rounding near 1 is
    a relative error of ~2^-24 / gap in the gap, half that after the
    square root, so |Δb| ≤ ~2^-24 |i·u| / sqrt(gap). The gates' sigmoids
    on their float32 arguments x: an argument's rounding (2^-24 |x|) is a
    relative error of up to that in a small sigmoid, so |Δb| ≤ ~2^-24
    (|x_i| + |x_r|) |b|. The bound is 4x the first and 2x the second."""
    p = {k: v.astype(np.float64) for k, v in p.items()}
    uf = u.astype(np.float64)
    x_r = uf * p["gate_r_w"] + p["gate_r_b"]
    x_i = uf * p["gate_i_w"] + p["gate_i_b"]
    r = 1.0 / (1.0 + np.exp(-x_r))
    i = 1.0 / (1.0 + np.exp(-x_i))
    log_a = -TR._C_RGLRU * np.log1p(np.exp(p["lam"])) * r
    gap = 1.0 - np.exp(2.0 * log_a)
    iu = np.abs(i * uf)
    bound = 2.0 ** -23 * iu * (2.0 / np.sqrt(gap)
                               + (np.abs(x_i) + np.abs(x_r)) * np.sqrt(gap))
    return np.exp(log_a), np.sqrt(np.maximum(gap, 1e-12)) * (i * uf), bound


@pytest.mark.parametrize("seed", range(50))
def test_rglru_coeffs_match_reference(seed):
    """Both packages' coefficients against a float64 evaluation of the
    reference formula, on inputs drawn in the test from its own seed.

    ``jax.nn.softplus`` is ``logaddexp(x, 0)`` with no threshold;
    ``F.softplus`` returns x itself above 20. Λ lies in (0.001, 0.1), where
    both are log1p(exp(x)), so the two agree. ``a`` within 1e-6. ``b =
    sqrt(1 - exp(2·log_a))·(i·u)`` cancels when ``r`` is small: float32's
    rounding of exp(2·log_a) near 1 (2^-24) is a relative error of
    2^-24 / gap in the gap, so ``b`` is held within a bound that follows
    that conditioning and the gates' (``_coeffs64``), not a flat one (a
    flat 1e-6 fails on some seeds)."""
    rng = np.random.default_rng(seed)
    jcfg, cfg = _cfg()
    jp, tp = _params(rng, cfg)
    u = _f32(rng, 2, 7, cfg.d_rnn, scale=2.0)
    ja, jb = JR._rglru_coeffs(jp, jnp.asarray(u))
    ta, tb = TR._rglru_coeffs(tp, torch.from_numpy(u))
    a64, b64, bound = _coeffs64({k: v.numpy() for k, v in tp.items()}, u)
    _close(ta, ja, 1e-6)
    for a, b in ((ta.numpy(), tb.numpy()), (np.asarray(ja), np.asarray(jb))):
        assert np.abs(a - a64).max() <= 1e-6
        assert (np.abs(b - b64) <= bound).all(), \
            float((np.abs(b - b64) / np.maximum(bound, 1e-30)).max())
    assert float(tp["lam"].max()) < 20.0


@pytest.mark.parametrize("t,chunk", [(37, 8), (32, 8), (5, 8), (1, 8),
                                     (19, 32), (23, 3)])
def test_linear_scan_chunked_matches_reference(t, chunk, rng):
    """T not a multiple of the chunk (padded with a = 1, b = 0), a nonzero
    h0, decays in (0.3, 1)."""
    a = rng.uniform(0.3, 1.0, (2, t, 12)).astype(np.float32)
    b = _f32(rng, 2, t, 12)
    h0 = _f32(rng, 2, 12)
    jh, jl = JR._linear_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(h0), chunk)
    th, tl = TR._linear_scan_chunked(torch.from_numpy(a),
                                     torch.from_numpy(b),
                                     torch.from_numpy(h0), chunk)
    _close(th, jh, 1e-5)
    _close(tl, jl, 1e-5)
    # and the recurrence itself, step by step in float64
    h, want = h0.astype(np.float64), []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    assert np.allclose(th.numpy(), np.stack(want, 1), atol=1e-5)
    assert np.allclose(tl.numpy(), h, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 32])
def test_assoc_scan_is_the_prefix_of_the_combine(n, rng):
    a = rng.uniform(0.5, 1.0, (3, n)).astype(np.float64)
    b = rng.standard_normal((3, n))
    pa, pb = TR._assoc_scan(torch.from_numpy(a), torch.from_numpy(b), 1)
    assert np.allclose(pa.numpy(), np.cumprod(a, 1))
    h, want = np.zeros(3), []
    for i in range(n):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    assert np.allclose(pb.numpy(), np.stack(want, 1))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [37, 1])
def test_rglru_train_matches_reference(t, with_state, rng):
    jcfg, cfg = _cfg()
    jp, tp = _params(rng, cfg)
    x = _f32(rng, 2, t, cfg.d_model)
    state = None
    if with_state:
        state = {"h": _f32(rng, 2, cfg.d_rnn),
                 "conv": _f32(rng, 2, cfg.conv_width - 1, cfg.d_rnn)}
    jy, js = JR.rglru_train(jp, jnp.asarray(x), jcfg, None if state is None
                            else {k: jnp.asarray(v) for k, v in state.items()})
    ty, ts = TR.rglru_train(tp, torch.from_numpy(x), cfg, None if state is None
                            else {k: torch.from_numpy(v)
                                  for k, v in state.items()})
    _close(ty, jy, 2e-5)
    assert ts["h"].dtype == torch.float32
    for k in ("h", "conv"):
        _close(ts[k], js[k], 1e-5)


def test_state_spec_and_init_match_reference():
    jcfg, cfg = _cfg(param_dtype="bfloat16")
    js = JR.rglru_state_spec(jcfg, 3, jnp.bfloat16)
    ts = TR.rglru_state_spec(cfg, 3, torch.bfloat16)
    assert {k: s.shape for k, s in js.items()} \
        == {k: s.shape for k, s in ts.items()}
    assert ts["h"].dtype == torch.float32 and ts["conv"].dtype \
        == torch.bfloat16
    p = TR.rglru_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    lam = p["lam"].float()
    assert lam.min() >= 0.0009 and lam.max() <= 0.1001
    assert all(v.dtype == torch.bfloat16 for v in p.values())
