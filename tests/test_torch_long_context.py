"""The port at the reference's long serving positions, on the CPU: the
rotary table of every config (its full rotary width and base) bit for bit
at positions up to 524,287; ``decode_step`` at smoke width for the
long-context configs, four steps at positions 524,284-524,287 from a
seeded state and full rings (gemma3-12b's global layer on a
524,288-slot cache); the WKV with its intra-chunk decays formed a group of
chunks at a time; and ``chip_smoke.py``'s blocked plain version of K4,
which holds a K4 call at T = 32768 by blocks of query rows.

The reference's ``decode_step`` is compiled here with XLA's algebraic
simplifier off. With it on, ``jax.jit`` rewrites the rotary table's
``1.0 / theta ** e`` (``src/repro/models/layers.py::rotary_cos_sin``) as
``theta ** -e``, which rounds once where the expression rounds twice: 1
ulp apart in 3 of 8 entries at smoke width (10-43 of 32-128 at full
width), which at position 524,287 moves the reference's own angles by up
to 0.03 rad. Op by op, and compiled with that pass off, the reference
computes the expression as written, the table the port matches.
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rwkv as JW  # noqa: E402
from repro.models.model import init_cache as j_init_cache  # noqa: E402

from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.kernels.attn import attn as PA  # noqa: E402
from repro_torch.models import decode_step  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import rwkv as TW  # noqa: E402
from repro_torch.models.model import init_cache  # noqa: E402

from test_torch_models import _flat, _np, _port_cfg  # noqa: E402
from test_torch_rwkv import _wkv_inputs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
POSITIONS = np.array([0, 2047, 32767, 524287])
LONG = ["recurrentgemma-9b", "rwkv6-1.6b", "h2o-danube-3-4b", "gemma3-12b"]
LAST, STEPS = 524287, 4
TOL = 1e-4          # tests/test_torch_decode.py's, the reference's own


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the rotary table --------------------------------------------------------

def _identity_trig(module):
    """``module``'s namespace with ``cos`` and ``sin`` the identity."""
    ns = types.SimpleNamespace(**{n: getattr(module, n) for n in dir(module)
                                  if not n.startswith("__")})
    ns.cos = ns.sin = lambda a: a
    return ns


@pytest.mark.parametrize("name", list(J_ARCHS))
def test_rotary_angles_are_the_reference_table(name, monkeypatch):
    """The port's angles equal the reference's bit for bit at every
    config's own ``(d_head · rope_fraction, rope_theta)``: each package's
    ``rotary_cos_sin`` with ``cos`` and ``sin`` read as the identity
    returns its angles. Smoke configs (``d_head`` 16) would not show the
    1-ulp entries of a 120- or 256-wide table. cos and sin themselves are
    each framework's float32 libm, within 2 ulp of 1."""
    cfg = j_get_config(name)
    d_rot = int(cfg.d_head * cfg.rope_fraction)
    monkeypatch.setattr(JL, "jnp", _identity_trig(jnp))
    monkeypatch.setattr(TL, "torch", _identity_trig(torch))
    want, _ = JL.rotary_cos_sin(jnp.asarray(POSITIONS), d_rot,
                                cfg.rope_theta)
    got, _ = TL.rotary_cos_sin(torch.from_numpy(POSITIONS), d_rot,
                               cfg.rope_theta)
    monkeypatch.undo()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(want).view(np.int32)), name
    jc, js = JL.rotary_cos_sin(jnp.asarray(POSITIONS), d_rot,
                               cfg.rope_theta)
    tc, ts = TL.rotary_cos_sin(torch.from_numpy(POSITIONS), d_rot,
                               cfg.rope_theta)
    assert np.abs(tc.numpy() - np.asarray(jc)).max() <= 2 ** -23
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 2 ** -23


# --- decode at position 524,287 -----------------------------------------------

@pytest.mark.parametrize("name", LONG)
def test_decode_at_the_long_position_matches_reference(name):
    """Four ``decode_step``s at positions 524,284-524,287 (B = 1) from the
    same seeded numpy cache — RG-LRU ``h`` and conv carry, WKV state and
    shifts, every ring full, gemma3-12b's global layer 524,288 slots — and
    the same tokens: the logits and every cache leaf within 1e-4 of the
    reference's after each step."""
    jcfg = j_get_smoke(name)
    cfg = _port_cfg(jcfg)
    jparams = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params = lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(3)
    jcache = j_init_cache(jcfg, 1, LAST + 1)
    leaves, tdef = jax.tree.flatten(jcache)
    draws = [rng.standard_normal(x.shape).astype(np.float32)
             for x in leaves]
    jcache = jax.tree.unflatten(tdef, [jnp.asarray(d) for d in draws])
    cache = init_cache(cfg, 1, LAST + 1, device="cpu")
    flat, jflat = _flat(cache), _flat(jcache)
    assert list(flat) == list(jflat)
    for path, leaf in flat.items():
        leaf.copy_(torch.from_numpy(np.array(jflat[path])))
    toks = rng.integers(0, cfg.vocab_size, (STEPS, 1), dtype=np.int32)
    ref = jax.jit(j_decode_step, static_argnums=4).lower(
        jparams, jcache, jnp.asarray(toks[0]), LAST, jcfg).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    for j in range(STEPS):
        pos = LAST - STEPS + 1 + j
        jl, jcache = ref(jparams, jcache, jnp.asarray(toks[j]), pos)
        lg, cache = decode_step(params, cache, torch.from_numpy(toks[j]),
                                pos, cfg)
        assert lg.shape == (1, cfg.vocab_size)
        assert np.abs(_np(lg) - _np(jl)).max() < TOL, (name, j)
        got, want = _flat(cache), _flat(jcache)
        assert max(np.abs(_np(got[p]) - _np(want[p])).max()
                   for p in want) < TOL, (name, j)


# --- the WKV in groups of chunks -----------------------------------------------

@pytest.mark.parametrize("t,chunk", [(100, 8), (64, 8)])
def test_wkv_groups_match_one_group_and_reference(t, chunk, rng,
                                                  monkeypatch):
    """A budget of 2 or 3 chunks' decays splits the 13 or 8 chunks into at
    least 3 groups: the output and state within 1e-6 of the output's rms of
    the one-group path (the same products a chunk) and within the WKV
    tests' 2e-5 of the reference."""
    args = _wkv_inputs(rng, 2, t, 3, 8)
    per_chunk = 2 * 3 * chunk * chunk * 8 * 4
    nc = -(-t // chunk)
    wo, ws = TW._wkv_chunked(*(torch.from_numpy(a) for a in args), chunk)
    for budget in (2 * per_chunk, 3 * per_chunk):
        assert -(-nc // (budget // per_chunk)) >= 3
        monkeypatch.setattr(TW, "WKV_GROUP_BYTES", budget)
        to, ts = TW._wkv_chunked(*(torch.from_numpy(a) for a in args), chunk)
        rms = wo.pow(2).mean().sqrt().item()
        assert (to - wo).abs().max().item() <= 1e-6 * rms
        assert (ts - ws).abs().max().item() <= 1e-6 * ws.pow(2).mean() \
            .sqrt().item()
        jo, js = JW._wkv_chunked(*(jnp.asarray(a) for a in args), chunk)
        assert np.allclose(to.numpy(), np.asarray(jo), atol=2e-5, rtol=0)
        assert np.allclose(ts.numpy(), np.asarray(js), atol=2e-5, rtol=0)


def test_wkv_at_the_training_shape_is_one_group():
    """rwkv6-1.6b's chunk decays at B = 2, T = 2048 are exactly the budget:
    one group, so the training step launches what it did."""
    cfg = j_get_config("rwkv6-1.6b")
    h, n, c = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim, \
        cfg.chunk_rec
    per_chunk = 2 * h * c * c * n * 4
    assert TW.WKV_GROUP_BYTES // per_chunk == 2048 // c
    assert (32768 // c) * per_chunk == 16 * TW.WKV_GROUP_BYTES


# --- K4's blocked plain version -----------------------------------------------

@pytest.mark.parametrize("shape", [(2, 40, 40, 8, 2, 16, True),
                                   (1, 37, 37, 6, 3, 8, True),
                                   (2, 24, 50, 4, 2, 16, False)])
def test_k4_blocked_plain_version_is_the_whole_one(shape, monkeypatch):
    """``chip_smoke.k4_plain`` with its blocks forced to a few query rows
    (``K4_REF_WHOLE`` small): the output and the LSE within 1e-6 of the
    whole plain version's, and ``k4_call_excess``'s share of the tolerance
    for a bf16 output the same, down to a fault planted in the last
    block's last row, which both must see."""
    cs = _chip_smoke()
    b, tq, tk, hq, hkv, dh, causal = shape
    g = hq // hkv
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh)))
    whole, wlse = PA.flash_attention_fwd_ref(q, k, v, causal=causal,
                                             with_lse=True)
    monkeypatch.setattr(cs, "K4_REF_WHOLE", 7 * g * tk)
    blocked, lse = cs.k4_plain(q, k, v, causal, with_lse=True)
    assert torch.allclose(blocked, whole, atol=1e-6, rtol=0)
    assert torch.allclose(lse, wlse, atol=1e-6, rtol=0)
    out = whole.bfloat16()
    out[:, -1] += 0.5
    monkeypatch.setattr(cs, "K4_REF_WHOLE", 1 << 26)
    want = cs.k4_call_excess(q, k, v, causal, out)
    monkeypatch.setattr(cs, "K4_REF_WHOLE", 7 * g * tk)
    got = cs.k4_call_excess(q, k, v, causal, out)
    assert want > 1.0 and abs(got - want) <= 1e-4 * want
    assert cs.k4_call_excess(q, k, v, causal, whole.bfloat16()) <= 1.0


def test_k4_plain_keeps_the_whole_call_where_it_fits():
    """Calls whose scores fit the budget take ``flash_attention_fwd_ref``
    as before, in the input's type: a bf16 call's output is its bf16
    output bit for bit."""
    cs = _chip_smoke()
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((1, 30, 4, 16), (1, 30, 2, 16),
                                     (1, 30, 2, 16)))
    got = cs.k4_plain(q, k, v, True, whole=cs.K4_PLAIN_WHOLE)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, PA.flash_attention_fwd_ref(q, k, v, causal=True))
