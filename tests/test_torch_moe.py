"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX reference
(``repro.models.moe``), function by function, on the CPU in float32.

Inputs are numpy draws from a seeded generator, handed to both packages.
Tolerances: routing indices and the dispatch sort are exact; gates within
1e-6 (one float32 softmax); FFN outputs within 2e-5 absolute (float32 sums
of products of width up to 128 in another order; outputs are of order 1);
the dispatch path's scatter-add sums at most top_k terms a token.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import moe as JM  # noqa: E402

from repro_torch.launch.mesh import make_cells_mesh  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

ATOL = 2e-5


def _cfg(name="mixtral-8x7b", **kw):
    jcfg = dataclasses.replace(j_get_smoke(name), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(rng, cfg):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    shapes = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
              "w_down": (e, f, d)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
            for k, s in shapes.items()}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _x(rng, b, t, d):
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=atol, rtol=0), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_route_matches_reference(name, rng):
    jcfg, cfg = _cfg(name)
    jp, tp = _both(_params(rng, cfg))
    jx, tx = _x(rng, 2, 13, cfg.d_model)
    jg, ji = JM._route(jp, jx, jcfg)
    tg, ti = TM._route(tp, tx, cfg)
    assert tg.dtype == torch.float32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg, atol=1e-6)


def test_route_breaks_ties_toward_the_lower_index():
    """``jax.lax.top_k`` ranks equal logits by index; so does the port
    (``torch.topk`` promises no order among ties)."""
    jcfg, cfg = _cfg(n_experts=6, top_k=3)
    router = np.zeros((cfg.d_model, 6), np.float32)
    router[:, 4] = 1.0                       # expert 4 first, the rest tied
    x = np.ones((1, 3, cfg.d_model), np.float32)
    _, ji = JM._route({"router": jnp.asarray(router)}, jnp.asarray(x), jcfg)
    _, ti = TM._route({"router": torch.from_numpy(router)},
                      torch.from_numpy(x), cfg)
    assert np.asarray(ji).tolist() == ti.numpy().tolist() == [[[4, 0, 1]] * 3]


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_moe_dense_matches_reference(name, rng):
    jcfg, cfg = _cfg(name)
    jp, tp = _both(_params(rng, cfg))
    jx, tx = _x(rng, 2, 11, cfg.d_model)
    _close(TM._moe_dense(tp, tx, cfg), JM._moe_dense(jp, jx, jcfg))


def test_expert_ffn_matches_reference(rng):
    jcfg, cfg = _cfg()
    p = _params(rng, cfg)
    xb = rng.standard_normal((cfg.n_experts, 9, cfg.d_model)).astype(
        np.float32)
    want = JM._expert_ffn(*(jnp.asarray(p[k]) for k in
                            ("w_gate", "w_up", "w_down")), jnp.asarray(xb))
    got = TM._expert_ffn(*(torch.from_numpy(p[k]) for k in
                           ("w_gate", "w_up", "w_down")), torch.from_numpy(xb))
    _close(got, want)


@pytest.mark.parametrize("a,e,cap", [(40, 4, 16), (40, 4, 5), (1, 3, 8),
                                     (97, 8, 8)])
def test_dispatch_sort_is_the_reference_exactly(a, e, cap, rng):
    """Order (a stable sort), sorted experts, slots and validity, with
    capacity drops where a run outgrows ``cap``."""
    e_flat = rng.integers(0, e, a).astype(np.int32)
    want = JM._dispatch_sort(jnp.asarray(e_flat), e, cap)
    got = TM._dispatch_sort(torch.from_numpy(e_flat).long(), e, cap)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if cap == 5:
        assert not got[3].all()


@pytest.mark.parametrize("scale", [1.0, 0.1])
@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_moe_local_matches_reference(name, scale, rng):
    """One shard of the dispatch path; ``capacity_scale=0.1`` makes the
    capacity 8 (its floor) against ~18 assignments an expert, so tokens
    drop to zero as in the reference."""
    jcfg, cfg = _cfg(name)
    jp, tp = _both(_params(rng, cfg))
    jx, tx = _x(rng, 2, 37, cfg.d_model)
    want = JM._moe_local(jp, jx, jcfg, capacity_scale=scale)
    got = TM._moe_local(tp, tx, cfg, capacity_scale=scale)
    _close(got, want)
    dense = TM._moe_dense(tp, tx, cfg)
    dropped = ~torch.isclose(got, dense, atol=ATOL).all(-1)
    assert dropped.any() == (scale < 1.0)


def test_moe_local_matches_dense_without_drops(rng):
    """With room for every assignment the dispatch path is the dense
    FFN."""
    _, cfg = _cfg(capacity_factor=4.0)
    _, tp = _both(_params(rng, cfg))
    _, tx = _x(rng, 2, 19, cfg.d_model)
    _close(TM._moe_local(tp, tx, cfg), TM._moe_dense(tp, tx, cfg))


def test_moe_apply_is_dense_without_a_mesh_and_refuses_mesh_forms(rng):
    jcfg, cfg = _cfg()
    jp, tp = _both(_params(rng, cfg))
    jx, tx = _x(rng, 1, 7, cfg.d_model)
    want = JM.moe_apply(jp, jx, jcfg, impl="tp")
    for impl in (None, "dense", "tp", "ep"):
        _close(TM.moe_apply(tp, tx, cfg, impl=impl), want)
    mesh = make_cells_mesh(2, devices=["cpu"])
    _close(TM.moe_apply(tp, tx, cfg, impl="dense", mesh=mesh), want)
    for impl in ("tp", "ep"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, "
                           "item 6"):
            TM.moe_apply(tp, tx, cfg, impl=impl, mesh=mesh)


def test_moe_init_keeps_a_float32_router_and_the_reference_fan_in():
    _, cfg = _cfg(param_dtype="bfloat16")
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert all(p[k].dtype == torch.bfloat16
               for k in ("w_gate", "w_up", "w_down"))
    # dense_init's fan-in is shape[0]: the expert count for 3-D weights
    w = p["w_down"].float().numpy() * np.sqrt(cfg.n_experts)
    assert np.abs(w).max() <= 2.0 + 1e-2


def test_moe_dense_in_bfloat16_stays_near_float32(rng):
    """bf16 weights and activations: the output in bf16, within a few bf16
    ulps of the float32 computation on the same (rounded) values."""
    _, cfg = _cfg()
    p = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in _params(rng, cfg).items()}
    p["router"] = p["router"].float()
    x = torch.from_numpy(rng.standard_normal((2, 9, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    got = TM._moe_dense(p, x, cfg)
    want = TM._moe_dense({k: v.float() for k, v in p.items()}, x.float(),
                         cfg)
    assert got.dtype == torch.bfloat16
    assert torch.allclose(got.float(), want, atol=0.05, rtol=0.02)
