"""The port's training gradient and step against the JAX reference, on the
CPU in float32: for all ten smoke configs and for granite-34b's,
chameleon-34b's, h2o-danube-3-4b's, qwen3-moe-235b-a22b's (its heads, and
its heads with its 128 experts), recurrentgemma-9b's and rwkv6-1.6b's head
geometries at smoke width (``test_torch_models.HEADS``), the loss and every
gradient leaf of ``repro_torch.training.optimizer.loss_and_grads`` against
``jax.value_and_grad(repro.models.loss_fn)``, and for recurrentgemma-9b's
and rwkv6-1.6b's smoke configs at their full configs' scan chunk of 32
over T = 80 (two chunk boundaries and a 16-step tail, through the scans'
backward); remat on or off leaves the
gradients bit for bit; ``param_specs`` of the ten full configs; and
three ``make_train_step`` steps against the reference's.

The reference's ``init_params`` draws the weights and
``repro_torch.convert.lm_params`` carries them into the port; tokens,
labels and frame embeddings are seeded numpy draws handed to both. The
reference runs under ``jax.jit`` with the config static. Tolerances: the
loss within 1e-5; each gradient leaf within 5e-5 of its largest
magnitude (sums of products in another order through every layer; the
largest seen is 6e-6 of it, rwkv6's); after three AdamW steps (lr 1e-3,
one warmup step) parameters within 1e-5 of the reference's, moments m
within 1e-6 and v within 1e-9 (their scales: lr times ~1, gradients of
~0.1, their squares), lr within 1e-6 relative (float32's cos differs by
an ulp between the two) and the gradient norm within 1e-5 relative.
``opt_update`` alone, on the same gradients, holds parameters within
1e-6 relative plus 1e-7 (an ulp of the float32 update) and within a bf16
ulp in bf16.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import param_specs as j_param_specs  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.models import param_specs  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

from test_torch_models import (SLICE17_HEADS, SLICE18_HEADS,  # noqa: E402
                               _flat, _port_cfg, heads_config)

ALL = list(TC.ARCHS)
B, T, ENC_LEN = 2, 24, 16
LOSS_TOL, GRAD_TOL = 1e-5, 5e-5
_J_GRAD = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True),
                  static_argnums=2)


def _batch(cfg, seed=1, b=B, t=T):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    labels[0, :3] = -100
    batch = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        batch["enc_input"] = rng.standard_normal(
            (b, ENC_LEN, cfg.d_model)).astype(np.float32)
    return batch


def _models(name, **overrides):
    """The reference's and the port's config and weights: smoke config
    ``name``, or a head geometry of ``test_torch_models.HEADS`` at smoke
    width."""
    jcfg = dataclasses.replace(heads_config(name), **overrides)
    cfg = _port_cfg(jcfg)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, lm_params(jax.tree.map(np.asarray, jparams),
                                         cfg, "cpu")


def _flat_grads(grads, prefix=""):
    """{path: gradient} in ``_flat``'s paths, a stacked leaf's per-repeat
    gradients stacked."""
    if isinstance(grads, dict):
        out = {}
        for k in sorted(grads):
            out.update(_flat_grads(grads[k], f"{prefix}/{k}"))
        return out
    if isinstance(grads, tuple) and "/scan/" in prefix:
        return {prefix: torch.stack(grads)}
    if isinstance(grads, tuple):
        out = {}
        for i, g in enumerate(grads):
            out.update(_flat_grads(g, f"{prefix}/{i}"))
        return out
    return {prefix: grads}


def _port_grads(params, batch, cfg):
    loss, _, grads = TO.loss_and_grads(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    return loss, _flat_grads(grads)


def _held_against_reference(name, t=T, seed=1, conditioned=False,
                            **overrides):
    """The loss and every gradient leaf of the port's ``loss_and_grads``
    against ``jax.value_and_grad`` of the reference's ``loss_fn`` on the
    same weights and a (B, t) batch drawn from ``seed``, within LOSS_TOL
    and GRAD_TOL of each leaf's largest magnitude. ``conditioned`` first
    holds the premise that float32 can meet GRAD_TOL on this input: the
    reference's own gradient, its weights moved by 1e-7 relative noise,
    stays within a quarter of GRAD_TOL."""
    jcfg, cfg, jparams, params = _models(name, **overrides)
    batch = _batch(cfg, seed=seed, t=t)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = _J_GRAD(jparams, jbatch, jcfg)
    if conditioned:
        rng = np.random.default_rng(3)
        moved = jax.tree.map(lambda a: a * (1 + 1e-7 * rng.standard_normal(
            a.shape)).astype(np.float32), jparams)
        want = _flat(jgrads)
        for path, w in _flat(_J_GRAD(moved, jbatch, jcfg)[1]).items():
            w0 = np.asarray(want[path])
            assert np.abs(np.asarray(w) - w0).max() <= GRAD_TOL / 4 * max(
                np.abs(w0).max(), 1e-6), (path, "ill-conditioned input")
    loss, grads = _port_grads(params, batch, cfg)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    want = _flat(jgrads)
    assert sorted(grads) == sorted(want)
    for path, w in want.items():
        g, w = grads[path].numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(), 1e-6), \
            (path, float(np.abs(g - w).max()), float(np.abs(w).max()))


@pytest.mark.parametrize("name", ALL + SLICE17_HEADS + ["qwen3-heads"]
                         + SLICE18_HEADS)
def test_loss_and_grads_match_reference(name):
    _held_against_reference(name)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_scan_grads_cross_chunks(name):
    """The RG-LRU scan's and the WKV chunks' backward across chunks: the
    smoke config at the full config's ``chunk_rec`` of 32 and T = 80, so
    that the scan crosses two chunk boundaries and pads a 16-step tail.
    The batch is seed 3's, and the test first holds that float32 can meet
    GRAD_TOL on it: at seed 1's (80 tokens a row), rwkv6's first-layer WKV
    output of row 1's first token on head 1 cancels to a group variance of
    3.8e-8, far under the group norm's eps of 1e-5, and there 1e-7
    relative noise on that token's r and k moves mu_k's gradient by 4.3e-4
    of its largest magnitude; the reference's own gradient moves by 9.4e-4
    under such noise on its weights, in both frameworks alike."""
    _held_against_reference(name, t=80, seed=3, conditioned=True,
                            chunk_rec=32)


@pytest.mark.parametrize("name", ALL)
def test_remat_leaves_the_gradients_bit_for_bit(name):
    """``remat=True`` under both policies recomputes each repeat's body in
    the backward (``torch.utils.checkpoint``), which gives the no-remat
    loss and gradients bit for bit."""
    _, cfg, _, params = _models(name)
    batch = _batch(cfg, seed=2)
    loss, want = _port_grads(params, batch, cfg)
    for policy in ("nothing", "dots_no_batch"):
        rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        rloss, got = _port_grads(params, batch, rcfg)
        assert torch.equal(rloss, loss), policy
        for path, w in want.items():
            assert torch.equal(got[path], w), (policy, path)


def test_remat_policy_saves_only_the_matrix_products():
    """``dots_no_batch`` saves the 2-D matrix products and recomputes the
    rest; an unknown policy raises."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models import model as TM
    aten = torch.ops.aten
    assert TM._save_matmuls(None, aten.mm.default) \
        == CheckpointPolicy.MUST_SAVE
    assert TM._save_matmuls(None, aten.bmm.default) \
        == CheckpointPolicy.PREFER_RECOMPUTE
    cfg = dataclasses.replace(_port_cfg(j_get_smoke("chatglm3-6b")),
                              remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        TM._maybe_remat(lambda x: x, cfg)


@pytest.mark.parametrize("name", ALL)
def test_param_specs_match_reference(name):
    """The full config's parameter tree as ``meta`` tensors: the
    reference's shapes and dtypes, leaf for leaf, nothing allocated."""
    jspecs = _flat(j_param_specs(j_get_config(name)))
    specs = _flat(param_specs(TC.get_config(name)))
    assert list(specs) == list(jspecs)
    for path, s in specs.items():
        assert s.is_meta, path
        assert tuple(s.shape) == tuple(jspecs[path].shape), path
        assert str(s.dtype).removeprefix("torch.") \
            == jnp.dtype(jspecs[path].dtype).name, path


@pytest.mark.parametrize("name", ["chatglm3-6b", "whisper-tiny"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(name, n_micro):
    """Three steps of ``make_train_step`` against the reference's jitted
    step on the same weights and batches: parameters, both moments, the
    step count, lr and the gradient norm after each. AdamW's eps is 1e-6
    here: at the default 1e-8 the first step's g / (|g| + eps) turns the
    two frameworks' summation noise in a near-zero gradient element
    (~1e-9) into a difference of a sizeable share of lr, which says
    nothing of the step's arithmetic (``test_opt_update_matches_reference``
    holds that at the default eps on equal gradients)."""
    jcfg, cfg, jparams, params = _models(name)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-6)
    jstep = jax.jit(JO.make_train_step(jcfg, JO.OptConfig(**opt),
                                       n_microbatches=n_micro))
    step = TO.make_train_step(cfg, TO.OptConfig(**opt),
                              n_microbatches=n_micro)
    jstate = JO.opt_init(jparams)
    state = TO.opt_init(params)
    for i in range(3):
        batch = _batch(cfg, seed=10 + i, b=4)
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        for tree, jtree, tol in ((params, jparams, 1e-5),
                                 (state["m"], jstate["m"], 1e-6),
                                 (state["v"], jstate["v"], 1e-9)):
            got, want = _flat(tree), _flat(jtree)
            assert list(got) == list(want)
            for path, w in want.items():
                err = np.abs(got[path].numpy() - np.asarray(w)).max()
                assert err <= tol, (i, path, float(err))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_repeat", [False, True])
def test_opt_update_matches_reference(dtype, per_repeat):
    """``opt_update`` against the reference's on the same parameters and
    gradients (a stacked ``scan`` leaf, a tuple, a plain leaf), three
    updates at the default OptConfig but one warmup step. The port's
    gradient of a stacked leaf may be the tuple of its repeats
    (``per_repeat``), as ``loss_and_grads`` gives it."""
    rng = np.random.default_rng(4)
    shapes = {"embed": (7, 5), "scan": {"pos0": {"w": (3, 5, 4)}},
              "rem": ({"b": (4,)},)}

    def draw(scale):
        return _map_np(lambda s: (rng.standard_normal(s) * scale).astype(
            np.float32), shapes)
    params = draw(0.5)
    opt = dict(warmup_steps=1, total_steps=10)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    tparams = _map_np(lambda a: torch.from_numpy(np.array(
        jnp.asarray(a, dtype).astype(jnp.float32))).to(getattr(torch, dtype)),
        params)
    jstate, tstate = JO.opt_init(jparams), TO.opt_init(tparams)
    for i in range(3):
        grads = draw(0.1)
        jgrads = jax.tree.map(lambda a: jnp.asarray(a, dtype), grads)
        tgrads = _map_np(lambda a: torch.from_numpy(np.array(
            jnp.asarray(a, dtype).astype(jnp.float32))).to(
                getattr(torch, dtype)), grads)
        if per_repeat:
            w = tgrads["scan"]["pos0"]["w"]
            tgrads["scan"]["pos0"]["w"] = tuple(w[r] for r in range(3))
        jparams, jstate, jm = JO.opt_update(JO.OptConfig(**opt), jparams,
                                            jgrads, jstate)
        tparams, tstate, tm = TO.opt_update(TO.OptConfig(**opt), tparams,
                                            tgrads, tstate)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for path, w in _flat(jparams).items():
            got = _flat(tparams)[path].float().numpy()
            w = np.asarray(w.astype(jnp.float32))
            if dtype == "float32":
                assert np.allclose(got, w, rtol=1e-6, atol=1e-7), path
            else:       # a bf16 ulp: 2^-7 of the value
                assert (np.abs(got - w) <= 2 ** -7 * np.abs(w)).all(), path
        for key in ("m", "v"):
            for path, w in _flat(jstate[key]).items():
                assert np.allclose(_flat(tstate[key])[path].numpy(),
                                   np.asarray(w), rtol=1e-6, atol=1e-12)


def _map_np(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_np(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not all(isinstance(x, int) for x in tree):
        return tuple(_map_np(fn, v) for v in tree)
    return fn(tree)


def test_update_works_a_piece_at_a_time():
    """The in-place update cuts every leaf into pieces of at most 2^26
    elements along its leading axes, and a stacked leaf by repeat."""
    assert TO._pieces((10, 20)) == [()]
    big = (3, 2 ** 14, 2 ** 13)                 # 2^27 a repeat
    pieces = TO._pieces(big[1:])
    assert pieces == [(slice(0, 2 ** 13),), (slice(2 ** 13, 2 ** 14),)]
    rows = TO._pieces((2 ** 20, 2 ** 7))
    assert len(rows) == 2 and rows[0] == (slice(0, 2 ** 19),)
    half = slice(0, 2 ** 26), slice(2 ** 26, 2 ** 27)
    assert TO._pieces((2, 2 ** 27)) == [(r, h) for r in (0, 1) for h in half]
