"""The reference's train_4k step at one sequence a microbatch, on the CPU.

``src/repro/launch/specs.py`` builds the train_4k cell with
``n_microbatches = batch // n_data``: each data rank takes its rows one
sequence at a time and accumulates their gradients in float32. Here the
port's ``make_train_step`` at B = 4 and ``n_microbatches = 4`` (remat on)
runs three steps against the reference's jitted step on the same weights
and batches, meshless and over a one-rank gloo mesh, for the smoke configs
of chatglm3-6b (full attention), gemma3-12b and recurrentgemma-9b (whose
16-slot windows are shorter than T = 24, so their local layers take the
banded path), within ``test_torch_train.py``'s step tolerances. Then the
step's peak memory, counted on ``meta`` tensors by ``launch/cost.py``:
accumulating over 4 microbatches may add the float32 accumulator (4 bytes
a parameter) to the 1-microbatch step's peak, and no more — the loop
keeps at most one microbatch's gradient and takes the mean in place.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_mesh_programs import free_port  # noqa: E402
from test_torch_models import _flat  # noqa: E402
from test_torch_train import LOSS_TOL, _batch, _models  # noqa: E402

CONFIGS = ["chatglm3-6b", "gemma3-12b", "recurrentgemma-9b"]
B, M, STEPS = 4, 4, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-6)
# v's 1e-9 in ``test_train_step_matches_reference`` is set for its scale,
# gradients of ~0.1 (v ~1e-5); here the embedding's v reaches 9e-4
# (gemma3-12b's 8 smoke layers) and float32 sums in another order leave
# 2.5e-6-6.7e-6 of it. v's relative error is twice its gradient's, which
# ``test_torch_train.py`` holds within GRAD_TOL = 5e-5 of the largest: 1e-5
# of the leaf's largest v is 10x tighter than that
V_RTOL = 1e-5


def _steps(name):
    """The port's and the reference's configs and weights for ``name``
    with remat on, and the three steps' batches."""
    jcfg, cfg, jparams, params = _models(name, remat=True)
    assert cfg.window < 24 and cfg.remat
    batches = [_batch(cfg, seed=20 + i, b=B) for i in range(STEPS)]
    return jcfg, cfg, jparams, params, batches


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's three jitted steps at ``n_microbatches = 4``: after
    each, (lr, loss, grad_norm, step, params, m, v) as numpy."""
    jcfg, _, jparams, _, batches = _steps(name)
    jstep = jax.jit(JO.make_train_step(jcfg, JO.OptConfig(**OPT),
                                       n_microbatches=M))
    jstate = JO.opt_init(jparams)
    out = []
    for batch in batches:
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(jm["lr"]), float(jm["loss"]),
                    float(jm["grad_norm"]), int(jstate["step"]),
                    *({p: np.asarray(w) for p, w in _flat(t).items()}
                      for t in (jparams, jstate["m"], jstate["v"]))))
    return out


def _held(name, step, params, state):
    """Three port steps against the reference's, within the tolerances of
    ``test_torch_train.py::test_train_step_matches_reference``, v's with
    ``V_RTOL`` of the leaf's largest v beside them."""
    *_, batches = _steps(name)
    for i, (batch, want) in enumerate(zip(batches, _reference(name))):
        lr, loss, norm, count, *trees = want
        params, state, m = step(params, state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(m["lr"]) == pytest.approx(lr, rel=1e-6)
        assert abs(float(m["loss"]) - loss) <= LOSS_TOL
        assert float(m["grad_norm"]) == pytest.approx(norm, rel=1e-5)
        assert int(state["step"]) == count == i + 1
        for tree, jtree, tol, rtol in zip(
                (params, state["m"], state["v"]), trees, (1e-5, 1e-6, 1e-9),
                (0.0, 0.0, V_RTOL)):
            got = _flat(tree)
            assert list(got) == list(jtree)
            for path, w in jtree.items():
                err = np.abs(got[path].numpy() - w).max()
                assert err <= tol + rtol * np.abs(w).max(), \
                    (i, path, float(err))


@pytest.mark.parametrize("name", CONFIGS)
def test_one_sequence_a_microbatch_matches_reference(name):
    """The meshless step, one sequence a microbatch, as the train_4k cell
    runs it on a data rank."""
    _, cfg, _, params, _ = _steps(name)
    step = TO.make_train_step(cfg, TO.OptConfig(**OPT), n_microbatches=M)
    _held(name, step, params, TO.opt_init(params))


@pytest.mark.parametrize("name", CONFIGS)
def test_one_sequence_a_microbatch_on_a_mesh_matches_reference(name):
    """The mesh step (the ZeRO layout, each microbatch's gradient reduced
    into it and accumulated there) over a one-rank gloo group, one
    sequence a microbatch."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import sharding as S
    from repro_torch.models import param_specs
    _, cfg, _, params, _ = _steps(name)
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        specs = param_specs(cfg)
        osh = S.compute_shardings(specs, mesh, cfg)
        zsh = S.param_shardings(specs, mesh, cfg, extra_batch_dim=True)
        state = TO.opt_init(params, zero_shardings=zsh, out_shardings=osh)
        step = TO.make_train_step(cfg, TO.OptConfig(**OPT), mesh=mesh,
                                  n_microbatches=M, grad_shardings=zsh,
                                  param_out_shardings=osh)
        _held(name, step, params, state)
    finally:
        dist.destroy_process_group()


def test_microbatched_step_holds_one_gradient():
    """chatglm3-6b at full width and 2 layers in bf16 (0.94 B parameters,
    which dominate its activations at B = 4, T = 128), counted on ``meta``
    tensors by ``launch/cost.py::count``: the 4-microbatch step's peak
    exceeds the 1-microbatch step's by at most the float32 accumulator, 4
    bytes a parameter. A loop that keeps the last microbatch's gradient
    while the next is built, or a second float32 tree for the mean, holds
    about 8."""
    from repro_torch.configs import get_config
    from repro_torch.launch.cost import count
    from repro_torch.models import param_specs
    cfg = dataclasses.replace(get_config("chatglm3-6b"), n_layers=2,
                              remat=True, param_dtype="bfloat16")

    def peak(m):
        params = param_specs(cfg)
        state = TO.opt_init(params)
        tokens = torch.empty((B, 128), dtype=torch.int32, device="meta")
        batch = {"tokens": tokens, "labels": tokens.clone()}
        step = TO.make_train_step(cfg, TO.OptConfig(warmup_steps=1),
                                  n_microbatches=m)
        _, cost = count(step, params, state, batch,
                        track=(params, state, batch))
        return cost.peak_bytes, sum(t.numel() for t in leaves(params))
    (one, n), (four, _) = peak(1), peak(M)
    assert n > 9e8
    assert four - one <= 4 * n, (four - one) / n
