"""The port's mesh programs on a (2, 4) ``data × model`` mesh of eight gloo
ranks on the CPU, mirroring the reference's ``tests/test_mesh_programs.py``
(whose own mesh programs fail on jax 0.9.0, so the port is held against
its single-device and dense forms and the reference's single-device
step):

* the sharded train step on chatglm3-6b's smoke config with the ZeRO
  layout (``param_shardings(..., extra_batch_dim=True)``), at AdamW's
  default eps: the loss within 1e-5 of the meshless port step's and of
  the reference's ``make_train_step`` under ``jax.jit``; each rank's
  reduce-scattered gradient block, leaf by leaf, within 1e-5 of the
  leaf's rms of the matching block of the meshless gradient; the
  parameters after the step within 1e-5 of their rms of the meshless
  ``opt_update`` given the ranks' blocks put together; and every moment
  leaf the layout splits held as 1/N of its elements on each rank
  (counted in elements, not names);
* the MoE's ``ep`` (qwen3 smoke, 8 experts, top-2) and ``tp`` (mixtral
  smoke, 4 experts, ``d_expert`` 32, ``psum_late`` on and off) forms
  within 1e-5 (of the largest magnitude) of the single-device
  ``_moe_local`` over the same token shards (the same capacity), and
  against ``_moe_dense`` by the reference's share above 0.95; the
  gradient of a loss through each form within 1e-5 of the single-device
  form's, leaf by leaf (the collectives' autograd);
* the mesh train loop: a crash at step 3 and a restart from the ranks'
  shard checkpoints land on the uninterrupted run's final loss bit for
  bit;
* ``constrain`` under ``axis_rules`` redistributes a DTensor to its
  logical axes' layout and leaves a plain tensor alone.

All of it runs in one spawn of eight processes (``spawn_ranks``): each
rank binds nothing itself; the test picks a free port, starts the ranks
with ``python -c``, and joins them within ``JOIN_S`` seconds, killing
them all if one hangs.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.tree import leaves as _leaves, rebuild  # noqa: E402
from test_torch_models import _port_cfg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
TOL = 1e-5

PRELUDE = """
import sys
import torch
import torch.distributed as dist
rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
inputs = torch.load(f"{out}/inputs.pt", weights_only=False)
result = {}
"""

EPILOGUE = """
torch.save(result, f"{out}/rank{rank}.pt")
dist.barrier()
dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, body: str, inputs: dict, out) -> list:
    """Run ``body`` on ``world`` gloo ranks, each a ``python -c`` process
    with ``inputs`` loaded and a ``result`` dict to fill; → the ranks'
    results. Fails if a rank fails or the ranks are not done within
    ``JOIN_S`` seconds (then all are killed)."""
    torch.save(inputs, out / "inputs.pt")
    prog = PRELUDE + textwrap.dedent(body) + EPILOGUE
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(r),
                               str(world), port, str(out)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


RANK_BODY = """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.models import moe as M, param_specs
from repro_torch.training import optimizer as O
from repro_torch.training.train_loop import TrainLoopConfig, train

mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
di, mi = C.axis_index(mesh, "data"), C.axis_index(mesh, "model")

# the sharded train step, ZeRO-1/2 layout; each gradient block as the
# step reduces it, in the order of the leaves and their repeats
from repro_torch.tree import leaves
cfg = inputs["train_cfg"]
specs = param_specs(cfg)
osh = S.compute_shardings(specs, mesh, cfg)
zsh = S.param_shardings(specs, mesh, cfg, extra_batch_dim=True)
params = inputs["params"]
state = O.opt_init(params, zero_shardings=zsh, out_shardings=osh)
step = O.make_train_step(cfg, O.OptConfig(**inputs["opt"]), mesh=mesh,
                         grad_shardings=zsh, param_out_shardings=osh)
reduced, reduce = [], O._Layout.reduce

def record(lay, g):
    out = reduce(lay, g)
    reduced.append(out.clone())
    return out
O._Layout.reduce = record
params, state, m = step(params, state, inputs["batch"])
O._Layout.reduce = reduce
result["train"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                       params=params, m=state["m"], grads=reduced,
                       zspec=[z.spec for z in leaves(zsh)])

# constrain: a DTensor redistributed to its logical axes' layout
from torch.distributed.tensor import Replicate, distribute_tensor
whole = torch.arange(64, dtype=torch.float32).reshape(8, 8)
dx = distribute_tensor(whole, mesh, [Replicate(), Replicate()])
with S.axis_rules(mesh):
    cx = S.constrain(dx, "batch", "ff")
    plain = S.constrain(whole, "batch", "ff")
result["constrain"] = dict(placements=cx.placements, local=cx.to_local(),
                           plain_untouched=plain is whole)

# the MoE forms: forward and the gradient of sum(out * w)
for key in ("ep", "tp", "tp_late"):
    case = inputs[key]
    mcfg, p, x, w = case["cfg"], case["params"], case["x"], case["w"]
    impl = "ep" if key == "ep" else "tp"
    msh = S.compute_shardings({"ffn": p}, mesh, mcfg, impl)["ffn"]
    local = {k: S.shard_of(v, msh[k]).clone().requires_grad_(True)
             for k, v in p.items()}
    b = x.shape[0] // 2
    xl = x[di * b:(di + 1) * b].clone().requires_grad_(True)
    with torch.enable_grad():
        y = M.moe_apply(local, xl, mcfg, impl=impl, mesh=mesh,
                        psum_late=key == "tp_late")
        loss = (y * w[di * b:(di + 1) * b]).sum() / C.axis_size(mesh, "model")
        gx, *gw = torch.autograd.grad(loss, [xl] + [local[k] for k in
                                                   sorted(local)])
    result[key] = dict(y=y.detach(), gx=gx,
                       gw=dict(zip(sorted(local), gw)))

# the mesh train loop: crash and restart from the ranks' shards
loop = dict(total_steps=4, checkpoint_every=2, log_every=100, global_batch=8,
            seq_len=16)
tcfg = inputs["loop_cfg"]
whole = train(tcfg, TrainLoopConfig(checkpoint_dir=f"{out}/a", **loop),
              mesh=mesh, device="cpu")
try:
    train(tcfg, TrainLoopConfig(checkpoint_dir=f"{out}/b", **loop), mesh=mesh,
          inject_failure_at=3)
except RuntimeError as e:
    assert "injected failure" in str(e)
again = train(tcfg, TrainLoopConfig(checkpoint_dir=f"{out}/b", **loop),
              mesh=mesh)
result["loop"] = dict(whole=whole["final_loss"], again=again["final_loss"],
                      resumed_from=again["history"][0]["step"])
"""


def _moe_case(rng, name, **over):
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    p = TM.moe_init(gen, cfg)
    x = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    return dict(cfg=cfg, params=p, x=x, w=w)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(22)
    jcfg = j_get_smoke("chatglm3-6b")
    cfg = _port_cfg(jcfg)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    params = lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (8, 32))}
    opt = dict(warmup_steps=1)
    jstep = jax.jit(JO.make_train_step(jcfg, JO.OptConfig(**opt)))
    _, _, jm = jstep(jparams, JO.opt_init(jparams),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mono = TO.make_train_step(cfg, TO.OptConfig(**opt))
    p1, _, m1 = mono(lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu"),
                     TO.opt_init(params), tb)
    _, _, grads = TO.loss_and_grads(params, tb, cfg)
    inputs = dict(
        train_cfg=cfg, params=params, batch=tb, opt=opt,
        ep=_moe_case(rng, "qwen3-moe-235b-a22b", n_experts=8, top_k=2,
                     moe_impl="ep"),
        tp=_moe_case(rng, "mixtral-8x7b", n_experts=4, top_k=2, d_expert=32,
                     moe_impl="tp"),
        loop_cfg=get_smoke_config("chatglm3-6b"))
    inputs["tp_late"] = inputs["tp"]
    out = tmp_path_factory.mktemp("mesh")
    ranks = spawn_ranks(8, RANK_BODY, inputs, out)
    return dict(ranks=ranks, inputs=inputs, ref_loss=float(jm["loss"]),
                mono=(float(m1["loss"]), float(m1["grad_norm"]), p1),
                grads=grads)


SIZES = {"data": 2, "model": 4}


def _block_index(entry, coords) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of a dimension split over
    the mesh axes of one spec entry, major first (``PartitionSpec``)."""
    axes = () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)
    k, n = 0, 1
    for a in axes:
        k, n = k * SIZES[a] + coords[a], n * SIZES[a]
    return k, n


def _block(t, spec, coords):
    """The block of ``t`` that the rank at ``coords`` holds under
    ``spec``: a view."""
    for d, entry in enumerate(spec):
        k, n = _block_index(entry, coords)
        t = t.chunk(n, dim=d)[k] if n > 1 else t
    return t


def _units(params, grads, specs):
    """(the meshless gradient of each unit — a repeat of a stacked leaf,
    else the leaf —, its ZeRO spec) in the order the step reduces them."""
    out = []
    for (_, g, stacked), spec in zip(TO._param_leaves(params, grads), specs):
        if stacked:
            out += [(u, spec[1:]) for u in g]
        else:
            out.append((g, spec))
    return out


def _rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt()) or 1.0


def test_sharded_train_step_matches_single_device(run):
    """At AdamW's default eps. The step is held in its two halves, as
    AdamW's first step g / (|g| + eps) turns float32 noise in a near-zero
    element into a step of lr (the data-parallel gradient sums the batch's
    halves in another order): the gradient each rank reduces, element by
    element, against the meshless gradient, and the parameters against
    the meshless ``opt_update`` given that gradient, the ranks' blocks put
    together."""
    ref_loss = run["ref_loss"]
    loss1, gnorm1, _ = run["mono"]
    params = run["inputs"]["params"]
    units = _units(params, run["grads"], run["ranks"][0]["train"]["zspec"])
    whole = [torch.zeros_like(g) for g, _ in units]
    for r, res in enumerate(run["ranks"]):
        t = res["train"]
        assert abs(t["loss"] - loss1) <= TOL
        assert abs(t["loss"] - ref_loss) <= TOL
        assert t["grad_norm"] == pytest.approx(gnorm1, rel=1e-5)
        assert len(t["grads"]) == len(units)
        coords = dict(zip(("data", "model"), divmod(r, 4)))
        for (want, spec), got, acc in zip(units, t["grads"], whole):
            block = _block(want, spec, coords)
            assert got.shape == block.shape, spec
            assert float((got - block).abs().max()) <= TOL * _rms(want)
            _block(acc, spec, coords).copy_(got)
    nodes, it = [], iter(whole)
    for _, g, stacked in TO._param_leaves(params, run["grads"]):
        nodes.append(tuple(next(it) for _ in g) if stacked else next(it))
    start = rebuild(params, [x.clone() for x in _leaves(params)])
    want, _, wm = TO.opt_update(TO.OptConfig(**run["inputs"]["opt"]), start,
                                rebuild(params, nodes), TO.opt_init(start))
    for res in run["ranks"]:
        t = res["train"]
        assert t["grad_norm"] == pytest.approx(float(wm["grad_norm"]),
                                               rel=1e-5)
        for got, w in zip(_leaves(t["params"]), _leaves(want)):
            assert float((got - w).abs().max()) <= TOL * _rms(w)


def test_zero_moments_are_shards_of_the_layout(run):
    """Every moment leaf the ZeRO layout splits over the 8 ranks (data 2
    × model 4) holds 1/N of its elements on each rank, N the product of
    its axes' sizes; the layout splits at least the big matrices over the
    data axis."""
    sizes = {"data": 2, "model": 4}
    params = run["inputs"]["params"]
    split_by_data = 0
    for r in run["ranks"]:
        t = r["train"]
        for p, m, spec in zip(_leaves(params), _leaves(t["m"]),
                              t["zspec"]):
            n = int(np.prod([sizes[a] for e in spec if e
                             for a in (e if isinstance(e, tuple) else (e,))]))
            assert m.numel() * n == p.numel(), spec
            assert m.dtype == torch.float32
            split_by_data += "data" in str(spec)
    assert split_by_data >= 8 * 4


def _oracle(case, impl):
    """The single-device capacity form over the mesh's token shards: ep
    splits each data rank's rows by sequence over the 4 model ranks, tp
    keeps them whole; the same capacity as each rank computes."""
    cfg, p = case["cfg"], case["params"]
    x = case["x"].clone().requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    with torch.enable_grad():
        rows = []
        for d in range(2):
            xd = x[2 * d:2 * d + 2]
            if impl == "ep":
                rows.append(torch.cat([TM._moe_local(leaves, c, cfg)
                                       for c in xd.chunk(4, dim=1)], dim=1))
            else:
                rows.append(TM._moe_local(leaves, xd, cfg))
        y = torch.cat(rows)
        gx, *gw = torch.autograd.grad((y * case["w"]).sum(),
                                      [x] + [leaves[k] for k in sorted(p)])
    return y.detach(), gx, dict(zip(sorted(p), gw))


def _err(got, want) -> float:
    """The largest difference over the largest magnitude of ``want``."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


@pytest.mark.parametrize("key", ["ep", "tp", "tp_late"])
def test_moe_mesh_forms_match_single_device(run, key):
    case = run["inputs"][key]
    impl = "ep" if key == "ep" else "tp"
    y, gx, gw = _oracle(case, impl)
    dense = TM._moe_dense(case["params"], case["x"], case["cfg"])
    ranks = run["ranks"]
    # rank r = data index · 4 + model index
    for r, res in enumerate(ranks):
        d = r // 4
        assert _err(res[key]["y"], y[2 * d:2 * d + 2]) <= TOL
    # the reference's measure, over the whole output (model rank 0's rows)
    whole = torch.cat([ranks[0][key]["y"], ranks[4][key]["y"]])
    close = float(((whole - dense).abs() < 1e-4).float().mean())
    assert close > 0.95, close
    # the gradient: x's and the router's shares summed over the ranks that
    # hold them whole; the expert weights' over the data ranks
    for d in range(2):
        share = sum(ranks[4 * d + mi][key]["gx"] for mi in range(4))
        assert _err(share, gx[2 * d:2 * d + 2]) <= TOL
    router = sum(res[key]["gw"]["router"] for res in ranks)
    assert _err(router, gw["router"]) <= TOL
    for name in ("w_gate", "w_up", "w_down"):
        whole = gw[name]
        for mi in range(4):
            got = ranks[mi][key]["gw"][name] + ranks[4 + mi][key]["gw"][name]
            if impl == "ep":
                want = whole.chunk(4, dim=0)[mi]
            else:
                want = whole.chunk(4, dim=2 if name != "w_down" else 1)[mi]
            assert _err(got, want) <= TOL


def test_constrain_redistributes_a_dtensor_under_axis_rules(run):
    """"batch" → the data axis, "ff" → the model axis: each rank holds its
    (4, 2) block of the (8, 8) tensor; a plain tensor is left alone."""
    from torch.distributed.tensor import Shard
    whole = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    for r, res in enumerate(run["ranks"]):
        c = res["constrain"]
        assert tuple(c["placements"]) == (Shard(0), Shard(1))
        d, m = divmod(r, 4)
        assert torch.equal(c["local"], whole[4 * d:4 * d + 4, 2 * m:2 * m + 2])
        assert c["plain_untouched"]


def test_mesh_train_loop_resumes_bit_for_bit(run):
    for res in run["ranks"]:
        loop = res["loop"]
        assert loop["resumed_from"] == 3
        assert loop["again"] == loop["whole"]


def test_one_rank_mesh_step_is_the_meshless_step():
    """On a (1, 1) gloo mesh the ZeRO layout drops both axes of one rank:
    no leaf has an axis to sum, split or tile, ``reduce`` hands the
    gradient back as it is, and two mesh steps are the meshless steps bit
    for bit (loss, grad norm, parameters and moments)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import sharding as S
    from repro_torch.models import init_params, param_specs

    cfg = get_smoke_config("chatglm3-6b")
    rng = np.random.default_rng(3)
    opt = TO.OptConfig(warmup_steps=1)
    plain = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params = rebuild(plain, [x.clone() for x in _leaves(plain)])
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        specs = param_specs(cfg)
        osh = S.compute_shardings(specs, mesh, cfg)
        zsh = S.param_shardings(specs, mesh, cfg, extra_batch_dim=True)
        layouts = TO._layouts(params, zsh, osh)
        assert all(lay.sum_axes == lay.zero == lay.tiled == ()
                   for lay in layouts)
        g = torch.ones(3)
        assert layouts[0].reduce(g) is g
        state = TO.opt_init(params, zero_shardings=zsh, out_shardings=osh)
        step = TO.make_train_step(cfg, opt, mesh=mesh, grad_shardings=zsh,
                                  param_out_shardings=osh)
        plain_state = TO.opt_init(plain)
        plain_step = TO.make_train_step(cfg, opt)
        for _ in range(2):
            batch = {k: torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (4, 16))) for k in ("tokens", "labels")}
            params, state, m = step(params, state, batch)
            plain, plain_state, pm = plain_step(plain, plain_state, batch)
            assert torch.equal(m["loss"], pm["loss"])
            assert torch.equal(m["grad_norm"], pm["grad_norm"])
            for a, b in zip(_leaves((params, state["m"], state["v"])),
                            _leaves((plain, plain_state["m"],
                                     plain_state["v"]))):
                assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
