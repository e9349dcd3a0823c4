"""Dense tensor parallelism over ``model`` on eight gloo ranks on the CPU,
for all ten smoke configs, on two meshes over the same ranks: (data 4,
model 2) and (data 2, model 4).

Each rank holds its parameters in the compute layout
(``distributed/sharding.py::compute_shardings``: the query heads, the
FFN, the RG-LRU and RWKV projections and the vocabulary split where the
model axis divides them) and its rows of the batch, and runs:

* ``forward_train``, ``prefill`` and 4 ``decode_step``s with ``mesh=``:
  the float32 logits (whole on every rank) within 1e-5 of their rms of the
  meshless port's and of the reference's single-device functions (2e-5
  after a decode step, ``DECODE_TOL``) (the
  reference under ``jax.jit``; its weights carried across by
  ``repro_torch.convert.lm_params``);
* one ``make_train_step`` at AdamW's default eps with the ZeRO layout
  (``param_shardings(..., extra_batch_dim=True)``): the loss within 1e-5
  of the meshless step's, and each rank's reduced gradient block, leaf by
  leaf, within 1e-5 of the leaf's largest magnitude plus twice the
  meshless gradient's own movement when every parameter moves by one
  float32 rounding (``ULP``; the ranks compute the same function with
  their sums in another order; RWKV's ``u`` moves by 2.9e-5 of its
  largest magnitude so, chatglm3's leaves by under 2e-6; the embedding's
  gradient is zero on every row no token reads, so its rms lies far below
  its elements) of the same block of the meshless gradient — the split leaves' whole gradients and the whole leaves'
  summed shares alike; then the rank's parameters after the update within
  1e-5 of their rms of the meshless ``opt_update`` given the ranks' blocks
  put together (held in two halves, as ``tests/test_torch_mesh_programs.py``
  holds the data-parallel step: AdamW's first step turns float32 noise in
  a near-zero gradient element into a step of lr).

At model = 4 the smoke configs' 1 or 2 KV heads do not divide the axis,
so each rank computes the one KV head its query heads read from the whole
``wk`` and ``wv``; the leaves that are whole but per channel or per head
(RG-LRU's gates and conv, RWKV's ``u``, decays and group-norm scale) are
sliced on every rank at both sizes. Also, with no process group: the
plan's numbers for the full configs at 16 ranks, and the vocab-parallel
pieces' arithmetic.

All of it runs in one spawn of eight processes
(``test_torch_mesh_programs.start_ranks``), while this process computes
the reference's and the meshless port's results.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward_train as j_forward_train  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.models import (decode_step, forward_train,  # noqa: E402
                                prefill)
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.tree import leaves as _leaves, rebuild  # noqa: E402

from test_torch_mesh_programs import start_ranks  # noqa: E402
from test_torch_models import _port_cfg  # noqa: E402

ALL = sorted(TC.ARCHS)
MESHES = {"d4m2": (4, 2), "d2m4": (2, 4)}
B, T, STEPS, ENC_LEN = 4, 12, 4, 16
CACHE_LEN = T + STEPS
TOL = 1e-5
# a decode step's logits carry the reassociated sums of every step before
# it: qwen3-moe's third step at model 2 sits 1.1e-5 of its rms from the
# meshless port (the meshless port and the reference sit up to 5.3e-6
# apart on these inputs)
DECODE_TOL = 2e-5
# how far a gradient may move when the parameters move by one float32
# rounding: the ranks compute the same function with their sums in
# another order, which moves each activation by about that much
ULP = 2.0 ** -23
OPT = dict(warmup_steps=1)

_J_FORWARD = jax.jit(j_forward_train, static_argnums=2)
_J_PREFILL = jax.jit(j_prefill, static_argnums=(2, 3))
_J_DECODE = jax.jit(j_decode_step, static_argnums=4)

RANK_BODY = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import sharding as S
from repro_torch.models import decode_step, forward_train, param_specs, prefill
from repro_torch.training import optimizer as O
from repro_torch.tree import leaves, tree_map

for key, shape in inputs["meshes"].items():
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    di = mesh.get_local_rank("data")
    for name, case in inputs["cases"].items():
        cfg, whole, batch = case["cfg"], case["params"], case["batch"]
        specs = param_specs(cfg)
        osh = S.compute_shardings(specs, mesh, cfg)
        zsh = S.param_shardings(specs, mesh, cfg, extra_batch_dim=True)
        params = tree_map(lambda t, sh: S.shard_of(t, sh).clone(), whole, osh)
        n = batch["tokens"].shape[0] // shape[0]
        rows = {k: v[di * n:(di + 1) * n] for k, v in batch.items()}
        res = {}
        with torch.no_grad():
            res["forward"] = forward_train(params, rows, cfg, mesh=mesh)
            pre = {k: (v[:, :inputs["T"]] if k == "tokens" else v)
                   for k, v in rows.items() if k != "labels"}
            lg, cache = prefill(params, pre, cfg, inputs["cache_len"],
                                mesh=mesh)
            steps = [lg]
            for j in range(inputs["steps"]):
                lg, cache = decode_step(params, cache,
                                        rows["tokens"][:, inputs["T"] + j],
                                        inputs["T"] + j, cfg, mesh=mesh)
                steps.append(lg)
            res["decode"] = steps
        state = O.opt_init(params, zero_shardings=zsh, out_shardings=osh)
        step = O.make_train_step(cfg, O.OptConfig(**inputs["opt"]),
                                 mesh=mesh, grad_shardings=zsh,
                                 param_out_shardings=osh)
        with O.recorded_reduced() as reduced:
            params, state, m = step(params, state, batch)
        res.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   grads=reduced, params=params,
                   zspec=[z.spec for z in leaves(zsh)],
                   ospec=[o.spec for o in leaves(osh)])
        result[(key, name)] = res

    # one module at a time: its output and the input's gradient share
    from repro_torch.models import attention as MA, model as MM
    from repro_torch.models import recurrent as MR, rwkv as MW
    from repro_torch.models.layers import cross_entropy_sums, mlp_apply
    for mod, case in inputs["modules"].items():
        cfg = inputs["cases"][case["arch"]]["cfg"]
        tp = S.tp_plan(cfg, mesh)
        osh = S.compute_shardings(param_specs(cfg), mesh, cfg)
        whole = inputs["cases"][case["arch"]]["params"]
        local = tree_map(lambda t, sh: S.shard_of(t, sh).clone(), whole, osh)
        blk = tree_map(lambda t: t[0], local["scan"]["pos0"])
        n = case["x"].shape[0] // shape[0]
        rows = slice(di * n, (di + 1) * n)
        x = case["x"][rows].clone().requires_grad_(True)
        with torch.enable_grad():
            if mod == "attention":
                y = MA.attn_train(blk["attn"], x, cfg, "attn", tp=tp)
            elif mod == "mlp":
                y = mlp_apply(blk["ffn"], x, cfg.mlp_kind, tp=tp)
            elif mod == "cross_attention":
                y, _ = MA.cross_attn_train(blk["cross"], x, case["enc"][rows],
                                           cfg, tp)
            elif mod == "rglru":
                y, _ = MR.rglru_train(blk["rec"], x, cfg, tp=tp)
            elif mod == "rwkv_time":
                y, _ = MW.rwkv_time_mix(blk, x, cfg, tp=tp)
            elif mod == "rwkv_channel":
                y, _ = MW.rwkv_channel_mix(blk, x, cfg, tp=tp)
            elif mod == "embed_head_ce":
                h = MM._embed(local, case["tokens"][rows], cfg, tp) + x
                y, _ = cross_entropy_sums(MM._head(local, h, cfg),
                                          case["labels"][rows], tp=tp)
            w = case["w"][0, 0, 0] if mod == "embed_head_ce" \
                else case["w"][rows]
            gx, = torch.autograd.grad((y * w).sum() / shape[1], [x])
        result[(key, mod)] = dict(y=y.detach(), gx=gx)
"""


def _rms(t) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(t, np.float64))))) \
        or 1.0


def _peak(t) -> float:
    """The largest magnitude of ``t``."""
    return float(t.abs().max()) or 1.0


def _apart(got, want) -> float:
    """The largest difference over the rms of ``want``."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor)
                      else want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / _rms(want)


def _case(name):
    """Smoke config ``name``: the reference's weights carried into the
    port and a seeded batch (``np`` arrays under ``"arrays"``)."""
    jcfg = j_get_smoke(name)
    cfg = _port_cfg(jcfg)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    params = lm_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, CACHE_LEN), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :3] = -100
    batch = {"tokens": toks, "labels": labels}
    if cfg.is_encdec:
        batch["enc_input"] = rng.standard_normal(
            (B, ENC_LEN, cfg.d_model)).astype(np.float32)
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, params=params,
                arrays=batch,
                batch={k: torch.from_numpy(v) for k, v in batch.items()})


def _references(case):
    """The reference's and the meshless port's logits and training step
    on ``case``'s weights and batch, added to ``case``."""
    cfg, jcfg, jparams, params = (case[k] for k in ("cfg", "jcfg",
                                                     "jparams", "params"))
    batch = case["arrays"]
    toks = batch["tokens"]
    pre = {k: (v[:, :T] if k == "tokens" else v) for k, v in batch.items()
           if k != "labels"}

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_fwd = np.asarray(_J_FORWARD(jparams, jb, jcfg))
    lg, cache = _J_PREFILL(jparams, {k: jnp.asarray(v) for k, v in
                                     pre.items()}, jcfg, CACHE_LEN)
    ref_dec = [np.asarray(lg)]
    for j in range(STEPS):
        lg, cache = _J_DECODE(jparams, cache, jnp.asarray(toks[:, T + j]),
                              T + j, jcfg)
        ref_dec.append(np.asarray(lg))

    tb = case["batch"]
    tpre = {k: torch.from_numpy(v) for k, v in pre.items()}
    with torch.no_grad():
        fwd = forward_train(params, tb, cfg)
        lg, tcache = prefill(params, tpre, cfg, CACHE_LEN)
        dec = [lg]
        for j in range(STEPS):
            lg, tcache = decode_step(params, tcache, tb["tokens"][:, T + j],
                                     T + j, cfg)
            dec.append(lg)
    _, metrics, grads = TO.loss_and_grads(params, tb, cfg)
    gen = torch.Generator().manual_seed(11)
    moved = rebuild(params, [t * (1 + ULP * torch.randn(
        t.shape, generator=gen)) for t in _leaves(params)])
    _, _, nudged = TO.loss_and_grads(moved, tb, cfg)
    case.update(ref_fwd=ref_fwd, ref_dec=ref_dec, fwd=fwd, dec=dec,
                loss=float(metrics["loss"]), grads=grads, nudged=nudged)


# module → the smoke config whose first block carries it
MODULES = {"attention": "chatglm3-6b", "mlp": "chatglm3-6b",
           "cross_attention": "whisper-tiny", "rglru": "recurrentgemma-9b",
           "rwkv_time": "rwkv6-1.6b", "rwkv_channel": "rwkv6-1.6b",
           "embed_head_ce": "gemma3-12b"}


def _module_inputs(cases):
    """Seeded inputs of each module: x (B, T, d) rows for each data rank,
    the weights of the output's sum, an encoder output, tokens and
    labels."""
    rng = np.random.default_rng(5)
    out = {}
    for mod, arch in MODULES.items():
        d = cases[arch]["cfg"].d_model
        vocab = cases[arch]["cfg"].vocab_size

        def f32(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
        out[mod] = dict(arch=arch, x=f32(B, T, d), w=f32(B, T, d),
                        enc=f32(B, ENC_LEN, d),
                        tokens=torch.from_numpy(rng.integers(
                            0, vocab, (B, T))),
                        labels=torch.from_numpy(rng.integers(
                            0, vocab, (B, T))))
    return out


def _module_meshless(case, params, cfg):
    """The meshless module on the whole batch → (y, the input's
    gradient) of the same loss the ranks take."""
    from repro_torch.models import attention as MA, model as MM
    from repro_torch.models import recurrent as MR, rwkv as MW
    from repro_torch.models.layers import cross_entropy_sums, mlp_apply
    from repro_torch.tree import tree_map
    mod = case["mod"]
    blk = tree_map(lambda t: t[0], params["scan"]["pos0"])
    x = case["x"].clone().requires_grad_(True)
    with torch.enable_grad():
        if mod == "attention":
            y = MA.attn_train(blk["attn"], x, cfg, "attn")
        elif mod == "mlp":
            y = mlp_apply(blk["ffn"], x, cfg.mlp_kind)
        elif mod == "cross_attention":
            y, _ = MA.cross_attn_train(blk["cross"], x, case["enc"], cfg)
        elif mod == "rglru":
            y, _ = MR.rglru_train(blk["rec"], x, cfg)
        elif mod == "rwkv_time":
            y, _ = MW.rwkv_time_mix(blk, x, cfg)
        elif mod == "rwkv_channel":
            y, _ = MW.rwkv_channel_mix(blk, x, cfg)
        else:
            # each row's CE sum: a data rank sums its rows'
            h = MM._embed(params, case["tokens"], cfg) + x
            logits = MM._head(params, h, cfg)
            y = torch.stack([cross_entropy_sums(logits[r:r + 1],
                                                case["labels"][r:r + 1])[0]
                             for r in range(B)])
        w = case["w"][0, 0, 0] if mod == "embed_head_ce" else case["w"]
        gx, = torch.autograd.grad((y * w).sum(), [x])
    return y.detach(), gx


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = {name: _case(name) for name in ALL}
    modules = _module_inputs(cases)
    inputs = dict(
        meshes=MESHES, T=T, cache_len=CACHE_LEN, steps=STEPS, opt=OPT,
        cases={n: {k: c[k] for k in ("cfg", "params", "batch")}
               for n, c in cases.items()}, modules=modules)
    out = tmp_path_factory.mktemp("tp")
    join = start_ranks(8, RANK_BODY, inputs, out)
    for case in cases.values():       # while the ranks run
        _references(case)
    return dict(ranks=join(), cases=cases, modules=modules)


def _coords(key, r):
    n_model = MESHES[key][1]
    return dict(zip(("data", "model"), divmod(r, n_model)))


def _rows(key, r):
    n = B // MESHES[key][0]
    d = _coords(key, r)["data"]
    return slice(d * n, (d + 1) * n)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ALL)
def test_forward_train_logits_match(run, name, key):
    case = run["cases"][name]
    for r, res in enumerate(run["ranks"]):
        got = res[(key, name)]["forward"]
        rows = _rows(key, r)
        assert _apart(got, case["fwd"][rows]) <= TOL, r
        assert _apart(got, case["ref_fwd"][rows]) <= TOL, r


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ALL)
def test_prefill_and_decode_logits_match(run, name, key):
    case = run["cases"][name]
    for r, res in enumerate(run["ranks"]):
        got = res[(key, name)]["decode"]
        rows = _rows(key, r)
        assert len(got) == STEPS + 1
        for j, (g, mine, ref) in enumerate(zip(got, case["dec"],
                                               case["ref_dec"])):
            tol = TOL if j == 0 else DECODE_TOL
            assert _apart(g, mine[rows]) <= tol, (r, j)
            assert _apart(g, ref[rows]) <= tol, (r, j)


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


def _sizes(key):
    return dict(zip(("data", "model"), MESHES[key]))


def _cut(t, spec, coords, sizes):
    """The block of ``t`` at ``coords`` under ``spec`` on a mesh of
    ``sizes``."""
    for d, entry in enumerate(spec):
        axes = S.spec_axes(entry)
        k, n = 0, 1
        for a in axes:
            k, n = k * sizes[a] + coords[a], n * sizes[a]
        if n > 1:
            t = t.chunk(n, dim=d)[k]
    return t


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ALL)
def test_loss_and_reduced_gradient_match(run, name, key):
    """The loss, and each rank's reduced block of every leaf's gradient —
    split leaves (whole gradients of the rank's slice, summed over the
    data ranks) and whole leaves (the ranks' shares summed) alike."""
    case = run["cases"][name]
    sizes = _sizes(key)
    first = run["ranks"][0][(key, name)]
    units = _units(case["params"], case["grads"], first["zspec"])
    nudged = _units(case["params"], case["nudged"], first["zspec"])
    split = sum(any("model" in S.spec_axes(e) for e in o)
                for o in first["ospec"])
    if MESHES[key][1] > 1 and name != "whisper-tiny":
        assert split, "no leaf split over model"
    for r, res in enumerate(run["ranks"]):
        out = res[(key, name)]
        assert abs(out["loss"] - case["loss"]) <= TOL * max(
            1.0, abs(case["loss"]))
        assert len(out["grads"]) == len(units)
        coords = _coords(key, r)
        for i, ((want, spec), got, (near, _)) in enumerate(zip(
                units, out["grads"], nudged)):
            block = _cut(want, spec, coords, sizes)
            assert got.shape == block.shape, (i, spec)
            bound = TOL * _peak(want) + 2 * float((near - want).abs().max())
            assert float((got - block).abs().max()) <= bound, (r, i, spec)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ALL)
def test_adamw_step_matches_meshless_update(run, name, key):
    """At AdamW's default eps: each rank's parameters after the step are
    its compute-layout block of the meshless ``opt_update`` given the
    ranks' reduced blocks put together, and the gradient norm is that
    update's."""
    case = run["cases"][name]
    sizes = _sizes(key)
    params = case["params"]
    first = run["ranks"][0][(key, name)]
    units = _units(params, case["grads"], first["zspec"])
    whole = [torch.zeros_like(g) for g, _ in units]
    for r, res in enumerate(run["ranks"]):
        coords = _coords(key, r)
        for (_, spec), got, acc in zip(units, res[(key, name)]["grads"],
                                       whole):
            _cut(acc, spec, coords, sizes).copy_(got)
    nodes, it = [], iter(whole)
    for _, g, stacked in TO._param_leaves(params, case["grads"]):
        nodes.append(tuple(next(it) for _ in g) if stacked else next(it))
    start = rebuild(params, [x.clone() for x in _leaves(params)])
    want, _, wm = TO.opt_update(TO.OptConfig(**OPT), start,
                                rebuild(params, nodes), TO.opt_init(start))
    for r, res in enumerate(run["ranks"]):
        out = res[(key, name)]
        assert out["grad_norm"] == pytest.approx(float(wm["grad_norm"]),
                                                 rel=1e-5)
        coords = _coords(key, r)
        for got, w, ospec in zip(_leaves(out["params"]), _leaves(want),
                                 out["ospec"]):
            block = _cut(w, ospec, coords, sizes)
            assert got.shape == block.shape, ospec
            assert float((got - block).abs().max()) <= TOL * _rms(w)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("mod", list(MODULES))
def test_split_module_matches_meshless(run, mod, key):
    """Each module's split form on its rank's rows: its output (whole on
    every rank) within 1e-5 of the meshless module's rms, and the input's
    gradient — each rank's share, summed over the model ranks — within
    1e-5 of its largest magnitude; for the vocab-parallel embedding, head
    and cross-entropy the output is the rows' CE sum."""
    case = dict(run["modules"][mod], mod=mod)
    arch = MODULES[mod]
    y, gx = _module_meshless(case, run["cases"][arch]["params"],
                             run["cases"][arch]["cfg"])
    n_data, n_model = MESHES[key]
    n = B // n_data
    ranks = run["ranks"]
    for r, res in enumerate(ranks):
        rows = _rows(key, r)
        got = res[(key, mod)]["y"]
        want = y[rows].sum() if mod == "embed_head_ce" else y[rows]
        assert _apart(got, want) <= TOL, r
    for d in range(n_data):
        share = sum(ranks[d * n_model + m][(key, mod)]["gx"]
                    for m in range(n_model))
        want = gx[d * n:(d + 1) * n]
        assert float((share - want).abs().max()) <= TOL * _peak(want), d


@pytest.mark.parametrize("name", ALL)
def test_plan_at_sixteen_ranks(name):
    """The full configs' plans on a 16-rank model axis: local heads and KV
    heads, one KV head a rank where the KV heads do not divide the axis,
    and the parts that split exactly where their widths divide it."""
    cfg = TC.get_config(name)
    mesh = S.MeshShape((16, 16), ("data", "model"))
    for rank in (0, 5, 15):
        p = S.tp_plan(cfg, mesh, rank=rank)
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        assert p.attn == (hq % 16 == 0 and (hkv % 16 == 0 or 16 % hkv == 0))
        if p.attn:
            assert p.heads * 16 == hq
            g = hq // hkv
            # every local query head reads a KV head the rank computes
            for h in range(rank * p.heads, (rank + 1) * p.heads):
                assert p.kv_first <= h // g < p.kv_first + p.kv_heads
            if not p.kv_split:
                assert p.kv_heads == 1
        else:
            assert (p.heads, p.kv_heads) == (hq, hkv)
        assert p.vocab == (cfg.vocab_size % 16 == 0)
        assert p.ff == (cfg.d_ff % 16 == 0)
    assert S.tp_plan(cfg, S.MeshShape((16, 1), ("data", "model"))) is None


def test_kv_heads_of_granite_and_chatglm3_at_sixteen():
    """granite's one KV head serves every rank; chatglm3's two each serve
    eight ranks; whisper's six heads do not split over 16."""
    mesh = S.MeshShape((16, 16), ("data", "model"))
    granite = [S.tp_plan(TC.get_config("granite-34b"), mesh, rank=r)
               for r in range(16)]
    assert {(p.heads, p.kv_heads, p.kv_first) for p in granite} == {
        (3, 1, 0)}
    glm = [S.tp_plan(TC.get_config("chatglm3-6b"), mesh, rank=r).kv_first
           for r in range(16)]
    assert glm == [0] * 8 + [1] * 8
    assert not S.tp_plan(TC.get_config("whisper-tiny"), mesh, rank=0).attn


def test_compute_layout_of_granite_on_sixteen():
    """Rank 0's share of granite-34b's parameters in the compute layout on
    a 16-rank model axis: the query, FFN and vocabulary leaves split, the
    single KV head's ``wk``/``wv`` whole: about a sixteenth of the
    whole."""
    cfg = TC.get_config("granite-34b")
    from repro_torch.models import param_specs
    specs = param_specs(cfg)
    mesh = S.MeshShape((16, 16), ("data", "model"))
    osh = S.compute_shardings(specs, mesh, cfg)
    whole = local = 0
    for t, sh in zip(_leaves(specs), _leaves(osh)):
        n = 1
        for e in sh.spec:
            n *= 16 if "model" in S.spec_axes(e) else 1
        whole += t.numel()
        local += t.numel() // n
    assert 1 / 16 < local / whole < 1 / 14


def test_vocab_parallel_pieces_without_a_group():
    """A one-rank plan is None, so the meshless path runs; the split
    pieces' arithmetic on a 4-way vocabulary split put together on one
    process: the zero-padded blocks' sum is the whole, and the
    log-sum-exp from the blocks' max and sums is the whole's."""
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32))
    blocks = z.chunk(4, dim=-1)
    m = torch.stack([b.amax(-1) for b in blocks]).amax(0)
    lse = m + torch.log(sum(torch.exp(b - m[..., None]).sum(-1)
                            for b in blocks))
    assert float((lse - torch.logsumexp(z, -1)).abs().max()) <= 1e-6
    padded = sum(torch.nn.functional.pad(b, (8 * i, 8 * (3 - i)))
                 for i, b in enumerate(blocks))
    assert torch.equal(padded, z)
    cfg = dataclasses.replace(TC.get_smoke_config("chatglm3-6b"))
    assert S.tp_plan(cfg, None) is None
