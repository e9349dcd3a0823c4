"""The reference's ``optimized`` cells and its sequence-split decode cache
in the port, on eight gloo ranks on the CPU, for the ten smoke configs.

* Megatron-SP (``rules`` with ``seq_sp`` → ``model``) on (data 4,
  model 2) and (data 2, model 4) meshes: ``forward_train``'s logits within
  1e-5 of their rms of the meshless port's, and one ZeRO train step: the
  loss within 1e-5, each rank's reduced gradient block, leaf by leaf,
  within ``tests/test_torch_tensor_parallel.py``'s bound of the meshless
  gradient's block (1e-5 of its largest magnitude plus twice its movement
  when every parameter moves by one float32 rounding: the ranks sum in
  another order) and within ``tests/test_torch_train.py``'s 5e-5 of its
  largest magnitude of the block of ``jax.value_and_grad`` of the
  reference's ``loss_fn`` on one device (the meshless port's own distance
  to it).
* ZeRO-3 of the MoE experts: the optimized train step of both MoE configs
  as ``launch/specs.py::build_cell(optimized=True)`` builds it (the
  experts stored split over the data axes, ``qwen3`` in its ``ep`` form,
  ``mixtral`` in ``tp`` with ``psum_late``, Megatron-SP on, the moments in
  the ZeRO layout, the parameters written back to their storage layout)
  on a (2, 2) mesh (a slice of a (2, 2, 2) mesh) and on (2, 4): the loss
  within 1e-5, each rank's expert blocks 1/(data ranks) of the compute
  layout's, the reduced gradient blocks as above, the moments within 1e-5
  of their largest magnitude and the parameters within 1e-5 of their rms
  of the meshless ``opt_update`` given the ranks' blocks put together (as
  the tensor-parallel test holds them). The configs' capacity factor is
  E / top-k, so that no bucket drops a token and the capacity forms
  compute the dense form the meshless step runs.
* The sequence-split decode cache (``seq_kv``): a prefill of T = 12 and
  decode steps on both meshes, the cache every KV head for the rank's
  block of the slots: at ``cache_len`` 16 five steps (the ring of 16
  wraps at position 16, and the full caches' step at position 16 lies
  past their end: the clamp), at 18 four (18 does not split over 4: the
  caches stay whole there), and ``long_500k``'s layout (``seq_kv`` →
  (``data``, ``model``), the batch whole) at a batch of 1 on (2, 4). The
  logits within 1e-5 of their rms of the meshless port's (2e-5 after a
  decode step, ``DECODE_TOL``), and at 16 of the reference's
  ``prefill``/``decode_step`` under ``jax.jit``.
* The dense MoE's split forms over ``model``: the reference's ``_MOE_TP``
  (hidden units) and ``_MOE_EP`` (experts) slices within 1e-5 of their
  rms of ``_moe_dense`` of the whole stacks.
* The gloo forms of the collectives: the gather as a sum of zero-padded
  blocks and the reduce-scatter as a sum then a block, against the true
  collectives on the same inputs (bit for bit: sums with zeros are exact,
  and the scatter's sums are the same sums).

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
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.models import (decode_step, forward_train,  # noqa: E402
                                init_params)
from repro_torch.models import moe as TM, prefill  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.tree import leaves as _leaves, rebuild  # noqa: E402

from test_torch_mesh_programs import start_ranks  # noqa: E402
from test_torch_models import _port_cfg  # noqa: E402
from test_torch_tensor_parallel import (DECODE_TOL, ULP, _apart,  # noqa: E402
                                        _cut, _peak, _rms, _units)

ALL = sorted(TC.ARCHS)
MOE = ("mixtral-8x7b", "qwen3-moe-235b-a22b")
MESHES = {"d4m2": (4, 2), "d2m4": (2, 4)}
ZERO3 = {"z22": (2, 2), "z24": (2, 4)}
B, T, ENC_LEN = 4, 12, 16
TOL = 1e-5
# the meshless port's distance to the reference (tests/test_torch_train.py)
REF_GRAD_TOL = 5e-5
OPT = dict(warmup_steps=1)
# (rules, cache_len, decode steps, rows): "main" wraps the ring and clamps
# the full caches at its last step; "odd" does not split over 4 ranks;
# "long" is long_500k's layout at a batch of 1
DECODE = {
    "main": ({"seq_kv": "model"}, 16, 5, B),
    "odd": ({"seq_kv": "model"}, 18, 4, B),
    "long": ({"batch": None, "seq_kv": ("data", "model")}, 16, 5, 1),
}
SP_RULES = {"seq_sp": "model"}
OPT_RULES = {"seq_sp": "model", "fsdp": ("pod", "data")}

_J_GRAD = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True),
                  static_argnums=2)
_J_PREFILL = jax.jit(j_prefill, static_argnums=(2, 3))
_J_DECODE = jax.jit(j_decode_step, static_argnums=4)

RANK_BODY = """
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.models import decode_step, forward_train, param_specs, prefill
from repro_torch.models import moe as M
from repro_torch.training import optimizer as O
from repro_torch.tree import leaves, tree_map


def cut(whole, osh):
    return tree_map(lambda t, sh: S.shard_of(t, sh).clone(), whole, osh)


def kv_shapes(tree, name=None):
    # the (slots, heads) of every KV cache leaf of ``tree``
    if isinstance(tree, dict):
        return [s for k, v in tree.items() for s in kv_shapes(v, k)]
    if isinstance(tree, (tuple, list)):
        return [s for v in tree for s in kv_shapes(v, name)]
    return [tuple(tree.shape[-3:-1])] if name in ("k", "v") else []


def rows_of(batch, mesh, n_rows):
    di, nd = mesh.get_local_rank("data"), mesh.size(0)
    k = n_rows // nd
    return {k_: v[di * k:(di + 1) * k] for k_, v in batch.items()}


def train_step(cfg, mesh, params, osh, zsh, batch, rules, **kw):
    state = O.opt_init(params, zero_shardings=zsh, out_shardings=osh)
    step = O.make_train_step(cfg, O.OptConfig(**inputs["opt"]), mesh=mesh,
                             grad_shardings=zsh, param_out_shardings=osh,
                             rules=rules, **kw)
    with O.recorded_reduced() as reduced:
        params, state, m = step(params, state, batch)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                grads=reduced, params=params, m=state["m"],
                zspec=[z.spec for z in leaves(zsh)],
                ospec=[o.spec for o in leaves(osh)],
                coords={a: mesh.get_local_rank(a)
                        for a in mesh.mesh_dim_names})


meshes = {k: init_device_mesh("cpu", s, mesh_dim_names=("data", "model"))
          for k, s in inputs["meshes"].items()}
for key, mesh in meshes.items():
    for name, case in inputs["cases"].items():
        cfg, whole, batch = case["cfg"], case["params"], case["batch"]
        full = case["full"]
        specs = param_specs(cfg)
        osh = S.compute_shardings(specs, mesh, cfg)
        zsh = S.param_shardings(specs, mesh, cfg, extra_batch_dim=True)
        params = cut(whole, osh)
        rows = rows_of(batch, mesh, batch["tokens"].shape[0])
        res = {}
        with torch.no_grad():
            res["forward"] = forward_train(params, rows, cfg, mesh=mesh,
                                           rules=inputs["sp_rules"])
            for var, (rules, cache_len, steps, n_rows) in \\
                    inputs["decode"].items():
                if "data" in S.spec_axes(rules["seq_kv"]) and key != "d2m4":
                    continue
                sub = rows_of(full, mesh, n_rows) \\
                    if n_rows == full["tokens"].shape[0] else \\
                    {k: v[:n_rows] for k, v in full.items()}
                pre = {k: (v[:, :inputs["T"]] if k == "tokens" else v)
                       for k, v in sub.items() if k != "labels"}
                enc = inputs["enc_len"] if cfg.is_encdec else 0
                lg, cache = prefill(params, pre, cfg, cache_len, mesh=mesh,
                                    rules=rules)
                logits = [lg]
                for j in range(steps):
                    lg, cache = decode_step(
                        params, cache, sub["tokens"][:, inputs["T"] + j],
                        inputs["T"] + j, cfg, mesh=mesh, rules=rules,
                        cache_len=cache_len, enc_len=enc)
                    logits.append(lg)
                res[var] = logits
                res[var + "_kv"] = sorted(set(kv_shapes(cache)))
        res["train"] = train_step(cfg, mesh, params, osh, zsh, batch,
                                  inputs["sp_rules"])
        result[(key, name)] = res

# ZeRO-3 of the experts: the optimized step on (2, 2) and (2, 4)
rep = init_device_mesh("cpu", (2, 2, 2),
                       mesh_dim_names=("rep", "data", "model"))
zmeshes = {"z22": rep["data", "model"], "z24": meshes["d2m4"]}
for key, mesh in zmeshes.items():
    for name, case in inputs["zero3"].items():
        cfg, whole, batch = case["cfg"], case["params"], case["batch"]
        specs = param_specs(cfg)
        rules = inputs["opt_rules"]
        osh = S.compute_shardings(specs, mesh, cfg, moe_fsdp=True,
                                  rules=rules)
        zsh = S.param_shardings(specs, mesh, cfg, rules,
                                extra_batch_dim=True, moe_fsdp=True)
        params = cut(whole, osh)
        res = train_step(cfg, mesh, params, osh, zsh, batch, rules,
                         accum_dtype=torch.bfloat16)
        res["expert_numel"] = sum(
            params["scan"]["pos0"]["ffn"][k].numel()
            for k in ("w_gate", "w_up", "w_down"))
        result[(key, name)] = res

# the dense MoE's split forms, and the collectives' two forms
mesh = meshes["d2m4"]
for key, case in inputs["dense_moe"].items():
    msh = S.compute_shardings({"ffn": case["params"]}, mesh,
                              case["cfg"])["ffn"]
    local = {k: S.shard_of(v, msh[k]).clone()
             for k, v in case["params"].items()}
    result[("dense", key)] = dict(
        y=M.moe_apply(local, case["x"], case["cfg"], impl="dense",
                      mesh=mesh),
        shape=tuple(local["w_gate"].shape))
g = mesh.get_group("model")
x = inputs["coll"][mesh.get_rank()]
result["coll"] = {
    form: dict(gather=C._gather(x, g, 1, sums=form),
               scatter=C._scatter_sum(x, g, 1, sums=form))
    for form in (True, False)}
"""


def _to_jax(node):
    """The reference's parameter tree of the port's ``node``: the same
    keys, tuples and leaves (``convert.lm_params`` the other way), each
    leaf an array of the tensor's type."""
    if isinstance(node, dict):
        return {k: _to_jax(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_to_jax(v) for v in node)
    if node.dtype == torch.bfloat16:
        return jnp.asarray(node.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(node.numpy())


def _case(name, moe_impl=None):
    """Smoke config ``name`` (an MoE one in the form ``moe_impl``, with
    room for every assignment): the port's seeded weights (its
    ``init_params``, which draws in seconds what the reference's eager
    init takes 15 s for), the same carried into the reference, and a
    seeded batch of B rows of ``T + 6`` tokens."""
    jcfg = j_get_smoke(name)
    if moe_impl:
        jcfg = dataclasses.replace(
            jcfg, moe_impl=moe_impl, moe_psum_late=moe_impl == "tp",
            capacity_factor=jcfg.n_experts / jcfg.top_k)
    cfg = _port_cfg(jcfg)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jparams = _to_jax(params)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 6), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :3] = -100
    arrays = {"tokens": toks[:, :T], "labels": labels[:, :T]}
    full = {"tokens": toks}
    if cfg.is_encdec:
        arrays["enc_input"] = full["enc_input"] = rng.standard_normal(
            (B, ENC_LEN, cfg.d_model)).astype(np.float32)
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, params=params,
                arrays=arrays, full=full,
                batch={k: torch.from_numpy(v) for k, v in arrays.items()},
                decode_batch={k: torch.from_numpy(v)
                              for k, v in full.items()})


def _train_refs(case):
    """The meshless port's logits and gradient (and its movement under a
    one-ulp nudge) and the reference's gradient, added to ``case``."""
    cfg, params, tb = case["cfg"], case["params"], case["batch"]
    with torch.no_grad():
        case["fwd"] = forward_train(params, tb, cfg)
    loss, _, grads = TO.loss_and_grads(params, tb, cfg)
    gen = torch.Generator().manual_seed(11)
    moved = rebuild(params, [t * (1 + ULP * torch.randn(
        t.shape, generator=gen)) for t in _leaves(params)])
    _, _, nudged = TO.loss_and_grads(moved, tb, cfg)
    case.update(loss=float(loss), grads=grads, nudged=nudged)


def _reference_grads(case):
    (jloss, _), jgrads = _J_GRAD(case["jparams"], {
        k: jnp.asarray(v) for k, v in case["arrays"].items()}, case["jcfg"])
    case["ref_loss"] = float(jloss)
    case["ref_grads"] = lm_params(jax.tree.map(np.asarray, jgrads),
                                  case["cfg"], "cpu")


def _decode_refs(case):
    """The meshless port's prefill and decode logits of every variant, and
    the reference's of ``main``."""
    cfg, params = case["cfg"], case["params"]
    full = case["decode_batch"]
    case["dec"] = {}
    for var, (_, cache_len, steps, n_rows) in DECODE.items():
        sub = {k: v[:n_rows] for k, v in full.items()}
        pre = {k: (v[:, :T] if k == "tokens" else v) for k, v in sub.items()}
        with torch.no_grad():
            lg, c = prefill(params, pre, cfg, cache_len)
            out = [lg]
            for j in range(steps):
                lg, c = decode_step(params, c, sub["tokens"][:, T + j],
                                    T + j, cfg)
                out.append(lg)
        case["dec"][var] = out
    _, cache_len, steps, _ = DECODE["main"]
    pre = {k: jnp.asarray(v[:, :T] if k == "tokens" else v)
           for k, v in case["full"].items()}
    lg, c = _J_PREFILL(case["jparams"], pre, case["jcfg"], cache_len)
    ref = [np.asarray(lg)]
    for j in range(steps):
        lg, c = _J_DECODE(case["jparams"], c,
                          jnp.asarray(case["full"]["tokens"][:, T + j]),
                          T + j, case["jcfg"])
        ref.append(np.asarray(lg))
    case["ref_dec"] = ref


def _dense_moe_inputs():
    """The two dense-form slices: mixtral's smoke config in ``tp`` (the
    hidden units split) and qwen3's in ``ep`` (the experts split), with a
    seeded (2, 5, d) input."""
    rng = np.random.default_rng(3)
    out = {}
    for name, impl in (("mixtral-8x7b", "tp"), ("qwen3-moe-235b-a22b", "ep")):
        cfg = dataclasses.replace(TC.get_smoke_config(name), moe_impl=impl)
        gen = torch.Generator().manual_seed(5)
        params = TM.moe_init(gen, cfg, device="cpu")
        x = torch.from_numpy(rng.standard_normal(
            (2, 5, cfg.d_model)).astype(np.float32))
        out[impl] = dict(cfg=cfg, params=params, x=x)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cases = {name: _case(name) for name in ALL}
    zero3 = {name: _case(name, "ep" if "qwen3" in name else "tp")
             for name in MOE}
    dense = _dense_moe_inputs()
    rng = np.random.default_rng(13)
    coll = [torch.from_numpy(rng.standard_normal((2, 8, 3)).astype(
        np.float32)) for _ in range(8)]
    inputs = dict(
        meshes=MESHES, T=T, enc_len=ENC_LEN, opt=OPT, decode=DECODE,
        sp_rules=SP_RULES, opt_rules=OPT_RULES,
        cases={n: dict(cfg=c["cfg"], params=c["params"], batch=c["batch"],
                       full=c["decode_batch"]) for n, c in cases.items()},
        zero3={n: dict(cfg=c["cfg"], params=c["params"], batch=c["batch"])
               for n, c in zero3.items()},
        dense_moe=dense, coll=coll)
    out = tmp_path_factory.mktemp("sp")
    join = start_ranks(8, RANK_BODY, inputs, out)
    for case in cases.values():       # while the ranks run
        _train_refs(case)
        _reference_grads(case)
        _decode_refs(case)
    for case in zero3.values():
        _train_refs(case)
    return dict(ranks=join(), cases=cases, zero3=zero3, dense=dense,
                coll=coll)


def _coords(key, r):
    sizes = dict(zip(("data", "model"), MESHES[key]))
    return dict(zip(("data", "model"), divmod(r, sizes["model"])))


def _rows(key, r, n_rows=B):
    if n_rows != B:
        return slice(0, n_rows)
    n = B // MESHES[key][0]
    d = _coords(key, r)["data"]
    return slice(d * n, (d + 1) * n)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ALL)
def test_sp_forward_logits_match(run, name, key):
    case = run["cases"][name]
    for r, res in enumerate(run["ranks"]):
        got = res[(key, name)]["forward"]
        assert _apart(got, case["fwd"][_rows(key, r)]) <= TOL, r


def _check_gradient(res, case, sizes, ref=True):
    """Each reduced gradient block of ``res`` against the meshless port's
    (and the reference's) same block."""
    params = case["params"]
    units = _units(params, case["grads"], res["zspec"])
    nudged = _units(params, case["nudged"], res["zspec"])
    refs = _units(params, case["ref_grads"], res["zspec"]) if ref \
        else [(None, None)] * len(units)
    assert len(res["grads"]) == len(units)
    for i, ((want, spec), got, (near, _), (jw, _)) in enumerate(zip(
            units, res["grads"], nudged, refs)):
        block = _cut(want, spec, res["coords"], sizes)
        assert got.shape == block.shape, (i, spec)
        bound = TOL * _peak(want) + 2 * float((near - want).abs().max())
        assert float((got - block).abs().max()) <= bound, (i, spec)
        if jw is not None:
            jb = _cut(jw, spec, res["coords"], sizes)
            assert float((got - jb).abs().max()) <= REF_GRAD_TOL * _peak(
                jw), (i, spec)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("name", ALL)
def test_sp_loss_and_reduced_gradient_match(run, name, key):
    """The SP step's loss, and each rank's reduced block of every leaf's
    gradient, against the meshless port's and the reference's."""
    case = run["cases"][name]
    sizes = dict(zip(("data", "model"), MESHES[key]))
    for res in (r[(key, name)]["train"] for r in run["ranks"]):
        assert abs(res["loss"] - case["loss"]) <= TOL * max(
            1.0, abs(case["loss"]))
        assert abs(res["loss"] - case["ref_loss"]) <= TOL * max(
            1.0, abs(case["ref_loss"]))
        _check_gradient(res, case, sizes)


def _assembled_update(case, results, sizes):
    """The meshless ``opt_update`` of the ranks' reduced blocks (their
    ``results``) put together → (params, state, metrics)."""
    params = case["params"]
    units = _units(params, case["grads"], results[0]["zspec"])
    whole = [torch.zeros_like(g) for g, _ in units]
    for res in results:
        for (_, spec), got, acc in zip(units, res["grads"], whole):
            _cut(acc, spec, res["coords"], sizes).copy_(got)
    nodes, it = [], iter(whole)
    for _, g, stacked in TO._param_leaves(params, case["grads"]):
        nodes.append(tuple(next(it) for _ in g) if stacked else next(it))
    start = rebuild(params, [x.clone() for x in _leaves(params)])
    state = TO.opt_init(start)
    want, state, wm = TO.opt_update(TO.OptConfig(**OPT), start,
                                    rebuild(params, nodes), state)
    return want, state, wm


@pytest.mark.parametrize("key", list(ZERO3))
@pytest.mark.parametrize("name", MOE)
def test_zero3_optimized_step_matches_meshless(run, name, key):
    """The optimized step's loss, gradient blocks, moments and parameters;
    each rank stores 1/(data ranks) of its compute layout's experts."""
    case = run["zero3"][name]
    n_data, n_model = ZERO3[key]
    sizes = {"data": n_data, "model": n_model}
    # on (2, 2) the ranks 0-3 of the (2, 2, 2) mesh's first slice; 4-7
    # compute the same on the second
    results = [r[(key, name)] for r in run["ranks"]][:n_data * n_model]
    cfg = case["cfg"]
    whole = 3 * cfg.n_experts * cfg.d_model * cfg.d_expert * cfg.n_repeats
    want, state, wm = _assembled_update(case, results, sizes)
    for res in results:
        assert res["expert_numel"] * n_data * n_model == whole
        assert abs(res["loss"] - case["loss"]) <= TOL * max(
            1.0, abs(case["loss"]))
        assert res["grad_norm"] == pytest.approx(float(wm["grad_norm"]),
                                                 rel=1e-5)
        _check_gradient(res, case, sizes, ref=False)
        for got, w, spec in zip(_leaves(res["params"]), _leaves(want),
                                res["ospec"]):
            block = _cut(w, spec, res["coords"], sizes)
            assert got.shape == block.shape, spec
            assert float((got - block).abs().max()) <= TOL * _rms(w)
        for got, w, spec in zip(_leaves(res["m"]), _leaves(state["m"]),
                                res["zspec"]):
            block = _cut(w, spec, res["coords"], sizes)
            assert got.shape == block.shape, spec
            assert float((got - block).abs().max()) <= TOL * _peak(w)


# long_500k's layout runs on the (2, 4) mesh alone
DECODE_CASES = [(k, v) for k in MESHES for v in DECODE
                if v != "long" or k == "d2m4"]


@pytest.mark.parametrize("key,var", DECODE_CASES)
@pytest.mark.parametrize("name", ALL)
def test_seq_split_decode_matches(run, name, key, var):
    """Prefill and decode over the sequence-split cache against the
    meshless port's (and at ``main`` the reference's); each rank's cache
    holds its block of the slots, whole where the axes do not divide."""
    rules, cache_len, steps, n_rows = DECODE[var]
    axes = S.spec_axes(rules["seq_kv"])
    case = run["cases"][name]
    sizes = dict(zip(("data", "model"), MESHES[key]))
    n = int(np.prod([sizes[a] for a in axes]))
    for r, res in enumerate(run["ranks"]):
        out = res[(key, name)]
        got = out[var]
        rows = _rows(key, r, n_rows)
        assert len(got) == steps + 1
        for j, (g, mine) in enumerate(zip(got, case["dec"][var])):
            tol = TOL if j == 0 else DECODE_TOL
            assert _apart(g, mine[rows]) <= tol, (r, j)
            if var == "main":
                assert _apart(g, case["ref_dec"][j][rows]) <= tol, (r, j)
        cfg = case["cfg"]
        kinds = set(cfg.block_pattern) | set(cfg.remainder_kinds)
        lengths = {cache_len if k == "attn" else min(cfg.window, cache_len)
                   for k in kinds if k in ("attn", "local")}
        if cfg.is_encdec:
            lengths.add(ENC_LEN)
        want = {(length // n if length % n == 0 else length, cfg.n_kv_heads)
                for length in lengths}
        assert set(out[var + "_kv"]) == want, (r, out[var + "_kv"])


@pytest.mark.parametrize("impl", ["tp", "ep"])
def test_dense_moe_split_forms_match_dense(run, impl):
    case = run["dense"][impl]
    cfg = case["cfg"]
    want = TM._moe_dense(case["params"], case["x"], cfg)
    for res in run["ranks"]:
        out = res[("dense", impl)]
        e, _, f = out["shape"]
        assert (e, f) == ((cfg.n_experts, cfg.d_expert // 4) if impl == "tp"
                          else (cfg.n_experts // 4, cfg.d_expert))
        assert _apart(out["y"], want) <= TOL


def test_gloo_forms_of_the_collectives_match(run):
    """On each rank of the (2, 4) mesh's model groups: the gather and the
    reduce-scatter by sums equal the true collectives bit for bit, and
    the gather is the concatenation of the group's blocks."""
    coll = run["coll"]
    for r, res in enumerate(run["ranks"]):
        for op in ("gather", "scatter"):
            assert torch.equal(res["coll"][True][op],
                               res["coll"][False][op]), (r, op)
        group = range((r // 4) * 4, (r // 4) * 4 + 4)
        assert torch.equal(res["coll"][True]["gather"],
                           torch.cat([coll[q] for q in group], dim=1))
        total = sum(coll[q] for q in group)
        m = r % 4
        assert float((res["coll"][True]["scatter"]
                      - total[:, 2 * m:2 * m + 2]).abs().max()) <= 1e-6


def test_sp_raises_where_the_sequence_does_not_split():
    """Megatron-SP needs T divisible by the model axis: the check runs
    before any collective, on a named-shape mesh."""
    cfg = TC.get_smoke_config("chatglm3-6b")
    mesh = S.MeshShape((2, 4), ("data", "model"))

    class Ranked(S.MeshShape):
        def get_local_rank(self, axis):
            return 0
    ranked = Ranked(mesh.sizes, mesh.names)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="does not"):
        forward_train(params, {"tokens": torch.zeros((1, 6),
                                                     dtype=torch.long)},
                      cfg, mesh=ranked, rules=SP_RULES)
