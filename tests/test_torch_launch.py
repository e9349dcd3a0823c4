"""The port's ``launch/`` against the reference's, on the CPU.

* ``launch/specs.py::build_cell`` against the reference's ``build_cell``,
  spec for spec, for every arch × shape on the single-pod mesh, plain and
  ``optimized`` (Megatron-SP, ZeRO-3 of the MoE experts), and a multi-pod
  sample: the argument trees' shapes and dtypes, every input sharding,
  ``meta``, ``tokens_per_step``, ``mode``, ``donate`` and the skip
  reason. The reference's cells are built in one subprocess with 512
  placeholder host devices (``XLA_FLAGS``, set before JAX starts); the
  port's on a ``MeshShape`` of the same names and sizes.
* ``launch/cost.py``'s product flops of ``loss_fn`` on three smoke configs
  at (B, T) = (2, 64) against ``repro.launch.hlo_analysis.analyze_hlo`` of
  the reference's compiled ``loss_fn``, within 5 %, as
  ``tests/test_hlo_analysis.py`` holds the reference's own loop-aware
  count; attention is counted in the reference's convention (every query
  against every key). Doubling the depth doubles the layer flops.
* ``launch/dryrun.py::run_cell`` on a train and a prefill production cell
  (in a subprocess: its default group is the ``fake`` backend at 256
  ranks) writes a record with ``fits_hbm`` and a dominant term, and so
  does ``run_cell(..., optimized=True)`` on mixtral-8x7b's train cell (at
  2 of its 32 layers), whose Megatron-SP exits are reduce-scatters and
  whose expert gathers all-gathers, as the fake group reports them, and
  on its decode cell; the train cell stores 1/256 of the experts a rank
  (ZeRO-3 over the 16 data ranks, beside the 16 of ``model``).
* K4's and K4′'s fake implementations: fake CUDA tensors under
  ``FakeTensorMode`` and ``meta`` tensors launch nothing and come out in
  the right shapes.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed.sharding import MeshShape  # noqa: E402
from repro_torch.kernels.attn import attn as A  # noqa: E402
from repro_torch.launch import cost, specs  # noqa: E402
from repro_torch.models import loss_fn, param_specs  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE = [(a, s) for a, s in specs.all_cells()]
MULTI = [("granite-34b", "train_4k"), ("qwen3-moe-235b-a22b", "decode_32k"),
         ("rwkv6-1.6b", "long_500k"), ("whisper-tiny", "prefill_32k")]

REFERENCE = """
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.launch import specs

def flat(tree):
    return jax.tree_util.tree_leaves(tree)

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

devs = np.array(jax.devices())
meshes = {"single": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
          "multi": Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}
out = {}
for mesh_name, arch, shape, opt in json.loads(sys.argv[1]):
    cell = specs.build_cell(arch, shape, meshes[mesh_name], optimized=opt)
    out[f"{mesh_name}/{arch}/{shape}/{opt}"] = dict(
        mode=cell.mode, skipped=cell.skipped,
        tokens_per_step=cell.tokens_per_step, meta=cell.meta,
        donate=list(cell.donate),
        args=[[list(x.shape), str(x.dtype)] for x in flat(cell.args)],
        shardings=[spec(s) for s in flat(cell.in_shardings)])
json.dump(out, open(sys.argv[2], "w"))
"""


@pytest.fixture(scope="module")
def reference_cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("cells") / "cells.json"
    todo = [("single", a, s, o) for a, s in SINGLE for o in (False, True)] \
        + [("multi", a, s, False) for a, s in MULTI]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", REFERENCE,
                           json.dumps(todo), str(path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(path.read_text())


def _spec(entry):
    return [list(e) if isinstance(e, tuple) else e for e in entry]


def _port_cell(mesh_name, arch, shape, optimized):
    mesh = MeshShape((16, 16), ("data", "model")) if mesh_name == "single" \
        else MeshShape((2, 16, 16), ("pod", "data", "model"))
    cell = specs.build_cell(arch, shape, mesh, optimized=optimized)
    return dict(
        mode=cell.mode, skipped=cell.skipped,
        tokens_per_step=cell.tokens_per_step, meta=cell.meta,
        donate=list(cell.donate),
        args=[[list(x.shape), str(x.dtype).replace("torch.", "")]
              for x in leaves(cell.args)],
        shardings=[_spec(s.spec) for s in leaves(cell.in_shardings)])


@pytest.mark.parametrize("mesh_name,arch,shape,optimized",
                         [("single", a, s, o) for a, s in SINGLE
                          for o in (False, True)]
                         + [("multi", a, s, False) for a, s in MULTI])
def test_build_cell_matches_reference(reference_cells, mesh_name, arch,
                                      shape, optimized):
    want = reference_cells[f"{mesh_name}/{arch}/{shape}/{optimized}"]
    got = _port_cell(mesh_name, arch, shape, optimized)
    for key in ("mode", "skipped", "tokens_per_step", "meta", "donate"):
        assert got[key] == want[key], key
    assert got["args"] == want["args"]
    assert len(got["shardings"]) == len(want["shardings"])
    for i, (g, w) in enumerate(zip(got["shardings"], want["shardings"])):
        assert g == w, i


# --- product flops against the reference's HLO analysis --------------------

def _reference_flops(jcfg, b, t):
    params = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))
    batch = {"tokens": jax.ShapeDtypeStruct((b, t), jax.numpy.int32),
             "labels": jax.ShapeDtypeStruct((b, t), jax.numpy.int32)}
    if jcfg.is_encdec:
        batch["enc_input"] = jax.ShapeDtypeStruct((b, 32, jcfg.d_model),
                                                  jax.numpy.float32)

    def fn(p, bt):
        return j_loss_fn(p, bt, jcfg)[0]
    return analyze_hlo(jax.jit(fn).lower(params, batch).compile().as_text())


def _port_cost(cfg, b, t):
    params = param_specs(cfg)
    tok = torch.empty((b, t), dtype=torch.int32, device="meta")
    batch = {"tokens": tok, "labels": tok}
    if cfg.is_encdec:
        batch["enc_input"] = torch.empty((b, 32, cfg.d_model),
                                         device="meta")
    with torch.no_grad():
        _, c = cost.count(loss_fn, params, batch, cfg, track=(params,))
    return c


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "recurrentgemma-9b",
                                  "chatglm3-6b"])
def test_product_flops_match_the_reference_hlo(arch):
    jcfg = j_get_smoke(arch)
    cfg = get_smoke_config(arch)
    want = _reference_flops(jcfg, 2, 64).dot_flops
    got = _port_cost(cfg, 2, 64).flops
    assert want > 0
    assert abs(got - want) / want < 0.05, (got, want)


def test_doubling_depth_doubles_the_layer_flops():
    """granite's smoke config at 6 and 12 layers, and at 0 layers' worth
    (the embedding and head alone, from 2·F(6) − F(12))."""
    base = dataclasses.replace(get_smoke_config("granite-34b"), n_layers=6)
    f6 = _port_cost(base, 2, 64).flops
    f12 = _port_cost(dataclasses.replace(base, n_layers=12), 2, 64).flops
    f3 = _port_cost(dataclasses.replace(base, n_layers=3), 2, 64).flops
    outside = 2 * f6 - f12
    assert outside > 0
    assert (f12 - outside) == pytest.approx(2 * (f6 - outside), rel=1e-9)
    assert (f6 - outside) == pytest.approx(2 * (f3 - outside), rel=1e-9)


def test_cost_counts_storages_and_collectives_on_meta_tensors():
    """A (4, 8) @ (8, 16) product and its backward: flops 2·(2·4·8·16),
    product bytes the operands and outputs, the peak the arguments plus
    the live activations; a freed temporary leaves the live count."""
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, 16, device="meta", requires_grad=True)

    def step():
        y = x @ w
        tmp = torch.empty(1 << 20, device="meta")
        del tmp
        g, = torch.autograd.grad((y * y).sum(), [w])
        return g
    g, c = cost.count(step, track=(x, w))
    assert g.shape == w.shape
    assert c.argument_bytes == (32 + 128) * 4
    assert c.flops == 2 * 2 * 4 * 8 * 16
    assert c.peak_bytes >= c.argument_bytes + (1 << 22)
    assert not c.collective_bytes


# --- the dry run on production cells ----------------------------------------

RUN = """
import json, sys
from repro_torch.launch import dryrun
recs = [dryrun.run_cell(a, s, multi_pod=False, out_dir=sys.argv[2],
                        optimized=o)
        for a, s, o in json.loads(sys.argv[1])]
json.dump(recs, open(sys.argv[2] + "/all.json", "w"), default=float)
"""


def test_run_cell_writes_production_records(tmp_path):
    cells = [("whisper-tiny", "train_4k", False),
             ("chatglm3-6b", "prefill_32k", False),
             ("granite-34b", "long_500k", False)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN),
                           json.dumps(cells), str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = json.loads((tmp_path / "all.json").read_text())
    for rec in recs[:2]:
        assert "error" not in rec, rec.get("traceback")
        assert rec["devices"] == 256
        assert isinstance(rec["memory"]["fits_hbm"], bool)
        assert rec["memory"]["fits_hbm"]
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                               "collective_s")
        assert rec["per_device"]["dot_flops"] > 0
        assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
        assert "all-reduce" in rec["per_device"]["collective_counts"]
        assert (tmp_path / f"{rec['arch']}__{rec['shape']}__single.json") \
            .exists()
    assert recs[0]["mode"] == "train" and recs[1]["mode"] == "prefill"
    assert "reduce-scatter" in recs[0]["per_device"]["collective_counts"]
    assert recs[2]["skipped"].startswith("pure full attention")


# ``run_cell(..., optimized=True)`` on [arch, shape, layers]: a cell whose
# layers are given is counted at that depth (the config's widths, fewer
# layers), so that a train cell's 16 microbatches trace in seconds
RUN_OPT = """
import dataclasses, json, sys
from repro_torch import configs
from repro_torch.launch import dryrun, specs
whole = configs.get_config
recs = []
for a, s, layers in json.loads(sys.argv[1]):
    def cut(arch, layers=layers):
        cfg = whole(arch)
        return dataclasses.replace(cfg, n_layers=layers) if layers else cfg
    configs.get_config = specs.get_config = cut
    recs.append(dryrun.run_cell(a, s, multi_pod=False, out_dir=sys.argv[2],
                                optimized=True))
json.dump(recs, open(sys.argv[2] + "/all.json", "w"), default=float)
"""


def _expert_bytes(shardings, p_specs, sizes) -> tuple[int, int]:
    """(one rank's bytes, the whole's) of the expert stacks of ``p_specs``
    laid out as ``shardings`` on a mesh of axis ``sizes``."""
    mine = whole = 0
    for leaf in ("w_gate", "w_up", "w_down"):
        t = p_specs["scan"]["pos0"]["ffn"][leaf]
        n = int(np.prod([sizes[a] for e in shardings["scan"]["pos0"]["ffn"][
            leaf].spec for a in S.spec_axes(e)]))
        whole += t.numel() * t.element_size()
        mine += t.numel() * t.element_size() // n
    return mine, whole


def test_run_cell_writes_optimized_records(tmp_path):
    """``run_cell(..., optimized=True)`` on mixtral-8x7b: its train_4k cell
    (counted at 2 of its 32 layers) with Megatron-SP (its exits
    reduce-scatters, its entries all-gathers), the experts stored split
    over the data axes (ZeRO-3: 1/256 of them a rank, gathered a layer at
    a time) and the bf16 accumulator; its decode_32k cell, whole, with
    the cache split by sequence. Each record fits the card and says which
    layout it counted."""
    sizes = {"data": 16, "model": 16}
    mesh = MeshShape((16, 16), ("data", "model"))
    cfg = get_config("mixtral-8x7b")
    cell = specs.build_cell("mixtral-8x7b", "train_4k", mesh, optimized=True)
    p_specs = param_specs(cfg)
    stored = S.compute_shardings(p_specs, mesh, cfg, cell.meta["moe_impl"],
                                 moe_fsdp=True, rules=cell.rules)
    mine, whole = _expert_bytes(stored, p_specs, sizes)
    assert mine * 256 == whole and whole == 3 * 8 * 4096 * 14336 * 32 * 2
    plain = S.compute_shardings(p_specs, mesh, cfg, cell.meta["moe_impl"])
    assert _expert_bytes(plain, p_specs, sizes)[0] == 16 * mine

    cells = [("mixtral-8x7b", "train_4k", 2),
             ("mixtral-8x7b", "decode_32k", None)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(RUN_OPT),
                           json.dumps(cells), str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    train, dec = json.loads((tmp_path / "all.json").read_text())
    for rec in (train, dec):
        assert "error" not in rec, rec.get("traceback")
        assert rec["optimized"] and rec["meta"]["optimized"]
        assert "optimized" in rec["meta"]["layout"]
        assert rec["memory"]["fits_hbm"]
        assert (tmp_path / f"{rec['arch']}__{rec['shape']}__single__opt"
                           ".json").exists()
    assert train["meta"]["moe_impl"] == "tp"
    assert train["meta"]["n_microbatches"] == 16
    counts = train["per_device"]["collective_counts"]
    assert counts["reduce-scatter"] > 0 and counts["all-gather"] > 0
    # the two layers' parameters and moments a rank: the experts' 1/256
    # (bf16, two float32 moments) beside the dense leaves' shards
    cut = dataclasses.replace(cfg, n_layers=2)
    cut_specs = param_specs(cut)
    cut_mine, _ = _expert_bytes(
        S.compute_shardings(cut_specs, mesh, cut, "tp", moe_fsdp=True,
                            rules=cell.rules), cut_specs, sizes)
    assert train["memory"]["argument_bytes"] >= 5 * cut_mine
    assert dec["per_device"]["collective_counts"]["all-gather"] > 0
    assert dec["meta"]["moe_impl"] == "tp"


# --- K4's and K4′'s fake implementations -----------------------------------

def test_k4_fake_path_launches_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode
    A.FLASH_KERNEL.launches = 0
    A.FLASH_BWD_KERNEL.launches = 0
    with FakeTensorMode():
        q = torch.empty(2, 40, 8, 128, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(2, 40, 2, 128, device="cuda", dtype=torch.bfloat16)
        out = A.flash_attention_fwd(q, k, k, causal=True)
        assert out.shape == q.shape and out.device.type == "cuda"
        o2, lse = torch.ops.repro_torch.flash_attn_fwd(q, k, k, True, True)
        assert o2.shape == q.shape and lse.shape == (2, 8, 40)
        assert lse.dtype == torch.float32
        dq, dk, dv = A.flash_attention_bwd(q, k, k, out, out, lse=lse)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert A.FLASH_KERNEL.launches == 0
    assert A.FLASH_BWD_KERNEL.launches == 0
    # meta tensors, through autograd: the fake forward and backward
    q = torch.empty(2, 40, 8, 128, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty(2, 40, 2, 128, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    out = A.flash_attention_fwd(q, k, k)
    gq, gk = torch.autograd.grad(out.float().sum(), [q, k])
    assert gq.shape == q.shape and gk.shape == k.shape
    assert A.FLASH_KERNEL.launches == 0 and A.FLASH_BWD_KERNEL.launches == 0


def test_k4_flop_formula_counts_every_query_against_every_key():
    q = torch.empty(2, 40, 8, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty(2, 56, 2, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    one = 2 * 2 * 8 * 40 * 56 * 64
    for causal in (True, False):
        def step():
            out = A.flash_attention_fwd(q, k, k, causal=causal)
            return torch.autograd.grad(out.float().sum(), [q, k])
        _, c = cost.count(step)
        assert c.flops == 7 * one
    assert A.scratch_bytes("flash_attn_bwd", q, k, k, q, q, None, True) > 0
    assert np.isfinite(c.product_bytes)
