"""The port's logical-axis sharding rules against the JAX reference's, on
the CPU, with no process group: ``DEFAULT_RULES``, ``named_sharding_for``'s
divisibility fallback, and ``param_shardings`` spec for spec for all ten
full configs' ``param_specs`` at four production-shaped meshes (the
reference on a ``jax.sharding.AbstractMesh``, the port on a ``MeshShape``
of the same names and sizes), with ``extra_batch_dim`` and ``moe_fsdp``
on and off and the MoE tables of ``ep`` and ``tp``. A spec is compared as
the tuple of its entries. Also the port's compute layout
(``compute_shardings``) and the spec-to-placement rule.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import param_specs as j_param_specs  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distributed import sharding as TS  # noqa: E402
from repro_torch.models import param_specs  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _flat(tree, path=()):
    """(path, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, path + (str(i),))]
    return [("/".join(path), tree)]


def test_default_rules_match_reference():
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES


@pytest.mark.parametrize("sizes,names", MESHES)
def test_named_sharding_for_matches_reference(sizes, names):
    jm, tm = AbstractMesh(sizes, names), TS.MeshShape(sizes, names)
    for shape, logical in (((7, 8), ("batch", "ff")),
                           ((32, 48), ("batch", "heads")),
                           ((64, 30, 16), ("batch", "seq", "embed")),
                           ((6, 10), (None, "experts"))):
        for rules in (None, {"batch": ("data",)}, {"seq": "model"}):
            want = JS.named_sharding_for(shape, logical, jm, rules)
            got = TS.named_sharding_for(shape, logical, tm, rules)
            assert got.spec == tuple(want.spec), (shape, logical, rules)
    # the fallback: a dimension the axes do not divide stays whole
    got = TS.named_sharding_for((7, 8), ("batch", "ff"), tm)
    assert got.spec[0] is None or 7 % tm.shape["data"] == 0


@pytest.mark.parametrize("sizes,names", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shardings_match_reference(arch, sizes, names):
    jm, tm = AbstractMesh(sizes, names), TS.MeshShape(sizes, names)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jspecs, specs = j_param_specs(jcfg), param_specs(cfg)
    impls = ("ep", "tp") if cfg.is_moe else (cfg.moe_impl,)
    for impl in impls:
        jc = dataclasses.replace(jcfg, moe_impl=impl)
        tc = dataclasses.replace(cfg, moe_impl=impl)
        for extra in (False, True):
            for fsdp in (False, True):
                want = jax.tree_util.tree_flatten_with_path(
                    JS.param_shardings(jspecs, jm, jc, extra_batch_dim=extra,
                                       moe_fsdp=fsdp))[0]
                got = _flat(TS.param_shardings(specs, tm, tc,
                                               extra_batch_dim=extra,
                                               moe_fsdp=fsdp))
                assert len(got) == len(want)
                for (name, g), (_, w) in zip(got, want):
                    assert g.spec == tuple(w.spec), (impl, extra, fsdp, name)


@pytest.mark.parametrize("arch,impl", [("qwen3-moe-235b-a22b", "ep"),
                                       ("mixtral-8x7b", "tp"),
                                       ("chatglm3-6b", "dense")])
def test_compute_shardings_split_only_the_experts(arch, impl):
    """The expert stacks split over ``model`` as ``ep`` or ``tp`` lays them
    out (whole under ``dense``), the router whole; every other leaf that
    splits is a dense one the tensor-parallel plan computes split, at the
    ``model`` entry of the reference's spec and nowhere else."""
    cfg = get_config(arch)
    mesh = TS.MeshShape((2, 16, 16), ("pod", "data", "model"))
    plan = TS.tp_plan(cfg, mesh, rank=0)
    got = dict(_flat(TS.compute_shardings(param_specs(cfg), mesh, cfg,
                                          impl)))
    ref = dict(_flat(TS.param_shardings(param_specs(cfg), mesh,
                                        dataclasses.replace(
                                            cfg, moe_impl=impl)
                                        if cfg.is_moe else cfg)))
    split = {n: s.spec for n, s in got.items() if any(s.spec)}
    experts = {n: s for n, s in split.items() if cfg.is_moe
               and "ffn" in n and n.rsplit("/", 1)[-1] in ("w_gate", "w_up",
                                                          "w_down")}
    assert not any(n.endswith("router") for n in split)
    if impl == "dense" or not cfg.is_moe:
        assert not experts
    else:
        dim = {"ep": 1, "tp": {"w_gate": 3, "w_up": 3, "w_down": 2}}[impl]
        assert experts
        for name, spec in experts.items():
            d = dim if impl == "ep" else dim[name.rsplit("/", 1)[-1]]
            assert spec == tuple("model" if i == d else None
                                 for i in range(len(spec))), name
    for name, spec in split.items():
        want = tuple(e if e is not None and "model" in TS.spec_axes(e)
                     else None for e in ref[name].spec)
        assert spec == want, name
        if name not in experts:
            assert TS._tp_split(name, plan), name
    if not cfg.is_moe:
        assert any(n.endswith("attn/wq") for n in split) == plan.attn
        assert any(n.endswith("ffn/w_down") for n in split) == plan.ff


def test_spec_to_placements_and_constrain_without_context():
    from torch.distributed.tensor import Replicate, Shard

    class FakeMesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 2)
    mesh = FakeMesh()
    assert TS.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.to_placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        TS.to_placements((("data", "pod"),), mesh)
    x = torch.ones(4, 4)
    assert TS.constrain(x, "batch", "embed") is x
    with TS.axis_rules(TS.MeshShape((2, 2), ("data", "model"))):
        assert TS.current_mesh() is not None
        assert TS.constrain(x, "batch", "embed") is x   # a plain tensor
    assert TS.current_mesh() is None
