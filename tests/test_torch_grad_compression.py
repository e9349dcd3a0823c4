"""The port's int8 error-feedback compression
(``repro_torch.distributed.grad_compression``) against the JAX reference's,
on the CPU: ``init_error``, ``compress`` and ``decompress`` bit for bit on
seeded draws, .5 ties (rounded half to even) and an all-zero tensor (the
1e-12 floor of the scale); the reference's two properties of
``tests/test_grad_compression.py`` (the int8 range and scale, and the
error feedback's telescoping sum within 1e-4 and 1e-2); and
``ef_allreduce`` on gloo ranks at world 2 (one axis of a (2, 2)
``DeviceMesh``) and world 4 (the whole group), in one spawn of four
processes (``test_torch_mesh_programs.spawn_ranks``). On replicated input
the result is ``decompress(*compress(g, e)[:2])`` bit for bit (scaling by
a power of two commutes with rounding, so n·q·s/n is q·s exactly) and
within the reference's relative 0.02 of ``g``; on distinct inputs it is a
numpy model of the int32 sum times the largest scale over n, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import grad_compression as JG  # noqa: E402

from repro_torch.distributed import grad_compression as TG  # noqa: E402
from test_torch_mesh_programs import spawn_ranks  # noqa: E402


def _inputs(rng):
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                    np.float32)
    return [(rng.standard_normal((64, 32)) * 5).astype(np.float32),
            (rng.standard_normal(1000) * 1e-3).astype(np.float32),
            ties, np.zeros((3, 4), np.float32)]


@pytest.mark.parametrize("case", range(4))
def test_compress_and_decompress_match_reference_bit_for_bit(rng, case):
    g = _inputs(rng)[case]
    for e in (np.zeros_like(g),
              (rng.standard_normal(g.shape) * 1e-2).astype(np.float32)):
        jq, js, je = JG.compress(jnp.asarray(g), jnp.asarray(e))
        q, s, err = TG.compress(torch.from_numpy(g), torch.from_numpy(e))
        assert q.dtype == torch.int8 and s.dtype == err.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert s.item() == float(js)
        assert np.array_equal(err.numpy(), np.asarray(je))
        assert np.array_equal(TG.decompress(q, s).numpy(),
                              np.asarray(JG.decompress(jq, js)))
    q, s, err = TG.compress(torch.from_numpy(g), torch.zeros(g.shape))
    if case == 2:      # scale 1.0: the .5 ties round half to even
        assert q.tolist() == [127, 0, 2, 2, 0, -2, 4, -126]
    if case == 3:      # the floor: scale 1e-12 / 127, every code 0
        assert s.item() == np.float32(np.float32(1e-12) / np.float32(127))
        assert not q.any() and not err.any()
    tree = {"a": torch.from_numpy(g),
            "b": (torch.ones(2, dtype=torch.bfloat16),)}
    zeros = TG.init_error(tree)
    assert zeros["a"].dtype == zeros["b"][0].dtype == torch.float32
    assert not zeros["a"].any() and zeros["b"][0].shape == (2,)


def test_int8_range_and_scale(rng):
    g = torch.from_numpy((rng.standard_normal((64, 32)) * 5).astype(
        np.float32))
    q, scale, _ = TG.compress(g, torch.zeros_like(g))
    assert q.dtype == torch.int8
    assert int(q.abs().max()) <= 127
    rec = TG.decompress(q, scale)
    assert float((rec - g).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_telescopes(rng):
    """Σ decompressed_t + e_T = Σ g_t → long-run unbiasedness."""
    g_seq = [torch.from_numpy(rng.standard_normal((16, 8)).astype(
        np.float32)) for _ in range(20)]
    err = torch.zeros(16, 8)
    total_rec = torch.zeros(16, 8)
    for g in g_seq:
        q, s, err = TG.compress(g, err)
        total_rec = total_rec + TG.decompress(q, s)
    total_true = sum(g_seq)
    assert float((total_rec + err - total_true).abs().max()) < 1e-4
    rel = float(torch.linalg.norm(total_rec - total_true)
                / torch.linalg.norm(total_true))
    assert rel < 1e-2


RANK_BODY = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import grad_compression as G
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
rep, err = inputs["replicated"], inputs["err"]
mine = inputs["distinct"][rank]
zero = G.init_error(mine)
for n, where in ((4, (dist.group.WORLD,)), (2, (mesh, "pod"))):
    result[n, "replicated"] = G.ef_allreduce(rep, err, *where)
    result[n, "distinct"] = G.ef_allreduce(mine, zero, *where)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(7)

    def tree():
        return {"w": torch.from_numpy(rng.standard_normal((16, 16)).astype(
                    np.float32)),
                "b": (torch.from_numpy((rng.standard_normal(33) * 1e-3)
                                       .astype(np.float32)),)}
    rep = tree()
    err = {"w": torch.from_numpy((rng.standard_normal((16, 16)) * 1e-3)
                                 .astype(np.float32)),
           "b": (torch.zeros(33),)}
    inputs = dict(replicated=rep, err=err,
                  distinct=[tree() for _ in range(4)])
    out = spawn_ranks(4, RANK_BODY, inputs, tmp_path_factory.mktemp("ef"))
    return inputs, out


def _flat(tree):
    return [tree["b"][0], tree["w"]]


@pytest.mark.parametrize("n", [2, 4])
def test_ef_allreduce_of_replicated_input_is_the_local_decompress(ranks, n):
    inputs, out = ranks
    for res in out:
        got, new_err = res[n, "replicated"]
        for g, e, o, ne in zip(_flat(inputs["replicated"]),
                               _flat(inputs["err"]), _flat(got),
                               _flat(new_err)):
            q, s, want_err = TG.compress(g, e)
            assert torch.equal(o, TG.decompress(q, s))
            assert torch.equal(ne, want_err)
        w = inputs["replicated"]["w"]
        rel = float(torch.linalg.norm(got["w"] - w) / torch.linalg.norm(w))
        assert rel < 0.02, rel


@pytest.mark.parametrize("n", [2, 4])
def test_ef_allreduce_of_distinct_inputs_matches_numpy_model(ranks, n):
    inputs, out = ranks
    for r, res in enumerate(out):
        # world 4: every rank; world 2: the (2, 2) mesh's pod axis
        peers = range(4) if n == 4 else (r % 2, 2 + r % 2)
        got, _ = res[n, "distinct"]
        for i, o in enumerate(_flat(got)):
            qs = [JG.compress(jnp.asarray(_flat(inputs["distinct"][p])[i]
                                          .numpy()), 0.0) for p in peers]
            summed = np.sum([np.asarray(q).astype(np.int32)
                             for q, _, _ in qs], axis=0, dtype=np.int32)
            s_max = np.float32(max(float(s) for _, s, _ in qs))
            want = summed.astype(np.float32) * s_max / np.float32(n)
            assert np.array_equal(o.numpy(), want)
