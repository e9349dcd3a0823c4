"""The port's train loop and what it stands on, against the JAX reference,
on the CPU: ``TokenStream`` batches, the ``Checkpointer``'s contract (the
mirrors of ``tests/test_checkpoint.py``), a reference checkpoint restored
by the port, crash and restart, ``StepClock`` and ``ElasticMesh``, and the
launcher ``python -m repro_torch.launch.train --smoke --device cpu``.

Numpy draws are seeded in each test; the loop runs the h2o-danube-3-4b
smoke config (float32), whose restart must land on the uninterrupted run's
final loss within the reference's rel 1e-4 (on the CPU it does so bit for
bit, and the test holds that too).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenStream as JTokenStream  # noqa: E402
from repro.runtime import fault_tolerance as JF  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.runtime import fault_tolerance as TF  # noqa: E402
from repro_torch.training import TrainLoopConfig, train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,step,host,n_hosts", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 12, 1, 2), (11, 5, 3, 4)])
def test_token_stream_matches_reference(seed, step, host, n_hosts):
    kw = dict(global_batch=8, seq_len=33, vocab_size=512, seed=seed,
              n_hosts=n_hosts, host_id=host)
    got = TokenStream(DataConfig(**kw)).batch(step)
    want = JTokenStream(JDataConfig(**kw)).batch(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    assert DataConfig(**kw).host_batch == JDataConfig(**kw).host_batch


def _state(rng):
    return {"a": torch.from_numpy(rng.standard_normal((4, 5)).astype(
                np.float32)),
            "b": {"c": torch.arange(7, dtype=torch.int32),
                  "h": torch.from_numpy(rng.standard_normal(6).astype(
                      np.float32)).bfloat16()},
            "t": (torch.zeros((), dtype=torch.int32),
                  torch.ones(2, 3))}


def test_roundtrip(tmp_path):
    """Every leaf back with its type and shape, bit for bit: float32,
    int32, a 0-d leaf in a tuple, and bfloat16 (stored widened to float32,
    named in the manifest)."""
    state = _state(np.random.default_rng(0))
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state, blocking=True)
    assert ck.list_steps() == [3]
    got = ck.restore(3, state)
    for g, w in zip(_leaves(got), _leaves(state)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert isinstance(got["t"], tuple)
    with open(tmp_path / "step_000000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["n_leaves"] == 5
    assert manifest["dtypes"] == ["float32", "int32", "bfloat16", "int32",
                                  "float32"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_leaf_order_is_the_references(tmp_path):
    """``leaf<i>`` of the port's npz is leaf i of the reference's flattening
    of the same tree (dict keys sorted, tuples in order)."""
    state = _state(np.random.default_rng(1))
    Checkpointer(str(tmp_path)).save(1, state, blocking=True)
    jleaves = jax.tree_util.tree_leaves(jax.tree.map(
        lambda t: np.asarray(t.float()), state))
    with np.load(tmp_path / "step_000000001" / "host0.npz") as data:
        for i, want in enumerate(jleaves):
            a = data[f"leaf{i}"]
            if a.dtype == np.uint16:        # bf16 patterns
                a = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16).float().numpy()
            assert np.array_equal(a.astype(np.float32), want)


def test_gc_keeps_last(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        ck.save(s, state, blocking=True)
    assert ck.list_steps() == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    # a crash mid-save leaves a dir without manifest.json
    os.makedirs(tmp_path / "step_000000009")
    assert ck.list_steps() == []
    assert ck.restore_latest({"x": torch.zeros(1)}) is None


def test_inflight_save_visible_to_new_instance(tmp_path):
    """A fresh Checkpointer on the same dir (the restart path) must drain the
    previous instance's async writer before reading — otherwise a crash right
    after a non-blocking save resumes from an older step."""
    state = {"x": torch.arange(1 << 16, dtype=torch.float32)}
    ck = Checkpointer(str(tmp_path))
    ck.save(7, state, blocking=False)         # do NOT wait — commit in flight
    fresh = Checkpointer(str(tmp_path))       # simulated restart
    restored = fresh.restore_latest(state)
    assert restored is not None
    step, got = restored
    assert step == 7
    assert torch.equal(got["x"], state["x"])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A float32 checkpoint the reference's Checkpointer wrote (its
    manifest names no dtypes) restores in the port's, leaf for leaf."""
    rng = np.random.default_rng(2)
    state = {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                        "rem": (rng.standard_normal(5).astype(np.float32),)},
             "opt": {"step": np.int32(4),
                     "m": rng.standard_normal((3, 4)).astype(np.float32)}}
    JCheckpointer(str(tmp_path)).save(5, state, blocking=True)
    like = jax.tree.map(lambda a: torch.zeros(np.shape(a), dtype=getattr(
        torch, np.asarray(a).dtype.name)), state)
    step, got = Checkpointer(str(tmp_path)).restore_latest(like)
    assert step == 5
    for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(state)):
        assert g.dtype == getattr(torch, np.asarray(w).dtype.name)
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_port_bf16_checkpoint_restores_in_the_reference(tmp_path):
    """A bfloat16 leaf the port saved restores in the reference's
    Checkpointer (``data[leaf].astype(like.dtype)``) to its values, not its
    bit patterns, and the port's own round trip stays bit for bit."""
    import jax.numpy as jnp
    w = (torch.arange(1, 7) / 3).reshape(2, 3).bfloat16()
    state = {"w": w, "n": torch.tensor(3, dtype=torch.int32)}
    Checkpointer(str(tmp_path)).save(2, state, blocking=True)
    like = {"w": jnp.zeros((2, 3), jnp.bfloat16), "n": jnp.int32(0)}
    step, got = JCheckpointer(str(tmp_path)).restore_latest(like)
    assert step == 2
    assert got["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(got["w"], np.float32),
                          w.float().numpy())
    assert np.allclose(np.asarray(got["w"], np.float32),
                       np.arange(1, 7).reshape(2, 3) / 3, rtol=2 ** -8)
    assert int(got["n"]) == 3
    mine = Checkpointer(str(tmp_path)).restore(2, state)
    assert mine["w"].dtype == torch.bfloat16
    assert torch.equal(mine["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(mine["n"], state["n"])


def _loop(d, **kw):
    kw = dict(dict(total_steps=8, checkpoint_every=4, log_every=100,
                   global_batch=4, seq_len=32), **kw)
    return TrainLoopConfig(checkpoint_dir=str(d), **kw)


def test_crash_restart_resumes_identically(tmp_path, capsys):
    """Train 8 steps; crash at 6 after a checkpoint at 4; the restart
    restores step 5 (saved as ``step + 1``), steps from there, and lands on
    the uninterrupted run's final loss (the reference's rel 1e-4; on the
    CPU bit for bit) with the same parameters."""
    cfg = get_smoke_config("h2o-danube-3-4b")
    ref = train(cfg, _loop(tmp_path / "ref"), device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        train(cfg, _loop(tmp_path / "ft"), device="cpu", inject_failure_at=6)
    resumed = train(cfg, _loop(tmp_path / "ft"), device="cpu")
    assert "[train] restored checkpoint at step 5" in capsys.readouterr().out
    assert [h["step"] for h in resumed["history"]] == [5, 6, 7]
    assert resumed["final_loss"] == pytest.approx(ref["final_loss"],
                                                  rel=1e-4)
    assert resumed["final_loss"] == ref["final_loss"]
    for a, b in zip(_leaves(resumed["params"]), _leaves(ref["params"])):
        assert torch.equal(a, b)
    assert Checkpointer(str(tmp_path / "ft")).list_steps() == [5, 8]


def test_train_loop_history_and_microbatches(tmp_path):
    """The history carries loss, lr, grad_norm and the step time each
    step; the loss is finite; two microbatches give the one-batch loss
    within 1e-5 on the first step (the same weights)."""
    cfg = get_smoke_config("chatglm3-6b")
    one = train(cfg, _loop(tmp_path / "a", total_steps=2, seed=1),
                device="cpu")
    two = train(cfg, _loop(tmp_path / "b", total_steps=2, seed=1,
                           n_microbatches=2), device="cpu")
    for h in one["history"]:
        assert {"step", "loss", "lr", "grad_norm", "step_time_s"} <= set(h)
        assert np.isfinite(h["loss"]) and h["step_time_s"] > 0
    assert two["history"][0]["loss"] == pytest.approx(
        one["history"][0]["loss"], abs=1e-5)
    assert two["history"][0]["grad_norm"] == pytest.approx(
        one["history"][0]["grad_norm"], rel=1e-5)


def test_train_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(get_smoke_config("chatglm3-6b"), _loop(tmp_path))


def test_step_clock_matches_reference(monkeypatch):
    """``StepClock`` stamps heartbeats and straggler records as the
    reference's does, on the same step durations."""
    # both modules read the one ``time.time``: each clock's four steps
    # take 1, 1, 5 and 1 s
    assert TF.time is JF.time
    times = iter([0.0, 1.0, 1.0, 2.0, 2.0, 7.0, 7.0, 8.0] * 2)
    monkeypatch.setattr(TF.time, "time", lambda: next(times))
    clocks = []
    for mod in (TF, JF):
        hb, st = mod.HeartbeatMonitor(2), mod.StragglerMitigator(2)
        clock = mod.StepClock(1, hb, st)
        for _ in range(4):
            with clock:
                pass
        clocks.append((clock.step, hb.last_seen, hb.step, st.ewma,
                       st.flagged, hb.dead_hosts()))
    assert clocks[0] == clocks[1]
    assert clocks[0][4] == {1: 1}          # the 5 s step is a straggler


@pytest.mark.parametrize("alive,batch", [(8, 64), (7, 64), (3, 48), (1, 8),
                                         (5, 30)])
def test_elastic_mesh_matches_reference(alive, batch):
    for model, chips in ((4, 4), (8, 4), (2, 8)):
        assert TF.ElasticMesh(model, chips).plan(alive, batch) \
            == JF.ElasticMesh(model, chips).plan(alive, batch)


def test_launcher_trains_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu --steps 4``
    trains the default arch and reports a finite final loss."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("[train] done; final loss")
    assert np.isfinite(float(last.split()[-1]))
    assert Checkpointer(str(tmp_path)).list_steps() == [4]
