"""The port's examples (``repro_torch.examples``) on the CPU against the
reference's ``examples/``, run in the same test:

* ``quickstart``: the printed table and decisions equal the reference's
  (the port's device solve against the reference's numpy oracle);
* ``slicing_demo``: the slicing decisions (admitted, z, alloc, expected
  latency and accuracy) and the compressed frame sizes equal the
  reference's (task ids aside); the slice metrics' p50 latencies are not
  compared (the reference's own runs differ there: they depend on the
  timing of the run);
* ``train_lm --steps 40`` on the smoke config, with and without
  ``--full-attention``: the loss falls, and the first three losses are the
  reference's ``train`` on the same initial weights (the reference's
  ``init_params`` carried in by ``repro_torch.convert.lm_params``) within
  1e-4;
* ``serve_edge --device cpu --ticks 1`` (the smoke LM and chatglm3-6b's);
* with no card, each example raises unless given ``--device cpu``.
"""

import dataclasses
import importlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.training import TrainLoopConfig as JLoop  # noqa: E402
from repro.training import train as j_train  # noqa: E402

from repro_torch.convert import lm_params  # noqa: E402
from repro_torch.examples import (quickstart, serve_edge,  # noqa: E402
                                  slicing_demo, train_lm)
from repro_torch.training import train_loop  # noqa: E402

EXAMPLES = ("quickstart", "slicing_demo", "serve_edge", "train_lm")


def _reference(name, capsys):
    mod = importlib.import_module(f"examples.{name}")
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def test_quickstart_prints_the_reference_decisions(capsys):
    want = _reference("quickstart", capsys)
    sols = quickstart.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert sorted(sols) == sorted(quickstart.ALGORITHMS)


def test_slicing_demo_decides_as_the_reference(capsys):
    """Task ids are not compared: each package numbers its tasks from a
    process-wide counter, which earlier tests in the process advance."""
    def masked(text):
        return re.sub(r"task \d+:", "task #:", text)
    want = _reference("slicing_demo", capsys)
    slicing_demo.main(["--device", "cpu"])
    got = capsys.readouterr().out
    cut, gcut = want.index("slice metrics:"), got.index("slice metrics:")
    assert masked(got[:gcut]) == masked(want[:cut])
    assert got[gcut:].count("meets=True") == want[cut:].count("meets=True")


@pytest.mark.parametrize("full", [False, True],
                         ids=["local", "full_attention"])
def test_train_lm_learns_and_starts_as_the_reference(tmp_path, monkeypatch,
                                                     full):
    jcfg = j_get_smoke("h2o-danube-3-4b")
    if full:
        jcfg = dataclasses.replace(jcfg, window=None, block_pattern=("attn",))
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    monkeypatch.setattr(train_loop, "init_params", lambda gen, cfg, dev:
                        lm_params(jax.tree.map(np.asarray, jparams), cfg,
                                  dev))
    argv = ["--device", "cpu", "--steps", "40",
            "--ckpt-dir", str(tmp_path / "port")]
    out = train_lm.main(argv + (["--full-attention"] if full else []))
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 40 and out["final_loss"] < losses[0]
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    ref = j_train(jcfg, JLoop(total_steps=3, global_batch=8, seq_len=64,
                              log_every=100,
                              checkpoint_dir=str(tmp_path / "ref")))
    want = [h["loss"] for h in ref["history"]]
    assert np.abs(np.array(losses[:3]) - np.array(want)).max() <= 1e-4


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "chatglm3-6b"])
def test_serve_edge_runs_on_the_cpu(capsys, arch):
    engine = serve_edge.main(["--device", "cpu", "--ticks", "1",
                              "--arch", arch])
    out = capsys.readouterr().out
    assert out.count("admitted=True") == 4
    assert all(m["jobs_done"] > 0 for m in engine.metrics().values())


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_a_card_unless_told_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the examples run on it")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--steps", "1"] if name == "train_lm" else [])
