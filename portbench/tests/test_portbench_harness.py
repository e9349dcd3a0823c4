"""The harness on the CPU at tiny sizes: the result line's shape, a cell,
a configuration, a traffic mix and a metric added by new files alone,
the metric files against ``BENCHMARK.json``, the refusal without a card
or without the program, and (on the card only) a real cell's run."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
sys.path[:0] = [PB, HERE]

import tiny  # noqa: E402
from pbench.harness import main  # noqa: E402
from pbench.spec import Spec  # noqa: E402


def _run(root, cell, capsys, trace=0, seed=987654321012):
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
               "--trace", str(trace)], root=root, device="cpu")
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_result_line_shape(tmp_path, capsys, cell):
    root = tiny.make_root(tmp_path)
    rc, line, err = _run(root, cell, capsys)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err
    assert line["attempted"] >= 1 and line["failed"] == 0
    dev = line["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    spec = Spec(root)
    want = {m["name"] for m in spec.metrics(cell, False)}
    assert set(line["metrics"]) == want and "setup_s" in want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for name, chk in line["checks"].items():
        assert chk["limit"] is None or chk["value"] <= chk["limit"]
        assert f"check {name} " in err
    assert err.rstrip().splitlines()[-1].startswith("check ")


def test_added_by_new_files_alone(tmp_path, capsys):
    """A configuration, a traffic mix, a cell and a per-layer metric that
    only new files and new entries bring are found by name."""
    root = tiny.make_root(tmp_path, cells={})
    pb = root / "portbench"
    port = dict(tiny.TINY["tiny-glm"], name="wide", d_model=96)
    (pb / "configs" / "wide.json").write_text(json.dumps({"port": port}))
    (pb / "traffic" / "short-3x24.json").write_text(json.dumps(
        {"kind": "prefill", "batch": 3, "prompt_len": 24, "cache_len": 32,
         "distinct_prompts": 1}))
    (pb / "workloads" / "wide-short.json").write_text(json.dumps(
        {"trace_calls": 1, "limits": {"logits_rel": 0.05,
                                      "cache_rel": 0.05}}))
    (pb / "metrics" / "calls.prefill.py").write_text(
        'LAYER = "model step"\nUNIT = "calls"\n'
        'MOVES = "prefill_tokens_per_s"\n\n\n'
        'def read(run):\n    return float(len(run.calls))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wide", "source": "tiny",
                             "file": "portbench/configs/wide.json",
                             "reduced": [], "why": "tiny"})
    bench["workloads"] = [{"name": "wide-short", "config": "wide",
                           "traffic": "short-3x24", "chips": 1,
                           "why": "tiny"}]
    for m in bench["end_to_end"]:
        if m["name"] == "prefill_tokens_per_s":
            m["workloads"] = ["wide-short"]
    bench["end_to_end"].append(
        {"name": "calls.prefill", "unit": "calls", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": ["wide-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, _ = _run(root, "wide-short", capsys)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["calls.prefill"]["value"] == line["attempted"]
    assert line["metrics"]["prefill_tokens_per_s"]["value"] > 0


def test_metric_files_agree_with_benchmark():
    spec = Spec()
    for group in ("end_to_end", "per_layer"):
        for m in spec.bench[group]:
            mod = spec.reader(m["name"])
            assert mod.UNIT == m["unit"], m["name"]
            if group == "per_layer":
                assert mod.LAYER == m["layer"], m["name"]
                assert mod.MOVES == m["moves"], m["name"]
                moved = next(e for e in spec.bench["end_to_end"]
                             if e["name"] == m["moves"])
                assert set(m["workloads"]) <= set(
                    moved.get("workloads", m["workloads"]))
    names = {w["name"] for w in spec.bench["workloads"]}
    for w in spec.bench["workloads"]:
        assert spec.cell_file(w["name"])["limits"]
        assert spec.traffic(w["traffic"])["kind"]
    for c in spec.bench["configs"]:
        assert spec.config(c["name"])["port"]
    assert names


def test_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = main(["--workload", "glm-prefill-32k", "--seed", "1", "--seconds",
               "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run fails and prints no result."""
    root = tiny.make_root(tmp_path)
    code = ("import sys; sys.path.insert(0, 'portbench');"
            "from pbench.harness import main;"
            "sys.exit(main(['--workload', 'tiny-glm-prefill', '--seed', '3',"
            " '--seconds', '0.1'], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["glm-prefill-32k", "rwkv-prefill-8k"])
def test_cell_correct_on_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "77", "--seconds", "3", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
