"""The plain references against the program at tiny sizes on the CPU: in
float32 they agree to rounding, which shows the two compute the same
function; and the control (the reference in fp8 in the program's place)
fails each cell's check by that cell's own limits."""

import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
sys.path[:0] = [PB, HERE]

import tiny  # noqa: E402
from pbench import loops  # noqa: E402
from pbench.harness import port_config  # noqa: E402
from pbench.spec import Spec  # noqa: E402


def _loop(root, cell, seed, **port):
    spec = Spec(root)
    w = spec.workload(cell)
    c = dict(spec.config(w["config"])["port"], **port)
    tr = spec.traffic(w["traffic"])
    d = loops.KINDS[tr["kind"]](c, port_config(c), tr, seed, "cpu")
    d.setup()
    return d, spec.cell_file(cell)["limits"]


def _answers(d, calls=3):
    for i in range(calls):
        d.call(i)
    ans = d.answers()
    d.release()
    return ans


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_reference_is_the_programs_function_in_float32(tmp_path, cell):
    root = tiny.make_root(tmp_path)
    d, _ = _loop(root, cell, 31, param_dtype="float32")
    ans = _answers(d)
    nums = d.compare(ans, d.reference("f32", ans))
    for name, v in nums.items():
        assert v <= (0.0 if name == "past_changed" else 2e-4), (name, v)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_fails_the_check(tmp_path, cell, seed):
    root = tiny.make_root(tmp_path)
    d, limits = _loop(root, cell, seed)
    ans = _answers(d)
    ref = d.reference("f32", ans)
    ok = d.compare(ans, ref)
    assert all(limits[k] is None or v <= limits[k]
               for k, v in ok.items()), ok
    low = d.compare(d.reference("fp8", {"tokens": ans.get("tokens")}), ref)
    assert any(limits[k] is not None and v > limits[k]
               for k, v in low.items()), low


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r);"
            "import pbench.reference.transformer, pbench.reference.rwkv6,"
            " pbench.reference.train, pbench.weights, pbench.yardstick;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % PB)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout))
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_harness_loads_no_jax(tmp_path):
    """A whole run (tiny, on the CPU) in a fresh process: the modules it
    loaded, compared by whole top-level name, hold no JAX and not the JAX
    package (``repro_torch`` begins with ``repro`` and is allowed)."""
    root = tiny.make_root(tmp_path)
    code = ("import sys; sys.path[:0] = [%r, %r];"
            "from pbench.harness import main;"
            "rc = main(['--workload', 'tiny-glm-decode', '--seed', '4',"
            " '--seconds', '0.1'], root=%r, device='cpu');"
            "print(sorted({m.split('.')[0] for m in sys.modules}));"
            "sys.exit(rc)" % (os.path.join(os.path.dirname(PB), "src"), PB,
                              str(root)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & {"repro", "jax", "jaxlib", "flax"}
    assert torch is not None
