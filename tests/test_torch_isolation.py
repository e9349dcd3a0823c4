"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package ``repro``, so it runs where only PyTorch is installed."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("")
                           .parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_every_port_module_imports_with_jax_and_repro_blocked():
    mods = _modules()
    assert "repro_torch.serving.multicell" in mods
    prog = textwrap.dedent(f"""
        import importlib, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        for name in list(sys.modules):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                del sys.modules[name]
        sys.meta_path.insert(0, Block())
        for m in {mods!r}:
            importlib.import_module(m)
        bad = [n for n in sys.modules
               if n.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("ok", len({mods!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


_IMPORT = re.compile(
    r"^\s*(?:import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)\b)",
    re.M)


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted(PORT.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    text = path.read_text()
    assert not _IMPORT.search(text), _IMPORT.search(text).group(0)
    assert "import_module(\"repro." not in text
