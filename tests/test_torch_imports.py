"""The port imports neither JAX nor the reference package, nor msgpack
(the machine with the card has none): every module of
``src/repro_torch`` must import in a fresh interpreter in which
``import jax``, ``import repro`` and ``import msgpack`` fail."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (SRC / "repro_torch").rglob("*.py"))

PROBE = """
import importlib, sys
for name in ("jax", "jaxlib", "repro", "msgpack"):
    sys.modules[name] = None            # any import of them now fails
failed = []
for mod in sys.argv[1:]:
    try:
        importlib.import_module(mod)
    except Exception as e:
        failed.append(f"{mod}: {type(e).__name__}: {e}")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")
                and sys.modules[m] is not None)
print("\\n".join(failed + [f"loaded {m}" for m in loaded]))
"""


def test_modules_found():
    assert "repro_torch.core.schedule" in MODULES
    assert "repro_torch.launch.tables" in MODULES
    assert "repro_torch.checkpoint.checkpoint" in MODULES
    assert len(MODULES) > 40


def test_every_module_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", PROBE, *MODULES],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=SRC.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize("blocked", ["jax", "repro", "msgpack"])
def test_probe_catches_an_import(blocked, tmp_path):
    """The probe fails a module that imports a blocked package."""
    (tmp_path / "leaky.py").write_text(f"import {blocked}\n")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{SRC}"}
    out = subprocess.run([sys.executable, "-c", PROBE, "leaky"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert "leaky: ImportError" in out.stdout or \
        "leaky: ModuleNotFoundError" in out.stdout, out.stdout
