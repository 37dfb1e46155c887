"""The port stands alone: it imports neither JAX nor the JAX package."""
import os
import pathlib
import re
import subprocess
import sys

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    src = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=src), timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15                  # every submodule was imported
    assert bad == "[]", bad


def test_no_source_file_names_jax_or_the_reference():
    # "repro_torch" has no word boundary after "repro", so it never matches
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b)", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_router_modules_load_no_jax():
    """The replica router, its check and the placement rules stand alone."""
    probe = ("import sys\n"
             "import repro_torch.runtime.router, repro_torch.runtime.sharded_check\n"
             "import repro_torch.launch.mesh, repro_torch.launch.serve\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(PORT.parent)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
