"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither jax nor any module of the JAX package ``repro``.

It runs in a subprocess because this test process has jax loaded already
(tests/conftest.py imports it).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
ROOT_FILES = [Path(__file__).resolve().parents[1] / "chip_smoke.py"]

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "ml_dtypes"))
             or k == "repro" or k.startswith("repro."))
print(len(names), bad)
"""


def test_import_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         env=env, cwd=str(SRC.parent), timeout=120, check=True).stdout
    n, bad = out.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", out


def test_sources_import_no_jax_and_no_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|repro)(\s|\.|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + ROOT_FILES
    assert len(files) > 20
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, f"{f}: {hits}"
