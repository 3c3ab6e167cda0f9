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
ROOT_FILES = [Path(__file__).resolve().parents[1] / "chip_smoke.py",
              Path(__file__).resolve().parent / "torch_dp_ranks.py",
              Path(__file__).resolve().parent / "torch_control_ranks.py",
              Path(__file__).resolve().parent / "torch_train_ranks.py"]

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "ml_dtypes"))
             or k == "repro" or k.startswith("repro."))
tp = {"repro_torch.core.collectives", "repro_torch.core.sync_policy", "repro_torch.launch.mesh"}
control = {"repro_torch.runtime.faults", "repro_torch.runtime.overload",
           "repro_torch.launch.frontend", "repro_torch.runtime.control"}
from repro_torch.core import collectives
from repro_torch.launch import mesh
from repro_torch.runtime import kvcache, scheduler
data = all((collectives.data_all_reduce, collectives.data_all_gather, collectives.data_send,
            mesh.split_data_shards, kvcache.pool_block_bytes, scheduler.DisaggScheduler))
train = {"repro_torch.training." + m for m in ("data", "optimizer", "loss", "train_loop",
                                               "zero", "checkpoint")} | {"repro_torch.launch.train"}
print(len(names), "repro_torch.runtime.drafter" in names and tp | control | train <= set(names)
      and data, bad)
"""


def test_import_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         env=env, cwd=str(SRC.parent), timeout=120, check=True).stdout
    n, drafter, bad = out.split(" ", 2)
    # the drafter is the port's own copy of repro.runtime.drafter; the
    # tensor-parallel modules (collectives, sync policy, mesh), the serving
    # control plane (faults, overload, the HTTP frontend, the round
    # records of a world of ranks) and the data
    # axis (its collectives, the pool split, the migration unit, the
    # disaggregated scheduler) and the training path (its data, optimizer,
    # loss, step, ZeRO-1, checkpoints and driver) load too
    assert int(n) >= 20 and drafter == "True" and bad.strip() == "[]", out


def test_sources_import_no_jax_and_no_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|repro)(\s|\.|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + ROOT_FILES
    assert len(files) > 20
    for f in files:
        hits = pattern.findall(f.read_text())
        assert not hits, f"{f}: {hits}"
