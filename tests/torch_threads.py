"""Caps torch's CPU threads in a worker of a parallel pytest run.

``pytest -n N`` (xdist) runs N worker processes, and torch opens one
intra-op thread per core in each of them, so N workers put N times the
cores' worth of threads on the cores, spinning against each other.  Each
port test file imports this module, which gives every worker its share of
the cores (at least one thread) when ``PYTEST_XDIST_WORKER_COUNT`` says the
run is parallel; a plain ``pytest`` run keeps torch's default.  Tests that
spawn their own rank processes set those processes' threads themselves
(``torch_tp_ranks.py``).
"""
import os

import torch


def worker_threads() -> int:
    """This worker's share of the cores, or 0 outside a parallel run."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers <= 1:
        return 0
    return max(1, len(os.sched_getaffinity(0)) // workers)


if worker_threads():
    torch.set_num_threads(worker_threads())
