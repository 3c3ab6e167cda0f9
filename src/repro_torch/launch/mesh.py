"""Tensor-parallel ranks over ``torch.distributed`` (``repro.launch.mesh``
for the model axis; the data axis, ``dp``, is not ported).

Each rank is one process running the same program on its shard
(``models/model.py``).  ``init_tp`` joins the group through a ``file://``
store, so concurrent runs (test workers) never race for a port; ``spawn``
starts the ranks with the ``spawn`` start method and returns what each
rank's function returned.

Backends are chosen, never switched: ``nccl`` needs one card a rank and
raises, naming ``gloo``, when there are fewer cards than ranks; ``gloo``
puts rank r on ``cuda:r % device_count`` (so ranks may share one card) or
on the CPU, and stages CUDA tensors through host memory
(``core/collectives.py``).  A wall time taken with ranks sharing a card is
no tensor-parallel speed.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as tdist

from repro_torch.models.common import Dist

BACKENDS = ("nccl", "gloo")
TIMEOUT = datetime.timedelta(minutes=10)


def check_backend(tp: int, backend: str, device: str) -> None:
    """Raise where ``backend`` cannot run ``tp`` ranks on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"dist backend {backend!r} not in {BACKENDS}")
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if device != "cuda" or n < tp:
            raise RuntimeError(f"nccl runs one rank a card: {tp} ranks, {n} cards on "
                               f"{device!r}; use --dist-backend gloo to share a card "
                               "(host-staged collectives) or to run on the CPU")


def rank_device(rank: int, backend: str, device: str = "cuda") -> torch.device:
    """The device of ``rank``: ``cuda:rank`` under nccl; under gloo
    ``cuda:rank % device_count``, or the CPU when ``device`` is "cpu"."""
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the plain versions")
    return torch.device("cuda", rank if backend == "nccl" else rank % n)


def init_tp(tp: int, rank: int, backend: str, init_file: str, device: str = "cuda") -> Dist:
    """Join the ``tp``-rank group as ``rank`` through the store file
    ``init_file`` (the same path for every rank); -> this rank's Dist.  The
    rank's card becomes its current device."""
    check_backend(tp, backend, device)
    dev = rank_device(rank, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:   # ranks on the CPU share its cores: each takes its share of threads
        torch.set_num_threads(max(1, torch.get_num_threads() // tp))
    tdist.init_process_group(backend, init_method=f"file://{init_file}", world_size=tp,
                             rank=rank, timeout=TIMEOUT)
    return Dist(tp=tp, rank=rank, group=tdist.group.WORLD, backend=backend)


def _rank_main(rank: int, fn: Callable, tp: int, backend: str, device: str, workdir: str,
               args: tuple) -> None:
    dist = init_tp(tp, rank, backend, os.path.join(workdir, "store"), device)
    try:
        out = fn(dist, rank_device(rank, backend, device), *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        tdist.destroy_process_group()


def spawn(fn: Callable, tp: int, *args, backend: str = "gloo", device: str = "cuda") -> List[Any]:
    """Run ``fn(dist, device, *args)`` on ``tp`` ranks, each a process of
    the ``spawn`` start method (``fn`` and ``args`` are pickled: a function
    of a module, plain data); -> every rank's return value, in rank order.
    A rank that raises ends the others and raises here.  Build the CUDA
    kernels before (``kernels.build.build_all``): each rank would build its
    own copy."""
    check_backend(tp, backend, device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_tp_") as workdir:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, tp, backend, device, workdir, args), nprocs=tp,
            join=True, start_method="spawn")
        out = []
        for r in range(tp):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))     # written by this call's own ranks
        return out
