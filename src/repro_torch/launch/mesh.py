"""The ranks of a ``dp`` x ``tp`` world over ``torch.distributed``
(``repro.launch.mesh``: its model and data axes, ``split_data_shards``).

Each rank is one process running the same program on its shard
(``models/model.py``): world rank ``d * tp + t`` is model rank ``t`` of
data replica ``d``.  Each replica's ``tp`` ranks form its model group (the
tensor-parallel collectives); the ``dp`` ranks of one model index form its
data group (the data axis: the sampled tokens gathered, the KV cache's
log-sum-exp merge, KV-block migration); a gloo group of the whole world
carries the serving control plane's round records from world rank 0
(``core/collectives.control_broadcast``).  ``init_tp`` joins the world and
its groups through a ``file://`` store, so concurrent runs (test workers)
never race for a port; ``spawn`` starts the ranks with the ``spawn`` start
method and returns what each rank's function returned.

Backends are chosen, never switched: ``nccl`` needs one card a rank and
raises, naming ``gloo``, when there are fewer cards than ranks; ``gloo``
puts rank r on ``cuda:r % device_count`` (so ranks may share one card) or
on the CPU, and stages CUDA tensors through host memory
(``core/collectives.py``).  A wall time taken with ranks sharing a card is
no tensor-parallel, data-parallel or disaggregated speed.
"""
from __future__ import annotations

import datetime
import gc
import os
import pickle
import tempfile
from typing import Any, Callable, List

import torch
import torch.distributed as tdist

from repro_torch.models.common import Dist

BACKENDS = ("nccl", "gloo")
TIMEOUT = datetime.timedelta(minutes=10)


def split_data_shards(n_shards: int, prefill_shards: int):
    """Role assignment of disaggregated serving: data shards
    ``[0, prefill_shards)`` form the prefill pool, the rest the decode pool
    (contiguous ranges, so each pool's slots and block namespaces stay
    shard-local) -> (prefill shards, decode shards)."""
    if not 0 < prefill_shards < n_shards:
        raise ValueError(
            f"need 1 <= prefill_shards < data shards; got "
            f"prefill_shards={prefill_shards} with {n_shards} shard(s)")
    return (tuple(range(prefill_shards)),
            tuple(range(prefill_shards, n_shards)))


def check_backend(tp: int, backend: str, device: str) -> None:
    """Raise where ``backend`` cannot run ``tp`` ranks (a world of that
    many) on ``device``."""
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


def init_tp(tp: int, rank: int, backend: str, init_file: str, device: str = "cuda",
            dp: int = 1) -> Dist:
    """Join the world of ``dp`` x ``tp`` ranks as world rank ``rank``
    through the store file ``init_file`` (the same path for every rank),
    and its model and data groups; -> this rank's Dist.  The rank's card
    becomes its current device."""
    world = dp * tp
    check_backend(world, backend, device)
    dev = rank_device(rank, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:   # ranks on the CPU share its cores: each takes its share of threads
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    tdist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                             rank=rank, timeout=TIMEOUT)
    d, t = divmod(rank, tp)
    group = data_group = tdist.group.WORLD
    if dp > 1 and tp > 1:
        # every rank creates every group, in the same order
        for r in range(dp):
            g = tdist.new_group(list(range(r * tp, (r + 1) * tp)))
            group = g if r == d else group
        for m in range(tp):
            g = tdist.new_group(list(range(m, world, tp)))
            data_group = g if m == t else data_group
    # the control plane's round records are host metadata: a gloo group of
    # the whole world, made beside an NCCL world so that they never ride
    # NCCL on a card
    control = None
    if world > 1:
        control = (tdist.group.WORLD if backend == "gloo"
                   else tdist.new_group(list(range(world)), backend="gloo"))
    return Dist(tp=tp, rank=t, group=group, backend=backend, dp=dp, data_rank=d,
                data_group=data_group, control=control)


def _rank_main(rank: int, fn: Callable, tp: int, dp: int, backend: str, device: str,
               workdir: str, args: tuple) -> None:
    dist = init_tp(tp, rank, backend, os.path.join(workdir, "store"), device, dp)
    try:
        out = fn(dist, rank_device(rank, backend, device), *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        # what a rank's reference cycles still hold of its groups (an engine
        # behind a frontend's callbacks) goes before the groups do: a gloo
        # group freed later, at interpreter exit, can abort the process
        gc.collect()
        tdist.destroy_process_group()


def spawn(fn: Callable, tp: int, *args, backend: str = "gloo", device: str = "cuda",
          dp: int = 1) -> List[Any]:
    """Run ``fn(dist, device, *args)`` on the ``dp`` x ``tp`` ranks of a
    world, each a process of the ``spawn`` start method (``fn`` and
    ``args`` are pickled: a function of a module, plain data); -> every
    rank's return value, in world rank order.  A rank that raises ends the
    others and raises here.  Build the CUDA kernels before
    (``kernels.build.build_all``): each rank would build its own copy."""
    world = dp * tp
    check_backend(world, backend, device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as workdir:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, tp, dp, backend, device, workdir, args), nprocs=world,
            join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))     # written by this call's own ranks
        return out
