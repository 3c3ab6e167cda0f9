"""Explicit collectives with byte accounting (``repro.core.collectives``).

The paper's contribution is which collectives a decode round runs and how
many bytes they move, so every collective of the port goes through these
wrappers, and running a step under ``comm_stats`` yields its schedule:
one ``CommRecord`` per call with the JAX package's kinds, tags and wire
factors (an all-reduce moves about twice its payload per rank in a ring,
the others once).

Differences from the JAX package:

* JAX records a traced program, so a scanned layer body counts once; the
  port records every call, so compare per layer.
* At tp=1 every wrapper is the identity and records nothing (the JAX
  package's ``reduce_out`` at tp=1).
* Under gloo a CUDA tensor is staged through host memory here, explicitly:
  copied to the host, reduced or gathered there, copied back.
* The data axis (``Dist.dp`` replicas, ``data_*`` below) has its own
  wrappers, recorded with axis "data": the sampled tokens all-gathered
  (tag ``dp_tokens``), the sequence-sharded KV cache's log-sum-exp merge
  (an all-reduce max, kind ``all_reduce_max``, which the JAX package's
  ``pmax`` does not record, and an all-reduce sum, tag ``lse_merge``), and
  KV blocks sent from one data rank to another (kind ``send``, recorded by
  the sender, tag ``migrate``).
* The serving control plane's round record (``control_broadcast``): a
  variable-length byte string that world rank 0 broadcasts to the whole
  world over a gloo group (``Dist.control``), its length first and then
  its bytes, each broadcast recorded with axis "world" and tag
  ``control``.  The JAX package has one controller and no such record.
* The training forward (``SyncPolicy.train``, ``training/``) runs the
  same collectives through ``torch.autograd.Function`` pairs
  (``all_gather_ad``, ``reduce_scatter_ad``, ``all_reduce_ad``,
  ``data_sum_ad``): a forward record keeps its JAX tag, the collective
  of its backward is recorded under that tag with ``GRAD_SUFFIX``, and a
  layer's forward run again in the backward (activation checkpointing,
  ``recomputing``) records under the tag with ``REMAT_SUFFIX``.  The JAX
  package records only the traced forward.  Their backward rule follows
  from one convention: the gradient of a replicated activation is held as
  partial sums over the model ranks (each rank's share through its own
  columns), that of a sequence chunk exactly.  So a gather's backward
  reduce-scatters, a reduce-scatter's gathers, a branch's or the
  embedding's all-reduce all-reduces its gradient too, and the loss
  statistics' sums (whose result every rank turns into the same loss)
  pass the gradient through.  ``psum`` sums over several axes as one
  record (the JAX package's ``psum`` over a tuple of axes), and
  ``data_reduce_scatter`` is ZeRO-1's over the data axis.
* ``all_gather`` and ``reduce_scatter`` along the sequence take any length
  s: each rank's chunk is padded to ceil(s / tp) rows inside the
  collective and trimmed after it (``seq_chunk``), so no padding row ever
  leaves the collective.  The JAX package's ``shard_residual`` drops rows
  where s % tp != 0.  A record counts the rows that cross, padding
  included; where s % tp == 0 that is the JAX package's count.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist

from repro_torch.models.common import Dist

AXIS = "model"     # the JAX package's name of the tensor-parallel mesh axis
DATA_AXIS = "data"   # ... and of the data axis
WORLD_AXIS = "world"   # every rank of the dp x tp world (the round records)
_local = threading.local()
GRAD_SUFFIX = ".grad"    # a training collective's backward record: tag + this
REMAT_SUFFIX = ".remat"  # a forward collective run again for a checkpointed layer

@dataclass
class CommRecord:
    kind: str
    axis: str
    bytes: int
    shape: tuple
    tag: str = ""


@dataclass
class CommStats:
    records: List[CommRecord] = field(default_factory=list)

    def count(self, kind: Optional[str] = None) -> int:
        return sum(1 for r in self.records if kind is None or r.kind == kind)

    def total_bytes(self, kind: Optional[str] = None, axis: Optional[str] = None) -> int:
        return sum(r.bytes for r in self.records
                   if (kind is None or r.kind == kind) and (axis is None or r.axis == axis))

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.kind] = out.get(r.kind, 0) + r.bytes
        return out

    def by_tag(self) -> Dict[str, Dict[str, int]]:
        """"tag (kind)" -> {"count", "bytes"} (wire bytes), in first-seen
        order (one tag may name a gather at prefill and an all-reduce at
        decode)."""
        out: Dict[str, Dict[str, int]] = {}
        for r in self.records:
            e = out.setdefault(f"{r.tag} ({r.kind})", {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += r.bytes
        return out


@contextlib.contextmanager
def comm_stats():
    """Record every wrapped collective issued in this thread under the
    context (nested contexts: the innermost records)."""
    stats = CommStats()
    prev = getattr(_local, "stats", None)
    _local.stats = stats
    try:
        yield stats
    finally:
        _local.stats = prev


@contextlib.contextmanager
def _recording(stats: Optional[CommStats], suffix: str = ""):
    """Record into ``stats`` in this thread under the context, each tag
    with ``suffix``: the backward of a CUDA graph runs in autograd's own
    thread, which the forward's ``comm_stats`` does not reach."""
    prev = getattr(_local, "stats", None), getattr(_local, "suffix", "")
    _local.stats, _local.suffix = stats, suffix
    try:
        yield
    finally:
        _local.stats, _local.suffix = prev


def recomputing():
    """A context, made now, under which a checkpointed layer's forward runs
    again in the backward: its collectives are recorded into the stats
    recording now, tagged with ``REMAT_SUFFIX``."""
    return _recording(getattr(_local, "stats", None), REMAT_SUFFIX)


def _record(kind: str, x: torch.Tensor, tag: str, wire_factor: float = 1.0,
            axis: str = AXIS) -> None:
    stats: Optional[CommStats] = getattr(_local, "stats", None)
    if stats is not None:
        nbytes = x.numel() * x.element_size()
        stats.records.append(CommRecord(kind, axis, int(nbytes * wire_factor),
                                        tuple(x.shape), tag + getattr(_local, "suffix", "")))


def seq_chunk(s: int, tp: int, rank: int) -> Tuple[int, int]:
    """Rows [lo, hi) of a length-s sequence that ``rank`` holds: chunks of
    ceil(s / tp) rows, the last ones shorter or empty."""
    c = -(-s // tp)
    return min(s, rank * c), min(s, (rank + 1) * c)


def _staged(x: torch.Tensor, dist: Dist) -> torch.Tensor:
    """The tensor the backend reduces: under gloo a CUDA tensor's host copy."""
    x = x.contiguous()
    return x.cpu() if dist.backend == "gloo" and x.is_cuda else x


def all_reduce(x: torch.Tensor, dist: Dist, tag: str = "") -> torch.Tensor:
    """The sum over the ranks (the JAX package's ``psum``); ``x`` may be
    overwritten."""
    if dist.tp == 1:
        return x
    _record("all_reduce", x, tag, wire_factor=2.0)
    buf = _staged(x, dist)
    tdist.all_reduce(buf, group=dist.group)
    return buf.to(x.device)


def all_reduce_max(x: torch.Tensor, dist: Dist, tag: str = "") -> torch.Tensor:
    """The max over the model ranks of a tensor that carries no gradient
    (the JAX package's ``pmax``, which it does not record; recorded here
    as kind ``all_reduce_max``)."""
    if dist.tp == 1:
        return x
    _record("all_reduce_max", x, tag, wire_factor=2.0)
    buf = _staged(x, dist).clone()
    tdist.all_reduce(buf, op=tdist.ReduceOp.MAX, group=dist.group)
    return buf.to(x.device)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x with dim 0 zero-padded to ``rows``."""
    if x.shape[0] == rows:
        return x
    out = x.new_zeros((rows, *x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def all_gather(x: torch.Tensor, dist: Dist, dim: int, tag: str = "",
               total: Optional[int] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order.  With
    ``total``, x is this rank's ``seq_chunk`` of a length-``total`` axis:
    padded to ceil(total / tp) rows for the collective, the padding
    trimmed from the result."""
    if dist.tp == 1:
        return x
    rows = x.shape[dim] if total is None else -(-total // dist.tp)
    local = _pad_rows(x.movedim(dim, 0), rows)
    _record("all_gather", local.movedim(0, dim), tag)
    buf = _staged(local, dist)
    out = buf.new_empty((dist.tp * rows, *buf.shape[1:]))
    tdist.all_gather_into_tensor(out, buf, group=dist.group)
    if total is not None:
        out = out[:total]
    return out.to(x.device).movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dist: Dist, dim: int, tag: str = "") -> torch.Tensor:
    """Sum over the ranks of ``x``, of which each rank keeps its
    ``seq_chunk`` along ``dim`` (any length: padded inside, trimmed after)."""
    if dist.tp == 1:
        return x
    s = x.shape[dim]
    rows = -(-s // dist.tp)
    full = _pad_rows(x.movedim(dim, 0), dist.tp * rows)
    _record("reduce_scatter", full.movedim(0, dim), tag)
    buf = _staged(full, dist)
    out = buf.new_empty((rows, *buf.shape[1:]))
    tdist.reduce_scatter_tensor(out, buf, group=dist.group)
    lo, hi = seq_chunk(s, dist.tp, dist.rank)
    return out[:hi - lo].to(x.device).movedim(0, dim).contiguous()


def broadcast_from0(x: torch.Tensor, dist: Dist, tag: str = "") -> torch.Tensor:
    """Rank 0's ``x`` on every rank: the paper's baseline, in which rank 0
    computes the embedding activations and broadcasts them."""
    if dist.tp == 1:
        return x
    _record("broadcast", x, tag)
    buf = _staged(x, dist)
    if buf is x:
        buf = x.clone()
    # src is a world rank: model rank 0 of this replica
    tdist.broadcast(buf, src=tdist.get_global_rank(dist.group, 0), group=dist.group)
    return buf.to(x.device)


# -- the data axis -----------------------------------------------------------


def data_all_reduce(x: torch.Tensor, dist: Dist, op: str = "sum", tag: str = "") -> torch.Tensor:
    """The sum (``op`` "sum", the JAX package's ``psum`` over the data axis)
    or the max ("max", its ``pmax``) over the ``dp`` replicas; ``x`` may be
    overwritten."""
    if dist.dp == 1:
        return x
    _record("all_reduce" if op == "sum" else "all_reduce_max", x, tag,
            wire_factor=2.0, axis=DATA_AXIS)
    buf = _staged(x, dist)
    tdist.all_reduce(buf, op=tdist.ReduceOp.SUM if op == "sum" else tdist.ReduceOp.MAX,
                     group=dist.data_group)
    return buf.to(x.device)


def data_all_gather(x: torch.Tensor, dist: Dist, tag: str = "") -> torch.Tensor:
    """The replicas' ``x`` (each the same shape) concatenated along dim 0 in
    data-rank order."""
    if dist.dp == 1:
        return x
    _record("all_gather", x, tag, axis=DATA_AXIS)
    buf = _staged(x, dist)
    out = buf.new_empty((dist.dp * buf.shape[0], *buf.shape[1:]))
    tdist.all_gather_into_tensor(out, buf, group=dist.data_group)
    return out.to(x.device)


def data_send(x: torch.Tensor, dist: Dist, to: int, tag: str = "") -> None:
    """Send ``x`` to data rank ``to`` (this model rank of that replica),
    which takes it with ``data_recv``; recorded here, on the sender."""
    _record("send", x, tag, axis=DATA_AXIS)
    tdist.send(_staged(x, dist), dst=tdist.get_global_rank(dist.data_group, to))


def data_recv(shape, dtype: torch.dtype, device, dist: Dist, frm: int) -> torch.Tensor:
    """What data rank ``frm`` sent with ``data_send``: a tensor of that
    ``shape`` and ``dtype``, on ``device``."""
    buf = torch.empty(shape, dtype=dtype, device="cpu" if dist.backend == "gloo" else device)
    tdist.recv(buf, src=tdist.get_global_rank(dist.data_group, frm))
    return buf.to(device)


def data_reduce_scatter(x: torch.Tensor, dist: Dist, tag: str = "") -> torch.Tensor:
    """The sum over the ``dp`` replicas of the 1-D ``x`` (a multiple of dp
    long), of which data rank d keeps the d-th of dp equal chunks (the JAX
    package's tiled ``psum_scatter`` over the data axis)."""
    if dist.dp == 1:
        return x
    _record("reduce_scatter", x, tag, axis=DATA_AXIS)
    buf = _staged(x, dist)
    out = buf.new_empty((buf.shape[0] // dist.dp,))
    tdist.reduce_scatter_tensor(out, buf, group=dist.data_group)
    return out.to(x.device)


def psum(x: torch.Tensor, dist: Dist, axes: Tuple[str, ...], tag: str = "") -> torch.Tensor:
    """The sum over the ranks of every axis in ``axes`` (``DATA_AXIS``,
    ``AXIS``; an axis of one rank is skipped): one record, as the JAX
    package records its ``psum`` over a tuple of axes, run as one
    all-reduce an axis, the data axis first."""
    axes = tuple(a for a in axes if (dist.dp if a == DATA_AXIS else dist.tp) > 1)
    if not axes:
        return x
    _record("all_reduce", x, tag, wire_factor=2.0, axis="+".join(axes))
    buf = _staged(x, dist)
    for a in axes:
        tdist.all_reduce(buf, group=dist.data_group if a == DATA_AXIS else dist.group)
    return buf.to(x.device)


# -- differentiable collectives (the training forward) -----------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, dim, tag, total):
        ctx.dist, ctx.dim, ctx.tag, ctx.stats = dist, dim, tag, getattr(_local, "stats", None)
        return all_gather(x, dist, dim, tag=tag, total=total)

    @staticmethod
    def backward(ctx, g):
        # every rank's share of the gathered tensor's gradient, summed
        with _recording(ctx.stats):
            g = reduce_scatter(g.contiguous().clone(), ctx.dist, ctx.dim,
                               tag=ctx.tag + GRAD_SUFFIX)
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, dim, tag):
        ctx.dist, ctx.dim, ctx.tag, ctx.total = dist, dim, tag, x.shape[dim]
        ctx.stats = getattr(_local, "stats", None)
        return reduce_scatter(x.contiguous().clone(), dist, dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        with _recording(ctx.stats):
            g = all_gather(g.contiguous(), ctx.dist, ctx.dim, tag=ctx.tag + GRAD_SUFFIX,
                           total=ctx.total)
        return g, None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, tag, grad_sum):
        ctx.dist, ctx.tag, ctx.grad_sum = dist, tag, grad_sum
        ctx.stats = getattr(_local, "stats", None)
        return all_reduce(x.contiguous().clone(), dist, tag=tag)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            with _recording(ctx.stats):
                g = all_reduce(g.contiguous().clone(), ctx.dist, tag=ctx.tag + GRAD_SUFFIX)
        return g, None, None, None


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dist, tag, scale):
        ctx.scale = scale
        return data_all_reduce(x.contiguous().clone(), dist, tag=tag) * scale

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


def all_gather_ad(x: torch.Tensor, dist: Dist, dim: int, tag: str = "",
                  total: Optional[int] = None) -> torch.Tensor:
    """``all_gather`` whose backward reduce-scatters the gradient."""
    return x if dist.tp == 1 else _AllGather.apply(x, dist, dim, tag, total)


def reduce_scatter_ad(x: torch.Tensor, dist: Dist, dim: int, tag: str = "") -> torch.Tensor:
    """``reduce_scatter`` whose backward gathers the gradient."""
    return x if dist.tp == 1 else _ReduceScatter.apply(x, dist, dim, tag)


def all_reduce_ad(x: torch.Tensor, dist: Dist, tag: str = "", *,
                  grad_sum: bool = True) -> torch.Tensor:
    """``all_reduce`` (never in place) whose backward all-reduces the
    gradient too (``grad_sum``: the result's gradient is held as partial
    sums, a branch's output or the embedding's) or passes it through (the
    loss statistics, whose gradient every rank holds whole)."""
    return x if dist.tp == 1 else _AllReduce.apply(x, dist, tag, grad_sum)


def data_sum_ad(x: torch.Tensor, dist: Dist, tag: str = "", scale: float = 1.0) -> torch.Tensor:
    """``scale`` times the sum of ``x`` over the data replicas, the gradient
    passed through (times ``scale``): each replica's share of a loss over
    the global batch, whose parameter gradients ``reduce_grads`` then sums
    over the replicas."""
    return x * scale if dist.dp == 1 else _DataSum.apply(x, dist, tag, scale)


# -- the control plane ---------------------------------------------------------


def control_broadcast(payload: Optional[bytes], dist: Dist) -> bytes:
    """World rank 0's ``payload`` on every rank of the world (the others
    pass None): its length as one int64, then its bytes (skipped when
    empty), both host tensors over the gloo control group, tag
    ``control``.  The identity in a world of one rank."""
    if dist.world == 1:
        return payload or b""
    group = dist.control
    src = tdist.get_global_rank(group, 0)
    n = torch.tensor([len(payload) if dist.world_rank == 0 else 0], dtype=torch.int64)
    _record("broadcast", n, "control", axis=WORLD_AXIS)
    tdist.broadcast(n, src=src, group=group)
    size = int(n[0])
    if size == 0:
        return b""
    if dist.world_rank == 0:
        buf = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    else:
        buf = torch.empty(size, dtype=torch.uint8)
    _record("broadcast", buf, "control", axis=WORLD_AXIS)
    tdist.broadcast(buf, src=src, group=group)
    return payload if dist.world_rank == 0 else buf.numpy().tobytes()
