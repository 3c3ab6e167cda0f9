"""Mixture-of-experts FFN (``repro.models.moe``): softmax -> top-k ->
renormalise routing, index dispatch with GShard capacity clipping, the
batched expert FFN and a deterministic combine, plus the always-on shared
experts.

Under tensor parallelism the experts are sharded over the ranks as the JAX
package shards them (``moe_plan``): ``n_blocks = max(E, tp)`` expert
blocks, ``local_blocks`` a rank, and where E < tp each expert's d_ff split
over ``ffn_tp = tp // E`` ranks.  The FFN's input is replicated (decode)
or gathered (``pre_ffn``), so every rank routes every token the same way,
dispatches only the assignments of its own experts and returns an
unreduced partial; the layer's ``ffn_reduce`` is the only collective, as
in the reference: no all-to-all.

* ``capacity``: C = T for T <= 256 tokens (no assignment drops), else
  max(4, ceil(T * k / E * capacity_factor)).  Past 256, which assignments
  drop depends on T and on the order of the flattened (row, position)
  tokens, pad tokens included: an expert keeps its first C assignments in
  token order.  ``RowLayout`` lets a forward that computes only some of
  the reference's rows present the rest of them to the router.
* ``route`` ranks the experts through ``ops.topk`` (the kernel on the card,
  which puts the lower index first among equal values as ``lax.top_k``
  does; its plain version on the CPU), never ``torch.topk``, whose order
  among ties is unspecified.  One launch per MoE layer and forward.  The
  kernel ranks the detached probabilities; where they require grad (the
  training forward) the gates are gathered from the probabilities, so
  they carry the router's gradient, and ``route(aux=True)`` adds the
  Switch/GShard load-balance loss E * sum_e f_e * P_e (``moe_forward``
  appends it to its ``aux`` list).
* The expert blocks ``(E, d, f)`` / ``(E, f, d)`` run as batched matmuls on
  ``wquant.to_dense`` weights (an int8/int4 block is dequantized each
  forward, as the reference serves this einsum site).
* The combine scatters each kept assignment's gated fp32 output back to its
  token and sums the k of them in ascending expert order, the order of the
  reference's scatter-add, in a fixed loop (``index_add_`` on the card adds
  in no fixed order).  The sum is rounded to bf16 before the shared
  experts' output is added.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import wquant
from repro_torch.kernels import ops
from repro_torch.models.common import activation
from repro_torch.models.mlp import mlp_forward

# profiler ranges: the routing, dispatch and combine bookkeeping, and the
# expert blocks' matmuls (with an int8/int4 block's dequantization);
# launch/profile_decode.py reports their device time per step
DISPATCH_RANGE, EXPERTS_RANGE = "moe dispatch", "moe experts"

# A list in LOG collects one record per MoE layer call, as device tensors:
# T, C, the router's fp32 probabilities and top experts, and the dispatch
# bookkeeping, read with ``dropped`` (chip_smoke.py and the tests).  A list
# in ROUTE_REPLAY supplies each call's top experts in order (another
# device's choice, replayed: chip_smoke.py's witness of a router near-tie),
# gated by the call's own probabilities.  None (the default): neither.
LOG: Optional[List[Dict[str, Any]]] = None
ROUTE_REPLAY: Optional[List[torch.Tensor]] = None


def dropped(rec: Dict[str, Any]) -> torch.Tensor:
    """A LOG record -> its dropped assignments, (n, 2) rows of (token,
    expert) on the host."""
    lost = ~rec["keep"]
    order = rec["order"][lost]
    return torch.stack([order // rec["k"], rec["top_e"].reshape(-1)[order]], 1).cpu()


@dataclass
class RowLayout:
    """The reference's full-width rows around the rows a forward computes.

    The JAX engine's whole-prompt slot admission and the chunk half of its
    mixed step run every slot's row, pad tokens from position 0 on the rows
    not admitted, and discard those rows' results; the port computes the
    admitted rows only.  Where that changes an MoE layer's T past 256, the
    forward carries the other rows along as ``tokens`` (g, s) attending
    their own fresh K/V, and every MoE layer routes the B rows in slot
    order: the computed rows at ``rows`` (b,) and these at ``others`` (g,)."""

    tokens: torch.Tensor
    rows: torch.Tensor
    others: torch.Tensor

    @property
    def width(self) -> int:
        return len(self.rows) + len(self.others)

    def merge(self, x: torch.Tensor, xo: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((self.width, *x.shape[1:]))
        out[self.rows], out[self.others] = x, xo
        return out


def moe_plan(m: MoEConfig, tp: int) -> Tuple[int, int, int, int]:
    """-> (n_blocks, dff_block, local_blocks, ffn_tp), raising where the
    experts do not split over ``tp`` ranks (``repro.models.moe.moe_plan``)."""
    E = m.n_experts
    if E >= tp:
        if E % tp:
            raise ValueError(f"n_experts {E} not divisible by tp {tp}")
        return E, m.expert_d_ff, E // tp, 1
    if tp % E:
        raise ValueError(f"tp {tp} not divisible by n_experts {E}")
    ffn_tp = tp // E
    if m.expert_d_ff % ffn_tp:
        raise ValueError("expert_d_ff not divisible by ffn_tp")
    return tp, m.expert_d_ff // ffn_tp, 1, ffn_tp


def local_experts(m: MoEConfig, tp: int, rank: int) -> Tuple[int, int]:
    """(e_lo, local_E): the experts rank ``rank`` serves, [e_lo, e_lo +
    local_E) (one expert, a slice of its d_ff, where ffn_tp > 1)."""
    n_blocks, _, local_blocks, _ = moe_plan(m, tp)
    return (rank * local_blocks * m.n_experts) // n_blocks, max(1, local_blocks * m.n_experts
                                                                 // n_blocks)


def capacity(m: MoEConfig, tokens: int) -> int:
    """Expert capacity: decode-sized batches get C = T (drop-free), larger
    ones the GShard capacity-factor clipping."""
    if tokens <= 256:
        return tokens
    return max(4, int(math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor)))


def route(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig, *, aux: bool = False):
    """x (T, d) -> (top experts (T, k) int64, gates (T, k) fp32, the fp32
    probabilities (T, E)): fp32 logits, softmax, top-k, renormalised; with
    ``aux`` a fourth, the load-balance loss (``load_balance_aux``)."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)
    top_p, top_e = ops.topk(probs.detach(), m.top_k)
    if ROUTE_REPLAY is not None:
        top_e = ROUTE_REPLAY.pop(0).to(device=probs.device, dtype=top_e.dtype)
    if ROUTE_REPLAY is not None or probs.requires_grad:
        top_p = probs.gather(1, top_e.long())
    gates = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    out = top_e.long(), gates, probs
    return (*out, load_balance_aux(probs, out[0], m)) if aux else out


def load_balance_aux(probs: torch.Tensor, top_e: torch.Tensor, m: MoEConfig) -> torch.Tensor:
    """The reference's Switch/GShard load-balance loss of one routing:
    E * sum_e f_e * P_e, f_e the share of the k T assignments that chose
    expert e (each counting 1 / k), P_e the mean probability of e; fp32.
    Only the probabilities carry a gradient."""
    f = torch.zeros_like(probs).scatter_add_(
        1, top_e, torch.full(top_e.shape, 1.0 / m.top_k, device=probs.device)).mean(dim=0)
    return m.n_experts * (f * probs.mean(dim=0)).sum()


def moe_forward(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, tp: int = 1,
                rank: int = 0, aux: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """x (b, s, d), the whole token set -> the FFN output (b, s, d) of an
    MoE layer: routed experts plus the shared ones.  At ``tp`` > 1 this
    rank's unreduced partial: its experts' (``local_experts``) share of
    the routed output and its shard of the shared experts'.  ``aux`` (the
    training forward): a list the layer's load-balance loss is appended
    to."""
    m = cfg.moe
    b, s, d = x.shape
    T, k = b * s, m.top_k
    xf = x.reshape(T, d)
    C = capacity(m, T)
    e_lo, E = local_experts(m, tp, rank)
    with torch.profiler.record_function(DISPATCH_RANGE):
        routed = route(p["router"], xf, m, aux=aux is not None)
        top_e, gates, probs = routed[:3]
        if aux is not None:
            aux.append(routed[3])
        xe, order, keep, slot = _dispatch(top_e, xf, m, C, e_lo, E)
    if LOG is not None:
        LOG.append({"T": T, "C": C, "k": k, "keep": keep, "order": order, "top_e": top_e,
                    "probs": probs})
    with torch.profiler.record_function(EXPERTS_RANGE):
        act = activation(cfg.act)
        up = torch.bmm(xe, wquant.to_dense(p["w_up"]))
        up = (act(torch.bmm(xe, wquant.to_dense(p["w_gate"]))) * up if cfg.gated_mlp
              else act(up))
        ye = torch.bmm(up, wquant.to_dense(p["w_down"])).view(E * C, d)
    with torch.profiler.record_function(DISPATCH_RANGE):
        out = _combine(ye, top_e, gates, order, slot).view(b, s, d).to(x.dtype)
    if m.n_shared:
        out = out + mlp_forward(p["shared"], x, cfg)
    return out


def _dispatch(top_e: torch.Tensor, xf: torch.Tensor, m: MoEConfig, C: int, e_lo: int,
              E: int):
    """Lay the T tokens out per expert -> (xe (E, C, d) for the E experts
    from ``e_lo`` on, the sort order of the flat (token, rank)
    assignments, which sorted ones are kept (by every rank alike), their
    slot among the E * C rows, E * C for the dump row: a dropped
    assignment's, or another rank's expert's)."""
    T, d = xf.shape
    k, n_e = m.top_k, m.n_experts
    # a stable sort by expert, each assignment's place in its expert's
    # queue, and the first C of each queue kept
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = torch.zeros(n_e, dtype=torch.long, device=xf.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=xf.device) - starts[sorted_e]
    keep = pos < C
    mine = keep & (sorted_e >= e_lo) & (sorted_e < e_lo + E)
    slot = torch.where(mine, (sorted_e - e_lo) * C + pos, E * C)
    x_disp = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    x_disp[slot] = xf[order // k]
    return x_disp[:E * C].view(E, C, d), order, keep, slot


def _combine(ye: torch.Tensor, top_e, gates, order, slot) -> torch.Tensor:
    """Expert outputs ye (E * C, d) -> (T, d) fp32: each kept assignment's
    gated output at its (token, rank) place, then the k ranks summed in
    ascending expert order.  An assignment in the dump row (dropped, or
    another rank's) adds zero."""
    T, k = top_e.shape
    d = ye.shape[1]
    ye = torch.cat([ye, ye.new_zeros((1, d))])                         # the dump row
    gate = torch.where(slot < ye.shape[0] - 1, gates.reshape(-1)[order], 0.0)
    contrib = torch.empty((T * k, d), dtype=torch.float32, device=ye.device)
    contrib[order] = ye[slot].float() * gate[:, None]
    contrib = contrib.view(T, k, d)
    by_expert = torch.argsort(top_e, dim=1)
    out = torch.zeros((T, d), dtype=torch.float32, device=ye.device)
    for j in range(k):
        out = out + contrib.gather(1, by_expert[:, j, None, None].expand(T, 1, d))[:, 0]
    return out
