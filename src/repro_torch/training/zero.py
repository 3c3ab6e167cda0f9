"""ZeRO-1: the optimizer state sharded over the data replicas
(``repro.training.zero``).

Each replica keeps the fp32 moments of its 1/dp chunk of every leaf.  A
step, per leaf in the training tree's order:

  grads:  flattened; a leaf replicated over the model ranks first summed
          over them (``zero_grad_tp``); zero-padded to dp equal chunks and
          reduce-scattered over the data replicas in the leaf's own dtype
          (``zero_grad_rs``): this replica receives the sum of its chunk;
  norm:   the squared norm of the chunks (a replicated leaf's counted once
          over the model ranks) summed over the data and then the model
          ranks (``zero_gnorm``), for the clip;
  update: AdamW on the chunk in fp32, rounded to the leaf's dtype;
  params: the chunks all-gathered over the data replicas
          (``zero_param_ag``) and trimmed back into the leaf.

The state of a leaf is its moments in the JAX package's layout,
``(n_data, [tp,] chunk)`` globally with chunk = ceil(local size / n_data)
(the ``tp`` axis where the leaf is split over the model ranks): a replica
holds its ``(1, [1,] chunk)`` of it.  At dp = 1 the update is AdamW's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import collectives as cc
from repro_torch.models.common import Dist
from repro_torch.training.optimizer import AdamWConfig, lr_schedule

Tree = Dict[str, torch.Tensor]


def _chunk(numel: int, dist: Dist) -> int:
    return -(-numel // dist.dp)


def zero_state_defs(params: Tree, sharded: Dict[str, bool], dist: Dist) -> Dict:
    """key -> the global shape of each moment, ``(n_data, [tp,] chunk)``
    (the JAX package's ``zero_state_defs``), from this rank's leaves."""
    return {k: (dist.dp, dist.tp, _chunk(p.numel(), dist)) if sharded[k]
            else (dist.dp, _chunk(p.numel(), dist)) for k, p in params.items()}


def init_zero_state(params: Tree, sharded: Dict[str, bool], dist: Dist) -> Dict:
    """This replica's state: {"moments": key -> {"m", "v"} fp32 zeros of
    its ``(1, [1,] chunk)``, "step": int32 0}."""
    moments = {}
    for k, shape in zero_state_defs(params, sharded, dist).items():
        local = (1, shape[-1]) if len(shape) == 2 else (1, 1, shape[-1])
        z = torch.zeros(local, dtype=torch.float32, device=params[k].device)
        moments[k] = {"m": z, "v": torch.zeros_like(z)}
    dev = next(iter(params.values())).device
    return {"moments": moments, "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def zero_update(params: Tree, grads: Tree, state: Dict, sharded: Dict[str, bool],
                c: AdamWConfig, dist: Dist) -> Tuple[Tree, Dict, torch.Tensor]:
    """-> (params, state, grad_norm), both updated in place.  ``grads``
    are this rank's own, not yet summed over the data replicas."""
    step = state["step"] + 1
    scattered = {}
    for k, g in grads.items():
        gf = g.reshape(-1)
        if dist.tp > 1 and not sharded[k]:
            gf = cc.all_reduce(gf.clone(), dist, tag="zero_grad_tp")
        chunk = _chunk(gf.numel(), dist)
        gf = torch.nn.functional.pad(gf, (0, dist.dp * chunk - gf.numel()))
        scattered[k] = cc.data_reduce_scatter(gf, dist, tag="zero_grad_rs").float()
    sq = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    for k, gf in scattered.items():
        part = torch.sum(gf * gf)
        sq = sq + (part / dist.tp if dist.tp > 1 and not sharded[k] else part)
    sq = cc.data_all_reduce(sq, dist, tag="zero_gnorm")
    sq = cc.all_reduce(sq, dist, tag="zero_gnorm")
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(state["step"], c)
    b1c = 1 - c.b1 ** step.float()
    b2c = 1 - c.b2 ** step.float()
    for k, p in params.items():
        mom = state["moments"][k]
        m, v = mom["m"].view(-1), mom["v"].view(-1)
        g = scattered[k] * scale
        chunk = g.shape[0]
        pf = torch.nn.functional.pad(p.reshape(-1), (0, dist.dp * chunk - p.numel()))
        p_chunk = pf[dist.data_rank * chunk:(dist.data_rank + 1) * chunk].float()
        m.copy_(c.b1 * m + (1 - c.b1) * g)
        v.copy_(c.b2 * v + (1 - c.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + c.eps) + c.weight_decay * p_chunk
        p_chunk = (p_chunk - lr * delta).to(p.dtype)     # rounded, then gathered
        if dist.dp > 1:
            p_chunk = cc.data_all_gather(p_chunk, dist, tag="zero_param_ag")
        p.copy_(p_chunk[:p.numel()].view(p.shape))
    state["step"] = step
    return params, state, gnorm
