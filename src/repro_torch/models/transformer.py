"""Decoder layers: the sub-layer of ``repro.models.transformer.sublayer_forward``,
sequential or parallel residual, with its mixer dispatch
(``_mixer_forward``: ``attn``, ``local_attn`` -- GQA, or latent attention
where ``cfg.mla`` -- ``rglru`` or ``ssd``) and its FFN (dense, or mixture of
experts on ``cfg.is_moe_layer`` layers; an ``ssd`` layer has none and no
``norm2``: x + ssd(norm1(x))), and the layer loop that the JAX
package runs as scans over groups of stacked parameters (here a Python
loop over per-layer views of the same stacked tensors).

Layer i's kind is ``cfg.block_kind(i)``, the layer pattern cycled over the
layers.  Each kind owns its part of the cache: the attention layers (GQA
or MLA) the K/V or latents, in their own order, the recurrent layers
(RG-LRU or SSD) the recurrent state.

A ``moe.RowLayout`` (``Ghost``) carries the reference's other full-width
rows through the layers beside the computed ones: each of their mixers
attends their own fresh K/V, each MoE layer routes all the rows together
in slot order, and at tp > 1 they ride in the computed rows' gathers and
reductions.

Every residual-stream collective is the ``SyncPolicy``'s, with the JAX
package's tags (``transformer.py:220-247`` there): ``pre_mixer`` and
``pre_ffn`` gathers of a sequence-sharded residual, ``mixer_reduce`` and
``ffn_reduce`` after a sequential layer's branches, and one ``one_shot``
reduction of a parallel-residual layer's summed partials (``attn_reduce``
and ``ffn_reduce`` without ``one_shot_sync``).  At tp=1 each is the
identity.

``train_layers`` is the training forward's loop (a ``KVStep`` with
``train``): each layer its plain differentiable branch, optionally under
activation checkpointing (``ParallelConfig.remat``, the reference's
``jax.checkpoint`` per layer group), and the MoE layers' load-balance
losses summed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import wquant
from repro_torch.core import collectives as cc
from repro_torch.core.sync_policy import SyncPolicy
from repro_torch.core.zero_copy import fused_out_projection, parallel_partials
from repro_torch.models import attention as attn
from repro_torch.models import mla, moe, rglru, ssm
from repro_torch.models.common import recurrent_layer, rms_norm
from repro_torch.models.mlp import mlp_forward, mlp_hidden

ATTN_KINDS = ("attn", "local_attn")
# mixers that carry recurrent state (``h``/``conv`` in the cache) -> forward
RECURRENT = {"rglru": rglru.rglru_forward, "ssd": ssm.ssd_forward}


@dataclass
class Ghost:
    """The other rows of a ``moe.RowLayout`` in flight: their residual
    ``x``, their RoPE tables and their fresh-K/V ``KVStep``."""

    layout: moe.RowLayout
    x: torch.Tensor
    rope: Tuple[torch.Tensor, torch.Tensor]
    step: attn.KVStep


def _mixer_forward(p, xa, cfg: ModelConfig, kind: str, index: int, *, rope,
                   step: attn.KVStep, length_mask) -> torch.Tensor:
    if kind in ATTN_KINDS and cfg.mla is not None:
        return mla.mla_forward(p, xa, cfg, rope=rope, step=step, layer=index)
    if kind in ATTN_KINDS:
        return attn.gqa_forward(p, xa, cfg, rope=rope, step=step, layer=index,
                                window=cfg.window if kind == "local_attn" else 0)
    if kind in RECURRENT and step.train:
        kw = {"train": True} if kind == "rglru" else {}
        return RECURRENT[kind](p["mixer"], xa, cfg, **kw)[0]
    if kind in RECURRENT:
        return recurrent_layer(RECURRENT[kind], p["mixer"], xa, cfg, cache=step.cache,
                               index=index, rows=step.state_rows, length_mask=length_mask)
    raise ValueError(kind)


def _ffn(p, x: torch.Tensor, cfg: ModelConfig, policy: SyncPolicy,
         aux: Optional[list] = None) -> torch.Tensor:
    """The FFN branch's partial: dense, or an MoE layer's experts (this
    rank's, routing every token of ``x``; ``aux`` collects its
    load-balance loss)."""
    if "router" not in p:
        return mlp_forward(p, x, cfg)
    return moe.moe_forward(p, x, cfg, policy.dist.tp, policy.dist.rank, aux=aux)


def sublayer_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                     kind: str = "attn", index: int = 0, *,
                     rope: Tuple[torch.Tensor, torch.Tensor], step: attn.KVStep,
                     length_mask: Optional[torch.Tensor] = None,
                     policy: SyncPolicy, ghost: Optional[Ghost] = None) -> torch.Tensor:
    """x + mixer(norm1(x)), then + mlp(norm2(.)): one decoder layer of kind
    ``kind``, the ``index``-th of its kind's cache, each branch's partial
    reduced by ``policy``.  With ``cfg.parallel_residual`` (attention
    layers): x + (attn + mlp)(norm1(x)); under ``policy.one_shot`` both
    partials are summed by one fused_dual_matmul
    (``zero_copy.parallel_partials``) into the one buffer that the one
    reduction reads (paper section 2.2), else each is computed and reduced
    on its own.  ``ghost``: rows carried beside ``x`` for the MoE layers'
    routing (``Ghost``, ``_ghost_sublayer``)."""
    if ghost is not None:
        return _ghost_sublayer(p, x, cfg, kind, index, rope=rope, step=step,
                               length_mask=length_mask, policy=policy, ghost=ghost)
    xa = policy.gather_in(rms_norm(x, p["norm1"], cfg.rms_eps), tag="pre_mixer")
    if cfg.parallel_residual and kind in ATTN_KINDS:
        heads = attn.gqa_heads(p, xa, cfg, rope=rope, step=step, layer=index,
                               window=cfg.window if kind == "local_attn" else 0)
        h = mlp_hidden(p, xa, cfg)
        if policy.one_shot:
            return x + policy.reduce_out(parallel_partials(heads, p["w_o"], h, p["w_down"],
                                                           fused=not step.train),
                                         tag="one_shot")
        # the two-sync baseline the paper improves on
        return (x + policy.reduce_out(fused_out_projection(heads, p["w_o"]), tag="attn_reduce")
                + policy.reduce_out(wquant.matmul(h, p["w_down"]), tag="ffn_reduce"))
    x = x + policy.reduce_out(_mixer_forward(p, xa, cfg, kind, index, rope=rope, step=step,
                                             length_mask=length_mask), tag="mixer_reduce")
    if kind == "ssd":
        return x
    xf = policy.gather_in(rms_norm(x, p["norm2"], cfg.rms_eps), tag="pre_ffn")
    return x + policy.reduce_out(_ffn(p, xf, cfg, policy, step.aux), tag="ffn_reduce")


def _ghost_sublayer(p, x: torch.Tensor, cfg: ModelConfig, kind: str, index: int, *, rope,
                    step: attn.KVStep, length_mask, policy: SyncPolicy,
                    ghost: Ghost) -> torch.Tensor:
    """A sequential layer over the computed rows ``x`` and the ghost's,
    which advances ``ghost.x`` in place.  Each row set runs its own mixer
    (its own KVStep); the ghost rows ride in the same gathers and
    reductions as ``x``, stacked after its rows, so the layer issues the
    collectives of the reference's one tensor of all the rows; an MoE
    layer routes all of them together in slot order."""
    b = x.shape[0]
    cat = lambda a, o: torch.cat([a, o])
    n1 = lambda t: rms_norm(t, p["norm1"], cfg.rms_eps)
    n2 = lambda t: rms_norm(t, p["norm2"], cfg.rms_eps)
    xa = policy.gather_in(cat(n1(x), n1(ghost.x)), tag="pre_mixer")
    mix = cat(_mixer_forward(p, xa[:b], cfg, kind, index, rope=rope, step=step,
                             length_mask=length_mask),
              _mixer_forward(p, xa[b:], cfg, kind, index, rope=ghost.rope, step=ghost.step,
                             length_mask=None))
    red = policy.reduce_out(mix, tag="mixer_reduce")
    x, ghost.x = x + red[:b], ghost.x + red[b:]
    xf = policy.gather_in(cat(n2(x), n2(ghost.x)), tag="pre_ffn")
    if "router" in p:
        lay = ghost.layout
        out = _ffn(p, lay.merge(xf[:b], xf[b:]), cfg, policy)
        out = cat(out[lay.rows], out[lay.others])
    else:
        out = cat(_ffn(p, xf[:b], cfg, policy), _ffn(p, xf[b:], cfg, policy))
    red = policy.reduce_out(out, tag="ffn_reduce")
    ghost.x = ghost.x + red[b:]
    return x + red[:b]


def layers_forward(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor,
                   cfg: ModelConfig, **kw) -> torch.Tensor:
    """The layers in order; each takes the next cache index of its mixer's
    family (attention, GQA or MLA, and recurrent count apart)."""
    seen = {"attn": 0, "recurrent": 0}
    for i, p in enumerate(layers):
        kind = cfg.block_kind(i)
        family = "recurrent" if kind in RECURRENT else "attn"
        x = sublayer_forward(p, x, cfg, kind, seen[family], **kw)
        seen[family] += 1
    return x


def _train_layer(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *, rope,
                 step: attn.KVStep, policy: SyncPolicy):
    """One layer of the training forward -> (x', its load-balance loss: 0
    but for an MoE layer)."""
    terms: list = []
    x = sublayer_forward(p, x, cfg, kind, rope=rope, step=dataclasses.replace(step, aux=terms),
                         policy=policy)
    return x, sum(terms) if terms else torch.zeros((), device=x.device)


def _remat_context():
    """The forward run of a checkpointed layer as itself; its run again in
    the backward records its collectives as such (``cc.recomputing``)."""
    return contextlib.nullcontext(), cc.recomputing()


def train_layers(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor, cfg: ModelConfig, *,
                 rope, step: attn.KVStep, policy: SyncPolicy,
                 remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward's layers (``step.train``, no cache) -> (x, the
    summed load-balance loss, fp32).  ``remat``: each layer under
    ``torch.utils.checkpoint`` (non-reentrant), its activations recomputed
    in the backward, as the reference checkpoints each layer group."""
    aux = torch.zeros((), device=x.device)
    for i, p in enumerate(layers):
        kind = cfg.block_kind(i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _train_layer, p, x, cfg, kind, rope=rope, step=step, policy=policy,
                use_reentrant=False, context_fn=_remat_context)
        else:
            x, a = _train_layer(p, x, cfg, kind, rope=rope, step=step, policy=policy)
        aux = aux + a
    return x, aux
