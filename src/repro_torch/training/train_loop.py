"""The per-rank train step (``repro.training.train_loop``): loss ->
gradients -> their reduction over the ranks -> AdamW or ZeRO-1.

The parameters are the training tree (``training/checkpoint.py``: the JAX
package's leaves, flat, each this rank's shard), whose leaves require
grad.  The loss runs the training forward (``model.train_forward``: the
differentiable branch of every mixer, the differentiable collectives at
tp > 1), drops a frontend's prefix positions, and takes the chunked
vocab-parallel cross-entropy plus ``aux_weight`` times the MoE layers'
load-balance loss averaged over the data replicas.

The gradient rule is the JAX package's, reached by another road.  JAX
differentiates a per-shard program whose transposed collectives do not
sum cotangents over the mesh axes; here autograd differentiates the
collectives themselves (``collectives.all_gather_ad`` and its pairs), so
a leaf split over the model ranks gets its whole gradient on its rank,
and a replicated leaf gets its rank's share.  ``reduce_grads`` then sums
every gradient over the data replicas and a replicated leaf's over the
model ranks too (one ``grad_reduce`` record a leaf, as the JAX package's
``psum`` over the axes its spec does not name).  The clip reads the norm
of the whole model's gradient (``grad_norm``: a split leaf's squares
summed over the model ranks, tag ``gnorm``), so a step at tp > 1 updates
the weights as the step at tp = 1 does; the JAX package's AdamW path
clips each rank by its own shard's norm instead.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import collectives as cc
from repro_torch.models import model as M
from repro_torch.models.common import Dist
from repro_torch.training import checkpoint
from repro_torch.training.loss import chunked_vocab_parallel_xent
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_opt_state, sq_norm
from repro_torch.training.zero import init_zero_state, zero_update

Tree = Dict[str, torch.Tensor]
# the loss's sequence chunk: the largest of these that divides the sequence
XENT_CHUNKS = (512, 448, 384, 320, 256, 192, 128, 96, 64, 32, 16, 8, 4, 2, 1)


def init_tree(cfg: ModelConfig, ctx: M.ModelCtx, *, seed: int = 0, device="cuda",
              dtype: Optional[torch.dtype] = None) -> Tree:
    """Seeded random weights (``model.init_params`` at tp = 1) as this
    rank's training tree; ``dtype`` widens or narrows every float leaf (the
    tests' fp32 runs).  At tp > 1 every rank draws the whole model and keeps
    its shard, so one seed is one model at every layout."""
    tree = checkpoint.tree_of(M.init_params(cfg, ParallelConfig(), seed=seed, device=device),
                              cfg)
    if dtype is not None:
        tree = {k: t.to(dtype) if t.is_floating_point() else t for k, t in tree.items()}
    return checkpoint.shard_tree(tree, cfg, ctx.plan, ctx.dist.rank)


def local_batch(batch: Dict[str, np.ndarray], dist: Dist, device) -> Dict[str, torch.Tensor]:
    """This data replica's rows of a global batch, on ``device``: the d-th of
    dp equal row blocks (the JAX package's ``P("data")``)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // dist.dp
        out[k] = torch.from_numpy(np.ascontiguousarray(
            v[dist.data_rank * n:(dist.data_rank + 1) * n])).to(device)
    return out


def _grad(loss: torch.Tensor, tree: Tree) -> Tree:
    """d loss / d leaf for every leaf of ``tree`` (zeros for a leaf the
    loss does not read)."""
    keys = list(tree)
    grads = torch.autograd.grad(loss, [tree[k] for k in keys], allow_unused=True)
    return {k: torch.zeros_like(tree[k]) if g is None else g for k, g in zip(keys, grads)}


def reduce_grads(grads: Tree, sharded: Dict[str, bool], dist: Dist) -> Tree:
    """Every gradient summed over the data replicas, a replicated leaf's
    over the model ranks too: one ``grad_reduce`` record a leaf."""
    out = {}
    for k, g in grads.items():
        axes = (cc.DATA_AXIS,) + (() if sharded[k] else (cc.AXIS,))
        out[k] = cc.psum(g, dist, axes, tag="grad_reduce")
    return out


def grad_norm(grads: Tree, sharded: Dict[str, bool], dist: Dist) -> torch.Tensor:
    """The norm of the whole model's (reduced) gradient: the split leaves'
    squares summed over the model ranks, the replicated ones' counted once."""
    split = {k: g for k, g in grads.items() if sharded[k]}
    rest = {k: g for k, g in grads.items() if not sharded[k]}
    sq = sq_norm(grads) if not split else cc.all_reduce(sq_norm(split), dist, tag="gnorm")
    if split and rest:
        sq = sq + sq_norm(rest)
    return torch.sqrt(sq)


def init_state(tree: Tree, ctx: M.ModelCtx, zero1: bool = False) -> Dict:
    """AdamW's state, or this replica's ZeRO-1 state, for ``tree``."""
    if zero1:
        return init_zero_state(tree, checkpoint.model_sharded(ctx.cfg, ctx.plan), ctx.dist)
    return init_opt_state(tree)


def make_train_step(ctx: M.ModelCtx, opt_cfg: AdamWConfig, aux_weight: Optional[float] = None,
                    *, zero1: bool = False, grad_accum: int = 1):
    """-> ``train_step(tree, opt_state, batch)`` -> (tree, opt_state,
    metrics), the tree and state updated in place.  ``batch`` is this
    replica's rows (``local_batch``): tokens, labels, a frontend's
    features.  ``zero1``: the state is ZeRO-1's (``training/zero.py``).
    ``grad_accum`` = N: N microbatches of the replica's rows, their
    gradients summed in fp32 and averaged, then cast to the leaves'
    dtypes.  Metrics (0-dim tensors): ``loss`` (the cross-entropy),
    ``total_loss``, ``aux`` and ``grad_norm``."""
    cfg, plan, dist = ctx.cfg, ctx.plan, ctx.dist
    M.check_trainable(cfg, ctx.parallel)
    sharded = checkpoint.model_sharded(cfg, plan)
    if aux_weight is None:
        aux_weight = cfg.moe.router_aux_weight if cfg.moe else 0.0

    def loss_fn(tree: Tree, batch: Dict[str, torch.Tensor]):
        params = checkpoint.params_of(tree, cfg, plan, dist.rank)
        hidden, aux = M.train_forward(params, batch["tokens"], cfg, ctx,
                                      features=batch.get("features"))
        if cfg.frontend is not None:
            # the prefix positions predict no token: text token t is read
            # at position prefix + t - 1
            hidden = hidden[:, cfg.frontend.prefix_len:]
        s = hidden.shape[1]
        chunk = next(c for c in XENT_CHUNKS if s % c == 0)
        xent = chunked_vocab_parallel_xent(hidden, lambda h: M.lm_head_local(params, h),
                                           batch["labels"], plan, dist, chunk=chunk)
        aux_m = cc.data_sum_ad(aux, dist, tag="aux_mean", scale=1.0 / dist.dp)
        return xent + aux_weight * aux_m, xent, aux_m

    def grads_of(tree: Tree, batch: Dict[str, torch.Tensor]):
        if grad_accum <= 1:
            total, xent, aux = loss_fn(tree, batch)
            return (total.detach(), xent.detach(), aux.detach()), _grad(total, tree)
        n = grad_accum
        acc = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
               for k, t in tree.items()}
        sums = [0.0, 0.0, 0.0]
        for i in range(n):
            micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
            out = loss_fn(tree, micro)
            for k, g in _grad(out[0], tree).items():
                acc[k] += g.float()
            sums = [a + b.detach() for a, b in zip(sums, out)]
        grads = {k: (a * (1.0 / n)).to(tree[k].dtype) for k, a in acc.items()}
        return tuple(x * (1.0 / n) for x in sums), grads

    def train_step(tree: Tree, opt_state: Dict, batch: Dict[str, torch.Tensor]):
        for t in tree.values():
            t.requires_grad_(True)
        (total, xent, aux), grads = grads_of(tree, batch)
        if zero1:
            tree, opt_state, gnorm = zero_update(tree, grads, opt_state, sharded, opt_cfg, dist)
        else:
            grads = reduce_grads(grads, sharded, dist)
            tree, opt_state, gnorm = adamw_update(tree, grads, opt_state, opt_cfg,
                                                  grad_norm(grads, sharded, dist))
        metrics = {"loss": xent, "total_loss": total, "aux": aux, "grad_norm": gnorm}
        return tree, opt_state, metrics

    train_step.grads = grads_of     # (loss, xent, aux) and the unreduced gradients
    train_step.loss = loss_fn       # (loss, xent, aux) of a batch
    return train_step


__all__ = ["AdamWConfig", "grad_norm", "init_state", "init_tree", "local_batch",
           "make_train_step", "reduce_grads"]
