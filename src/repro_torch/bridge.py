"""Weight bridge: the JAX package's parameter tree -> the port's params.

The JAX package draws its weights with ``jax.random`` per leaf, which torch
cannot reproduce; holding the port to the reference therefore means serving
the reference's own weights.  ``params_from_jax`` takes ``Engine.params``
with every leaf converted to numpy (``jax.tree.map(np.asarray, params)``)
and returns the layout of ``repro_torch.models.model``:

* the tree holds layer groups in layer order (``build_groups``): a group
  of sub-layers ``sub0``, ``sub1``, ... (one period of the layer pattern)
  whose leaves are stacked on a leading repeat axis when the group is
  scanned (``stack_defs``, n > 1) and are not when it is unrolled (n = 1).
  Repeat r of sub-layer j is layer ``first + r * len(subs) + j``.  A
  sub-layer holds ``norm1``, ``norm2`` (none in a parallel-residual layer),
  ``mixer`` and ``ffn`` (an SSD sub-layer: ``norm1`` and ``mixer`` only);
  an attention (GQA or MLA) mixer's leaves flatten into the layer's dict,
  a recurrent (RG-LRU or SSD) mixer's stay under ``mixer`` (an RG-LRU
  ``w_gate`` is not the FFN's); an MoE ``ffn``'s
  router (fp32) and expert blocks flatten too, and its shared experts'
  MLP stays under ``shared``;
* each family's layers (``model.layer_family``: attention, MLA, RG-LRU,
  each with a dense or an MoE FFN) are stacked in layer order, as
  ``model.init_params`` lays them out: deepseek-moe-16b's unrolled dense
  layer 0 is one family, its scanned MoE layers another;
* the embed table stays ``(ncb, V, d)`` and the lm_head ``(ncb, d, V)``
  (ncb codebooks, 1 but for musicgen-medium); a tied tree has no lm_head
  (the table is the head); a frontend's projector (``norm``, ``w1``,
  ``w2``) crosses as it is, bf16 whatever the quantization;
* with ``dist`` at tp > 1 every leaf of the tp=1 tree is then cut to the
  rank's shard by the rule ``init_params`` follows (``model.shard_leaf``,
  by the leaf's layer family: an expert block by expert, MLA's
  up-projections by head, an RG-LRU mixer by channel):
  quantized leaves too, by their values and scales, so a rank holds the
  JAX package's tp=1 weights, split.  An int4 ``w_down`` whose groups
  straddle the rank boundary raises.

The tree's leaves may also be torch tensors, as ``training.checkpoint``
reads a saved tree back.

Training keeps the JAX package's tree itself, flat (the training tree of
``training/checkpoint.py``): ``tree_from_jax`` takes a numpy JAX tree
(parameters, or moments in their layout) to it, bit for bit and sharded
to the rank's JAX per-shard layout, and ``tree_to_jax`` takes a training
tree (parameters, AdamW's ``m``/``v``, ZeRO-1's moments) back to the
JAX package's nesting as numpy, bf16 leaves widened to fp32 (lossless),
so the tests compare updated parameters and moments leaf by leaf.

bf16 leaves cross bit-exact: numpy holds them as 2-byte values, viewed as
``uint16`` and then as ``torch.bfloat16``.  A weight-quantized tree's
projection leaves are ``repro.core.wquant.QuantWeight``s; they are read by
their fields (``q``, ``scale``, ``mode``, ``group``, ``k``), since this
module imports nothing of the JAX package, and become the port's
``QuantWeight``s with the same bytes (an MoE expert block with two leading
dims, ``(L, E, K, N)``).  This module imports neither jax nor
ml_dtypes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.wquant import QuantWeight, map_tensors
from repro_torch.configs.base import ParallelConfig
from repro_torch.models import multimodal
from repro_torch.models.common import Dist, resolve_device
from repro_torch.models.model import (ModelCtx, check_supported, layer_families,
                                      layer_param_defs, shard_leaf, split_layers)
from repro_torch.models.transformer import RECURRENT


def _is_quant(a) -> bool:
    return all(hasattr(a, f) for f in ("q", "scale", "mode", "group", "k"))


def to_torch(a):
    """numpy array (bf16 included) -> CPU tensor with the same bits; a
    quantized leaf -> the port's QuantWeight of such tensors.  A torch
    tensor (a tree read back from a checkpoint) passes through."""
    if _is_quant(a):
        return QuantWeight(to_torch(a.q), to_torch(a.scale), a.mode, int(a.group), int(a.k))
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _cat_layers(parts: list):
    """Per-layer (1, ...) leaves -> one (n, ...) leaf."""
    if isinstance(parts[0], QuantWeight):
        first = parts[0]
        return QuantWeight(torch.cat([p.q for p in parts]), torch.cat([p.scale for p in parts]),
                           first.mode, first.group, first.k)
    return torch.cat(parts, dim=0)


def _shape(t) -> tuple:
    """The dense shape a leaf stands for (K unpacked for a QuantWeight)."""
    if isinstance(t, QuantWeight):
        return (*t.q.shape[:-2], t.k, t.q.shape[-1])
    return tuple(t.shape)


def _layer_leaves(sub: Dict[str, Any], family: str) -> Dict[str, Any]:
    mixer = sub["mixer"]
    if family in RECURRENT:
        mixer = {f"mixer.{name}": a for name, a in mixer.items()}
    ffn = {}
    for name, a in sub.get("ffn", {}).items():
        if isinstance(a, dict):         # an MoE layer's shared experts
            ffn.update({f"{name}.{n}": t for n, t in a.items()})
        else:
            ffn[name] = a
    norms = {k: sub[k] for k in ("norm1", "norm2") if k in sub}
    return {**norms, **mixer, **ffn}


def _tree_layers(tree: Dict[str, Any], cfg: ModelConfig) -> list:
    """The JAX tree's layers in order: one dict of (1, ...) leaves each."""
    family_of = {i: f for f, idx in layer_families(cfg).items() for i in idx}
    layers = []
    for group in tree["groups"]:
        subs = [f"sub{j}" for j in range(len(group))]
        if not subs or set(subs) != set(group):
            raise ValueError(f"a layer group holds sub-layers sub0, sub1, ..., got {sorted(group)}")
        norm1 = group[subs[0]]["norm1"]
        n = norm1.shape[0] if norm1.ndim == 2 else 0     # 0: an unrolled group
        first = len(layers)
        layers.extend({} for _ in range(max(n, 1) * len(subs)))
        if len(layers) > cfg.n_layers:
            raise ValueError(f"the tree holds more than {cfg.n_layers} layers")
        for j, key in enumerate(subs):
            for name, a in _layer_leaves(group[key], family_of[first + j]).items():
                t = to_torch(a)
                for r in range(max(n, 1)):
                    i = first + r * len(subs) + j
                    layers[i][name] = (map_tensors(t, lambda x: x[r:r + 1]) if n
                                       else map_tensors(t, lambda x: x[None]))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"the tree holds {len(layers)} layers, the config {cfg.n_layers}")
    return layers


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                    dist: Dist = Dist()) -> Dict[str, Any]:
    """JAX ``Engine.params`` with numpy leaves (a tp=1 tree) -> port params
    on ``device`` (the card unless ``device="cpu"`` is asked for): this
    rank's shard of them under ``dist``."""
    check_supported(cfg, ParallelConfig(tp=dist.tp))
    device = resolve_device(device)
    plan = ModelCtx.make(cfg, ParallelConfig(tp=dist.tp, dp=dist.dp), dist).plan

    def place(name, t, family="attn"):
        return map_tensors(shard_leaf(name, t, cfg, plan, dist.rank, family),
                           lambda a: a.contiguous().to(device))

    per_layer = _tree_layers(tree, cfg)
    layers: list = [None] * cfg.n_layers
    for family, idx in layer_families(cfg).items():
        defs = layer_param_defs(cfg, family)
        for i in idx:
            if set(per_layer[i]) != set(defs):
                raise ValueError(f"layer {i} leaves {sorted(per_layer[i])} != expected "
                                 f"{sorted(defs)}")
        stacked = {name: _cat_layers([per_layer[i][name] for i in idx]) for name in defs}
        for name, d in defs.items():
            want = (len(idx), *d.shape)
            if _shape(stacked[name]) != want:
                raise ValueError(f"{name}: shape {_shape(stacked[name])} != {want}")
        stacked = {name: place(name, t, family) for name, t in stacked.items()}
        for i, layer in zip(idx, split_layers(stacked, len(idx))):
            layers[i] = layer
    d, V, ncb = cfg.d_model, cfg.vocab_size, cfg.n_codebooks
    table = to_torch(tree["embed"]["table"])
    if ("lm_head" in tree) == cfg.tie_embeddings:
        raise ValueError(f"an lm_head leaf with tie_embeddings={cfg.tie_embeddings}")
    head = None if cfg.tie_embeddings else to_torch(tree["lm_head"])
    if tuple(table.shape) != (ncb, V, d) or (head is not None and _shape(head) != (ncb, d, V)):
        raise ValueError(f"embed {tuple(table.shape)} / lm_head {head and _shape(head)} "
                         f"!= ({ncb}, {V}, {d}) / ({ncb}, {d}, {V})")
    out = {
        "embed": {"table": place("table", table)},
        "layers": layers,
        "final_norm": to_torch(tree["final_norm"]).to(device),
    }
    if head is not None:
        out["lm_head"] = place("lm_head", head)
    if ("frontend" in tree) != (cfg.frontend is not None):
        raise ValueError(f"a frontend leaf with frontend={cfg.frontend}")
    if cfg.frontend is not None:
        defs = multimodal.frontend_defs(cfg)
        front = {name: to_torch(a) for name, a in tree["frontend"].items()}
        shapes = {n: spec[0] for n, spec in defs.items()}
        if {n: tuple(t.shape) for n, t in front.items()} != shapes:
            raise ValueError(f"frontend leaves {sorted(front)} != {sorted(defs)} by shape")
        out["frontend"] = {name: t.to(device) for name, t in front.items()}
    return out


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A nested JAX tree (dicts, lists and tuples) -> {"a/0/b": leaf},
    the keys of its ``checkpoint`` flattening."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cuda",
                  dist: Dist = Dist()) -> Dict[str, torch.Tensor]:
    """A numpy JAX parameter tree (tp=1) -> this rank's training tree on
    ``device`` (the card unless ``device="cpu"`` is asked for), the same
    bits, in the training tree's key order."""
    from repro_torch.training import checkpoint

    device = resolve_device(device)
    flat = flatten(tree)
    layout = checkpoint.tree_layout(cfg)
    if set(flat) != set(layout):
        raise ValueError(f"the tree's leaves {sorted(set(flat) ^ set(layout))} do not match "
                         f"{cfg.name}'s")
    plan = ModelCtx.make(cfg, ParallelConfig(tp=dist.tp, dp=dist.dp), dist).plan
    full = {k: to_torch(flat[k]) for k in layout}
    return {k: t.to(device) for k, t in
            checkpoint.shard_tree(full, cfg, plan, dist.rank).items()}


def tree_to_jax(flat: Dict[str, Any]) -> Dict[str, Any]:
    """A flat tree of torch tensors (a training tree, or any flat state
    keyed so) -> the JAX package's nesting, numpy leaves (bf16 as fp32,
    lossless); a "groups" node is a tuple, as the JAX tree holds it."""
    out: Dict[str, Any] = {}
    for key, t in flat.items():
        node, parts = out, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = t.detach().cpu()
        node[parts[-1]] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return tuple(node[str(i)] for i in range(len(node)))
        return node

    return fix(out)
