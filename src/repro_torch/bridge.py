"""Weight bridge: the JAX package's parameter tree -> the port's params.

The JAX package draws its weights with ``jax.random`` per leaf, which torch
cannot reproduce; holding the port to the reference therefore means serving
the reference's own weights.  ``params_from_jax`` takes ``Engine.params``
with every leaf converted to numpy (``jax.tree.map(np.asarray, params)``)
and returns the layout of ``repro_torch.models.model``:

* the layer group's leaves are stacked on a leading layer axis
  (``stack_defs``); the group's one sub-layer ``sub0`` holds ``norm1``,
  ``norm2``, ``mixer`` (attention) and ``ffn`` (MLP), which flatten into one
  dict per layer;
* the embed table stays ``(1, V, d)`` and the lm_head ``(1, d, V)``.

bf16 leaves cross bit-exact: numpy holds them as 2-byte values, viewed as
``uint16`` and then as ``torch.bfloat16``.  A weight-quantized tree's
projection leaves are ``repro.core.wquant.QuantWeight``s; they are read by
their fields (``q``, ``scale``, ``mode``, ``group``, ``k``), since this
module imports nothing of the JAX package, and become the port's
``QuantWeight``s with the same bytes.  This module imports neither jax nor
ml_dtypes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.wquant import QuantWeight, map_tensors
from repro_torch.models.common import resolve_device
from repro_torch.models.model import check_supported, layer_param_defs, split_layers


def _is_quant(a) -> bool:
    return all(hasattr(a, f) for f in ("q", "scale", "mode", "group", "k"))


def to_torch(a):
    """numpy array (bf16 included) -> CPU tensor with the same bits; a
    quantized leaf -> the port's QuantWeight of such tensors."""
    if _is_quant(a):
        return QuantWeight(to_torch(a.q), to_torch(a.scale), a.mode, int(a.group), int(a.k))
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _cat_layers(parts: list):
    """Per-group (n, ...) leaves -> one (L, ...) leaf."""
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


def _layer_leaves(group: Dict[str, Any]) -> Dict[str, Any]:
    if set(group) != {"sub0"}:
        raise ValueError(f"a dense layer group holds one sub-layer, got {sorted(group)}")
    sub = group["sub0"]
    return {"norm1": sub["norm1"], "norm2": sub["norm2"], **sub["mixer"], **sub["ffn"]}


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """JAX ``Engine.params`` with numpy leaves -> port params on ``device``
    (the card unless ``device="cpu"`` is asked for)."""
    check_supported(cfg)
    device = resolve_device(device)
    defs = layer_param_defs(cfg)
    parts: Dict[str, list] = {name: [] for name in defs}
    for group in tree["groups"]:
        leaves = _layer_leaves(group)
        if set(leaves) != set(defs):
            raise ValueError(f"layer leaves {sorted(leaves)} != expected {sorted(defs)}")
        stacked = np.asarray(leaves["norm1"]).ndim == 2   # (n, d) when scanned
        for name, a in leaves.items():
            t = to_torch(a)
            parts[name].append(t if stacked else map_tensors(t, lambda a: a[None]))
    stacked = {name: _cat_layers(ts) for name, ts in parts.items()}
    for name, (shape, _, _) in defs.items():
        want = (cfg.n_layers, *shape)
        if _shape(stacked[name]) != want:
            raise ValueError(f"{name}: shape {_shape(stacked[name])} != {want}")
    d, V = cfg.d_model, cfg.vocab_size
    table, head = to_torch(tree["embed"]["table"]), to_torch(tree["lm_head"])
    if tuple(table.shape) != (1, V, d) or _shape(head) != (1, d, V):
        raise ValueError(f"embed {tuple(table.shape)} / lm_head {_shape(head)} "
                         f"!= (1, {V}, {d}) / (1, {d}, {V})")
    stacked = {name: map_tensors(t, lambda a: a.to(device)) for name, t in stacked.items()}
    return {
        "embed": {"table": table.to(device)},
        "layers": split_layers(stacked, cfg.n_layers),
        "final_norm": to_torch(tree["final_norm"]).to(device),
        "lm_head": map_tensors(head, lambda a: a.to(device)),
    }
