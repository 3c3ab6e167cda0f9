"""Checkpoints in the JAX package's flat-key ``.npz`` format
(``repro.training.checkpoint``), with numpy alone, and the packed
weight-quantized tree that ``--wq-cache`` persists on it
(``repro.models.model.save_quantized`` / ``load_quantized``).

A checkpoint is ``<path>.npz``: one array per leaf under its tree path
joined by "/" (a packed weight's payload and scale under ``<leaf>/0`` and
``<leaf>/1``, as JAX flattens its ``QuantWeight``), bf16 leaves stored as
fp32 (lossless), and ``<path>.meta.json`` holding ``{"step", "meta",
"n_arrays"}``.  The quantized tree is written in the JAX package's
parameter layout -- layer groups of sub-layers, a scanned group's leaves
stacked over its repeats -- so that a file either package saved reads back
through ``bridge.params_from_jax``.
"""
from __future__ import annotations

import json
import os
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.wquant import QuantWeight

SEP = "/"
# a sub-layer's leaves outside its mixer (the rest of an attention layer's
# leaves, and an RG-LRU layer's ``mixer.<name>``, are the mixer's)
_NORMS, _FFN = ("norm1", "norm2"), ("w_up", "w_gate", "w_down")


def _stem(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save(path: str, flat: Dict[str, np.ndarray], *, step: int = 0,
         meta: Optional[Dict] = None) -> None:
    """Write ``flat`` (key -> numpy array; no bf16, which npz cannot hold)
    and its sidecar metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_stem(path) + ".npz", **flat)
    with open(path + ".meta.json", "w") as f:
        json.dump({"step": step, "meta": meta or {}, "n_arrays": len(flat)}, f)


def load_meta(path: str) -> Optional[Dict]:
    """The sidecar metadata of the checkpoint at ``path``, or None when
    there is none (the raw path and the ``.npz``-stripped stem are tried,
    as the JAX package does)."""
    for meta_path in (path + ".meta.json", _stem(path) + ".meta.json"):
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                return json.load(f)
    return None


def load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(_stem(path) + ".npz") as data:
        return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# The packed weight-quantized tree (--wq-cache)
# ---------------------------------------------------------------------------


def wq_meta(cfg: ModelConfig, parallel: ParallelConfig) -> Dict[str, Any]:
    """What the packed layout depends on (the JAX package's ``_wq_meta``
    less ``backend``: its Pallas and jnp paths pack alike, so a file saved
    under either loads)."""
    return {"arch": cfg.name, "weight_quant": parallel.weight_quant,
            "wq_group_size": parallel.wq_group_size, "tp": parallel.tp}


def has_quantized(path: str) -> bool:
    return load_meta(path) is not None


def layer_groups(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """The JAX package's layer groups (``build_groups``) for the configs the
    port serves: (kinds of one period, repeats) in layer order -- the
    aligned full periods of the layer pattern as one group, each layer left
    over as a group of its own."""
    p, n = len(cfg.layer_pattern), cfg.n_layers
    groups = [(tuple(cfg.layer_pattern), n // p)] if n // p else []
    return groups + [((cfg.block_kind(i),), 1) for i in range(n // p * p, n)]


def _sub_path(name: str) -> Tuple[str, ...]:
    """A port layer leaf -> its path inside the JAX sub-layer."""
    if name in _NORMS:
        return (name,)
    if name in _FFN:
        return ("ffn", name)
    return ("mixer", name.split(".")[-1])


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).contiguous().numpy()


def _put(flat: Dict[str, np.ndarray], key: str, leaf) -> None:
    if isinstance(leaf, QuantWeight):
        flat[key + SEP + "0"], flat[key + SEP + "1"] = _to_numpy(leaf.q), _to_numpy(leaf.scale)
    else:
        flat[key] = _to_numpy(leaf)


def _stack(leaves: list, stacked: bool):
    if not stacked:
        return leaves[0]
    if isinstance(leaves[0], QuantWeight):
        first = leaves[0]
        return QuantWeight(torch.stack([w.q for w in leaves]),
                           torch.stack([w.scale for w in leaves]), first.mode, first.group,
                           first.k)
    return torch.stack(leaves)


def params_to_flat(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's params -> flat arrays keyed as the JAX package flattens its
    tree of the same weights."""
    flat: Dict[str, np.ndarray] = {}
    first = 0
    for g, (kinds, reps) in enumerate(layer_groups(cfg)):
        for j in range(len(kinds)):
            layers = [params["layers"][first + r * len(kinds) + j] for r in range(reps)]
            names = [f"mixer.{k}" for k in layers[0].get("mixer", {})]
            names += [k for k in layers[0] if k != "mixer"]
            for name in names:
                head, _, leaf = name.rpartition(".")
                parts = [(lay[head] if head else lay)[leaf] for lay in layers]
                key = SEP.join(("groups", str(g), f"sub{j}", *_sub_path(name)))
                _put(flat, key, _stack(parts, reps > 1))
        first += reps * len(kinds)
    _put(flat, "embed/table", params["embed"]["table"])
    _put(flat, "final_norm", params["final_norm"])
    _put(flat, "lm_head", params["lm_head"])
    return flat


def _leaf_from_flat(arrays: Dict[str, np.ndarray], mode: str, fp32: bool):
    """npz arrays of one leaf -> a torch tensor of its stored type (bf16
    unless ``fp32``), or a packed weight's fields for the bridge."""
    if set(arrays) == {"0", "1"}:
        q, scale = torch.from_numpy(arrays["0"]), torch.from_numpy(arrays["1"]).bfloat16()
        k = q.shape[-2] * (2 if mode == "int4" else 1)
        group = k // scale.shape[-2] if mode == "int4" else 0
        return SimpleNamespace(q=q, scale=scale, mode=mode, group=group, k=k)
    a = torch.from_numpy(arrays[""])
    return a if fp32 or not a.is_floating_point() else a.bfloat16()


def flat_to_tree(flat: Dict[str, np.ndarray], mode: str) -> Dict[str, Any]:
    """Flat arrays -> the JAX package's nested tree (groups as a list), its
    leaves torch tensors in their stored types; fp32 leaves stay fp32
    (``Lambda``), every other float leaf becomes bf16 again."""
    leaves: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for key, a in flat.items():
        parts = key.split(SEP)
        if parts[-1] in ("0", "1") and len(parts) > 1:
            leaves.setdefault(tuple(parts[:-1]), {})[parts[-1]] = a
        else:
            leaves.setdefault(tuple(parts), {})[""] = a
    tree: Dict[str, Any] = {}
    for path, arrays in leaves.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _leaf_from_flat(arrays, mode, fp32=path[-1] == "Lambda")
    groups = tree.get("groups", {})
    tree["groups"] = [groups[str(i)] for i in range(len(groups))]
    return tree


def save_quantized(params: Dict[str, Any], cfg: ModelConfig, parallel: ParallelConfig,
                   path: str) -> None:
    """Persist an already-quantized param tree (packed payloads, scales and
    the bf16 rest) with the meta that ``load_quantized`` checks."""
    save(path, params_to_flat(params, cfg), meta=wq_meta(cfg, parallel))


def load_quantized(path: str, cfg: ModelConfig, parallel: ParallelConfig, device="cuda"):
    """Restore a packed tree saved by ``save_quantized`` or by the JAX
    package's onto ``device``.  A meta that does not match ``cfg`` and
    ``parallel`` is an error: the bytes would be read in another layout."""
    from repro_torch.bridge import params_from_jax

    meta = load_meta(path)
    if meta is None:
        raise FileNotFoundError(f"no quantized checkpoint at {path}")
    want = wq_meta(cfg, parallel)
    got = {k: meta.get("meta", {}).get(k) for k in want}
    if got != want:
        raise ValueError(f"quantized checkpoint {path} was packed for {got}, "
                         f"the engine wants {want}")
    return params_from_jax(flat_to_tree(load_flat(path), parallel.weight_quant), cfg,
                           device=device)
