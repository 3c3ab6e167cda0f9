"""Checkpoints in the JAX package's flat-key ``.npz`` format
(``repro.training.checkpoint``), with numpy alone, the training tree they
hold, and the packed weight-quantized tree that ``--wq-cache`` persists on
it (``repro.models.model.save_quantized`` / ``load_quantized``).

A checkpoint is ``<path>.npz``: one array per leaf under its tree path
joined by "/" (a packed weight's payload and scale under ``<leaf>/0`` and
``<leaf>/1``, as JAX flattens its ``QuantWeight``), bf16 leaves stored as
fp32 (lossless), and ``<path>.meta.json`` holding ``{"step", "meta",
"n_arrays"}``.  A file either package saved restores in the other.

The training tree (``tree_of``) is the JAX package's parameter tree,
flat: key -> tensor, keyed by those paths -- ``embed/table``,
``groups/<g>/sub<j>/{norm1, norm2, mixer/<leaf>, ffn/<leaf>,
ffn/shared/<leaf>}``, ``final_norm``, ``lm_head`` (none where the head is
tied), ``frontend/<leaf>`` -- each layer group (``build_groups``: the
aligned full periods of the layer pattern, deepseek's dense layer 0 a
group of its own) stacked over its repeats when it repeats.  Training,
its optimizer state, ZeRO-1's chunks and this format all follow it, so
each bridges to the JAX package's leaf by leaf.  ``params_of`` gives the
port's forward its per-layer dicts as views of those leaves.  At tp > 1 a
leaf is this rank's shard in the JAX package's per-shard layout
(``shard_tree``): ``model.shard_leaf``'s, except a KV projection whose
heads are fewer than the ranks, which the JAX package keeps whole
(replicated) and the forward slices.
"""
from __future__ import annotations

import functools
import json
import os
from types import SimpleNamespace
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.wquant import QuantWeight, map_tensors

SEP = "/"
# a sub-layer's leaves outside its mixer (the rest of an attention layer's
# leaves, and an RG-LRU layer's ``mixer.<name>``, are the mixer's)
_NORMS, _FFN = ("norm1", "norm2"), ("w_up", "w_gate", "w_down", "router")
# the leaves the JAX package keeps in fp32 (the rest are bf16)
FP32_LEAVES = ("Lambda", "router", "dt_bias", "A_log", "D")
# KV projections, replicated by the JAX package where the KV heads are fewer
# than the ranks
_KV = ("w_k", "w_v", "b_k", "b_v")


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


class Leaf(NamedTuple):
    """Where a training-tree key lives in the port's params: the leaf's name
    in ``model.layer_param_defs`` (or ``table``, ``final_norm``,
    ``lm_head``, ``frontend.<name>``), its layer family, the layers it
    stacks (none outside the layers) and whether it has the repeat axis."""
    name: str
    family: str
    layers: Tuple[int, ...]
    stacked: bool


def build_groups(cfg: ModelConfig) -> List[Tuple[Tuple[Tuple[str, bool], ...], int]]:
    """The JAX package's layer groups (``build_groups``): ((kind, is_moe)
    of each sub-layer of one period, repeats) in layer order.  An aligned
    full period of the layer pattern whose MoE flags are the pattern's own
    joins the run of equal periods before it; any other layer (deepseek's
    dense layer 0, the layers past the last full period) is a group of its
    own."""
    p, n = len(cfg.layer_pattern), cfg.n_layers
    sig = lambda i: (cfg.block_kind(i), cfg.is_moe_layer(i))

    def period_ok(start: int) -> bool:
        if start % p or start + p > n:
            return False
        return all(sig(start + j) == (cfg.layer_pattern[j], cfg.moe is not None
                                      and cfg.layer_pattern[j] != "ssd")
                   for j in range(p))

    groups, i = [], 0
    while i < n:
        if period_ok(i):
            unit = tuple(sig(i + j) for j in range(p))
            cnt = 0
            while period_ok(i) and tuple(sig(i + j) for j in range(p)) == unit:
                cnt, i = cnt + 1, i + p
            groups.append((unit, cnt))
        else:
            groups.append(((sig(i),), 1))
            i += 1
    return groups


def _sub_path(name: str) -> Tuple[str, ...]:
    """A port layer leaf -> its path inside the JAX sub-layer."""
    if name in _NORMS:
        return (name,)
    if name in _FFN:
        return ("ffn", name)
    if name.startswith("shared."):
        return ("ffn", "shared", name[len("shared."):])
    return ("mixer", name.split(".")[-1])


def _key_order(key: str):
    return [int(p) if p.isdigit() else p for p in key.split(SEP)]


@functools.lru_cache(maxsize=None)
def tree_layout(cfg: ModelConfig) -> Dict[str, Leaf]:
    """key -> ``Leaf`` of every leaf of ``cfg``'s training tree, in the JAX
    package's flatten order (its dicts' sorted keys).  Cached: read it,
    never change it."""
    from repro_torch.models import multimodal
    from repro_torch.models.model import layer_family, layer_param_defs

    out: Dict[str, Leaf] = {"embed/table": Leaf("table", "attn", (), False),
                            "final_norm": Leaf("final_norm", "attn", (), False)}
    if not cfg.tie_embeddings:
        out["lm_head"] = Leaf("lm_head", "attn", (), False)
    if cfg.frontend is not None:
        out.update({f"frontend/{n}": Leaf(f"frontend.{n}", "attn", (), False)
                    for n in multimodal.frontend_defs(cfg)})
    first = 0
    for g, (subs, reps) in enumerate(build_groups(cfg)):
        for j in range(len(subs)):
            ids = tuple(first + r * len(subs) + j for r in range(reps))
            family = layer_family(cfg, ids[0])
            for name in layer_param_defs(cfg, family):
                key = SEP.join(("groups", str(g), f"sub{j}", *_sub_path(name)))
                out[key] = Leaf(name, family, ids, reps > 1)
        first += reps * len(subs)
    return {k: out[k] for k in sorted(out, key=_key_order)}


def _get(params: Dict[str, Any], leaf: Leaf, layer: Optional[int] = None):
    if layer is None:
        if leaf.name == "table":
            return params["embed"]["table"]
        head, _, name = leaf.name.rpartition(".")
        return (params[head] if head else params)[name]
    head, _, name = leaf.name.rpartition(".")
    lay = params["layers"][layer]
    return (lay[head] if head else lay)[name]


def tree_of(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The port's params (``model.init_params``, ``bridge.params_from_jax``;
    a tp=1 tree) -> the training tree: new tensors (or QuantWeights), each
    layer group's leaves stacked over its repeats."""
    out = {}
    for key, leaf in tree_layout(cfg).items():
        if not leaf.layers:
            out[key] = map_tensors(_get(params, leaf), lambda t: t.clone())
        else:
            out[key] = _stack([_get(params, leaf, i) for i in leaf.layers], leaf.stacked)
            if not leaf.stacked:
                out[key] = map_tensors(out[key], lambda t: t.clone())
    return out


def _kv_whole(name: str, plan) -> bool:
    """A KV projection that the JAX package keeps whole at this tp."""
    return name in _KV and plan.tp > 1 and not plan.kv_sharded


def shard_tree(tree: Dict[str, Any], cfg: ModelConfig, plan, rank: int) -> Dict[str, Any]:
    """A tp=1 training tree -> rank ``rank``'s shard of it under ``plan``
    (the JAX package's per-shard layout), each leaf its own contiguous
    tensor."""
    from repro_torch.models.model import shard_leaf

    out = {}
    for key, leaf in tree_layout(cfg).items():
        t = tree[key]
        if plan.tp > 1 and not _kv_whole(leaf.name, plan):
            t = shard_leaf(leaf.name, t, cfg, plan, rank, leaf.family)
        out[key] = map_tensors(t, lambda a: a.contiguous())
    return out


# leaves whose JAX partition spec names the model axis at every tp (a layer
# leaf by its name in ``model.layer_param_defs``; an RG-LRU mixer's every
# leaf; an SSD mixer's but its replicated ``w_bc`` and ``conv_w``, which the
# reference slices at forward time)
_MODEL_SPLIT = {"w_q", "b_q", "w_o", "w_up", "w_gate", "w_down", "lm_head", "w_uq", "w_uk",
                "w_uv", "shared.w_up", "shared.w_gate", "shared.w_down"}


def model_sharded(cfg: ModelConfig, plan) -> Dict[str, bool]:
    """key -> whether the leaf's JAX partition spec names the model axis
    (at tp = 1 too, where ZeRO-1's moment layout still reads it); the rest
    are replicated over the model ranks, and at tp > 1 their gradients are
    summed over them."""
    from repro_torch.core.embedding import table_replicated

    def split(leaf: Leaf) -> bool:
        name = leaf.name
        if name.startswith("mixer."):
            return not (leaf.family.startswith("ssd") and name in ("mixer.w_bc", "mixer.conv_w"))
        if name in _KV:
            return plan.n_kv_p >= plan.tp
        if name == "table":
            return not table_replicated(cfg)
        return name in _MODEL_SPLIT

    return {key: split(leaf) for key, leaf in tree_layout(cfg).items()}


def params_of(tree: Dict[str, Any], cfg: ModelConfig, plan=None, rank: int = 0):
    """The training tree -> the port's params for its forward: per-layer
    dicts of views of the stacked leaves (autograd carries their
    gradients to the leaves).  A whole KV projection (``_kv_whole``) is
    sliced to the rank's columns here, as the JAX package's
    ``_slice_kv_weight`` does each forward."""
    from repro_torch.models.model import shard_leaf

    params: Dict[str, Any] = {"layers": [{} for _ in range(cfg.n_layers)]}
    for key, leaf in tree_layout(cfg).items():
        t = tree[key]
        if plan is not None and _kv_whole(leaf.name, plan):
            t = shard_leaf(leaf.name, t, cfg, plan, rank, leaf.family)
        head, _, name = leaf.name.rpartition(".")
        if not leaf.layers:
            node = params.setdefault("embed", {}) if name == "table" else params
            (node.setdefault(head, {}) if head else node)[name] = t
            continue
        for r, i in enumerate(leaf.layers):
            lay = params["layers"][i]
            (lay.setdefault(head, {}) if head else lay)[name] = t[r] if leaf.stacked else t
    return params


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


def tree_to_flat(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A training tree (torch leaves, QuantWeights too) -> the npz arrays."""
    flat: Dict[str, np.ndarray] = {}
    for key, leaf in tree.items():
        _put(flat, key, leaf)
    return flat


def params_to_flat(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The port's params -> flat arrays keyed as the JAX package flattens its
    tree of the same weights."""
    return tree_to_flat(tree_of(params, cfg))


def save_tree(path: str, tree: Dict[str, Any], *, step: int = 0,
              meta: Optional[Dict] = None) -> None:
    """Save a training tree (or a flat tree of optimizer state) in the JAX
    package's format."""
    save(path, tree_to_flat(tree), step=step, meta=meta)


def restore(path: str, like: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], int]:
    """The JAX package's ``restore``: the checkpoint at ``path`` read into
    the keys of ``like`` (a training tree), each leaf checked against its
    shape and cast to its dtype on its device -> (tree, step)."""
    flat = load_flat(path)
    out = {}
    for key, t in like.items():
        a = flat[key]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint mismatch at {key}: {a.shape} vs {tuple(t.shape)}")
        out[key] = torch.from_numpy(a).to(device=t.device, dtype=t.dtype)
    meta = load_meta(path)
    return out, meta["step"] if meta else 0


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
    (``FP32_LEAVES``), every other float leaf becomes bf16 again."""
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
        node[path[-1]] = _leaf_from_flat(arrays, mode, fp32=path[-1] in FP32_LEAVES)
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
