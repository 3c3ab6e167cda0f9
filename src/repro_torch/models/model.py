"""Top-level dense decoder: parameters, caches and forward
(``repro.models.model`` for the dense family at tp=1).

Parameters are a plain dict::

    {"embed": {"table": (1, V, d)},
     "layers": [ {norm1, w_q, w_k, w_v, w_o, [b_q, b_k, b_v], norm2,
                  w_up, [w_gate], w_down}, ... one per layer ],
     "final_norm": (d,), "lm_head": (1, d, V)}

Each per-layer tensor is a view into one tensor stacked over the layers,
the layout of the JAX package's scanned layer group.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.embedding import embed_lookup
from repro_torch.models.common import init_leaf, resolve_device, rms_norm, rope_tables
from repro_torch.models.transformer import layers_forward

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig()) -> None:
    """Raise NotImplementedError naming every feature of ``cfg`` and
    ``parallel`` that the port does not serve yet."""
    missing = []
    if cfg.moe is not None:
        missing.append("moe (mixture-of-experts FFN)")
    if cfg.mla is not None:
        missing.append("mla (multi-head latent attention)")
    if cfg.ssm is not None:
        missing.append("ssm (Mamba-2 blocks)")
    if cfg.rglru is not None:
        missing.append("rglru (RG-LRU blocks)")
    if set(cfg.layer_pattern) != {"attn"}:
        missing.append(f"layer_pattern {cfg.layer_pattern} (only full-attention layers)")
    if cfg.window:
        missing.append("window (sliding-window attention)")
    if cfg.frontend is not None:
        missing.append("frontend (modality prefix)")
    if cfg.n_codebooks != 1:
        missing.append("n_codebooks>1 (multi-codebook heads)")
    if cfg.parallel_residual:
        missing.append("parallel_residual")
    if cfg.tie_embeddings:
        missing.append("tie_embeddings")
    if parallel.kv_quant:
        missing.append("kv_quant (int8 KV cache)")
    if parallel.weight_quant != "none":
        missing.append(f"weight_quant={parallel.weight_quant}")
    if parallel.tp != 1:
        missing.append("tp>1 (tensor parallelism)")
    if missing:
        raise NotImplementedError(f"{cfg.name}: the PyTorch port does not serve "
                                  f"{', '.join(missing)} yet")


def layer_param_defs(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], str, int]]:
    """name -> (shape of one layer, init rule, fan_in): the JAX ParamDefs
    of one dense sub-layer (``attn_defs``, ``mlp_defs``, the two norms)."""
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"{cfg.name}: n_heads {cfg.n_heads} not a multiple of "
                         f"n_kv_heads {cfg.n_kv_heads}")
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    q_cols, kv_cols = cfg.n_heads * hd, cfg.n_kv_heads * hd
    defs = {
        "norm1": ((d,), "zeros", 0),
        "w_q": ((d, q_cols), "scaled", d),
        "w_k": ((d, kv_cols), "scaled", d),
        "w_v": ((d, kv_cols), "scaled", d),
        "w_o": ((cfg.n_heads, hd, d), "scaled", hd),
        "norm2": ((d,), "zeros", 0),
        "w_up": ((d, f), "scaled", d),
        "w_down": ((f, d), "scaled", f),
    }
    if cfg.qkv_bias:
        defs.update(b_q=((q_cols,), "zeros", 0), b_k=((kv_cols,), "zeros", 0),
                    b_v=((kv_cols,), "zeros", 0))
    if cfg.gated_mlp:
        defs["w_gate"] = ((d, f), "scaled", d)
    return defs


def split_layers(stacked: Dict[str, torch.Tensor], n_layers: int) -> List[Dict[str, torch.Tensor]]:
    """Stacked (L, ...) tensors -> one dict of views per layer."""
    return [{k: t[i] for k, t in stacked.items()} for i in range(n_layers)]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights by the JAX package's init rules (normal std 0.02,
    scaled 1/sqrt(fan_in), zeros), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  The draws differ from
    ``jax.random``'s, so parity with the JAX package goes through
    ``repro_torch.bridge`` instead."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    stacked = {}
    for name, (shape, rule, fan_in) in layer_param_defs(cfg).items():
        t = torch.empty((L, *shape), dtype=torch.bfloat16, device=device)
        for i in range(L):   # per layer: an fp32 draw of one layer at a time
            t[i] = init_leaf(shape, rule, gen, device=device, fan_in=fan_in)
        stacked[name] = t
    return {
        "embed": {"table": init_leaf((1, V, d), "normal", gen, device=device)},
        "layers": split_layers(stacked, L),
        "final_norm": init_leaf((d,), "zeros", gen, device=device),
        "lm_head": init_leaf((1, d, V), "scaled", gen, device=device, fan_in=d),
    }


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *, device) -> Dict[str, torch.Tensor]:
    """Dense KV cache for all layers; ``pos`` -1 marks an empty entry."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
    }


def lm_head(params: Params, x: torch.Tensor, head_f32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (b, s, d) -> logits (b, s, V) in fp32, as ``_lm_head`` computes them.
    ``head_f32`` is a resident fp32 copy of ``lm_head[0]``; without one the
    head is cast for this call."""
    head = head_f32 if head_f32 is not None else params["lm_head"][0].float()
    return x.float() @ head


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[Dict[str, torch.Tensor]] = None,
            cur_pos: Optional[int] = None, last_only: bool = False,
            head_f32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (b, s) -> fp32 logits (b, s or 1, V).

    Without ``cur_pos`` this is a prefill from position 0 (writing the
    cache when one is given); with ``cur_pos`` it is one decode step
    (s == 1) at that position of ``caches``."""
    b, s = tokens.shape
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens)
    valid = None
    if cur_pos is not None:
        if s != 1 or caches is None:
            raise ValueError("a decode step takes one token per row and a cache")
        S = caches["pos"].shape[0]
        if not 0 <= cur_pos < S:
            raise ValueError(f"decode position {cur_pos} outside the cache of {S}")
        caches["pos"][cur_pos] = cur_pos
        valid = (caches["pos"] >= 0) & (caches["pos"] <= cur_pos)
        positions = torch.arange(cur_pos, cur_pos + 1, device=dev)
    else:
        positions = torch.arange(s, device=dev)
        if caches is not None:
            S = caches["pos"].shape[0]
            if s > S:
                raise ValueError(f"prompt of {s} tokens is longer than the cache of {S}")
            caches["pos"].fill_(-1)
            caches["pos"][:s] = positions
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    x = layers_forward(params["layers"], x, positions, cfg, rope=rope, cache=caches,
                       cur_pos=cur_pos, valid=valid)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if last_only:
        x = x[:, -1:]
    return lm_head(params, x, head_f32)
