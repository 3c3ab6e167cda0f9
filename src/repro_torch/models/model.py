"""Top-level dense decoder: parameters, caches and forward
(``repro.models.model`` for the dense family at tp=1).

Parameters are a plain dict::

    {"embed": {"table": (1, V, d)},
     "layers": [ {norm1, w_q, w_k, w_v, w_o, [b_q, b_k, b_v], norm2,
                  w_up, [w_gate], w_down}, ... one per layer ],
     "final_norm": (d,), "lm_head": (1, d, V)}

Each per-layer tensor is a view into one tensor stacked over the layers,
the layout of the JAX package's scanned layer group.  Under weight-only
quantization the projections and the lm_head are ``QuantWeight``s whose
packed values and scales are such views too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import wquant
from repro_torch.core.wquant import QuantWeight
from repro_torch.core.embedding import embed_lookup
from repro_torch.models.common import init_leaf, resolve_device, rms_norm, rope_tables
from repro_torch.models.transformer import layers_forward

Params = Dict[str, Any]

# The leaves weight-only quantization covers (``_map_wq_leaves``), with how
# the forward consumes each: "matmul" through the dequant_matmul kernel,
# "einsum" dequantized for a batched contraction (the out-projection w_o,
# (n_heads, hd, d)).  Embed, norms and biases stay bf16.
WQ_SITES = {"w_q": "matmul", "w_k": "matmul", "w_v": "matmul", "w_o": "einsum",
            "w_up": "matmul", "w_gate": "matmul", "w_down": "matmul", "lm_head": "matmul"}


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
    if parallel.weight_quant not in ("none", *wquant.MODES):
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


def split_layers(stacked: Dict[str, Any], n_layers: int) -> List[Dict[str, Any]]:
    """Stacked (L, ...) tensors or QuantWeights -> one dict of views per layer."""
    return [{k: wquant.map_tensors(t, lambda a: a[i]) for k, t in stacked.items()}
            for i in range(n_layers)]


def _quantized_empty(shape, mode: str, group_size: int, device) -> QuantWeight:
    """Uninitialised storage for the quantized form of a (*B, K, N) weight."""
    *lead, k, n = shape
    if mode == "int8":
        return QuantWeight(torch.empty(shape, dtype=torch.int8, device=device),
                           torch.empty((*lead, n), dtype=torch.bfloat16, device=device),
                           "int8", 0, k)
    g = wquant.effective_group(k, group_size)
    return QuantWeight(torch.empty((*lead, k // 2, n), dtype=torch.uint8, device=device),
                       torch.empty((*lead, k // g, n), dtype=torch.bfloat16, device=device),
                       "int4", g, k)


def _quantize_into(dst: QuantWeight, w: torch.Tensor, group_size: int, cols: int = 8192) -> None:
    """Quantize ``w`` into ``dst``'s storage a block of columns at a time:
    every scale belongs to one column, so the bytes are those of one
    ``quantize`` call, and the fp32 temporaries stay at K x 8192."""
    for c in range(0, w.shape[-1], cols):
        qw = wquant.quantize(w[..., c:c + cols], dst.mode, group_size)
        dst.q[..., c:c + cols] = qw.q
        dst.scale[..., c:c + cols] = qw.scale


def _quantizes(name: str, shape, parallel: ParallelConfig) -> bool:
    return (parallel.weight_quant != "none" and name in WQ_SITES
            and wquant.quantizable(shape, parallel.weight_quant, parallel.wq_group_size))


def init_params(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), *,
                seed: int = 0, device="cuda") -> Params:
    """Random weights by the JAX package's init rules (normal std 0.02,
    scaled 1/sqrt(fan_in), zeros), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  The draws differ from
    ``jax.random``'s, so parity with the JAX package goes through
    ``repro_torch.bridge`` instead.

    With ``parallel.weight_quant`` set, each layer's leaf is drawn in bf16,
    quantized and written into the stacked packed storage before the next
    is drawn, so the bf16 tree never exists (qwen-72b's does not fit one
    card).  The draws are the same as without quantization: the result is
    ``quantize_params`` of the bf16 weights of the same seed."""
    check_supported(cfg, parallel)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    mode, gs = parallel.weight_quant, parallel.wq_group_size
    stacked = {}
    for name, (shape, rule, fan_in) in layer_param_defs(cfg).items():
        quant = _quantizes(name, shape, parallel)
        if quant:
            t = _quantized_empty((L, *shape), mode, gs, device)
        else:
            t = torch.empty((L, *shape), dtype=torch.bfloat16, device=device)
        for i in range(L):   # per layer: an fp32 draw of one layer at a time
            leaf = init_leaf(shape, rule, gen, device=device, fan_in=fan_in)
            if quant:
                _quantize_into(wquant.index_batch(t, i), leaf, gs)
            else:
                t[i] = leaf
        stacked[name] = t
    table = init_leaf((1, V, d), "normal", gen, device=device)
    final_norm = init_leaf((d,), "zeros", gen, device=device)
    head = init_leaf((1, d, V), "scaled", gen, device=device, fan_in=d)
    if _quantizes("lm_head", head.shape, parallel):
        qhead = _quantized_empty(head.shape, mode, gs, device)
        _quantize_into(qhead, head, gs)
        head = qhead
    return {"embed": {"table": table}, "layers": split_layers(stacked, L),
            "final_norm": final_norm, "lm_head": head}


def quantize_params(params: Params, parallel: ParallelConfig) -> Params:
    """Quantize at load (``repro.models.model.quantize_params`` at tp=1):
    the bf16 leaves of ``WQ_SITES`` and the lm_head become QuantWeights in
    new stacked storage; leaves already quantized pass through, and shapes
    that do not quantize stay bf16."""
    if parallel.weight_quant == "none":
        return params
    mode, gs = parallel.weight_quant, parallel.wq_group_size
    layers = params["layers"]
    new_layers = [dict(p) for p in layers]
    for name in WQ_SITES:
        first = layers[0].get(name)   # None for the lm_head
        if first is None or isinstance(first, QuantWeight) or not _quantizes(name, first.shape, parallel):
            continue
        dst = _quantized_empty((len(layers), *first.shape), mode, gs, first.device)
        for i, p in enumerate(layers):
            view = wquant.index_batch(dst, i)
            _quantize_into(view, p[name], gs)
            new_layers[i][name] = view
    out = dict(params, layers=new_layers)
    head = params["lm_head"]
    if not isinstance(head, QuantWeight) and _quantizes("lm_head", head.shape, parallel):
        out["lm_head"] = _quantized_empty(head.shape, mode, gs, head.device)
        _quantize_into(out["lm_head"], head, gs)
    return out


def decode_weight_bytes(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig()) -> Dict[str, int]:
    """Weight bytes one decode token sweeps, from shapes alone
    (``repro.models.model.decode_weight_bytes`` at tp=1).  ``quantized``:
    the leaves the transform covers, at their packed size; ``dense``: the
    rest (norms, biases, unquantized projections) in bf16;
    ``quantized_ref_einsum``: the part of ``quantized`` served by
    dequantizing (w_o), which also writes and reads a bf16 copy per step;
    ``swept``: the sum.  The embed table is left out: a token reads one
    row of it."""
    L = cfg.n_layers
    leaves = [(name, (L, *shape)) for name, (shape, _, _) in layer_param_defs(cfg).items()]
    leaves += [("final_norm", (cfg.d_model,)), ("lm_head", (1, cfg.d_model, cfg.vocab_size))]
    quantized = dense = ref_einsum = 0
    for name, shape in leaves:
        if _quantizes(name, shape, parallel):
            b = wquant.quant_bytes(shape, parallel.weight_quant, parallel.wq_group_size)
            quantized += b
            ref_einsum += b if WQ_SITES[name] == "einsum" else 0
        else:
            dense += 2 * math.prod(shape)
    return {"quantized": quantized, "dense": dense, "quantized_ref_einsum": ref_einsum,
            "swept": quantized + dense}


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
    A quantized head goes through the dequant_matmul kernel with fp32 out.
    ``head_f32`` is a resident fp32 copy of a bf16 ``lm_head[0]``; without
    one the head is cast for this call."""
    head = params["lm_head"]
    if isinstance(head, QuantWeight):
        return wquant.matmul(x, wquant.index_batch(head, 0), out_dtype=torch.float32)
    head = head_f32 if head_f32 is not None else head[0].float()
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
