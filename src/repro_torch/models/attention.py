"""Dense GQA/MHA attention with RoPE and optional QKV bias: the subset of
``repro.models.attention.gqa_forward`` that serves a dense decoder at tp=1
over a dense KV cache.

The cache is one dict for the whole model (see ``model.init_caches``):
``k``/``v`` of shape (L, b, hkv, S, hd) and one position row ``pos`` (S,)
that every layer shares, since in wave serving all layers hold the same
positions.  Writes are in place, which is what buffer donation gives the
JAX package.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import wquant
from repro_torch.core.zero_copy import fused_out_projection
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope


def decode_attention(q, k, v, valid, scale: float) -> torch.Tensor:
    """Single-token attention over the cache, normalized: the decode kernel's
    partials divided out (``decode_attention_shardable`` without seq
    sharding)."""
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def gqa_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, rope: Tuple[torch.Tensor, torch.Tensor],
                cache: Optional[Dict[str, Any]] = None, layer: int = 0,
                cur_pos: Optional[int] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (b, s, d) -> attention output (b, s, d) after the out-projection.
    ``rope`` holds the (cos, sin) tables of ``positions``.

    Prefill (``cur_pos`` None): writes K/V at view [0, s) of ``cache`` (if
    given) and attends the fresh K/V causally through the flash-prefill
    kernel.  Decode (``cur_pos`` an int, s == 1): writes K/V at ``cur_pos``
    and attends the cache entries that ``valid`` (S,) marks."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    scale = 1.0 / math.sqrt(hd)

    q = wquant.matmul(x, p["w_q"])
    k = wquant.matmul(x, p["w_k"])
    v = wquant.matmul(x, p["w_v"])
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = apply_rope(q.view(b, s, hq, hd).transpose(1, 2), *rope)
    k = apply_rope(k.view(b, s, hkv, hd).transpose(1, 2), *rope)
    v = v.view(b, s, hkv, hd).transpose(1, 2)

    if cur_pos is not None:
        ck, cv = cache["k"][layer], cache["v"][layer]
        ck[:, :, cur_pos] = k[:, :, 0]
        cv[:, :, cur_pos] = v[:, :, 0]
        out = decode_attention(q.contiguous(), ck, cv, valid, scale)
    else:
        if cache is not None:
            cache["k"][layer, :, :, :s] = k
            cache["v"][layer, :, :, :s] = v
        q_pos = positions.to(torch.int32).expand(b, s)
        out = ops.flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                                q_pos.contiguous(), scale)
    return fused_out_projection(out, p["w_o"])
