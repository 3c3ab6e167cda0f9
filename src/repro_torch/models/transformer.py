"""Decoder layers: the sequential-residual sub-layer of
``repro.models.transformer.sublayer_forward`` and the layer loop that the
JAX package runs as a ``lax.scan`` over stacked parameters (here a Python
loop over per-layer views of the same stacked tensors)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import rms_norm
from repro_torch.models.mlp import mlp_forward


def sublayer_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                     rope: Tuple[torch.Tensor, torch.Tensor], step: attn.KVStep,
                     layer: int = 0) -> torch.Tensor:
    """x + attn(norm1(x)), then + mlp(norm2(.)): one decoder layer."""
    xa = rms_norm(x, p["norm1"], cfg.rms_eps)
    x = x + attn.gqa_forward(p, xa, cfg, rope=rope, step=step, layer=layer)
    xf = rms_norm(x, p["norm2"], cfg.rms_eps)
    return x + mlp_forward(p, xf, cfg)


def layers_forward(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor,
                   cfg: ModelConfig, **kw) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = sublayer_forward(p, x, cfg, layer=i, **kw)
    return x
