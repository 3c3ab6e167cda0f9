"""Dense FFN: gated (SwiGLU/GeGLU) or plain 2-matmul (``repro.models.mlp``).

``mlp_hidden`` stops before the down-projection, so that a parallel-residual
layer can fuse ``h @ w_down`` with the attention out-projection
(``models/transformer.py``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import wquant
from repro_torch.models.common import activation


def mlp_hidden(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (..., d) -> the activation h (..., d_ff) that ``w_down`` reads."""
    act = activation(cfg.act)
    up = wquant.matmul(x, params["w_up"])
    return act(wquant.matmul(x, params["w_gate"])) * up if cfg.gated_mlp else act(up)


def mlp_forward(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return wquant.matmul(mlp_hidden(params, x, cfg), params["w_down"])
