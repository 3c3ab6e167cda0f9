"""Dense FFN: gated (SwiGLU/GeGLU) or plain 2-matmul (``repro.models.mlp``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import wquant
from repro_torch.models.common import activation


def mlp_forward(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    up = wquant.matmul(x, params["w_up"])
    h = act(wquant.matmul(x, params["w_gate"])) * up if cfg.gated_mlp else act(up)
    return wquant.matmul(h, params["w_down"])
