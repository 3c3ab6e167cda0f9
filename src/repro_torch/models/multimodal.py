"""The modality frontend's projector (``repro.models.multimodal``).

The encoder itself (InternViT, EnCodec) is a stub, as in the JAX package:
the caller gives precomputed patch or frame features, (batch, prefix_len,
feature_dim).  The projector that maps them into the decoder's d_model is
part of the language model: RMSNorm, then a 2-layer MLP with a tanh GELU
between, plain matmuls as the reference's jnp (no kernel).  Its weights are
replicated, and the projected prefix stands in front of the prompt's
token activations, so positions run over prefix + prompt.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import gelu_tanh, rms_norm


def frontend_defs(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init rule, fan-in) of the projector's leaves."""
    f, d = cfg.frontend, cfg.d_model
    return {"norm": ((f.feature_dim,), "zeros", 0),
            "w1": ((f.feature_dim, d), "scaled", f.feature_dim),
            "w2": ((d, d), "scaled", d)}


def project_features(params: Dict[str, torch.Tensor], features: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """(b, prefix_len, feature_dim) features -> (b, prefix_len, d_model)
    bf16: RMSNorm of the features cast to bf16, tanh GELU of ``@ w1``, then
    ``@ w2``.  The normed features stay bf16 whatever the projector's dtype,
    and meet fp32 weights (a training run's fp32 tree) promoted, as jnp
    promotes them."""
    h = rms_norm(features.to(torch.bfloat16), params["norm"], cfg.rms_eps)
    w1 = params["w1"]
    return gelu_tanh(h.to(torch.promote_types(h.dtype, w1.dtype)) @ w1) @ params["w2"]
