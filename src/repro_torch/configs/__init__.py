"""Config registry: ``get_config("<arch-id>")`` for every arch of
``repro.configs`` (the same ids): dense (sequential or parallel residual),
RG-LRU hybrid, MLA, MoE (over a sliding-window ring too), Mamba-2 SSD, and
the modality-prefix VLM and multi-codebook audio decoders."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (FrontendStub, MLAConfig, ModelConfig, MoEConfig,
                                     ParallelConfig, RGLRUConfig, SamplingConfig, SSMConfig)

# arch-id -> module name
_REGISTRY = {
    "yi-9b": "yi_9b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen-72b": "qwen_72b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "gptj-parallel": "gptj_parallel",
    "minicpm3-4b": "minicpm3_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "internvl2-26b": "internvl2_26b",
    "musicgen-medium": "musicgen_medium",
}

ALL_ARCHS = tuple(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    key = name if name in _REGISTRY else name.replace("_", "-")
    if key not in _REGISTRY:
        # also accept module-style ids like qwen2_5_32b
        key = next((a for a, mod in _REGISTRY.items() if mod == name), None)
        if key is None:
            raise KeyError(f"unknown arch {name!r}; the port serves {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[key]}").CONFIG


__all__ = ["ALL_ARCHS", "FrontendStub", "MLAConfig", "ModelConfig", "MoEConfig", "ParallelConfig",
           "RGLRUConfig", "SSMConfig", "SamplingConfig", "get_config"]
