"""Config registry: ``get_config("<arch-id>")`` for the dense archs the port
serves (the same arch ids as ``repro.configs``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ParallelConfig, SamplingConfig

# arch-id -> module name
_REGISTRY = {
    "yi-9b": "yi_9b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen-72b": "qwen_72b",
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


__all__ = ["ALL_ARCHS", "ModelConfig", "ParallelConfig", "SamplingConfig", "get_config"]
