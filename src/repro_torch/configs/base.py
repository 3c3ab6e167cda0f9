"""Configuration dataclasses for the PyTorch port.

A copy of the dense-decoder part of ``repro.configs.base``: the field names,
defaults and ``reduced()`` rule are the same, so a config built here
describes the same model as its JAX namesake.  The family features the port
does not serve yet (MoE, MLA, SSM, RG-LRU, sliding windows, frontends,
multi-codebook heads, parallel residual, tied embeddings) keep their fields,
so that ``repro_torch.models.model.check_supported`` can name what a config
needs and refuse it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("attn",)
    qkv_bias: bool = False
    parallel_residual: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    window: int = 0             # sliding-window size (0 = full causal)
    act: str = "silu"           # silu (gated) | gelu
    gated_mlp: bool = True      # SwiGLU vs plain 2-matmul MLP
    n_codebooks: int = 1
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    ssm: Optional[Any] = None
    rglru: Optional[Any] = None
    frontend: Optional[Any] = None
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Parameters of the dense decoder: embed, attention, FFN, lm_head."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        ffn = (3 if self.gated_mlp else 2) * d * self.d_ff
        heads = 1 if self.tie_embeddings else 2
        return heads * self.vocab_size * d * self.n_codebooks + self.n_layers * (attn + ffn)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256, head_dim 64 (the
        dense part of ``repro.configs.base.ModelConfig.reduced``)."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64) if self.window else 0,
        )


@dataclass(frozen=True)
class ParallelConfig:
    """The layout fields the port reads.  Weight-only quantization is
    served (quantize at load: int8 per-output-column scales, int4 scales per
    ``wq_group_size`` segment of the reduction dim); tensor parallelism and
    the int8 KV cache come in later slices, and ``check_supported`` refuses
    them."""

    tp: int = 1
    kv_quant: bool = False
    weight_quant: str = "none"  # none | int8 | int4
    wq_group_size: int = 128    # int4 group length along the reduction dim


@dataclass(frozen=True)
class SamplingConfig:
    top_k: int = 40             # 1 = greedy
    temperature: float = 1.0
