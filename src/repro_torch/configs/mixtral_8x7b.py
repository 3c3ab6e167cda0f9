"""mixtral-8x7b -- MoE 8 experts top-2 with sliding-window attention
[arXiv:2401.04088]; the JAX package's ``repro.configs.mixtral_8x7b``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,                 # == expert_d_ff; no dense FFN layers
    vocab_size=32000,
    layer_pattern=("local_attn",),
    window=4096,                # SWA per Mistral-7B/Mixtral
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=14336),
    citation="arXiv:2401.04088 (Mixtral of Experts)",
)
