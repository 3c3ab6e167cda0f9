"""recurrentgemma-9b — hybrid Griffin: RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427].

Pattern is (recurrent, recurrent, local-attn) repeating; 38 layers = 12 full
periods + 2 trailing recurrent blocks. Local attention window 2048 per the
Griffin/RecurrentGemma papers. GQA with a single KV head (MQA).
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    act="gelu",                 # Gemma-family GeGLU
    rope_theta=10000.0,
    rglru=RGLRUConfig(lru_width=0, conv_width=4),
    citation="arXiv:2402.19427 (Griffin); RecurrentGemma-9B card",
)
