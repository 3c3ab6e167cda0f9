"""qwen-72b — the paper's own experiment model (§3) [arXiv:2309.16609].

Qwen-72B: 80 layers, d_model 8192, 64 MHA heads, d_ff 24576, vocab 151936,
QKV bias. This config reproduces the paper's headline measurement target
(140 ms/token at TP=4 on 4x Xeon 8575C).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=64,
    d_ff=24576,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    citation="arXiv:2309.16609 (Qwen Technical Report)",
)
