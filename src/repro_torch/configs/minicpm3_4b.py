"""minicpm3-4b -- dense with multi-head latent attention (MLA)
[hf:openbmb/MiniCPM3-4B].

The port's copy of ``repro.configs.minicpm3_4b``: MLA dims
(q_lora_rank/kv_lora_rank/nope/rope/v) per the MiniCPM3-4B model card; the
outer dims are 62 layers, d_model 2560, 40 heads, d_ff 6400, vocab 73448.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    rope_theta=10000.0,
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    citation="hf:openbmb/MiniCPM3-4B (MLA dims per model card)",
)
