"""mamba2-1.3b -- attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060]; the JAX package's ``repro.configs.mamba2_1_3b``.

48 pure-SSD layers (no FFN, as in the Mamba block layout); d_inner =
2 * d_model, ssm_state 128, head_dim 64; the lm_head is the embed table.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,                  # attention-free; SSD heads derive from ssm cfg
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssd",),
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256, conv_width=4),
    citation="arXiv:2405.21060 (Transformers are SSMs / Mamba-2)",
)
