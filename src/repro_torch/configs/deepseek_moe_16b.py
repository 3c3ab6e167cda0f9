"""deepseek-moe-16b -- fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066].

The port's copy of ``repro.configs.deepseek_moe_16b``: layer 0 is a dense
FFN (d_ff 10944 per the model card); layers 1..27 are MoE with 64 routed
experts of d_ff 1408 and 2 shared experts (2 x 1408 = 2816 shared width).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                 # dense layer-0 FFN width (model card)
    vocab_size=102400,
    dense_ffn_layers=(0,),
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        expert_d_ff=1408,       # fine-grained experts
        n_shared=2,
        shared_d_ff=2816,       # 2 shared experts x 1408
    ),
    citation="arXiv:2401.06066 (DeepSeekMoE)",
)
