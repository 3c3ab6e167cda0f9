"""gptj-parallel -- parallel-residual demo config for the paper's section 2.2.

GPT-J-6B layout: attention and FFN branches read the same normed input and
their results are summed into the residual -- the structure for which the
paper's one-time synchronization applies (one all-reduce per layer instead
of two).  The port's copy of ``repro.configs.gptj_parallel``: RMSNorm and
full-width RoPE as the JAX package serves it.  [EleutherAI/gpt-j-6B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gptj-parallel",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=16,
    n_kv_heads=16,
    d_ff=16384,
    vocab_size=50400,
    parallel_residual=True,
    gated_mlp=False,
    act="gelu",
    rope_theta=10000.0,
    citation="hf:EleutherAI/gpt-j-6B (parallel attention+FFN)",
)
