"""internvl2-26b -- VLM: InternViT (stub) + InternLM2 backbone
[arXiv:2404.16821]; the JAX package's ``repro.configs.internvl2_26b``.

The ViT is a stub: the caller gives precomputed patch features (256 a
tile after pixel-shuffle, 3200-wide InternViT-6B features), which the
2-layer MLP projector (``models/multimodal.py``) maps in front of the
prompt.
"""
from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    frontend=FrontendStub(kind="vision", prefix_len=256, feature_dim=3200),
    citation="arXiv:2404.16821 (InternVL 1.5/2); InternViT-6B features 3200-d",
)
