"""musicgen-medium -- audio decoder over EnCodec tokens [arXiv:2306.05284];
the JAX package's ``repro.configs.musicgen_medium``.

4 codebooks of 2048 tokens: the 4 streams' embeddings are summed and 4
LM heads predict the next frame, sampled per codebook.  The EnCodec
tokenizer and the text-conditioning encoder are stubs: the caller gives
conditioning frame features (64 of 768), which the projector maps in
front of the prompt.  A plain (ungated) GELU FFN.
"""
from repro_torch.configs.base import FrontendStub, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
    gated_mlp=False,
    act="gelu",
    rope_theta=10000.0,
    frontend=FrontendStub(kind="audio", prefix_len=64, feature_dim=768),
    citation="arXiv:2306.05284 (MusicGen); EnCodec 4x2048 codebooks",
)
