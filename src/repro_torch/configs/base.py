"""Configuration dataclasses for the PyTorch port.

A copy of ``repro.configs.base`` for every family the JAX package
registers (dense, RG-LRU hybrid, MLA, MoE, Mamba-2 SSD, and the
modality-prefix and multi-codebook archs): the field names, defaults,
``block_kind``, ``param_count`` and ``reduced()`` rule are the same, so a
config built here describes the same model as its JAX namesake.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (GShard-style capacity dispatch)."""

    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared: int = 0           # DeepSeekMoE shared experts (always-on)
    shared_d_ff: int = 0        # d_ff of the shared experts (total)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight (training)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block config."""

    state_dim: int = 128        # N
    head_dim: int = 64          # P
    expand: int = 2             # d_inner = expand * d_model
    chunk: int = 256            # SSD chunk length
    conv_width: int = 4         # depthwise conv kernel size
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrence config (Griffin / RecurrentGemma)."""

    lru_width: int = 0          # 0 -> d_model
    conv_width: int = 4
    c_constant: float = 8.0     # the fixed `c` in a = exp(-c * softplus(Lambda) * sigma(r))


@dataclass(frozen=True)
class FrontendStub:
    """Stub modality frontend: the encoder (a ViT, EnCodec) is not built.
    The caller gives precomputed patch or frame features, (batch,
    prefix_len, feature_dim); the projector (``models/multimodal.py``) maps
    them to d_model and prepends them to the prompt."""

    kind: str                   # "vision" | "audio"
    prefix_len: int             # number of patch/frame positions
    feature_dim: int            # raw frontend feature width


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
    # block pattern, cycled over layers, e.g. ("rglru", "rglru", "local_attn")
    layer_pattern: Tuple[str, ...] = ("attn",)
    # layer indices whose FFN is dense even in an MoE model (deepseek layer 0)
    dense_ffn_layers: Tuple[int, ...] = ()
    qkv_bias: bool = False
    parallel_residual: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    window: int = 0             # sliding-window size of local_attn layers (0 = full)
    act: str = "silu"           # silu (gated) | gelu
    gated_mlp: bool = True      # SwiGLU vs plain 2-matmul MLP
    n_codebooks: int = 1
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: Optional[FrontendStub] = None
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_kind(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        """An MoE FFN: ``moe`` set and the layer not in ``dense_ffn_layers``
        (an ``ssd`` layer has no FFN)."""
        return (self.moe is not None and layer not in self.dense_ffn_layers
                and self.block_kind(layer) != "ssd")

    def param_count(self) -> int:
        """Parameters of the dense decoder, the RG-LRU hybrid, MLA, MoE and
        Mamba-2: embed, attention (GQA or latent), RG-LRU or SSD mixer per
        layer, dense or MoE FFN (router and shared experts included; none
        in an SSD layer), lm_head unless tied."""
        d, hd = self.d_model, self.resolved_head_dim
        mats = 3 if self.gated_mlp else 2
        heads = 1 if self.tie_embeddings else 2
        total = heads * self.vocab_size * d * self.n_codebooks
        for layer in range(self.n_layers):
            if self.block_kind(layer) == "rglru":
                w = self.rglru.lru_width or d
                total += d * 2 * w + 3 * w + w * d  # in-proj (x2), gates, out-proj
            elif self.block_kind(layer) == "ssd":
                s = self.ssm
                di = s.expand * d
                total += d * (2 * di + 2 * s.state_dim + di // s.head_dim) + di * d
                continue                            # no FFN
            elif self.mla is not None:
                m, n_q = self.mla, self.n_heads
                qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += d * m.q_lora_rank + m.q_lora_rank * n_q * qd
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
                total += n_q * m.v_head_dim * d
            else:
                total += d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
            if self.is_moe_layer(layer):
                m = self.moe
                total += m.n_experts * mats * d * m.expert_d_ff + d * m.n_experts
                total += mats * d * m.shared_d_ff if m.n_shared else 0
            else:
                total += mats * d * self.d_ff
        return total

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers (or one period of a longer layer
        pattern), d_model<=256, head_dim 64, window<=64, <=4 experts of top
        2, the small MLA ranks, SSD state 32, head 32, chunk 32, and a
        frontend of 8 positions of 64 features
        (``repro.configs.base.ModelConfig.reduced``)."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        pat = self.layer_pattern
        n_layers = max(2, len(pat)) if len(pat) > 1 else 2
        kw = dict(
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=min(self.d_model, 256),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64) if self.window else 0,
            dense_ffn_layers=tuple(i for i in self.dense_ffn_layers if i < n_layers),
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4), top_k=min(self.moe.top_k, 2),
                expert_d_ff=min(self.moe.expert_d_ff, 128),
                shared_d_ff=min(self.moe.shared_d_ff, 128))
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                                  qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=32, head_dim=32, chunk=32)
        if self.rglru is not None:
            kw["rglru"] = dataclasses.replace(self.rglru, lru_width=0)
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(self.frontend, prefix_len=8, feature_dim=64)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParallelConfig:
    """The layout fields the port reads.  Weight-only quantization is
    served (quantize at load: int8 per-output-column scales, int4 scales per
    ``wq_group_size`` segment of the reduction dim), and so are the paged KV
    backend of the slot engine, chunked admission, speculative decoding,
    the int8 KV cache, and a world of ``dp`` x ``tp`` ranks of one
    process each (``launch/mesh.py``): tensor parallelism with the paper's
    three toggles inside each of ``dp`` data replicas, the batch (slots and
    paged pools) split over the replicas, or with ``kv_seq_shard`` the
    wave's KV cache sequence split over them and merged by log-sum-exp;
    ``disagg_prefill_shards`` splits the data shards into the prefill and
    decode pools of ``DisaggScheduler``."""

    tp: int = 1
    dp: int = 1
    # tensor parallelism (the JAX package's defaults, paper sections 2.1-2.2)
    seq_parallel: bool = True   # Megatron-SP residual stream at prefill, chunk and verify
    kv_seq_shard: bool = False  # shard the decode KV cache's sequence over the data axis
    topk_sync: bool = True      # 2.1b: local top-k before the gather
    id_broadcast: bool = True   # 2.1a: token ids are replicated, not embeddings
    one_shot_sync: bool = True  # 2.2: one all-reduce per parallel-residual layer
    kv_quant: bool = False
    remat: bool = True          # activation checkpointing per layer (training)
    weight_quant: str = "none"  # none | int8 | int4
    wq_group_size: int = 128    # int4 group length along the reduction dim
    # chunked admission (the continuous schedulers' default): every prompt
    # streams through the fused mixed prefill/decode step in chunks of at
    # most this many tokens; 0 = whole-prompt bucketed admission
    prefill_chunk: int = 256
    # speculative decoding: spec_k n-gram drafts per active slot, verified in
    # one width-(spec_k + 1) step; 0 = plain one-token decode
    spec_k: int = 0
    spec_ngram: int = 3         # longest n-gram the prompt-lookup drafter matches
    # paged KV cache (PagedContinuousScheduler reads these as its defaults)
    kv_block_size: int = 16     # tokens per KV block
    kv_pool_blocks: int = 0     # total pool blocks; 0 = n_slots * blocks/slot + one null
                                # block per data shard
    # disaggregated prefill/decode serving (DisaggScheduler): the first
    # disagg_prefill_shards data shards form the prefill pool (prompts admit
    # and stream through the chunk-only step there), the rest the decode
    # pool; finished KV blocks migrate between the shards' block namespaces,
    # refcounts handed off through the allocator.  0 = unset (the
    # scheduler's prefill_shards argument must name the split; the JAX
    # package's field and default); needs dp >= 2 and an arch whose
    # capability record supports "disagg"
    disagg_prefill_shards: int = 0
    # the serving control plane of the continuous schedulers (the JAX
    # package's fields, names and defaults).  overlap_decode: dispatch decode
    # block N+1 on block N's device outputs and land N's tokens one block
    # late, the host state advancing on a prediction that a landed EOS rolls
    # back; greedy streams equal the blocking loop's.
    overlap_decode: bool = False
    # fault injection (runtime/faults.py's grammar; "" = none): a transient
    # step failure is retried max_step_retries times, with a backoff from
    # retry_backoff_s doubling per failure, from the exact pre-step state;
    # past that a failure blamed on a slot quarantines its request
    fault_plan: str = ""
    max_step_retries: int = 3
    retry_backoff_s: float = 0.05
    # priority classes: per-class per-token SLO targets in seconds (0 = none),
    # slots and paged blocks only interactive admissions may take, and the
    # degradation ladder of runtime/overload.py (queue_hi/lo 0 = from the
    # slot count; patience/cooldown rounds; itl_hi/lo scale the interactive
    # SLO into the latency band)
    slo_interactive_s: float = 0.0
    slo_standard_s: float = 0.0
    slo_batch_s: float = 0.0
    interactive_reserve_slots: int = 0
    interactive_reserve_blocks: int = 0
    overload_degrade: bool = False
    overload_queue_hi: int = 0
    overload_queue_lo: int = 0
    overload_patience: int = 3
    overload_cooldown: int = 6
    overload_itl_hi: float = 1.5
    overload_itl_lo: float = 1.0


@dataclass(frozen=True)
class SamplingConfig:
    top_k: int = 40             # 1 = greedy
    temperature: float = 1.0
