"""Top-level decoder: parameters, caches and forward (``repro.models.model``
for the dense family, sequential or parallel residual, the RG-LRU hybrid,
multi-head latent attention, the mixture-of-experts FFN (over a
sliding-window ring too), the Mamba-2 SSD mixer, tied embeddings, the
modality-prefix frontend and multi-codebook heads, at any supported
tensor-parallel degree).

Parameters are a plain dict::

    {"embed": {"table": (ncb, V, d)},
     "layers": [ one dict per layer, by its family (``layer_family``):
                 attn: {norm1, w_q, w_k, w_v, w_o, [b_q, b_k, b_v],
                        [norm2], <FFN>}
                 mla: {norm1, w_dq, q_norm, w_uq, w_dkv, kv_norm, w_uk, w_uv,
                       w_o (h, v_head_dim, d), norm2, <FFN>}
                 rglru: {norm1, mixer: {w_gate, w_x, conv_w, gate_a_w, gate_a_b,
                                        gate_x_w, gate_x_b, Lambda, w_out},
                         norm2, <FFN>}
                 ssd: {norm1, mixer: {w_z, w_x, w_bc, w_dt, dt_bias, A_log, D,
                                      conv_w, norm, w_out}} ],
     "final_norm": (d,), "lm_head": (ncb, d, V),
     ["frontend": {"norm": (feature_dim,), "w1": (feature_dim, d), "w2": (d, d)}]}

ncb is ``cfg.n_codebooks`` (1 but for musicgen-medium): a token frame sums
its codebooks' embedding rows and the head gives ncb logit rows a position.
A config with a ``frontend`` holds the projector of its stub encoder's
features (``models/multimodal.py``).

    <FFN> dense: w_up, [w_gate], w_down
          MoE ("+moe" families): router (d, E) fp32, w_up / [w_gate] (E, d, f),
          w_down (E, f, d), [shared: {w_up, [w_gate], w_down}]

A parallel-residual layer (``cfg.parallel_residual``) has no ``norm2``: its
attention and FFN both read norm1's output.  An RG-LRU layer keeps its
mixer's leaves under ``mixer``: its ``w_gate`` and the GeGLU FFN's are
different weights; an SSD layer has no FFN and no ``norm2``; an MoE layer
keeps its shared experts' dense MLP under ``shared``.  With
``cfg.tie_embeddings`` the tree has no ``lm_head``: the logits read the
embed table (``lm_head``).  Each per-layer tensor is a view into one tensor stacked over
the layers of its family, as the JAX package stacks a scanned layer group.
Under weight-only quantization the projections and the lm_head are
``QuantWeight``s whose packed values and scales are such views too (an
expert block ``(L, E, K, N)``).

Under tensor parallelism (``ModelCtx.dist.tp`` ranks) each rank's dict
holds its shard (``shard_leaf``, by the leaf's layer family): the padded
q-head layout's and the KV heads' columns of ``w_q``/``w_k``/``w_v`` and
their biases, its heads of ``w_o``, its columns of ``w_up``/``w_gate`` and
rows of ``w_down``, its columns of the lm_head (the vocab padded to a
multiple of tp; a multi-codebook head's of every codebook) and, for a
table larger than ``embedding.REPLICATE_BYTES_LIMIT`` or tied to the head,
its rows of the embed table (the tied head is that shard, transposed); an MLA
layer its heads' columns of ``w_uq``/``w_uk``/``w_uv``; an MoE layer its
experts' blocks (``moe.moe_plan``: where tp > E, a slice of one expert's
d_ff) and its columns and rows of the shared experts; an RG-LRU layer its
channels, gate blocks and ``w_out`` rows; an SSD layer its heads
(``ssm``: ``w_z``/``w_x``/``w_dt`` columns, the per-head scalars and norm,
``w_out`` rows, its x channels of the conv weight beside the B/C ones).
Norms, smaller tables, the router, an SSD layer's ``w_bc``, the frontend's
projector and MLA's down-projections (the latent cache they feed is
replicated) are replicated.  The forward is the
per-shard program: every rank runs it, and the collectives between them
are the ``SyncPolicy``'s (``core/sync_policy.py``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import wquant
from repro_torch.core.embedding import embed_lookup, table_replicated
from repro_torch.core.sync_policy import SyncPolicy
from repro_torch.core.wquant import QuantWeight
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import multimodal, rglru, ssm
from repro_torch.models.common import (Dist, ShardPlan, init_leaf, resolve_device, rms_norm,
                                       rope_tables)
from repro_torch.models.transformer import (ATTN_KINDS, RECURRENT, Ghost, layers_forward,
                                            train_layers)

Params = Dict[str, Any]

# The leaves weight-only quantization covers (``_map_wq_leaves``), with how
# the forward consumes each: "matmul" through the dequant_matmul kernel,
# "einsum" dequantized for a batched contraction (the out-projection w_o,
# (n_heads, hd, d)).  Embed, norms, biases and the frontend's projector
# stay bf16.  ``wq_site`` adds what the layer's family changes: an MLA mixer
# stays bf16, MoE expert blocks are einsum sites and its shared experts
# matmul sites; ``head_site`` makes a multi-codebook head an einsum site.
WQ_SITES = {"w_q": "matmul", "w_k": "matmul", "w_v": "matmul", "w_o": "einsum",
            "w_up": "matmul", "w_gate": "matmul", "w_down": "matmul", "lm_head": "matmul"}
FFN_KEYS = ("w_up", "w_gate", "w_down")


# tensor-parallel degrees the port serves
TP_DEGREES = (1, 2, 4, 8)


@dataclass(frozen=True)
class ModelCtx:
    """What the per-shard forward needs beside the config
    (``repro.models.model.ModelCtx``): the rank's place, the shard plan and
    the layout toggles, and the config it was made for (``make``).  The
    default is tp=1."""

    plan: ShardPlan
    dist: Dist = Dist()
    parallel: ParallelConfig = ParallelConfig()
    cfg: Optional[ModelConfig] = None

    @staticmethod
    def make(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(),
             dist: Dist = Dist()) -> "ModelCtx":
        if parallel.tp != dist.tp:
            raise ValueError(f"ParallelConfig.tp {parallel.tp} != the rank group's tp {dist.tp}")
        if parallel.dp != dist.dp:
            raise ValueError(f"ParallelConfig.dp {parallel.dp} != the world's dp {dist.dp}")
        return ModelCtx(ShardPlan.make(cfg, dist.tp), dist, parallel, cfg)

    def policy(self, *, seq_sharded: bool, seq_len: int) -> SyncPolicy:
        """Prefill, chunk and verify forwards run ``seq_sharded`` (the
        residual stream sequence-sharded unless ``parallel.seq_parallel`` is
        off); decode keeps the residual replicated."""
        return SyncPolicy(self.dist, seq_len=seq_len, one_shot=self.parallel.one_shot_sync,
                          seq_sharded=(seq_sharded and self.parallel.seq_parallel
                                       and self.dist.tp > 1))

    def vocab_valid(self, vocab: int) -> int:
        """How many of this rank's ``local_vocab`` logit columns are real
        (the rest pad the vocab to a multiple of tp)."""
        lv = self.plan.local_vocab
        return max(0, min(lv, vocab - self.dist.rank * lv))


class LeafDef(NamedTuple):
    """One parameter of a layer: the shape of one layer's leaf, the JAX
    ``ParamDef`` init rule, the fan-in of a "scaled" rule, the dtype."""
    shape: Tuple[int, ...]
    rule: str
    fan_in: int
    dtype: torch.dtype = torch.bfloat16


def check_supported(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), *,
                    wq_cache: Optional[str] = None) -> None:
    """Raise NotImplementedError naming every feature of ``cfg`` and
    ``parallel`` that the port does not serve yet (``wq_cache``: the path of
    a packed weight checkpoint), and ValueError where ``cfg`` cannot be
    split over ``parallel.tp`` ranks."""
    missing = []
    kinds = set(cfg.layer_pattern)
    if cfg.mla is not None and (cfg.window or "rglru" in kinds):
        missing.append("mla with windowed or rglru layers")
    if cfg.parallel_residual and (cfg.moe is not None or cfg.mla is not None):
        missing.append("parallel_residual with moe or mla layers")
    if kinds - {*ATTN_KINDS, *RECURRENT}:
        missing.append(f"layer_pattern {cfg.layer_pattern} "
                       "(only attn, local_attn, rglru and ssd layers)")
    if "rglru" in kinds and cfg.rglru is None:
        missing.append("rglru layers without an RGLRUConfig")
    if "ssd" in kinds and cfg.ssm is None:
        missing.append("ssd layers without an SSMConfig")
    if kinds >= set(RECURRENT):
        missing.append("rglru and ssd layers together (one recurrent-state layout)")
    if cfg.window and "local_attn" not in kinds:
        missing.append("window (on full-attention layers, which ignore it)")
    if cfg.window and kinds >= set(ATTN_KINDS):
        missing.append("attn and local_attn layers together (one cache length for all)")
    if cfg.parallel_residual and "rglru" in kinds:
        missing.append("parallel_residual with rglru layers")
    if parallel.weight_quant not in ("none", *wquant.MODES):
        missing.append(f"weight_quant={parallel.weight_quant}")
    if parallel.tp not in TP_DEGREES:
        missing.append(f"tp={parallel.tp} (tensor parallelism at tp 1, 2, 4 or 8)")
    if parallel.tp > 1 and wq_cache is not None:
        missing.append("wq_cache at tp>1 (a packed checkpoint per rank)")
    if wq_cache is not None and (cfg.moe is not None or "ssd" in kinds or cfg.tie_embeddings):
        missing.append("wq_cache with moe or ssd layers or tied embeddings (the packed "
                       "file's layer groups)")
    if wq_cache is not None and (cfg.frontend is not None or cfg.n_codebooks != 1):
        missing.append("wq_cache with a frontend or a multi-codebook head (the packed "
                       "file's frontend leaves and codebook axis)")
    if parallel.dp < 1:
        missing.append(f"dp={parallel.dp}")
    if parallel.kv_seq_shard and (cfg.mla is not None or kinds != {"attn"}):
        missing.append("kv_seq_shard with mla, sliding-window or recurrent layers (the "
                       "sequence-sharded cache of full-causal GQA layers only)")
    if missing:
        raise NotImplementedError(f"{cfg.name}: the PyTorch port does not serve "
                                  f"{', '.join(missing)} yet")
    if parallel.tp > 1:
        tp = parallel.tp
        ShardPlan.make(cfg, tp)        # raises where the heads cannot split
        if cfg.d_ff % tp:
            raise ValueError(f"{cfg.name}: d_ff {cfg.d_ff} not a multiple of tp {tp}")
        # the JAX plans' own refusals: experts (moe_plan), the shared
        # experts' d_ff, the RG-LRU channels and gate blocks, the SSD heads
        # (_dims)
        try:
            if cfg.moe is not None:
                moe_mod.moe_plan(cfg.moe, tp)
                if cfg.moe.n_shared and cfg.moe.shared_d_ff % tp:
                    raise ValueError(f"shared_d_ff {cfg.moe.shared_d_ff} not a multiple of "
                                     f"tp {tp}")
            if "rglru" in kinds:
                rglru._dims(cfg, tp)
            if "ssd" in kinds:
                ssm._dims(cfg, tp)
        except ValueError as e:
            raise ValueError(f"{cfg.name}: {e}") from None


def check_trainable(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig()) -> None:
    """Raise NotImplementedError naming every feature of ``cfg`` and
    ``parallel`` that the port does not train yet, beside
    ``check_supported``'s refusals: at tp > 1 only the dense family
    trains, whose heads and vocab split over tp without padding (a padded
    head or vocab column would be trained); weight and KV quantization,
    ``kv_seq_shard`` and, at tp > 1, the embedding-broadcast baseline are
    serving layouts."""
    check_supported(cfg, parallel)
    missing = []
    kinds = set(cfg.layer_pattern)
    if parallel.weight_quant != "none" or parallel.kv_quant or parallel.kv_seq_shard:
        missing.append("weight_quant, kv_quant or kv_seq_shard (serving layouts)")
    if parallel.tp > 1:
        for what, on in (("rglru layers", "rglru" in kinds), ("moe layers", cfg.moe is not None),
                         ("mla layers", cfg.mla is not None), ("ssd layers", "ssd" in kinds),
                         ("tied embeddings", cfg.tie_embeddings),
                         ("a frontend", cfg.frontend is not None),
                         ("a multi-codebook head", cfg.n_codebooks != 1)):
            if on:
                missing.append(f"{what} at tp>1")
        plan = ShardPlan.make(cfg, parallel.tp)
        if plan.n_heads_p != plan.n_heads or plan.vocab_p != cfg.vocab_size:
            missing.append(f"tp={parallel.tp} over {cfg.n_heads} heads and a vocab of "
                           f"{cfg.vocab_size} (padded heads or vocab columns)")
        if not parallel.id_broadcast:
            missing.append("id_broadcast=False at tp>1")
    if missing:
        raise NotImplementedError(f"{cfg.name}: the PyTorch port does not train "
                                  f"{', '.join(missing)} yet")


def attention_window(cfg: ModelConfig) -> int:
    """The sliding window every attention layer of ``cfg`` reads (0: full
    causal); ``check_supported`` admits no mix of windowed and full layers."""
    return cfg.window if "local_attn" in cfg.layer_pattern else 0


def layer_family(cfg: ModelConfig, layer: int) -> str:
    """The parameter layout of layer ``layer``, keyed as the JAX package's
    ``layer_signature`` keys its scan groups: the mixer ("attn" for attn
    and local_attn, "mla" for latent attention, "rglru", "ssd"), with "+moe"
    where the FFN is a mixture of experts."""
    kind = cfg.block_kind(layer)
    mixer = kind if kind in RECURRENT else "mla" if cfg.mla is not None else "attn"
    return mixer + ("+moe" if cfg.is_moe_layer(layer) else "")


def layer_families(cfg: ModelConfig) -> Dict[str, List[int]]:
    """family (``layer_family``) -> its layer indices in order."""
    fams: Dict[str, List[int]] = {}
    for i in range(cfg.n_layers):
        fams.setdefault(layer_family(cfg, i), []).append(i)
    return fams


def _ffn_defs(cfg: ModelConfig, d_ff: int, prefix: str = "") -> Dict[str, LeafDef]:
    """``mlp_defs`` at width ``d_ff``, the names prefixed."""
    d = cfg.d_model
    defs = {f"{prefix}w_up": LeafDef((d, d_ff), "scaled", d),
            f"{prefix}w_down": LeafDef((d_ff, d), "scaled", d_ff)}
    if cfg.gated_mlp:
        defs[f"{prefix}w_gate"] = LeafDef((d, d_ff), "scaled", d)
    return defs


def layer_param_defs(cfg: ModelConfig, family: str = "attn") -> Dict[str, LeafDef]:
    """name -> LeafDef of one layer of ``family``: the JAX ParamDefs of a
    sub-layer (``attn_defs``, ``_mla_defs``, or ``rglru_defs`` or
    ``ssd_defs`` as ``mixer.<name>``; ``mlp_defs``, or ``moe_defs`` with its
    shared experts as ``shared.<name>``; ``norm1``, and ``norm2`` unless the
    residual is parallel).  An SSD layer is ``norm1`` and its mixer."""
    if cfg.n_heads % cfg.n_kv_heads:
        raise ValueError(f"{cfg.name}: n_heads {cfg.n_heads} not a multiple of "
                         f"n_kv_heads {cfg.n_kv_heads}")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q_cols, kv_cols = cfg.n_heads * hd, cfg.n_kv_heads * hd
    mixer, _, ffn = family.partition("+")
    if mixer == "ssd":
        return {"norm1": LeafDef((d,), "zeros", 0),
                **{f"mixer.{n}": LeafDef(*spec) for n, spec in ssm.ssd_defs(cfg).items()}}
    if mixer == "rglru":
        defs = {"norm1": LeafDef((d,), "zeros", 0),
                **{f"mixer.{n}": LeafDef(*spec) for n, spec in rglru.rglru_defs(cfg).items()}}
    elif mixer == "mla":
        defs = {"norm1": LeafDef((d,), "zeros", 0),
                **{n: LeafDef(*spec) for n, spec in mla_mod.mla_defs(cfg).items()}}
    else:
        defs = {
            "norm1": LeafDef((d,), "zeros", 0),
            "w_q": LeafDef((d, q_cols), "scaled", d),
            "w_k": LeafDef((d, kv_cols), "scaled", d),
            "w_v": LeafDef((d, kv_cols), "scaled", d),
            "w_o": LeafDef((cfg.n_heads, hd, d), "scaled", hd),
        }
    if not cfg.parallel_residual:
        defs["norm2"] = LeafDef((d,), "zeros", 0)
    if ffn == "moe":
        m = cfg.moe
        E, f = m.n_experts, m.expert_d_ff
        defs["router"] = LeafDef((d, E), "scaled", d, torch.float32)
        defs.update({"w_up": LeafDef((E, d, f), "scaled", d),
                     "w_down": LeafDef((E, f, d), "scaled", f)})
        if cfg.gated_mlp:
            defs["w_gate"] = LeafDef((E, d, f), "scaled", d)
        if m.n_shared:
            defs.update(_ffn_defs(cfg, m.shared_d_ff, "shared."))
    else:
        defs.update(_ffn_defs(cfg, cfg.d_ff))
    if cfg.qkv_bias and mixer == "attn":
        defs.update(b_q=LeafDef((q_cols,), "zeros", 0), b_k=LeafDef((kv_cols,), "zeros", 0),
                    b_v=LeafDef((kv_cols,), "zeros", 0))
    return defs


def wq_site(family: str, name: str) -> Optional[str]:
    """How the forward consumes leaf ``name`` of a ``family`` layer under
    weight-only quantization (``_map_wq_leaves``): "matmul", "einsum", or
    None where it stays bf16.  An MLA mixer's leaves stay bf16; the expert
    blocks of an MoE layer are einsum sites (``wquant.to_dense``), its
    shared experts matmul sites."""
    mixer, _, ffn = family.partition("+")
    if name.startswith("shared."):
        return "matmul" if name[len("shared."):] in FFN_KEYS else None
    if ffn == "moe" and name in FFN_KEYS:
        return "einsum"
    if mixer == "mla" and name not in FFN_KEYS:
        return None
    return WQ_SITES.get(name)


def head_site(cfg: ModelConfig) -> str:
    """How the forward consumes a quantized lm_head (``_map_wq_leaves``):
    through dequant_matmul at one codebook, dequantized for the einsum over
    the codebooks of a multi-codebook head."""
    return "matmul" if cfg.n_codebooks == 1 else "einsum"


def split_layers(stacked: Dict[str, Any], n_layers: int) -> List[Dict[str, Any]]:
    """Stacked (n, ...) tensors or QuantWeights -> one dict of views per
    layer; a ``mixer.<name>`` leaf goes to ``layer["mixer"][name]``, a
    ``shared.<name>`` one to ``layer["shared"][name]``."""
    out = []
    for i in range(n_layers):
        layer: Dict[str, Any] = {}
        for key, t in stacked.items():
            head, _, leaf = key.rpartition(".")
            (layer.setdefault(head, {}) if head else layer)[leaf] = wquant.map_tensors(
                t, lambda a: a[i])
        out.append(layer)
    return out


def _quantized_empty(shape, mode: str, group_size: int, device) -> QuantWeight:
    """Uninitialised storage for the quantized form of a (*B, K, N) weight."""
    *lead, k, n = shape
    if mode == "int8":
        return QuantWeight(torch.empty(shape, dtype=torch.int8, device=device),
                           torch.empty((*lead, n), dtype=torch.bfloat16, device=device),
                           "int8", 0, k)
    g = wquant.effective_group(k, group_size)
    return QuantWeight(torch.empty((*lead, k // 2, n), dtype=torch.uint8, device=device),
                       torch.empty((*lead, k // g, n), dtype=torch.bfloat16, device=device),
                       "int4", g, k)


def _quantize_into(dst: QuantWeight, w: torch.Tensor, group_size: int, cols: int = 8192,
                   rows: Optional[Tuple[int, int]] = None) -> None:
    """Quantize ``w`` into ``dst``'s storage a block of columns at a time:
    every scale belongs to one column, so the bytes are those of one
    ``quantize`` call, and the fp32 temporaries stay at K x 8192.
    ``rows`` (start, size): keep those reduction rows of the int8 result
    (a row-parallel shard, its scales taken over the whole K)."""
    for c in range(0, w.shape[-1], cols):
        qw = wquant.quantize(w[..., c:c + cols], dst.mode, group_size)
        if rows is not None:
            qw = wquant.slice_rows(qw, *rows)
        dst.q[..., c:c + cols] = qw.q
        dst.scale[..., c:c + cols] = qw.scale


def _k_shards(name: str, tp: int, family: str = "attn",
              cfg: Optional[ModelConfig] = None) -> int:
    """Ranks the reduction dim of leaf ``name`` is split over (the JAX
    package's ``_wq_k_shards``): the row-parallel ``w_down`` of a dense FFN
    or of the shared experts; an expert block's ``w_down`` where each
    expert's d_ff is split over ffn_tp > 1 ranks (``cfg`` given), whose
    JAX blocks of d_ff / ffn_tp rows are quantized each alone."""
    if name == "shared.w_down" or (name == "w_down" and not family.endswith("+moe")):
        return tp
    if name == "w_down" and cfg is not None and tp > 1:
        return moe_mod.moe_plan(cfg.moe, tp)[3]
    return 1


def _quantizes(name: str, shape, parallel: ParallelConfig, family: str = "attn",
               cfg: Optional[ModelConfig] = None) -> bool:
    return (parallel.weight_quant != "none" and wq_site(family, name) is not None
            and wquant.quantizable(shape, parallel.weight_quant, parallel.wq_group_size,
                                   _k_shards(name, parallel.tp, family, cfg)))


# -- tensor-parallel shards -------------------------------------------------


class Split(NamedTuple):
    """One axis of a leaf's shard: axis ``axis`` (counted from the end) of
    the global leaf holds ``dims`` = (groups, heads a group, entries a
    head), is zero-padded to ``dims_p``, and the rank keeps [start, start +
    size) of it; the axis's last ``kept`` entries stand after those and
    every rank keeps them (an SSD conv weight's B/C columns)."""
    axis: int
    dims: Tuple[int, int, int]
    dims_p: Tuple[int, int, int]
    start: int
    size: int
    kept: int = 0


def _split(name: str, cfg: ModelConfig, plan: ShardPlan, rank: int,
           family: str = "attn") -> Tuple[Split, ...]:
    """How leaf ``name`` of a ``family`` layer (``layer_family``; "attn"
    for the table and the lm_head) splits over the ranks: its ``Split``s,
    applied in order; () where it is replicated.  Q heads pad within their
    KV group (``ShardPlan``); a KV head replicated over ``kv_rep`` ranks is
    the rank's own columns.  MLA's up-projections split by head like
    ``w_q`` (n_kv = n_heads), its down-projections, norms and the router
    are replicated; an expert block splits on its expert axis and, where
    ffn_tp > 1, on its d_ff too (``moe.moe_plan``); the shared experts
    split as a dense FFN of ``shared_d_ff``; an RG-LRU mixer by channel,
    gate block and ``w_out`` row (``rglru._dims``); an SSD mixer by head
    (``ssm._dims``), its conv weight the rank's x channels and the B/C
    columns (``ssm.conv_slice``), ``w_bc`` replicated."""
    tp = plan.tp
    if tp == 1:
        return ()
    mixer, _, ffn = family.partition("+")
    g = plan.n_heads // plan.n_kv_heads

    def even(n: int, axis: int) -> Split:
        return Split(axis, (n, 1, 1), (n, 1, 1), rank * (n // tp), n // tp)

    def heads(width: int) -> Split:
        return Split(-1, (plan.n_kv_heads, g, width), (plan.n_kv_p, plan.group_p, width),
                     rank * plan.local_q * width, plan.local_q * width)

    if mixer == "ssd" and name.startswith("mixer."):
        leaf = name[len("mixer."):]
        d_in, nh, _ = ssm._dims(cfg, tp)
        if leaf == "conv_w":
            start, width, bc = ssm.conv_slice(cfg, tp, rank)
            return (Split(-1, (d_in, 1, 1), (d_in, 1, 1), start, width, bc),)
        per_head = {"w_z": (d_in, -1), "w_x": (d_in, -1), "norm": (d_in, -1),
                    "w_out": (d_in, -2), "w_dt": (nh, -1), "dt_bias": (nh, -1),
                    "A_log": (nh, -1), "D": (nh, -1)}
        return (even(*per_head[leaf]),) if leaf in per_head else ()
    if name.startswith("mixer."):                     # RG-LRU
        leaf = name[len("mixer."):]
        w, nb, _ = rglru._dims(cfg, tp)
        axis = {"w_gate": -1, "w_x": -1, "conv_w": -1, "Lambda": -1, "w_out": -2}
        if leaf in axis:
            return (even(w, axis[leaf]),)
        return (even(nb, -3 if leaf.endswith("_w") else -2),)
    if name.startswith("shared."):
        return (even(cfg.moe.shared_d_ff, -2 if name == "shared.w_down" else -1),)
    if ffn == "moe" and name in FFN_KEYS:
        m = cfg.moe
        _, dff_b, _, ffn_tp = moe_mod.moe_plan(m, tp)
        e_lo, local_e = moe_mod.local_experts(m, tp, rank)
        E = (m.n_experts, 1, 1)
        out = (Split(-3, E, E, e_lo, local_e),)
        if ffn_tp > 1:
            f = (m.expert_d_ff, 1, 1)
            out += (Split(-2 if name == "w_down" else -1, f, f, rank % ffn_tp * dff_b, dff_b),)
        return out
    if name == "w_o":
        return (Split(-3, (plan.n_kv_heads, g, 1), (plan.n_kv_p, plan.group_p, 1),
                      rank * plan.local_q, plan.local_q),)
    if mixer == "mla":
        m = cfg.mla
        width = {"w_uq": m.qk_nope_head_dim + m.qk_rope_head_dim,
                 "w_uk": m.qk_nope_head_dim, "w_uv": m.v_head_dim}.get(name)
        if width is not None:
            return (heads(width),)
    hd = cfg.resolved_head_dim
    if name in ("w_q", "b_q"):
        return (heads(hd),)
    if name in ("w_k", "w_v", "b_k", "b_v"):
        dims = (plan.n_kv_heads, 1, hd)
        if plan.kv_sharded:
            return (Split(-1, dims, (plan.n_kv_p, 1, hd), rank * plan.local_kv * hd,
                          plan.local_kv * hd),)
        return (Split(-1, dims, dims, rank // plan.kv_rep * hd, hd),)
    if name in FFN_KEYS:
        return (even(cfg.d_ff, -2 if name == "w_down" else -1),)
    vocab = Split(-1, (cfg.vocab_size, 1, 1), (plan.vocab_p, 1, 1), rank * plan.local_vocab,
                  plan.local_vocab)
    if name == "lm_head":
        return (vocab,)
    if name == "table" and not table_replicated(cfg):
        return (vocab._replace(axis=-2),)
    return ()


def _pad_slice(t: torch.Tensor, axis: int, dims, dims_p, start: int, size: int,
               kept: int = 0, fill: float = 0.0) -> torch.Tensor:
    """Axis ``axis`` of t viewed as ``dims``, padded with ``fill`` to
    ``dims_p``, then [start, start + size) of it, followed by the axis's
    last ``kept`` entries."""
    if kept:
        n = t.shape[axis] - kept
        return torch.cat([_pad_slice(t.narrow(axis, 0, n), axis, dims, dims_p, start, size,
                                     fill=fill), t.narrow(axis, n, kept)], dim=axis)
    if tuple(dims) != tuple(dims_p):
        axis %= t.dim()
        lead, tail = t.shape[:axis], t.shape[axis + 1:]
        out = t.new_full((*lead, *dims_p, *tail), fill)
        out[(slice(None),) * axis + tuple(slice(0, n) for n in dims)] = t.reshape(
            *lead, *dims, *tail)
        t = out.reshape(*lead, math.prod(dims_p), *tail)
    return t.narrow(axis, start, size)


def _apply_split(w, sp: Split):
    """One ``Split`` of a tensor or a QuantWeight.  A QuantWeight pads its
    columns or heads with zero values and the scale ``quantize`` gives a
    zero column, so the result is the quantization of the padded leaf,
    sliced; a row split keeps its int8 scales and its int4 groups' scale
    rows (``wquant.slice_rows``)."""
    if not isinstance(w, QuantWeight):
        return _pad_slice(w, *sp)
    if sp.axis == -2:
        return wquant.slice_rows(w, sp.start, sp.size)
    # a batch axis (w_o's heads, an expert block's experts) is the last
    # batch axis of the values and of the int8 scales
    s_axis = -2 if sp.axis == -3 and w.mode == "int8" else sp.axis
    return QuantWeight(_pad_slice(w.q, *sp),
                       _pad_slice(w.scale, s_axis, *sp[1:], fill=wquant.zero_scale(w.mode)),
                       w.mode, w.group, w.k)


def shard_leaf(name: str, w, cfg: ModelConfig, plan: ShardPlan, rank: int,
               family: str = "attn"):
    """A global leaf of a ``family`` layer (one layer's, a stack of layers',
    the table or the lm_head; a tensor or a QuantWeight) -> this rank's
    shard (``_split``)."""
    for sp in _split(name, cfg, plan, rank, family):
        w = _apply_split(w, sp)
    return w


def _shard_shape(name: str, shape, cfg: ModelConfig, plan: ShardPlan, rank: int,
                 family: str = "attn"):
    out = list(shape)
    for sp in _split(name, cfg, plan, rank, family):
        out[sp.axis] = sp.size + sp.kept
    return tuple(out)


def init_params(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(), *,
                seed: int = 0, device="cuda", dist: Dist = Dist()) -> Params:
    """Random weights by the JAX package's init rules (normal std 0.02,
    scaled 1/sqrt(fan_in), zeros), drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.  The draws differ from
    ``jax.random``'s, so parity with the JAX package goes through
    ``repro_torch.bridge`` instead.

    With ``parallel.weight_quant`` set, each layer's leaf is drawn in bf16,
    quantized and written into the stacked packed storage before the next
    is drawn, so the bf16 tree never exists (qwen-72b's does not fit one
    card).  The draws are the same as without quantization: the result is
    ``quantize_params`` of the bf16 weights of the same seed.

    At tp > 1 (``dist``) every rank draws each global leaf with the same
    generator sequence as tp=1 and keeps its shard (``shard_leaf``), so one
    seed is one model at every tp.  A quantized leaf is the quantization of
    the global leaf, sliced: a row-parallel int8 ``w_down`` is quantized
    whole, every other leaf's shard alone, which gives the same bytes
    (its scales see only its own columns, or its groups only its rows)."""
    check_supported(cfg, parallel)
    device = resolve_device(device)
    plan = ModelCtx.make(cfg, dataclasses.replace(parallel, dp=dist.dp), dist).plan
    gen = torch.Generator(device=device).manual_seed(seed)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    mode, gs = parallel.weight_quant, parallel.wq_group_size
    layers: List[Dict[str, Any]] = [{} for _ in range(L)]
    shard = lambda name, w, family="attn": shard_leaf(name, w, cfg, plan, dist.rank, family)
    for family, idx in layer_families(cfg).items():
        n, stacked = len(idx), {}
        for name, (shape, rule, fan_in, dtype) in layer_param_defs(cfg, family).items():
            quant = _quantizes(name, shape, parallel, family, cfg)
            local = (n, *_shard_shape(name, shape, cfg, plan, dist.rank, family))
            if quant:
                t = _quantized_empty(local, mode, gs, device)
            else:
                t = torch.empty(local, dtype=dtype, device=device)
            # a row-parallel int8 shard's scales span the global K: quantize
            # the leaf's other splits whole and keep the rank's rows
            splits = _split(name, cfg, plan, dist.rank, family)
            rows = [sp for sp in splits if sp.axis == -2]
            whole_k = quant and mode == "int8" and bool(rows)
            for i in range(n):   # per layer: an fp32 draw of one layer at a time
                leaf = init_leaf(shape, rule, gen, device=device, fan_in=fan_in, dtype=dtype)
                if whole_k:
                    for sp in splits:
                        leaf = leaf if sp.axis == -2 else _apply_split(leaf, sp)
                    _quantize_into(wquant.index_batch(t, i), leaf, gs,
                                   rows=(rows[0].start, rows[0].size))
                elif quant:
                    _quantize_into(wquant.index_batch(t, i), shard(name, leaf, family), gs)
                else:
                    t[i] = shard(name, leaf, family)
            stacked[name] = t
        for i, layer in zip(idx, split_layers(stacked, n)):
            layers[i] = layer
    ncb = cfg.n_codebooks
    table = shard("table", init_leaf((ncb, V, d), "normal", gen, device=device))
    final_norm = init_leaf((d,), "zeros", gen, device=device)
    out = {"embed": {"table": table.contiguous()}, "layers": layers, "final_norm": final_norm}
    if not cfg.tie_embeddings:
        head = init_leaf((ncb, d, V), "scaled", gen, device=device, fan_in=d)
        if _quantizes("lm_head", head.shape, parallel):
            local = shard("lm_head", head)
            qhead = _quantized_empty(local.shape, mode, gs, device)
            _quantize_into(qhead, local, gs)
            head = qhead
        else:
            head = shard("lm_head", head).contiguous()
        out["lm_head"] = head
    if cfg.frontend is not None:        # replicated, bf16 whatever the quantization
        out["frontend"] = {name: init_leaf(shape, rule, gen, device=device, fan_in=fan_in)
                           for name, (shape, rule, fan_in) in
                           multimodal.frontend_defs(cfg).items()}
    return out


def quantize_params(params: Params, parallel: ParallelConfig) -> Params:
    """Quantize at load (``repro.models.model.quantize_params``): the bf16
    leaves that ``wq_site`` names and the lm_head become QuantWeights in
    new storage stacked over each layer family (an RG-LRU or MLA layer's
    FFN, not its mixer; an MoE layer's expert blocks and shared experts);
    leaves already quantized pass through, and shapes that do not quantize
    stay bf16.  At tp > 1 a shard cannot be quantized alone (an int8
    row-parallel scale spans the global K), so the leaves must come
    quantized (``init_params``, or ``bridge.params_from_jax`` of a
    quantized tree)."""
    if parallel.weight_quant == "none":
        return params
    mode, gs = parallel.weight_quant, parallel.wq_group_size
    layers = params["layers"]
    new_layers = [{k: dict(v) if isinstance(v, dict) else v for k, v in p.items()}
                  for p in layers]
    families: Dict[str, List[int]] = {}
    for i, p in enumerate(layers):
        families.setdefault(_family_of(p), []).append(i)
    todo = []
    for family, idx in families.items():
        for name, first in _flat_leaves(layers[idx[0]]).items():
            if (not isinstance(first, QuantWeight)
                    and _quantizes(name, first.shape, parallel, family)):
                todo.append((idx, name, first))
    head = params.get("lm_head")
    head_todo = (head is not None and not isinstance(head, QuantWeight)
                 and _quantizes("lm_head", head.shape, parallel))
    if parallel.tp > 1 and (todo or head_todo):
        raise ValueError("at tp>1 the weights are quantized whole before they are sharded: "
                         "pass quantized shards (init_params, bridge.params_from_jax)")
    for idx, name, first in todo:
        dst = _quantized_empty((len(idx), *first.shape), mode, gs, first.device)
        nest, _, leaf = name.rpartition(".")
        for n, i in enumerate(idx):
            view = wquant.index_batch(dst, n)
            _quantize_into(view, _flat_leaves(layers[i])[name], gs)
            (new_layers[i][nest] if nest else new_layers[i])[leaf] = view
    out = dict(params, layers=new_layers)
    if head_todo:
        out["lm_head"] = _quantized_empty(head.shape, mode, gs, head.device)
        _quantize_into(out["lm_head"], head, gs)
    return out


def _family_of(layer: Dict[str, Any]) -> str:
    """``layer_family`` read off one layer's leaves."""
    if "mixer" in layer:
        mixer = "ssd" if "w_z" in layer["mixer"] else "rglru"
    else:
        mixer = "mla" if "w_dkv" in layer else "attn"
    return mixer + ("+moe" if "router" in layer else "")


def _flat_leaves(layer: Dict[str, Any]) -> Dict[str, Any]:
    """One layer's leaves by their ``layer_param_defs`` names (a nested
    ``mixer`` or ``shared`` dict's as ``<dict>.<name>``)."""
    out = {}
    for k, v in layer.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": t for n, t in v.items()})
        else:
            out[k] = v
    return out


def decode_weight_bytes(cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig()) -> Dict[str, int]:
    """Weight bytes one decode token sweeps, from shapes alone
    (``repro.models.model.decode_weight_bytes`` at tp=1).  ``quantized``:
    the leaves the transform covers, at their packed size; ``dense``: the
    rest (norms, biases, routers, MLA's latent projections, unquantized
    projections) at their stored width; ``quantized_ref_einsum``: the part
    of ``quantized`` served by dequantizing (w_o, MoE expert blocks), which
    also writes and reads a bf16 copy per step, and a multi-codebook
    head); ``swept``: the sum.  The embed table is left out, since a token
    reads one row of each codebook's, except where it is tied to the head:
    then the head's sweep reads it whole, in bf16 whatever the quantization.
    The frontend's projector is left out too: a prefill runs it, decode
    never does.  The head counts its ncb codebooks.  MoE counts every
    expert, as the reference's decode (C = T) runs every one.

    At tp > 1 ``rank_swept`` adds what one rank's shard sweeps (rank 0's:
    its padded heads, its experts, its vocab shard of the head, or of the
    tied table), each quantized leaf at its shard's packed size."""
    leaves = [(family, name, (len(idx), *d.shape), d.dtype)
              for family, idx in layer_families(cfg).items()
              for name, d in layer_param_defs(cfg, family).items()]
    head = "table" if cfg.tie_embeddings else "lm_head"
    leaves += [("attn", "final_norm", (cfg.d_model,), torch.bfloat16),
               ("attn", head, (cfg.n_codebooks, cfg.d_model, cfg.vocab_size), torch.bfloat16)]
    quantized = dense = ref_einsum = rank_swept = 0
    plan = ShardPlan.make(cfg, parallel.tp)
    for family, name, shape, dtype in leaves:
        # the tied table is swept as the head: (ncb, d, V), split on V
        local = _shard_shape("lm_head" if name == "table" else name, shape, cfg, plan, 0,
                             family)
        if _quantizes(name, shape, parallel, family, cfg):
            mode, gs = parallel.weight_quant, parallel.wq_group_size
            b = wquant.quant_bytes(shape, mode, gs, _k_shards(name, parallel.tp, family, cfg))
            quantized += b
            site = head_site(cfg) if name == "lm_head" else wq_site(family, name)
            ref_einsum += b if site == "einsum" else 0
            rank_swept += wquant.quant_bytes(local, mode, gs)
        else:
            dense += dtype.itemsize * math.prod(shape)
            rank_swept += dtype.itemsize * math.prod(local)
    out = {"quantized": quantized, "dense": dense, "quantized_ref_einsum": ref_einsum,
           "swept": quantized + dense}
    if parallel.tp > 1:
        out["rank_swept"] = rank_swept
    return out


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *, device,
                per_slot: bool = False, paged: Optional[Tuple[int, int]] = None,
                ring_slack: int = 0, kv_quant: bool = False,
                kv_heads: Optional[int] = None, tp: int = 1,
                kv_seq_shard_dp: int = 1) -> Dict[str, torch.Tensor]:
    """The cache of all layers; ``pos`` -1 marks an empty entry.

    Wave (default): ``k``/``v`` (A, batch, hkv, S, hd) for the A attention
    layers, ``pos`` (S,).  ``per_slot``: the same K/V and ``pos`` (batch,
    S), every row a slot at its own position.  S is ``max_len``, or for
    ``local_attn`` layers with a window a ring of ``window + ring_slack``
    entries (``attention.cache_len_for``).  ``paged=(n_blocks,
    block_size)``: ``k``/``v`` are block pools (A, n_blocks, hkv,
    block_size, hd) and ``pos`` is (batch, view) over each slot's view of
    ceil(max_len / block_size) blocks.  ``kv_quant``: ``k``/``v`` are int8
    and ``k_scale``/``v_scale`` hold a bf16 scale per entry, shaped as
    ``k`` less its hd (pools of scales for a paged cache), zeros as the JAX
    package's ``init_cache(quant=True)`` makes them.  Recurrent layers add
    their state, ``h`` and ``conv`` (``rglru.init_rglru_state`` or
    ``ssm.init_ssd_state``).
    ``kv_heads``: the KV heads this rank holds (``ShardPlan.local_kv``;
    default all of them); ``tp``: the ranks the recurrent state splits over
    (each holds the RG-LRU's w / tp channels, or the SSD's heads / tp and
    its d_in / tp + 2N conv channels); ``kv_seq_shard_dp``: the data ranks
    a wave cache's sequence splits over (``kv_seq_shard``: this rank's
    ceil(max_len / dp) entries, ``pos`` the absolute positions they hold).
    MLA layers cache latents instead of K/V:
    ``ckv``/``krope`` with a unit head axis and their own widths
    (``mla.cache_dims``), bf16 whatever ``kv_quant`` says, as the reference
    keeps its latent cache."""
    fams = layer_families(cfg)
    n_rec = sum(len(fams.get(kind, ())) for kind in RECURRENT)
    n_attn = cfg.n_layers - n_rec
    window = attention_window(cfg)
    hkv, hd = kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.mla is not None:
        leaves, kv_quant = {k: (1, w) for k, w in mla_mod.cache_dims(cfg).items()}, False
    else:
        leaves = {"k": (hkv, hd), "v": (hkv, hd)}
    if paged is not None:
        n_blocks, bs = paged
        shape = lambda h, w: (n_attn, n_blocks, h, bs, w)
        pos_shape = (batch, -(-max_len // bs) * bs)
    else:
        S = attn.cache_len_for(cfg, "local_attn" if window else "attn", max_len, ring_slack,
                               kv_seq_shard_dp)
        shape = lambda h, w: (n_attn, batch, h, S, w)
        pos_shape = (batch, S) if per_slot else (S,)
    kv_dtype = torch.int8 if kv_quant else torch.bfloat16
    caches = {key: torch.zeros(shape(*hw), dtype=kv_dtype, device=device)
              for key, hw in leaves.items()}
    caches["pos"] = torch.full(pos_shape, -1, dtype=torch.int32, device=device)
    if kv_quant:
        for key in ("k_scale", "v_scale"):
            caches[key] = torch.zeros(shape(hkv, hd)[:-1], dtype=torch.bfloat16, device=device)
    if n_rec:
        if "ssd" in fams:
            caches.update(ssm.init_ssd_state(cfg, n_rec, batch, device=device, tp=tp))
        else:
            caches.update(rglru.init_rglru_state(cfg, n_rec, batch, device=device, tp=tp))
    return caches


def lm_head(params: Params, x: torch.Tensor, head_f32: Optional[torch.Tensor] = None,
            valid: Optional[int] = None) -> torch.Tensor:
    """x (b, s, d) -> logits (b, s, V) in fp32, or (b, s, ncb, V) for a
    multi-codebook head, as ``_lm_head`` computes them (at tp > 1 this
    rank's columns of the padded vocab).  A quantized head goes through the
    dequant_matmul kernel with fp32 out; a quantized multi-codebook head is
    dequantized to bf16 and widened for the einsum, as the reference does.
    ``head_f32`` is a resident fp32 copy of a bf16 ``lm_head[0]`` (d, V),
    of the whole (ncb, d, V) head of a multi-codebook one, or of the embed
    table's transpose where the head is tied (no ``lm_head``: the table,
    bf16 whatever the quantization, is the head); at tp > 1 of the rank's
    vocab shard; without one the head is cast for this call.  Columns from
    ``valid`` on pad the vocab to a multiple of tp and read -inf, so no
    top-k picks them (the JAX package leaves them as drawn weights)."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"]["table"].transpose(1, 2)
    quant = isinstance(head, QuantWeight)
    if (head.q if quant else head).shape[0] > 1:                 # multi-codebook
        w = head_f32 if head_f32 is not None else wquant.to_dense(head).float()
        logits = torch.einsum("bsd,cdv->bscv", x.float(), w)
    elif quant:
        logits = wquant.matmul(x, wquant.index_batch(head, 0), out_dtype=torch.float32)
    else:
        logits = x.float() @ (head_f32 if head_f32 is not None else head[0].float())
    if valid is not None and valid < logits.shape[-1]:
        logits[..., valid:] = float("-inf")
    return logits


def lm_head_local(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The head of the training loss (the reference's ``lm_head_local``):
    x (b, c, d) -> this rank's fp32 logits (b, c, local_vocab), or (b, c,
    ncb, local_vocab), differentiable, with no column set to -inf (training
    at tp > 1 pads no vocab column, ``check_trainable``)."""
    return lm_head(params, x)


def train_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                  ctx: Optional[ModelCtx] = None, *,
                  features: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward (the reference's ``forward(..., seq_sharded=True,
    skip_head=True)`` with no cache): tokens (b, s), or (b, s, ncb) frames,
    and a frontend's ``features`` -> (the final-norm hidden states (b,
    prefix + s, d), the summed load-balance loss of the MoE layers, fp32).

    Every layer takes its plain differentiable branch (``KVStep.train``):
    the chunked or banded attention scan, the RG-LRU's associative scan, the
    unfused parallel residual, the MoE gates gathered from the router's
    probabilities (whose detached copy the ``topk`` kernel ranks: the one
    kernel on the path); ``ctx.parallel.remat`` checkpoints each layer.  At
    tp > 1 the residual stream is sequence-sharded and every collective is
    differentiable (``SyncPolicy.train``, the embedding's merge)."""
    b, dev = tokens.shape[0], tokens.device
    ctx = ctx or ModelCtx.make(cfg)
    x = embed_lookup(params["embed"], tokens, plan=ctx.plan, dist=ctx.dist,
                     id_broadcast=ctx.parallel.id_broadcast, train=True)
    if cfg.frontend is not None and features is not None:
        prefix = multimodal.project_features(params["frontend"], features, cfg)
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    s = x.shape[1]
    policy = dataclasses.replace(ctx.policy(seq_sharded=True, seq_len=s), train=True)
    positions = torch.arange(s, device=dev)
    step = attn.KVStep(None, decode=False, q_pos=positions.to(torch.int32).expand(b, s),
                       train=True)
    rope_dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
    x, aux = train_layers(params["layers"], policy.shard_residual(x), cfg,
                          rope=rope_tables(positions, rope_dim, cfg.rope_theta), step=step,
                          policy=policy, remat=ctx.parallel.remat)
    x = policy.unshard_residual(x)
    return rms_norm(x, params["final_norm"], cfg.rms_eps), aux


def _seq_shard_step(caches, b: int, s: int, positions: torch.Tensor, cur_pos, q_pos,
                    dist: Dist) -> attn.KVStep:
    """``_kv_step`` of a sequence-sharded wave cache (``kv_seq_shard``):
    data rank d holds view positions [d * S, (d + 1) * S) of the sequence
    at indices 0..S-1 (the JAX package's ``_write_prefill`` and
    ``_write_decode`` with a ``seq_axis``).  A prefill writes the rank's
    slice of the prompt and attends the whole prompt's fresh K/V; a decode
    step writes its token only on the owner of its position and merges
    the ranks' partials (``KVStep.lse``)."""
    pos = caches["pos"]
    S, dev = pos.shape[0], positions.device
    lo = dist.data_rank * S
    none = torch.zeros((0,), dtype=torch.long, device=dev)
    if cur_pos is not None:
        if not 0 <= cur_pos < S * dist.dp:
            raise ValueError(f"decode position {cur_pos} outside the cache of {S} x {dist.dp}")
        owner, idx = divmod(cur_pos, S)
        step = attn.KVStep(caches, decode=True, lse=dist)
        if owner == dist.data_rank:
            pos[idx] = cur_pos
            step.wave_pos = idx
        else:                        # another rank writes it: no target here
            step.targets, step.src = (none, none), none
        step.valid = (pos >= 0) & (pos <= cur_pos)
        return step
    if s > S * dist.dp:
        raise ValueError(f"seq-sharded prefill needs s <= S*shards ({s} > {S}*{dist.dp})")
    n = max(0, min(s, lo + S) - lo)
    pos.fill_(-1)
    pos[:n] = positions[lo:lo + n].to(pos.dtype)
    idx = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev).repeat_interleave(n)
    src = (torch.arange(b, device=dev)[:, None] * s + lo + idx[None, :]).reshape(-1)
    return attn.KVStep(caches, decode=False, q_pos=q_pos, targets=(rows, idx.repeat(b)),
                       src=src)


def _kv_step(caches, b: int, s: int, positions: torch.Tensor, *, cur_pos, slots,
             block_tables, write_rows=None, chunk_writes=None, window: int = 0,
             length_mask: Optional[torch.Tensor] = None,
             seq_shard: Optional[Dist] = None) -> attn.KVStep:
    """Where this forward writes K/V and recurrent state and what it
    attends, worked out once for all layers; writes the position rows that
    decode needs first.  ``window`` > 0: the attention layers are a
    sliding-window ring, written at position % S and read with the
    window's mask; a chunk into a slot ring attends the rows' position
    stripe as it stands before the chunk, beside the chunk's positions (-1
    where ``length_mask`` marks a pad column).  Recurrent state is carried
    through whole prompts and decode steps, over a dense or a paged cache;
    a chunk does not carry it, as in the reference.  ``seq_shard`` (the
    rank's Dist under ``kv_seq_shard``): the wave cache holds this data
    rank's slice of the sequence (``_seq_shard_step``); slots and chunks
    refuse it, as the reference does."""
    dev = positions.device
    bt = block_tables
    ring = window > 0
    q_pos = None if cur_pos is not None else positions.to(torch.int32).expand(b, s).contiguous()
    if caches is None:
        return attn.KVStep(None, decode=False, q_pos=q_pos)
    pos = caches["pos"]
    if seq_shard is not None:
        if cur_pos is not None and not isinstance(cur_pos, int):
            raise ValueError("per-slot decode positions are incompatible "
                             "with kv_seq_shard (batch=1 long-context path)")
        if pos.dim() != 1 or positions.dim() == 2:
            raise ValueError("chunked prefill is incompatible with "
                             "kv_seq_shard (batch=1 long-context path)")
        return _seq_shard_step(caches, b, s, positions, cur_pos, q_pos, seq_shard)
    if pos.dim() == 1:                                        # wave cache
        S = pos.shape[0]
        if cur_pos is not None:
            if cur_pos < 0 or (not ring and cur_pos >= S):
                raise ValueError(f"decode position {cur_pos} outside the cache of {S}")
            idx = cur_pos % S
            pos[idx] = cur_pos
            valid = (pos >= 0) & (pos <= cur_pos)
            if ring:
                valid &= pos > cur_pos - window
            return attn.KVStep(caches, decode=True, valid=valid, wave_pos=idx)
        pos.fill_(-1)
        if s > S:
            if not ring:
                raise ValueError(f"prompt of {s} tokens is longer than the cache of {S}")
            tail = positions[s - S:]                          # the ring keeps the last S
            idx = tail % S
            pos[idx] = tail.to(pos.dtype)
            return attn.KVStep(caches, decode=False, q_pos=q_pos, ring_idx=idx)
        pos[:s] = positions
        return attn.KVStep(caches, decode=False, q_pos=q_pos, wave_pos=0)
    chunk = cur_pos is None and positions.dim() == 2
    if "h" in caches and chunk:
        raise NotImplementedError("a chunk carries no recurrent state (the reference refuses "
                                  "chunks and verify steps on recurrent layers)")
    if ring and bt is not None:
        raise NotImplementedError("a sliding-window ring is not block-addressable (no paged "
                                  "cache for it)")
    if bt is not None:
        bt = bt.to(device=dev, dtype=torch.int32).contiguous()
    if cur_pos is not None:                                   # slot decode
        rows = torch.arange(b, device=dev) if write_rows is None else write_rows
        wpos = cur_pos if write_rows is None else cur_pos[write_rows]
        attn.write_pos_batched(pos, wpos, rows, ring)
        valid = (pos >= 0) & (pos <= cur_pos[:, None])
        if ring:
            valid &= pos > cur_pos[:, None] - window
        if bt is None:
            targets = (rows, attn.slot_index(wpos, pos.shape[1], ring))
        else:
            targets = attn.paged_decode_targets(bt if write_rows is None else bt[rows], wpos,
                                                attn.block_size(caches))
        return attn.KVStep(caches, decode=True, valid=valid, targets=targets, src=write_rows,
                           bt=bt)
    if bt is None and chunk:                                  # slot chunk
        if slots is None or chunk_writes is None:
            raise ValueError("a chunk into a slot cache names its slots and its writes")
        targets, src = chunk_writes
        kv_pos = None
        if ring:
            real = positions if length_mask is None else torch.where(length_mask, positions, -1)
            kv_pos = torch.cat([pos[slots], real.to(pos.dtype)], dim=1)
        return attn.KVStep(caches, decode=False, q_pos=q_pos, targets=targets, src=src,
                           rows=slots.to(torch.int32).contiguous(), ring_kv_pos=kv_pos)
    if bt is None:                                            # slot admission
        if slots is None:
            raise ValueError("a prefill into a slot cache names the slots it fills")
        if s > pos.shape[1]:
            raise ValueError(f"prompt of {s} tokens is longer than the cache of {pos.shape[1]}")
        pos[slots, :s] = positions.to(pos.dtype)              # index == position (s <= S)
        targets = (slots.repeat_interleave(s), torch.arange(s, device=dev).repeat(len(slots)))
        return attn.KVStep(caches, decode=False, q_pos=q_pos, targets=targets,
                           state_rows=slots)
    targets = attn.paged_flat_targets(bt, q_pos[:, 0], s, attn.block_size(caches))
    return attn.KVStep(caches, decode=False, q_pos=q_pos, targets=targets, bt=bt,
                       paged_read=positions.dim() == 2, state_rows=slots)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[Dict[str, torch.Tensor]] = None, cur_pos=None,
            last_only: bool = False, head_f32: Optional[torch.Tensor] = None,
            length_mask: Optional[torch.Tensor] = None,
            start_pos: Optional[torch.Tensor] = None,
            block_tables: Optional[torch.Tensor] = None,
            slots: Optional[torch.Tensor] = None,
            write_rows: Optional[torch.Tensor] = None,
            chunk_writes=None, ctx: Optional[ModelCtx] = None,
            seq_sharded: bool = False, layout: Optional[moe_mod.RowLayout] = None,
            features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (b, s), or (b, s, ncb) frames of a multi-codebook model ->
    fp32 logits (b, s or 1, V), or (b, s or 1, ncb, V): at tp > 1
    (``ctx``) this rank's vocab shard of them (b, s or 1, local_vocab).

    ``features`` (b, prefix_len, feature_dim), for a config with a
    ``frontend``: the stub encoder's output, projected and put in front of
    the tokens' activations (``multimodal.project_features``), so the
    sequence is prefix_len + s long and every position, cache write and
    mask counts from the prefix's start (``length_mask`` and the logits
    cover prefix + tokens).  Without it the tokens stand alone, as in a
    decode step.

    Without ``cur_pos`` this is a prefill: from position 0, or per row from
    ``start_pos`` (b,) (positions start_pos[b] + arange(s): a cached-prefix
    admission, a chunk of chunked admission, or a verify step).  With
    ``cur_pos`` it is one decode step (s == 1): an int for the wave cache's
    shared position, or a (b,) tensor of per-slot positions.

    The cache is ``init_caches``'s.  A prefill into a slot cache writes rows
    ``slots`` (b,) of it; a chunk (``start_pos`` given) writes there at each
    row's own offset where ``chunk_writes`` says (``attention.chunk_writes``)
    and attends those slots' stripes.  Into a paged cache a prefill writes
    through ``block_tables`` (b, nbps), which decode reads and writes
    through too; its recurrent state is that of rows ``slots`` (the
    admitted ones) of a paged admission.  A slot decode writes the token of the rows ``write_rows``
    (default all: a row being admitted must not write its stale position).
    Recurrent layers continue from the cache's recurrent state of the rows
    computed (the admitted ``slots``, else every row) and write it back;
    ``length_mask`` keeps their pad steps out of it; in a chunk into a slot
    ring it marks the columns written (the rest are chunk padding).
    ``last_only`` keeps one position per row: the last, or with
    ``length_mask`` (b, s) (true at real tokens of a right-padded batch)
    each row's last real token.

    ``ctx`` (default tp=1) places this rank; ``seq_sharded`` (a prefill,
    chunk or verify forward, as the JAX engine chooses) keeps each rank's
    chunk of the sequence in the residual stream between the layers'
    branches (``ModelCtx.policy``).

    ``layout`` (an MoE model's prefill or chunk): the reference's
    other full-width rows, whose pad tokens from position 0 ride along
    for the MoE layers' routing (``moe.RowLayout``); their logits are not
    computed, and they write no cache.  They attend their own fresh K/V,
    or in a chunk into a slot ring, as in the reference, their rows' ring
    beside a chunk whose first column alone is real."""
    b = tokens.shape[0]
    dev = tokens.device
    ctx = ctx or ModelCtx.make(cfg)
    emb = dict(plan=ctx.plan, dist=ctx.dist, id_broadcast=ctx.parallel.id_broadcast)
    if layout is None:
        x = embed_lookup(params["embed"], tokens, **emb)
    else:       # the ghost rows' activations in the same lookup (and its collective)
        x = embed_lookup(params["embed"], torch.cat([tokens, layout.tokens]), **emb)
        x, gx = x[:b], x[b:]
    if cfg.frontend is not None and features is not None:
        prefix = multimodal.project_features(params["frontend"], features, cfg)
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    s = x.shape[1]
    policy = ctx.policy(seq_sharded=seq_sharded, seq_len=s)
    if cur_pos is not None:
        if s != 1 or caches is None:
            raise ValueError("a decode step takes one token per row and a cache")
        positions = (torch.tensor([cur_pos], device=dev) if isinstance(cur_pos, int)
                     else cur_pos[:, None])
    elif start_pos is not None:
        positions = start_pos[:, None] + torch.arange(s, device=dev, dtype=start_pos.dtype)
    else:
        positions = torch.arange(s, device=dev)
    step = _kv_step(caches, b, s, positions, cur_pos=cur_pos, slots=slots,
                    block_tables=block_tables, write_rows=write_rows,
                    chunk_writes=chunk_writes, window=attention_window(cfg),
                    length_mask=length_mask,
                    seq_shard=ctx.dist if ctx.parallel.kv_seq_shard else None)
    if caches is not None and "k_scale" in caches:    # the int8 cache's writes, once
        step.quant_dst = attn.quant_targets(b, s, dev, wave_pos=step.wave_pos,
                                            ring_idx=step.ring_idx, targets=step.targets,
                                            src=step.src)
    rope_dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.resolved_head_dim
    rope = rope_tables(positions, rope_dim, cfg.rope_theta)
    ghost = None
    if layout is not None:
        g, gs = layout.tokens.shape
        gpos = torch.arange(gs, device=dev)
        gstep = attn.KVStep(None, decode=False,
                            q_pos=gpos.to(torch.int32).expand(g, gs).contiguous())
        if step.ring_kv_pos is not None:
            # a chunk into a slot ring: the reference runs those rows through
            # the same ring branch, at offset 0 with one real column,
            # attending their own pre-write ring, and keeps nothing of them
            real = torch.where(gpos == 0, gpos, -1).to(torch.int32).expand(g, gs)
            gstep = dataclasses.replace(
                gstep, cache=caches, rows=layout.others.to(torch.int32),
                ring_kv_pos=torch.cat([caches["pos"][layout.others], real], dim=1))
        ghost = Ghost(layout, policy.shard_residual(gx),
                      rope_tables(gpos, rope_dim, cfg.rope_theta), gstep)
    x = policy.shard_residual(x)
    kw = {} if ghost is None else {"ghost": ghost}
    x = layers_forward(params["layers"], x, cfg, rope=rope, step=step, length_mask=length_mask,
                       policy=policy, **kw)
    x = policy.unshard_residual(x)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if last_only and length_mask is not None:
        last = (length_mask.sum(dim=1) - 1).clamp_min(0)
        x = x[torch.arange(b, device=dev), last][:, None]
    elif last_only:
        x = x[:, -1:]
    return lm_head(params, x, head_f32, ctx.vocab_valid(cfg.vocab_size))
