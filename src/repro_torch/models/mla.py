"""Multi-head latent attention (DeepSeek-V2 / MiniCPM3 style, absorbed
matmuls): ``repro.models.attention.mla_forward`` and
``mla_latent_attention`` in plain PyTorch, as the JAX package computes them
in jnp.

The cache holds one latent per token, ``ckv`` (kv_lora_rank) and the
RoPE'd key part ``krope`` (qk_rope_head_dim), in the layouts of
``model.init_caches`` with a unit head axis: ``(A, b, 1, S, r)`` for the
wave and slot caches, pools ``(A, n_blocks, 1, bs, r)`` for the paged one.
The unit axis is the JAX package's "dummy head axis": every write of a
``KVStep`` (the wave slice, the slot and pool targets, the chunk writes)
and every slot utility of ``runtime/kvcache.py`` applies to the latents as
it does to K/V.  ``ParallelConfig.kv_quant`` does not apply: the latent
cache stays bf16 with no scales, as in the reference.

Queries are absorbed: ``q_abs`` = q_nope x w_uk in fp32, cast to bf16, so
scores are the two dots nope . ckv + rope . krope, each an fp32 product of
bf16 operands, never concatenated.  Decode attends the valid cache entries
in one masked softmax; prefill, chunks and verify steps stream over
``KV_CHUNK`` entries with the online softmax of the reference, whose
single-chunk result equals decode's, which is what makes chunked == whole
and spec == plain hold.  The fp32 latent output is up-projected by w_uv in
fp32, cast to bf16, and contracted by ``fused_out_projection``.

Under tensor parallelism a rank holds its heads (``ShardPlan``'s padded
layout, n_kv = n_heads) of ``w_uq``/``w_uk``/``w_uv`` and ``w_o``, as the
JAX package's ``_mla_defs`` shards them; ``w_dq``, ``w_dkv`` and the norms
are replicated, so every rank computes and caches the whole latent (the
cache is replicated), and the out-projection returns an unreduced partial
that the layer's ``mixer_reduce`` sums.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.zero_copy import fused_out_projection
from repro_torch.kernels.ref import paged_view
from repro_torch.models.attention import KV_CHUNK, write_targets
from repro_torch.models.common import apply_rope, online_softmax_step, rms_norm

# profiler range around the latent attention (scores, softmax, values):
# launch/profile_decode.py reports its device time per step
MLA_RANGE = "mla latent attention"


def mla_defs(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init rule, fan-in) of one layer's MLA mixer
    (``_mla_defs``), as ``rglru.rglru_defs`` gives its mixer's."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ((d, m.q_lora_rank), "scaled", d),
        "q_norm": ((m.q_lora_rank,), "zeros", 0),
        "w_uq": ((m.q_lora_rank, h * qd), "scaled", m.q_lora_rank),
        "w_dkv": ((d, m.kv_lora_rank + m.qk_rope_head_dim), "scaled", d),
        "kv_norm": ((m.kv_lora_rank,), "zeros", 0),
        "w_uk": ((m.kv_lora_rank, h * m.qk_nope_head_dim), "scaled", m.kv_lora_rank),
        "w_uv": ((m.kv_lora_rank, h * m.v_head_dim), "scaled", m.kv_lora_rank),
        "w_o": ((h, m.v_head_dim, d), "scaled", m.v_head_dim),
    }


def cache_dims(cfg: ModelConfig) -> Dict[str, int]:
    """The latent cache's leaves and their widths."""
    return {"ckv": cfg.mla.kv_lora_rank, "krope": cfg.mla.qk_rope_head_dim}


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., s, r) x (..., t, r) -> (..., s, t): an fp32 product of bf16
    operands (``preferred_element_type=float32``)."""
    return a.float() @ b.float().transpose(-1, -2)


def latent_attention(qa: torch.Tensor, qr: torch.Tensor, kv: torch.Tensor,
                     krope: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """``mla_latent_attention``: qa (b, h, sq, r) absorbed queries and qr
    (b, h, sq, e) RoPE'd ones, bf16, over kv (b, sk, r) and krope (b, sk, e);
    q_pos (sq,) or (b, sq), kv_pos (sk,) or (b, sk) (-1 empty) -> the fp32
    latent output (b, h, sq, r), streamed over KV_CHUNK entries."""
    b, h, sq, _ = qa.shape
    sk = kv.shape[1]
    chunk = min(KV_CHUNK, sk)
    qpos = q_pos if q_pos.dim() == 2 else q_pos[None]
    kvp = kv_pos if kv_pos.dim() == 2 else kv_pos[None]
    m = torch.full((b, h, sq), float("-inf"), device=qa.device)
    l = torch.zeros((b, h, sq), device=qa.device)
    acc = torch.zeros((b, h, sq, kv.shape[-1]), device=qa.device)
    for c0 in range(0, sk, chunk):
        k_i, r_i = kv[:, None, c0:c0 + chunk], krope[:, None, c0:c0 + chunk]
        p_i = kvp[:, c0:c0 + chunk]
        sc = (_dot(qa, k_i) + _dot(qr, r_i)) * scale                 # (b, h, sq, t)
        valid = (p_i[:, None, :] >= 0) & (p_i[:, None, :] <= qpos[:, :, None])
        sc = sc.masked_fill(~valid[:, None], float("-inf"))
        m, m_safe, corr = online_softmax_step(sc, m)
        p = torch.exp(sc - m_safe[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(qa.dtype).float() @ k_i.float()
    return acc / torch.clamp(l, min=1e-30)[..., None]


def decode_attention(qa: torch.Tensor, qr: torch.Tensor, kv: torch.Tensor,
                     krope: torch.Tensor, valid: torch.Tensor, scale: float) -> torch.Tensor:
    """The reference's decode branch: one query per row over the whole
    cache view kv (b, S, r) / krope (b, S, e) in one masked softmax;
    ``valid`` (S,) or (b, S) -> fp32 latent output (b, h, 1, r)."""
    sc = (_dot(qa, kv[:, None]) + _dot(qr, krope[:, None])) * scale   # (b, h, 1, S)
    mask = valid[None, None, None] if valid.dim() == 1 else valid[:, None, None]
    sc = sc.masked_fill(~mask, float("-inf"))
    mx = sc.amax(dim=-1)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    p = torch.exp(sc - mx[..., None])
    acc = p.to(qa.dtype).float() @ kv[:, None].float()
    return acc / torch.clamp(p.sum(dim=-1), min=1e-30)[..., None]


def _write(side: torch.Tensor, new: torch.Tensor, step) -> None:
    """In place: fresh latents ``new`` (b, 1, s, r) into one layer's cache
    ``side`` where ``step`` says (the writes of ``attention.gqa_heads``)."""
    s = new.shape[2]
    if step.targets is not None:
        write_targets(side, new, step.targets, step.src)
    else:
        side[:, :, step.wave_pos:step.wave_pos + s] = new


def mla_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                rope: Tuple[torch.Tensor, torch.Tensor], step, layer: int = 0) -> torch.Tensor:
    """x (b, s, d) -> the attention output (b, s, d) after the
    out-projection.  ``rope`` holds this forward's tables at
    qk_rope_head_dim; ``step`` is the forward's ``attention.KVStep`` and
    ``layer`` the layer's index among the attention layers.

    Where the latents come from: decode writes its token and attends the
    valid entries of the rows' cache (through the block table, paged); a
    whole prompt (wave, slot admission, a fresh paged admission) attends
    its fresh latents; a cached-prefix paged admission or a paged chunk
    the slots' views through ``step.bt`` and a dense chunk the slots'
    stripes ``step.rows``, both with kv positions arange(S): causality
    masks the tail."""
    m = cfg.mla
    b, s, _ = x.shape
    nope, e, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    h = p["w_uq"].shape[-1] // (nope + e)
    scale = 1.0 / math.sqrt(nope + e)

    q_lat = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.rms_eps)
    q = (q_lat @ p["w_uq"]).view(b, s, h, nope + e)
    q_nope, q_rope = q.split([nope, e], dim=-1)
    qr = apply_rope(q_rope.transpose(1, 2), *rope)                       # (b, h, s, e)
    w_uk = p["w_uk"].view(r, h, nope)
    qa = torch.einsum("bshn,rhn->bhsr", q_nope.float(), w_uk.float()).to(x.dtype)

    ckv_new, krope_new = (x @ p["w_dkv"]).split([r, e], dim=-1)
    ckv_new = rms_norm(ckv_new, p["kv_norm"], cfg.rms_eps)
    krope_new = apply_rope(krope_new[:, None], *rope)                    # (b, 1, s, e)
    ckv_new = ckv_new[:, None]

    c = step.cache
    kv, kr, kv_pos = ckv_new[:, 0], krope_new[:, 0], step.q_pos
    if c is not None:
        cc, cr = c["ckv"][layer], c["krope"][layer]
        _write(cc, ckv_new, step)
        _write(cr, krope_new, step)
        if step.bt is not None and (step.decode or step.paged_read):
            kv, kr = paged_view(cc, step.bt)[:, 0], paged_view(cr, step.bt)[:, 0]
        elif step.decode:
            kv, kr = cc[:, 0], cr[:, 0]
        elif step.rows is not None:
            rows = step.rows.long()
            kv, kr = cc[rows, 0], cr[rows, 0]
        if step.paged_read or step.rows is not None:
            kv_pos = torch.arange(kv.shape[1], device=x.device)
    with torch.profiler.record_function(MLA_RANGE):
        if step.decode:
            o_lat = decode_attention(qa, qr, kv, kr, step.valid, scale)
        else:
            o_lat = latent_attention(qa, qr, kv, kr, step.q_pos, kv_pos, scale)
    w_uv = p["w_uv"].view(r, h, m.v_head_dim)
    o = torch.einsum("bhsr,rhv->bhsv", o_lat, w_uv.float()).to(x.dtype)
    return fused_out_projection(o, p["w_o"])
