"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060):
``repro.models.ssm``, per shard.

Prefill uses the chunked SSD form (intra-chunk quadratic term + inter-chunk
state scan); decode (s == 1) is the O(1) recurrent update.  Recurrence per
head (P = head_dim, N = state_dim):

    h_i = a_i * h_{i-1} + (dt_i x_i) B_i^T          h: (P, N)
    y_i = h_i C_i + D x_i

with a_i = exp(dt_i * A), A = -exp(A_log) < 0.  Chunked identities (cs =
inclusive cumsum of log a within a chunk):

    intra:      Y[i] += sum_{j<=i} exp(cs[i]-cs[j]) (C_i . B_j) (dt_j x_j)
    into-state: S = sum_j exp(cs[L-1]-cs[j]) (dt_j x_j) B_j^T
    inter:      Y[i] += exp(cs[i]) C_i . H_chunk_start
    carry:      H' = exp(cs[L-1]) H + S

then a gated RMS norm per head and the out-projection.  Everything is plain
PyTorch, as the reference computes it in jnp (no Pallas kernel).  The
dtypes follow the JAX package step by step: projections and the conv in
bf16, dt, the decay, the state and y in fp32, ``y`` rounded to bf16 before
``w_out``.  Where the JAX package widens the conv's bf16 sum to fp32 at
once, its last add is fp32 here, as XLA computes it on the CPU (as in
``rglru._causal_conv``).

The state lives in the model's cache dict, stacked over the SSD layers:
``h`` (n, b, heads, P, N) fp32 and ``conv`` (n, b, W-1, d_in + 2N) bf16
(``init_ssd_state``).

Under tensor parallelism a rank holds heads / tp of the SSD heads, as the
JAX package shards them: the columns of ``w_z``, ``w_x`` and ``w_dt``,
its heads of ``dt_bias``, ``A_log``, ``D`` and ``norm``, and its rows of
the row-parallel ``w_out``; ``w_bc`` (one B/C group) is replicated.  The
conv weight is stored as the rank's own slice, its d_in / tp x channels
followed by the replicated B/C columns (``conv_slice``, the JAX package's
``_conv_weight_local``, which slices the replicated leaf at forward
time), so the conv tail holds d_in / tp + 2N channels a rank.  The block
is per head up to ``w_out`` (the gated norm too), so the rank's program
is the tp=1 one at its heads, read off ``w_dt``'s columns, and ``w_out``
returns an unreduced partial that the layer's ``mixer_reduce`` sums: one
collective a layer.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import conv_tail

N_GROUPS = 1  # mamba2-1.3b uses a single B/C group
# profiler range around the SSD recurrence (from the conv output to the
# gated norm): launch/profile_decode.py reports its device time per step
SSD_RANGE = "ssd scan"


def _dims(cfg: ModelConfig, tp: int = 1) -> Tuple[int, int, int]:
    """(d_inner, SSD heads, a rank's heads), raising where the heads do not
    split over ``tp`` ranks (``repro.models.ssm._dims``)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    if n_heads % tp:
        raise ValueError(f"ssd heads {n_heads} not divisible by tp {tp}")
    return d_in, n_heads, n_heads // tp


def conv_slice(cfg: ModelConfig, tp: int, rank: int) -> Tuple[int, int, int]:
    """Where a rank's conv weight comes from in the global (W, d_in + 2N)
    leaf: (start, width) of its x channels, then the 2N B/C columns kept
    by every rank -> (start, width, 2N)."""
    d_in, _, _ = _dims(cfg, tp)
    loc = d_in // tp
    return rank * loc, loc, 2 * N_GROUPS * cfg.ssm.state_dim


def ssd_defs(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init rule, fan_in, dtype) of the mixer's leaves, as
    ``repro.models.ssm.ssd_defs`` declares them ("scaled" over dim 0;
    ``dt_bias``, ``A_log`` and ``D`` fp32 zeros)."""
    s, d = cfg.ssm, cfg.d_model
    d_in, n_heads, _ = _dims(cfg)
    gn = N_GROUPS * s.state_dim
    bf16, f32 = torch.bfloat16, torch.float32
    return {
        "w_z": ((d, d_in), "scaled", d, bf16),
        "w_x": ((d, d_in), "scaled", d, bf16),
        "w_bc": ((d, 2 * gn), "scaled", d, bf16),
        "w_dt": ((d, n_heads), "scaled", d, bf16),
        "dt_bias": ((n_heads,), "zeros", 0, f32),
        "A_log": ((n_heads,), "zeros", 0, f32),
        "D": ((n_heads,), "zeros", 0, f32),
        "conv_w": ((s.conv_width, d_in + 2 * gn), "scaled", s.conv_width, bf16),
        "norm": ((d_in,), "zeros", 0, bf16),
        "w_out": ((d_in, d), "scaled", d_in, bf16),
    }


def init_ssd_state(cfg: ModelConfig, n_layers: int, batch: int, *,
                   device, tp: int = 1) -> Dict[str, torch.Tensor]:
    """Zero state of ``n_layers`` SSD layers: fp32 ``h``, bf16 ``conv``
    (``init_ssd_state``, stacked), at a rank's heads / ``tp`` and its
    d_in / ``tp`` + 2N conv channels."""
    s = cfg.ssm
    d_in, _, local_h = _dims(cfg, tp)
    conv_ch = d_in // tp + 2 * N_GROUPS * s.state_dim
    return {
        "h": torch.zeros((n_layers, batch, local_h, s.head_dim, s.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, s.conv_width - 1, conv_ch),
                            dtype=torch.bfloat16, device=device),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor],
                 valid_len: Optional[torch.Tensor]):
    """Depthwise causal conv of u (b, s, ch) with taps w (W, ch), continuing
    from ``tail`` (b, W-1, ch) -> (silu(conv) in u's dtype, the new tail).
    The bf16 sum rounds after every product and partial sum but the last
    add, which XLA keeps in fp32 where its consumer widens it."""
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    ext = torch.cat([tail.to(u.dtype), u], dim=1)
    s = u.shape[1]
    acc = sum(ext[:, i:i + s] * w[i] for i in range(W - 1))
    out = acc.float() + (ext[:, W - 1:W - 1 + s] * w[W - 1]).float()
    return F.silu(out).to(u.dtype), conv_tail(ext, W, valid_len, tail)


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L): seg[i, j] = sum_{t=j+1..i} log_a[t] (i >= j),
    -inf above the diagonal; the diagonal is 0."""
    L = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def _rmsnorm_gated(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """y, z (b, s, heads, P) fp32: the norm over each head's channels after
    the gate silu(z); gamma (heads, P)."""
    y = y * F.silu(z)
    var = (y * y).mean(dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * (1.0 + gamma.float())


def ssd_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                length_mask: Optional[torch.Tensor] = None):
    """x (b, s, d) -> (out (b, s, d), new state or None).  ``state`` holds
    ``h`` (b, heads, P, N) and ``conv`` (b, W-1, d_in + 2N) to continue from
    (None: zeros; a prefill then returns no state, a decode step does).
    ``p`` is a rank's shard: its heads are ``w_dt``'s columns, and ``out``
    is its unreduced partial.

    ``length_mask`` (b, s), true at real tokens of a right-padded batch,
    zeroes dt on the pad steps, so a = exp(0) = 1 and dt x vanishes there,
    and ends each row's conv tail at its true length: the carried state
    equals that of an unpadded prefill.  A prefill longer than the SSD
    chunk must be a multiple of it, as the reference requires."""
    sc = cfg.ssm
    b, s, _ = x.shape
    nh, P = p["w_dt"].shape[-1], sc.head_dim

    z = x @ p["w_z"]
    xr = x @ p["w_x"]
    bc = x @ p["w_bc"]
    dt_raw = x @ p["w_dt"]
    tail = state["conv"] if state is not None else None
    valid_len = length_mask.sum(dim=-1) if length_mask is not None else None
    conv_out, new_tail = _causal_conv(torch.cat([xr, bc], dim=-1), p["conv_w"], tail, valid_len)
    with torch.profiler.record_function(SSD_RANGE):
        y, h = _scan(p, conv_out, xr.shape[-1], dt_raw, cfg, state, length_mask)
    y = _rmsnorm_gated(y, z.float().reshape(b, s, nh, P), p["norm"].reshape(nh, P), cfg.rms_eps)
    new_state = None if state is None and s > 1 else {"h": h, "conv": new_tail}
    return y.reshape(b, s, nh * P).to(x.dtype) @ p["w_out"], new_state


def _scan(p, conv_out, loc: int, dt_raw, cfg: ModelConfig, state, length_mask):
    """``ssd_forward``'s recurrence from the conv output (x, then B and C
    from column ``loc`` on) and the projected dt -> (y (b, s, heads, P)
    fp32 before the norm, the new state h)."""
    b, s, nh = dt_raw.shape
    sc = cfg.ssm
    P, N = sc.head_dim, sc.state_dim
    xr = conv_out[..., :loc]
    Bm, Cm = conv_out[..., loc:].chunk(2, dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    dt = dt.clamp(sc.dt_min, 10.0)                                    # (b, s, h)
    if length_mask is not None:
        dt = torch.where(length_mask[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"].float())
    log_a = dt * A
    xh = xr.reshape(b, s, nh, P).float()
    Bh = Bm.reshape(b, s, N_GROUPS, N)[:, :, 0].float()              # (b, s, N)
    Ch = Cm.reshape(b, s, N_GROUPS, N)[:, :, 0].float()
    xdt = xh * dt[..., None]                                          # (b, s, h, P)
    h0 = state["h"] if state is not None else torch.zeros((b, nh, P, N), device=xr.device)

    if s == 1:
        a = torch.exp(log_a[:, 0])                                    # (b, h)
        h_new = h0 * a[..., None, None] + torch.einsum("bhp,bn->bhpn", xdt[:, 0], Bh[:, 0])
        y = torch.einsum("bhpn,bn->bhp", h_new, Ch[:, 0]) + p["D"][None, :, None] * xh[:, 0]
        return y[:, None], h_new
    L = min(sc.chunk, s)
    if s % L:
        raise ValueError(f"seq {s} not divisible by ssd chunk {L}")
    nc = s // L
    la = log_a.reshape(b, nc, L, nh).permute(0, 3, 1, 2)                # (b, h, c, L)
    xc = xdt.reshape(b, nc, L, nh, P).permute(0, 3, 1, 2, 4)            # (b, h, c, L, P)
    Bc, Cc = Bh.reshape(b, nc, L, N), Ch.reshape(b, nc, L, N)
    cs = torch.cumsum(la, dim=-1)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_intra = torch.einsum("bhcij,bhcjp->bhcip", torch.exp(_segsum(la)) * scores[:, None], xc)
    decay_end = torch.exp(cs[..., -1:] - cs)                          # (b, h, c, L)
    S = torch.einsum("bhcj,bhcjp,bcjn->bhcpn", decay_end, xc, Bc)
    chunk_decay = torch.exp(cs[..., -1])                              # (b, h, c)
    H, before = h0, []
    for c in range(nc):                                               # the state before each chunk
        before.append(H)
        H = H * chunk_decay[:, :, c, None, None] + S[:, :, c]
    y_inter = torch.einsum("bhci,bcin,bhcpn->bhcip", torch.exp(cs), Cc, torch.stack(before, dim=2))
    y = (y_intra + y_inter).permute(0, 2, 3, 1, 4).reshape(b, s, nh, P)
    return y + p["D"][None, None, :, None] * xh, H

