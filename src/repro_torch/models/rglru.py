"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
``repro.models.rglru``.

Block: two input branches (gate: GELU; recurrent: causal depthwise conv ->
RG-LRU), their product, an out-projection.  The RG-LRU is elementwise over
the lru_width channels, with block-diagonal gate projections of n_heads
blocks:

    r_t = sigmoid(W_a u_t + b_a)          recurrence gate
    i_t = sigmoid(W_x u_t + b_x)          input gate
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Prefill runs the recurrence through the ``lru_scan`` kernel; decode (s == 1)
is the O(1) step in plain PyTorch.  The training forward (``train``) runs
it as an associative scan in PyTorch ops (``associative_scan``, the
reference's jnp branch), which autograd differentiates.  The dtypes follow the JAX package step
by step: the branches and the conv in bf16, the gates and the recurrence in
fp32, ``y = (h * gate.float()).to(x.dtype)``; where the JAX package
widens a bf16 result to fp32 at once (the conv into the recurrence, the
GELU gate into ``y``), the last op of that result is fp32 here, as XLA
computes it on the CPU.

The recurrent state lives in the model's cache dict, stacked over the
RG-LRU layers: ``h`` (n, b, w) fp32 and ``conv`` (n, b, conv_width - 1, w)
bf16 (``init_rglru_state``).

Under tensor parallelism a rank holds w / tp channels of every leaf (the
branches' and the conv's columns, ``Lambda``, n_blocks / tp gate blocks,
the rows of ``w_out``) and of the state, as the JAX package shards them:
the block is elementwise over the channels, so the rank's program is the
tp=1 one at its width, and ``w_out`` returns an unreduced partial that the
layer's ``mixer_reduce`` sums.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import conv_tail, gelu_tanh


def _dims(cfg: ModelConfig, tp: int = 1) -> Tuple[int, int, int]:
    """(lru_width, n_blocks, block size), raising where the gate blocks do
    not split over ``tp`` ranks (``repro.models.rglru._dims``)."""
    w = cfg.rglru.lru_width or cfg.d_model
    n_blocks = cfg.n_heads
    if w % n_blocks or n_blocks % tp:
        raise ValueError(f"lru_width {w} / n_blocks {n_blocks} / tp {tp} mismatch")
    return w, n_blocks, w // n_blocks


def rglru_defs(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init rule, fan_in, dtype) of the mixer's leaves, as
    ``repro.models.rglru.rglru_defs`` declares them ("scaled" draws with std
    1/sqrt(fan_in), the fan-in being dim 0, or dim 1 of the block-diagonal
    gates; ``Lambda`` is fp32)."""
    d = cfg.d_model
    w, nb, bs = _dims(cfg)
    cw = cfg.rglru.conv_width
    bf16 = torch.bfloat16
    return {
        "w_gate": ((d, w), "scaled", d, bf16),
        "w_x": ((d, w), "scaled", d, bf16),
        "conv_w": ((cw, w), "scaled", cw, bf16),
        "gate_a_w": ((nb, bs, bs), "scaled", bs, bf16),
        "gate_a_b": ((nb, bs), "zeros", 0, bf16),
        "gate_x_w": ((nb, bs, bs), "scaled", bs, bf16),
        "gate_x_b": ((nb, bs), "zeros", 0, bf16),
        "Lambda": ((w,), "normal", 0, torch.float32),
        "w_out": ((w, d), "scaled", w, bf16),
    }


def init_rglru_state(cfg: ModelConfig, n_layers: int, batch: int, *,
                     device, tp: int = 1) -> Dict[str, torch.Tensor]:
    """Zero recurrent state of ``n_layers`` RG-LRU layers: fp32 ``h``, bf16
    ``conv`` (``init_rglru_state``, stacked), at a rank's w / ``tp``
    channels."""
    w = _dims(cfg, tp)[0] // tp
    return {
        "h": torch.zeros((n_layers, batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, cfg.rglru.conv_width - 1, w),
                            dtype=torch.bfloat16, device=device),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor],
                 valid_len: Optional[torch.Tensor]):
    """Depthwise causal conv of u (b, s, ch) with taps w (W, ch), continuing
    from ``tail`` (b, W-1, ch) -> (out, the new tail in u's dtype).

    In bf16 the sum rounds after every product and partial sum, as the JAX
    package writes it, except the last add, which stays fp32: XLA (excess
    precision allowed, its default) drops the round trip to bf16 between
    that add and the consumer that widens it (the recurrence input), while
    the gates read it rounded.  ``out`` is that fp32 value; round it for
    the gates.  Rounding it for both moves logits by ~1e-1 a few layers on."""
    W = w.shape[0]
    if tail is None:
        tail = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    ext = torch.cat([tail.to(u.dtype), u], dim=1)
    s = u.shape[1]
    acc = sum(ext[:, i:i + s] * w[i] for i in range(W - 1))
    out = acc.float() + (ext[:, W - 1:W - 1 + s] * w[W - 1]).float()
    return out, conv_tail(ext, W, valid_len, tail)


def _block_diag(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """u (b, s, w) through the block-diagonal linear map w (nb, bs, bs) plus
    bias b (nb, bs), in fp32."""
    nb, bs, _ = w.shape
    ub = u.reshape(*u.shape[:2], nb, bs).float()
    out = torch.einsum("bsnx,nxy->bsny", ub, w.float()) + b.float()
    return out.reshape(u.shape)


def associative_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + bx_t along dim 1 from h_{-1} = 0, as a
    log-depth scan of the combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)
    (the reference's ``jax.lax.associative_scan``, in Hillis-Steele order:
    the same products, summed in another order).  Out of place, so autograd
    differentiates it."""
    s, d = a.shape[1], 1
    while d < s:
        a_prev = torch.nn.functional.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        b_prev = torch.nn.functional.pad(bx[:, :-d], (0, 0, d, 0))
        a, bx = a * a_prev, a * b_prev + bx
        d *= 2
    return bx


def rglru_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                  state: Optional[Dict[str, torch.Tensor]] = None,
                  length_mask: Optional[torch.Tensor] = None, train: bool = False):
    """x (b, s, d) -> (out (b, s, d), new state or None).  ``state`` holds
    ``h`` (b, w) and ``conv`` (b, W-1, w) to continue from (None: zeros, and
    no state is returned).  ``length_mask`` (b, s), true at real tokens of a
    right-padded batch, makes the pad steps identities (a = 1, input term 0)
    and ends each row's conv tail at its true length, so the carried state
    equals that of an unpadded prefill.  ``train``: the training forward's
    branch (no state), the scan in PyTorch ops (``associative_scan``)
    rather than the ``lru_scan`` kernel, whose output has no gradient."""
    c = cfg.rglru.c_constant
    gate = gelu_tanh(x @ p["w_gate"], f32_out=True)   # read in fp32 only
    u = x @ p["w_x"]
    tail = state["conv"] if state is not None else None
    valid_len = length_mask.sum(dim=-1) if length_mask is not None else None
    u_f32, new_tail = _causal_conv(u, p["conv_w"], tail, valid_len)
    u = u_f32.to(x.dtype)

    r = torch.sigmoid(_block_diag(u, p["gate_a_w"], p["gate_a_b"]))
    i = torch.sigmoid(_block_diag(u, p["gate_x_w"], p["gate_x_b"]))
    a = torch.exp(-c * F.softplus(p["Lambda"].float()) * r)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    bx = beta * i * u_f32
    if length_mask is not None:
        lm = length_mask[..., None]
        a = torch.where(lm, a, 1.0)
        bx = torch.where(lm, bx, 0.0)

    h0 = state["h"] if state is not None else torch.zeros(
        (x.shape[0], u.shape[-1]), dtype=torch.float32, device=x.device)
    if train:
        if state is not None:
            raise ValueError("the training forward carries no recurrent state")
        hs, new_state = associative_scan(a, bx), None
    elif x.shape[1] == 1:
        h = a[:, 0] * h0 + bx[:, 0]
        hs, new_state = h[:, None], {"h": h, "conv": new_tail}
    else:
        hs, h_final = ops.lru_scan(a.contiguous(), bx.contiguous(), h0.contiguous())
        new_state = {"h": h_final, "conv": new_tail} if state is not None else None
    y = (hs * gate).to(x.dtype)
    return y @ p["w_out"], new_state

