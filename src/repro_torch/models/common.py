"""Shared model building blocks: the tensor-parallel layout (``Dist``,
``ShardPlan``), device choice, init rules, norms, RoPE, activations, the
streaming softmax step of the jnp attention paths, the carried conv history
of recurrent blocks and their state-carrying layer.  The math follows
``repro.models.common`` line for line, so the same weights give the same
numbers up to float rounding.

Under tensor parallelism every rank runs the same per-shard program on its
own shard of the weights, as the JAX package's per-shard code runs inside
``shard_map``; the collectives are explicit calls of
``repro_torch.core.collectives``, which count them."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Dist:
    """This rank's place in the ``dp`` x ``tp`` world (the JAX package's
    ``Dist``, its model and data axes): ``tp`` ranks of one data replica,
    this one model ``rank`` among them, and ``group``, the
    ``torch.distributed`` process group of the replica; ``dp`` replicas,
    this one ``data_rank`` among them, and ``data_group``, the group of the
    ranks of this model rank in every replica.  World rank
    ``data_rank * tp + rank`` (``launch.mesh.init_tp`` joins the groups).
    ``backend`` "gloo" stages CUDA tensors through host memory, "nccl"
    reduces on the cards.  tp 1 (dp 1) has no model (data) group: every
    collective over that axis is the identity.  ``control`` is a gloo group
    of the whole world (None in a world of one rank), over which world rank
    0 broadcasts the serving control plane's round records (host metadata,
    never on a card)."""

    tp: int = 1
    rank: int = 0
    group: Any = None
    backend: str = "gloo"
    dp: int = 1
    data_rank: int = 0
    data_group: Any = None
    control: Any = None

    @property
    def world_rank(self) -> int:
        return self.data_rank * self.tp + self.rank

    @property
    def world(self) -> int:
        return self.dp * self.tp


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ShardPlan:
    """How attention heads and the vocab land on the ``tp`` ranks
    (``repro.models.common.ShardPlan``, the same rule).

    Q heads are padded to a multiple of tp: zero heads, exact no-ops under
    the row-parallel out-projection and its all-reduce.  When n_kv < tp each
    KV head is replicated over ``kv_rep = tp // n_kv`` adjacent ranks and
    each KV group's Q heads are padded to a multiple of ``kv_rep``."""

    tp: int
    n_heads: int            # true head count
    n_kv_heads: int         # true kv head count
    n_heads_p: int          # padded q heads (multiple of tp)
    n_kv_p: int             # padded kv heads
    kv_rep: int             # how many ranks share one kv head
    local_q: int            # q heads per rank
    local_kv: int           # kv heads per rank
    vocab_p: int            # padded vocab (multiple of tp)
    local_vocab: int

    @staticmethod
    def make(cfg, tp: int) -> "ShardPlan":
        n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
        if n_kv >= tp:
            # shard kv heads directly; pad both q and kv to multiples of tp
            n_kv_p = pad_to(n_kv, tp)
            g = max(1, n_q // n_kv)
            if n_q % n_kv:
                raise ValueError(f"{cfg.name}: n_heads {n_q} not a multiple of n_kv {n_kv}")
            n_q_p = n_kv_p * g
            kv_rep = 1
        else:
            if tp % n_kv:
                raise ValueError(f"{cfg.name}: tp {tp} not a multiple of n_kv {n_kv}")
            kv_rep = tp // n_kv
            g = n_q // n_kv
            if n_q % n_kv:
                raise ValueError(f"{cfg.name}: ragged GQA groups unsupported")
            n_q_p = n_kv * pad_to(g, kv_rep)
            n_kv_p = n_kv
        vocab_p = pad_to(cfg.vocab_size, tp)
        return ShardPlan(tp=tp, n_heads=n_q, n_kv_heads=n_kv, n_heads_p=n_q_p, n_kv_p=n_kv_p,
                         kv_rep=kv_rep, local_q=n_q_p // tp, local_kv=max(1, n_kv_p // tp),
                         vocab_p=vocab_p, local_vocab=vocab_p // tp)

    @property
    def kv_sharded(self) -> bool:
        """KV heads split over the ranks (else each is replicated over
        ``kv_rep`` of them)."""
        return self.n_kv_p >= self.tp

    @property
    def group_p(self) -> int:
        """Q heads per KV head in the padded layout."""
        return self.n_heads_p // self.n_kv_p


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default of every
    entry point) must be present: with no card the call raises instead of
    carrying on on the CPU, which only an explicit ``cpu`` selects."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, not {dev.type!r}")
    return dev


def init_leaf(shape, rule: str, generator: torch.Generator, *, device,
              fan_in: int = 0, dtype=torch.bfloat16) -> torch.Tensor:
    """One parameter by the JAX ``ParamDef`` rules: ``zeros``; ``normal``
    with std 0.02; ``scaled`` with std 1/sqrt(fan_in).  Drawn in fp32 from
    ``generator`` and rounded to ``dtype``."""
    if rule == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    std = 0.02 if rule == "normal" else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the ``(1 + gamma)`` scale (zero-initialised gammas)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def gelu_tanh(x: torch.Tensor, f32_out: bool = False) -> torch.Tensor:
    """The tanh GELU as ``jax.nn.gelu(approximate=True)`` computes it, op by
    op in x's dtype: in bf16 each step rounds where the JAX package's does
    (``F.gelu`` rounds once, and then differs by an ulp in ~40 % of the
    values).  ``f32_out``: the last product in fp32, unrounded, which is
    what XLA computes when the caller widens the result to fp32 at once
    (excess precision, its default, drops that round trip)."""
    c, k = (torch.tensor(v, dtype=torch.float32).to(x.dtype)   # constants in x's dtype
            for v in (math.sqrt(2 / math.pi), 0.044715))
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3)))
    return x.float() * cdf.float() if f32_out else x * cdf


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return gelu_tanh
    raise ValueError(f"unknown activation {name!r}")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the fp32 rotation angles: one pair per forward, shared
    by every layer's q and k (b, heads, seq, head_dim).  Positions (seq,)
    shared by all rows give (seq, head_dim/2); per-row positions (b, seq)
    give (b, 1, seq, head_dim/2), broadcast over the heads."""
    angles = positions[..., None].float() * rope_freqs(head_dim, theta, positions.device)
    if positions.dim() == 2:
        angles = angles[:, None]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (not interleaved) in fp32, as the JAX package
    rotates.  x: (..., seq, head_dim); cos/sin from ``rope_tables``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def online_softmax_step(sc: torch.Tensor, m: torch.Tensor):
    """One KV chunk of the reference's streaming softmax: scores ``sc``
    (..., t) and the running max ``m`` (...) -> (new max, its finite
    stand-in, the correction of the old accumulators), a fully masked row
    keeping max -inf."""
    m_new = torch.maximum(m, sc.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
    return m_new, m_safe, corr


def conv_tail(ext: torch.Tensor, W: int, valid_len: Optional[torch.Tensor],
              tail: torch.Tensor) -> torch.Tensor:
    """Carried depthwise-conv history from the extended input ``ext``
    (b, s+W-1, ch) = [old tail ; new inputs].  ``valid_len`` (b,) ends each
    row's tail at its own last real input (a right-padded admission);
    without it the tail is the last W-1 inputs."""
    if W == 1:
        return tail
    if valid_len is not None:
        idx = valid_len.long()[:, None] + torch.arange(W - 1, device=ext.device)[None, :]
        return torch.gather(ext, 1, idx[..., None].expand(-1, -1, ext.shape[2]))
    return ext[:, -(W - 1):]


def recurrent_layer(forward: Callable, p: Dict[str, torch.Tensor], x: torch.Tensor, cfg, *,
                    cache: Optional[Dict[str, torch.Tensor]], index: int,
                    rows: Optional[torch.Tensor] = None,
                    length_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One recurrent mixer (``forward``: ``rglru_forward`` or
    ``ssd_forward``) over the model's cache: continue from the state of the
    ``index``-th recurrent layer in the cache rows ``rows`` (None: every
    row, in order) and write the new state back in place."""
    if cache is None:
        return forward(p, x, cfg, length_mask=length_mask)[0]
    h, conv = cache["h"][index], cache["conv"][index]
    state = {"h": h, "conv": conv} if rows is None else {"h": h[rows], "conv": conv[rows]}
    out, new = forward(p, x, cfg, state=state, length_mask=length_mask)
    if rows is None:
        h.copy_(new["h"])
        conv.copy_(new["conv"])
    else:
        h[rows] = new["h"]
        conv[rows] = new["conv"].to(conv.dtype)
    return out
