"""Shared model building blocks: device choice, init rules, norms, RoPE,
activations.  The math follows ``repro.models.common`` line for line, so
the same weights give the same numbers up to float rounding."""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


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


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the fp32 rotation angles, (..., seq, head_dim/2): one
    pair per forward, shared by every layer's q and k."""
    angles = positions[..., None].float() * rope_freqs(head_dim, theta, positions.device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation (not interleaved) in fp32, as the JAX package
    rotates.  x: (..., seq, head_dim); cos/sin from ``rope_tables``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
