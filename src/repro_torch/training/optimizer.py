"""AdamW (``repro.training.optimizer``), over the training tree: a flat
dict key -> parameter tensor (``training/checkpoint.py``), each leaf
updated by the JAX package's formula in fp32 and rounded back to its
dtype.

The moments are fp32, one pair per leaf; the gradients are clipped by
their global norm before the update, and weight decay applies to every
leaf, as in the reference.  The update writes each parameter and moment
in place (a training card holds one copy of the weights), under
``torch.no_grad``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params: Tree) -> Dict:
    """{"m", "v": fp32 zeros per leaf, "step": int32 0}."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros, "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(step: torch.Tensor, c: AdamWConfig) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac, in fp32 (``step`` an
    int32 tensor)."""
    warm = torch.clamp((step + 1) / max(1, c.warmup_steps), max=1.0)
    t = torch.clamp((step - c.warmup_steps) / max(1, c.total_steps - c.warmup_steps), 0.0, 1.0)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return c.lr * warm * cos


def sq_norm(tree: Tree) -> torch.Tensor:
    """The sum of the squares of every leaf, in fp32."""
    total = None
    for x in tree.values():
        part = torch.sum(torch.square(x.float()))
        total = part if total is None else total + part
    return total


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sq_norm(tree))


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Dict, c: AdamWConfig,
                 gnorm: Optional[torch.Tensor] = None) -> Tuple[Tree, Dict, torch.Tensor]:
    """-> (params, state, grad_norm), both updated in place.  ``gnorm``: the
    norm to clip by, where the tree is a shard of the model's
    (``train_loop``); default the tree's own."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(state["step"], c)
    b1c = 1 - c.b1 ** step.float()
    b2c = 1 - c.b2 ** step.float()
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        g = grads[k].float() * scale
        m.copy_(c.b1 * m + (1 - c.b1) * g)
        v.copy_(c.b2 * v + (1 - c.b2) * g * g)
        p32 = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + c.eps) + c.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, gnorm
