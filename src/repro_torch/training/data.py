"""Synthetic data pipeline: deterministic, shardable token streams (the
port's copy of ``repro.training.data``, on the port's ``ModelConfig``).

``make_batch`` gives the batch of a step, bit for bit the JAX package's: a
fixed-point Markov-1 stream over the vocab with a learnable bigram
structure (so the loss falls in a short run), drawn by numpy from a
generator seeded by (seed, step), so a run resumes without state.  A
multi-codebook config adds a random offset per codebook (frames (b, s,
ncb)); a frontend config gives fewer text positions and the stub encoder's
features (b, prefix_len, feature_dim) fp32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


def _bigram_stream(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """Markov-1 stream: tok[t+1] = (a*tok[t] + noise) % vocab -- learnable."""
    out = np.empty(n, dtype=np.int32)
    t = int(rng.integers(vocab))
    a = 31337 % vocab or 7
    for i in range(n):
        out[i] = t
        t = (a * t + int(rng.integers(0, 17))) % vocab
    return out


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic batch for ``step``: {tokens, labels[, features]}."""
    rng = np.random.default_rng(dc.seed * 1_000_003 + step)
    text_len = dc.seq_len
    if cfg.frontend is not None:
        text_len = dc.seq_len - cfg.frontend.prefix_len
    n = dc.global_batch * (text_len + 1)
    stream = _bigram_stream(rng, n, cfg.vocab_size).reshape(dc.global_batch, text_len + 1)
    if cfg.n_codebooks > 1:
        offs = rng.integers(0, cfg.vocab_size, size=(1, 1, cfg.n_codebooks))
        stream = (stream[..., None] + offs).astype(np.int32) % cfg.vocab_size
    batch = {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
    if cfg.frontend is not None:
        batch["features"] = rng.standard_normal(
            (dc.global_batch, cfg.frontend.prefix_len, cfg.frontend.feature_dim),
            dtype=np.float32,
        )
    return batch


def iter_batches(cfg: ModelConfig, dc: DataConfig, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield make_batch(cfg, dc, step)
        step += 1
