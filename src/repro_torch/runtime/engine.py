"""Serving engine: weights and caches on one device, prefill and decode
steps, and the wave ``generate`` loop (``repro.runtime.engine.Engine`` for
the wave path at tp=1).

The decode step is the paper's experiment unit (ms/token of exactly this
function).  The JAX package fuses n decode steps into one ``lax.scan``
program; here the steps are a plain Python loop that keeps the sampled
tokens on the device, so the host waits only once, at the end of
``generate``.  KV caches are updated in place instead of donated.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, SamplingConfig
from repro_torch.core.wquant import QuantWeight
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device
from repro_torch.runtime.sampling import sample_tokens


class Engine:
    """One model on one device.

    ``params`` defaults to random weights drawn on the device from ``seed``
    (``model.init_params``); pass the output of ``repro_torch.bridge`` to
    serve the JAX package's weights.  With ``parallel.weight_quant`` set the
    weights are quantized at load: drawn quantized, or quantized here when
    ``params`` holds bf16 leaves (quantized leaves pass through).  A bf16
    lm_head is kept resident as one fp32 copy, because the logits are
    computed in fp32 and casting the head on every step would allocate and
    write it anew each time; a quantized head is not, since an fp32 copy
    would undo its point."""

    def __init__(self, cfg: ModelConfig, *, parallel: ParallelConfig = ParallelConfig(),
                 sampling: SamplingConfig = SamplingConfig(), max_len: int = 128,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda"):
        M.check_supported(cfg, parallel)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # fp32 products (the lm_head) in full fp32, as the reference does
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.parallel, self.sampling = cfg, parallel, sampling
        self.max_len = max_len
        if params is None:
            params = M.init_params(cfg, parallel, seed=seed, device=self.device)
        self.params = M.quantize_params(params, parallel)
        head = self.params["lm_head"]
        self.head_f32 = None if isinstance(head, QuantWeight) else head[0].float()
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def init_caches(self, batch: int) -> Dict[str, torch.Tensor]:
        return M.init_caches(self.cfg, batch, self.max_len, device=self.device)

    def prefill(self, tokens: torch.Tensor, caches) -> torch.Tensor:
        """Prompt step: writes the cache, samples from the LAST position's
        logits (a pad position for right-padded short rows, as in the JAX
        package) -> next token ids (b,)."""
        logits = M.forward(self.params, tokens, self.cfg, caches=caches,
                           last_only=True, head_f32=self.head_f32)
        return sample_tokens(logits[:, -1], self.sampling, self.generator)

    def decode(self, tok: torch.Tensor, caches, cur_pos: int) -> torch.Tensor:
        """One decode step for the whole batch at the shared position."""
        logits = M.forward(self.params, tok[:, None], self.cfg, caches=caches,
                           cur_pos=cur_pos, head_f32=self.head_f32)
        return sample_tokens(logits[:, -1], self.sampling, self.generator)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """prompts (b, prompt_len) int -> generated tokens (b, max_new) int32."""
        b, plen = prompts.shape
        if plen + max_new > self.max_len:
            raise ValueError(f"prompt_len {plen} + max_new {max_new} exceeds "
                             f"max_len {self.max_len}")
        caches = self.init_caches(b)
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)
        tok = self.prefill(tokens, caches)
        outs = [tok]
        for cur in range(plen, plen + max_new - 1):
            tok = self.decode(tok, caches, cur)
            outs.append(tok)
        return torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()
