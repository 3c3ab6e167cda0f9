"""Serving engine: weights and caches on one device, prefill and decode
steps, the wave ``generate`` loop and the slot engine of continuous
batching over a dense or a paged KV cache (``repro.runtime.engine.Engine``
at tp=1).

The decode step is the paper's experiment unit (ms/token of exactly this
function).  The JAX package fuses n decode steps into one ``lax.scan``
program; here the steps are a plain Python loop that keeps the sampled
tokens on the device, so the host waits only once per block (at the end of
``generate``, and in ``land`` for the slot engine).  KV caches are updated
in place instead of donated.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, SamplingConfig
from repro_torch.core.wquant import QuantWeight
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device
from repro_torch.runtime import kvcache
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

    # -- slot engine (continuous batching) -----------------------------------
    #
    # Every row of a slot cache is an independent slot at its own position.
    # Admission prefills only the admitted slots, in place: the rows it
    # computes are the admitted ones (the JAX package computes the full
    # width and keeps the admitted rows with merge_slots; each row is
    # independent, so the result for an admitted row is the same).  Decode
    # runs all slots; finished and empty slots are masked inside the step.

    def init_slot_caches(self, n_slots: int) -> Dict[str, torch.Tensor]:
        return M.init_caches(self.cfg, n_slots, self.max_len, device=self.device,
                             per_slot=True)

    def init_paged_caches(self, n_slots: int, n_blocks: int,
                          block_size: int) -> Dict[str, torch.Tensor]:
        return M.init_caches(self.cfg, n_slots, self.max_len, device=self.device,
                             paged=(n_blocks, block_size))

    def _admit_rows(self, tokens, admit, plens, **kw) -> np.ndarray:
        """Prefill the admitted rows of ``tokens`` (B, Lp) and sample each
        one's first token from its own last real prompt position -> (B,)
        host tokens (0 on rows not admitted)."""
        rows = np.flatnonzero(np.asarray(admit))
        tok = torch.as_tensor(np.asarray(tokens)[rows], dtype=torch.long, device=self.device)
        plens_d = kvcache.device_ints(np.asarray(plens)[rows], self.device)
        lmask = torch.arange(tok.shape[1], device=self.device)[None, :] < plens_d[:, None]
        logits = M.forward(self.params, tok, self.cfg, last_only=True, length_mask=lmask,
                           head_f32=self.head_f32, **kw)
        out = np.zeros(len(admit), np.int32)
        out[rows] = self.land(sample_tokens(logits[:, -1], self.sampling, self.generator))
        return out

    @torch.inference_mode()
    def prefill_into_slots(self, caches, tokens, admit, plens) -> np.ndarray:
        """Admit requests in flight: prefill ``tokens`` (B, Lp) into the
        slots flagged by ``admit`` (B,) of a live slot cache, right-padded to
        ``plens``; other slots keep their bytes.  Returns each admitted
        slot's first sampled token (B,) on the host."""
        kvcache.reset_slots(caches, admit)
        slots = kvcache.device_ints(np.flatnonzero(np.asarray(admit)), self.device)
        tok = self._admit_rows(tokens, admit, plens, caches=caches, slots=slots)
        kvcache.mask_prompt_padding(caches, plens, admit)
        return tok

    @torch.inference_mode()
    def prefill_into_slots_paged(self, caches, tokens, admit, plens, starts, total_lens,
                                 block_tables) -> np.ndarray:
        """Paged admission.  ``tokens`` (B, Lp) hold each row's prompt
        SUFFIX (the whole prompt when nothing is cached), ``starts`` (B,)
        its absolute offset, ``total_lens`` = starts + plens, and
        ``block_tables`` (B, nbps) the slots' tables, of which only the
        admitted rows are read: the other slots' blocks are never written.
        With any cached prefix the suffix attends each slot's view through
        the table (the paged flash-prefill kernel); without one it attends
        its own fresh K/V (the flash-prefill kernel), as in the dense slot
        engine."""
        rows = np.flatnonzero(np.asarray(admit))
        start = np.asarray(starts)[rows]
        kvcache.reset_slots(caches, admit)
        tok = self._admit_rows(
            tokens, admit, plens, caches=caches,
            block_tables=kvcache.device_ints(np.asarray(block_tables)[rows], self.device,
                                             torch.int32),
            start_pos=kvcache.device_ints(start, self.device) if start.any() else None)
        kvcache.set_slot_positions(caches, total_lens, admit)
        return tok

    @staticmethod
    def land(*tensors):
        """Device tensors -> host numpy, waiting for the work that produces
        them: the slot engine's one synchronisation per call."""
        out = [t.cpu().numpy() for t in tensors]
        return out[0] if len(out) == 1 else out

    @torch.inference_mode()
    def decode_slots(self, caches, tok, pos, done, remaining, eos, *, n: int = 1,
                     block_tables=None):
        """``n`` masked decode steps over all slots, as a Python loop whose
        tokens and state stay on the device; one host copy at the end.
        Finished rows (``done`` or no budget left) keep their token and
        position and rewrite their frozen index, row-locally.  With
        ``block_tables`` (B, nbps) the cache is paged: the table is copied
        to the device once per call, from a fresh host array.  Returns
        host (toks (n, B), pos, done, remaining)."""
        state = kvcache.device_ints(np.stack([tok, pos, done, remaining, eos]), self.device)
        tok_d, pos_d, done_d, rem_d, eos_d = state
        done_d = done_d.bool()
        bt = None if block_tables is None else kvcache.device_ints(
            block_tables, self.device, torch.int32)
        toks = []
        for _ in range(n):
            logits = M.forward(self.params, tok_d[:, None], self.cfg, caches=caches,
                               cur_pos=pos_d, block_tables=bt, head_f32=self.head_f32)
            nxt = sample_tokens(logits[:, -1], self.sampling, self.generator)
            active = ~done_d & (rem_d > 0)
            tok_d = torch.where(active, nxt, tok_d)
            pos_d = torch.where(active, pos_d + 1, pos_d)
            hit_eos = active & (eos_d >= 0) & (tok_d == eos_d)
            rem_d = torch.where(active, rem_d - 1, rem_d)
            done_d = done_d | hit_eos | (rem_d <= 0)
            toks.append(tok_d)
        out = self.land(torch.stack([*toks, pos_d, done_d.long(), rem_d]))
        return (out[:n].astype(np.int32), out[n].astype(np.int32), out[n + 1].astype(bool),
                out[n + 2].astype(np.int32))

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
