#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles every CUDA kernel of ``src/repro_torch/kernels/csrc``
   with nvcc (one process per source, all at once);
3. kernels: each kernel at the full-width shapes of the serving paths
   (attention, paged attention, the verify chunk's flash_verify and top-k
   at yi-9b; dequant_matmul at yi-9b int8 and qwen-72b int4, decode and
   prefill widths; flash_prefill and flash_verify also over slot stripes
   read through the row index; lru_scan, top-k over its vocab and the
   head_dim-256 windowed prefill and ring decode at recurrentgemma-9b;
   fused_dual_matmul at gptj-parallel's decode and prefill shapes, the
   heads read in place, and at the JAX sweep's odd shape in bf16 and fp32;
   the head_dim-256 flash_verify, paged decode and paged prefill at
   gptj-parallel's 16 MHA heads; the decode kernels' int8 load path at
   yi-9b's, qwen-72b's (4, 64, 1, 128) over 2950 of 4096 rows and the
   head_dim-256 shapes, dense and paged, bit for bit against the bf16
   kernel on the dequantized cache; kv_quant_write in the wave's, a ring's
   and the slots' and pools' layouts, bit for bit against its plain
   version), against its plain PyTorch version on the same inputs (stated
   tolerance; lru_scan, whose tiles combine carries in their own order, against an fp64 scan: at most 4x the plain version's
   error or 1e-5 of max |h|, at the wave prefill, a one-request admission
   and slow decays; top-k bit for bit, NaN rows included; both one launch
   a call), with its time, the plain version's, one PyTorch library
   call's for the same function (a yardstick the port never calls) and
   the least time the card could take (bytes at 3.35 TB/s or operations
   at the peak of their type, whichever is larger); the attention, matmul,
   lru_scan and top-k rows also carry the registers and spills nvcc's
   -Xptxas -v printed for the kernel instance they time;
4. reference: a small GQA model on the card (kernels) against the same
   model on the CPU (plain versions), in bf16, int8 and int4 weights, and
   over the int8 KV cache in bf16 and int4 weights:
   prefill and 8 decode-step logits; and in bf16, with and without the
   int8 KV cache, the slot engine's
   chunked-admission steps (Engine.mixed_step, a chunk beside a decode
   half) and verify steps (Engine.verify_slots, with drafts partly wrong so
   that some are rejected and the slots rewound): every sampled logits row
   and the position rows; and a small RG-LRU hybrid (head_dim 256, window
   64) through a wave and the slot engine past its ring's wrap, the slots
   admitted a second time, in bf16 and with int8 weights and the int8 KV
   cache: every logits row and the recurrent state; and a
   small parallel-residual model (head_dim 256) through a teacher-forced
   forward, a wave, the dense slot engine in chunks with spec decode, and
   the paged pool whole-prompt and in chunks with spec decode, the card
   handed the CPU's tokens: every live logits row; a sequential residual
   planted on the card must fail the same limit;
5. serve: four full-width models with random weights from a seed, each
   through the port's WaveScheduler: yi-9b in bf16, over the int8 KV cache
   and in int8 (48 layers), qwen-72b in int4 (80 layers), gptj-parallel in
   bf16 (28 layers).  Each serves 8 requests in waves of 4, greedy, 32 new
   tokens each; and qwen-72b in int4 over the int8 KV cache serves 4
   prompts of 2800-3000 tokens into a 4096-token cache in one wave, 32 new
   tokens each, with its peak memory below the card's (a bf16 cache of
   that size would not fit beside the weights); tokens in range, a second
   run identical, and every kernel's launch count as the path predicts it
   (gptj-parallel: one fused_dual_matmul a layer per forward; int8 KV: L
   kv_quant_write per forward and the decode kernels' int8 instance);
6. slots: full-width yi-9b bf16 (48 layers) through continuous batching,
   over the dense slot cache (ContinuousScheduler) and the paged one
   (PagedContinuousScheduler), each once admitting whole prompts
   (``prefill_chunk=0``) and once admitting in chunks of 64 tokens with
   speculative decoding (``spec_k=4``): 12 requests behind a shared
   64-token system prompt, 4 slots, arrivals every 4 decode steps, budgets
   of 8..32 tokens, greedy.  Tokens in range and a second run identical;
   every kernel's launch count as the schedulers' own counts predict it;
   chunked admission, decode during admission and verify steps really
   happened; prefix reuse really happened and the block allocator's audit
   passes (paged); and per request the tokens equal the whole-prompt dense
   phase's, or part first where the top-2 logits lie within 1e-2, with at
   most half the requests parted.  The dense spec phase runs once more
   with a drafter that proposes the whole-prompt phase's own next tokens,
   every other time with a wrong last draft: it must accept drafts and
   reject some, emit more than one token per verify step and give the
   same tokens.  Random full-width weights make greedy streams that
   repeat one token whatever their context, so these token checks show
   that the path runs and rewinds, not that its attention reads the
   right rows: phase 4 shows that.  The four phases run again over the
   int8 KV cache, each parting certified against the plain versions (as
   gptj-parallel's are, in 8): its paged cached prefix is a second
   approximation of the cache in the reference too;
7. hybrid: full-width recurrentgemma-9b (3 of 38 layers), in bf16 and then
   with int8 weights and the int8 KV cache, through the
   WaveScheduler (prompts of 2100-2300 tokens, longer than the 2048-token
   window) and the ContinuousScheduler (its default chunk falls back to
   whole prompts; slots decode past position 2048): tokens in range, a
   second run identical, the ring wrapped, and launch counts exactly one
   lru_scan a recurrent layer and one flash_prefill an attention layer per
   prefill forward, one decode_attention an attention layer per decode
   step (int8: its int8 instance, one kv_quant_write an attention layer a
   forward, and a dequant_matmul per quantized projection); then 4 decode steps
   past the window under
   torch.profiler, whose decode_attention device time over its launches
   stands beside the head_dim-256 decode row's cold time (``in_step``);
8. parallel slots: full-width gptj-parallel bf16 (28 layers)
   through the four phases of 6, on the same workload and checks, its
   launches counted as there, with one fused_dual_matmul a layer per
   forward (two per mixed step with a decode half); but where a stream parts from the dense
   phase's, the plain versions (run on the card) certify the near-tie:
   on the same inputs the port's logits lie within 5e-2 of theirs, and
   both tokens within 5e-2 of their top.

9. tensor parallelism: two ranks, one process each, share the card over
   gloo, their collectives staged through host memory (no wall time of
   these phases is a tensor-parallel speed).  First the small GQA model,
   the same with QKV bias in int4 and the small parallel-residual model at
   tp=2 against the same weights at tp=1 on the CPU: every logits row of a
   21-token prefill (the ranks' sequence chunks differ) and 8 decode steps
   within 5e-2, the greedy wave's tokens the CPU's (a parting certified at
   a CPU top-2 gap below 1e-2).  Then full width, each rank drawing every
   global leaf from the tp=1 seed and keeping its shard: yi-9b bf16 (48
   layers) through phase 5's wave workload and phase 6's paged
   chunked-spec one; gptj-parallel bf16 (28 layers) waves with and
   without one_shot_sync; qwen-72b int4 (80 layers) in one wave of 4, its
   embedding vocab-sharded; and at the cut depth of the tp=1 phases they
   are held to: recurrentgemma-9b bf16 (3 layers: R, R, A; its rank's 2048
   of 4096 RG-LRU channels and 8 q heads over the replicated KV head; its
   256000-row table vocab-sharded) in one wave of 4 of phase 7's
   2100-2300-token prompts, past the window; deepseek-moe-16b bf16 (14
   layers; 32 of 64 experts a rank) in one wave of 4 of phase 5's prompts
   (> 256 routed tokens: drops) and phase 6's paged chunked-spec workload;
   mixtral-8x7b int4 (4 layers; 4 of 8 experts a rank, 16 q over 4 KV
   heads) and minicpm3-4b bf16 (8 layers; 20 of 40 latent heads a rank,
   the latent cache replicated) in one wave of 4 each; mamba2-1.3b bf16
   (8 layers; 32 of 64 SSD heads a rank, its tied head over the
   vocab-sharded table) in one wave of 4 of phase 5's prompts and phase
   11's paged slot workload; musicgen-medium bf16 (12 layers; 12 of 24
   heads, the (4, d, 1024) head shard, (b, 4) frames) in one wave of 4;
   and at full depth internvl2-26b int4 (48 layers, 24 q over 4 KV heads,
   its 92553-row table vocab-sharded, its lm_head's 46277-column rank
   shard through dequant_matmul) in one wave of 4, both behind their
   zero-feature prefixes.  Per request, each
   holds the tokens of the tp=1 phase of the same weights (qwen-72b and
   the cut-depth waves: the first four of their tp=1 wave; the two-sync
   gptj wave: the one-shot one's too; a frame's every codebook a token of
   its own) or parts at a
   near-tie of the tp=1 model, at most half parted: a top-2 gap below
   1e-2 (not enough alone for gptj-parallel), or a witness: for
   gptj-parallel the plain versions, as its slot phases; else the tp
   ranks' own logits at the parting, within twice the tp=1 port's
   distance from its plain versions there (at least 5e-2) of tp=1's, each
   side's token within once that of the other's top.  Each phase prints its collectives (``comm``:
   one decode step at b 4 and the whole run, by tag), and a decode step
   must all-reduce 2 x L times (L with one_shot_sync; once an SSD layer),
   each 64 KiB on the wire for yi-9b, plus the two top-k gathers and,
   where the table is vocab-sharded (qwen-72b, recurrentgemma-9b,
   mamba2-1.3b's tied one, internvl2-26b), the embedding's all-reduce;
   every rank's launches as
   predicted (two top-k launches a sampling call; each MoE layer's routing
   top-k once a forward on every rank; one lru_scan a recurrent layer a
   prefill); every rank the same tokens and the same dropped assignments,
   and deepseek's wave the tp=1 wave's drops, layer call by layer call
   (its paged job too where no stream parted).  Kernel rows at the ranks'
   shapes: lru_scan at (4, 2304, 2048), decode_attention at
   recurrentgemma's (4, 8, 1, 256) over its ring, at mixtral's (4, 16
   over 4, 1, 128) over the wrapped 4100-entry ring and at internvl's (4,
   24 over 4, 1, 128), the top-k over musicgen's (16, 1024) shard of a
   step's frames and dequant_matmul at internvl's int4 lm_head rank shard,
   their launches counted on the tp phases.  With two or
   more cards the yi-9b wave runs once more over NCCL, one card a rank;
   with one, a line says why it did not run.

10. latent attention and experts (run before 9): reduced minicpm3-4b
   (MLA) and deepseek-moe-16b (MoE; bf16 and int4) on the card against
   the same weights on the CPU: prefill and 8 decode-step logits within
   5e-2, and the paged pool's greedy streams in chunks of 16 with spec
   decode equal or parted at a CPU top-2 gap below 1e-2; one MoE forward
   of 320 tokens on both with the same top experts and the same dropped
   assignments.  Then full width from seed 0: minicpm3-4b bf16 (8 of 62
   layers; its latent attention is plain PyTorch, no attention kernel
   runs) and deepseek-moe-16b bf16 (14 of 28 layers) each through phase 5's
   wave workload and phase 6's paged chunked-spec phase, and deepseek in
   int4 through the wave, whose 4 x <= 125-token prefills route more than
   256 tokens and drop assignments past capacity: tokens in range, a
   second run identical, launches as predicted (one routing top-k launch
   per MoE layer and forward beside the sampling one), ms/token, peak
   memory and the drops.  Kernel rows at deepseek's shapes: flash_prefill
   and decode_attention at 16 MHA heads of 128 (g 1), the routing top-k
   over (T, 64) fp32 rows, k 6.

11. experts over a sliding-window ring, and Mamba-2 SSD (run before 9):
   reduced mixtral-8x7b (window 64) in bf16, int4 and over the int8 KV
   cache on the card against the CPU: a 72-token prompt into its 64-entry
   wave ring and 8 decode steps, the CPU replaying the card's expert
   choices, within 5e-2; the continuous scheduler in chunks of 16 with
   spec decode of 4 drafts, its chunks and verify steps landing on a
   68-entry ring that has wrapped: greedy streams equal, or parted where
   the card's token lies within 5e-2 of the CPU's top, the CPU's top-2 gap
   is below 1e-2 or a router near-tie was replayed.  Reduced mamba2-1.3b:
   logits and its recurrent state (h, conv) through a prefill and 8
   decode steps, and the wave, continuous and paged streams.  Then full
   width from seed 0: mixtral-8x7b int4 (4 of 32 layers) through phase 5's
   wave workload, then 4 prompts of 4040-4090 tokens into 4 slots in
   chunks of 256 with spec decode of 4 drafts, every slot decoding past
   its 4100-entry ring (the wrap asserted from its position rows), in
   bf16 K/V and over the int8 cache, once each; mamba2-1.3b bf16 (8 of
   48 layers) through the wave and the continuous and paged slot phases (the pool
   reserves no block; phase 9's tp jobs are held to its wave and paged
   streams).  Launches as predicted (a chunk or a verify step
   into the ring attends in plain PyTorch, as the reference's jnp), peak
   memory, ms/token and the MoE drops.  Kernel rows at mixtral's shapes:
   flash_prefill at g 4 with the window, decode_attention and its int8
   instance over the wrapped ring, the routing top-k over (T, 8), k 2,
   dequant_matmul at its int4 w_q and lm_head; and the top-k over mamba2's
   vocab.

12. the modality prefix and the multi-codebook head (run before 9):
   reduced internvl2-26b and musicgen-medium on the card against the same
   weights on the CPU behind 8 positions of seeded non-zero features: a
   prefill and 8 decode-step logits within 5e-2, and Engine.generate's
   greedy streams equal or parted where every differing codebook shows a
   CPU top-2 gap below 1e-2.  Then full width from seed 0, zero features:
   internvl2-26b at full depth, bf16 (48 layers, its 256-position prefix)
   through phase 5's wave workload, the slot workload through the
   ContinuousScheduler (whole prompts: the frontend blocks chunks) in bf16
   and over the int8 KV cache on the same weights, and the int4 wave
   (phase 9's internvl job is held to it); musicgen-medium bf16 at 12 of 48
   layers (its 64-position prefix, (b, 4) frames) through the wave
   (phase 9's musicgen job is held to it) and continuous phases.  Tokens in range, a second run
   identical, launches as predicted (a multi-codebook head is dequantized
   for its einsum, no dequant_matmul launch; one top-k launch samples a
   step's b x 4 frames), peak memory and ms a frame; the bf16 continuous
   streams equal the same requests served through the wave, each in a
   wave of 4 copies of itself (no padding), or part where both tokens of
   every differing codebook lie within 5e-2 of the card's teacher-forced
   top (the two paths prefill at other widths), at most MAX_PARTED
   parted.  Kernel rows at
   their shapes: flash_prefill over prefix + prompt at g 6 / head_dim 128
   and g 1 / head_dim 64, decode_attention there (internvl's int8
   instance too), the top-k over (4, 92553) and (16, 2048), dequant_matmul
   at internvl's int4 w_q and 92553-column lm_head, kv_quant_write of
   internvl's slot admission and decode.

13. the serving control plane (run with phase 6, on its yi-9b engine at 48
   layers): the slot workload through the ContinuousScheduler and the
   PagedContinuousScheduler (whole prompts), blocking and overlapped
   (``overlap``: decode block N+1 dispatched on block N's device outputs
   before N lands), twice each in the order B, O, O, B, every overlapped
   dispatch under
   ``torch.cuda.set_sync_debug_mode("error")``: the same streams and the
   same launches, the loop ahead of the host (landings, dispatch-ahead
   depth 2), the host-blocked and overlapped seconds and each loop's wall
   printed; the paged overlapped loop under the fault plan
   ``step:at=6,times=2;poison:slot=1,at=12;alloc:at=20``: one request
   quarantined, two step retries, every survivor's stream the clean run's;
   the dense loop with the class mix interactive=0.25,standard=0.5,
   batch=0.25, the degradation ladder on and a burst of 12 batch requests:
   the ladder's level after every round printed, only batch shed, the
   workload's admitted survivors as the unloaded run's; and the HTTP
   frontend (``launch/frontend.py``) on 127.0.0.1 over the overlapped
   continuous scheduler: 4 concurrent SSE clients get the tokens the
   scheduler retired with, 6 concurrent requests against max_pending 4 get
   a 429 with Retry-After, and a stream in flight at the drain is served
   whole before the listener closes.  A stream may part from its reference
   at a top-2 gap below 1e-2 (the runs admit in other batches), at most
   MAX_PARTED.

14. the data axis (after phase 9; ``dp_phases``): ranks spawned over gloo
   share the card, their collectives and KV-block transfers staged through
   host memory (no wall is a data-parallel or disaggregated speed).  On
   two ranks, yi-9b bf16 at 48 layers: one 16000-token prompt, greedy, 32
   new tokens, through the WaveScheduler with ``kv_seq_shard`` (16384
   cache entries, 8192 a rank), held to the dp=1 wave of the same prompt
   on the slot phases' weights (every token, but a first parting at a
   dp=1 top-2 gap below 1e-2; the sampled logits within REF_TOL up to it;
   an all-reduce max and sum tagged ``lse_merge`` a layer and decode step;
   one prefill and the decode steps' launches on each rank); then the slot
   workload through the DisaggScheduler at 1p1d (2 + 2 slots, chunks of
   64), held to phase 6's dp=1 ``paged-chunked`` phase as phase 9 holds
   its tp jobs (partings certified, at most half), the ``migrate`` sends'
   bytes equal to migrated_blocks x pool_block_bytes, decode-side prefix
   hits once the shared prompt has landed, the prefill pool's ranks
   launching no decode kernel and the decode pool's no chunk kernel, the
   allocator's audit clean on every rank, and the pools:, migration: and
   migration wait lines printed.  On four ranks the certification mix
   (int8 weights and K/V) at 2p2d with 8 slots, at 24 of 48 layers
   (``EARLIER_DEPTH``, with the dp=1 run it is held to), clean and under
   ``migrate:handoff=1`` (one request quarantined, the survivors' streams
   the clean run's, every rank's audit clean), held to a dp=1 unified
   paged run on rank 0's card (partings certified on the plain versions,
   as the int8-KV slot phases certify them).  Row 4s times the decode
   kernel at a kv_seq_shard rank's slice.  Over NCCL where the card count
   allows (else a line says why not).

15. the control plane across ranks (``control_ranks_start`` before phase
   10, its ranks running beside phases 10 and 11, and
   ``control_ranks_phase`` after them): yi-9b bf16 at full width and 8 of
   48 layers
   (``EARLIER_DEPTH``) in one spawn of four gloo ranks on the card, dp 2 x
   tp 2, world rank 0 deciding
   what reads the wall clock and broadcasting it in a round record (tag
   ``control``).  Phase 13's workload and plans: (a) blocking against
   overlapped on the dense slot cache and the paged one, the same
   streams, retire order and (rid, token) emission order; (b) the paged
   overlapped loop under CP_FAULTS, one request quarantined with two
   retries, the dp=1 run's quarantine, retries and preemptions, every
   survivor the clean overlapped run's (a preemption changes who shares a
   batch, so a survivor may part at a certified near-tie, as in phase 13);
   (c) the dense loop with
   CP_CLASS_MIX, the ladder, CP_BURST and deadlines (two requests whose
   deadline passed at once, the rest one no run reaches): the dp=1 run's
   levels after every round, transitions, sheds and timeouts, the
   survivors the unloaded run's (certified
   partings aside); (d) disagg 1p1d
   (each pool a tp 2 replica, chunks of 64) plain, held to a dp=1 unified
   paged run at the same chunk, and overlapped under the ladder with the
   interactive block reserve and the burst: interactive never shed, only
   batch shed, the survivors the plain run's (certified partings aside);
   (e) the HTTP frontend on
   rank 0 over the overlapped dense loop, ranks 1-3 following the records:
   4 SSE clients get the dp=1 run's tokens, 6 requests against
   max_pending 4 get a 429 with Retry-After, the drain serves the stream
   in flight and the stop record ends all four ranks.  Every rank the
   same streams, outcomes, order, levels and counters, and two control
   broadcasts (a record) every round of every run; every other stream
   held to a dp = tp = 1 run on this process's card (rank 0's), a parting
   certified by its top-2 gap there (< 1e-2) or, as phase 9 certifies
   one, by the replica's own logits, at most half of a run's streams
   (but the frontend's, whose batches follow HTTP timing: CP_HELD).
   The sync-debug check of phase 13 (``sync_checked_dispatch``) holds at
   tp = dp = 1 and under NCCL with a card a rank; over gloo each staged
   all-reduce copies to the host inside the dispatch, so this phase does
   not make it.  No wall here is a speed, nor one of phases 10 and 11
   (the ranks share the card and the host's cores with them; they time no
   kernel).  The phase prints its seconds.

16. training (after phases 10 and 11, beside phase 15's ranks, in the
   time they still take: ``train_phases``, ``train_ranks_phase``): (a)
   reduced yi-9b (activation checkpointing on) and deepseek-moe-16b (off,
   so each forward routes once), fp32 weights drawn on the CPU, TF32 off:
   two ``make_train_step`` steps on the card against the same on the CPU,
   the loss within 1e-4 relative and the weights within 5e-4; a token the
   card's router ranks apart from the CPU's must be a near-tie (< 1e-3 in
   probability), and then the card replays the CPU's routes
   (``moe.ROUTE_REPLAY``), the line counting them; (b) yi-9b at full width
   and 4 of 48 layers through ``launch/train.py`` (bf16, 20 steps of 8 x
   128 tokens, lr 1e-3, ``--ckpt`` into a temporary directory): every loss
   and grad norm finite, min(last 5 losses) below the first, no kernel
   launched, the checkpoint restored on the card bit-equal and its weights
   giving the next batch's loss exactly; its peak memory and ms a step
   (taken beside phase 15's ranks); (c) reduced yi-9b in phase 15's dp 2 x
   tp 2 world of gloo ranks, each running ``_train_rank`` after its own
   work: AdamW and ZeRO-1, two steps, every rank's whole model within 5e-4
   and 1e-3 of (a)'s dp = 1 CPU run, with the first step's collectives by
   tag.  Its lines are ``{"train": ...}`` and add no launch to the
   kernels line.

Earlier slices' phases that no tp phase is held to and whose checks read
the same at any depth run at a cut depth (``EARLIER_DEPTH``:
recurrentgemma-9b 3 of 38 layers, the gptj-parallel slot phases 14 of 28,
the yi-9b int8-KV slot phases 24 of 48, its int8-weight and int8-KV waves
12 of 48, phase 10's minicpm3-4b 8 of 62 and deepseek-moe-16b 14 of 28,
phase 11's mixtral-8x7b 4 of 32 and mamba2-1.3b 8 of 48, phase 12's
musicgen-medium 12 of 48, phase 14's 2p2d int8 mix 24 of 48, phase 15's
control plane 8 of 48), so that the whole run stays under its limit with
phases 10-15 added.  The tp phases of the dense family and internvl2-26b,
and the tp=1 phases they are held to, run at full depth; the RG-LRU,
MoE, MLA, SSD and musicgen tp phases run at their tp=1 phases' cut depth
(drawing those weights again at full depth would cost minutes).  The slot
phases hold at most MAX_PARTED partings, and shallower
random models part more often (the yi-9b int8-KV ones at 12 layers: 7 of
12), so they keep their earlier depths.  qwen-72b's
int8-KV wave stays at 80 layers: its peak memory must show that 4 x 4096
tokens fit the card; phase 12's internvl2-26b runs at full depth (its peak
memory shows that its 39.7 GB of bf16 weights serve on one card).

Each kernel row of the last lines counts its launches on the phases of the
arches whose shapes it was timed at (``launches_counted_on``), the tp
phases' launches summed over their ranks.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
hold the kernels' JSON and one serve JSON line per phase.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS = 989e12           # dense bf16 tensor-core peak
FP32_FLOPS = 67e12            # fp32 outside the tensor cores
L2_FLUSH_BYTES = 128 * 2**20  # > the 50 MB L2: each timed launch starts cold

# yi-9b at full width: 32 q heads over 4 KV heads, head_dim 128, vocab 64000
B, HQ, HKV, HD, VOCAB = 4, 32, 4, 128, 64000
PREFILL_S, DECODE_S, DECODE_VALID = 128, 512, 300
SERVE_REQUESTS, SERVE_BATCH, SERVE_MAX_NEW, SERVE_MAX_LEN = 8, 4, 32, 256
# gptj-parallel: 28 layers of 16 MHA heads of head_dim 256, d 4096, a plain
# GELU FFN of 16384, vocab 50400; every layer's attention out-projection and
# FFN down-projection go through one fused_dual_matmul
GJ_ARCH, GJ_H, GJ_HD, GJ_D, GJ_F = "gptj-parallel", 16, 256, 4096, 16384
# (arch, weight_quant, kv_quant) of the serve phases, in order; consecutive
# phases of one (arch, weight_quant) share their weights
SERVE_PHASES = (("yi-9b", "none", False), ("yi-9b", "none", True), ("yi-9b", "int8", False),
                ("qwen-72b", "int4", False), ("qwen-72b", "int4", True), (GJ_ARCH, "none", False))
# qwen-72b int4 with the int8 KV cache: 4 prompts of 2800-3000 tokens in one
# wave, 32 new tokens, a 4096-token cache (a bf16 cache would not fit beside
# the weights)
QWEN_LONG = dict(requests=4, batch=4, prompt=(2800, 3000), max_new=32, max_len=4096)
# paged kernels: 16-token blocks; decode over a shuffled 32-entry table
# (512-token view, 300 valid rows); prefill of a 64-token suffix after a
# 64..128-token prefix in a 256-token view
BLOCK, DECODE_NBPS, PREFILL_SQ, PREFILL_VIEW = 16, 32, 64, 256
# slot stripes of a (4, 4, 256, 128) slot cache read through the row index:
# a verify chunk of SPEC_K + 1 queries at frontiers 93..246, and a 64-token
# chunk at offsets 64..128
SPEC_K, STRIPE = 4, 256
# the continuous-batching phases: serve.py --requests 12 --slots 4
# --shared-prefix 64 --prompt-len 64 --max-new 32 --max-new-spread 4
# --arrival-every 4 --kv-block-size 16, max_len 256
SLOT_WORKLOAD = dict(requests=12, shared_prefix=64, prompt_len=64, max_new=32,
                     max_new_spread=4, arrival_every=4)
# at most MAX_PARTED of a phase's streams may part from the dense phase's
SLOTS, TIE_GAP, MAX_PARTED = 4, 1e-2, SLOT_WORKLOAD["requests"] // 2
# recurrentgemma-9b: 16 q heads over 1 KV head of head_dim 256, a 2048-token
# window, lru width 4096, vocab 256000; the wave phase's prefill is 4 rows of
# up to 2304 tokens
RG_ARCH, RG_HQ, RG_HD, RG_WINDOW, RG_W, RG_SQ = "recurrentgemma-9b", 16, 256, 2048, 4096, 2304
RG_VOCAB = 256000
RG_WAVE = dict(requests=8, batch=4, prompt=(2100, 2300), max_new=32, max_len=2400)
RG_SLOTS = dict(requests=8, slots=4, prompt=(1984, 2048), max_new=(64, 128), arrival_every=4,
                max_len=2304)
# The depth of earlier slices' phases that the tp phases do not hold to and
# whose checks read the same at any depth, cut so that the whole run stays
# near its ~800 s aim (PERF.md section 4): recurrentgemma-9b's four phases,
# gptj-parallel's and yi-9b's int8-KV slot phases, yi-9b's int8-weight and
# int8-KV waves, phase 10's minicpm3-4b and deepseek-moe-16b phases and
# phase 11's mixtral-8x7b and mamba2-1.3b phases (phase name -> layers;
# their full-depth peaks and ms/token are in PERF.md section 6).  The dense
# tp phases, the tp=1 phases they are held to, qwen-72b's int8-KV wave (its
# peak memory shows that 4 x 4096 tokens fit one card) and phase 12 run at
# full depth; the RG-LRU, MoE, MLA and SSD tp phases and musicgen-medium's
# at their tp=1 phases' cut depth here (musicgen's phase-12 checks read
# the same at any depth; internvl2-26b's stay at 48 layers for its peak
# memory).  deepseek-moe-16b runs 14 layers: its tp=2 paged chunked-spec
# job parted from the tp=1 phase in 7 of 12 streams at 6 and at 28 layers
# and in 3 at 14, every parting certified (router near-ties; PERF.md
# section 6), against the at-most-half rule.
EARLIER_DEPTH = {"recurrentgemma-9b": 3, "gptj-parallel slots": 14, "yi-9b int8-KV slots": 24,
                 "yi-9b int8 wave": 12, "yi-9b int8-KV wave": 12, "minicpm3-4b": 8,
                 "deepseek-moe-16b": 14, "mixtral-8x7b": 4, "mamba2-1.3b": 8,
                 "musicgen-medium": 12, "yi-9b 2p2d int8 mix": 24, "yi-9b control ranks": 8}


def wave_name(weight_quant: str, kv_quant: bool) -> str:
    """A wave phase's name in EARLIER_DEPTH: "wave", "int8 wave", "int8-KV
    wave", "int8-KV int4 wave"."""
    return ("int8-KV " if kv_quant else "") + ("" if weight_quant == "none"
                                              else weight_quant + " ") + "wave"


def phase_config(arch: str, phase: str = ""):
    """``arch``'s config, at the cut depth of EARLIER_DEPTH where its entry
    (``arch``, or ``arch`` + " " + ``phase``) has one."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    n = EARLIER_DEPTH.get(f"{arch} {phase}".strip(), EARLIER_DEPTH.get(arch))
    return dataclasses.replace(cfg, n_layers=n) if n else cfg


# dequant_matmul cases: (what, mode, T, K, N, out dtype); the first is the
# int4 qwen-72b decode hot path and heads the kernels line
DQ_CASES = (("qwen-72b w_up int4, decode", "int4", B, 8192, 24576, torch.bfloat16),
            ("yi-9b w_up int8, decode", "int8", B, 4096, 11008, torch.bfloat16),
            ("qwen-72b lm_head int4, decode", "int4", B, 8192, 151936, torch.float32),
            ("qwen-72b w_down int4, prefill", "int4", 512, 24576, 8192, torch.bfloat16),
            ("yi-9b w_down int8, prefill", "int8", 512, 11008, 4096, torch.bfloat16),
            # a tp=2 rank's w_down rows: shard-local int4 groups
            ("qwen-72b w_down int4 tp=2 shard, decode", "int4", B, 12288, 8192, torch.bfloat16))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cold_ms(fn, flush: torch.Tensor, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of fn() in ms by CUDA events around each call, the
    L2 flushed before each (as the serving path finds it after a layer's
    weight sweep).  The device first sleeps while the host queues every
    call, so host-side launch cost does not show up as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)   # ~0.1 s of GPU clock cycles
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(n_bytes: float, ops: float, peak: float) -> dict:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ptxas_row(source: str, instance: str) -> dict:
    """What nvcc's ``-Xptxas -v`` printed when it built the kernel instance
    of ``csrc/<source>.cu`` whose mangled name holds ``instance``: its
    registers and spill store / load bytes."""
    from repro_torch.kernels import build

    hits = [(e, i) for e, i in build.ptxas_info(source).items() if instance in e]
    if len(hits) != 1:
        fail(f"{source}: {len(hits)} kernel instances match {instance!r} in nvcc's report")
    entry, info = hits[0]
    return {"entry": entry, **info}


# the mangled-name part of each attention instance a row times (bf16): the
# prefill body's tensor-core kernel <HD, PAGED, SPLIT>, the decode body's
# kernel <bf16, HD, PAGED>
def _mma(hd: int, paged: bool, split: bool) -> str:
    return f"mma_body6kernelILi{hd}ELb{int(paged)}ELb{int(split)}E"


def _dec(hd: int, paged: bool, q8: bool = False) -> str:
    return f"decode6kernelI13__nv_bfloat16Li{hd}ELb{int(paged)}ELb{int(q8)}E"


# the mangled-name part of a matmul kernel instance (csrc/gemm_sm90.cuh's
# Cfg<MODE, WM, MT, WN, NT, BK, ...>) that serves a `kind` weight at T rows
def _gemm(kind: str, T: int) -> str:
    from repro_torch.kernels import ops

    bk, bn, bm = ops.gemm_tile(kind, T, 128)
    wn = 1
    if T > ops.GEMM_NARROW_T and kind != "bf16":
        wm, mt, nt = 8, 1, 16          # wgmma: two warpgroups of 64 columns
    elif T > ops.GEMM_NARROW_T:
        wm, mt, wn, nt = 4, 2, 2, 8    # mma.sync: 4 x 2 warps
    else:
        (wm, mt), nt = {512: (8, 4), 256: (8, 2), 128: (4, 2)}[bm], bn // 8
    mode = ("bf16", "int8", "int4").index(kind)
    return f"CfgILi{mode}ELi{wm}ELi{mt}ELi{wn}ELi{nt}ELi{bk}E"


def check_kernels(dev, flush) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = []

    # flash prefill: one wave's prompt attention of one layer
    q = rnd(B, HQ, PREFILL_S, HD).bfloat16()
    k, v = rnd(B, HKV, PREFILL_S, HD).bfloat16(), rnd(B, HKV, PREFILL_S, HD).bfloat16()
    q_pos = torch.arange(PREFILL_S, device=dev, dtype=torch.int32).expand(B, -1).contiguous()
    scale = HD ** -0.5
    got = ops.flash_prefill(q, k, v, q_pos, scale)
    want = ref.flash_prefill_ref(q, k, v, q_pos, scale)
    err = (got.float() - want.float()).abs().max().item()
    tol = 3e-2
    if not err <= tol:
        fail(f"flash_prefill differs from its plain version by {err} > {tol}")
    pairs = (q_pos.long() + 1).clamp(max=PREFILL_S).sum().item() * HQ
    out.append({
        "name": "flash_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:114",
        "counter": "flash_prefill",
        "shape": f"q ({B},{HQ},{PREFILL_S},{HD}) bf16, k/v ({B},{HKV},{PREFILL_S},{HD}), causal",
        "ptxas": ptxas_row("flash_prefill", _mma(HD, False, False)),
        "max_abs_err": err, "tolerance": tol,
        "ms": cold_ms(lambda: ops.flash_prefill(q, k, v, q_pos, scale), flush),
        "plain_ms": cold_ms(lambda: ref.flash_prefill_ref(q, k, v, q_pos, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), flush),
        **bound(2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * q_pos.numel(),
                4 * HD * pairs, BF16_FLOPS),
    })

    # decode attention: one decode step of one layer over a part-filled cache
    q = rnd(B, HQ, 1, HD).bfloat16()
    k, v = rnd(B, HKV, DECODE_S, HD).bfloat16(), rnd(B, HKV, DECODE_S, HD).bfloat16()
    valid = torch.arange(DECODE_S, device=dev) < DECODE_VALID
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
    m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, scale)
    o, o2 = acc / l[..., None], acc2 / l2[..., None]
    err = max((o - o2).abs().max().item(), (m - m2).abs().max().item())
    l_rel = ((l - l2).abs() / l2).max().item()
    tol = 1e-3
    if not (err <= tol and l_rel <= 1e-4):
        fail(f"decode_attention differs from its plain version: {err} (tol {tol}), "
             f"l relative {l_rel} (tol 1e-4)")
    mask = valid[None, None, None, :]
    out.append({
        "name": "decode_attention_partial", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:66",
        "counter": "decode_attention",
        "shape": f"q ({B},{HQ},1,{HD}) bf16, k/v ({B},{HKV},{DECODE_S},{HD}), "
                 f"{DECODE_VALID} valid",
        "ptxas": ptxas_row("decode_attention", _dec(HD, False)),
        "max_abs_err": err, "tolerance": tol,
        "ms": cold_ms(lambda: ops.decode_attention_partial(q, k, v, valid, scale), flush),
        "plain_ms": cold_ms(lambda: ref.decode_attention_ref(q, k, v, valid, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True), flush),
        # bytes: only the K/V rows the mask keeps need reading
        **bound(2 * (q.numel() + 2 * B * HKV * DECODE_VALID * HD) + valid.numel()
                + 4 * (m.numel() + l.numel() + acc.numel()),
                4 * HD * B * HQ * DECODE_VALID, BF16_FLOPS),
    })

    # top-k over the fp32 logits: k = 1 is the greedy path the serve phases
    # run, at yi-9b's vocab and at recurrentgemma-9b's; k = 40 (the serve
    # CLI's default) is checked and timed beside it; bit for bit against
    # the plain version, one launch a call.  The NaN case (NaN on either
    # side of a chunk edge, a row of NaN, -inf) is held to the plain
    # version on the CPU, whose sort ranks NaN first by index as the JAX
    # package does; whether the card's sort agrees is recorded
    entry = None
    # at tp=2 (the tp phases): a rank's vocab shard, then the tp * k candidates
    for V, kk, key in ((VOCAB, 1, None), (VOCAB, 40, "k40"), (RG_VOCAB, 1, f"v{RG_VOCAB}"),
                       (VOCAB, 40, "nan"), (VOCAB // TP, 1, "tp2_shard"),
                       (TP, 1, "tp2_candidates"), (TP * 40, 40, "tp2_candidates_k40")):
        x = rnd(B, V)
        if key == "nan":
            chunk, _ = ops.topk_chunk_plan(B, V, kk, ops._sm_count(x.device))
            x[0, [chunk - 1, chunk, V - 1]] = float("nan")
            x[1] = float("nan")
            x[2, :100] = float("-inf")
        before = ops.LAUNCHES["topk"]
        vals, idx = ops.topk(x, kk)
        if ops.LAUNCHES["topk"] != before + 1:
            fail(f"topk made {ops.LAUNCHES['topk'] - before} launches in one call")
        rv, ri = ref.topk_ref(x.cpu() if key == "nan" else x, kk)
        same = (torch.equal(vals.cpu().view(torch.int32), rv.cpu().view(torch.int32))
                and torch.equal(idx.cpu(), ri.cpu()))
        err = (vals.cpu() - rv.cpu()).nan_to_num().abs().max().item()
        if not same:
            fail(f"topk ({B}, {V}) k={kk} {key or ''} differs from its plain version (value "
                 f"error {err}, indices equal {torch.equal(idx.cpu(), ri.cpu())})")
        timed = {
            "shape": f"x ({B},{V}) fp32, k={kk}", "max_abs_err": err, "tolerance": 0.0,
            "ms": cold_ms(lambda: ops.topk(x, kk), flush),
            "plain_ms": cold_ms(lambda: ref.topk_ref(x, kk), flush),
            "library_ms": cold_ms(lambda: torch.topk(x, kk), flush),
            **bound(4 * x.numel() + 8 * B * kk, x.numel(), FP32_FLOPS),
        }
        if key == "nan":
            _, ci = ref.topk_ref(x, kk)
            timed.update(shape=timed["shape"] + ", NaN at a chunk edge, a row of NaN, -inf",
                         card_sort_agrees=bool(torch.equal(ci, ri.to(dev))))
        if entry is None:
            # the floor of this timing: one launch that does nothing worth
            # counting (a one-element fill), CUDA events around it as above
            one = torch.zeros(1, device=dev)
            entry = {"name": "topk", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/topk.cu",
                     "replaces": "src/repro/kernels/topk_shard.py:66",
                     "counter": "topk", "ptxas": ptxas_row("topk", "topk_kernelIfE"), **timed,
                     "launch_floor_ms": cold_ms(one.zero_, flush)}
        else:
            entry[key] = timed
    out.append(entry)
    out.append(check_dequant(dev, flush))
    out.extend(check_paged(dev, flush))
    out[0]["stripe"] = check_stripe_prefill(dev, flush)
    out.append(check_verify(dev, flush))
    for row in out:     # the rows above are counted on the yi-9b and qwen-72b phases
        row["arches"] = ["yi-9b", "qwen-72b"]
    out.extend(check_hybrid_kernels(dev, flush))
    out.extend(check_parallel_kernels(dev, flush))
    out.extend(check_int8_kernels(dev, flush))
    out.extend(check_moe_kernels(dev, flush))
    out.extend(check_ring_ssd_kernels(dev, flush))
    out.extend(check_frontend_kernels(dev, flush))
    out.extend(check_tp_rank_kernels(dev, flush))
    out.extend(check_dp_rank_kernels(dev, flush))
    return out


def check_parallel_kernels(dev, flush) -> list:
    """gptj-parallel's kernels: fused_dual_matmul at its widths, the heads
    read in place, at each T the serving paths give it -- decode at 4 and 8
    rows (one n8 tile), a verify step of 4 slots x (SPEC_K + 1) (T 20, 32
    padded rows) and one slot's 64-token chunk (the widest byte-bound
    instance), a prefill (T 512, the 128 x 128 tiles) -- and at the JAX
    sweep's odd shape in bf16 (the narrow-load path) and fp32 (the fp32
    CUDA-core GEMM), each with the registers and spills nvcc reported for
    the instance it runs; the head_dim-256 instances of the
    verify and paged kernels at its 16 MHA heads (g 1).  Their launches are
    counted on the gptj-parallel phases only.  Tolerance of
    fused_dual_matmul: fp32 1e-4 abs + 1e-4 rel (sums over K up to 20480 in
    another order), bf16 1e-2 abs + 1e-2 rel (one output rounding apart)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(8)
    cases = []
    for what, a_shape, kb, d, dtype in (
            ("gptj decode", (B, GJ_H, 1, GJ_HD), GJ_F, GJ_D, torch.bfloat16),
            ("gptj decode at 8 rows", (2 * B, GJ_H, 1, GJ_HD), GJ_F, GJ_D, torch.bfloat16),
            ("gptj tp=2 shard decode", (B, GJ_H // 2, 1, GJ_HD), GJ_F // 2, GJ_D,
             torch.bfloat16),
            ("gptj verify step", (B, GJ_H, SPEC_K + 1, GJ_HD), GJ_F, GJ_D, torch.bfloat16),
            ("gptj 64-token chunk", (1, GJ_H, PREFILL_SQ, GJ_HD), GJ_F, GJ_D, torch.bfloat16),
            ("gptj prefill, heads read in place", (B, GJ_H, PREFILL_S, GJ_HD), GJ_F, GJ_D,
             torch.bfloat16),
            ("JAX sweep's odd shape, bf16", (257, 129), 65, 33, torch.bfloat16),
            ("JAX sweep's odd shape, fp32", (257, 129), 65, 33, torch.float32)):
        heads = len(a_shape) == 4
        T = a_shape[0] * a_shape[2] if heads else a_shape[0]
        ka = a_shape[1] * a_shape[3] if heads else a_shape[1]
        a = torch.randn(a_shape, generator=gen, device=dev).to(dtype)
        wa = (torch.randn((ka, d), generator=gen, device=dev) * ka ** -0.5).to(dtype)
        b = torch.randn((T, kb), generator=gen, device=dev).to(dtype)
        wb = (torch.randn((kb, d), generator=gen, device=dev) * kb ** -0.5).to(dtype)
        # the kernel takes w_o as (h, hd, d) and the heads as they lie; the
        # plain version and the library call the (T, Ka) matrix, made beforehand
        a_in, wa_in = (a, wa.view(a_shape[1], a_shape[3], d)) if heads else (a, wa)
        a2 = a.transpose(1, 2).reshape(T, ka) if heads else a
        got = ops.fused_dual_matmul(a_in, wa_in, b, wb).float()
        want = ref.fused_dual_matmul_ref(a2, wa, b, wb).float()
        err = (got - want).abs().max().item()
        lim = 1e-4 if dtype == torch.float32 else 1e-2
        if not ((got - want).abs() <= lim + lim * want.abs()).all():
            fail(f"fused_dual_matmul {what} differs from its plain version by {err} "
                 f"(tol {lim} abs + {lim} rel)")
        w_cat = torch.cat((wa, wb), 0)
        esz = a.element_size()
        cases.append({
            "case": what,
            "shape": (f"a {'heads ' if heads else ''}{tuple(a_shape)} @ ({ka},{d}) + b ({T},{kb}) "
                      f"@ ({kb},{d}) {str(dtype)[6:]}"),
            "max_abs_err": err, "tolerance": f"{lim} abs + {lim} rel",
            "ptxas": ptxas_row("fused_dual_matmul", _gemm("bf16", T) if dtype == torch.bfloat16
                               else "gemm_f32_kernel"),
            "ms": cold_ms(lambda: ops.fused_dual_matmul(a_in, wa_in, b, wb), flush),
            "plain_ms": cold_ms(lambda: ref.fused_dual_matmul_ref(a2, wa, b, wb), flush),
            "library_ms": cold_ms(lambda: torch.matmul(torch.cat((a2, b), 1), w_cat), flush),
            **bound(esz * (a.numel() + wa.numel() + b.numel() + wb.numel() + T * d),
                    2 * T * (ka + kb) * d, FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS),
        })
        del a, wa, b, wb, w_cat, got, want, a_in, wa_in, a2
    out = [{"name": "fused_dual_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_dual_matmul.cu",
            "replaces": "src/repro/kernels/fused_residual.py:47",
            "counter": "fused_dual_matmul", "arches": [GJ_ARCH],
            "library": "torch.matmul(torch.cat((a, b), 1), w_cat): cuBLAS over the activations "
                       "concatenated in the timed call and the weights concatenated beforehand",
            **{k: cases[0][k] for k in ("shape", "max_abs_err", "tolerance", "ms", "plain_ms",
                                        "library_ms", "bound_ms", "bound_by")},
            "cases": cases}]
    heads = (GJ_H, GJ_H, GJ_HD)
    for row in [check_verify(dev, flush, heads), *check_paged(dev, flush, heads)]:
        row.update(name=row["name"] + " (head_dim 256)", arches=[GJ_ARCH])
        out.append(row)
    return out


def check_hybrid_kernels(dev, flush) -> list:
    """The RG-LRU hybrid's kernels at recurrentgemma-9b's shapes: lru_scan
    at the wave prefill's (4, 2304, 4096), at an odd width, at a one-request
    admission (1, 2048, 4096) and with slow decays; the decode
    and prefill attention at head_dim 256, g 16, over the 2048-token window.
    Their launches are counted on the recurrentgemma phases only."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = []

    # lru_scan: the tiled scan combines its segments' carries in its own
    # order, so it is held to an fp64 scan of the same inputs
    # (ref.lru_scan_limit: its worst error at most 4x the plain fp32
    # version's, or 1e-5 of the largest |h|); two calls give the same bits,
    # one launch each.  Cases: the wave prefill, an odd width, a one-request
    # admission, and slow decays (a in [0.9, 0.999], a trained RG-LRU's
    # range, b = sqrt(1 - a^2) x), where the carries matter most
    lru_tile = "kernelIfLb1E"
    cases = []
    for bsz, sq, w, decay in ((B, RG_SQ, RG_W, "random"), (B, RG_SQ, 4000, "random"),
                              (1, RG_WINDOW, RG_W, "random"), (B, RG_SQ, RG_W, "slow")):
        if decay == "random":
            a, x = torch.sigmoid(rnd(bsz, sq, w)), rnd(bsz, sq, w)
        else:
            a = 0.9 + 0.099 * torch.rand((bsz, sq, w), generator=gen, device=dev)
            x = torch.sqrt(1 - a * a) * rnd(bsz, sq, w)
        h0 = rnd(bsz, w)
        before = ops.LAUNCHES["lru_scan"]
        hs, hT = ops.lru_scan(a, x, h0)
        hs2, hT2 = ops.lru_scan(a, x, h0)
        if ops.LAUNCHES["lru_scan"] != before + 2:
            fail(f"lru_scan made {ops.LAUNCHES['lru_scan'] - before} launches in two calls")
        if not (torch.equal(hs, hs2) and torch.equal(hT, hT2) and torch.equal(hT, hs[:, -1])):
            fail(f"lru_scan ({bsz}, {sq}, {w}): two calls differ or h_final is not the last h")
        want, want_T = ref.lru_scan_ref(a, x, h0)
        err = max((hs - want).abs().max().item(), (hT - want_T).abs().max().item())
        del hs2, hT2, want
        lim = ref.lru_scan_limit(a, x, h0)
        kern64 = max((hs.double() - lim["want"]).abs().max().item(),
                     (hT.double() - lim["want_T"]).abs().max().item())
        if not kern64 <= lim["limit"]:
            fail(f"lru_scan ({bsz}, {sq}, {w}), {decay} decay: error {kern64} against fp64 > "
                 f"{lim['limit']} (the plain version's {lim['plain']})")
        del lim["want"]
        cases.append({
            "shape": f"a, b ({bsz},{sq},{w}) fp32, h0 ({bsz},{w}), {decay} decay",
            "max_abs_err": err, "err_fp64": kern64, "plain_err_fp64": lim["plain"],
            "tolerance": f"fp64 error <= max({ref.LRU_ERR_FACTOR} x plain's, "
                         f"{ref.LRU_ERR_FLOOR} max|h|) = {lim['limit']}",
            "ms": cold_ms(lambda: ops.lru_scan(a, x, h0), flush),
            "plain_ms": (cold_ms(lambda: ref.lru_scan_ref(a, x, h0), flush, iters=3, warmup=1)
                         if decay == "random" else None),
            "library_ms": None,
            **bound(4 * (3 * a.numel() + 2 * h0.numel()), 2 * a.numel(), FP32_FLOPS),
        })
        del a, x, h0, hs
    out.append({"name": "lru_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
                "replaces": "src/repro/kernels/lru_scan.py:39", "counter": "lru_scan",
                "arches": [RG_ARCH],
                "library": "none: no single PyTorch call computes a linear recurrence",
                "tile": ops.lru_tile_plan(), "ptxas": ptxas_row("lru_scan", lru_tile),
                **{k: cases[0][k] for k in ("shape", "max_abs_err", "err_fp64", "plain_err_fp64",
                                            "tolerance", "ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")},
                "odd_width": cases[1], "admission_b1": cases[2], "slow_decay": cases[3]})

    # decode over a 2048-entry ring: per row, the window of a query at
    # position f over entries written at p % 2048 (rows 0 and 3 wrapped,
    # row 2 not yet full)
    S, scale = RG_WINDOW, RG_HD ** -0.5
    q = rnd(B, RG_HQ, 1, RG_HD).bfloat16()
    k, v = rnd(B, 1, S, RG_HD).bfloat16(), rnd(B, 1, S, RG_HD).bfloat16()
    idx = torch.arange(S, device=dev)
    frontiers = [2300, 2047, 1500, 3000]
    valid = torch.stack([(f - (f - idx) % S >= 0) for f in frontiers]).contiguous()
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
    m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, scale)
    o, o2 = acc / l[..., None], acc2 / l2[..., None]
    err = max((o - o2).abs().max().item(), (m - m2).abs().max().item())
    l_rel = ((l - l2).abs() / l2).max().item()
    if not (err <= 1e-3 and l_rel <= 1e-4):
        fail(f"decode_attention at head_dim 256 differs from its plain version: {err} "
             f"(tol 1e-3), l relative {l_rel} (tol 1e-4)")
    n_valid = int(valid.sum())
    out.append({
        "name": "decode_attention_partial (head_dim 256)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:66", "counter": "decode_attention",
        "arches": [RG_ARCH],
        "shape": f"q ({B},{RG_HQ},1,{RG_HD}) bf16, k/v ({B},1,{S},{RG_HD}) ring, per-row "
                 f"window masks at positions {frontiers} ({n_valid} valid)",
        "library": "SDPA with a per-row bool mask",
        "ptxas": ptxas_row("decode_attention", _dec(RG_HD, False)),
        "max_abs_err": err, "tolerance": 1e-3,
        "ms": cold_ms(lambda: ops.decode_attention_partial(q, k, v, valid, scale), flush),
        "plain_ms": cold_ms(lambda: ref.decode_attention_ref(q, k, v, valid, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid[:, None, None, :], scale=scale, enable_gqa=True), flush),
        **bound(2 * (q.numel() + 2 * n_valid * RG_HD) + valid.numel()
                + 4 * (m.numel() + l.numel() + acc.numel()),
                4 * RG_HD * RG_HQ * n_valid, BF16_FLOPS),
    })

    # windowed prefill of the wave's longest prompts over their fresh K/V:
    # per element as the stripe rows (outputs here are ~0.04, so an absolute
    # limit would not see the band's edge), and the plain version one key
    # narrower or wider must fail the same limit
    q = rnd(B, RG_HQ, RG_SQ, RG_HD).bfloat16()
    k, v = rnd(B, 1, RG_SQ, RG_HD).bfloat16(), rnd(B, 1, RG_SQ, RG_HD).bfloat16()
    q_pos = torch.arange(RG_SQ, device=dev, dtype=torch.int32).expand(B, -1).contiguous()
    tol = "2e-3 + 1e-2 |want| (bf16); 1e-3 (fp32 inputs)"
    got = ops.flash_prefill(q, k, v, q_pos, scale, window=RG_WINDOW).float()
    far = lambda want: ((got - want).abs() > 2e-3 + 1e-2 * want.abs()).any().item()
    want = ref.flash_prefill_ref(q, k, v, q_pos, scale, RG_WINDOW).float()
    err = (got - want).abs().max().item()
    if far(want):
        fail(f"flash_prefill at head_dim 256 with a window differs from its plain version by "
             f"{err} ({tol})")
    edge = {}
    for w in (RG_WINDOW - 1, RG_WINDOW + 1):
        want = ref.flash_prefill_ref(q, k, v, q_pos, scale, w).float()
        edge[w] = (got - want).abs().max().item()
        if not far(want):
            fail(f"flash_prefill's limit ({tol}) cannot tell window {RG_WINDOW} from {w}")
    f32 = (q.float(), k.float(), v.float(), q_pos, scale, RG_WINDOW)
    err32 = (ops.flash_prefill(*f32[:5], window=RG_WINDOW) - ref.flash_prefill_ref(*f32)
             ).abs().max().item()
    if not err32 <= 1e-3:
        fail(f"flash_prefill at head_dim 256 with a window differs from its plain version in "
             f"fp32 by {err32} > 1e-3")
    j = torch.arange(RG_SQ, device=dev)
    band = (j[None, :] <= j[:, None]) & (j[None, :] > j[:, None] - RG_WINDOW)
    pairs = int(band.sum()) * B * RG_HQ
    del want, got, f32
    out.append({
        "name": "flash_prefill (head_dim 256, window 2048)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:114", "counter": "flash_prefill",
        "arches": [RG_ARCH],
        "shape": f"q ({B},{RG_HQ},{RG_SQ},{RG_HD}) bf16, k/v ({B},1,{RG_SQ},{RG_HD}), "
                 f"window {RG_WINDOW}",
        "library": "SDPA with a bool band mask",
        "ptxas": ptxas_row("flash_prefill", _mma(RG_HD, False, False)),
        "max_abs_err": err, "max_abs_err_fp32": err32, "tolerance": tol,
        "max_abs_err_against_window": edge,
        "ms": cold_ms(lambda: ops.flash_prefill(q, k, v, q_pos, scale, window=RG_WINDOW),
                      flush, iters=10),
        "plain_ms": cold_ms(lambda: ref.flash_prefill_ref(q, k, v, q_pos, scale, RG_WINDOW),
                            flush, iters=3, warmup=1),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=band, scale=scale, enable_gqa=True), flush, iters=10),
        **bound(2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * q_pos.numel(),
                4 * RG_HD * pairs, BF16_FLOPS),
    })
    return out


def stripe_inputs(dev, gen, sq: int, lo: int, hi: int, heads=(HQ, HKV, HD)):
    """q (B, hq, sq, hd) bf16, a (B, hkv, STRIPE, hd) slot cache, a shuffled
    row index and q_pos: row b's chunk starts at a draw from [lo, hi]
    (``heads`` = (hq, hkv, hd), yi-9b's by default)."""
    hq, hkv, hd = heads
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).bfloat16()
    q, k, v = rnd(B, hq, sq, hd), rnd(B, hkv, STRIPE, hd), rnd(B, hkv, STRIPE, hd)
    rows = torch.randperm(B, generator=gen, device=dev).to(torch.int32)
    starts = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev)
    q_pos = (starts[:, None] + torch.arange(sq, device=dev)[None, :]).to(torch.int32)
    return q, k, v, rows, q_pos.contiguous()


def stripe_stats(q, k, v, rows, q_pos, fn, plain, flush) -> dict:
    """Hold ``fn`` (a kernel wrapper taking rows=) against ``plain`` on the
    gathered stripes: bf16 per element to 2e-3 + 1e-2 |want| (one bf16 ulp
    is at most 7.8e-3 of a value), fp32 inputs to 1e-3; time both, SDPA
    with a bool causal mask over the stripes gathered beforehand (gather
    untimed), and bound the work (bytes: q, the output and the K/V rows the
    queries reach, each once; operations: ~4 hd per (query, head, key)
    pair at the bf16 peak)."""
    import torch.nn.functional as F

    hq, hkv, hd = q.shape[1], k.shape[1], k.shape[3]
    scale = hd ** -0.5
    kg, vg = k[rows.long()], v[rows.long()]
    got = fn(q, k, v, q_pos, scale, rows=rows).float()
    want = plain(q, kg, vg, q_pos, scale).float()
    err = (got - want).abs().max().item()
    tol = "2e-3 + 1e-2 |want| (bf16); 1e-3 (fp32 inputs)"
    if not ((got - want).abs() <= 2e-3 + 1e-2 * want.abs()).all():
        fail(f"{fn.__name__} over stripes differs from its plain version by {err} ({tol})")
    f32 = (q.float(), k.float(), v.float(), q_pos, scale)
    err32 = (fn(*f32, rows=rows) - plain(q.float(), kg.float(), vg.float(), q_pos, scale)
             ).abs().max().item()
    if not err32 <= 1e-3:
        fail(f"{fn.__name__} over stripes differs from its plain version in fp32 by {err32}")
    causal = torch.arange(STRIPE, device=q.device)[None, None, None, :] <= q_pos[:, None, :, None]
    used = int((q_pos.max(dim=1).values.long() + 1).sum())
    pairs = int((q_pos.long() + 1).sum()) * hq
    return {
        "max_abs_err": err, "max_abs_err_fp32": err32, "tolerance": tol,
        "ms": cold_ms(lambda: fn(q, k, v, q_pos, scale, rows=rows), flush),
        "plain_ms": cold_ms(lambda: plain(q, k[rows.long()], v[rows.long()], q_pos, scale),
                            flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=causal, scale=scale, enable_gqa=True), flush),
        **bound(2 * (2 * q.numel() + 2 * used * hkv * hd) + 4 * (rows.numel() + q_pos.numel()),
                4 * hd * pairs, BF16_FLOPS),
    }


def check_stripe_prefill(dev, flush) -> dict:
    """flash_prefill reading a 64-token chunk's slot stripes through the row
    index, as a chunk of chunked admission does."""
    from repro_torch.kernels import ops, ref

    q, k, v, rows, q_pos = stripe_inputs(dev, torch.Generator(device=dev).manual_seed(5),
                                         PREFILL_SQ, 64, 128)
    return {"shape": f"q ({B},{HQ},{PREFILL_SQ},{HD}) bf16 at offsets "
                     f"{q_pos[:, 0].tolist()}, slot cache ({B},{HKV},{STRIPE},{HD}) through "
                     f"rows {rows.tolist()}",
            "library": "SDPA with a bool causal mask over the stripes gathered beforehand "
                       "(gather untimed)",
            **stripe_stats(q, k, v, rows, q_pos, ops.flash_prefill, ref.flash_prefill_ref,
                           flush)}


def check_verify(dev, flush, heads=(HQ, HKV, HD)) -> dict:
    """flash_verify at the dense verify chunk of the spec phase, beside
    flash_prefill on the same inputs (the kernel it takes over from);
    ``heads`` = (hq, hkv, hd), yi-9b's by default."""
    from repro_torch.kernels import ops, ref

    hq, hkv, hd = heads
    q, k, v, rows, q_pos = stripe_inputs(dev, torch.Generator(device=dev).manual_seed(6),
                                         SPEC_K + 1, 93, STRIPE - 10, heads)
    stats = stripe_stats(q, k, v, rows, q_pos, ops.flash_verify, ref.flash_verify_ref, flush)
    return {"name": "flash_verify", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_verify.cu",
            "replaces": "src/repro/kernels/prefill_attention.py:179",
            "counter": "flash_verify",
            "shape": f"q ({B},{hq},{SPEC_K + 1},{hd}) bf16 at frontiers "
                     f"{q_pos[:, 0].tolist()}, slot cache ({B},{hkv},{STRIPE},{hd}) through "
                     f"rows {rows.tolist()}",
            "library": "SDPA with a bool causal mask over the stripes gathered beforehand "
                       "(gather untimed)",
            "ptxas": ptxas_row("flash_verify", _mma(hd, False, True)),
            **stats,
            "flash_prefill_ms": cold_ms(lambda: ops.flash_prefill(q, k, v, q_pos, hd ** -0.5,
                                                                  rows=rows), flush)}


def check_paged(dev, flush, heads=(HQ, HKV, HD)) -> list:
    """The paged kernels at yi-9b shapes (or ``heads`` = (hq, hkv, hd))
    against their plain versions.  The library yardstick is SDPA with a
    bool mask over the view gathered through the table beforehand (the
    gather is not timed)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    hq, hkv, hd = heads
    gen = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).bfloat16()
    scale = hd ** -0.5
    out = []

    # decode: each slot's 300 valid rows lie in its first 19 table entries;
    # the rest of its 32 entries are null, as in a live slot
    nb = B * DECODE_NBPS + 1
    kp, vp = rnd(nb, hkv, BLOCK, hd), rnd(nb, hkv, BLOCK, hd)
    q = rnd(B, hq, 1, hd)
    live = -(-DECODE_VALID // BLOCK)
    bt = (torch.randperm(nb - 1, generator=gen, device=dev)[:B * DECODE_NBPS] + 1)
    bt = bt.reshape(B, DECODE_NBPS).to(torch.int32)
    bt[:, live:] = 0
    bt = bt.contiguous()
    valid = (torch.arange(DECODE_NBPS * BLOCK, device=dev) < DECODE_VALID).expand(B, -1).contiguous()
    m, l, acc = ops.paged_decode_attention_partial(q, kp, vp, bt, valid, scale)
    m2, l2, acc2 = ref.paged_decode_attention_ref(q, kp, vp, bt, valid, scale)
    o, o2 = acc / l[..., None], acc2 / l2[..., None]
    err = max((o - o2).abs().max().item(), (m - m2).abs().max().item())
    l_rel = ((l - l2).abs() / l2).max().item()
    tol = 1e-3
    if not (err <= tol and l_rel <= 1e-4):
        fail(f"paged_decode_attention differs from its plain version: {err} (tol {tol}), "
             f"l relative {l_rel} (tol 1e-4)")
    kv, vv = ref.paged_view(kp, bt), ref.paged_view(vp, bt)
    mask = valid[:, None, None, :]
    out.append({
        "name": "paged_decode_attention_partial", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:184",
        "counter": "paged_decode_attention",
        "shape": f"q ({B},{hq},1,{hd}) bf16, pools ({nb},{hkv},{BLOCK},{hd}), shuffled table "
                 f"({B},{DECODE_NBPS}) with {DECODE_NBPS - live} null entries per slot, "
                 f"{DECODE_VALID} valid",
        "library": "SDPA with a bool mask over the view gathered beforehand (gather untimed)",
        "ptxas": ptxas_row("paged_decode_attention", _dec(hd, True)),
        "max_abs_err": err, "tolerance": tol,
        "ms": cold_ms(lambda: ops.paged_decode_attention_partial(q, kp, vp, bt, valid, scale),
                      flush),
        "plain_ms": cold_ms(lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, valid, scale),
                            flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, kv, vv, attn_mask=mask, scale=scale, enable_gqa=True), flush),
        # bytes: the K/V of the blocks that hold valid rows, each read once
        **bound(2 * (q.numel() + 2 * B * live * hkv * BLOCK * hd) + 4 * bt.numel()
                + valid.numel() + 4 * (m.numel() + l.numel() + acc.numel()),
                4 * hd * B * hq * DECODE_VALID, BF16_FLOPS),
    })

    # prefill of a suffix after a cached prefix, through shuffled tables
    nbps = PREFILL_VIEW // BLOCK
    nb = B * nbps + 1
    kp, vp = rnd(nb, hkv, BLOCK, hd), rnd(nb, hkv, BLOCK, hd)
    q = rnd(B, hq, PREFILL_SQ, hd)
    bt = (torch.randperm(nb - 1, generator=gen, device=dev)[:B * nbps] + 1)
    bt = bt.reshape(B, nbps).to(torch.int32).contiguous()
    starts = torch.randint(64, 129, (B,), generator=gen, device=dev)
    q_pos = (starts[:, None] + torch.arange(PREFILL_SQ, device=dev)[None, :]).to(torch.int32)
    # bf16 output: 2e-3 plus 1e-2 of |want| per element (one bf16 ulp is at
    # most 7.8e-3 of a value); fp32 inputs at the same shape: 1e-3
    got = ops.paged_flash_prefill(q, kp, vp, bt, q_pos, scale).float()
    want = ref.paged_flash_prefill_ref(q, kp, vp, bt, q_pos, scale).float()
    err = (got - want).abs().max().item()
    tol = "2e-3 + 1e-2 |want| (bf16); 1e-3 (fp32 inputs)"
    if not ((got - want).abs() <= 2e-3 + 1e-2 * want.abs()).all():
        fail(f"paged_flash_prefill differs from its plain version by {err} ({tol})")
    f32 = (q.float(), kp.float(), vp.float(), bt, q_pos, scale)
    err32 = (ops.paged_flash_prefill(*f32) - ref.paged_flash_prefill_ref(*f32)).abs().max().item()
    if not err32 <= 1e-3:
        fail(f"paged_flash_prefill differs from its plain version in fp32 by {err32} > 1e-3")
    kv, vv = ref.paged_view(kp, bt), ref.paged_view(vp, bt)
    causal = torch.arange(PREFILL_VIEW, device=dev)[None, None, None, :] <= q_pos[:, None, :, None]
    used = int((q_pos.max(dim=1).values.long() + 1).sum())      # view rows the queries reach
    pairs = int((q_pos.long() + 1).sum()) * hq
    out.append({
        "name": "paged_flash_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_flash_prefill.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:208",
        "counter": "paged_flash_prefill",
        "shape": f"q ({B},{hq},{PREFILL_SQ},{hd}) bf16 after prefixes {starts.tolist()}, pools "
                 f"({nb},{hkv},{BLOCK},{hd}), shuffled table ({B},{nbps})",
        "library": "SDPA with a bool causal mask over the view gathered beforehand "
                   "(gather untimed)",
        "ptxas": ptxas_row("paged_flash_prefill", _mma(hd, True, False)),
        "max_abs_err": err, "max_abs_err_fp32": err32, "tolerance": tol,
        "ms": cold_ms(lambda: ops.paged_flash_prefill(q, kp, vp, bt, q_pos, scale), flush),
        "plain_ms": cold_ms(lambda: ref.paged_flash_prefill_ref(q, kp, vp, bt, q_pos, scale),
                            flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, kv, vv, attn_mask=causal, scale=scale, enable_gqa=True), flush),
        **bound(2 * (2 * q.numel() + 2 * used * hkv * hd) + 4 * (bt.numel() + q_pos.numel()),
                4 * hd * pairs, BF16_FLOPS),
    })
    return out


# the int8 KV cache: qwen-72b's wave at 4 x ~2950 tokens of a 4096-token
# cache (64 MHA heads of 128)
QW_HQ, QW_S, QW_VALID = 64, 4096, 2950


def int8_decode_case(q, kq, ks, vq, vs, valid, scale, flush, bt=None) -> dict:
    """One int8 decode case, dense or (``bt``) paged: the int8 kernel bit for
    bit against the bf16 kernel on ``dequantize_kv`` of the same cache (m, l
    and acc), and against the plain version (dequantize, then the plain
    decode) to 1e-3 on the output and m and 1e-4 relative on l, as rows 4
    and 5 are held; the times of the int8 kernel, the bf16 kernel on the copy, the
    plain version and SDPA over the dequantized copy (the dequantization
    and, paged, the gather untimed; no PyTorch call reads int8), and the
    bound: q, the int8 values and bf16 scales of the valid rows, the mask,
    the table and the fp32 outputs, each once."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    kd, vd = ref.dequantize_kv(kq, ks), ref.dequantize_kv(vq, vs)
    if bt is None:
        call = lambda: ops.decode_attention_partial(q, kq, vq, valid, scale, k_scale=ks,
                                                    v_scale=vs)
        on_copy = lambda: ops.decode_attention_partial(q, kd, vd, valid, scale)
        plain = lambda: ref.decode_attention_ref(q, ref.dequantize_kv(kq, ks),
                                                 ref.dequantize_kv(vq, vs), valid, scale)
        kv, vv = kd, vd
    else:
        call = lambda: ops.paged_decode_attention_partial(q, kq, vq, bt, valid, scale,
                                                          k_scale=ks, v_scale=vs)
        on_copy = lambda: ops.paged_decode_attention_partial(q, kd, vd, bt, valid, scale)
        plain = lambda: ref.paged_decode_attention_ref(q, ref.dequantize_kv(kq, ks),
                                                       ref.dequantize_kv(vq, vs), bt, valid,
                                                       scale)
        kv, vv = ref.paged_view(kd, bt), ref.paged_view(vd, bt)
    got, want = call(), on_copy()
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want)):
        diff = max((a - b).nan_to_num().abs().max().item() for a, b in zip(got, want))
        fail(f"int8 decode ({'paged' if bt is not None else 'dense'}, q {tuple(q.shape)}) "
             f"differs from the bf16 kernel on the dequantized cache by {diff}")
    m, l, acc = got
    m2, l2, acc2 = plain()
    live = l2 > 0                                   # rows with a valid key
    err = max((acc / l[..., None] - acc2 / l2[..., None])[live].abs().max().item(),
              (m - m2)[live].abs().max().item())
    l_rel = ((l - l2)[live].abs() / l2[live]).max().item()
    tol = 1e-3
    if not (err <= tol and l_rel <= 1e-4 and torch.equal(live, l > 0)):
        fail(f"int8 decode ({'paged' if bt is not None else 'dense'}, q {tuple(q.shape)}) "
             f"differs from its plain version: {err} (tol {tol}), l relative {l_rel} "
             f"(tol 1e-4)")
    b, hq, _, hd = q.shape
    hkv = kq.shape[1]
    mask = valid[None, None, None, :] if valid.dim() == 1 else valid[:, None, None, :]
    n_valid = int(valid.sum()) * (b if valid.dim() == 1 else 1)     # (row, key) pairs
    return {
        "max_abs_err": err, "l_rel_err": l_rel,
        "tolerance": "bit for bit against the bf16 kernel on the dequantized cache; "
                     f"against the plain version {tol} on the output and m, 1e-4 relative "
                     "on l",
        "ms": cold_ms(call, flush), "bf16_kernel_on_copy_ms": cold_ms(on_copy, flush),
        "plain_ms": cold_ms(plain, flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, kv, vv, attn_mask=mask, scale=scale, enable_gqa=True), flush),
        **bound(2 * q.numel() + n_valid * hkv * (2 * hd + 4) + valid.numel()
                + (0 if bt is None else 4 * bt.numel())
                + 4 * (m.numel() + l.numel() + acc.numel()),
                4 * hd * hq * n_valid, BF16_FLOPS),
    }


def kvq_write_case(what, k, v, n, m, dst, flush, dequantized, null_block=False) -> dict:
    """kv_quant_write of fresh k, v into int8 caches (n, h, m, hd) at the
    targets ``dst``: values, scales and (``dequantized``) the dequantized
    fresh K/V bit for bit against the plain version (``null_block``: the
    null block 0, written by several tokens in no set order and never read
    as valid, is left out); the kernel's and the plain version's times; the
    bound: k and v read, the written tokens' values and scales (and the
    dequantized K/V) written, the targets read, once each."""
    from repro_torch.kernels import ops, ref

    b, h, s, hd = k.shape
    new = lambda: ([torch.zeros((n, h, m, hd), dtype=torch.int8, device=k.device)
                    for _ in range(2)]
                   + [torch.zeros((n, h, m), dtype=torch.bfloat16, device=k.device)
                      for _ in range(2)])
    got_c, want_c = new(), new()
    before = ops.LAUNCHES["kv_quant_write"]
    got = ops.kv_quant_write(k, v, *got_c, *dst, dequantized=dequantized)
    if ops.LAUNCHES["kv_quant_write"] != before + 1:
        fail("kv_quant_write made more than one launch in a call")
    want = ref.kv_quant_write_ref(k, v, *want_c, *dst)
    keep = slice(1, None) if null_block else slice(None)
    same = all(torch.equal(a[keep].view(torch.uint8), w[keep].view(torch.uint8))
               for a, w in zip(got_c[:2], want_c[:2]))
    same &= all(torch.equal(a[keep].view(torch.int16), w[keep].view(torch.int16))
                for a, w in zip(got_c[2:], want_c[2:]))
    if dequantized:
        same &= all(torch.equal(a.view(torch.int16), w.view(torch.int16))
                    for a, w in zip(got, want))
    if not same:
        fail(f"kv_quant_write ({what}) differs from its plain version")
    written = int((dst[0] >= 0).sum()) * h
    n_bytes = (2 * 2 * k.numel() + 2 * written * (hd + 2) + 8 * b * s
               + (2 * 2 * k.numel() if dequantized else 0))
    return {"case": what, "shape": f"k/v ({b},{h},{s},{hd}) bf16 -> ({n},{h},{m},{hd}) int8, "
                                   f"{written // h} tokens written",
            "max_abs_err": 0.0, "tolerance": "bit for bit against the plain version",
            "ms": cold_ms(lambda: ops.kv_quant_write(k, v, *got_c, *dst,
                                                     dequantized=dequantized), flush),
            "plain_ms": cold_ms(lambda: ref.kv_quant_write_ref(k, v, *want_c, *dst), flush),
            "library_ms": None, **bound(n_bytes, 5 * 2 * k.numel(), FP32_FLOPS)}


def check_int8_kernels(dev, flush) -> list:
    """The int8 KV cache's kernels: the decode kernels' int8 load path at
    yi-9b's rows 4 and 5 shapes, at head_dim 256 (row 4b's recurrentgemma
    ring; row 5b's gptj-parallel pools) and at qwen-72b's (4, 64, 1, 128)
    over a 4096-entry cache with 2950 valid rows, dense and paged; and
    kv_quant_write in the wave's, a ring's and the slots' and pools'
    layouts at the serving paths' shapes."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn

    gen = torch.Generator(device=dev).manual_seed(9)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    kv8 = lambda *shape: ref.quantize_kv(rnd(*shape).bfloat16())
    out = []

    def dense(hq, hkv, S, hd, valid):
        q = rnd(B, hq, 1, hd).bfloat16()
        (kq, ks), (vq, vs) = kv8(B, hkv, S, hd), kv8(B, hkv, S, hd)
        return q, kq, ks, vq, vs, valid

    idx = torch.arange(RG_WINDOW, device=dev)
    frontiers = [2300, 2047, 1500, 3000]
    cases = {
        "yi-9b": dense(HQ, HKV, DECODE_S, HD, torch.arange(DECODE_S, device=dev) < DECODE_VALID),
        "qwen-72b": dense(QW_HQ, QW_HQ, QW_S, HD, torch.arange(QW_S, device=dev) < QW_VALID),
        RG_ARCH: dense(RG_HQ, 1, RG_WINDOW, RG_HD,
                       torch.stack([(f - (f - idx) % RG_WINDOW >= 0) for f in frontiers])),
    }
    shapes = {"yi-9b": f"q ({B},{HQ},1,{HD}) bf16, k/v ({B},{HKV},{DECODE_S},{HD}) int8, "
                       f"{DECODE_VALID} valid",
              "qwen-72b": f"q ({B},{QW_HQ},1,{HD}) bf16, k/v ({B},{QW_HQ},{QW_S},{HD}) int8, "
                          f"{QW_VALID} valid",
              RG_ARCH: f"q ({B},{RG_HQ},1,{RG_HD}) bf16, k/v ({B},1,{RG_WINDOW},{RG_HD}) int8 "
                       f"ring, per-row window masks at positions {frontiers}"}
    for arch, case in cases.items():
        hd = case[0].shape[-1]
        out.append({
            "name": "decode_attention_partial (int8)" + ("" if arch == "yi-9b" else f", {arch}"),
            "route": "cuda", "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:66",
            "counter": "decode_attention_int8", "arches": [arch], "shape": shapes[arch],
            "library": "SDPA with a bool mask over the dequantized cache (dequantization "
                       "untimed)",
            "ptxas": ptxas_row("decode_attention", _dec(hd, False, True)),
            **int8_decode_case(*case, hd ** -0.5, flush)})
        del case
    del cases

    # paged: each slot's valid rows in its first table entries, the rest null
    paged = []
    for what, hq, hkv, hd, nbps, n_valid in (("yi-9b", HQ, HKV, HD, DECODE_NBPS, DECODE_VALID),
                                             (GJ_ARCH, GJ_H, GJ_H, GJ_HD, DECODE_NBPS,
                                              DECODE_VALID),
                                             ("qwen-72b", QW_HQ, QW_HQ, HD, QW_S // BLOCK,
                                              QW_VALID)):
        nb = B * nbps + 1
        (kq, ks), (vq, vs) = kv8(nb, hkv, BLOCK, hd), kv8(nb, hkv, BLOCK, hd)
        q = rnd(B, hq, 1, hd).bfloat16()
        live = -(-n_valid // BLOCK)
        bt = (torch.randperm(nb - 1, generator=gen, device=dev)[:B * nbps] + 1)
        bt = bt.reshape(B, nbps).to(torch.int32)
        bt[:, live:] = 0
        bt = bt.contiguous()
        valid = (torch.arange(nbps * BLOCK, device=dev) < n_valid).expand(B, -1).contiguous()
        paged.append({"case": what, "shape": f"q ({B},{hq},1,{hd}) bf16, pools ({nb},{hkv},"
                                             f"{BLOCK},{hd}) int8, shuffled table ({B},{nbps}),"
                                             f" {n_valid} valid",
                      "ptxas": ptxas_row("paged_decode_attention", _dec(hd, True, True)),
                      **int8_decode_case(q, kq, ks, vq, vs, valid, hd ** -0.5, flush, bt=bt)})
        del kq, ks, vq, vs
    out.append({"name": "paged_decode_attention_partial (int8)", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:184",
                "counter": "paged_decode_attention_int8", "arches": ["yi-9b"],
                "library": "SDPA with a bool mask over the dequantized view gathered "
                           "beforehand (dequantization and gather untimed)",
                **{k: v for k, v in paged[0].items() if k != "case"},
                "head_dim_256": paged[1], "qwen_72b": paged[2]})

    # kv_quant_write: K/V as a layer makes them (transposed views of (b, s, h, hd))
    fresh = lambda b, s, h, hd: tuple(rnd(b, s, h, hd).bfloat16().transpose(1, 2)
                                      for _ in range(2))
    writes = []
    k, v = fresh(B, 1, QW_HQ, HD)
    writes.append(kvq_write_case("qwen-72b decode step, wave cache", k, v, B, QW_S,
                                 attn.quant_targets(B, 1, dev, wave_pos=QW_VALID), flush, False))
    k, v = fresh(B, QW_VALID, QW_HQ, HD)
    writes.append(kvq_write_case("qwen-72b wave prefill", k, v, B, QW_S,
                                 attn.quant_targets(B, QW_VALID, dev, wave_pos=0), flush, True))
    k, v = fresh(B, RG_SQ, 1, RG_HD)
    ring = torch.arange(RG_SQ - RG_WINDOW, RG_SQ, device=dev) % RG_WINDOW
    writes.append(kvq_write_case("recurrentgemma-9b wave prefill into its ring", k, v, B,
                                 RG_WINDOW, attn.quant_targets(B, RG_SQ, dev, ring_idx=ring),
                                 flush, True))
    k, v = fresh(B, 1, HKV, HD)
    rows = torch.tensor([0, 2, 3], device=dev)
    writes.append(kvq_write_case(
        "yi-9b slot decode, three of four rows", k, v, SLOTS, SERVE_MAX_LEN,
        attn.quant_targets(B, 1, dev, targets=(rows, torch.tensor([70, 5, 130], device=dev)),
                           src=rows), flush, False))
    nbps = SERVE_MAX_LEN // BLOCK
    k, v = fresh(B, PREFILL_SQ, HKV, HD)
    bt = (torch.randperm(B * nbps, generator=gen, device=dev) + 1).reshape(B, nbps)
    bt[-1, -2:] = 0                                       # past the table: the null block
    starts = torch.tensor([64, 80, 100, 200], device=dev)
    phys, off = attn.paged_flat_targets(bt, starts, PREFILL_SQ, BLOCK)
    writes.append(kvq_write_case("yi-9b paged chunk of 64", k, v, B * nbps + 1, BLOCK,
                                 attn.quant_targets(B, PREFILL_SQ, dev, targets=(phys, off)),
                                 flush, False, null_block=True))
    del k, v
    head = writes[0]
    out.append({"name": "kv_quant_write", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/kv_quant_write.cu",
                "replaces": "src/repro/models/attention.py:156",
                "replaces_what": "no Pallas kernel: _quantize_kv and the cache writes in jnp",
                "counter": "kv_quant_write", "arches": ["yi-9b", "qwen-72b", RG_ARCH],
                "library": "none: no single PyTorch call quantizes and scatters",
                "ptxas": ptxas_row("kv_quant_write", "kvq6kernelILi128E"),
                **{k: head[k] for k in ("shape", "max_abs_err", "tolerance", "ms", "plain_ms",
                                        "library_ms", "bound_ms", "bound_by")},
                "cases": writes})
    return out


def check_dequant(dev, flush, cases=DQ_CASES, name: str = "dequant_matmul") -> dict:
    """dequant_matmul at ``cases`` (DQ_CASES'), the row ``name``.  Tolerance: 1e-4 of the
    largest |output| for sums over K <= 24576 in another order (every
    product is exact in fp32), plus, for a bf16 output, one bf16 ulp (the
    spacing of bf16 values) at the plain version's fp32 value."""
    from repro_torch.core import wquant
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for what, mode, T, K, N, out_dtype in cases:
        w_dense = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).bfloat16()
        w = wquant.quantize(w_dense, mode, 128)
        x = torch.randn((T, K), generator=gen, device=dev).bfloat16()
        got = ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group, out_dtype=out_dtype)
        want = ref.dequant_matmul_ref(x, w.q, w.scale, mode, w.group)
        err = (got.float() - want).abs().max().item()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        if out_dtype == torch.float32:
            ok = err <= tol
        else:
            ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
            ok = bool(((got.float() - want).abs() <= ulp + tol).all())
            tol = f"one bf16 ulp + {tol}"
        if not ok:
            fail(f"dequant_matmul {what} differs from its plain version by {err} (tol {tol})")
        w_dense = wquant.dequantize(w)    # the bf16 weight the quantized one replaces
        n_bytes = (2 * x.numel() + w.q.numel() + 2 * w.scale.numel()
                   + got.element_size() * got.numel())
        rows.append({
            "case": what, "shape": f"x ({T},{K}) bf16 @ {mode} ({K},{N}) g{w.group} -> {out_dtype}",
            "max_abs_err": err, "tolerance": tol,
            "ptxas": ptxas_row("dequant_matmul", _gemm(mode, T)),
            "ms": cold_ms(lambda: ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group,
                                                     out_dtype=out_dtype), flush),
            "plain_ms": cold_ms(lambda: ref.dequant_matmul_ref(x, w.q, w.scale, mode, w.group),
                                flush),
            "library_ms": cold_ms(lambda: torch.matmul(x, w_dense), flush),
            **bound(n_bytes, 2 * T * K * N, BF16_FLOPS),
        })
        del w_dense, w, x, got, want
    head = rows[0]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "src/repro/kernels/wquant_matmul.py:84",
            "counter": "dequant_matmul",
            "library": "torch.matmul on the dense bf16 weight (cuBLAS; not a dequant)",
            **{k: head[k] for k in ("shape", "max_abs_err", "tolerance", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")},
            "cases": rows}


def to_device(params: dict, dev) -> dict:
    """The port's params (QuantWeight leaves and an RG-LRU layer's ``mixer``
    dict included) copied to ``dev``."""
    from repro_torch.core.wquant import map_tensors

    def mv(t):
        if isinstance(t, dict):
            return {k: mv(v) for k, v in t.items()}
        if isinstance(t, list):
            return [mv(v) for v in t]
        return map_tensors(t, lambda a: a.to(dev))
    return mv(params)


# logits of the small GQA model, card against CPU: fp32 logits of magnitude
# ~1, as the port's CPU tests hold it against the JAX package (bf16
# activations rounded after differently ordered sums)
REF_TOL = 5e-2


def small_gqa(dev, weight_quant: str = "none"):
    """The reference checks' model: reduced yi-9b with 8 q heads over 2 KV
    heads of head_dim 128, random weights from seed 1 -> (cfg, CPU params,
    the same params on ``dev``)."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("yi-9b").reduced(), n_heads=8, n_kv_heads=2,
                              head_dim=128)
    cpu = M.init_params(cfg, ParallelConfig(weight_quant=weight_quant), seed=1, device="cpu")
    return cfg, cpu, to_device(cpu, dev)


def reference_check(dev, weight_quant: str = "none", kv_quant: bool = False) -> dict:
    """The small GQA model on the card against the same weights on the CPU,
    where the plain versions run: prefill logits and 8 teacher-forced
    decode steps, within REF_TOL; ``kv_quant``: over the int8 KV cache."""
    cfg, cpu, gpu = small_gqa(dev, weight_quant)
    worst = teacher_forced_worst(cfg, cpu, gpu, dev, kv_quant)
    if not worst <= REF_TOL:
        fail(f"{weight_quant} kv_quant={kv_quant}: card logits differ from the CPU's by "
             f"{worst} > {REF_TOL}")
    return {"config": cfg.name + "-gqa-hd128", "weight_quant": weight_quant,
            "kv_quant": kv_quant, "max_abs_logit_err": worst, "tolerance": REF_TOL}


def teacher_forced_worst(cfg, cpu, gpu, dev, kv_quant: bool = False) -> float:
    """The largest |card - CPU| over the logits of a 3 x 20-token prefill
    and 8 decode steps fed the CPU's greedy tokens; fails on non-finite
    card logits."""
    return teacher_forced(cfg, cpu, gpu, dev, kv_quant)[0]


def teacher_forced(cfg, cpu, gpu, dev, kv_quant: bool = False):
    """``teacher_forced_worst`` -> (the largest |card - CPU|, the caches
    after the steps, by device)."""
    from repro_torch.models import model as M

    b, plen, max_len = 3, 20, 128
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, plen)))
    caches = {d: M.init_caches(cfg, b, max_len, device=d, kv_quant=kv_quant)
              for d in ("cpu", dev)}
    worst = 0.0
    with torch.inference_mode():
        lc = M.forward(cpu, tokens, cfg, caches=caches["cpu"])
        lg = M.forward(gpu, tokens.to(dev), cfg, caches=caches[dev]).cpu()
        worst = max(worst, (lc - lg).abs().max().item())
        tok = lc[:, -1].argmax(-1)
        for cur in range(plen, plen + 8):
            lc = M.forward(cpu, tok[:, None], cfg, caches=caches["cpu"], cur_pos=cur)
            lg = M.forward(gpu, tok[:, None].to(dev), cfg, caches=caches[dev],
                           cur_pos=cur).cpu()
            worst = max(worst, (lc - lg).abs().max().item())
            tok = lc[:, -1].argmax(-1)
    if not torch.isfinite(lg).all():
        fail(f"{cfg.name}: non-finite card logits")
    return worst, caches


@contextlib.contextmanager
def sampled_logits(log: list):
    """Record, on the host, every logits batch the slot engine samples from."""
    from repro_torch.runtime import engine as E

    sample = E.sample_tokens

    def record(logits, *args):
        log.append(logits.float().cpu())
        return sample(logits, *args)
    E.sample_tokens = record
    try:
        yield
    finally:
        E.sample_tokens = sample


def slot_reference_check(dev, kv_quant: bool = False) -> dict:
    """The slot engine's chunked-admission and verify steps on the card
    against the same calls on the CPU, on the small GQA model.

    Slots 0 and 1 hold prompts of 20 and 33 tokens; ``Engine.mixed_step``
    admits a 40-token prompt into slot 2 in chunks of 16 (the stripe
    flash_prefill through the row index) while slots 0 and 1 decode beside
    it (decode_attention).  Then ``Engine.verify_slots`` runs SPEC_K-draft
    verify steps (flash_verify), the first over all three slots, the
    others over slots 0 and 2 once slot 1's budget is spent; their drafts
    are the CPU's own plain continuation with one wrong token
    planted at a place that moves with the step and the slot: drafts are
    accepted up to it, the rest rejected and the slot rewound, or all are
    accepted.  Both engines get the same inputs and keep their own state.
    Every logits row sampled for a slot whose history is still the same on
    both is compared within REF_TOL (a verify step's rows past the first
    rejection too), and so is its position row after each verify step; a
    slot whose greedy tokens part (possible only where the CPU's top-2
    logits lie within 2 x REF_TOL) is compared no further.  Fails unless
    it compared mixed steps with a decode half, verify rows that accepted
    some but not all of their drafts, and verify rows computed at another
    batch row than their slot's.  ``kv_quant``: over the int8 KV cache."""
    import copy

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.runtime.engine import Engine

    cfg, cpu, gpu = small_gqa(dev)
    S, C, nslot = 128, 16, 3
    eng = {d: Engine(cfg, parallel=ParallelConfig(kv_quant=kv_quant), params=p,
                     sampling=SamplingConfig(top_k=1), max_len=S, device=where)
           for d, p, where in (("cpu", cpu, "cpu"), ("card", gpu, dev))}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (20, 33, 40)]
    toks = np.zeros((nslot, 33), np.int32)
    for i in (0, 1):
        toks[i, :len(prompts[i])] = prompts[i]
    admit, plens = np.array([True, True, False]), np.array([20, 33, 1])
    caches, state = {}, {}
    for d, e in eng.items():
        caches[d] = e.init_slot_caches(nslot)
        first = e.prefill_into_slots(caches[d], toks, admit, plens)
        # slot 2 rides the decode half frozen, at a stale index inside its
        # chunk; slot 1's budget ends in the first verify step, so that the
        # later ones compute slots 0 and 2 only (rows that are not 0..b-1)
        state[d] = dict(tok=first, pos=np.array([20, 33, 5], np.int32),
                        done=np.array([False, False, True]),
                        remaining=np.array([40, 5, 0], np.int32),
                        eos=np.full(nslot, -1, np.int32))
    live = np.ones(nslot, bool)
    worst, parted = 0.0, []
    seen = {"mixed_decode_halves": 0, "verify_rows": 0, "row_mapped": 0, "partly_accepted": 0,
            "all_rejected": 0, "all_accepted": 0}

    def call(fn):
        """fn(device) on both engines -> ({device: result}, {device: logits})."""
        out, logs = {}, {}
        for d in eng:
            logs[d] = []
            with sampled_logits(logs[d]):
                out[d] = fn(d)
        return out, logs

    def compare(a, b):
        nonlocal worst
        worst = max(worst, (a - b).abs().max().item())

    def part(i, a, b, where):
        """Slot i, whose tokens were ``a`` on the CPU and ``b`` on the card,
        is compared no further if they differ."""
        if live[i] and not np.array_equal(a, b):
            live[i] = False
            parted.append({"slot": int(i), "at": where})

    with torch.inference_mode():
        n2 = len(prompts[2])
        for off in range(0, n2, C):
            nc = min(C, n2 - off)
            ctok = np.zeros((nslot, C), np.int32)
            ctok[2, :nc] = prompts[2][off:off + nc]
            active = np.flatnonzero(~state["cpu"]["done"] & live)
            out, logs = call(lambda d: eng[d].mixed_step(
                caches[d], ctok, np.array([False, False, True]), np.array([1, 1, nc]),
                np.array([0, 0, off]), np.array([1, 1, off + nc]), **state[d]))
            compare(logs["cpu"][0], logs["card"][0])            # the chunk's last row
            if out["cpu"][5] and out["card"][5]:                 # both ran the decode half
                compare(logs["cpu"][1][active], logs["card"][1][active])
                seen["mixed_decode_halves"] += 1
            for i in active:
                part(i, out["cpu"][1][i], out["card"][1][i], f"mixed step at chunk {off}")
            if off + nc == n2:
                part(2, out["cpu"][0][2], out["card"][0][2], "first token")
            for d in eng:
                ptok, nxt, pos, done, rem, _ = out[d]
                state[d].update(tok=nxt, pos=pos, done=done, remaining=rem)
                if off + nc == n2:                           # slot 2 starts decoding
                    state[d]["tok"][2], state[d]["pos"][2] = ptok[2], n2
                    state[d]["done"][2], state[d]["remaining"][2] = False, 40
        k1 = SPEC_K + 1
        for step in range(4):
            act = {d: np.flatnonzero(~state[d]["done"] & (state[d]["remaining"] > 0))
                   for d in eng}
            if not act["cpu"].size:
                break
            plain, *_ = eng["cpu"].decode_slots(copy.deepcopy(caches["cpu"]), **state["cpu"],
                                                n=SPEC_K)
            drafts = plain.T.copy()                          # (slot, SPEC_K)
            for i in range(nslot):
                w = (step + 2 * i) % k1                      # w == SPEC_K: all right
                if w < SPEC_K:
                    drafts[i, w] = (drafts[i, w] + 1) % cfg.vocab_size
            out, logs = call(lambda d: eng[d].verify_slots(
                caches[d], np.concatenate([state[d]["tok"][:, None], drafts], axis=1),
                state[d]["pos"], state[d]["done"], state[d]["remaining"], state[d]["eos"]))
            for i in act["cpu"][live[act["cpu"]]]:   # live: active on both, same inputs
                r = {d: int(np.searchsorted(act[d], i)) for d in eng}
                compare(logs["cpu"][0][r["cpu"] * k1:(r["cpu"] + 1) * k1],
                        logs["card"][0][r["card"] * k1:(r["card"] + 1) * k1])
                tg, ne = out["cpu"][0][i], out["cpu"][1][i]
                acc = int(np.cumprod(drafts[i] == tg[:-1]).sum())
                seen["verify_rows"] += 1
                seen["row_mapped"] += int(r["cpu"] != i)
                seen["all_rejected" if acc == 0 else "all_accepted" if acc == SPEC_K
                     else "partly_accepted"] += 1
                part(i, tg[:ne], out["card"][0][i][:out["card"][1][i]], f"verify {step}")
                if live[i] and not torch.equal(caches["cpu"]["pos"][i],
                                               caches["card"]["pos"][i].cpu()):
                    fail(f"slot reference: slot {i}'s position row differs after verify {step}")
            for d in eng:
                _, _, nxt, pos, done, rem = out[d]
                state[d].update(tok=nxt, pos=pos, done=done, remaining=rem)
    if not worst <= REF_TOL:
        fail(f"slot reference: card logits differ from the CPU's by {worst} > {REF_TOL}")
    if not (seen["mixed_decode_halves"] and seen["partly_accepted"] and seen["row_mapped"]):
        fail(f"slot reference: no mixed decode half, partly accepted verify row or "
             f"verify over a row map compared: {seen}, parted {parted}")
    return {"config": cfg.name + "-gqa-hd128", "calls": "mixed_step, verify_slots",
            "kv_quant": kv_quant, "max_abs_logit_err": worst, "tolerance": REF_TOL,
            "compared": seen, "parted": parted}


# the small hybrid, card against CPU: five bf16 layers over 80 tokens carry
# more rounding to the logits than the two-layer checks above.  On an H100
# the sound check reads 6.6e-2; with one fault planted on the card's side
# (K/V ring writes clamped instead of wrapped, the prefill window dropped or
# one key narrower or wider, admission leaving h/conv unreset) it reads
# 0.29-1.55.  The limit lies between, with half the sound reading to spare.
HYBRID_TOL = 0.1


def small_hybrid(dev, weight_quant: str = "none"):
    """The hybrid reference checks' model: recurrentgemma-9b's pattern over
    5 layers (R, R, A, R, R: a period group and two singles), d 512, 2 q
    heads over 1 KV head of head_dim 256, window 64, d_ff 1024, vocab 512;
    random weights from seed 1 -> (cfg, CPU params, the same on ``dev``)."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(RG_ARCH).reduced(), n_layers=5, d_model=512, n_heads=2,
                              n_kv_heads=1, head_dim=256, d_ff=1024)
    cpu = M.init_params(cfg, ParallelConfig(weight_quant=weight_quant), seed=1, device="cpu")
    return cfg, cpu, to_device(cpu, dev)


def hybrid_reference_check(dev, weight_quant: str = "none", kv_quant: bool = False) -> dict:
    """The small hybrid on the card (kernels) against the same model on the
    CPU (plain versions), in bf16 or with int8 weights and the int8 KV
    cache: every logits row and the recurrent state (h, conv), within
    HYBRID_TOL.

    Wave: 3 prompts of 80 tokens into a 64-entry ring (the prefill keeps the
    last 64), then 24 teacher-forced decode steps, positions 80-103 at
    p % 64.  Slot engine: 3 slots first hold prompts of 50, 12 and 33
    tokens for 4 decode steps; then prompts of 23, 41 and 60 tokens are
    admitted into the same slots (right-padded to 64, so the length mask
    keeps the pads out of the state, and the admission must zero what the
    slots held) and decoded for 24 teacher-forced steps at per-slot
    positions, past 64 for two of them.  This is what shows that the
    card's path reads the right ring rows and resets its state: random
    full-width weights repeat one token, so the serve phases' token checks
    cannot.  A fault shared by both devices (the model's code runs on
    both) is the CPU tests' to find, against the JAX package."""
    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine

    cfg, cpu, gpu = small_hybrid(dev, weight_quant)
    parallel = ParallelConfig(weight_quant=weight_quant, kv_quant=kv_quant)
    steps = 24
    worst = {"wave_logits": 0.0, "slot_logits": 0.0, "h": 0.0, "conv": 0.0}

    def cmp(key, a, b):
        a, b = a.float().cpu(), b.float().cpu()
        if not torch.isfinite(b).all():
            fail(f"hybrid reference: non-finite {key} on the card")
        worst[key] = max(worst[key], (a - b).abs().max().item())

    def state(c_cpu, c_card):
        cmp("h", c_cpu["h"], c_card["h"])
        cmp("conv", c_cpu["conv"], c_card["conv"])

    rng = np.random.default_rng(4)
    with torch.inference_mode():
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 80)))
        caches = {d: M.init_caches(cfg, 3, 128, device=d, kv_quant=kv_quant)
                  for d in ("cpu", dev)}
        lc = M.forward(cpu, tokens, cfg, caches=caches["cpu"])
        cmp("wave_logits", lc, M.forward(gpu, tokens.to(dev), cfg, caches=caches[dev]))
        for cur in range(80, 80 + steps):
            tok = lc[:, -1].argmax(-1)[:, None]
            lc = M.forward(cpu, tok, cfg, caches=caches["cpu"], cur_pos=cur)
            cmp("wave_logits", lc, M.forward(gpu, tok.to(dev), cfg, caches=caches[dev],
                                             cur_pos=cur))
        state(caches["cpu"], caches[dev])
        ring = caches["cpu"]["pos"]
        if not torch.equal(ring, caches[dev]["pos"].cpu()):
            fail("hybrid reference: wave ring positions differ")
        if not (ring.numel() == cfg.window and int(ring.min()) == 80 + steps - cfg.window):
            fail(f"hybrid reference: the wave ring did not wrap as expected: {ring.tolist()}")

        eng = {d: Engine(cfg, parallel=parallel, params=p, sampling=SamplingConfig(top_k=1),
                         max_len=128, device=where)
               for d, p, where in (("cpu", cpu, "cpu"), ("card", gpu, dev))}
        caches = {d: e.init_slot_caches(3) for d, e in eng.items()}
        for plens, n in ((np.array([50, 12, 33]), 4), (np.array([23, 41, 60]), steps)):
            prompts = np.zeros((3, 64), np.int32)
            for i, plen in enumerate(plens):
                prompts[i, :plen] = rng.integers(0, cfg.vocab_size, plen)
            logs = {}
            for d, e in eng.items():
                logs[d] = []
                with sampled_logits(logs[d]):
                    e.prefill_into_slots(caches[d], prompts, np.ones(3, bool), plens)
            cmp("slot_logits", logs["cpu"][0], logs["card"][0])
            state(caches["cpu"], caches["card"])
            tok, pos = logs["cpu"][0].argmax(-1), torch.from_numpy(plens)
            for _ in range(n):
                lc = M.forward(cpu, tok[:, None], cfg, caches=caches["cpu"], cur_pos=pos)
                cmp("slot_logits", lc, M.forward(gpu, tok[:, None].to(dev), cfg,
                                                 caches=caches["card"], cur_pos=pos.to(dev)))
                tok, pos = lc[:, -1].argmax(-1), pos + 1
            state(caches["cpu"], caches["card"])
            if not torch.equal(caches["cpu"]["pos"], caches["card"]["pos"].cpu()):
                fail("hybrid reference: slot ring positions differ")
    if not max(worst.values()) <= HYBRID_TOL:
        fail(f"hybrid reference: card differs from the CPU by {worst} > {HYBRID_TOL}")
    return {"config": cfg.name + "-5layer-d512-hd256", "layers": "R,R,A,R,R",
            "weight_quant": weight_quant, "kv_quant": kv_quant,
            "window": cfg.window, "max_abs_err": worst, "tolerance": HYBRID_TOL,
            "slot_positions_past_window": int((plens + steps - 1 >= cfg.window).sum())}


def small_parallel(dev):
    """The parallel-residual reference checks' model: gptj-parallel's layer
    over 3 layers at d 512, 2 MHA heads of head_dim 256, d_ff 1024, vocab
    512; random weights from seed 1 -> (cfg, CPU params, the same on
    ``dev``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(GJ_ARCH).reduced(), n_layers=3, d_model=512, n_heads=2,
                              n_kv_heads=2, head_dim=256, d_ff=1024)
    cpu = M.init_params(cfg, seed=1, device="cpu")
    return cfg, cpu, to_device(cpu, dev)


def sequential_on_card(real):
    """A sub-layer that is ``real`` on the CPU and, on the card, the planted
    fault: a sequential residual whose FFN reads the norm of x + attention
    (with norm1's gamma: a parallel-residual layer has no norm2)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.common import rms_norm
    from repro_torch.models.mlp import mlp_forward

    def sublayer(p, x, cfg, kind="attn", index=0, *, rope, step, length_mask=None, policy):
        if x.device.type != "cuda":
            return real(p, x, cfg, kind, index, rope=rope, step=step, length_mask=length_mask,
                        policy=policy)
        x = x + attn.gqa_forward(p, rms_norm(x, p["norm1"], cfg.rms_eps), cfg, rope=rope,
                                 step=step, layer=index)
        return x + mlp_forward(p, rms_norm(x, p["norm1"], cfg.rms_eps), cfg)
    return sublayer


@contextlib.contextmanager
def plain_on_card():
    """Every kernel wrapper runs its plain version, as it does on CPU
    tensors, on the card's tensors too (and counts no launch)."""
    from repro_torch.kernels import ops

    device_of = ops._device_of
    ops._device_of = lambda *tensors: "cpu"
    try:
        yield
    finally:
        ops._device_of = device_of


def forced_scheduler_check(cfg, cpu, gpu, dev, make, reqs) -> dict:
    """One scheduler over the CPU engine and then over the card's, on the
    same requests; the card's sampling is handed the CPU's tokens, so both
    take the same decisions (admissions, chunks, accepted drafts) and every
    logits batch the card samples from is computed on the inputs of the
    CPU's.  -> the largest |card - CPU| over every live row, and the CPU
    run's stats.  A row is live unless a masked decode step freezes it
    (done, or no budget left): a frozen row's logits are discarded, and a
    paged slot frozen mid-admission may read the null block, whose
    contents depend on the order of duplicate writes."""
    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.runtime import engine as E
    from repro_torch.runtime.engine import Engine

    sample, decode_step = E.sample_tokens, Engine._decode_step
    logs, toks, stats = {"cpu": [], "card": []}, [], {}
    live, pending = [], []

    def step(self, caches, tok, pos, done, rem, *args, **kw):
        pending.append((~done & (rem > 0)).cpu())
        return decode_step(self, caches, tok, pos, done, rem, *args, **kw)

    def on_cpu(logits, *args):
        t = sample(logits, *args)
        logs["cpu"].append(logits.float().cpu())
        toks.append(t.cpu())
        live.append(pending.pop() if pending else torch.ones(len(t), dtype=torch.bool))
        return t

    def on_card(logits, *args):
        i = len(logs["card"])
        logs["card"].append(logits.float().cpu())
        pending.clear()
        if i >= len(toks) or toks[i].shape[0] != logits.shape[0]:
            fail(f"{cfg.name}: the card's schedule parts from the CPU's at sampling call {i}")
        return toks[i].to(logits.device)

    for d, p, where, fn in (("cpu", cpu, "cpu", on_cpu), ("card", gpu, dev, on_card)):
        eng = Engine(cfg, parallel=ParallelConfig(kv_block_size=8), params=p,
                     sampling=SamplingConfig(top_k=1), max_len=128, device=where)
        sched = make(eng)
        for i, (prompt, m) in enumerate(reqs):
            sched.submit(prompt, max_new=m, arrival_step=2 * i)
        E.sample_tokens, Engine._decode_step = fn, step
        try:
            sched.run()
        finally:
            E.sample_tokens, Engine._decode_step = sample, decode_step
        stats[d] = dict(getattr(sched, "stats", {}))
    if len(logs["card"]) != len(logs["cpu"]):
        fail(f"{cfg.name}: {len(logs['card'])} sampling calls on the card, "
             f"{len(logs['cpu'])} on the CPU")
    worst = 0.0
    for a, b, m in zip(logs["cpu"], logs["card"], live):
        if not m.any():        # a step of a block after every row finished
            continue
        if not torch.isfinite(b[m]).all():
            fail(f"{cfg.name}: non-finite card logits")
        worst = max(worst, (a[m] - b[m]).abs().max().item())
    return {"sampling_calls": len(logs["cpu"]), "rows": int(sum(m.sum() for m in live)),
            "max_abs_logit_err": worst, "stats": stats["cpu"]}


def parallel_reference_check(dev) -> dict:
    """The small parallel-residual model (head_dim 256) on the card against
    the same weights on the CPU, every logits row within REF_TOL: a
    teacher-forced prefill and 8 decode steps, then the schedulers -- a
    wave, the dense slot engine admitting in chunks of 16 with spec decode
    (SPEC_K n-gram drafts), and the paged pool behind a shared 16-token
    prompt, admitting whole prompts and in chunks with spec decode -- with
    the card handed the CPU's tokens (``forced_scheduler_check``).  The
    planted fault (a sequential residual on the card) must exceed the
    limit."""
    from repro_torch.models import transformer
    from repro_torch.runtime.scheduler import (ContinuousScheduler, PagedContinuousScheduler,
                                               WaveScheduler)

    cfg, cpu, gpu = small_parallel(dev)
    worst = {"forward": teacher_forced_worst(cfg, cpu, gpu, dev)}
    real = transformer.sublayer_forward
    transformer.sublayer_forward = sequential_on_card(real)
    try:
        fault = teacher_forced_worst(cfg, cpu, gpu, dev)
    finally:
        transformer.sublayer_forward = real
    if not fault > REF_TOL:
        fail(f"parallel reference: a sequential residual on the card reads {fault}, "
             f"within {REF_TOL}: the check cannot see the layer's structure")
    rng = np.random.default_rng(9)
    shared = rng.integers(0, cfg.vocab_size, 16)
    reqs = []
    for i in range(6):   # every other prompt repeats a phrase, so n-gram drafts find some
        own = (np.tile(rng.integers(0, cfg.vocab_size, 4), 5) if i % 2 else
               rng.integers(0, cfg.vocab_size, int(rng.integers(4, 31))))
        reqs.append((np.concatenate([shared, own]).astype(np.int32), int(rng.integers(6, 17))))
    slot = dict(n_slots=3, block_steps=4)
    paths = {
        "wave": lambda e: WaveScheduler(e, batch_size=3),
        "continuous-chunked-spec": lambda e: ContinuousScheduler(
            e, prefill_chunk=16, spec_k=SPEC_K, **slot),
        "paged": lambda e: PagedContinuousScheduler(e, prefill_chunk=0, **slot),
        "paged-chunked-spec": lambda e: PagedContinuousScheduler(
            e, prefill_chunk=16, spec_k=SPEC_K, **slot),
    }
    runs = {}
    for name, make in paths.items():
        runs[name] = forced_scheduler_check(cfg, cpu, gpu, dev, make, reqs)
        worst[name] = runs[name]["max_abs_logit_err"]
        st = runs[name]["stats"]
        if "chunked" in name and not (st["chunked_admissions"] and st["mixed_decode_steps"]
                                      and st["spec_steps"]):
            fail(f"parallel reference {name}: no chunks, decode beside them or verify: {st}")
        if name.startswith("paged") and not st["prefill_tokens_saved"]:
            fail(f"parallel reference {name}: no prefix reuse: {st}")
    if not max(worst.values()) <= REF_TOL:
        fail(f"parallel reference: card logits differ from the CPU's by {worst} > {REF_TOL}")
    return {"config": cfg.name + "-3layer-d512-hd256", "max_abs_logit_err": worst,
            "tolerance": REF_TOL, "planted_sequential_residual": fault,
            "schedulers": {k: {"sampling_calls": r["sampling_calls"], "rows": r["rows"]}
                           for k, r in runs.items()}}


def hybrid_phases(dev) -> list:
    """Full-width recurrentgemma-9b, random weights from seed 0, greedy, in
    bf16 and then with int8 weights and the int8 KV cache, at the depth of
    EARLIER_DEPTH:
    (a)
    WaveScheduler over RG_WAVE; (b) ContinuousScheduler over RG_SLOTS with
    ``prefill_chunk`` left at its default, from which it falls back to
    whole-prompt admission.  Each runs twice: tokens in range, the second
    run identical, and every launch count as predicted -- per prefill
    forward one lru_scan a recurrent layer and one flash_prefill an
    attention layer (26 and 12 at 38 layers), per decode step one
    decode_attention an attention layer (int8: its int8 instance), per
    sampling call one topk; int8: per forward one kv_quant_write an
    attention layer and one dequant_matmul for each quantized projection
    and the lm_head."""
    from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import ContinuousScheduler, WaveScheduler

    def expect(cfg, prefills: int, decodes: int, parallel) -> dict:
        fams = M.layer_families(cfg)
        n_rec, n_attn = len(fams["rglru"]), len(fams["attn"])
        out = {name: 0 for name in ops.KERNELS}
        out.update(lru_scan=n_rec * prefills, flash_prefill=n_attn * prefills,
                   topk=prefills + decodes,
                   dequant_matmul=dequant_launches_per_forward(cfg, parallel)
                   * (prefills + decodes))
        if parallel.kv_quant:
            out.update(decode_attention_int8=n_attn * decodes,
                       kv_quant_write=n_attn * (prefills + decodes))
        else:
            out.update(decode_attention=n_attn * decodes)
        return out

    rng = np.random.default_rng(0)
    results, params = [], None
    for weight_quant, phase in (("none", "wave"), ("none", "continuous"), ("int8", "wave"),
                                ("int8", "continuous")):
        parallel = ParallelConfig(weight_quant=weight_quant, kv_quant=weight_quant != "none")
        cfg = phase_config(RG_ARCH)
        t_phase = time.monotonic()
        opts = RG_WAVE if phase == "wave" else RG_SLOTS
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        if phase == "wave":             # each weight set drawn once, for its two phases
            params = None
            torch.cuda.empty_cache()
        eng = Engine(cfg, parallel=parallel, sampling=SamplingConfig(top_k=1),
                     max_len=opts["max_len"], params=params, seed=0, device=dev)
        params = eng.params
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        lo, hi = opts["prompt"]
        work = [rng.integers(0, cfg.vocab_size, int(rng.integers(lo, hi + 1))).astype(np.int32)
                for _ in range(opts["requests"])]
        if phase == "wave":
            budgets = [opts["max_new"]] * len(work)
        else:
            budgets = [int(rng.integers(opts["max_new"][0], opts["max_new"][1] + 1))
                       for _ in work]

        def run():
            if phase == "wave":
                sched = WaveScheduler(eng, batch_size=opts["batch"])
            else:
                sched = ContinuousScheduler(eng, n_slots=opts["slots"])
                if sched.chunk != 0 or sched.spec_k != 0:
                    fail(f"{RG_ARCH} continuous: no fallback to whole-prompt admission "
                         f"(chunk {sched.chunk}, spec_k {sched.spec_k})")
            for i, (p, m) in enumerate(zip(work, budgets)):
                sched.submit(p, max_new=m, arrival_step=i * opts.get("arrival_every", 0))
            torch.cuda.synchronize()
            t = time.monotonic()
            done = sched.run()
            torch.cuda.synchronize()
            return sched, {r.rid: r.output for r in done}, time.monotonic() - t

        ops.reset_launches()
        sched, first, dt1 = run()
        launches = dict(ops.LAUNCHES)
        _, second, dt2 = run()
        if (weight_quant, phase) == ("none", "wave"):     # phase 9's RG-LRU wave is held to it
            TP1_STREAMS[(cfg.name, "none", "wave")] = (cfg.n_layers, first)
        if phase == "wave":
            waves = -(-len(work) // opts["batch"])
            want = expect(cfg, waves, waves * (opts["max_new"] - 1), parallel)
            wrapped = min(len(p) for p in work) > cfg.window
        else:
            st = sched.stats
            want = expect(cfg, st["prefill_calls"], st["decode_steps"], parallel)
            # the last position a slot writes is prompt + emitted - 2
            wrapped = max(len(p) + len(first[i]) - 2 for i, p in enumerate(work)) >= cfg.window
        if launches != want:
            fail(f"{RG_ARCH} {weight_quant} {phase}: kernel launches {launches} != expected "
                 f"{want}")
        if not wrapped:
            fail(f"{RG_ARCH} {phase}: no slot's ring wrapped")
        for rid, toks in first.items():
            if (len(toks) != budgets[rid]
                    or not ((toks >= 0) & (toks < cfg.vocab_size)).all()):
                fail(f"{RG_ARCH} {phase} request {rid}: tokens out of range or wrong count")
            if not np.array_equal(toks, second[rid]):
                fail(f"{RG_ARCH} {phase} request {rid}: greedy tokens differ between two runs")
        n_tokens = sum(len(t) for t in first.values())
        result = {
            "arch": cfg.name, "scheduler": phase, "weight_quant": weight_quant,
            "kv_quant": parallel.kv_quant, "layers": cfg.n_layers,
            "params": cfg.param_count(), "requests": len(work), "max_len": opts["max_len"],
            "prompt_lens": [len(p) for p in work], "max_new": budgets, "tokens": n_tokens,
            "init_s": init_s, "wall_s": [dt1, dt2],
            "ms_per_token": [1e3 * dt1 / n_tokens, 1e3 * dt2 / n_tokens],
            "swept_bytes_per_token": M.decode_weight_bytes(cfg, parallel),
            "launches": launches, "repeatable": True, "ring_wrapped": True,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "first_tokens": {rid: first[rid][:8].tolist() for rid in sorted(first)[:2]},
        }
        if phase == "continuous":
            result.update(slots=opts["slots"], stats=dict(sched.stats),
                          summary=sched.request_summary())
        else:
            with torch.inference_mode():   # one full-width logits row: finite, right shape
                logits = M.forward(eng.params, torch.as_tensor(work[0], device=dev)[None].long(),
                                   cfg, last_only=True, head_f32=eng.head_f32)
            if logits.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(logits).all():
                fail(f"{RG_ARCH}: full-width logits {tuple(logits.shape)} not finite / "
                     f"wrong shape")
            del logits
            result["decode_attention_in_step"] = decode_kernel_in_step(eng, cfg, dev)
        result["phase_s"] = time.monotonic() - t_phase
        results.append(result)
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return results


def decode_kernel_in_step(eng, cfg, dev, steps: int = 4) -> dict:
    """The decode_attention kernel as a recurrentgemma decode step runs it:
    a wave of B prompts of window + 64 tokens (so the ring has wrapped, as
    ``profile_decode.py`` prefills), two warm-up steps, then ``steps`` steps
    under torch.profiler; the kernel's device time over its launches.  The
    step leaves L2 as the layers before it left it, where ``cold_ms``
    flushes 128 MiB before each launch."""
    from repro_torch.models import model as M

    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, cfg.window + 64))
    caches = eng.init_caches(B)
    with torch.inference_mode():
        tok = eng.prefill(torch.as_tensor(prompts, device=dev), caches)
        cur = prompts.shape[1]
        for _ in range(2):
            tok = eng.decode(tok, caches, cur)
            cur += 1
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                tok = eng.decode(tok, caches, cur)
                cur += 1
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.key_averages() if e.device_type == cuda and "decode::kernel" in e.key]
    n = sum(e.count for e in ev)
    if n != steps * len(M.layer_families(cfg)["attn"]):
        fail(f"{RG_ARCH}: the profiled decode steps ran {n} decode_attention kernels")
    us = sum(e.self_device_time_total for e in ev)
    del caches
    return {"steps": steps, "launches": n, "device_ms": us / 1e3, "ms_per_launch": us / 1e3 / n,
            "prompt_len": prompts.shape[1]}


def dequant_launches_per_forward(cfg, parallel) -> int:
    """dequant_matmul launches of one forward: one for each quantized
    projection of every layer (an RG-LRU layer's FFN; its mixer is not
    quantized) and one for the lm_head (the kernel merges its K splits in
    the launch), none for a multi-codebook head (dequantized for its
    einsum, as the reference serves it)."""
    from repro_torch.models import model as M

    if parallel.weight_quant == "none":
        return 0
    return (M.head_site(cfg) == "matmul") + sum(len(idx) * sum(M.wq_site(family, name) == "matmul"
                                  for name in M.layer_param_defs(cfg, family))
                   for family, idx in M.layer_families(cfg).items())


def kernel_attention_layers(cfg) -> int:
    """Layers whose attention runs the attention kernels: every attention
    layer but MLA's, whose latent attention is plain PyTorch (none in an
    RG-LRU or SSD layer)."""
    return 0 if cfg.mla is not None else sum(cfg.block_kind(i) in ("attn", "local_attn")
                                             for i in range(cfg.n_layers))


def moe_layers(cfg) -> int:
    """MoE layers: one routing top-k launch each per forward."""
    return sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))


@contextlib.contextmanager
def drop_log(routes: bool = False):
    """Record every MoE layer call inside (``moe.LOG``); on exit the
    yielded dict holds the forwards past 256 tokens, their assignments and
    how many were dropped, and ``per_call``: every call's dropped
    assignments in order (the tp phases hold theirs to the tp=1 phase's;
    popped before the dict is printed); with ``routes``, every call's top
    experts on the host (``routes``, popped too)."""
    from repro_torch.models import moe

    out: dict = {}
    moe.LOG = []
    try:
        yield out
    finally:
        recs, moe.LOG = moe.LOG, None
        big = [r for r in recs if r["T"] > 256]
        out.update(layer_calls=len(recs), layer_calls_past_256=len(big),
                   assignments_past_256=sum(r["T"] * r["k"] for r in big),
                   dropped=sum(int((~r["keep"]).sum()) for r in big),
                   capacity_at_largest_T=max((r["C"] for r in big), default=None),
                   per_call=[int((~r["keep"]).sum()) for r in recs])
        if routes:
            out["routes"] = [r["top_e"].cpu() for r in recs]


def serve_phase(dev, arch: str, weight_quant: str, kv_quant: bool = False, params=None):
    """One wave phase (see the module docstring) -> (its result, the
    engine's params for the next phase of the same weights).  qwen-72b
    with the int8 KV cache serves QWEN_LONG, every other phase 8 requests of
    16-128 tokens in waves of 4 into a 256-token cache."""
    from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import WaveScheduler

    t_phase = time.monotonic()
    long = arch == "qwen-72b" and kv_quant
    cfg = phase_config(arch, wave_name(weight_quant, kv_quant))
    parallel = ParallelConfig(weight_quant=weight_quant, kv_quant=kv_quant)
    opts = QWEN_LONG if long else dict(requests=SERVE_REQUESTS, batch=SERVE_BATCH,
                                       prompt=(16, 128), max_new=SERVE_MAX_NEW,
                                       max_len=FRONTEND_MAX_LEN.get(arch, SERVE_MAX_LEN))
    frame = () if cfg.n_codebooks == 1 else (cfg.n_codebooks,)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = Engine(cfg, parallel=parallel, sampling=SamplingConfig(top_k=1),
                 max_len=opts["max_len"], seed=0, params=params, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rng = np.random.default_rng(0)
    lo, hi = opts["prompt"]
    work = [rng.integers(0, cfg.vocab_size, (int(rng.integers(lo, hi + 1)), *frame))
            .astype(np.int32) for _ in range(opts["requests"])]
    max_new = opts["max_new"]

    def run():
        sched = WaveScheduler(eng, batch_size=opts["batch"])
        for p in work:
            sched.submit(p, max_new=max_new)
        torch.cuda.synchronize()
        t = time.monotonic()
        done = sched.run()
        torch.cuda.synchronize()
        return {r.rid: r.output for r in done}, time.monotonic() - t

    ops.reset_launches()
    with drop_log() as drops:
        first, dt1 = run()
    launches = dict(ops.LAUNCHES)
    second, dt2 = run()
    n_tokens = sum(len(t) for t in first.values())
    waves = -(-opts["requests"] // opts["batch"])
    per_call = drops.pop("per_call", None)
    if not kv_quant:
        TP1_STREAMS[(cfg.name, weight_quant, "wave")] = (cfg.n_layers, first)
        TP1_DROPS[(cfg.name, weight_quant, "wave")] = per_call
    L, A, n_moe = cfg.n_layers, kernel_attention_layers(cfg), moe_layers(cfg)
    expect = {name: 0 for name in ops.KERNELS}
    expect.update({"flash_prefill": A * waves,
                   "decode_attention" + ("_int8" if kv_quant else ""): A * (max_new - 1) * waves,
                   "kv_quant_write": A * max_new * waves if kv_quant else 0,
                   # sampling, and each MoE layer's routing, once a forward
                   "topk": max_new * waves * (1 + n_moe),
                   "dequant_matmul": dequant_launches_per_forward(cfg, parallel) * max_new * waves,
                   # a parallel-residual layer: one per layer and forward
                   "fused_dual_matmul": L * max_new * waves if cfg.parallel_residual else 0})
    if launches != expect:
        fail(f"{arch} {weight_quant} kv_quant={kv_quant}: kernel launches {launches} != "
             f"expected {expect}")
    for rid, toks in first.items():
        if len(toks) != max_new or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"{arch} {weight_quant} request {rid}: tokens out of range or wrong count: {toks}")
        if not np.array_equal(toks, second[rid]):
            fail(f"{arch} {weight_quant} request {rid}: greedy tokens differ between two runs")
    with torch.inference_mode():   # one full-width logits row: finite, right shape
        logits = M.forward(eng.params, torch.as_tensor(work[0], device=dev)[None].long(), cfg,
                           last_only=True, head_f32=eng.head_f32,
                           features=eng.zero_features(1))
    if logits.shape != (1, 1, *frame, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"{arch} {weight_quant}: full-width logits {tuple(logits.shape)} not finite / "
             f"wrong shape")
    peak = torch.cuda.max_memory_allocated() / 2**30
    params, eng_prefix = eng.params, eng.prefix
    del eng, logits
    torch.cuda.empty_cache()
    # one wave's cache, from shapes: as run, and what a bf16 one would take
    # (an SSD model's is its recurrent state)
    entries = L * 2 * opts["batch"] * cfg.n_kv_heads * opts["max_len"]
    hd = cfg.resolved_head_dim
    cache_gib = {"as_run": entries * (hd + 2 if kv_quant else 2 * hd) / 2**30,
                 "bf16": entries * 2 * hd / 2**30}
    if cfg.mla is not None:        # one bf16 latent (kv_lora_rank + rope dims) a token
        lat = L * opts["batch"] * opts["max_len"] * 2 * (cfg.mla.kv_lora_rank
                                                        + cfg.mla.qk_rope_head_dim) / 2**30
        cache_gib = {"as_run": lat, "bf16": lat}
    if cfg.ssm is not None:
        from repro_torch.runtime.kvcache import cache_bytes
        state = cache_bytes(M.init_caches(cfg, opts["batch"], opts["max_len"],
                                          device="meta")) / 2**30
        cache_gib = {"as_run": state, "bf16": state}
    if long and not peak < torch.cuda.get_device_properties(0).total_memory / 2**30:
        fail(f"{arch}: peak memory {peak} GiB is not below the card's")
    return {
        # an MLA model's latent cache stays bf16 whatever kv_quant says
        "arch": cfg.name, "weight_quant": weight_quant, "kv_quant": kv_quant and cfg.mla is None,
        "layers": cfg.n_layers, "params": cfg.param_count(), "requests": opts["requests"],
        "batch": opts["batch"], "max_new": max_new, "max_len": opts["max_len"],
        "prompt_lens": [len(p) for p in work], "tokens": n_tokens, "init_s": init_s,
        **({"prefix": eng_prefix} if eng_prefix else {}),
        **({"codebooks": cfg.n_codebooks} if frame else {}),
        "wall_s": [dt1, dt2], "ms_per_token": [1e3 * dt1 / n_tokens, 1e3 * dt2 / n_tokens],
        "swept_bytes_per_token": M.decode_weight_bytes(cfg, parallel),
        "launches": launches, "repeatable": True, "peak_mem_gib": peak,
        "kv_cache_gib": cache_gib, "phase_s": time.monotonic() - t_phase,
        "first_tokens": {rid: first[rid][:8].tolist() for rid in sorted(first)[:2]},
        **({"moe_drops": drops} if n_moe else {}),
    }, params


# the slot phases: (name, scheduler, its admission and decode options)
SLOT_PHASES = (("continuous", "dense", dict(prefill_chunk=0)),
               ("paged", "paged", dict(prefill_chunk=0)),
               ("continuous-chunked-spec", "dense", dict(prefill_chunk=64, spec_k=SPEC_K)),
               ("paged-chunked-spec", "paged", dict(prefill_chunk=64, spec_k=SPEC_K)))


def expected_slot_launches(backend: str, st: dict, L: int, parallel: bool = False,
                           kv_quant: bool = False, moe: int = 0, ring: bool = False,
                           dequant: int = 0) -> dict:
    """Kernel launches of one slot phase from its scheduler's stats.  Per
    whole-prompt admission (``prefill_calls`` not made of chunks): L of
    flash_prefill, or of paged_flash_prefill where a prefix was cached.
    Per mixed step (``prefill_chunks`` > 0 means every prefill call is one):
    L of flash_prefill over the stripes (chunks of 64 > VERIFY_WIDTH), or
    of paged_flash_prefill through the tables, and, where some slot was
    decode-active (``mixed_decode_steps``), one decode step.  Per verify
    step: L of flash_verify (two launches each) or paged_flash_prefill.
    Decode blocks make up the rest of ``decode_steps``.  Every prefill,
    decode and verify call samples once through top-k (one launch), and
    each of those forwards of a parallel-residual model (``parallel``)
    makes L of fused_dual_matmul: a mixed step with a decode half 2L.
    ``kv_quant`` (the int8 cache): every forward L of kv_quant_write; the
    decode kernels' int8 instances in place of theirs; and the paged chunks,
    cached-prefix admissions and verify steps L of flash_prefill over the
    dequantized views in place of paged_flash_prefill.  ``L`` counts the
    layers whose attention runs the kernels (0 for MLA); ``moe``: the MoE
    layers, each one routing top-k launch a forward.  ``ring`` (a dense
    slot ring): a chunk or a verify step attends in plain PyTorch, so only
    whole-prompt admissions launch flash_prefill.  ``dequant``: the
    dequant_matmul launches of one forward."""
    from repro_torch.kernels import ops

    mixed = st["prefill_calls"] if st["prefill_chunks"] else 0
    whole = st["prefill_calls"] - mixed
    prefix = st.get("prefix_prefill_calls", 0)
    spec = st.get("spec_steps", 0)
    decodes = st["decode_steps"] - mixed - spec + st["mixed_decode_steps"]
    expect = {name: 0 for name in ops.KERNELS}
    forwards = st["prefill_calls"] + decodes + spec
    expect["topk"] = forwards * (1 + moe)
    expect["dequant_matmul"] = dequant * forwards
    expect["fused_dual_matmul"] = L * forwards if parallel else 0
    q8 = "_int8" if kv_quant else ""
    expect["kv_quant_write"] = L * forwards if kv_quant else 0
    if backend == "paged" and kv_quant:
        expect["flash_prefill"] = L * (st["prefill_calls"] + spec)
        expect["paged_decode_attention_int8"] = L * decodes
    elif backend == "paged":
        expect["flash_prefill"] = L * (whole - prefix)
        expect["paged_flash_prefill"] = L * (prefix + mixed + spec)
        expect["paged_decode_attention"] = L * decodes
    elif ring:
        expect["flash_prefill"] = L * whole
        expect["decode_attention" + q8] = L * decodes
    else:
        expect["flash_prefill"] = L * st["prefill_calls"]
        expect["flash_verify"] = 2 * L * spec
        expect["decode_attention" + q8] = L * decodes
    return expect


class PlainContinuation:
    """A drafter that proposes what the whole-prompt dense phase emitted next
    after each history, except that every other proposal has a wrong last
    draft (a token id of a ``vocab``-wide vocabulary): drafts are right
    until the streams part, and the verify step both accepts and rejects
    (and rewinds past) drafts."""

    def __init__(self, done: dict, vocab: int):
        self.seqs = [np.concatenate([r.prompt, r.output]) for r in done.values()]
        self.vocab = vocab
        self.proposals = 0

    def propose_many(self, histories):
        out = []
        for h in histories:
            seq = next((q for q in self.seqs
                        if len(q) >= len(h) and np.array_equal(q[:len(h)], h)), h[-1:])
            cont = seq[len(h):len(h) + SPEC_K]
            draft = np.concatenate([cont, np.full(SPEC_K - len(cont), h[-1])])
            self.proposals += 1
            if self.proposals % 2:
                draft[-1] = (draft[-1] + 1) % self.vocab
            out.append(draft)
        return np.stack(out).astype(np.int32)


def slot_phases(dev, arch: str = "yi-9b", tie_check: str = "gap", kv_quant: bool = False) -> list:
    """Full-width ``arch`` bf16 (yi-9b or gptj-parallel) through the phases
    of SLOT_PHASES on one engine, a stream that parts from the dense
    phase's certified by ``tie_check`` ("gap" or "plain", see
    ``parted``); see the module docstring.  ``kv_quant``: the int8 KV cache,
    every parting certified against the plain versions (its paged prefix
    is a second approximation of the cache in the reference too)."""
    import argparse

    from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler

    cfg = phase_config(arch, "int8-KV slots" if kv_quant else
                       "slots" if arch == GJ_ARCH else "")
    if kv_quant:
        tie_check = "plain"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = Engine(cfg, parallel=ParallelConfig(kv_block_size=BLOCK, kv_quant=kv_quant),
                 sampling=SamplingConfig(top_k=1), max_len=SERVE_MAX_LEN, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    args = argparse.Namespace(**SLOT_WORKLOAD)
    L = cfg.n_layers
    classes = {"dense": ContinuousScheduler, "paged": PagedContinuousScheduler}

    def run(backend, opts, drafter=None):
        sched = classes[backend](eng, n_slots=SLOTS, **opts)
        if drafter is not None:
            sched.drafter = drafter
        serve.submit_workload(sched, cfg, args)
        torch.cuda.synchronize()
        t = time.monotonic()
        done = sched.run()
        torch.cuda.synchronize()
        return sched, {r.rid: r for r in done}, time.monotonic() - t

    def forward(seq):
        """The logits after ``seq``, as a whole-prompt admission computes
        them: through an int8 cache, with ``kv_quant``, whose prefill
        attends the dequantized fresh K/V."""
        with torch.inference_mode():
            caches = eng.init_caches(1) if kv_quant else None
            return M.forward(eng.params, seq[None], cfg, caches=caches, last_only=True,
                             head_f32=eng.head_f32)[0, -1]

    def parted(name, done):
        """Per request: the whole-prompt dense phase's tokens, or a first
        difference at a near-tie of the logits after the prompt and the
        dense tokens before it; at most MAX_PARTED requests parted.  A
        near-tie, with ``tie_check`` "gap": the top-2 logits lie within
        TIE_GAP.  With "plain": every kernel's plain version on the same
        inputs (``plain_on_card``) gives logits within REF_TOL of the
        port's, and puts both tokens -- the dense phase's and this
        phase's -- within REF_TOL of its top (a port held to REF_TOL may
        choose any token within twice that)."""
        flips = []
        for rid, r in tokens["continuous"].items():
            dense, other = r.output, done[rid].output
            if np.array_equal(dense, other):
                continue
            n = min(len(dense), len(other))
            t = int(np.argmax(dense[:n] != other[:n])) if (dense[:n] != other[:n]).any() else n
            seq = torch.as_tensor(np.concatenate([r.prompt, dense[:t]]), device=dev).long()
            logits = forward(seq)
            gap = float((lambda v: v[0] - v[1])(torch.topk(logits, 2).values))
            flip = {"rid": rid, "step": t, "top2_gap": gap}
            if tie_check == "gap":
                if not gap < TIE_GAP:
                    fail(f"{name} request {rid} parts from dense at step {t} with top-2 gap {gap}")
            else:
                with plain_on_card():
                    plain = forward(seq)
                err = (logits - plain).abs().max().item()
                slack = [(plain.max() - plain[int(x[t])]).item() for x in (dense, other)
                         if t < len(x)]
                if not (err <= REF_TOL and max(slack) < REF_TOL):
                    fail(f"{name} request {rid} parts from dense at step {t}: the plain "
                         f"versions there differ from the port by {err} and put the two "
                         f"tokens {slack} below their top (limit {REF_TOL} each)")
                flip.update(plain_max_abs_err=err, plain_slack=slack)
            flips.append(flip)
        if len(flips) > MAX_PARTED:
            fail(f"{name}: {len(flips)} of {len(done)} streams part from dense, more than "
                 f"{MAX_PARTED}: {flips}")
        return flips

    results, tokens = [], {}
    main_path = arch == "yi-9b" and not kv_quant
    for name, backend, opts in SLOT_PHASES + ((DISAGG_REF,) if main_path else ()):
        t_phase = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        sched, first, dt1 = run(backend, opts)
        launches = dict(ops.LAUNCHES)
        _, second, dt2 = run(backend, opts)
        st = sched.stats
        expect = expected_slot_launches(backend, st, L, cfg.parallel_residual, kv_quant)
        if launches != expect:
            fail(f"{name}: kernel launches {launches} != expected {expect} (stats {st})")
        if backend == "paged":
            if not (st["prefill_tokens_saved"] > 0 and st["shared_block_hits"] > 0
                    and (kv_quant or launches["paged_flash_prefill"] > 0)
                    and launches["paged_decode_attention" + ("_int8" if kv_quant else "")] > 0):
                fail(f"{name}: no prefix reuse or a paged kernel never ran: {st}, {launches}")
            try:
                sched.alloc.audit()
            except AssertionError as e:
                fail(f"{name}: block allocator audit: {e}")
        if opts["prefill_chunk"] and not (st["chunked_admissions"] > 0
                                          and st["mixed_decode_steps"] > 0
                                          and (not opts.get("spec_k") or st["spec_steps"] > 0)):
            fail(f"{name}: no chunked admission, no decode during admission or (spec "
                 f"decode on) no verify step: {st}")
        if sorted(first) != list(range(SLOT_WORKLOAD["requests"])):
            fail(f"{name}: served requests {sorted(first)}")
        for rid, r in first.items():
            toks = r.output
            if not (len(toks) and ((toks >= 0) & (toks < cfg.vocab_size)).all()):
                fail(f"{name} request {rid}: tokens out of range or none: {toks}")
            if not np.array_equal(toks, second[rid].output):
                fail(f"{name} request {rid}: greedy tokens differ between two runs")
        tokens[name] = first
        if not kv_quant:
            TP1_STREAMS[(cfg.name, "none", name)] = (L, {rid: r.output
                                                          for rid, r in first.items()})
        n_tokens = sum(len(r.output) for r in first.values())
        summary = sched.request_summary()
        result = {
            "arch": cfg.name, "scheduler": name, "kv_quant": kv_quant, "layers": L,
            "params": cfg.param_count(),
            "requests": SLOT_WORKLOAD["requests"], "slots": SLOTS, "block_size": BLOCK,
            "max_len": SERVE_MAX_LEN, "options": opts, "workload": SLOT_WORKLOAD,
            "tokens": n_tokens, "init_s": init_s, "wall_s": [dt1, dt2],
            "ms_per_token": [1e3 * dt1 / n_tokens, 1e3 * dt2 / n_tokens],
            "stats": dict(st), "summary": summary, "launches": launches,
            "repeatable": True, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        if name != "continuous":
            result["parted_from_dense_at_near_ties"] = parted(name, first)
        if name == "continuous-chunked-spec":
            # drafts that are right: the verify step's causal rows 1..K at work
            sched, oracle, dt = run(backend, opts,
                                    PlainContinuation(tokens["continuous"], cfg.vocab_size))
            st = sched.stats
            per_step = st["spec_emitted"] / max(1, st["spec_slot_steps"])
            if not (0 < st["spec_accepted"] < st["spec_proposed"] and per_step > 1.0):
                fail(f"{name}: right drafts were not accepted or wrong ones not "
                     f"rejected: {st}")
            result["right_drafts"] = {
                "wall_s": dt, "ms_per_token": 1e3 * dt / sum(len(r.output)
                                                           for r in oracle.values()),
                "stats": dict(st), "summary": sched.request_summary(),
                "parted_from_dense_at_near_ties": parted(name + " right drafts", oracle)}
        result["phase_s"] = time.monotonic() - t_phase
        results.append(result)
    if arch == "yi-9b" and not kv_quant:
        def top2_gap(seq: np.ndarray) -> float:
            logits = forward(torch.as_tensor(seq, device=dev).long())
            return float((lambda v: v[0] - v[1])(torch.topk(logits, 2).values))
        results.extend(control_plane_phases(dev, eng, cfg, top2_gap))
        seq_reference(dev, eng.params, cfg)
    del eng
    torch.cuda.empty_cache()
    return results


# -- the serving control plane (phase 13) ---------------------------------------
#
# On the yi-9b slot phases' engine (48 layers): the overlapped loop against
# the blocking one, a fault plan, priority classes under an overload burst,
# and the HTTP frontend.

CP_FAULTS = "step:at=6,times=2;poison:slot=1,at=12;alloc:at=20"
CP_CLASS_MIX = "interactive=0.25,standard=0.5,batch=0.25"
CP_BURST = "burst:at=8,count=12,plen=16,new=8,cls=batch"


@contextlib.contextmanager
def sync_checked_dispatch(eng, sched, counts: dict):
    """Every decode dispatch of ``eng`` runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that waits for the
    card (a blocking copy, ``.item()``, a synchronize) raises.  ``counts``:
    dispatches in all, and those queued while an earlier block was still
    unlanded (block N+1 before block N lands)."""
    plain = eng.dispatch_decode

    def dispatch(*a, **k):
        counts["dispatches"] += 1
        counts["ahead"] += bool(sched._pipeline)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return plain(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    eng.dispatch_decode = dispatch
    try:
        yield
    finally:
        del eng.dispatch_decode


def control_plane_phases(dev, eng, cfg, top2_gap) -> list:
    """Phase 13 on the slot phases' yi-9b engine: (a) continuous and paged,
    whole-prompt admission, blocking, overlapped, overlapped, blocking: the
    same streams and launches, every overlapped dispatch free of host
    synchronisation, the host-blocked and overlapped seconds and the walls; (b) paged overlapped
    under CP_FAULTS: one quarantine, two retries, a preemption, survivors
    as the clean overlapped run's; (c) dense with CP_CLASS_MIX, the ladder
    on and CP_BURST: its levels, the workload's admitted survivors as the
    unloaded run's; (d) the HTTP frontend on 127.0.0.1: 4 concurrent SSE
    clients get the scheduler's tokens, a 429 at max_pending, a graceful
    drain.  A parting from the reference stream is allowed at a top-2 gap
    below TIE_GAP (the runs admit in other batches), at most MAX_PARTED."""
    import argparse

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler

    classes = {"dense": ContinuousScheduler, "paged": PagedContinuousScheduler}
    base = argparse.Namespace(**SLOT_WORKLOAD)

    def run(backend, args=base, **kw):
        sched = classes[backend](eng, n_slots=SLOTS, prefill_chunk=0, **kw)
        serve.submit_workload(sched, cfg, args)
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.monotonic()
        done = sched.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        return sched, {r.rid: r for r in done}, wall, dict(ops.LAUNCHES)

    def parted(name, ref, done, rids=None):
        flips = []
        for rid in (ref if rids is None else rids):
            a, b = ref[rid].output, done[rid].output
            if np.array_equal(a, b):
                continue
            n = min(len(a), len(b))
            t = int(np.argmax(a[:n] != b[:n])) if (a[:n] != b[:n]).any() else n
            gap = top2_gap(np.concatenate([ref[rid].prompt, a[:t]]))
            if not gap < TIE_GAP:
                fail(f"{name} request {rid} parts from its reference at step {t} with top-2 "
                     f"gap {gap}")
            flips.append({"rid": rid, "step": t, "top2_gap": gap})
        if len(flips) > MAX_PARTED:
            fail(f"{name}: {len(flips)} streams parted, more than {MAX_PARTED}: {flips}")
        return flips

    def loop_line(runs):
        """The walls and host split of one loop's runs, each a list."""
        st = [sched.stats for sched, _, _, _ in runs]
        walls = [wall for _, _, wall, _ in runs]
        return {"wall_s": walls, "decode_steps": st[0]["decode_steps"],
                "wall_per_decode_step_ms": [1e3 * w / max(1, x["decode_steps"])
                                            for w, x in zip(walls, st)],
                "host_blocked_s": [x["host_blocked_s"] for x in st],
                "host_overlap_s": [x["host_overlap_s"] for x in st],
                "host_blocked_share": [x["host_blocked_s"] / w for w, x in zip(walls, st)],
                "landings": st[0]["landings"], "max_dispatch_ahead": st[0]["max_dispatch_ahead"],
                "dispatch_ahead_steps": st[0]["dispatch_ahead_steps"],
                "eos_rollbacks": st[0]["eos_rollbacks"]}

    results, clean = [], {}
    # (a) overlap against blocking: blocking, overlapped, overlapped,
    # blocking, so that each loop's two walls straddle the other's
    for backend in ("dense", "paged"):
        t_phase = time.monotonic()
        name = f"overlap {backend}"
        loops = {False: [], True: []}
        counts = {"dispatches": 0, "ahead": 0}
        for overlap in (False, True, True, False):
            if not overlap:
                loops[False].append(run(backend))
                continue
            sched = classes[backend](eng, n_slots=SLOTS, prefill_chunk=0, overlap=True)
            serve.submit_workload(sched, cfg, base)
            ops.reset_launches()
            torch.cuda.synchronize()
            t = time.monotonic()
            with sync_checked_dispatch(eng, sched, counts):
                done = sched.run()
            torch.cuda.synchronize()
            loops[True].append((sched, {r.rid: r for r in done}, time.monotonic() - t,
                                dict(ops.LAUNCHES)))
        _, d0, _, l0 = loops[False][0]
        for sched, done, _, launches in loops[True] + loops[False][1:]:
            if sorted(d0) != sorted(done) or any(not np.array_equal(d0[r].output,
                                                                    done[r].output) for r in d0):
                fail(f"{name}: the streams differ between the loops or their repeats")
            if launches != l0:
                fail(f"{name}: launches {launches} != the blocking loop's {l0}")
        for sched, _, _, _ in loops[True]:
            if not (sched.stats["landings"] > 0 and sched.stats["max_dispatch_ahead"] >= 2
                    and sched.stats["eos_rollbacks"] == 0):
                fail(f"{name}: the loop never ran ahead: {sched.stats}")
            if backend == "paged":
                sched.alloc.audit()
        if not counts["ahead"]:
            fail(f"{name}: no dispatch was queued ahead of a landing: {counts}")
        clean[backend] = loops[True][0][1]
        line = {"blocking": loop_line(loops[False]), "overlapped": loop_line(loops[True])}
        print(f"control plane {name}: " + json.dumps(line), flush=True)
        results.append({"arch": cfg.name, "scheduler": name, "kv_quant": False,
                        "layers": cfg.n_layers, "launches": loops[True][0][3],
                        "sync_checked": counts, **line, "phase_s": time.monotonic() - t_phase})
    # (b) faults on the paged overlapped loop
    t_phase = time.monotonic()
    sched, done, wall, launches = run("paged", overlap=True, fault_plan=CP_FAULTS,
                                      retry_backoff_s=0.0)
    st = sched.stats
    bad = [rid for rid, r in done.items() if r.finish_reason == "error"]
    # the alloc clause's denial lands while a block is in flight: the loop
    # lands it and retries the allocation, or preempts when nothing is
    if not (st["quarantined"] == 1 and st["step_retries"] == 2 and st["step_faults"] == 2
            and len(bad) == 1 and sorted(done) == sorted(clean["paged"])
            and all(c.times == 0 for c in sched.faults.clauses)):
        fail(f"faults: quarantine or retries not as planned: {st}, errors {bad}")
    sched.alloc.audit()
    survivors = [rid for rid in done if rid not in bad]
    flips = parted("faults", clean["paged"], done, survivors)
    results.append({"arch": cfg.name, "scheduler": "paged overlapped, faults", "kv_quant": False,
                    "fault_plan": CP_FAULTS, "launches": launches, "wall_s": wall,
                    "quarantined": bad, "faults": sched.request_summary()["faults"],
                    "preemptions": st["preemptions"], "parted_at_near_ties": flips,
                    "phase_s": time.monotonic() - t_phase})
    # (c) classes and the degradation ladder under a burst
    t_phase = time.monotonic()
    args = argparse.Namespace(**SLOT_WORKLOAD, class_mix=CP_CLASS_MIX)
    sched = ContinuousScheduler(eng, n_slots=SLOTS, prefill_chunk=0, fault_plan=CP_BURST,
                                overload_opts={"enabled": True})
    serve.submit_workload(sched, cfg, args)
    ops.reset_launches()
    levels, t = [], time.monotonic()
    while sched.serve_step():
        levels.append(sched.overload_level())
    done = {r.rid: r for r in sched.run()}
    wall, launches = time.monotonic() - t, dict(ops.LAUNCHES)
    summary = sched.request_summary()
    st = sched.stats
    kept = [rid for rid in clean["dense"] if done[rid].finish_reason in ("stop", "length")]
    shed = [rid for rid, r in done.items() if r.finish_reason == "shed"]
    if not (st["burst_injected"] == 12 and max(levels) >= 1 and shed and kept
            and all(done[rid].priority == "batch" for rid in shed)):
        fail(f"overload: the ladder never engaged or shed a latency class: levels {levels}, "
             f"{st}")
    flips = parted("overload", clean["dense"], done, kept)
    print(f"control plane overload: levels {levels}", flush=True)
    results.append({"arch": cfg.name, "scheduler": "dense, classes and ladder", "kv_quant": False,
                    "class_mix": CP_CLASS_MIX, "burst": CP_BURST, "launches": launches,
                    "wall_s": wall, "levels": levels, "overload": summary["overload"],
                    "classes": st["classes"], "kept": len(kept), "shed": len(shed),
                    "parted_at_near_ties": flips, "phase_s": time.monotonic() - t_phase})
    results.append(frontend_phase(eng, cfg, clean["dense"], parted))
    return results


def frontend_phase(eng, cfg, ref: dict, parted) -> dict:
    """(d): the HTTP frontend on 127.0.0.1 over an overlapped continuous
    scheduler on the card: 4 concurrent SSE clients (the workload's first
    four prompts and budgets) get the tokens the scheduler retired with,
    the blocking run's streams (near-ties aside); 6 concurrent requests
    against max_pending 4 get at least one 429 with Retry-After and the
    rest their whole budgets; a stream in flight when the drain begins is
    served to its end, and then nothing listens."""
    import asyncio
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import ops
    from repro_torch.launch.frontend import EngineService, HttpFrontend
    from repro_torch.runtime.scheduler import ContinuousScheduler

    t_phase = time.monotonic()
    sched = ContinuousScheduler(eng, n_slots=SLOTS, prefill_chunk=0, overlap=True)
    service = EngineService(sched, max_pending=SLOTS, idle_wait_s=0.002)
    frontend = HttpFrontend(service, port=0)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=lambda: (asyncio.set_event_loop(loop),
                                              loop.run_until_complete(frontend.start()),
                                              loop.run_forever()), daemon=True)
    ops.reset_launches()
    thread.start()
    deadline = time.monotonic() + 60
    while frontend._server is None:
        if time.monotonic() > deadline:
            fail("frontend: the server did not start")
        time.sleep(0.01)
    port = frontend.port

    def post(body):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        c.request("POST", "/v1/completions", json.dumps(body),
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()

    def sse(raw: bytes) -> list:
        toks = []
        for ev in raw.decode().split("\n\n"):
            if ev.startswith("data: {"):
                toks += json.loads(ev[6:])["choices"][0]["token_ids"]
        return toks

    reqs = [ref[rid] for rid in sorted(ref)[:4]]
    bodies = [{"prompt": r.prompt.tolist(), "max_tokens": r.max_new, "stream": True}
              for r in reqs]
    with ThreadPoolExecutor(6) as pool:
        streamed = list(pool.map(post, bodies))
        if any(st != 200 for st, _, _ in streamed):
            fail(f"frontend: statuses {[st for st, _, _ in streamed]}")
        retired = {tuple(r.prompt.tolist()): r.output.tolist() for r in sched.done}
        got = {}
        for i, (body, (_, _, raw)) in enumerate(zip(bodies, streamed)):
            toks = sse(raw)
            if toks != retired.get(tuple(body["prompt"])) or len(toks) != body["max_tokens"]:
                fail(f"frontend: client {i} streamed {toks}, the scheduler retired "
                     f"{retired.get(tuple(body['prompt']))}")
            got[i] = types.SimpleNamespace(output=np.asarray(toks, np.int32))
        flips = parted("frontend", {i: r for i, r in enumerate(reqs)}, got)
        launches = dict(ops.LAUNCHES)
        overload = list(pool.map(post, [{"prompt": r.prompt.tolist(), "max_tokens": 32}
                                        for r in list(ref.values())[4:10]]))
    statuses = [st for st, _, _ in overload]
    for st, headers, data in overload:
        if st == 429 and headers.get("Retry-After") != "1":
            fail(f"frontend: a 429 without Retry-After: {headers}")
        if st == 200 and len(json.loads(data)["choices"][0]["token_ids"]) != 32:
            fail("frontend: an admitted request lost tokens under shedding")
    if statuses.count(429) < 1 or sched.stats["shed_requests"] != statuses.count(429):
        fail(f"frontend: 6 requests against max_pending {SLOTS} shed none: {statuses}")
    # graceful drain: a stream in flight when stop() begins is served whole
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(post, dict(bodies[0], max_tokens=32))
        time.sleep(0.5)
        asyncio.run_coroutine_threadsafe(frontend.stop(), loop).result(timeout=300)
        st, _, raw = fut.result(timeout=300)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=60)
    loop.close()
    if st != 200 or len(sse(raw)) != 32:
        fail(f"frontend: the stream in flight at the drain got {st}, {len(sse(raw))} tokens")
    try:
        post({"prompt": [1, 2], "max_tokens": 1})
        fail("frontend: still listening after the drain")
    except OSError:
        pass
    return {"arch": cfg.name, "scheduler": "frontend (HTTP, overlapped continuous)",
            "kv_quant": False, "launches": launches, "clients": len(bodies),
            "parted_at_near_ties": flips, "overload_statuses": statuses,
            "shed_requests": sched.stats["shed_requests"], "drained_tokens": len(sse(raw)),
            "phase_s": time.monotonic() - t_phase}


# -- latent attention and mixture of experts -----------------------------------
#
# minicpm3-4b (MLA: its latent attention is plain PyTorch, its MLP and
# lm_head run dequant_matmul when quantized, its sampling top-k) and
# deepseek-moe-16b (MHA at head_dim 128, g 1, through the attention
# kernels; 27 MoE layers, each routing through the top-k kernel).

MLA_ARCH, MOE_ARCH = "minicpm3-4b", "deepseek-moe-16b"
# their wave phases, (arch, weight_quant), in order; deepseek's int4 wave
# reads its int4 experts through wquant.to_dense each forward
LATENT_MOE_WAVES = ((MLA_ARCH, "none"), (MOE_ARCH, "none"), (MOE_ARCH, "int4"))
# the routing top-k's rows: a decode step of 4 slots, a 4 x 125 wave prefill
ROUTER_T = (B, 500)


# a router near-tie: the CPU's k-th best expert and the one the card chose
# in its place lie within this much probability
ROUTER_TIE = 1e-2


@contextlib.contextmanager
def card_routes():
    """Inside: MoE forwards on the card record their top experts.  Yields a
    function that runs a CPU call replaying them, call by call, -> (its
    result, the router near-ties it took: one (layer call, token, margin)
    where the card ranked experts apart from the CPU's own top-k, margin
    the CPU's k-th probability less that of the card's other choice);
    fails where a margin is not below ROUTER_TIE."""
    from repro_torch.kernels import ref
    from repro_torch.models import moe

    moe.LOG = []

    def replay(cpu_call):
        card = [rec["top_e"].cpu() for rec in moe.LOG]
        moe.LOG, moe.ROUTE_REPLAY = [], card
        try:
            out = cpu_call()
            log = moe.LOG
        finally:
            moe.LOG = moe.ROUTE_REPLAY = None
        ties = []
        for call, rec in enumerate(log):
            probs, chosen = rec["probs"], rec["top_e"]
            own = ref.topk_ref(probs, chosen.shape[1])[1].long()
            chosen = chosen.long()
            for t in torch.nonzero((own.sort(1).values != chosen.sort(1).values).any(1))[:, 0]:
                kth = probs[t, own[t]].min()
                other = probs[t, [e for e in chosen[t].tolist() if e not in own[t].tolist()]]
                margin = float(kth - other.min())
                if not margin < ROUTER_TIE:
                    fail(f"the card routed token {int(t)} of MoE call {call} to experts "
                         f"{chosen[t].tolist()}, the CPU to {own[t].tolist()}, "
                         f"{margin} apart in probability (limit {ROUTER_TIE})")
                ties.append((call, int(t), margin))
        return out, ties

    try:
        yield replay
    finally:
        moe.LOG = moe.ROUTE_REPLAY = None


def routed_teacher_forced(cfg, cpu, gpu, dev, plen: int = 20, kv_quant: bool = False):
    """``teacher_forced_worst`` for an MoE model: each forward runs on the
    card first and then on the CPU replaying the card's expert choices
    (``card_routes``), so that a router near-tie, where the two devices
    rank experts apart, does not stand for a fault -> (the largest |card -
    CPU|, the near-ties replayed).  ``plen``: the prompt (past a window's
    ring of 64 it wraps); ``kv_quant``: over the int8 cache."""
    from repro_torch.models import model as M

    b, max_len = 3, 128
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, plen)))
    caches = {d: M.init_caches(cfg, b, max_len, device=d, kv_quant=kv_quant)
              for d in ("cpu", dev)}
    worst, ties = 0.0, []
    with torch.inference_mode():
        tok, cur = tokens, None
        for _ in range(9):                      # the prefill, then 8 decode steps
            kw = {} if cur is None else {"cur_pos": cur}
            with card_routes() as replay:
                lg = M.forward(gpu, tok.to(dev), cfg, caches=caches[dev], **kw).cpu()
                lc, t = replay(lambda: M.forward(cpu, tok, cfg, caches=caches["cpu"], **kw))
            ties += t
            if not torch.isfinite(lg).all():
                fail(f"{cfg.name}: non-finite card logits")
            worst = max(worst, (lc - lg).abs().max().item())
            cur = plen if cur is None else cur + 1
            tok = lc[:, -1].argmax(-1)[:, None]
    return worst, ties


def parted_streams(cpu_done: dict, gpu_done: dict, certify) -> list:
    """Per request: the card's stream equals the CPU's, or parts where
    ``certify(prompt + the CPU's tokens before, the card's token)`` allows
    it -> the partings."""
    parted = []
    for rid, r in cpu_done.items():
        a, b = r.output, gpu_done[rid].output
        if np.array_equal(a, b):
            continue
        n = min(len(a), len(b))
        t = int(np.argmax(a[:n] != b[:n])) if (a[:n] != b[:n]).any() else n
        if t == n:
            fail(f"request {rid}: the card's stream and the CPU's differ in length")
        parted.append({"rid": rid, "step": t,
                       **certify(np.concatenate([r.prompt, a[:t]]).astype(np.int32),
                                 int(b[t]))})
    return parted


def small_model(dev, arch: str, weight_quant: str = "none"):
    """Reduced ``arch`` (minicpm3-4b, deepseek-moe-16b, mixtral-8x7b,
    mamba2-1.3b), random weights from seed 1, norm gammas (and an SSD
    mixer's dt_bias, A_log and D) drawn nonzero -> (cfg, CPU params, the
    same on ``dev``)."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).reduced()
    cpu = M.init_params(cfg, ParallelConfig(weight_quant=weight_quant), seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for layer in cpu["layers"]:
        for leaves in (layer, layer.get("mixer", {})):
            for name, sd in (("norm1", 0.2), ("norm2", 0.2), ("q_norm", 0.2), ("kv_norm", 0.2),
                             ("norm", 0.2), ("dt_bias", 0.5), ("A_log", 0.5), ("D", 1.0)):
                if name in leaves:
                    leaves[name].copy_(sd * torch.randn(leaves[name].shape, generator=gen))
    return cfg, cpu, to_device(cpu, dev)


def latent_moe_reference_check(dev) -> list:
    """Reduced minicpm3-4b (bf16) and deepseek-moe-16b (bf16 and int4) on
    the card against the same weights on the CPU, where the plain versions
    run: prefill logits and 8 teacher-forced decode steps within REF_TOL,
    and the greedy streams of the paged pool in chunks of 16 with spec
    decode (12 requests behind a shared prompt) equal, or parted at a CPU
    top-2 gap below TIE_GAP.  deepseek also routes one MoE forward of 320
    skewed tokens on both: the same top experts, and so the same dropped
    (token, expert) assignments, which must be some."""
    import argparse

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import PagedContinuousScheduler

    out = []
    for arch, mode in ((MLA_ARCH, "none"), (MOE_ARCH, "none"), (MOE_ARCH, "int4")):
        cfg, cpu, gpu = small_model(dev, arch, mode)
        ties = []
        if cfg.moe is not None:
            worst, ties = routed_teacher_forced(cfg, cpu, gpu, dev)
        else:
            worst = teacher_forced_worst(cfg, cpu, gpu, dev)
        if not worst <= REF_TOL:
            fail(f"small {arch} {mode}: card logits differ from the CPU's by {worst}")
        par = ParallelConfig(weight_quant=mode, kv_block_size=8)
        streams = {}
        for d, params in (("cpu", cpu), (dev, gpu)):
            eng = Engine(cfg, parallel=par, sampling=SamplingConfig(top_k=1), max_len=128,
                         params=params, device=d)
            sched = PagedContinuousScheduler(eng, n_slots=3, prefill_chunk=16, spec_k=3)
            serve.submit_workload(sched, cfg, argparse.Namespace(
                requests=12, shared_prefix=16, prompt_len=24, max_new=12, max_new_spread=4,
                arrival_every=2))
            streams[str(d)] = {r.rid: r for r in sched.run()}
            if not sched.stats["spec_steps"] or not sched.stats["prefill_tokens_saved"]:
                fail(f"small {arch}: no verify step or no prefix reuse: {sched.stats}")
        def certify(seq, tok):
            """A parting after ``seq``: the CPU's top-2 gap there below
            TIE_GAP, or a router near-tie on the way (the sequence on the
            card, and on the CPU with the card's expert choices, within
            REF_TOL)."""
            t = torch.from_numpy(seq)[None].long()
            with torch.inference_mode():
                lc = M.forward(cpu, t, cfg, last_only=True)[0, -1]
            gap = float((lambda v: v[0] - v[1])(torch.topk(lc, 2).values))
            flip = {"top2_gap": gap}
            if not gap < TIE_GAP and cfg.moe is not None:
                with torch.inference_mode(), card_routes() as replay:
                    lg = M.forward(gpu, t.to(dev), cfg, last_only=True).cpu()
                    lr, rt = replay(lambda: M.forward(cpu, t, cfg, last_only=True))
                err = (lr - lg).abs().max().item()
                if rt and err <= REF_TOL:
                    flip.update(router_ties=len(rt), replayed_max_abs_err=err)
                    gap = 0.0
            if not gap < TIE_GAP:
                fail(f"small {arch}: card and CPU part after {len(seq)} tokens, gap {gap}")
            return flip

        parted = parted_streams(streams["cpu"], streams[str(dev)], certify)
        row = {"config": cfg.name, "weight_quant": mode, "max_abs_logit_err": worst,
               "tolerance": REF_TOL, "router_ties_replayed": len(ties),
               "router_tie_margins": sorted(m for *_, m in ties)[-3:],
               "paged_chunked_spec_requests": len(streams["cpu"]),
               "parted_at_near_ties": parted}
        if arch == MOE_ARCH and mode == "none":
            row["drops_t320"] = moe_drop_check(cfg, cpu, gpu, dev)
        out.append(row)
    return out


def moe_drop_check(cfg, cpu, gpu, dev) -> dict:
    """One MoE layer's forward over 320 tokens leaning toward expert 0 on the
    card and on the CPU: the same top experts, the same drops."""
    from repro_torch.models import moe

    layer = next(i for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
    router = cpu["layers"][layer]["router"]
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn((1, 320, cfg.d_model), generator=gen)
         + 3.0 * router[:, 0] / router[:, 0].norm()).to(torch.bfloat16)
    got = {}
    for d, params in (("cpu", cpu), (dev, gpu)):
        moe.LOG = []
        with torch.inference_mode():
            y = moe.moe_forward(params["layers"][layer], x.to(d), cfg).float().cpu()
        (rec,) = moe.LOG
        moe.LOG = None
        got[str(d)] = (set(map(tuple, moe.dropped(rec).tolist())), rec["top_e"].cpu(), y,
                       rec["C"])
    (dc, tc, yc, C), (dg, tg, yg, _) = got["cpu"], got[str(dev)]
    err = (yc - yg).abs().max().item()
    if not (torch.equal(tc, tg) and dc == dg and dc and err <= REF_TOL):
        fail(f"small {cfg.name}: 320-token MoE forward: top experts equal {torch.equal(tc, tg)}, "
             f"drops {len(dc)} on the CPU and {len(dg)} on the card (equal {dc == dg}), "
             f"output error {err}")
    return {"tokens": 320, "capacity": C, "dropped": len(dc), "max_abs_err": err}


def latent_moe_slot_phase(dev, arch: str, params=None) -> dict:
    """Full-width ``arch`` bf16 through SLOT_PHASES' paged-chunked-spec
    phase (the workload of the slot phases), twice: tokens in range, the
    second run identical, every launch as the scheduler's stats predict
    it, chunked admission, decode during admission, verify steps and
    prefix reuse, and the allocator's audit; deepseek's drops reported."""
    import argparse

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import PagedContinuousScheduler

    name, _, opts = SLOT_PHASES[3]
    cfg = phase_config(arch)
    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = Engine(cfg, parallel=ParallelConfig(kv_block_size=BLOCK),
                 sampling=SamplingConfig(top_k=1), max_len=SERVE_MAX_LEN, seed=0,
                 params=params, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0

    def run():
        sched = PagedContinuousScheduler(eng, n_slots=SLOTS, **opts)
        serve.submit_workload(sched, cfg, argparse.Namespace(**SLOT_WORKLOAD))
        torch.cuda.synchronize()
        t = time.monotonic()
        done = sched.run()
        torch.cuda.synchronize()
        return sched, {r.rid: r.output for r in done}, time.monotonic() - t

    ops.reset_launches()
    with drop_log() as drops:
        sched, first, dt1 = run()
    launches = dict(ops.LAUNCHES)
    _, second, dt2 = run()
    # phase 9's MoE paged chunked-spec job is held to these
    TP1_STREAMS[(cfg.name, "none", name)] = (cfg.n_layers, first)
    TP1_DROPS[(cfg.name, "none", name)] = drops.pop("per_call")
    st = sched.stats
    expect = expected_slot_launches("paged", st, kernel_attention_layers(cfg), moe=moe_layers(cfg))
    if launches != expect:
        fail(f"{arch} {name}: kernel launches {launches} != expected {expect} (stats {st})")
    if not (st["prefill_tokens_saved"] > 0 and st["chunked_admissions"] > 0
            and st["mixed_decode_steps"] > 0 and st["spec_steps"] > 0):
        fail(f"{arch} {name}: no prefix reuse, chunked admission, decode during admission "
             f"or verify step: {st}")
    try:
        sched.alloc.audit()
    except AssertionError as e:
        fail(f"{arch} {name}: block allocator audit: {e}")
    if sorted(first) != list(range(SLOT_WORKLOAD["requests"])):
        fail(f"{arch} {name}: served requests {sorted(first)}")
    for rid, toks in first.items():
        if not (len(toks) and ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{arch} {name} request {rid}: tokens out of range or none: {toks}")
        if not np.array_equal(toks, second[rid]):
            fail(f"{arch} {name} request {rid}: greedy tokens differ between two runs")
    n_tokens = sum(len(t) for t in first.values())
    result = {
        "arch": cfg.name, "scheduler": name, "kv_quant": False, "layers": cfg.n_layers,
        "params": cfg.param_count(), "requests": SLOT_WORKLOAD["requests"], "slots": SLOTS,
        "block_size": BLOCK, "max_len": SERVE_MAX_LEN, "options": opts,
        "workload": SLOT_WORKLOAD, "tokens": n_tokens, "init_s": init_s, "wall_s": [dt1, dt2],
        "ms_per_token": [1e3 * dt1 / n_tokens, 1e3 * dt2 / n_tokens], "stats": dict(st),
        "summary": sched.request_summary(), "launches": launches, "repeatable": True,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "phase_s": time.monotonic() - t_phase,
    }
    if moe_layers(cfg):
        result["moe_drops"] = drops
    del eng
    torch.cuda.empty_cache()
    return result


def latent_moe_phases(dev) -> list:
    """minicpm3-4b and deepseek-moe-16b at full width, at EARLIER_DEPTH's
    cut depth (8 of 62 and 14 of 28 layers),
    random weights from seed 0: each's bf16 wave (phase 5's workload) and
    paged chunked-spec phase on the same weights, then deepseek's int4
    wave, whose 4 x <= 125-token prefills route more than 256 tokens."""
    for arch, mode in LATENT_MOE_WAVES:
        phase, params = serve_phase(dev, arch, mode)
        yield phase
        if mode == "none":
            yield latent_moe_slot_phase(dev, arch, params)
        del params
        torch.cuda.empty_cache()


def check_moe_kernels(dev, flush) -> list:
    """deepseek-moe-16b's kernel rows: flash_prefill and decode_attention at
    its 16 MHA heads of 128 (g 1), a wave of 4 x 125 tokens and one decode
    step over 300 of 512 entries, and the routing top-k over (T, 64) fp32
    softmax rows, k 6, at ROUTER_T, bit for bit; each against its plain
    version, with its time, SDPA's or torch.topk's, and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    H, hd, sq, scale = 16, 128, 125, 128 ** -0.5
    rows = []
    q, k, v = (rnd(B, H, sq, hd).bfloat16() for _ in range(3))
    q_pos = torch.arange(sq, device=dev, dtype=torch.int32).expand(B, -1).contiguous()
    got, want = ops.flash_prefill(q, k, v, q_pos, scale), ref.flash_prefill_ref(q, k, v, q_pos,
                                                                                  scale)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= 3e-2:
        fail(f"flash_prefill at {MOE_ARCH}'s heads differs from its plain version by {err}")
    pairs = B * H * sq * (sq + 1) // 2
    rows.append({
        "name": f"flash_prefill ({MOE_ARCH}, g 1)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:114", "counter": "flash_prefill",
        "shape": f"q/k/v ({B},{H},{sq},{hd}) bf16, causal", "max_abs_err": err,
        "tolerance": 3e-2,
        "ms": cold_ms(lambda: ops.flash_prefill(q, k, v, q_pos, scale), flush),
        "plain_ms": cold_ms(lambda: ref.flash_prefill_ref(q, k, v, q_pos, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), flush),
        **bound(2 * 4 * q.numel() + 4 * q_pos.numel(), 4 * hd * pairs, BF16_FLOPS)})
    S, n_valid = DECODE_S, DECODE_VALID
    q = rnd(B, H, 1, hd).bfloat16()
    k, v = rnd(B, H, S, hd).bfloat16(), rnd(B, H, S, hd).bfloat16()
    valid = torch.arange(S, device=dev) < n_valid
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
    m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, scale)
    err = (acc / l[..., None] - acc2 / l2[..., None]).abs().max().item()
    if not err <= 1e-3:
        fail(f"decode_attention at {MOE_ARCH}'s heads differs from its plain version by {err}")
    rows.append({
        "name": f"decode_attention_partial ({MOE_ARCH}, g 1)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:66", "counter": "decode_attention",
        "shape": f"q ({B},{H},1,{hd}) bf16, k/v ({B},{H},{S},{hd}), {n_valid} valid",
        "ptxas": ptxas_row("decode_attention", _dec(hd, False)),
        "max_abs_err": err, "tolerance": 1e-3,
        "ms": cold_ms(lambda: ops.decode_attention_partial(q, k, v, valid, scale), flush),
        "plain_ms": cold_ms(lambda: ref.decode_attention_ref(q, k, v, valid, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid[None, None, None, :], scale=scale), flush),
        **bound(2 * (q.numel() + 2 * B * H * n_valid * hd) + valid.numel()
                + 4 * (m.numel() + l.numel() + acc.numel()), 4 * hd * B * H * n_valid,
                BF16_FLOPS)})
    entry = None
    for T in ROUTER_T:
        probs = torch.softmax(rnd(T, 64), dim=-1)
        probs[:, 7] = probs[:, 3]                     # planted ties
        before = ops.LAUNCHES["topk"]
        vals, idx = ops.topk(probs, 6)
        if ops.LAUNCHES["topk"] != before + 1:
            fail("topk at the router shape made more than one launch")
        rv, ri = ref.topk_ref(probs, 6)
        if not (torch.equal(vals, rv) and torch.equal(idx, ri)):
            fail(f"topk at the router shape ({T}, 64) k 6 differs from its plain version")
        timed = {"shape": f"x ({T},64) fp32 softmax rows, k=6, tied columns",
                 "max_abs_err": 0.0, "tolerance": 0.0,
                 "ms": cold_ms(lambda: ops.topk(probs, 6), flush),
                 "plain_ms": cold_ms(lambda: ref.topk_ref(probs, 6), flush),
                 "library_ms": cold_ms(lambda: torch.topk(probs, 6), flush),
                 **bound(4 * probs.numel() + 8 * T * 6, probs.numel(), FP32_FLOPS)}
        if entry is None:
            entry = {"name": f"topk (router, {MOE_ARCH})", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/topk.cu",
                     "replaces": "src/repro/kernels/topk_shard.py:66", "counter": "topk",
                     **timed}
        else:
            entry[f"T{T}"] = timed
    rows.append(entry)
    for row in rows:
        row["arches"] = [MOE_ARCH]
    return rows


# -- mixture of experts over a sliding-window ring, and Mamba-2 SSD ------------
#
# mixtral-8x7b (32 local_attn layers, 32 q over 8 KV heads of 128, window
# 4096; 8 experts of 14336, top 2; int4 here, its bf16 weights, 93 GB, do not
# fit the card): the attention kernels at g 4, flash_prefill with the window
# and decode over a ring, the routing top-k over (T, 8), dequant_matmul for
# its int4 attention projections and lm_head; a chunk or a verify step into
# its slot ring attends in plain PyTorch (the reference's jnp).  mamba2-1.3b
# (48 SSD layers, tied embeddings, vocab 50280): its SSD is plain PyTorch
# (the reference's jnp), so only the sampling top-k launches a kernel.

RING_ARCH, SSD_ARCH = "mixtral-8x7b", "mamba2-1.3b"
RING_WINDOW, RING_HQ, RING_HKV, RING_VOCAB, SSD_VOCAB = 4096, 32, 8, 32000, 50280
# the ring phase: 4 prompts of 4040-4090 tokens into 4 slots, arriving 8
# steps apart, in chunks of 256 with spec decode of SPEC_K drafts, budgets
# of 64-128: every slot decodes past its 4100-entry ring (window + spec_k),
# so that verify chunks read and write a wrapped ring; while a later prompt
# streams in, the earlier slots decode in the mixed steps' decode halves,
# and two prompts' chunks together route 512 tokens beside the rows not
# admitted (``moe.RowLayout`` over the ring)
RING_PHASE = dict(requests=4, slots=4, prompt=(4040, 4090), max_new=(64, 128), chunk=256,
                  max_len=4224, arrival_every=8)
# the decode rows' ring: each row's query at its own position past the wrap
RING_S, RING_CUR = RING_WINDOW + SPEC_K, (4200, 4350, 5000, 8191)
DQ_RING_CASES = (("mixtral-8x7b w_q int4, decode", "int4", B, 4096, 4096, torch.bfloat16),
                 ("mixtral-8x7b lm_head int4, decode", "int4", B, 4096, RING_VOCAB,
                  torch.float32))


def check_ring_ssd_kernels(dev, flush) -> list:
    """mixtral-8x7b's and mamba2-1.3b's kernel rows: flash_prefill at
    (4, 32 over 8, 125, 128) with the 4096 window; decode_attention at
    (4, 32, 1, 128) over a wrapped 4100-entry ring, each row's 4096 live
    entries by its position stripe, and its int8 instance there; the
    routing top-k over (T, 8) fp32 softmax rows, k 2, T 4 and 500;
    dequant_matmul at mixtral's int4 w_q and lm_head at T 4; the sampling
    top-k over mamba2's vocab (4, 50280), k 1.  Each against its plain
    version (tolerances as the rows of the other shapes), with its time,
    SDPA's, torch.topk's or torch.matmul's, and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.runtime.kvcache import position_rows

    gen = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    sq, scale = 125, HD ** -0.5
    rows = []
    q = rnd(B, RING_HQ, sq, HD).bfloat16()
    k, v = (rnd(B, RING_HKV, sq, HD).bfloat16() for _ in range(2))
    q_pos = torch.arange(sq, device=dev, dtype=torch.int32).expand(B, -1).contiguous()
    call = lambda: ops.flash_prefill(q, k, v, q_pos, scale, window=RING_WINDOW)
    err = (call().float() - ref.flash_prefill_ref(q, k, v, q_pos, scale, window=RING_WINDOW)
           .float()).abs().max().item()
    if not err <= 3e-2:
        fail(f"flash_prefill at {RING_ARCH}'s heads differs from its plain version by {err}")
    pairs = B * RING_HQ * sq * (sq + 1) // 2
    rows.append({
        "name": f"flash_prefill ({RING_ARCH}, g 4, window {RING_WINDOW})", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:114", "counter": "flash_prefill",
        "shape": f"q ({B},{RING_HQ},{sq},{HD}) k/v ({B},{RING_HKV},{sq},{HD}) bf16, window "
                 f"{RING_WINDOW}", "max_abs_err": err, "tolerance": 3e-2,
        "ms": cold_ms(call, flush),
        "plain_ms": cold_ms(lambda: ref.flash_prefill_ref(q, k, v, q_pos, scale,
                                                          window=RING_WINDOW), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), flush),
        **bound(2 * (2 * q.numel() + 2 * k.numel()) + 4 * q_pos.numel(), 4 * HD * pairs,
                BF16_FLOPS)})
    cur = torch.tensor(RING_CUR, device=dev)
    pos = position_rows(cur + 1, RING_S, ring=True)          # the query's token written
    valid = (pos >= 0) & (pos <= cur[:, None]) & (pos > cur[:, None] - RING_WINDOW)
    n_valid = int(valid.sum())
    q = rnd(B, RING_HQ, 1, HD).bfloat16()
    k, v = (rnd(B, RING_HKV, RING_S, HD).bfloat16() for _ in range(2))
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
    m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, scale)
    err = (acc / l[..., None] - acc2 / l2[..., None]).abs().max().item()
    if not err <= 1e-3:
        fail(f"decode_attention over {RING_ARCH}'s ring differs from its plain version by {err}")
    ring = f"({B},{RING_HKV},{RING_S},{HD}), wrapped, {n_valid // B} live a row"
    rows.append({
        "name": f"decode_attention_partial ({RING_ARCH} ring)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:66", "counter": "decode_attention",
        "shape": f"q ({B},{RING_HQ},1,{HD}) bf16, k/v {ring}",
        "ptxas": ptxas_row("decode_attention", _dec(HD, False)),
        "max_abs_err": err, "tolerance": 1e-3,
        "ms": cold_ms(lambda: ops.decode_attention_partial(q, k, v, valid, scale), flush),
        "plain_ms": cold_ms(lambda: ref.decode_attention_ref(q, k, v, valid, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid[:, None, None, :], scale=scale, enable_gqa=True), flush),
        **bound(2 * q.numel() + 4 * RING_HKV * n_valid * HD + valid.numel()
                + 4 * (m.numel() + l.numel() + acc.numel()), 4 * HD * RING_HQ * n_valid,
                BF16_FLOPS)})
    (kq, ks), (vq, vs) = ref.quantize_kv(k), ref.quantize_kv(v)
    rows.append({"name": f"decode_attention_partial (int8), {RING_ARCH} ring", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "replaces": "src/repro/kernels/decode_attention.py:66",
                 "counter": "decode_attention_int8",
                 "shape": f"q ({B},{RING_HQ},1,{HD}) bf16, int8 k/v {ring}, bf16 scales",
                 "ptxas": ptxas_row("decode_attention", _dec(HD, False, q8=True)),
                 **int8_decode_case(q, kq, ks, vq, vs, valid, scale, flush)})
    entry = None
    for T in ROUTER_T:
        probs = torch.softmax(rnd(T, 8), dim=-1)
        probs[:, 5] = probs[:, 2]                     # planted ties
        before = ops.LAUNCHES["topk"]
        vals, idx = ops.topk(probs, 2)
        if ops.LAUNCHES["topk"] != before + 1:
            fail("topk at mixtral's router shape made more than one launch")
        rv, ri = ref.topk_ref(probs, 2)
        if not (torch.equal(vals, rv) and torch.equal(idx, ri)):
            fail(f"topk at mixtral's router shape ({T}, 8) k 2 differs from its plain version")
        timed = {"shape": f"x ({T},8) fp32 softmax rows, k=2, tied columns",
                 "max_abs_err": 0.0, "tolerance": 0.0,
                 "ms": cold_ms(lambda: ops.topk(probs, 2), flush),
                 "plain_ms": cold_ms(lambda: ref.topk_ref(probs, 2), flush),
                 "library_ms": cold_ms(lambda: torch.topk(probs, 2), flush),
                 **bound(4 * probs.numel() + 8 * T * 2, probs.numel(), FP32_FLOPS)}
        if entry is None:
            entry = {"name": f"topk (router, {RING_ARCH})", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/topk.cu",
                     "replaces": "src/repro/kernels/topk_shard.py:66", "counter": "topk",
                     **timed}
        else:
            entry[f"T{T}"] = timed
    rows.append(entry)
    rows.append(check_dequant(dev, flush, DQ_RING_CASES, f"dequant_matmul ({RING_ARCH} int4)"))
    for row in rows:
        row["arches"] = [RING_ARCH]
    x = rnd(B, SSD_VOCAB).float()
    vals, idx = ops.topk(x, 1)
    rv, ri = ref.topk_ref(x, 1)
    if not (torch.equal(vals, rv) and torch.equal(idx, ri)):
        fail(f"topk over {SSD_ARCH}'s vocab differs from its plain version")
    rows.append({"name": f"topk ({SSD_ARCH} vocab)", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/topk.cu",
                 "replaces": "src/repro/kernels/topk_shard.py:66", "counter": "topk",
                 "shape": f"x ({B},{SSD_VOCAB}) fp32, k=1", "max_abs_err": 0.0,
                 "tolerance": 0.0, "ms": cold_ms(lambda: ops.topk(x, 1), flush),
                 "plain_ms": cold_ms(lambda: ref.topk_ref(x, 1), flush),
                 "library_ms": cold_ms(lambda: torch.topk(x, 1), flush),
                 **bound(4 * x.numel() + 8 * B, x.numel(), FP32_FLOPS), "arches": [SSD_ARCH]})
    return rows


def moe_parting(cfg, cpu, gpu, dev, seq: np.ndarray, token: int, kv_quant: bool) -> dict:
    """A parting of the card's stream (its ``token``) from the CPU's after
    ``seq``: the prefill logits of ``seq`` (through an int8 cache with
    ``kv_quant``) on the card, then on the CPU replaying the card's expert
    choices; certified where they lie within REF_TOL and either the CPU's
    top-2 gap is below TIE_GAP, the card's token lies within REF_TOL of the
    CPU's top, or the card routed some token apart (a router near-tie,
    ``card_routes``); fails otherwise."""
    from repro_torch.models import model as M

    t = torch.from_numpy(seq)[None].long()
    caches = lambda d: M.init_caches(cfg, 1, len(seq), device=d, kv_quant=kv_quant)
    with torch.inference_mode(), card_routes() as replay:
        lg = M.forward(gpu, t.to(dev), cfg, caches=caches(dev), last_only=True).cpu()[0, -1]
        lc, ties = replay(lambda: M.forward(cpu, t, cfg, caches=caches("cpu"),
                                            last_only=True)[0, -1])
    err = (lc - lg).abs().max().item()
    gap = float((lambda v: v[0] - v[1])(torch.topk(lc, 2).values))
    slack = float(lc.max() - lc[token])
    if not (err <= REF_TOL and (gap < TIE_GAP or slack < REF_TOL or ties)):
        fail(f"small {cfg.name}: card and CPU part after {len(seq)} tokens: logits "
             f"{err} apart, CPU top-2 gap {gap}, the card's token {slack} below the top, "
             f"{len(ties)} router near-ties")
    return {"after": len(seq), "replayed_max_abs_err": err, "top2_gap": gap,
            "card_token_slack": slack, "router_ties": len(ties)}


def ring_ssd_reference_check(dev) -> list:
    """Reduced mixtral-8x7b (window 64) in bf16, int4 and over the int8 KV
    cache, and reduced mamba2-1.3b, on the card against the same weights
    on the CPU, where the plain versions run.  mixtral: a 72-token prompt
    into a 64-entry wave ring and 8 decode steps (every forward replaying
    the card's expert choices on the CPU, ``routed_teacher_forced``)
    within REF_TOL; and the continuous scheduler in chunks of 16 with spec
    decode of 4 drafts (a 68-entry ring), 3 slots, prompts of 34..64 and
    budgets that decode past the wrap: the greedy streams equal, or parted
    where ``moe_parting`` certifies.  mamba2: a 3 x 20-token prefill and 8
    decode steps, logits within REF_TOL and the recurrent state (h, conv)
    within 2e-2 of its largest value; the wave, the continuous scheduler
    and the paged pool (no block reserved): the greedy streams equal, or
    parted at a CPU top-2 gap below TIE_GAP."""
    import argparse

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import (ContinuousScheduler, PagedContinuousScheduler,
                                               WaveScheduler)

    out = []
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 512, int(rng.integers(34, 65))).astype(np.int32),
             int(rng.integers(30, 45)), 2 * i) for i in range(6)]
    for mode, kvq in (("none", False), ("int4", False), ("none", True)):
        cfg, cpu, gpu = small_model(dev, RING_ARCH, mode)
        worst, ties = routed_teacher_forced(cfg, cpu, gpu, dev, plen=72, kv_quant=kvq)
        if not worst <= REF_TOL:
            fail(f"small {RING_ARCH} {mode} kv_quant={kvq}: card logits differ from the "
                 f"CPU's by {worst}")
        par = ParallelConfig(weight_quant=mode, kv_quant=kvq)
        streams, st = {}, {}
        for d, params in (("cpu", cpu), (dev, gpu)):
            eng = Engine(cfg, parallel=par, sampling=SamplingConfig(top_k=1), max_len=128,
                         params=params, device=d)
            sched = ContinuousScheduler(eng, n_slots=3, prefill_chunk=16, spec_k=SPEC_K)
            for p, m, arrival in reqs:
                sched.submit(p, m, arrival_step=arrival)
            streams[str(d)] = {r.rid: r for r in sched.run()}
            st[str(d)] = dict(sched.stats)
            if not (sched.stats["spec_steps"] and sched.stats["chunked_admissions"]
                    and sched.caches["pos"].max().item() >= cfg.window + SPEC_K):
                fail(f"small {RING_ARCH}: no verify step, no chunked admission or no wrap: "
                     f"{sched.stats}")
        parted = parted_streams(streams["cpu"], streams[str(dev)], lambda seq, tok: moe_parting(
            cfg, cpu, gpu, dev, seq, tok, kvq))
        out.append({"config": cfg.name, "weight_quant": mode, "kv_quant": kvq,
                    "max_abs_logit_err": worst, "tolerance": REF_TOL,
                    "router_ties_replayed": len(ties),
                    "chunked_spec_requests": len(reqs), "ring": cfg.window + SPEC_K,
                    "spec_steps": st[str(dev)]["spec_steps"], "parted": parted})
    cfg, cpu, gpu = small_model(dev, SSD_ARCH)
    worst, caches = teacher_forced(cfg, cpu, gpu, dev)
    state = {key: ((caches[dev][key].float().cpu() - caches["cpu"][key].float()).abs().max()
                   / caches["cpu"][key].float().abs().max()).item() for key in ("h", "conv")}
    if not (worst <= REF_TOL and max(state.values()) <= 2e-2):
        fail(f"small {SSD_ARCH}: card logits {worst} from the CPU's, state {state}")
    rows = {"config": cfg.name, "max_abs_logit_err": worst, "tolerance": REF_TOL,
            "state_rel_err": state, "state_tolerance": 2e-2}
    wave_reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(10, 33))).astype(np.int32),
                  12) for _ in range(6)]
    make = {"wave": lambda e: WaveScheduler(e, 3),
            "continuous": lambda e: ContinuousScheduler(e, n_slots=3, prefill_chunk=0),
            "paged": lambda e: PagedContinuousScheduler(e, n_slots=3, prefill_chunk=0,
                                                        block_size=8)}
    for kind, mk in make.items():
        streams = {}
        for d, params in (("cpu", cpu), (dev, gpu)):
            eng = Engine(cfg, sampling=SamplingConfig(top_k=1), max_len=128, params=params,
                         device=d)
            sched = mk(eng)
            if kind == "wave":
                for p, m in wave_reqs:
                    sched.submit(p, m)
            else:
                serve.submit_workload(sched, cfg, argparse.Namespace(
                    requests=8, shared_prefix=16, prompt_len=24, max_new=12, max_new_spread=4,
                    arrival_every=2))
            streams[str(d)] = {r.rid: r for r in sched.run()}
            if kind == "paged" and sched.stats["blocks_hwm"] != 0:
                fail(f"small {SSD_ARCH}: the paged pool reserved blocks: {sched.stats}")

        def gap(seq, tok):
            with torch.inference_mode():
                lc = M.forward(cpu, torch.from_numpy(seq)[None].long(), cfg,
                               last_only=True)[0, -1]
            g = float((lambda v: v[0] - v[1])(torch.topk(lc, 2).values))
            if not g < TIE_GAP:
                fail(f"small {SSD_ARCH} {kind}: card and CPU part after {len(seq)} tokens, "
                     f"CPU top-2 gap {g}")
            return {"top2_gap": g}

        rows[f"{kind}_parted"] = parted_streams(streams["cpu"], streams[str(dev)], gap)
        rows[f"{kind}_requests"] = len(streams["cpu"])
    out.append(rows)
    return out


def ring_slot_phase(dev, params, kv_quant: bool, want=None) -> dict:
    """Full-width mixtral-8x7b int4 (on the wave phase's weights ``params``)
    through the ContinuousScheduler over RING_PHASE: chunks of 256 with spec
    decode of SPEC_K drafts into a 4100-entry slot ring, every slot decoding
    past it.  Tokens in range, launches as the scheduler's stats predict
    them (no attention kernel in a chunk or a verify step: they attend in
    plain PyTorch), chunked admission, decode during admission, verify
    steps, mixed steps carrying the rows not admitted and the ring's wrap
    (its position rows hold positions past 4100); over the int8 cache
    (``kv_quant``) the streams equal to the bf16 run's (``want``) counted.
    One run each (the wave phase on the same weights runs twice): peak
    memory and ms/token."""
    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import ContinuousScheduler

    t_phase = time.monotonic()
    cfg = phase_config(RING_ARCH)
    o = RING_PHASE
    parallel = ParallelConfig(weight_quant="int4", kv_quant=kv_quant)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = Engine(cfg, parallel=parallel, sampling=SamplingConfig(top_k=1),
                 max_len=o["max_len"], seed=0, params=params, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rng = np.random.default_rng(6)
    work = [(rng.integers(0, cfg.vocab_size, int(rng.integers(o["prompt"][0], o["prompt"][1] + 1)))
             .astype(np.int32), int(rng.integers(o["max_new"][0], o["max_new"][1] + 1)))
            for _ in range(o["requests"])]

    layouts = []
    layout = eng._layout

    def counted_layout(*args):
        """The engine's RowLayout, noting each mixed step that carries one."""
        lay = layout(*args)
        layouts.append(lay is not None)
        return lay

    eng._layout = counted_layout

    def run():
        layouts.clear()
        sched = ContinuousScheduler(eng, n_slots=o["slots"], prefill_chunk=o["chunk"],
                                    spec_k=SPEC_K)
        for i, (p, m) in enumerate(work):
            sched.submit(p, m, arrival_step=i * o["arrival_every"])
        torch.cuda.synchronize()
        t = time.monotonic()
        done = sched.run()
        torch.cuda.synchronize()
        return sched, {r.rid: r.output for r in done}, time.monotonic() - t

    ops.reset_launches()
    with drop_log() as drops:
        sched, first, dt1 = run()
    launches = dict(ops.LAUNCHES)
    st = sched.stats
    L = cfg.n_layers
    per_forward = dequant_launches_per_forward(cfg, parallel)
    expect = expected_slot_launches("dense", st, L, kv_quant=kv_quant, moe=moe_layers(cfg),
                                    ring=True, dequant=per_forward)
    # a mixed step whose chunk rows are not all the slots routes them beside
    # the others (B x 256 > 256 tokens): their projections are matmuls too,
    # their attention plain PyTorch (the ring branch) and their routing the
    # same top-k launch
    carried = sum(layouts)
    expect["dequant_matmul"] += (per_forward - 1) * carried
    if launches != expect:
        fail(f"{RING_ARCH} ring kv_quant={kv_quant}: kernel launches {launches} != expected "
             f"{expect} (stats {st})")
    S = sched.caches["pos"].shape[1]
    wrapped = int(sched.caches["pos"].max())
    if not (S == RING_WINDOW + SPEC_K and wrapped >= S and st["chunked_admissions"]
            and st["mixed_decode_steps"] and st["spec_steps"]
            and all(len(p) + len(first[i]) > S for i, (p, _) in enumerate(work))):
        fail(f"{RING_ARCH} ring: no chunked admission, no decode during admission, no "
             f"verify step or no slot past the {S}-entry ring (largest position held "
             f"{wrapped}): {st}")
    for rid, toks in first.items():
        if len(toks) != work[rid][1] or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"{RING_ARCH} ring request {rid}: tokens out of range or wrong count")
    n_tokens = sum(len(t) for t in first.values())
    result = {
        "arch": cfg.name, "scheduler": "continuous-chunked-spec (ring)", "weight_quant": "int4",
        "kv_quant": kv_quant, "layers": L, "params": cfg.param_count(),
        "requests": o["requests"], "slots": o["slots"], "arrival_every": o["arrival_every"],
        "ring_entries": S,
        "largest_position_held": wrapped, "mixed_steps_carrying_other_rows": carried,
        "options": {"prefill_chunk": o["chunk"], "spec_k": SPEC_K},
        "prompt_lens": [len(p) for p, _ in work], "max_new": [m for _, m in work],
        "tokens": n_tokens, "init_s": init_s, "wall_s": [dt1],
        "ms_per_token": [1e3 * dt1 / n_tokens], "stats": dict(st),
        "summary": sched.request_summary(), "launches": launches,
        "moe_drops": {k: v for k, v in drops.items() if k != "per_call"}}
    if want is not None:
        result["equal_to_bf16_kv_streams"] = sum(np.array_equal(t, want[rid])
                                                 for rid, t in first.items())
    result.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  kv_cache_gib=sum(t.numel() * t.element_size() for key, t in
                                   sched.caches.items() if key != "pos") / 2**30,
                  phase_s=time.monotonic() - t_phase)
    if not carried:
        fail(f"{RING_ARCH} ring: no mixed step carried the rows not admitted")
    del eng._layout         # the wrapper holds the engine: free it with the phase
    del eng, sched
    torch.cuda.empty_cache()
    return result, first


def ssd_slot_phases(dev, params) -> list:
    """Full-width mamba2-1.3b bf16 (the wave phase's weights ``params``)
    through the ContinuousScheduler and the PagedContinuousScheduler on
    the slot phases' workload, whole prompts (its recurrent state refuses
    chunks and verify steps), twice each: tokens in range, the second run
    identical, launches as predicted (the sampling top-k alone), the paged
    pool reserving no block (``blocks_hwm`` 0) and its audit passing, and
    the paged streams equal to the dense ones or parted at a top-2 gap
    below TIE_GAP."""
    import argparse

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler

    cfg = phase_config(SSD_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = Engine(cfg, parallel=ParallelConfig(kv_block_size=BLOCK),
                 sampling=SamplingConfig(top_k=1), max_len=SERVE_MAX_LEN, seed=0,
                 params=params, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    results, tokens = [], {}
    for name, cls in (("continuous", ContinuousScheduler), ("paged", PagedContinuousScheduler)):
        t_phase = time.monotonic()
        torch.cuda.reset_peak_memory_stats()

        def run():
            sched = cls(eng, n_slots=SLOTS, prefill_chunk=0)
            serve.submit_workload(sched, cfg, argparse.Namespace(**SLOT_WORKLOAD))
            torch.cuda.synchronize()
            t = time.monotonic()
            done = sched.run()
            torch.cuda.synchronize()
            return sched, {r.rid: r for r in done}, time.monotonic() - t

        ops.reset_launches()
        sched, first, dt1 = run()
        launches = dict(ops.LAUNCHES)
        _, second, dt2 = run()
        st = sched.stats
        expect = expected_slot_launches("paged" if name == "paged" else "dense", st, 0)
        if launches != expect:
            fail(f"{SSD_ARCH} {name}: kernel launches {launches} != expected {expect} ({st})")
        if name == "paged":
            if st["blocks_hwm"] != 0:
                fail(f"{SSD_ARCH} paged: the pool reserved blocks for an attention-free model")
            try:
                sched.alloc.audit()
            except AssertionError as e:
                fail(f"{SSD_ARCH} paged: block allocator audit: {e}")
        for rid, r in first.items():
            if not (len(r.output) and ((r.output >= 0) & (r.output < cfg.vocab_size)).all()):
                fail(f"{SSD_ARCH} {name} request {rid}: tokens out of range or none")
            if not np.array_equal(r.output, second[rid].output):
                fail(f"{SSD_ARCH} {name} request {rid}: greedy tokens differ between two runs")
        tokens[name] = first
        if name == "paged":       # phase 9's paged job is held to these
            TP1_STREAMS[(cfg.name, "none", "paged")] = (cfg.n_layers, {rid: r.output for rid, r
                                                                      in first.items()})
        n_tokens = sum(len(r.output) for r in first.values())
        result = {"arch": cfg.name, "scheduler": name, "kv_quant": False, "layers": cfg.n_layers,
                  "params": cfg.param_count(), "requests": SLOT_WORKLOAD["requests"],
                  "slots": SLOTS, "max_len": SERVE_MAX_LEN, "workload": SLOT_WORKLOAD,
                  "tokens": n_tokens, "init_s": init_s, "wall_s": [dt1, dt2],
                  "ms_per_token": [1e3 * dt1 / n_tokens, 1e3 * dt2 / n_tokens],
                  "stats": dict(st), "summary": sched.request_summary(),
                  "launches": launches, "repeatable": True,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if name == "paged":
            flips = []
            for rid, r in tokens["continuous"].items():
                a, b = r.output, first[rid].output
                if np.array_equal(a, b):
                    continue
                n = min(len(a), len(b))
                t = int(np.argmax(a[:n] != b[:n])) if (a[:n] != b[:n]).any() else n
                with torch.inference_mode():
                    lg = M.forward(eng.params, torch.as_tensor(np.concatenate(
                        [r.prompt, a[:t]]), device=dev)[None].long(), cfg, last_only=True,
                        head_f32=eng.head_f32)[0, -1]
                gap = float((lambda v: v[0] - v[1])(torch.topk(lg, 2).values))
                if not gap < TIE_GAP:
                    fail(f"{SSD_ARCH} paged request {rid} parts from dense at step {t}, gap {gap}")
                flips.append({"rid": rid, "step": t, "top2_gap": gap})
            result["parted_from_dense_at_near_ties"] = flips
        result["phase_s"] = time.monotonic() - t_phase
        results.append(result)
    del eng
    torch.cuda.empty_cache()
    return results


def ring_ssd_phases(dev):
    """mixtral-8x7b int4 at its cut depth (4 of 32 layers): phase 5's wave
    workload, then the ring phase in bf16 K/V and over the int8 cache, on
    the same weights; mamba2-1.3b bf16 at its cut depth (8 of 48 layers):
    phase 5's wave workload, then the continuous and paged slot phases, on
    the same weights."""
    phase, params = serve_phase(dev, RING_ARCH, "int4")
    yield phase
    ring, streams = ring_slot_phase(dev, params, False)
    yield ring
    yield ring_slot_phase(dev, params, True, want=streams)[0]
    del params
    torch.cuda.empty_cache()
    phase, params = serve_phase(dev, SSD_ARCH, "none")
    yield phase
    yield from ssd_slot_phases(dev, params)
    del params
    torch.cuda.empty_cache()


def check_tp_rank_kernels(dev, flush) -> list:
    """The kernels at a tp=2 rank's shapes of phase 9's RG-LRU, MoE and
    frontend jobs: lru_scan over recurrentgemma-9b's (4, 2304, 2048), a
    rank's half of the 4096 channels; decode_attention at its (4, 8, 1,
    256), a rank's 8 q heads over the replicated KV head, over the
    2048-entry ring, at mixtral-8x7b's (4, 16 over 4, 1, 128) over the
    wrapped 4100-entry ring and at internvl2-26b's (4, 24 over 4, 1, 128)
    over its 448-entry cache; the top-k over musicgen-medium's (16, 1024)
    shard of a step's frames, k 1; dequant_matmul at internvl2-26b's int4
    lm_head rank shard (4, 6144) @ (6144, 46277).  Each held to its plain
    version as the tp=1 rows are, with its time, SDPA's, torch.topk's or
    torch.matmul's (none for lru_scan) and its bound; its launches are
    counted on the tp phases only (``tp_only``), summed over the ranks."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.runtime.kvcache import position_rows

    gen = torch.Generator(device=dev).manual_seed(13)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    rows = []
    w = RG_W // TP
    a, x, h0 = torch.sigmoid(rnd(B, RG_SQ, w)), rnd(B, RG_SQ, w), rnd(B, w)
    hs, hT = ops.lru_scan(a, x, h0)
    want, want_T = ref.lru_scan_ref(a, x, h0)
    err = max((hs - want).abs().max().item(), (hT - want_T).abs().max().item())
    del want
    lim = ref.lru_scan_limit(a, x, h0)
    kern64 = max((hs.double() - lim["want"]).abs().max().item(),
                 (hT.double() - lim["want_T"]).abs().max().item())
    if not kern64 <= lim["limit"]:
        fail(f"lru_scan at a tp=2 rank's ({B}, {RG_SQ}, {w}): error {kern64} against fp64 > "
             f"{lim['limit']} (the plain version's {lim['plain']})")
    rows.append({
        "name": f"lru_scan ({RG_ARCH} tp=2 rank)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/lru_scan.py:39", "counter": "lru_scan",
        "arches": [RG_ARCH], "tp_only": True,
        "shape": f"a, b ({B},{RG_SQ},{w}) fp32, h0 ({B},{w}): {w} of {RG_W} channels",
        "library": "none: no single PyTorch call computes a linear recurrence",
        "max_abs_err": err, "err_fp64": kern64, "plain_err_fp64": lim["plain"],
        "tolerance": f"fp64 error <= max({ref.LRU_ERR_FACTOR} x plain's, "
                     f"{ref.LRU_ERR_FLOOR} max|h|) = {lim['limit']}",
        "ms": cold_ms(lambda: ops.lru_scan(a, x, h0), flush),
        "plain_ms": cold_ms(lambda: ref.lru_scan_ref(a, x, h0), flush, iters=3, warmup=1),
        "library_ms": None,
        **bound(4 * (3 * a.numel() + 2 * h0.numel()), 2 * a.numel(), FP32_FLOPS)})
    del a, x, h0, hs, lim

    def decode_row(name, arch, hq, hkv, hd, S, valid, what):
        scale = hd ** -0.5
        q = rnd(B, hq, 1, hd).bfloat16()
        k, v = (rnd(B, hkv, S, hd).bfloat16() for _ in range(2))
        m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
        m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, scale)
        err = (acc / l[..., None] - acc2 / l2[..., None]).abs().max().item()
        if not err <= 1e-3:
            fail(f"decode_attention at {name} differs from its plain version by {err}")
        n_valid = int(valid.sum())
        return {
            "name": f"decode_attention_partial ({name})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:66",
            "counter": "decode_attention", "arches": [arch], "tp_only": True,
            "shape": f"q ({B},{hq},1,{hd}) bf16, k/v ({B},{hkv},{S},{hd}) {what} "
                     f"({n_valid} valid)",
            "library": "SDPA with a per-row bool mask",
            "ptxas": ptxas_row("decode_attention", _dec(hd, False)),
            "max_abs_err": err, "tolerance": 1e-3,
            "ms": cold_ms(lambda: ops.decode_attention_partial(q, k, v, valid, scale), flush),
            "plain_ms": cold_ms(lambda: ref.decode_attention_ref(q, k, v, valid, scale), flush),
            "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=valid[:, None, None, :], scale=scale, enable_gqa=True),
                flush),
            **bound(2 * q.numel() + 4 * hkv * n_valid * hd + valid.numel()
                    + 4 * (m.numel() + l.numel() + acc.numel()), 4 * hd * hq * n_valid,
                    BF16_FLOPS)}

    idx = torch.arange(RG_WINDOW, device=dev)
    frontiers = [2300, 2047, 1500, 3000]
    valid = torch.stack([(f - (f - idx) % RG_WINDOW >= 0) for f in frontiers]).contiguous()
    rows.append(decode_row(f"{RG_ARCH} tp=2 rank, g 8", RG_ARCH, RG_HQ // TP, 1, RG_HD,
                           RG_WINDOW, valid, f"ring, window masks at {frontiers}"))
    cur = torch.tensor(RING_CUR, device=dev)
    pos = position_rows(cur + 1, RING_S, ring=True)
    valid = (pos >= 0) & (pos <= cur[:, None]) & (pos > cur[:, None] - RING_WINDOW)
    rows.append(decode_row(f"{RING_ARCH} tp=2 rank ring, g 4", RING_ARCH, RING_HQ // TP,
                           RING_HKV // TP, HD, RING_S, valid, "wrapped ring"))
    # internvl2-26b: a rank's 24 q over 4 KV heads behind the prefix
    S, lens = FRONTEND_DECODE[VLM_ARCH]
    valid = torch.arange(S, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
    rows.append(decode_row(f"{VLM_ARCH} tp=2 rank, g 6", VLM_ARCH, VLM_HQ // TP, VLM_HKV // TP,
                           HD, S, valid, f"valid {list(lens)}"))
    # musicgen-medium: the shard's top-k over a rank's (b x 4, 2048 / 2) frames
    x = rnd(B * AUD_NCB, AUD_VOCAB // TP).float()
    before = ops.LAUNCHES["topk"]
    vals, idx = ops.topk(x, 1)
    if ops.LAUNCHES["topk"] != before + 1:
        fail(f"topk over a {AUD_ARCH} tp=2 rank's frames made more than one launch")
    rv, ri = ref.topk_ref(x, 1)
    if not (torch.equal(vals, rv) and torch.equal(idx, ri)):
        fail(f"topk over a {AUD_ARCH} tp=2 rank's {tuple(x.shape)} frames differs from its "
             f"plain version")
    rows.append({
        "name": f"topk ({AUD_ARCH} tp=2 rank frames)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk_shard.py:66", "counter": "topk",
        "arches": [AUD_ARCH], "tp_only": True,
        "shape": f"x ({B * AUD_NCB},{AUD_VOCAB // TP}) fp32, k=1: a rank's half of {AUD_NCB} "
                 f"codebooks' vocab, b {B}",
        "library": "torch.topk", "max_abs_err": 0.0, "tolerance": 0.0,
        "ms": cold_ms(lambda: ops.topk(x, 1), flush),
        "plain_ms": cold_ms(lambda: ref.topk_ref(x, 1), flush),
        "library_ms": cold_ms(lambda: torch.topk(x, 1), flush),
        **bound(4 * x.numel() + 8 * x.shape[0], x.numel(), FP32_FLOPS)})
    # internvl2-26b int4: a rank's lm_head shard, 46277 columns (N % 16 != 0)
    lv = -(-VLM_VOCAB // TP)
    dq = check_dequant(dev, flush, (("internvl2-26b lm_head int4 tp=2 shard, decode", "int4", B,
                                     VLM_D, lv, torch.float32),),
                       f"dequant_matmul ({VLM_ARCH} int4 tp=2 rank lm_head)")
    rows.append({**dq, "arches": [VLM_ARCH], "tp_only": True})
    return rows


# -- the modality prefix and the multi-codebook head ---------------------------
#
# internvl2-26b (a 256-position vision prefix projected from 3200-wide stub
# features, then an InternLM2 backbone of 48 layers, 48 q over 8 KV heads of
# 128, vocab 92553; 19.86 B, 39.7 GB in bf16) and musicgen-medium (a
# 64-position audio prefix of 768-wide features, then 48 layers of 24 MHA
# heads of 64, a plain GELU FFN, 4 codebooks of 2048 summed at the
# embedding and sampled per codebook; 1.38 B).  The projector, the codebook
# sum and the multi-codebook head are plain PyTorch (the reference's jnp);
# the attention kernels run over prefix + prompt, and the top-k samples
# internvl's 92553-wide rows and musicgen's (b * 4, 2048) frames.

VLM_ARCH, AUD_ARCH = "internvl2-26b", "musicgen-medium"
VLM_HQ, VLM_HKV, VLM_PREFIX, VLM_VOCAB, VLM_D = 48, 8, 256, 92553, 6144
AUD_H, AUD_HD, AUD_PREFIX, AUD_NCB, AUD_VOCAB = 24, 64, 64, 4, 2048
# a cache holds the prefix, the longest prompt (the wave's 128 tokens, or
# the slot workload's 64 + 64 shared) and 32 new
FRONTEND_MAX_LEN = {VLM_ARCH: 448, AUD_ARCH: 256}
# the decode rows' cache: each row's valid length (prefix + prompt + steps)
FRONTEND_DECODE = {VLM_ARCH: (448, (300, 350, 400, 413)), AUD_ARCH: (256, (100, 150, 189, 221))}
DQ_VLM_CASES = (("internvl2-26b w_q int4, decode", "int4", B, VLM_D, VLM_D, torch.bfloat16),
                ("internvl2-26b lm_head int4, decode", "int4", B, VLM_D, VLM_VOCAB,
                 torch.float32))


def check_frontend_kernels(dev, flush) -> list:
    """internvl2-26b's and musicgen-medium's kernel rows: flash_prefill over
    prefix + a 125-token prompt at (4, 48 over 8, 381, 128) and (4, 24, 189,
    64); decode_attention at (4, 48, 1, 128) over a 448-entry cache and (4,
    24, 1, 64) over a 256-entry one, each row's valid length its own, and
    internvl's int8 instance; the sampling top-k over internvl's (4, 92553)
    rows and musicgen's (16, 2048) frames, k 1; dequant_matmul at internvl's
    int4 w_q and lm_head (N 92553, no 16-byte weight rows); kv_quant_write
    of internvl's slot admission and slot decode.  Each against its plain
    version (tolerances as the rows of the other shapes), with its time,
    SDPA's, torch.topk's or torch.matmul's, and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention as attn

    gen = torch.Generator(device=dev).manual_seed(12)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    heads = {VLM_ARCH: (VLM_HQ, VLM_HKV, HD, VLM_PREFIX),
             AUD_ARCH: (AUD_H, AUD_H, AUD_HD, AUD_PREFIX)}
    rows = []
    for arch, (hq, hkv, hd, prefix) in heads.items():
        sq, scale = prefix + 125, hd ** -0.5
        q = rnd(B, hq, sq, hd).bfloat16()
        k, v = (rnd(B, hkv, sq, hd).bfloat16() for _ in range(2))
        q_pos = torch.arange(sq, device=dev, dtype=torch.int32).expand(B, -1).contiguous()
        err = (ops.flash_prefill(q, k, v, q_pos, scale).float()
               - ref.flash_prefill_ref(q, k, v, q_pos, scale).float()).abs().max().item()
        if not err <= 3e-2:
            fail(f"flash_prefill at {arch}'s heads differs from its plain version by {err}")
        pairs = B * hq * sq * (sq + 1) // 2
        rows.append({
            "name": f"flash_prefill ({arch}, g {hq // hkv}, head_dim {hd})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
            "replaces": "src/repro/kernels/prefill_attention.py:114", "counter": "flash_prefill",
            "shape": f"q ({B},{hq},{sq},{hd}) k/v ({B},{hkv},{sq},{hd}) bf16, causal over "
                     f"{prefix} prefix + 125 prompt positions", "max_abs_err": err,
            "tolerance": 3e-2, "ms": cold_ms(lambda: ops.flash_prefill(q, k, v, q_pos, scale),
                                             flush),
            "plain_ms": cold_ms(lambda: ref.flash_prefill_ref(q, k, v, q_pos, scale), flush),
            "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale, enable_gqa=True), flush),
            **bound(2 * (2 * q.numel() + 2 * k.numel()) + 4 * q_pos.numel(), 4 * hd * pairs,
                    BF16_FLOPS), "arches": [arch]})
        S, lens = FRONTEND_DECODE[arch]
        valid = torch.arange(S, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        q = rnd(B, hq, 1, hd).bfloat16()
        k, v = (rnd(B, hkv, S, hd).bfloat16() for _ in range(2))
        m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
        m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, scale)
        err = (acc / l[..., None] - acc2 / l2[..., None]).abs().max().item()
        if not err <= 1e-3:
            fail(f"decode_attention at {arch}'s heads differs from its plain version by {err}")
        n_valid = sum(lens)
        shape = f"q ({B},{hq},1,{hd}) bf16, k/v ({B},{hkv},{S},{hd}), valid {list(lens)}"
        rows.append({
            "name": f"decode_attention_partial ({arch}, g {hq // hkv}, head_dim {hd})",
            "route": "cuda", "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:66",
            "counter": "decode_attention", "shape": shape, "max_abs_err": err, "tolerance": 1e-3,
            "ms": cold_ms(lambda: ops.decode_attention_partial(q, k, v, valid, scale), flush),
            "plain_ms": cold_ms(lambda: ref.decode_attention_ref(q, k, v, valid, scale), flush),
            "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=valid[:, None, None, :], scale=scale, enable_gqa=True),
                flush),
            **bound(2 * q.numel() + 4 * hkv * n_valid * hd + valid.numel()
                    + 4 * (m.numel() + l.numel() + acc.numel()), 4 * hd * hq * n_valid,
                    BF16_FLOPS), "arches": [arch]})
        if arch == VLM_ARCH:
            (kq, ks), (vq, vs) = ref.quantize_kv(k), ref.quantize_kv(v)
            rows.append({"name": f"decode_attention_partial (int8), {arch}", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                         "replaces": "src/repro/kernels/decode_attention.py:66",
                         "counter": "decode_attention_int8",
                         "shape": shape.replace("), valid", ") int8, bf16 scales, valid"),
                         **int8_decode_case(q, kq, ks, vq, vs, valid, scale, flush),
                         "arches": [arch]})
            del kq, ks, vq, vs
        del q, k, v
    entry = None
    for n_rows, n, arch in ((B, VLM_VOCAB, VLM_ARCH), (B * AUD_NCB, AUD_VOCAB, AUD_ARCH)):
        x = rnd(n_rows, n).float()
        before = ops.LAUNCHES["topk"]
        vals, idx = ops.topk(x, 1)
        if ops.LAUNCHES["topk"] != before + 1:
            fail(f"topk over {arch}'s rows made more than one launch")
        rv, ri = ref.topk_ref(x, 1)
        if not (torch.equal(vals, rv) and torch.equal(idx, ri)):
            fail(f"topk over {arch}'s ({n_rows}, {n}) rows differs from its plain version")
        timed = {"shape": f"x ({n_rows},{n}) fp32, k=1", "max_abs_err": 0.0, "tolerance": 0.0,
                 "ms": cold_ms(lambda: ops.topk(x, 1), flush),
                 "plain_ms": cold_ms(lambda: ref.topk_ref(x, 1), flush),
                 "library_ms": cold_ms(lambda: torch.topk(x, 1), flush),
                 **bound(4 * x.numel() + 8 * n_rows, x.numel(), FP32_FLOPS)}
        if entry is None:
            entry = {"name": f"topk ({VLM_ARCH} vocab, {AUD_ARCH} frames)", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/topk.cu",
                     "replaces": "src/repro/kernels/topk_shard.py:66", "counter": "topk",
                     **timed, "arches": [VLM_ARCH, AUD_ARCH]}
        else:
            entry[AUD_ARCH] = timed
    rows.append(entry)
    dq = check_dequant(dev, flush, DQ_VLM_CASES, f"dequant_matmul ({VLM_ARCH} int4)")
    rows.append({**dq, "arches": [VLM_ARCH]})
    # kv_quant_write: K/V as a layer makes them (transposed views of (b, s, h, hd))
    fresh = lambda s: tuple(rnd(B, s, VLM_HKV, HD).bfloat16().transpose(1, 2) for _ in range(2))
    S = FRONTEND_MAX_LEN[VLM_ARCH]
    sq = VLM_PREFIX + 125
    slots = torch.arange(B, device=dev)
    k, v = fresh(sq)
    writes = [kvq_write_case(
        f"{VLM_ARCH} slot admission of {B} x {sq}", k, v, B, S,
        attn.quant_targets(B, sq, dev, targets=(slots.repeat_interleave(sq),
                                                 torch.arange(sq, device=dev).repeat(B))),
        flush, False)]
    k, v = fresh(1)
    writes.append(kvq_write_case(
        f"{VLM_ARCH} slot decode", k, v, B, S,
        attn.quant_targets(B, 1, dev, targets=(slots, torch.tensor(FRONTEND_DECODE[VLM_ARCH][1],
                                                                   device=dev) - 1)),
        flush, False))
    del k, v
    head = writes[0]
    rows.append({"name": f"kv_quant_write ({VLM_ARCH})", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/kv_quant_write.cu",
                 "replaces": "src/repro/models/attention.py:156",
                 "replaces_what": "no Pallas kernel: _quantize_kv and the cache writes in jnp",
                 "counter": "kv_quant_write", "arches": [VLM_ARCH],
                 "library": "none: no single PyTorch call quantizes and scatters",
                 **{k: head[k] for k in ("shape", "max_abs_err", "tolerance", "ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by")},
                 "cases": writes})
    return rows


def small_frontend_model(dev, arch: str):
    """Reduced ``arch`` (``small_model``), its projector's norm gamma drawn
    nonzero too -> (cfg, CPU params, the same on ``dev``)."""
    cfg, cpu, _ = small_model(dev, arch)
    norm = cpu["frontend"]["norm"]
    norm.copy_(0.2 * torch.randn(norm.shape, generator=torch.Generator().manual_seed(3)))
    return cfg, cpu, to_device(cpu, dev)


def frontend_reference_check(dev) -> list:
    """Reduced internvl2-26b and musicgen-medium on the card against the
    same weights on the CPU, where the plain versions run, behind 8
    positions of seeded non-zero features: the logits of a 3 x 20-token
    (frame) prefill and 8 decode steps fed the CPU's greedy tokens within
    REF_TOL, and ``Engine.generate``'s greedy streams of 16 new tokens
    (frames) from the same prompts and features equal, or parted where
    every codebook that differs shows a CPU top-2 gap below TIE_GAP."""
    from repro_torch.configs import SamplingConfig
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine

    out = []
    for arch in (VLM_ARCH, AUD_ARCH):
        cfg, cpu, gpu = small_frontend_model(dev, arch)
        frame = () if cfg.n_codebooks == 1 else (cfg.n_codebooks,)
        f = cfg.frontend
        rng = np.random.default_rng(5)
        b, plen, max_len = 3, 20, 64
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, plen, *frame)))
        feats = torch.from_numpy(rng.standard_normal((b, f.prefix_len, f.feature_dim))
                                 .astype(np.float32))
        caches = {d: M.init_caches(cfg, b, max_len, device=d) for d in ("cpu", dev)}
        worst = 0.0
        with torch.inference_mode():
            lc = M.forward(cpu, tokens, cfg, caches=caches["cpu"], features=feats)
            lg = M.forward(gpu, tokens.to(dev), cfg, caches=caches[dev],
                           features=feats.to(dev)).cpu()
            worst = max(worst, (lc - lg).abs().max().item())
            tok = lc[:, -1].argmax(-1)
            for cur in range(f.prefix_len + plen, f.prefix_len + plen + 8):
                lc = M.forward(cpu, tok[:, None], cfg, caches=caches["cpu"], cur_pos=cur)
                lg = M.forward(gpu, tok[:, None].to(dev), cfg, caches=caches[dev],
                               cur_pos=cur).cpu()
                worst = max(worst, (lc - lg).abs().max().item())
                tok = lc[:, -1].argmax(-1)
        if not (worst <= REF_TOL and torch.isfinite(lg).all()):
            fail(f"small {arch}: card logits differ from the CPU's by {worst} > {REF_TOL}")
        streams = {}
        for d, params in (("cpu", cpu), (dev, gpu)):
            eng = Engine(cfg, sampling=SamplingConfig(top_k=1), max_len=max_len, params=params,
                         device=d)
            streams[str(d)] = eng.generate(tokens.numpy(), 16, feats.numpy())
        parted = []
        for i in range(b):
            a, c = streams["cpu"][i], streams[str(dev)][i]
            if np.array_equal(a, c):
                continue
            diff = (a != c).reshape(len(a), -1)
            t = int(np.argmax(diff.any(axis=1)))
            seq = np.concatenate([tokens[i].numpy(), a[:t]])
            with torch.inference_mode():
                lc = M.forward(cpu, torch.from_numpy(seq)[None].long(), cfg, last_only=True,
                               features=feats[i:i + 1])[0, -1].reshape(-1, cfg.vocab_size)
            top2 = torch.topk(lc, 2).values
            gaps = (top2[:, 0] - top2[:, 1])[torch.from_numpy(np.flatnonzero(diff[t]))]
            if not (gaps < TIE_GAP).all():
                fail(f"small {arch}: the card's generate stream {i} parts from the CPU's at "
                     f"step {t}, CPU top-2 gaps {gaps.tolist()}")
            parted.append({"row": i, "step": t, "top2_gaps": gaps.tolist()})
        out.append({"config": cfg.name, "prefix": f.prefix_len, "codebooks": cfg.n_codebooks,
                    "features": "seeded normal", "max_abs_logit_err": worst,
                    "tolerance": REF_TOL, "generate_rows": b, "generate_parted": parted})
    return out


class _Recorder:
    """Keeps what ``serve.submit_workload`` submits."""

    def __init__(self):
        self.reqs = []

    def submit(self, prompt, max_new, arrival_step=0, priority="standard"):
        self.reqs.append((np.asarray(prompt), max_new, arrival_step))


def frontend_slot_phase(dev, arch: str, params, kv_quant: bool = False, want=None):
    """Full-width ``arch`` (the wave phase's weights ``params``) through the
    ContinuousScheduler over SLOT_WORKLOAD (12 requests into 4 slots, arrivals
    every 4 decode steps, budgets 8..32; musicgen-medium's prompts are
    frames and take no shared prompt), whole prompts behind the prefix (the
    default chunk of 256 falls back: the frontend blocks chunks), twice:
    tokens in range, the second run identical, launches as predicted.  In
    bf16 (``want`` None) the same requests then go through the WaveScheduler,
    each alone in a wave of SLOTS copies of itself (no padding, so the
    stream is the request's own, and its decode steps as wide as the
    slots'), and each continuous stream must equal its wave stream or part
    first where, for every differing codebook, both tokens lie within
    REF_TOL of the top of the card's logits teacher-forced along the wave's
    stream: a slot's prompt is prefilled alone in its bucket and the wave's
    four copies together, so their products run at other widths (other
    cuBLAS tiles) and, over 48 random layers, their logits stand a few 1e-2
    apart, as the card's and the CPU's do (REF_TOL); at most MAX_PARTED
    parted.  Over the int8 cache (``kv_quant``) the streams
    equal to the bf16 run's (``want``) are counted.  -> (result, streams)."""
    import argparse

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import ContinuousScheduler, WaveScheduler

    t_phase = time.monotonic()
    cfg = phase_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = Engine(cfg, parallel=ParallelConfig(kv_quant=kv_quant),
                 sampling=SamplingConfig(top_k=1), max_len=FRONTEND_MAX_LEN[arch], seed=0,
                 params=params, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rec = _Recorder()
    serve.submit_workload(rec, cfg, argparse.Namespace(**SLOT_WORKLOAD))

    def run(sched, arrivals=True):
        for p, m, a in rec.reqs:
            sched.submit(p, m, arrival_step=a if arrivals else 0)
        torch.cuda.synchronize()
        t = time.monotonic()
        done = sched.run()
        torch.cuda.synchronize()
        return {r.rid: r.output for r in done}, time.monotonic() - t

    ops.reset_launches()
    sched = ContinuousScheduler(eng, n_slots=SLOTS)
    first, dt1 = run(sched)
    launches = dict(ops.LAUNCHES)
    second, dt2 = run(ContinuousScheduler(eng, n_slots=SLOTS))
    st = sched.stats
    expect = expected_slot_launches("dense", st, cfg.n_layers, kv_quant=kv_quant)
    if sched.chunk != 0 or launches != expect:
        fail(f"{arch} continuous kv_quant={kv_quant}: chunk {sched.chunk}, kernel launches "
             f"{launches} != expected {expect} ({st})")
    frame = () if cfg.n_codebooks == 1 else (cfg.n_codebooks,)
    for rid, toks in first.items():
        if (toks.shape != (rec.reqs[rid][1], *frame)
                or not ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{arch} continuous request {rid}: tokens out of range or wrong count")
        if not np.array_equal(toks, second[rid]):
            fail(f"{arch} continuous request {rid}: greedy tokens differ between two runs")
    n_tokens = sum(len(t) for t in first.values())
    result = {"arch": cfg.name, "scheduler": "continuous", "weight_quant": "none",
              "kv_quant": kv_quant, "layers": cfg.n_layers, "params": cfg.param_count(),
              "prefix": eng.prefix, "codebooks": cfg.n_codebooks,
              "requests": len(rec.reqs), "slots": SLOTS, "max_len": FRONTEND_MAX_LEN[arch],
              "workload": SLOT_WORKLOAD, "prompt_lens": [len(p) for p, _, _ in rec.reqs],
              "tokens": n_tokens, "init_s": init_s, "wall_s": [dt1, dt2],
              "ms_per_token": [1e3 * dt1 / n_tokens, 1e3 * dt2 / n_tokens],
              "stats": dict(st), "summary": sched.request_summary(), "launches": launches,
              "repeatable": True, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if want is not None:
        result["equal_to_bf16_kv_streams"] = sum(np.array_equal(t, want[rid])
                                                 for rid, t in first.items())
    else:
        # each request alone in a wave of SLOTS copies of itself: no padding,
        # and its decode steps as wide as the slots' (SLOTS rows)
        sched_w = WaveScheduler(eng, batch_size=SLOTS)
        for p, m, _ in rec.reqs:
            for _ in range(SLOTS):
                sched_w.submit(p, m)
        torch.cuda.synchronize()
        t = time.monotonic()
        done_w = sched_w.run()
        torch.cuda.synchronize()
        dt_w = time.monotonic() - t
        wave = {r.rid // SLOTS: r.output for r in done_w if r.rid % SLOTS == 0}
        parted = []
        for rid, toks in first.items():
            a, b = wave[rid], toks
            if np.array_equal(a, b):
                continue
            diff = (a != b).reshape(len(a), -1)
            t = int(np.argmax(diff.any(axis=1)))
            seq = np.concatenate([rec.reqs[rid][0], a[:t]])
            with torch.inference_mode():
                lg = M.forward(eng.params, torch.as_tensor(seq, device=dev)[None].long(), cfg,
                               last_only=True, head_f32=eng.head_f32,
                               features=eng.zero_features(1))[0, -1].reshape(-1, cfg.vocab_size)
            cbs = np.flatnonzero(diff[t])
            top = lg.max(dim=-1).values[cbs].cpu()
            at = lambda toks: lg[cbs, torch.as_tensor(np.asarray(toks).reshape(-1)[cbs],
                                                      device=dev)].cpu()
            slack = torch.maximum(top - at(a[t]), top - at(b[t])).tolist()
            top2 = torch.topk(lg, 2).values[cbs]
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            if not max(slack) < REF_TOL:
                fail(f"{arch} continuous request {rid} parts from its wave stream at step {t}: "
                     f"a token {slack} below the top (top-2 gaps {gaps})")
            parted.append({"rid": rid, "step": t, "codebooks": cbs.tolist(),
                           "tokens_below_top": slack, "top2_gaps": gaps})
        if len(parted) > MAX_PARTED:
            fail(f"{arch} continuous: {len(parted)} streams part from the wave's")
        result.update(wave_copies_s=dt_w, parted_from_wave_at_near_ties=parted)
    result["phase_s"] = time.monotonic() - t_phase
    del eng
    torch.cuda.empty_cache()
    return result, first


def frontend_phases(dev):
    """internvl2-26b at full depth: phase 5's wave workload behind its
    256-position prefix in bf16, the slot workload through the continuous
    scheduler in bf16 and over the int8 KV cache on the same weights, then
    the int4 wave; musicgen-medium at its cut depth (EARLIER_DEPTH): the
    bf16 wave and continuous phases in (b, 4) frames."""
    for arch in (VLM_ARCH, AUD_ARCH):
        phase, params = serve_phase(dev, arch, "none")
        yield phase
        result, streams = frontend_slot_phase(dev, arch, params)
        yield result
        if arch == VLM_ARCH:
            yield frontend_slot_phase(dev, arch, params, kv_quant=True, want=streams)[0]
        del params
        torch.cuda.empty_cache()
        if arch == VLM_ARCH:
            yield serve_phase(dev, arch, "int4")[0]
            torch.cuda.empty_cache()


# -- tensor parallelism --------------------------------------------------------
#
# Two ranks, one process each, share the one card over gloo (NCCL puts one
# rank on each card), every collective staged through host memory: no wall
# time of these phases is a tensor-parallel speed.  The kernels are built
# before the ranks start; each rank loads them.

TP = 2
# the tp=1 phases' streams, (arch, weight_quant, phase) -> (layers,
# {rid: tokens}), and an MoE arch's dropped assignments a layer call, in
# order (``drop_log``'s ``per_call``): the tp phases are held to them
TP1_STREAMS: dict = {}
TP1_DROPS: dict = {}
LAYER_TAGS = ("mixer_reduce", "ffn_reduce", "one_shot", "attn_reduce")
# an SSD job's shards, widened to fp32, against the tp=1 model in fp32: the
# two sum in other orders, fp32 rounding (2^15 below bf16's) carried as the
# bf16 one is (to ~1 in logits of std ~0.9), so ~1e-4 apart; a wrong head,
# channel or state moves them by whole units
TP_FP32_TOL = 1e-2


def tp_small_models():
    """The tp reference checks' models -> (name, cfg, ParallelConfig kw):
    the small GQA model, the same with QKV bias in int4 (qwen-like), and
    the small parallel-residual model."""
    from repro_torch.configs import get_config

    gqa = dataclasses.replace(get_config("yi-9b").reduced(), n_heads=8, n_kv_heads=2,
                              head_dim=128)
    par = dataclasses.replace(get_config(GJ_ARCH).reduced(), n_layers=3, d_model=512,
                              n_heads=2, n_kv_heads=2, head_dim=256, d_ff=1024)
    return [("gqa-hd128", gqa, {}),
            ("qwen-like-int4", dataclasses.replace(gqa, qkv_bias=True), {"weight_quant": "int4"}),
            ("parallel-hd256", par, {})]


TP_REF_B, TP_REF_PLEN, TP_REF_STEPS = 3, 21, 8


def _tp_reference_rank(dist, dev, models, forced):
    """One rank of ``tp_reference_check``: each small model's shard of the
    CPU's seed-1 weights on the card; the logits of a 3 x 21-token prefill
    (21: the ranks' sequence chunks differ) and 8 decode steps fed the
    CPU's greedy tokens, all vocab gathered; a greedy wave of 12 tokens;
    the collectives of one decode step and the launches."""
    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.core import collectives as cc
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine

    out = {}
    for (name, cfg, kw), (tokens, steps) in zip(models, forced):
        par = ParallelConfig(tp=dist.tp, **kw)
        params = to_device(M.init_params(cfg, par, seed=1, device="cpu", dist=dist), dev)
        eng = Engine(cfg, parallel=par, params=params, sampling=SamplingConfig(top_k=1),
                     max_len=128, device=dev, dist=dist)
        full = lambda lg: cc.all_gather(lg, dist, 2)[..., :cfg.vocab_size].float().cpu()
        ops.reset_launches()
        with torch.inference_mode():
            caches = eng.init_caches(TP_REF_B)
            t = torch.as_tensor(tokens, device=dev)
            logits = [full(eng.forward(t, caches=caches, seq_sharded=True))]
            for i in range(TP_REF_STEPS):
                tok = torch.as_tensor(steps[:, i], device=dev)[:, None]
                with cc.comm_stats() as st:
                    lg = eng.forward(tok, caches=caches, cur_pos=TP_REF_PLEN + i)
                logits.append(full(lg))
            gen = eng.generate(tokens, 12)
        torch.cuda.synchronize()
        out[name] = {"logits": logits, "tokens": gen, "comm_per_decode_step": st.by_tag(),
                     "launches": dict(ops.LAUNCHES)}
        del eng, params
        torch.cuda.empty_cache()
    return out


def tp_reference_check(dev) -> dict:
    """The small models at tp=2, two ranks on the card, against the same
    weights at tp=1 on the CPU (plain versions): every logits row within
    REF_TOL, and the greedy wave's tokens the CPU's (a parting certified
    where the CPU's top-2 logits lie within TIE_GAP)."""
    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.launch import mesh
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine

    t0 = time.monotonic()
    models, forced, cpu_runs = tp_small_models(), [], []
    for name, cfg, kw in models:
        par = ParallelConfig(**kw)
        eng = Engine(cfg, parallel=par, params=M.init_params(cfg, par, seed=1, device="cpu"),
                     sampling=SamplingConfig(top_k=1), max_len=128, device="cpu")
        tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                   (TP_REF_B, TP_REF_PLEN))
        with torch.inference_mode():
            caches = eng.init_caches(TP_REF_B)
            lg = eng.forward(torch.as_tensor(tokens), caches=caches)
            logits, steps = [lg], []
            tok = lg[:, -1].argmax(-1)
            for i in range(TP_REF_STEPS):
                steps.append(tok.numpy())
                lg = eng.forward(tok[:, None], caches=caches, cur_pos=TP_REF_PLEN + i)
                logits.append(lg)
                tok = lg[:, -1].argmax(-1)
        forced.append((tokens, np.stack(steps, axis=1)))
        cpu_runs.append((eng, logits, eng.generate(tokens, 12), tokens))
    got = mesh.spawn(_tp_reference_rank, TP, models, forced, backend="gloo", device="cuda")
    result = {"ranks": TP, "backend": "gloo", "tolerance": REF_TOL, "models": {}}
    for (name, cfg, kw), (eng, logits, toks, tokens) in zip(models, cpu_runs):
        worst, parted = 0.0, []
        for rank, res in enumerate(r[name] for r in got):
            for a, b in zip(logits, res["logits"]):
                if not torch.isfinite(b).all():
                    fail(f"tp reference {name} rank {rank}: non-finite card logits")
                worst = max(worst, (a - b).abs().max().item())
            for row in range(TP_REF_B):
                a, b = toks[row], res["tokens"][row]
                if np.array_equal(a, b):
                    continue
                t = int(np.argmax(a != b))
                seq = torch.as_tensor(np.concatenate([tokens[row], a[:t]]))[None]
                with torch.inference_mode():
                    top2 = torch.topk(eng.forward(seq, last_only=True)[0, -1], 2).values
                gap = (top2[0] - top2[1]).item()
                if not gap < TIE_GAP:
                    fail(f"tp reference {name} rank {rank} row {row}: greedy tokens part from "
                         f"the CPU's at step {t} with top-2 gap {gap}")
                parted.append({"rank": rank, "row": row, "step": t, "top2_gap": gap})
        if not worst <= REF_TOL:
            fail(f"tp reference {name}: tp=2 card logits differ from the CPU's tp=1 by "
                 f"{worst} > {REF_TOL}")
        comm = got[0][name]["comm_per_decode_step"]
        n_ar = sum(v["count"] for k, v in comm.items() if k.split(" ")[0] in LAYER_TAGS)
        want = cfg.n_layers * (1 if cfg.parallel_residual else 2)
        if n_ar != want:
            fail(f"tp reference {name}: {n_ar} layer all-reduces a decode step, not {want}")
        result["models"][name] = {
            "config": cfg.name, "layers": cfg.n_layers, **kw, "max_abs_logit_err": worst,
            "parted_at_near_ties": parted, "comm_per_decode_step": comm,
            "launches_rank0": got[0][name]["launches"]}
    result["phase_s"] = time.monotonic() - t0
    return result


def _tp_full_jobs():
    """The full-width tp phases, in order, the consecutive ones of one
    (arch, weight_quant, layers) on one set of weights: yi-9b bf16 (48
    layers) in the wave workload and the paged chunked-spec one;
    gptj-parallel bf16 (28 layers) waves with and without
    ``one_shot_sync``; qwen-72b int4 (80 layers) in one wave of 4; and at
    their tp=1 phases' cut depth (EARLIER_DEPTH): recurrentgemma-9b bf16
    (3 layers) in one wave of 4 of phase 7's 2100-2300-token prompts,
    deepseek-moe-16b bf16 (14 layers) in one wave of 4 and the paged
    chunked-spec workload, mixtral-8x7b int4 (4 layers) and minicpm3-4b
    bf16 (8 layers) in one wave of 4 each, mamba2-1.3b bf16 (8 layers) in
    one wave of 4 and the paged slot workload (whole prompts), and
    musicgen-medium bf16 (12 layers, (b, 4) frames) in one wave of 4; and
    internvl2-26b int4 at full depth (48 layers) in one wave of 4, behind
    their zero-feature prefixes.  Each job's ``layers`` is its depth,
    ``max_len`` its cache length and ``ref_phase`` (default the wave, or
    the paged chunked-spec phase) the tp=1 phase it is held to."""
    from repro_torch.configs import get_config

    def wave_work(arch, n, lo=16, hi=128):
        rng = np.random.default_rng(0)      # serve_phase's and hybrid_phases' draws
        cfg = get_config(arch)
        frame = () if cfg.n_codebooks == 1 else (cfg.n_codebooks,)
        return [rng.integers(0, cfg.vocab_size, (int(rng.integers(lo, hi + 1)), *frame))
                .astype(np.int32) for _ in range(n)]

    wave = dict(kind="wave", batch=SERVE_BATCH, max_new=SERVE_MAX_NEW, max_len=SERVE_MAX_LEN)
    paged = dict(name="tp2-paged-chunked-spec", kind="paged", max_len=SERVE_MAX_LEN,
                 opts=dict(prefill_chunk=64, spec_k=SPEC_K))
    cut = lambda arch: phase_config(arch).n_layers
    jobs = [
        dict(name="tp2-wave", arch="yi-9b", quant="none", work=wave_work("yi-9b", 8), **wave),
        dict(arch="yi-9b", quant="none", **paged),
        dict(name="tp2-wave", arch=GJ_ARCH, quant="none", work=wave_work(GJ_ARCH, 8), **wave),
        dict(name="tp2-wave-two-sync", arch=GJ_ARCH, quant="none", one_shot=False,
             work=wave_work(GJ_ARCH, 8), **wave),
        dict(name="tp2-wave", arch="qwen-72b", quant="int4", work=wave_work("qwen-72b", 4),
             **wave),
        dict(name="tp2-wave", arch=RG_ARCH, quant="none", layers=cut(RG_ARCH),
             work=wave_work(RG_ARCH, SERVE_BATCH, *RG_WAVE["prompt"]),
             **dict(wave, max_len=RG_WAVE["max_len"])),
        dict(name="tp2-wave", arch=MOE_ARCH, quant="none", layers=cut(MOE_ARCH),
             work=wave_work(MOE_ARCH, SERVE_BATCH), **wave),
        dict(arch=MOE_ARCH, quant="none", layers=cut(MOE_ARCH), **paged),
        dict(name="tp2-wave", arch=RING_ARCH, quant="int4", layers=cut(RING_ARCH),
             work=wave_work(RING_ARCH, SERVE_BATCH), **wave),
        dict(name="tp2-wave", arch=MLA_ARCH, quant="none", layers=cut(MLA_ARCH),
             work=wave_work(MLA_ARCH, SERVE_BATCH), **wave),
        dict(name="tp2-wave", arch=SSD_ARCH, quant="none", layers=cut(SSD_ARCH),
             work=wave_work(SSD_ARCH, SERVE_BATCH), **wave),
        dict(paged, name="tp2-paged", arch=SSD_ARCH, quant="none", layers=cut(SSD_ARCH),
             opts=dict(prefill_chunk=0), ref_phase="paged"),
        dict(name="tp2-wave", arch=AUD_ARCH, quant="none", layers=cut(AUD_ARCH),
             work=wave_work(AUD_ARCH, SERVE_BATCH),
             **dict(wave, max_len=FRONTEND_MAX_LEN[AUD_ARCH])),
        dict(name="tp2-wave", arch=VLM_ARCH, quant="int4", work=wave_work(VLM_ARCH, SERVE_BATCH),
             **dict(wave, max_len=FRONTEND_MAX_LEN[VLM_ARCH])),
    ]
    for job in jobs:
        job.setdefault("layers", get_config(job["arch"]).n_layers)
    return jobs


def _job_config(job: dict):
    """A tp job's config: its arch at the job's depth."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(job["arch"]), n_layers=job["layers"])


def _tp_full_rank(dist, dev, jobs):
    """One rank of the full-width tp phases (``_tp_full_jobs``): per job its
    streams, launches, dropped assignments (``drop_log``), the collectives
    of the run and of one decode step at b 4, walls, init time, peak
    memory, and where a stream parts from the tp=1 phase's (``job["ref"]``)
    the whole vocab's logits there."""
    import argparse

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.core import collectives as cc
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import PagedContinuousScheduler, WaveScheduler

    out, eng, weights = [], None, None
    for job in jobs:
        cfg = _job_config(job)
        par = ParallelConfig(tp=dist.tp, weight_quant=job["quant"], kv_block_size=BLOCK,
                             one_shot_sync=job.get("one_shot", True))
        params = eng.params if (job["arch"], job["quant"], job["layers"]) == weights else None
        eng = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        eng = Engine(cfg, parallel=par, sampling=SamplingConfig(top_k=1), max_len=job["max_len"],
                     seed=0, params=params, device=dev, dist=dist)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        weights = (job["arch"], job["quant"], job["layers"])
        if job["kind"] == "wave":
            sched = WaveScheduler(eng, batch_size=job["batch"])
            for p in job["work"]:
                sched.submit(p, max_new=job["max_new"])
        else:
            sched = PagedContinuousScheduler(eng, n_slots=SLOTS, **job["opts"])
            serve.submit_workload(sched, cfg, argparse.Namespace(**SLOT_WORKLOAD))
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.monotonic()
        with cc.comm_stats() as st, drop_log(routes=job["kind"] == "wave") as drops:
            done = sched.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        launches = dict(ops.LAUNCHES)
        parting_logits = {}
        for r in done:          # the same on every rank: the streams are replicated
            p = _parting(job, r.rid, r.output, job["ref"][r.rid], r.prompt)
            if p is not None:
                with torch.inference_mode():
                    lg = eng.forward(torch.as_tensor(p[1], device=dev)[None].long(),
                                     last_only=True, features=eng.zero_features(1))[0, -1]
                    lg = cc.all_gather(lg.float(), dist, lg.dim() - 1)[..., :cfg.vocab_size]
                parting_logits[r.rid] = lg.cpu().numpy()
        res = {"streams": {r.rid: r.output for r in done}, "parting_logits": parting_logits,
               "routes": drops.pop("routes", None),
               "prompts": {r.rid: r.prompt for r in done}, "launches": launches,
               "comm_run": st.by_tag(), "wall_s": wall, "init_s": init_s,
               "stats": dict(getattr(sched, "stats", {})), "moe_drops": drops,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        if job["kind"] == "wave" and cfg.ssm is not None:
            # the shards widened to fp32 through the first wave's prefill
            # (sequence-sharded), its last logits gathered over the vocab
            with torch.inference_mode():
                lg = M.forward(_widen(eng.params), torch.as_tensor(_first_wave(job),
                                                                   device=dev).long(), cfg,
                               ctx=eng.ctx, last_only=True, seq_sharded=True)[:, -1]
                res["fp32_logits"] = cc.all_gather(lg, dist, lg.dim() - 1)[
                    ..., :cfg.vocab_size].cpu().numpy()
            del lg
        if job["kind"] == "wave":     # one decode step at b 4, after an 8-token prompt
            frame = () if cfg.n_codebooks == 1 else (cfg.n_codebooks,)
            with torch.inference_mode():
                caches = eng.init_caches(SERVE_BATCH)
                tok = eng.prefill(torch.zeros((SERVE_BATCH, 8, *frame), dtype=torch.long,
                                              device=dev), caches,
                                  eng.zero_features(SERVE_BATCH))
                with cc.comm_stats() as st:
                    eng.decode(tok, caches, eng.prefix + 8)
            res["comm_per_decode_step"] = st.by_tag()
            del caches, tok
        res["job_s"] = time.monotonic() - t0
        out.append(res)
        del sched, done       # the scheduler holds the engine: free it before the next job
    return out


def _tp1_engine(job: dict, dev, cache: dict):
    """The tp=1 model of seed 0 (``job``'s arch, depth and weights, drawn
    once on the card when a tp stream first parts)."""
    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.runtime.engine import Engine

    key = (job["arch"], job["quant"], job["layers"])
    if key not in cache:
        cache.clear()
        torch.cuda.empty_cache()
        cache[key] = Engine(_job_config(job), parallel=ParallelConfig(weight_quant=job["quant"]),
                            sampling=SamplingConfig(top_k=1), max_len=job["max_len"], seed=0,
                            device=dev)
    return cache[key]


def _tp1_logits(job: dict, dev, cache: dict, seq: np.ndarray) -> torch.Tensor:
    """The logits of the tp=1 model (``_tp1_engine``) after ``seq`` (behind
    the zero features' prefix of a frontend arch): (V,), or (ncb, V)."""
    eng = _tp1_engine(job, dev, cache)
    with torch.inference_mode():
        return eng.forward(torch.as_tensor(seq, device=dev)[None].long(), last_only=True,
                           features=eng.zero_features(1))[0, -1]


def _widen(tree):
    """A parameter tree with every floating leaf fp32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widen(v) for v in tree]
    return tree.float() if torch.is_floating_point(tree) else tree


def _tp1_exact_logits(job: dict, dev, cache: dict, tokens: np.ndarray) -> torch.Tensor:
    """The tp=1 model's last logits after ``tokens`` (b, s) evaluated in
    fp32: its bf16 weights widened (kept in ``cache`` beside its engine),
    every activation fp32 -> (b, V).  An attention-free model's forward
    runs no kernel but the sampling top-k, so its plain versions are
    itself: this evaluation is what measures its own rounding at its
    depth."""
    from repro_torch.models import model as M

    eng = _tp1_engine(job, dev, cache)
    if "fp32" not in cache:
        cache["fp32"] = _widen(eng.params)
    with torch.inference_mode():
        return M.forward(cache["fp32"], torch.as_tensor(tokens, device=dev).long(), eng.cfg,
                         last_only=True, features=eng.zero_features(len(tokens)))[:, -1]


def _first_wave(job: dict) -> np.ndarray:
    """A wave job's first wave of prompts, right-padded (pad id 0) as the
    WaveScheduler pads them: (batch, longest)."""
    wave = job["work"][:job["batch"]]
    out = np.zeros((len(wave), max(len(p) for p in wave), *wave[0].shape[1:]), np.int32)
    for i, p in enumerate(wave):
        out[i, :len(p)] = p
    return out


def _moe_wave_witness(job: dict, dev, cache: dict, r0: dict) -> dict:
    """An MoE tp wave as the tp=1 model (``_tp1_engine``) computes it
    replaying the ranks' expert choices call by call (``r0["routes"]``):
    ``Engine.generate``'s calls, the right-padded prompts, then the ranks'
    tokens one decode step at a time, so that the prefill's capacity drops,
    which the routes decide and which shape every row, are the ranks' ->
    {"logits": each forward's last logits (b, V), "drops": every call's
    dropped assignments, "margins": where its own router ranked experts
    apart from the replayed ones, its k-th probability less that of the
    ranks' other choice}."""
    from repro_torch.kernels import ref
    from repro_torch.models import moe

    eng = _tp1_engine(job, dev, cache)
    work = job["work"]
    plen = max(len(p) for p in work)
    prompts = np.zeros((len(work), plen), np.int64)
    for i, p in enumerate(work):
        prompts[i, :len(p)] = p
    streams = np.stack([r0["streams"][i] for i in range(len(work))])
    logits = []
    moe.LOG, moe.ROUTE_REPLAY = [], [e.to(dev) for e in r0["routes"]]
    try:
        with torch.inference_mode():
            caches = eng.init_caches(len(work))
            logits.append(eng.forward(torch.as_tensor(prompts, device=dev), caches=caches,
                                      last_only=True, seq_sharded=True)[:, -1].float())
            for i in range(1, streams.shape[1]):
                tok = torch.as_tensor(streams[:, i - 1], device=dev)[:, None].long()
                logits.append(eng.forward(tok, caches=caches, cur_pos=plen + i - 1)[:, -1]
                              .float())
        log = moe.LOG
        if moe.ROUTE_REPLAY:
            fail(f"{job['arch']}: {len(moe.ROUTE_REPLAY)} of the ranks' routes not replayed")
    finally:
        moe.LOG = moe.ROUTE_REPLAY = None
    margins = []
    for rec in log:
        probs, chosen = rec["probs"], rec["top_e"].long()
        own = ref.topk_ref(probs, chosen.shape[1])[1].long()
        for j in torch.nonzero((own.sort(1).values != chosen.sort(1).values).any(1))[:, 0]:
            other = probs[j, [e for e in chosen[j].tolist() if e not in own[j].tolist()]]
            margins.append(float(probs[j, own[j]].min() - other.min()))
    return {"logits": logits, "drops": [int((~r["keep"]).sum()) for r in log],
            "margins": margins}


def tp_phases(dev, backend: str = "gloo"):
    """The full-width tp phases on ``TP`` ranks (``_tp_full_jobs``), each
    phase's result yielded as soon as it is checked; see the module
    docstring."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.core.embedding import table_replicated
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh

    t0 = time.monotonic()
    jobs = _tp_full_jobs()
    if backend == "nccl":
        jobs = jobs[:1]
    for job in jobs:
        # held to the tp=1 phase of the same seed, weights and depth (its
        # first requests where the tp phase serves fewer)
        cfg = _job_config(job)
        key = (cfg.name, job["quant"], job.get("ref_phase", "wave" if job["kind"] == "wave"
                                                else "paged-chunked-spec"))
        if key not in TP1_STREAMS or TP1_STREAMS[key][0] != cfg.n_layers:
            fail(f"{job['name']} {cfg.name}: no tp=1 phase of {cfg.n_layers} layers to hold "
                 f"it to ({key})")
        job["ref"], job["ref_drops"] = TP1_STREAMS[key][1], TP1_DROPS.get(key)
    got = mesh.spawn(_tp_full_rank, TP, jobs, backend=backend, device="cuda")
    spawn_s = time.monotonic() - t0
    results, tp1, one_shot_streams = [], {}, None
    for j, job in enumerate(jobs):
        cfg = _job_config(job)
        L, name = cfg.n_layers, f"{job['name']} {cfg.name}"
        A, n_moe = kernel_attention_layers(cfg), moe_layers(cfg)
        n_rec = sum(cfg.block_kind(i) == "rglru" for i in range(L))
        ranks = [r[j] for r in got]
        par = ParallelConfig(tp=TP, weight_quant=job["quant"])
        for rank, res in enumerate(ranks):
            if job["kind"] == "wave":
                waves = -(-len(job["work"]) // job["batch"])
                mn = job["max_new"]
                expect = {k: 0 for k in ops.KERNELS}
                expect.update({
                    "flash_prefill": A * waves, "decode_attention": A * (mn - 1) * waves,
                    "lru_scan": n_rec * waves,
                    # the shard's top-k and the candidates', and each MoE
                    # layer's routing on every rank, once a forward
                    "topk": (2 + n_moe) * mn * waves,
                    "dequant_matmul": dequant_launches_per_forward(cfg, par) * mn * waves,
                    "fused_dual_matmul": (L * mn * waves if cfg.parallel_residual
                                          and job.get("one_shot", True) else 0)})
            else:
                expect = expected_slot_launches("paged", res["stats"], A, moe=n_moe)
                expect["topk"] += expect["topk"] // (1 + n_moe)     # two a sampling call
            if res["launches"] != expect:
                fail(f"{name} rank {rank}: kernel launches {res['launches']} != {expect}")
            if res["moe_drops"] != ranks[0]["moe_drops"]:
                fail(f"{name}: rank {rank}'s dropped assignments {res['moe_drops']} differ "
                     f"from rank 0's")
            for rid, toks in res["streams"].items():
                if not (len(toks) and ((toks >= 0) & (toks < cfg.vocab_size)).all()):
                    fail(f"{name} rank {rank} request {rid}: tokens out of range: {toks}")
                if not np.array_equal(toks, ranks[0]["streams"][rid]):
                    fail(f"{name}: rank {rank}'s stream {rid} differs from rank 0's")
        r0 = ranks[0]
        comm = r0.get("comm_per_decode_step")
        if comm is not None:
            layer = {k: v for k, v in comm.items() if k.split(" ")[0] in LAYER_TAGS}
            per = 2 if not cfg.parallel_residual or not job.get("one_shot", True) else 1
            # an SSD layer has no FFN: its mixer's one all-reduce
            n_ar = sum(1 if cfg.block_kind(i) == "ssd" else per for i in range(L))
            payload = 2 * SERVE_BATCH * cfg.d_model * 2      # bf16 (b, 1, d) twice on the wire
            if (sum(v["count"] for v in layer.values()) != n_ar
                    or any(v["bytes"] != v["count"] * payload for v in layer.values())):
                fail(f"{name}: a decode step's layer all-reduces {layer}, not {n_ar} "
                     f"of {payload} bytes")
            gathers = [k for k in comm if k.startswith(("topk_vals", "topk_idx"))]
            if len(gathers) != 2 or any(comm[k]["count"] != 1 for k in gathers):
                fail(f"{name}: top-k gathers of a decode step {comm}")
            if table_replicated(cfg) == any(k.startswith("embed_shard_merge") for k in comm):
                fail(f"{name}: the vocab-sharded embedding's all-reduce {comm}")
        # held to the tp=1 phase's tokens, and the two-sync baseline to the
        # one-shot phase's too
        drops = r0["moe_drops"]
        per_call = drops.pop("per_call")
        witness = None
        if n_moe and job["kind"] == "wave":
            # the tp=1 model replaying the ranks' expert choices through the
            # wave: the same drops, and routes apart only at near-ties
            witness = _moe_wave_witness(job, dev, tp1, r0)
            bad = [m for m in witness["margins"] if not m < ROUTER_TIE]
            if witness["drops"] != per_call or bad:
                fail(f"{name}: replaying the ranks' routes, the tp=1 model drops "
                     f"{witness['drops']} a layer call, the ranks {per_call}; its own router "
                     f"ranks experts apart from theirs by {bad} (limit {ROUTER_TIE})")
            drops.update(router_near_ties=len(witness["margins"]),
                         as_replayed_at_tp1=True)
            # the wave's calls are the first of the tp=1 phase's (its first
            # wave): its drops, or apart through those near-ties alone
            want = job["ref_drops"][:len(per_call)]
            drops.update(as_tp1_phase=per_call == want, tp1_phase_dropped=sum(want))
            if not drops["dropped"] or (per_call != want and not witness["margins"]):
                fail(f"{name}: dropped assignments a layer call {per_call} != the tp=1 "
                     f"phase's {want} with no router near-tie, or none past 256 tokens")
        elif n_moe:
            drops["as_tp1_phase"] = per_call == job["ref_drops"]
        # random-weight SSD streams part at most requests under any other
        # summation order (its bf16 logits lie ~0.1-1.5 from its fp32
        # evaluation; PERF.md section 6): each parting is certified, no
        # count is held, and the shards are held in fp32 instead
        ssd = cfg.ssm is not None
        parted = {"tp1": _tp_parted(name, job, r0, job["ref"], dev, tp1, r0["parting_logits"],
                                    witness, limit=not ssd)}
        twin = None
        if "fp32_logits" in r0:
            exact = _tp1_exact_logits(job, dev, tp1, _first_wave(job)).float().cpu().numpy()
            twin = float(np.abs(r0["fp32_logits"] - exact).max())
            if not twin <= TP_FP32_TOL:
                fail(f"{name}: the ranks' shards widened to fp32 give logits {twin} from the "
                     f"tp=1 model's in fp32 (limit {TP_FP32_TOL})")
        if n_moe and job["kind"] != "wave" and not parted["tp1"] and not drops["as_tp1_phase"]:
            fail(f"{name}: the streams of the tp=1 phase, but dropped assignments a layer call "
                 f"{per_call} != its {job['ref_drops']}")
        if job["name"] == "tp2-wave-two-sync":
            parted["one_shot"] = _tp_parted(name, job, r0, one_shot_streams, dev, tp1)
        if job["name"] == "tp2-wave" and cfg.parallel_residual:
            one_shot_streams = r0["streams"]
        n_tokens = sum(len(t) for t in r0["streams"].values())
        launches = {k: sum(r["launches"][k] for r in ranks) for k in ops.KERNELS}
        results.append({
            "arch": cfg.name, "scheduler": job["name"], "weight_quant": job["quant"],
            "layers": L, "params": cfg.param_count(), "ranks": TP, "backend": backend,
            "one_shot_sync": job.get("one_shot", True),
            "note": "ranks share one card; collectives staged through host memory: "
                    "no wall time here is a tensor-parallel speed" if backend == "gloo" else "",
            "requests": len(r0["streams"]), "tokens": n_tokens,
            "init_s": [r["init_s"] for r in ranks], "wall_s": [r["wall_s"] for r in ranks],
            "ms_per_token": 1e3 * r0["wall_s"] / n_tokens,
            "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in ranks],
            "launches": launches, "launches_per_rank": r0["launches"],
            **({"moe_drops": drops} if n_moe else {}),
            "comm": {"per_decode_step": comm, "run": r0["comm_run"]},
            "stats": r0["stats"], "parted_at_near_ties": parted,
            **({"fp32_twin_max_abs_diff": twin, "fp32_twin_tolerance": TP_FP32_TOL}
               if twin is not None else {}),
            "first_tokens": {rid: r0["streams"][rid][:8].tolist()
                             for rid in sorted(r0["streams"])[:2]},
            "ranks_spawn_to_exit_s": spawn_s,
        })
        if j == len(jobs) - 1:
            tp1.clear()
            torch.cuda.empty_cache()
            results[-1]["tp_phases_s"] = time.monotonic() - t0
        yield results[-1]


def _parting(job: dict, rid: int, toks: np.ndarray, want: np.ndarray, prompt: np.ndarray):
    """-> None where ``toks`` is ``want``, else (t, seq): the first step at
    which it parts (a frame where any codebook does), and what the model
    read before it: the prompt as the phase ran it (a wave's right-padded)
    and ``want``'s tokens before t."""
    if np.array_equal(toks, want):
        return None
    n = min(len(toks), len(want))
    diff = (toks[:n] != want[:n]).reshape(n, -1).any(axis=1)
    t = int(np.argmax(diff)) if diff.any() else n
    if job["kind"] == "wave":
        w0 = rid - rid % job["batch"]
        plen = max(len(p) for p in job["work"][w0:w0 + job["batch"]])
        prompt = np.concatenate([prompt, np.zeros((plen - len(prompt), *prompt.shape[1:]),
                                                  np.int32)])
    return t, np.concatenate([prompt, want[:t]])


def _tp_witness(name: str, rid: int, t: int, err: float, tp_diff: float, slack: list) -> dict:
    """Certify request ``rid``'s tp parting at step ``t`` by the tp ranks'
    own logits there.  ``spread``, the larger of REF_TOL and ``err`` (the
    tp=1 port's distance from its plain versions on the same input, or
    an attention-free model's from its fp32 evaluation), is the port's own
    rounding at that depth; two computations each that far from the exact
    logits lie within twice it of each other.  So the tp logits must lie
    within 2 x ``spread`` of the tp=1 ones (``tp_diff``: a wrong shard or
    merge moves them by whole units), and each side must rank the other
    side's token within ``spread`` of its top (``slack``)."""
    spread = max(REF_TOL, err)
    if not (tp_diff <= 2 * spread and max(slack) <= spread):
        fail(f"{name} request {rid} parts at step {t}: the tp logits there differ from "
             f"tp=1's by {tp_diff} (limit {2 * spread}) and the two sides put each other's "
             f"token {slack} below their top (limit {spread}: the tp=1 port is {err} from "
             f"its plain versions or, attention-free, its fp32 evaluation)")
    return {"tp_max_abs_diff": tp_diff, "tp_slack": slack, "spread": spread}


def _at_most_half(name: str, n_parted: int, n_streams: int, what: str = "streams") -> None:
    """The parity contract's cap: at most half of a run's streams part
    from those they are held to, each parting certified."""
    if n_parted > n_streams // 2:
        fail(f"{name}: {n_parted} of {n_streams} {what} part")


def _tp_parted(name: str, job: dict, r0: dict, ref: dict, dev, cache: dict,
               tp_logits: dict | None = None, witness: dict | None = None,
               limit: bool = True) -> list:
    """Per request of a tp phase (rank 0's streams): ``ref``'s tokens, or a
    first difference at a near-tie of the tp=1 model; with ``limit``, at
    most half the requests parted.  A frame parts where any codebook does,
    and each codebook that differs there is a token of its own: every one
    of them must be certified, and each counts as a parted stream out of
    the requests' ncb codebook streams.  A near-tie: the tp=1 top-2 logits within TIE_GAP, as
    the dense slot phases certify one.  Else a witness, which for the
    parallel residual is the only one that counts (its one fused sum
    rounds once where the two-sync baseline rounds each partial), as in
    its slot phases: every kernel's plain version there within REF_TOL of
    the tp=1 port's logits, and both tokens -- ``ref``'s and the tp
    phase's -- within REF_TOL of the plain version's top.  Where the tp
    ranks' own logits there are given (``tp_logits``) and the arch is not
    the parallel residual, the witness is theirs (``_tp_witness``; an
    attention-free model, which runs no kernel there, takes its distance
    from its fp32 evaluation, ``_tp1_exact_logits``).  An MoE
    wave's ``witness`` (``_moe_wave_witness``) takes the tp logits' place:
    the tp=1 model through the same wave, replaying the ranks' expert
    choices, must rank their token within ``spread`` of its top."""
    parted = []
    for rid, toks in r0["streams"].items():
        want = ref[rid]
        p = _parting(job, rid, toks, want, r0["prompts"][rid])
        if p is None:
            continue
        t, seq = p
        # a row per codebook (one for a single-codebook head); each codebook
        # that differs at step t is a token of its own, certified alone
        logits = _tp1_logits(job, dev, cache, seq).float()
        V = logits.shape[-1]
        logits = logits.reshape(-1, V)
        ncb = logits.shape[0]
        cbs = (np.flatnonzero((toks[t] != want[t]).reshape(-1)) if t < min(len(toks), len(want))
               else np.arange(ncb))
        top2 = torch.topk(logits[torch.as_tensor(cbs, device=dev)], 2).values
        gap = float((top2[:, 0] - top2[:, 1]).max())
        flip = {"rid": rid, "step": t, "top2_gap": gap,
                **({"codebooks": cbs.tolist()} if ncb > 1 else {})}

        def below(lg, x):
            """How far below its top ``lg`` puts stream x's token(s) at t."""
            at = np.asarray(x[t]).reshape(-1)
            return max((lg[c].max() - lg[c, int(at[c])]).item() for c in cbs)

        if witness is not None or job["arch"] == GJ_ARCH or not gap < TIE_GAP:
            with plain_on_card():
                plain = _tp1_logits(job, dev, cache, seq).float().reshape(-1, V)
            err = (logits - plain).abs().max().item()
            flip["plain_max_abs_err"] = err
            if _job_config(job).ssm is not None:
                # no kernel to be apart from: the port's rounding is its
                # distance from its fp32 evaluation
                exact = _tp1_exact_logits(job, dev, cache, seq[None])[0].float().reshape(-1, V)
                flip["fp32_max_abs_err"] = (logits - exact).abs().max().item()
                err = max(err, flip["fp32_max_abs_err"])
            tp = (None if tp_logits is None
                  else torch.as_tensor(tp_logits[rid], device=dev).reshape(-1, V))
            if witness is not None:
                # an MoE wave: the wave as the ranks ran it, their expert
                # choices replayed (``_moe_wave_witness``), ranks their
                # token within ``spread`` of its top; its routes apart
                # from the ranks' are near-ties (checked by the caller)
                spread = max(REF_TOL, err)
                slack = below(witness["logits"][t][rid].reshape(-1, V), toks)
                if not slack <= spread:
                    fail(f"{name} request {rid} parts at step {t}: the tp=1 model replaying "
                         f"the ranks' expert choices through the wave puts their token "
                         f"{slack} below its top (limit {spread})")
                flip.update(replayed_wave_slack=slack, spread=spread)
            elif job["arch"] == GJ_ARCH or tp is None:
                slack = [below(plain, x) for x in (want, toks) if t < len(x)]
                if not (err <= REF_TOL and max(slack) < REF_TOL):
                    fail(f"{name} request {rid} parts at step {t}: the plain versions there "
                         f"differ from the port by {err} and put the two tokens {slack} below "
                         f"their top (limit {REF_TOL} each)")
                flip["plain_slack"] = slack
            else:
                slack = [below(lg, x) for lg, x in ((logits, toks), (tp, want)) if t < len(x)]
                flip.update(_tp_witness(name, rid, t, err, (tp - logits).abs().max().item(),
                                        slack))
        parted.append(flip)
    # each codebook of a frame is a token of its own: a parting frame counts
    # its differing codebooks, out of every request's ncb streams
    ncb = _job_config(job).n_codebooks
    n_parted = sum(len(f.get("codebooks", (0,))) for f in parted)
    if limit:
        _at_most_half(name, n_parted, len(r0["streams"]) * ncb,
                      "codebook streams" if ncb > 1 else "streams")
    return parted



# -- the data axis (phase 14) ----------------------------------------------------
#
# dp ranks, one process each, share the one card over gloo (their
# collectives and block transfers staged through host memory): no wall
# time here is a data-parallel or disaggregated speed (without MPS the
# ranks time-slice the card, so the decode pool's ITL under prefill load
# cannot show the pools' independence).

DP = 2
# kv_seq_shard: one 16000-token prompt into a 16384-entry cache, 8192
# entries a data rank, 32 new tokens, greedy
SEQ_JOB = dict(prompt=16000, max_len=16384, max_new=32)
DP1_SEQ: dict = {}       # the dp=1 wave of the long prompt (slot_phases' engine)
# the dp=1 paged phase the 1p1d disagg phase is held to: chunks of 64, no
# spec decode (the decode pool then runs paged_decode_attention)
DISAGG_REF = ("paged-chunked", "paged", dict(prefill_chunk=64))
# the JAX package's certification mix: int8 weights and int8 K/V, 2p2d
MIX_DP, MIX_SLOTS, MIX_FAULT = 4, 8, "migrate:handoff=1"
LSE_BYTES = 2 * 1 * HQ * (HD + 1) * 4     # l and acc of one merge, twice on the wire


def seq_prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(SEQ_JOB["prompt"]).integers(
        0, vocab, SEQ_JOB["prompt"]).astype(np.int32)


def seq_wave(eng) -> dict:
    """A greedy wave of the long prompt through the WaveScheduler on
    ``eng`` -> its tokens, the logits each step sampled from (on the
    host), the launches, the collectives, the wall and the peak memory."""
    from repro_torch.core import collectives as cc
    from repro_torch.kernels import ops
    from repro_torch.runtime.scheduler import WaveScheduler

    sched = WaveScheduler(eng, batch_size=1)
    sched.submit(seq_prompt(eng.cfg.vocab_size), max_new=SEQ_JOB["max_new"])
    log = []
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.monotonic()
    with sampled_logits(log), cc.comm_stats() as st:
        done = sched.run()
    torch.cuda.synchronize()
    return {"tokens": done[0].output, "logits": torch.cat(log).numpy(),
            "launches": dict(ops.LAUNCHES), "comm": st.by_tag(),
            "wall_s": time.monotonic() - t,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def seq_reference(dev, params, cfg) -> None:
    """The dp=1 wave the kv_seq_shard phase is held to, on the slot
    phases' yi-9b weights (48 layers), into DP1_SEQ."""
    from repro_torch.configs import SamplingConfig
    from repro_torch.runtime.engine import Engine

    t0 = time.monotonic()
    eng = Engine(cfg, sampling=SamplingConfig(top_k=1), max_len=SEQ_JOB["max_len"],
                 params=params, device=dev)
    torch.cuda.reset_peak_memory_stats()
    DP1_SEQ.update(seq_wave(eng), layers=cfg.n_layers)
    DP1_SEQ["phase_s"] = time.monotonic() - t0
    del eng
    torch.cuda.empty_cache()


def _dp_parting_logits(eng, job, streams, prompts, dev) -> dict:
    """Where a stream parts from the dp=1 phase's (``job["ref"]``): the
    logits after the prompt and the reference's tokens before the parting,
    by this rank's engine (a cacheless forward, replicated math)."""
    out = {}
    for rid, toks in streams.items():
        p = _parting(job, rid, toks, job["ref"][rid], prompts[rid])
        if p is not None:
            with torch.inference_mode():
                out[rid] = eng.forward(torch.as_tensor(p[1], device=dev)[None].long(),
                                       last_only=True)[0, -1].float().cpu().numpy()
    return out


def _disagg_run(eng, job, fault_plan: str = "") -> dict:
    """One DisaggScheduler run of the slot workload -> its streams, stats,
    pools, launches, collectives by tag, the allocator's audit, wall."""
    import argparse

    from repro_torch.core import collectives as cc
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime import kvcache
    from repro_torch.runtime.scheduler import DisaggScheduler

    sched = DisaggScheduler(eng, n_slots=job["slots"], prefill_shards=job["prefill_shards"],
                            prefill_chunk=job["chunk"], fault_plan=fault_plan)
    serve.submit_workload(sched, eng.cfg, argparse.Namespace(**SLOT_WORKLOAD))
    ops.reset_launches()
    torch.cuda.synchronize()
    t = time.monotonic()
    with cc.comm_stats() as st:
        done = sched.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    try:
        sched.alloc.audit(expect_no_migration=True)
        audit = "ok"
    except AssertionError as e:
        audit = str(e)
    return {"streams": {r.rid: r.output for r in done},
            "reasons": {r.rid: r.finish_reason for r in done},
            "errors": {r.rid: r.stats.get("error") for r in done if r.finish_reason == "error"},
            "prompts": {r.rid: r.prompt for r in done},
            "stats": {k: v for k, v in sched.stats.items() if not isinstance(v, dict)},
            "pools": sched.request_summary()["pools"], "launches": dict(ops.LAUNCHES),
            "comm": st.by_tag(), "audit": audit, "used": sched.alloc.total_used(),
            "block_bytes": kvcache.pool_block_bytes(sched.caches), "wall_s": wall}


def _dp_rank(dist, dev, jobs):
    """One rank of the data-axis phases (``dp_phases``): per job its result
    (see ``seq_wave`` and ``_disagg_run``), the init time and peak memory."""
    from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
    from repro_torch.models.common import Dist
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.kvcache import cache_bytes
    from repro_torch.runtime.scheduler import PagedContinuousScheduler

    out, params, weights = [], None, None
    for job in jobs:
        cfg = _dp_config(job)
        quant = job.get("quant", {})
        par = ParallelConfig(dp=dist.dp, kv_block_size=BLOCK, **quant,
                             kv_seq_shard=job["kind"] == "seq")
        key = (job["arch"], quant.get("weight_quant", "none"), cfg.n_layers)
        params = params if key == weights else None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        eng = Engine(cfg, parallel=par, sampling=SamplingConfig(top_k=1),
                     max_len=job["max_len"], seed=0, params=params, device=dev, dist=dist)
        torch.cuda.synchronize()
        params, weights = eng.params, key
        res = {"init_s": time.monotonic() - t0, "data_rank": dist.data_rank}
        if job["kind"] == "seq":
            res.update(seq_wave(eng))
            res["cache_gib"] = cache_bytes(eng.init_caches(1)) / 2**30
        else:
            res.update(_disagg_run(eng, job))
            if "ref" in job and dist.data_rank == 0:
                res["parting_logits"] = _dp_parting_logits(eng, job, res["streams"],
                                                           res["prompts"], dev)
            if job.get("fault"):
                res["fault"] = _disagg_run(eng, job, job["fault"])
            if job.get("dp1_ref") and dist.data_rank == 0:
                # the dp=1 unified paged engine on the same weights, this
                # rank's card: the streams the mix is held to
                import argparse

                from repro_torch.launch import serve
                one = Engine(cfg, parallel=ParallelConfig(kv_block_size=BLOCK, **quant),
                             sampling=SamplingConfig(top_k=1), max_len=job["max_len"],
                             params=eng.params, device=dev, dist=Dist())
                uni = PagedContinuousScheduler(one, n_slots=job["slots"],
                                               prefill_chunk=job["chunk"])
                serve.submit_workload(uni, cfg, argparse.Namespace(**SLOT_WORKLOAD))
                res["dp1"] = {r.rid: r.output for r in uni.run()}
                del one, uni
        res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        res["job_s"] = time.monotonic() - t0
        out.append(res)
        del eng
    return out


def _dp_config(job: dict):
    """A data-axis job's config: its arch at the job's depth (default all
    its layers)."""
    from repro_torch.configs import get_config

    cfg = get_config(job["arch"])
    return dataclasses.replace(cfg, n_layers=job.get("layers", cfg.n_layers))


def _dp_jobs(backend: str) -> list:
    """The data-axis phases' jobs: on DP = 2 ranks yi-9b bf16 at 48 layers
    through the kv_seq_shard wave and disaggregated 1p1d serving of the slot
    workload (held to the dp=1 paged-chunked phase); on MIX_DP = 4 ranks
    the certification mix (int8 weights and K/V) at 2p2d, clean and under
    MIX_FAULT, held to a dp=1 unified paged run on rank 0's card."""
    from repro_torch.configs import get_config

    ref = TP1_STREAMS.get(("yi-9b", "none", DISAGG_REF[0]))
    if ref is None or ref[0] != get_config("yi-9b").n_layers:
        fail(f"no dp=1 {DISAGG_REF[0]} phase of yi-9b at full depth to hold 1p1d to")
    disagg = dict(kind="disagg", arch="yi-9b", max_len=SERVE_MAX_LEN, chunk=64)
    two = [dict(name="kv-seq-shard dp=2", kind="seq", arch="yi-9b",
                max_len=SEQ_JOB["max_len"]),
           dict(disagg, name="disagg 1p1d", slots=SLOTS, prefill_shards=1, ref=ref[1])]
    if backend == "nccl":
        return [(DP, [two[1]])]
    # at a cut depth with the dp=1 run it is held to (the run's time limit)
    four = [dict(disagg, name="disagg 2p2d int8 mix", slots=MIX_SLOTS, prefill_shards=2,
                 quant=dict(weight_quant="int8", kv_quant=True), fault=MIX_FAULT,
                 dp1_ref=True, layers=phase_config("yi-9b", "2p2d int8 mix").n_layers)]
    return [(DP, two), (MIX_DP, four)]


def _dp_launch_roles(name: str, job: dict, ranks: list) -> None:
    """The pools' roles in the launches: a prefill-pool rank runs the chunk
    step's prefill kernel and never a decode kernel, a decode-pool rank the
    reverse (a step with no row of a rank's shard launches nothing there)."""
    for r in ranks:
        prefill = r["data_rank"] < job["prefill_shards"]
        la = r["launches"]
        chunk = la["flash_prefill"] + la["paged_flash_prefill"]
        dec = la["paged_decode_attention"] + la["paged_decode_attention_int8"]
        if (prefill and (dec or not chunk)) or (not prefill and (chunk or not dec)):
            fail(f"{name}: data rank {r['data_rank']} ({'prefill' if prefill else 'decode'} "
                 f"pool) launched {la}")


def dp_phases(dev, backend: str = "gloo"):
    """Phase 14: the data axis on one card (see the module docstring), each
    phase's result yielded once it is checked."""
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh

    for dp, jobs in _dp_jobs(backend):
        t0 = time.monotonic()
        got = mesh.spawn(_dp_rank, 1, jobs, backend=backend, device="cuda", dp=dp)
        spawn_s = time.monotonic() - t0
        for j, job in enumerate(jobs):
            cfg = _dp_config(job)
            L = cfg.n_layers
            ranks = [r[j] for r in got]
            name = f"{job['name']} {cfg.name}"
            r0 = ranks[0]
            res = {"arch": cfg.name, "scheduler": job["name"], "layers": L,
                   "params": cfg.param_count(), "ranks": dp, "backend": backend,
                   "note": "ranks share one card (gloo: host-staged collectives and block "
                           "transfers); no wall here is a data-parallel or disaggregated "
                           "speed" if backend == "gloo" else "",
                   "init_s": [r["init_s"] for r in ranks],
                   "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in ranks],
                   "launches": {k: sum(r["launches"][k] for r in ranks) for k in ops.KERNELS},
                   "launches_per_rank": [r["launches"] for r in ranks],
                   "ranks_spawn_to_exit_s": spawn_s}
            if job["kind"] == "seq":
                res.update(_check_seq(name, ranks, L))
            else:
                res.update(_check_disagg(name, job, ranks, L, dev, cfg))
            res["phase_s"] = max(r["job_s"] for r in ranks)
            yield res


def _check_seq(name: str, ranks: list, L: int) -> dict:
    """kv_seq_shard against the dp=1 wave (DP1_SEQ): every rank's stream
    the dp=1 one's, or a first parting certified by the dp=1 top-2 gap
    there; the logits within REF_TOL of the dp=1 ones up to the parting;
    one lse_merge all-reduce sum and max a layer and decode step and
    nothing else over the data axis but the stream check; the launches one
    prefill and the decode steps, on each rank."""
    if not DP1_SEQ or DP1_SEQ["layers"] != L:
        fail(f"{name}: no dp=1 wave of the long prompt at {L} layers to hold it to")
    n = SEQ_JOB["max_new"]
    want = DP1_SEQ["tokens"]
    expect = {k: 0 for k in ranks[0]["launches"]}
    expect.update(flash_prefill=L, decode_attention=L * (n - 1), topk=n)
    for r in ranks:
        toks = r["tokens"]
        if r["launches"] != expect:
            fail(f"{name} data rank {r['data_rank']}: launches {r['launches']} != {expect}")
        if not np.array_equal(toks, ranks[0]["tokens"]):
            fail(f"{name}: data rank {r['data_rank']}'s stream differs from rank 0's")
        merges = {k: v for k, v in r["comm"].items() if k.startswith("lse_merge")}
        per = L * (n - 1)
        if (merges.get("lse_merge (all_reduce)", {}).get("count") != per
                or merges.get("lse_merge (all_reduce_max)", {}).get("count") != per
                or merges["lse_merge (all_reduce)"]["bytes"] != per * LSE_BYTES):
            fail(f"{name}: lse_merge records {merges}, not {per} of each ({LSE_BYTES} B a sum)")
    toks = ranks[0]["tokens"]
    diff = np.flatnonzero(toks != want)
    t = int(diff[0]) if diff.size else n
    parted = []
    if diff.size:
        top2 = np.sort(DP1_SEQ["logits"][t])[-2:]
        gap = float(top2[1] - top2[0])
        if not gap < TIE_GAP:
            fail(f"{name}: parts from the dp=1 wave at step {t} with top-2 gap {gap}")
        parted.append({"step": t, "top2_gap": gap})
    err = float(np.abs(ranks[0]["logits"][:t + 1] - DP1_SEQ["logits"][:t + 1]).max())
    if not err <= REF_TOL:
        fail(f"{name}: logits {err} from the dp=1 wave's (limit {REF_TOL})")
    return {"prompt": SEQ_JOB["prompt"], "max_len": SEQ_JOB["max_len"], "max_new": n,
            "slice_per_rank": -(-SEQ_JOB["max_len"] // len(ranks)),
            "tokens": int(len(toks)), "logits_max_abs_diff_vs_dp1": err,
            "parted_at_near_ties": parted,
            "lse_merges_per_decode_step": L, "comm_run": ranks[0]["comm"],
            "wall_s": [r["wall_s"] for r in ranks],
            "ms_per_token": 1e3 * ranks[0]["wall_s"] / n,
            "dp1": {"wall_s": DP1_SEQ["wall_s"], "ms_per_token": 1e3 * DP1_SEQ["wall_s"] / n,
                    "peak_mem_gib": DP1_SEQ["peak_mem_gib"], "phase_s": DP1_SEQ["phase_s"]},
            "cache_gib_per_rank": [r["cache_gib"] for r in ranks],
            "first_tokens": toks[:8].tolist()}


def _check_disagg(name: str, job: dict, ranks: list, L: int, dev, cfg) -> dict:
    """A disagg run: every rank the same streams, pools and counters; the
    migrate sends' bytes migrated_blocks x pool_block_bytes; a prefix hit
    skipping copies; the pools' launch roles; the audit on every rank; the
    streams held to the dp=1 phase (partings certified as phase 9's, at
    most half), and under MIX_FAULT one request quarantined, the
    survivors' streams the clean run's."""
    from repro_torch.launch import serve

    r0 = ranks[0]
    for r in ranks:
        if {k: v.tolist() for k, v in r["streams"].items()} != \
                {k: v.tolist() for k, v in r0["streams"].items()}:
            fail(f"{name}: data rank {r['data_rank']}'s streams differ from rank 0's")
        counts = lambda st: {k: v for k, v in st.items() if isinstance(v, int)}
        if counts(r["stats"]) != counts(r0["stats"]) or r["audit"] != "ok" or r["used"]:
            fail(f"{name}: data rank {r['data_rank']}: stats {r['stats']} (rank 0 "
                 f"{r0['stats']}), audit {r['audit']}, {r['used']} blocks left")
    st, pools = r0["stats"], r0["pools"]
    if sorted(r0["streams"]) != list(range(SLOT_WORKLOAD["requests"])):
        fail(f"{name}: served {sorted(r0['streams'])}")
    for rid, toks in r0["streams"].items():
        if not (len(toks) and ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{name} request {rid}: tokens out of range or none: {toks}")
    sent = sum(r["comm"].get("migrate (send)", {"bytes": 0})["bytes"] for r in ranks)
    if not (st["migrated_blocks"] > 0 and sent == st["migrated_blocks"] * r0["block_bytes"]
            == st["migration_bytes"]):
        fail(f"{name}: migrate sends {sent} B != {st['migrated_blocks']} blocks x "
             f"{r0['block_bytes']} B ({st['migration_bytes']} counted)")
    # one decode shard (1p1d): once the shared prompt has landed there, every
    # later request's shared blocks are referenced instead of copied
    if not st["handoffs"] or (job["prefill_shards"] == 1 and not st["migration_skipped_blocks"]):
        fail(f"{name}: no handoff, or at 1p1d no decode-side prefix hit: {st}")
    _dp_launch_roles(name, job, ranks)
    lines = serve.disagg_lines(pools)
    for line in lines:
        print(f"{name}:{line}", flush=True)
    res = {"requests": len(r0["streams"]), "slots": job["slots"],
           "prefill_shards": job["prefill_shards"], "chunk": job["chunk"],
           "weight_quant": job.get("quant", {}).get("weight_quant", "none"),
           "kv_quant": job.get("quant", {}).get("kv_quant", False),
           "tokens": sum(len(t) for t in r0["streams"].values()),
           "stats": st, "pools": pools, "report_lines": lines,
           "block_bytes": r0["block_bytes"], "migrate_sent_bytes": sent,
           "wall_s": [r["wall_s"] for r in ranks],
           "comm_run": {k: v for k, v in r0["comm"].items()},
           "first_tokens": {rid: r0["streams"][rid][:8].tolist() for rid in (0, 1)}}
    if "ref" in job:
        tjob = dict(job, kind="paged", arch=cfg.name, quant="none", layers=L,
                    max_len=job["max_len"])
        res["parted_at_near_ties"] = _tp_parted(name, tjob, r0, job["ref"], dev, {},
                                                r0.get("parting_logits"))
    if "dp1" in r0:
        res["parted_from_dp1"] = _mix_parted(name, r0, dev, cfg, job)
    if "fault" in r0:
        f = r0["fault"]
        bad = [rid for rid, why in f["reasons"].items() if why == "error"]
        if not (len(bad) == 1 and f["stats"]["migration_faults"] == 1
                and "migration" in (f["errors"][bad[0]] or "")):
            fail(f"{name} under {MIX_FAULT}: quarantined {bad}, stats {f['stats']}")
        for rid, toks in f["streams"].items():
            if rid not in bad and not np.array_equal(toks, r0["streams"][rid]):
                fail(f"{name} under {MIX_FAULT}: survivor {rid}'s stream differs from the "
                     f"clean run's")
        for r in ranks:
            if r["fault"]["audit"] != "ok" or r["fault"]["used"]:
                fail(f"{name} under {MIX_FAULT}: data rank {r['data_rank']}'s audit "
                     f"{r['fault']['audit']}, {r['fault']['used']} blocks left")
        res["fault"] = {"plan": MIX_FAULT, "quarantined": bad, "stats": f["stats"],
                        "audit_every_rank": "ok", "wall_s": f["wall_s"]}
    return res


def _mix_parted(name: str, r0: dict, dev, cfg, job) -> list:
    """The mix's streams against the dp=1 unified paged run on rank 0's
    card: equal, or a first parting certified on the plain versions (int8
    weights and K/V, as the int8-KV slot phases certify one): at most
    MAX_PARTED.  The plain witness runs here on a dp=1 engine of the same
    seeded weights, drawn again."""
    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine

    ref, flips, eng = r0["dp1"], [], None
    for rid, toks in r0["streams"].items():
        want = ref[rid]
        p = _parting(dict(kind="paged"), rid, toks, want, r0["prompts"][rid])
        if p is None:
            continue
        t, seq = p
        if eng is None:
            eng = Engine(cfg, parallel=ParallelConfig(**job["quant"]),
                         sampling=SamplingConfig(top_k=1), max_len=job["max_len"], seed=0,
                         device=dev)
        x = torch.as_tensor(seq, device=dev)[None].long()
        with torch.inference_mode():
            logits = M.forward(eng.params, x, cfg, last_only=True,
                               caches=eng.init_caches(1), head_f32=eng.head_f32)[0, -1]
            with plain_on_card():
                plain = M.forward(eng.params, x, cfg, last_only=True,
                                  caches=eng.init_caches(1), head_f32=eng.head_f32)[0, -1]
        err = (logits - plain).abs().max().item()
        slack = [(plain.max() - plain[int(s[t])]).item() for s in (want, toks) if t < len(s)]
        if not (err <= REF_TOL and max(slack) < REF_TOL):
            fail(f"{name} request {rid} parts from the dp=1 run at step {t}: the plain "
                 f"versions there differ from the port by {err} and put the two tokens "
                 f"{slack} below their top (limit {REF_TOL} each)")
        flips.append({"rid": rid, "step": t, "plain_max_abs_err": err, "plain_slack": slack})
    if len(flips) > MAX_PARTED:
        fail(f"{name}: {len(flips)} of {len(ref)} streams part from the dp=1 run")
    del eng
    torch.cuda.empty_cache()
    return flips


def check_dp_rank_kernels(dev, flush) -> list:
    """Row 4s: decode_attention_partial at a kv_seq_shard rank's shape,
    yi-9b's (1, 32 over 4, 1, 128) over an 8192-entry slice with 8000
    valid, held to its plain version, with SDPA's time, its bound (the
    valid rows' bytes) and the split plan ``decode_split_plan`` chose; its
    launches are counted on the kv_seq_shard phase only."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(14)
    S, n_valid, scale = SEQ_JOB["max_len"] // DP, 8000, HD ** -0.5
    q = torch.randn((1, HQ, 1, HD), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((1, HKV, S, HD), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    valid = torch.arange(S, device=dev) < n_valid
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
    m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, scale)
    err = (acc / l[..., None] - acc2 / l2[..., None]).abs().max().item()
    if not err <= 1e-3:
        fail(f"decode_attention at a kv_seq_shard rank differs from its plain version by {err}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, splits = ops.decode_split_plan(1, HQ, HKV, S, sms)
    return [{
        "name": "decode_attention_partial (yi-9b kv_seq_shard rank slice)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:66", "counter": "decode_attention",
        "arches": ["yi-9b"], "phase_only": ["kv-seq-shard dp=2"],
        "shape": f"q (1,{HQ},1,{HD}) bf16, k/v (1,{HKV},{S},{HD}) ({n_valid} valid)",
        "split_plan": {"chunk": chunk, "splits": splits, "sms": sms,
                       "blocks": HKV * -(-(HQ // HKV) // ops.DECODE_ROWS) * splits},
        "library": "SDPA with a bool mask",
        "ptxas": ptxas_row("decode_attention", _dec(HD, False)),
        "max_abs_err": err, "tolerance": 1e-3,
        "ms": cold_ms(lambda: ops.decode_attention_partial(q, k, v, valid, scale), flush),
        "plain_ms": cold_ms(lambda: ref.decode_attention_ref(q, k, v, valid, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid[None, None, None, :], scale=scale, enable_gqa=True), flush),
        **bound(2 * q.numel() + 4 * HKV * n_valid * HD + valid.numel()
                + 4 * (m.numel() + l.numel() + acc.numel()), 4 * HD * HQ * n_valid,
                BF16_FLOPS)}]


# -- the control plane across ranks (phase 15) -------------------------------------
#
# yi-9b at full width and a cut depth (EARLIER_DEPTH "yi-9b control ranks")
# over a dp 2 x tp 2 world of gloo ranks sharing the card: phase 13's
# workload and plans through the whole serving control plane, world rank 0
# deciding what reads the wall clock and broadcasting it in a round record
# (tag ``control``).  The sync-debug check of phase 13's overlapped
# dispatches (``sync_checked_dispatch``) holds at tp = dp = 1 and under
# NCCL with a card a rank; over gloo every host-staged all-reduce copies
# to the host inside the dispatch, so it is not made here.  No wall of this
# phase is a speed: four ranks time-slice one card.

CP_DP, CP_TP = 2, 2
# what phases 10 and 11's serve lines say of their walls and TTFTs
BESIDE_CP = ("phase 15's four ranks ran on the card beside this phase: its walls and TTFTs "
             "are taken on a shared card and host")
# the class-mix run's requests whose deadline has passed at their first
# round (rank 0 retires them queued, every rank with it); the others get
# a deadline no run reaches
CP_LATE, CP_LATE_S, CP_FAR_S = (2, 7), 1e-6, 1e6
# (scheduler kind, its keywords, class mix, deadlines): the runs of every
# rank, and which of them the dp = tp = 1 reference runs too
CP_RUNS = {
    "dense blocking": ("dense", {}, "", False),
    "dense overlapped": ("dense", {"overlap": True}, "", False),
    "paged blocking": ("paged", {}, "", False),
    "paged overlapped": ("paged", {"overlap": True}, "", False),
    "paged faults": ("paged", {"overlap": True, "fault_plan": CP_FAULTS,
                               "retry_backoff_s": 0.0}, "", False),
    "dense ladder": ("dense", {"fault_plan": CP_BURST, "overload_opts": {"enabled": True}},
                     CP_CLASS_MIX, True),
    "disagg": ("disagg", {"prefill_chunk": 64, "prefill_shards": 1}, CP_CLASS_MIX, False),
    "disagg ladder": ("disagg", {"prefill_chunk": 64, "prefill_shards": 1, "reserve_blocks": 1,
                                 "fault_plan": CP_BURST, "overload_opts": {"enabled": True},
                                 "overlap": True}, CP_CLASS_MIX, False),
}
CP_DP1_RUNS = {"dense blocking": None, "paged blocking": None, "paged faults": None,
               "dense ladder": None, "paged chunked": ("paged", {"prefill_chunk": 64},
                                                      CP_CLASS_MIX, False)}
# what each run's streams are held to: a dp = tp = 1 run ("dp1 ...") or,
# for the requests it served, another run of the same world (a preemption,
# a shed or a timeout changes who shares a batch, so a survivor may part
# at a near-tie, as in phase 13).  The frontend's batches follow HTTP
# timing, so which near-ties flip changes from run to run (on the H100 at
# 8 layers 3, 1 and 3 of its 4 streams, against dp=1 or the world's
# blocking run): each of its partings is certified, but half of four does
# not bound their count, and the frontend is held to none
CP_HELD = {"dense blocking": "dp1 dense blocking", "paged blocking": "dp1 paged blocking",
           "disagg": "dp1 paged chunked", "frontend": "dp1 dense blocking",
           "paged faults": "paged overlapped", "dense ladder": "dense blocking",
           "disagg ladder": "disagg"}


def cp_workload(cfg, class_mix: str = "") -> list:
    """Phase 13's workload as (prompt, max_new, arrival_step, priority): the
    draws of ``serve.submit_workload``."""
    import argparse

    from repro_torch.launch import serve

    reqs = []

    class Recorder:
        def submit(self, prompt, max_new, arrival_step=0, priority="standard"):
            reqs.append((np.asarray(prompt, np.int32), max_new, arrival_step, priority))

    serve.submit_workload(Recorder(), cfg,
                          argparse.Namespace(**SLOT_WORKLOAD, class_mix=class_mix))
    return reqs


def cp_run(eng, kind: str, kw: dict, class_mix: str, deadlines: bool) -> dict:
    """One run of phase 13's workload through ``kind``'s scheduler on
    ``eng`` (any world) -> its streams, finish reasons, (rid, token)
    emission trace, retire order, counters, the ladder's level after every
    round and its transitions, the control records and rounds, the wall."""
    from repro_torch.core import collectives as cc
    from repro_torch.runtime.scheduler import (ContinuousScheduler, DisaggScheduler,
                                               PagedContinuousScheduler)

    cls = {"dense": ContinuousScheduler, "paged": PagedContinuousScheduler,
           "disagg": DisaggScheduler}[kind]
    sched = cls(eng, n_slots=SLOTS, **({"prefill_chunk": 0} | kw))
    events = []
    sched.on_token = lambda rid, t: events.append((rid, int(t)))
    for i, (p, mn, arr, prio) in enumerate(cp_workload(eng.cfg, class_mix)):
        dl = (CP_LATE_S if i in CP_LATE else CP_FAR_S) if deadlines else None
        sched.submit(p, mn, arrival_step=arr, priority=prio, deadline_s=dl)
    levels = []
    torch.cuda.synchronize()
    t = time.monotonic()
    with cc.comm_stats() as st:
        while sched.serve_step():
            levels.append(sched.overload_level())
        done = sched.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t
    if kind != "dense":
        sched.alloc.audit(expect_no_migration=True)
    ctl = sched.overload_ctl
    return {"streams": {r.rid: r.output for r in done},
            "reasons": {r.rid: r.finish_reason for r in done},
            "prompts": {r.rid: r.prompt for r in done},
            "classes_of": {r.rid: r.priority for r in done},
            "events": events, "order": [r.rid for r in done],
            "stats": {k: v for k, v in sched.stats.items() if not isinstance(v, dict)},
            "classes": sched.stats["classes"], "counters": sched.control_counters(),
            "levels": levels, "transitions": None if ctl is None else list(ctl.transitions),
            "control": st.by_tag().get("control (broadcast)", {"count": 0, "bytes": 0}),
            "rounds": len(levels) + 2, "wall_s": wall,
            "pools": sched.request_summary().get("pools")}


def _cp_post(port, body):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    c.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def _cp_sse(raw: bytes) -> list:
    toks = []
    for ev in raw.decode().split("\n\n"):
        if ev.startswith("data: {"):
            toks += json.loads(ev[6:])["choices"][0].get("token_ids", [])
    return toks


def cp_frontend(eng, dist) -> dict:
    """(e): the HTTP frontend over the overlapped continuous scheduler.
    World rank 0 serves on 127.0.0.1 and its client threads post: the
    workload's first 4 prompts as concurrent SSE streams, 6 concurrent
    requests of 32 tokens against max_pending SLOTS, and a stream in flight
    when the drain begins; every other rank follows the round records
    until the stop record."""
    import asyncio
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.frontend import EngineService, HttpFrontend, follow
    from repro_torch.runtime.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(eng, n_slots=SLOTS, prefill_chunk=0, overlap=True)
    reqs = cp_workload(eng.cfg)
    # the SSE clients' requests are the scheduler's first four, on every
    # rank: their retired outputs by workload rid
    rid_of = {tuple(p.tolist()): i for i, (p, *_) in enumerate(reqs[:4])}

    def sse_outputs():
        return {rid_of[tuple(r.prompt.tolist())]: r.output for r in sched.done if r.rid < 4}

    if dist.world_rank != 0:
        follow(sched)
        return {"done": len(sched.done), "counters": sched.control_counters(),
                "sse_outputs": sse_outputs()}
    service = EngineService(sched, max_pending=SLOTS, idle_wait_s=0.002)
    frontend = HttpFrontend(service, port=0)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=lambda: (asyncio.set_event_loop(loop),
                                              loop.run_until_complete(frontend.start()),
                                              loop.run_forever()), daemon=True)
    thread.start()
    deadline = time.monotonic() + 120
    while frontend._server is None:
        if time.monotonic() > deadline:
            raise RuntimeError("frontend: the server did not start")
        time.sleep(0.01)
    port = frontend.port
    with ThreadPoolExecutor(6) as pool:
        streamed = list(pool.map(lambda r: _cp_post(port, {"prompt": r[0].tolist(),
                                                           "max_tokens": r[1], "stream": True}),
                                 reqs[:4]))
        overload = list(pool.map(lambda r: _cp_post(port, {"prompt": r[0].tolist(),
                                                           "max_tokens": 32}), reqs[4:10]))
        fut = pool.submit(_cp_post, port, {"prompt": reqs[0][0].tolist(), "max_tokens": 32,
                                           "stream": True})
        time.sleep(0.5)
        asyncio.run_coroutine_threadsafe(frontend.stop(), loop).result(timeout=300)
        drained = fut.result(timeout=300)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=60)
    loop.close()
    try:
        _cp_post(port, {"prompt": [1, 2], "max_tokens": 1})
        listening = True
    except OSError:
        listening = False
    return {"done": len(sched.done), "counters": sched.control_counters(),
            "sse_outputs": sse_outputs(),
            "streamed": [(st, _cp_sse(raw)) for st, _, raw in streamed],
            "overload": [(st, h.get("Retry-After"),
                          len(json.loads(data)["choices"][0]["token_ids"]) if st == 200 else 0)
                         for st, h, data in overload],
            "drained": (drained[0], len(_cp_sse(drained[2]))), "listening": listening,
            "shed_requests": sched.stats["shed_requests"]}


def cp_parting_logits(eng, dist, streams: dict, want: dict, prompts: dict) -> dict:
    """Where a stream parts from the dp=1 run's ``want``: this rank's
    replica's logits (gathered over the vocab) after the prompt and
    ``want``'s tokens before the parting, a cacheless forward; the same
    forwards on every rank, since the streams are."""
    from repro_torch.core import collectives as cc

    out = {}
    for rid in sorted(want):
        a, b = np.asarray(streams[rid]), np.asarray(want[rid])
        n = min(len(a), len(b))
        if np.array_equal(a, b) or not (a[:n] != b[:n]).any():
            continue
        t = int(np.argmax(a[:n] != b[:n]))
        seq = np.concatenate([prompts[rid], b[:t]])
        with torch.inference_mode():
            lg = eng.forward(torch.as_tensor(seq, device=eng.device)[None].long(),
                             last_only=True)[0, -1]
            lg = cc.all_gather(lg.float(), dist, lg.dim() - 1)[..., :eng.cfg.vocab_size]
        out[rid] = lg.cpu().numpy()
    return out


def _cp_rank(dist, dev, layers: int, want: dict) -> dict:
    """One rank of phase 15: every run of CP_RUNS, then the frontend; its
    launches over all of them, the init time, the peak memory, and its
    replica's logits where a stream parts from the dp=1 run it is held to
    (``want``: run -> streams)."""
    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.kernels import ops
    from repro_torch.runtime.engine import Engine

    cfg = dataclasses.replace(phase_config("yi-9b", "control ranks"), n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = Engine(cfg, parallel=ParallelConfig(tp=dist.tp, dp=dist.dp, kv_block_size=BLOCK),
                 sampling=SamplingConfig(top_k=1), max_len=SERVE_MAX_LEN, seed=0, device=dev,
                 dist=dist)
    torch.cuda.synchronize()
    out = {"world_rank": dist.world_rank, "init_s": time.monotonic() - t0, "runs": {}}
    ops.reset_launches()
    for name, run in CP_RUNS.items():
        out["runs"][name] = cp_run(eng, *run)
    t = time.monotonic()
    out["frontend"] = cp_frontend(eng, dist)
    out["frontend"]["wall_s"] = time.monotonic() - t
    out["launches"] = dict(ops.LAUNCHES)
    prompts = {i: p for i, (p, *_) in enumerate(cp_workload(cfg))}
    streams = {k: v["streams"] for k, v in out["runs"].items()}
    streams["frontend"] = out["frontend"]["sse_outputs"]
    out["parting_logits"] = {}
    for run, key in CP_HELD.items():
        ref = want[key[4:]] if key.startswith("dp1 ") else streams[key]
        reasons = out["runs"].get(run, {}).get("reasons", {})
        held = {rid: ref[rid] for rid in streams[run]
                if rid in ref and reasons.get(rid, "length") in ("stop", "length")}
        out["parting_logits"][run] = cp_parting_logits(eng, dist, streams[run], held, prompts)
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["rank_s"] = time.monotonic() - t0
    # phase 16 (c) in the same world, after phase 15's work
    t = time.monotonic()
    out["train"] = _train_rank(dist, dev, (False, True))
    out["train_s"] = time.monotonic() - t
    return out


def control_ranks_start(dev) -> dict:
    """Phase 15's first half: the dp = tp = 1 references on this process's
    card (rank 0's; the engine freed after them, drawn again from its seed
    for the checks), then the spawn of the dp 2 x tp 2 world in a thread
    that only waits for the ranks, while this process's own CUDA work goes
    on in the main thread (phases 10 and 11 run beside the ranks: their
    peaks leave the ranks' 4 x ~4.3 GiB room, and they time no kernel);
    -> the state ``control_ranks_phase`` checks."""
    import threading

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.launch import mesh
    from repro_torch.runtime.engine import Engine

    st = {"t_phase": time.monotonic(), "cfg": phase_config("yi-9b", "control ranks")}
    st["eng"] = Engine(st["cfg"], parallel=ParallelConfig(kv_block_size=BLOCK),
                       sampling=SamplingConfig(top_k=1), max_len=SERVE_MAX_LEN, seed=0,
                       device=dev)
    st["ref"] = ref = {k: cp_run(st["eng"], *(run or CP_RUNS[k]))
                       for k, run in CP_DP1_RUNS.items()}
    torch.cuda.synchronize()
    st["ref_s"] = time.monotonic() - st["t_phase"]
    want = {k: ref[k]["streams"] for k in ("dense blocking", "paged blocking", "paged chunked")}
    # the fault run's scheduler left its hook on the engine (a cycle): drop
    # it, so that the engine's memory is free while phases 10 and 11 run
    st.pop("eng").dispatch_hook = None
    gc.collect()
    torch.cuda.empty_cache()

    def ranks():
        t = time.monotonic()
        try:
            st["got"] = mesh.spawn(_cp_rank, CP_TP, st["cfg"].n_layers, want, backend="gloo",
                                   device="cuda", dp=CP_DP)
        except BaseException as e:       # reported by control_ranks_phase
            st["error"] = e
        st["spawn_s"] = time.monotonic() - t

    st["thread"] = threading.Thread(target=ranks, daemon=True)
    st["thread"].start()
    return st


def control_ranks_phase(dev, st: dict) -> dict:
    """Phase 15's checks (see the module docstring), once the ranks started
    by ``control_ranks_start`` have ended: every parting from the
    reference certified by its top-2 gap there (< TIE_GAP) or the
    replica's own logits, at most MAX_PARTED a run."""
    from repro_torch.kernels import ops

    from repro_torch.configs import ParallelConfig, SamplingConfig
    from repro_torch.runtime.engine import Engine

    t_wait = time.monotonic()
    st["thread"].join()
    if "error" in st:
        fail(f"phase 15: the dp {CP_DP} x tp {CP_TP} ranks failed: {st['error']!r}")
    t_phase, cfg, ref = st["t_phase"], st["cfg"], st["ref"]
    wait_s = time.monotonic() - t_wait
    # the dp=1 engine of the references again, from its seed: the witness
    eng = Engine(cfg, parallel=ParallelConfig(kv_block_size=BLOCK),
                 sampling=SamplingConfig(top_k=1), max_len=SERVE_MAX_LEN, seed=0, device=dev)
    ref_s, spawn_s, got = st["ref_s"], st["spawn_s"], st["got"]
    L = cfg.n_layers
    name = f"control plane dp={CP_DP} x tp={CP_TP}"
    want = {k: ref[k]["streams"] for k in ("dense blocking", "paged blocking", "paged chunked")}
    r0 = got[0]
    print(f"{name}: dp=1 references {ref_s:.1f}s, ranks {spawn_s:.1f}s (runs "
          + ", ".join(f"{k} {v['wall_s']:.1f}s" for k, v in r0["runs"].items())
          + f", frontend {r0['frontend']['wall_s']:.1f}s)", flush=True)

    def logits(seq) -> torch.Tensor:
        with torch.inference_mode():
            return eng.forward(torch.as_tensor(seq, device=dev)[None].long(),
                               last_only=True)[0, -1].float()

    def parted(what, streams, rids, cap: bool = True) -> list:
        """Each stream of run ``what`` (rids ``rids``) against the stream it
        is held to (CP_HELD): equal, or a first parting certified by the
        dp=1 top-2 gap there (< TIE_GAP), or else, as phase 9 certifies a
        tp parting, by the replica's own logits there (``_tp_witness``);
        with ``cap``, at most half of ``rids`` parted (``_at_most_half``)."""
        key = CP_HELD[what]
        held = want[key[4:]] if key.startswith("dp1 ") else runs[key]["streams"]
        flips = []
        for rid in rids:
            a, b = np.asarray(streams[rid]), np.asarray(held[rid])
            n = min(len(a), len(b))
            if np.array_equal(a, b) or not (a[:n] != b[:n]).any():
                continue
            t = int(np.argmax(a[:n] != b[:n]))
            seq = np.concatenate([r0["runs"]["dense blocking"]["prompts"][rid], b[:t]])
            lg = logits(seq)
            top2 = torch.topk(lg, 2).values
            flip = {"rid": rid, "step": t, "top2_gap": float(top2[0] - top2[1])}
            if not flip["top2_gap"] < TIE_GAP:
                tp = r0["parting_logits"][what].get(rid)
                if tp is None:
                    fail(f"{name} {what}: no replica logits at request {rid}'s parting")
                tp = torch.as_tensor(tp, device=dev)
                with plain_on_card():
                    plain = logits(seq)
                slack = [(lg.max() - lg[int(a[t])]).item(), (tp.max() - tp[int(b[t])]).item()]
                flip.update(_tp_witness(f"{name} {what}", rid, t,
                                        (lg - plain).abs().max().item(),
                                        (tp - lg).abs().max().item(), slack))
            flips.append(flip)
        if cap:
            _at_most_half(f"{name} {what} (held to {key})", len(flips), len(rids))
        return flips

    same = lambda a, b: sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    # every rank: the same streams, outcomes, order, levels and counters
    for run in list(CP_RUNS) + ["frontend"]:
        for r in got[1:]:
            x, y = (r0[run], r[run]) if run == "frontend" else (r0["runs"][run], r["runs"][run])
            keys = ("done", "counters") if run == "frontend" else (
                "reasons", "order", "levels", "transitions", "counters")
            streams = "sse_outputs" if run == "frontend" else "streams"
            if any(x[k] != y[k] for k in keys) or not same(x[streams], y[streams]):
                fail(f"{name} {run}: world rank {r['world_rank']} parted from rank 0")
    # a record every round of every run, on every rank: its length and its
    # payload; the host seconds each rank spent in the exchange
    for r in got:
        for run, x in r["runs"].items():
            if x["control"]["count"] != 2 * x["rounds"]:
                fail(f"{name} {run}: world rank {r['world_rank']} made {x['control']['count']} "
                     f"control broadcasts in {x['rounds']} rounds, not two a round")
    runs = r0["runs"]
    control = {run: {"rounds": x["rounds"], "broadcasts": x["control"]["count"],
                     "bytes": x["control"]["bytes"],
                     "seconds_per_rank": [r["runs"][run]["stats"]["control_s"] for r in got],
                     "rank0_ms_per_round": 1e3 * x["stats"]["control_s"] / x["rounds"]}
               for run, x in runs.items()}
    res = {"arch": cfg.name, "scheduler": name, "layers": L, "ranks": CP_DP * CP_TP,
           "backend": "gloo", "kv_quant": False,
           "note": "four ranks share one card (gloo: host-staged collectives); no wall here "
                   "is a speed",
           "launches": {k: sum(r["launches"][k] for r in got) for k in ops.KERNELS},
           "launches_per_rank": [r["launches"] for r in got],
           "init_s": [r["init_s"] for r in got],
           "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in got],
           "rank_s": [r["rank_s"] for r in got], "dp1_reference_s": ref_s,
           "ranks_spawn_to_exit_s": spawn_s, "waited_for_ranks_s": wait_s,
           "control_record": control, "runs": {}}
    # (a) the overlapped loop against the blocking one at the same world,
    # and both against the dp=1 blocking run
    for kind in ("dense", "paged"):
        b, o = runs[f"{kind} blocking"], runs[f"{kind} overlapped"]
        if not (same(b["streams"], o["streams"]) and b["events"] == o["events"]
                and b["order"] == o["order"]):
            fail(f"{name} {kind}: the overlapped loop's streams, emission trace or retire "
                 f"order differ from the blocking loop's")
        if not (o["stats"]["landings"] > 0 and o["stats"]["max_dispatch_ahead"] >= 2):
            fail(f"{name} {kind}: the overlapped loop never ran ahead: {o['stats']}")
        flips = parted(f"{kind} blocking", b["streams"], b["streams"])
        res["runs"][kind] = {"wall_s": [b["wall_s"], o["wall_s"]],
                             "host_blocked_s": [b["stats"]["host_blocked_s"],
                                                o["stats"]["host_blocked_s"]],
                             "host_overlap_s": o["stats"]["host_overlap_s"],
                             "landings": o["stats"]["landings"],
                             "max_dispatch_ahead": o["stats"]["max_dispatch_ahead"],
                             "parted_from_dp1": flips}
    # (b) the fault plan: dp=1's quarantine, retries and preemptions, the
    # survivors the clean overlapped run's at this world
    f, f1 = runs["paged faults"], ref["paged faults"]
    bad = sorted(rid for rid, why in f["reasons"].items() if why == "error")
    keys = ("step_faults", "step_retries", "quarantined", "preemptions")
    counts = {k: f["stats"][k] for k in keys}
    if not (bad == sorted(rid for rid, why in f1["reasons"].items() if why == "error")
            and len(bad) == 1 and counts == {k: f1["stats"][k] for k in keys}
            and counts["step_retries"] == 2 and counts["quarantined"] == 1):
        fail(f"{name} faults: quarantined {bad}, {counts}; dp=1: {f1['reasons']}, "
             f"{ {k: f1['stats'][k] for k in keys} }")
    ff = parted("paged faults", f["streams"], [rid for rid in f["streams"] if rid not in bad])
    res["runs"]["faults"] = {"plan": CP_FAULTS, "quarantined": bad, "counts": counts,
                             "survivors_parted_from_clean": ff, "wall_s": f["wall_s"]}
    # (c) classes, the ladder, a burst and deadlines: dp=1's levels,
    # transitions, sheds and timeouts; the survivors the dense run's
    c, c1 = runs["dense ladder"], ref["dense ladder"]
    shed = sorted(rid for rid, why in c["reasons"].items() if why == "shed")
    late = sorted(rid for rid, why in c["reasons"].items() if why == "timeout")
    kept = [rid for rid in runs["dense blocking"]["streams"]
            if c["reasons"][rid] in ("stop", "length")]
    if not (c["levels"] == c1["levels"] and c["transitions"] == c1["transitions"]
            and max(c["levels"]) >= 1 and shed and late == sorted(CP_LATE)
            and c["reasons"] == c1["reasons"] and c["stats"]["burst_injected"] == 12
            and all(c["classes_of"][rid] == "batch" for rid in shed)):
        fail(f"{name} ladder: levels {c['levels']} (dp=1 {c1['levels']}), shed {shed}, "
             f"timed out {late}, {c['stats']}")
    kf = parted("dense ladder", c["streams"], kept)
    res["runs"]["ladder"] = {"survivors_parted_from_unloaded": kf, "class_mix": CP_CLASS_MIX, "burst": CP_BURST, "levels": c["levels"],
                             "transitions": c["transitions"], "shed": shed, "timed_out": late,
                             "kept": len(kept), "wall_s": c["wall_s"]}
    # (d) disagg 1p1d at dp 2 x tp 2: the plain run held to the dp=1
    # unified paged one at the same chunk width; with the ladder (and the
    # overlapped loop), interactive never shed and the survivors the plain
    # run's
    d, dl = runs["disagg"], runs["disagg ladder"]
    flips = parted("disagg", d["streams"], d["streams"])
    dshed = [rid for rid, why in dl["reasons"].items() if why == "shed"]
    if not (dl["classes"]["interactive"]["shed"] == 0 and dshed
            and max(dl["levels"]) >= 1 and dl["stats"]["landings"] > 0
            and all(dl["classes_of"][rid] == "batch" for rid in dshed)):
        fail(f"{name} disagg ladder: levels {dl['levels']}, shed {dshed}, {dl['classes']}")
    df = parted("disagg ladder", dl["streams"],
                [rid for rid, why in dl["reasons"].items()
                 if why in ("stop", "length") and rid in d["streams"]])
    res["runs"]["disagg"] = {"pools": d["pools"], "parted_from_dp1": flips,
                             "ladder_survivors_parted_from_plain": df,
                             "ladder_levels": dl["levels"], "ladder_shed": dshed,
                             "wall_s": [d["wall_s"], dl["wall_s"]]}
    # (e) the HTTP frontend: the clients' tokens the dp=1 run's, a 429, the
    # drain served the stream in flight and ended every rank
    fe, dense1 = r0["frontend"], ref["dense blocking"]["streams"]
    sse = {rid: np.asarray(toks, np.int32) for rid, (st, toks) in enumerate(fe["streamed"])}
    if any(st != 200 for st, _ in fe["streamed"]) or any(
            len(sse[rid]) != len(dense1[rid]) or not np.array_equal(
                sse[rid], fe["sse_outputs"][rid]) for rid in sse):
        fail(f"{name} frontend: the SSE clients got {fe['streamed']}, the scheduler retired "
             f"{fe['sse_outputs']}")
    ff = parted("frontend", sse, sse, cap=False)      # see CP_HELD
    statuses = [st for st, _, _ in fe["overload"]]
    if not (statuses.count(429) >= 1 and fe["shed_requests"] == statuses.count(429)
            and all(ra == "1" for st, ra, _ in fe["overload"] if st == 429)
            and all(n == 32 for st, _, n in fe["overload"] if st == 200)
            and fe["drained"] == (200, 32) and not fe["listening"]):
        fail(f"{name} frontend: statuses {fe['overload']}, drained {fe['drained']}, "
             f"listening {fe['listening']}")
    res["runs"]["frontend"] = {"parted_from_dp1": ff, "overload_statuses": statuses,
                               "drained_tokens": fe["drained"][1], "wall_s": fe["wall_s"],
                               "ranks_ended": len(got)}
    res["phase_s"] = time.monotonic() - t_phase
    res["note"] += "; its ranks ran beside phases 10 and 11"
    del eng
    torch.cuda.empty_cache()
    return res


# -- phase 16: training (PR 30) ----------------------------------------------

TRAIN_ARCHS = ("yi-9b", "deepseek-moe-16b")   # (a): reduced, fp32, card against the CPU
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_BATCH = dict(global_batch=4, seq_len=32)
TRAIN_LOSS_TOL, TRAIN_PARAM_TOL, TRAIN_ZERO_TOL = 1e-4, 5e-4, 1e-3
ROUTER_TIE_TRAIN = 1e-3     # a router near-tie the card's fp32 may rank the other way
# (b): yi-9b at full width, 4 of 48 layers, through launch/train.py; lr 1e-3
# (the driver's default 3e-3, the reference's for its reduced widths, made
# the loss climb from 11.6 to 12-14 at d_model 4096: PERF.md section 6)
TRAIN_FULL_ARGV = ["--arch", "yi-9b", "--full", "--layers", "4", "--global-batch", "8",
                   "--seq-len", "128", "--steps", "20", "--log-every", "1", "--lr", "1e-3"]


def _train_steps(cfg, dev, par, *, zero1=False, dist=None, routes=None, steps=2):
    """``steps`` make_train_step steps of reduced ``cfg`` on ``dev`` from the
    seed-0 weights drawn on the CPU (fp32) -> (the whole model's tree after
    them on the host, each step's metrics, each MoE layer call's top
    experts and probabilities, the first step's collectives by tag).
    ``routes``: the top experts to replay (``moe.ROUTE_REPLAY``)."""
    from repro_torch.core import collectives as cc
    from repro_torch.launch.train import gather_tree
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.common import Dist
    from repro_torch.training import data as D
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import AdamWConfig

    ctx = M.ModelCtx.make(cfg, par, dist or Dist())
    tree = {k: t.to(dev) for k, t in TL.init_tree(cfg, ctx, device="cpu",
                                                   dtype=torch.float32).items()}
    fn = TL.make_train_step(ctx, AdamWConfig(**TRAIN_OPT), zero1=zero1)
    opt = TL.init_state(tree, ctx, zero1=zero1)
    dc = D.DataConfig(**TRAIN_BATCH)
    moe.LOG = []
    moe.ROUTE_REPLAY = None if routes is None else [r.to(dev) for r in routes]
    metrics, comm = [], {}
    try:
        for i in range(steps):
            with cc.comm_stats() as st:
                tree, opt, m = fn(tree, opt, TL.local_batch(D.make_batch(cfg, dc, i), ctx.dist,
                                                            dev))
            metrics.append({k: float(v) for k, v in m.items()})
            comm = comm or st.by_tag()
        log = [(r["top_e"].cpu(), r["probs"].detach().cpu()) for r in moe.LOG]
    finally:
        moe.LOG = moe.ROUTE_REPLAY = None
    whole = gather_tree(tree, ctx)
    return {k: t.detach().float().cpu() for k, t in whole.items()}, metrics, log, comm


def _tree_err(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def train_reference_check(dev) -> list:
    """Phase 16 (a): reduced yi-9b and deepseek-moe-16b, fp32 weights, TF32
    off, two make_train_step steps on the card against the same on the CPU:
    the loss within TRAIN_LOSS_TOL relative, the weights within
    TRAIN_PARAM_TOL.  Where the card's router ranks a token apart from the
    CPU's, that token must be a near-tie (< ROUTER_TIE_TRAIN in
    probability), and the card runs again replaying the CPU's routes
    (``moe.ROUTE_REPLAY``); the line counts them.  deepseek runs without
    activation checkpointing, so each forward routes once."""
    from repro_torch.configs import ParallelConfig, get_config

    out = []
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        par = ParallelConfig(remat=cfg.moe is None)
        cpu, cpu_m, cpu_log, _ = _train_steps(cfg, "cpu", par)
        card, card_m, card_log, _ = _train_steps(cfg, dev, par)
        apart = 0
        for (te_c, p_c), (te_g, _) in zip(cpu_log, card_log):
            diff = (te_c.sort(1).values != te_g.sort(1).values).any(1)
            for t in torch.nonzero(diff)[:, 0]:
                own = [e for e in te_g[t].tolist() if e not in te_c[t].tolist()]
                other = [e for e in te_c[t].tolist() if e not in te_g[t].tolist()]
                margin = float(p_c[t, other].min() - p_c[t, own].max())
                if not margin < ROUTER_TIE_TRAIN:
                    fail(f"phase 16 {arch}: the card routes token {int(t)} apart from the "
                         f"CPU by {margin} in probability")
                apart += 1
        if apart:
            card, card_m, _, _ = _train_steps(cfg, dev, par, routes=[r for r, _ in cpu_log])
        loss_err = max(abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(card_m, cpu_m))
        err = _tree_err(card, cpu)
        row = {"phase": 16, "arch": cfg.name, "what": "train steps, card against the CPU",
               "steps": len(card_m), "loss": [m["loss"] for m in card_m],
               "loss_rel_err": loss_err, "param_max_abs_err": err, "remat": par.remat,
               "router_tokens_replayed": apart}
        if not (loss_err <= TRAIN_LOSS_TOL and err <= TRAIN_PARAM_TOL):
            fail(f"phase 16 {arch}: card against CPU {row}")
        out.append((row, cpu))
    return out


def _train_rank(dist, device, zero1_cases):
    """Phase 16 (c), one rank of the dp x tp world: reduced yi-9b's two
    steps from the seed-0 weights, AdamW and ZeRO-1 -> each case's whole
    model, metrics and first-step collectives by tag."""
    from repro_torch.configs import ParallelConfig, get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCHS[0]).reduced()
    out = {}
    for zero1 in zero1_cases:
        tree, metrics, _, comm = _train_steps(cfg, device, ParallelConfig(tp=dist.tp,
                                                                          dp=dist.dp),
                                              zero1=zero1, dist=dist)
        out[zero1] = {"tree": tree, "metrics": metrics, "comm": comm}
    return out


def train_ranks_phase(got: list, dp1: dict) -> dict:
    """Phase 16 (c)'s checks, on what phase 15's ranks returned (``_cp_rank``
    runs ``_train_rank`` after its own work): every rank's whole model
    after two steps within TRAIN_PARAM_TOL (AdamW) and TRAIN_ZERO_TOL
    (ZeRO-1) of (a)'s dp = 1 run on the CPU (the same weights and
    batches)."""
    row = {"phase": 16, "arch": "yi-9b-smoke", "what": f"train at dp {CP_DP} x tp {CP_TP}, "
           "gloo ranks on the card (phase 15's world)",
           "rank_s": max(r["train_s"] for r in got)}
    for zero1, tol in ((False, TRAIN_PARAM_TOL), (True, TRAIN_ZERO_TOL)):
        name = "zero1" if zero1 else "adamw"
        errs = [_tree_err(r["train"][zero1]["tree"], dp1) for r in got]
        row[name] = {"param_max_abs_err": max(errs), "loss": got[0]["train"][zero1]["metrics"],
                     "comm_first_step": got[0]["train"][zero1]["comm"]}
        if not max(errs) <= tol:
            fail(f"phase 16 dp {CP_DP} x tp {CP_TP} {name}: {max(errs)} from dp=1")
    return row


def train_full_phase(dev) -> dict:
    """Phase 16 (b): yi-9b at full width and 4 of 48 layers through
    launch/train.py (bf16, global batch 8 x 128, 20 steps, --ckpt): every
    loss and grad norm finite, min(last 5 losses) < the first, no kernel
    launched (the training forward reaches none: yi-9b routes nothing), the
    checkpoint restored on the card bit-equal, and its weights giving the
    next batch's loss exactly; its peak memory and ms a step."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.training import checkpoint, data
    from repro_torch.training import train_loop as TL
    from repro_torch.training.optimizer import AdamWConfig

    t0 = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "yi-9b-4.npz")
        args = train.build_parser().parse_args(TRAIN_FULL_ARGV + ["--ckpt", path])
        run = train.train(args, device=dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        restored, step = checkpoint.restore(path, run.tree)
    losses = [h["loss"] for h in run.history]
    gnorms = [h["grad_norm"] for h in run.history]
    same = all(torch.equal(restored[k], t.detach()) for k, t in run.tree.items())
    cfg = train.config_of(args)
    fn = TL.make_train_step(run.ctx, AdamWConfig())
    batch = TL.local_batch(data.make_batch(cfg, data.DataConfig(args.global_batch, args.seq_len),
                                           args.steps), run.ctx.dist, dev)
    with torch.no_grad():
        live, back = (float(fn.loss(t, batch)[1]) for t in (run.tree, restored))
    step_ms = sorted(1e3 * s for s in run.step_s[1:])
    row = {"phase": 16, "arch": cfg.name, "what": "launch/train.py at full width, "
           f"{cfg.n_layers} layers", "steps": len(losses), "loss_first": losses[0],
           "loss_min_last5": min(losses[-5:]), "losses": losses, "grad_norms": gnorms,
           "kernel_launches": launches, "ckpt_step": step, "ckpt_bit_equal": same,
           "next_loss": live, "next_loss_restored": back, "peak_mem_gib": peak,
           "ms_per_step_median": step_ms[len(step_ms) // 2], "ms_per_step_min": step_ms[0],
           "phase_s": time.monotonic() - t0}
    if not all(np.isfinite(losses + gnorms)) or not min(losses[-5:]) < losses[0]:
        fail(f"phase 16 (b): losses {losses}, grad norms {gnorms}")
    if launches:
        fail(f"phase 16 (b): the training path launched kernels {launches}")
    if not (same and step == args.steps and live == back):
        fail(f"phase 16 (b): the checkpoint did not round-trip: {row}")
    return row


def train_phases(dev):
    """Phase 16's (a) and (b), run beside phase 15's ranks (after phases 10
    and 11, while phase 15's world still serves) -> (their rows, (a)'s
    dp = 1 CPU tree of yi-9b, which (c) is held to)."""
    t0 = time.monotonic()
    ref = train_reference_check(dev)
    rows = [r for r, _ in ref] + [train_full_phase(dev)]
    for row in rows:
        row["note"] = BESIDE_CP
    print(f"phase 16 (training; (a) and (b) beside phase 15's ranks): "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    return rows, ref[0][1]


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    from repro_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.monotonic()
    reports = build.build_all()
    print(f"build: {len(reports)} libraries in {time.monotonic() - t0:.1f}s")
    for src, text in reports.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:   # the mangled name names the instance
                entry = line.split("'")[1][:64] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"  {src} {entry}: {line.strip()}")

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    kernels = check_kernels(dev, flush)
    del flush
    for mode, kvq in (("none", False), ("int8", False), ("int4", False), ("none", True),
                      ("int4", True)):
        print(json.dumps({"reference": reference_check(dev, mode, kvq)}), flush=True)
    for kvq in (False, True):
        print(json.dumps({"reference": slot_reference_check(dev, kvq)}), flush=True)
    print(json.dumps({"reference": hybrid_reference_check(dev)}), flush=True)
    print(json.dumps({"reference": hybrid_reference_check(dev, "int8", kv_quant=True)}),
          flush=True)
    print(json.dumps({"reference": parallel_reference_check(dev)}), flush=True)
    for row in latent_moe_reference_check(dev):
        print(json.dumps({"reference": row}), flush=True)
    for row in ring_ssd_reference_check(dev):
        print(json.dumps({"reference": row}), flush=True)
    for row in frontend_reference_check(dev):
        print(json.dumps({"reference": row}), flush=True)
    phases, params, weights = [], None, None
    for arch, mode, kvq in SERVE_PHASES:
        depth = phase_config(arch, wave_name(mode, kvq)).n_layers
        if (arch, mode, depth) != weights:
            params = None
            torch.cuda.empty_cache()
        phase, params = serve_phase(dev, arch, mode, kvq, params)
        weights = (arch, mode, depth)
        print(json.dumps({"serve": phase}), flush=True)
        phases.append(phase)
    del params
    torch.cuda.empty_cache()
    cp, beside = None, False
    for run in (lambda: slot_phases(dev), lambda: slot_phases(dev, kv_quant=True),
                lambda: hybrid_phases(dev), lambda: slot_phases(dev, GJ_ARCH, "plain"),
                "phase 15 start", lambda: latent_moe_phases(dev), lambda: ring_ssd_phases(dev),
                "phase 16", "phase 15 checks", lambda: frontend_phases(dev)):
        if run == "phase 15 start":
            # phase 15's ranks (separate processes) run beside phases 10 and 11
            cp = control_ranks_start(dev)
            beside = True
            continue
        if run == "phase 16":
            # training's card work in the time phase 15's ranks still take
            train_rows, train_dp1 = train_phases(dev)
            for row in train_rows:
                print(json.dumps({"train": row}), flush=True)
            continue
        if run == "phase 15 checks":
            phase = control_ranks_phase(dev, cp)
            print(json.dumps({"serve": phase}), flush=True)
            phases.append(phase)
            print(f"phase 15 (control plane dp={CP_DP} x tp={CP_TP}, its ranks beside phases 10 "
                  f"and 11): {phase['phase_s']:.1f}s from its start, "
                  f"{phase['waited_for_ranks_s']:.1f}s of it waiting for the ranks after them",
                  flush=True)
            beside = False
            print(json.dumps({"train": train_ranks_phase(cp["got"], train_dp1)}), flush=True)
            continue
        for phase in run():
            if beside:
                phase["note"] = "; ".join(x for x in (phase.get("note"), BESIDE_CP) if x)
            print(json.dumps({"serve": phase}), flush=True)
            phases.append(phase)
    print(json.dumps({"reference": tp_reference_check(dev)}), flush=True)
    tp_runs = [tp_phases]
    if torch.cuda.device_count() >= TP:
        tp_runs.append(lambda d: tp_phases(d, "nccl"))
    else:
        print(f"tp nccl phase: not run: {torch.cuda.device_count()} card(s); NCCL puts one "
              f"rank on each card, so tp={TP} over NCCL needs {TP} cards", flush=True)
    for run in tp_runs:
        for phase in run(dev):
            print(json.dumps({"serve": phase}), flush=True)
            phases.append(phase)
    dp_runs = [dp_phases]
    if torch.cuda.device_count() >= DP:
        dp_runs.append(lambda d: dp_phases(d, "nccl"))
    else:
        print(f"dp nccl phase: not run: {torch.cuda.device_count()} card(s); NCCL puts one "
              f"rank on each card, so dp={DP} over NCCL needs {DP} cards", flush=True)
    t_dp = time.monotonic()
    for run in dp_runs:
        for phase in run(dev):
            print(json.dumps({"serve": phase}), flush=True)
            phases.append(phase)
    print(f"dp phases: {time.monotonic() - t_dp:.1f}s", flush=True)
    for k in kernels:
        # a row counts the phases of the arches whose shapes it was timed at
        arches, counter, tp_only = k.pop("arches"), k.pop("counter"), k.pop("tp_only", False)
        only = k.pop("phase_only", None)
        k["launches"] = sum(p["launches"][counter] for p in phases
                            if p["arch"] in arches and (p.get("ranks") or not tp_only)
                            and (only is None or p.get("scheduler") in only))
        k["launches_counted_on"] = (only if only is not None else
                                    [f"{a} tp={TP}" if tp_only else a for a in arches])
        if k["launches"] == 0:
            fail(f"{k['name']} was not launched on the serving paths")
        if k["name"] == "topk":
            k[f"v{RG_VOCAB}"]["launches"] = sum(p["launches"]["topk"] for p in phases
                                                if p["arch"] == RG_ARCH)
        if k["name"] in ("decode_attention_partial (head_dim 256)",
                         f"decode_attention_partial (int8), {RG_ARCH}"):
            k["in_step"] = next(p["decode_attention_in_step"] for p in phases
                                if "decode_attention_in_step" in p
                                and p["kv_quant"] == ("int8" in k["name"]))
    print(f"chip_smoke: {time.monotonic() - t0:.1f}s after the device check")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
