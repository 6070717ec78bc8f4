#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero and prints no result):

  0. build — compiles every CUDA source of ``repro_torch/kernels/csrc`` into
     ``build/kernels/`` (one ``nvcc`` per source, all started together).
  1. kernels vs plain — each hand-written kernel (cmatmul, ctwiddle,
     pmatmul, freq_outer, freq_mat, xcorr_offdiag, paged_attention) runs at
     the shapes the
     serving and training paths give it (d = 2048 and 8192, b = 128,
     n = 256; the prime d = 2039 for the padded plan's q = 1 inverse path
     and the ragged R_off tiles; the LM probe's d = 2304; the LM train
     step's aux loss, ``lmtrain`` labels: n = 64 rows of d = 2304 through
     every aux arm's kernels, n = 32 of d = 5120 through the ungrouped
     arm's), forward and,
     labelled ``bwd``, as the vjps call it, and at edge shapes that take the
     kernels' other paths (freq_outer: N of 1, 9 and 130, N != NB, K of 1,
     500, 1000 and 4096, an operand 4 bytes off, on both of its kernels;
     R_off: one tile, ragged last tiles, batches of 1, 17 and 300, an operand
     4 bytes off; paged attention: lengths around a split's CHUNK rows, a
     length of 1 in a wide table, a window that starts mid-chunk or exceeds
     every length, n_rep 1 to 8, hd 48 to 256, pages of 5 and 16), and is held
     against its plain PyTorch version on the same inputs.  Prints max error, kernel / plain / library time and
     the bound; a cmatmul line names its library yardstick: complex ``@``,
     or, for the real-input stage and the vjp's Re-only output, the one real
     ``matmul`` that computes the same function; a paged_attention line with
     a soft cap (the JSON, long and verify cases) compiled
     ``flex_attention``.
     Then the gradient of the regularizer at the paper's width (n = 256,
     d = 8192; b = 128 and ungrouped, q = 2) on the kernel route against the
     ``impl="plain"`` route (``[grad]`` lines).  paged_attention also runs
     "hot" cases with q x 40 at softcap 30 / 50, where the cap moves the
     output by over 100 x the tolerance (a printed, checked control).
     Last, the paper's identity (``[oracle]`` lines): the kernel route's
     R_sum (q = 2 and 1; cmatmul, ctwiddle) and R_sum^(128) (pmatmul,
     freq_outer) at n = 256, d = 8192 and the prime d = 2039 against their
     definitions from the explicit C (``r_sum_from_matrix``,
     ``r_sum_grouped_from_matrix``) within the reference tests' rtol 1e-3
     (grouped: + atol 1e-4), and ``sumvec_fourstep`` against the O(n d^2)
     ``sumvec_direct`` at d = 2048.
  2. the service — ``EmbeddingService`` at the full ``ssl-paper`` width
     (3072 -> 512 -> 512 -> 2048 -> 2048 -> 2048, random weights from a
     seed, buckets up to 256) serves 512 seeded requests twice: probe
     ungrouped (Eq. 6, four-step kernels), then b = 128 (Eq. 13, grouped
     kernels), style 'vic', q = 2.  Embeddings are checked against the CPU
     forward, the last probe window against the plain route on the card,
     ``dispatch_errors`` must be 0 and every kernel of the run's path must
     have launched (counters cleared just before each run).
  3. profile — the same two service runs, warmed, under ``torch.profiler``:
     wall time vs summed device time (the device's idle share) and the
     device work by kernel name.  A ported kernel's device ms sums every
     ``__global__`` function of its source (``DEVICE_KERNELS``: R_off's tile
     pass and partials sum, paged attention's decode pass and split
     combine, freq_outer's narrow and wide kernels); a kernel whose launch
     counter moved in a profiled window but
     that shows no device time fails the phase (here, in 4 and in 5).
  4. train — ``make_ssl_train_step`` with LARS at the full ``ssl-paper``
     width (batch 256, ``ssl_batch`` data, random weights from a seed), 20
     steps of three arms on the kernel route and on the ``impl="plain"``
     route from the same parameters, batches and permutations:
     (a) BT, R_sum, b = 128, q = 2 (pmatmul, freq_outer, freq_mat);
     (b) VICReg, R_sum ungrouped, q = 1 (cmatmul, ctwiddle, forward and
     inverse four-step); (c) BT, R_off through the fused kernel
     (xcorr_offdiag).  Step-0 gradients per parameter and every step's loss
     must agree within 5e-4 relative, and every kernel of an arm must have
     launched on the forward and (but xcorr_offdiag, whose backward is torch
     products) the backward pass.  Prints median step ms per arm and route,
     then a profiler pass over 10 warmed steps of each arm (its kernels'
     device ms must be > 0; torch.cat's device copies are read out too).
     Arm (a)'s trained state is saved through ``checkpoint/`` and served by
     ``ServeEngine.from_checkpoint``: its embeddings of a 256-row batch must
     equal the trained model's forward bit for bit.
  4b. dist — distributed decorrelation on one NCCL rank (a group of one,
     ``FileStore`` rendezvous; collectives across ranks are the CPU tests'
     job): (1) the BT loss, R_sum b = 128 q = 2 at n = 256, d = 8192 (a
     65 x 64 x 64 complex accumulator all-reduced), under ``global`` (axis
     "data") and ``tp`` (a 1 x 1 mesh, the all-to-all) on the kernel route
     against ``local``'s kernel route, and ``global``'s kernel route against
     its ``impl="plain"`` route: loss and input gradients within 5e-4,
     pmatmul and freq_outer launched on the forward, pmatmul and freq_mat on
     the backward; (2) ``make_sharded_ssl_train_step`` at the ssl-paper
     width, arm (a) of phase 4 (LARS, peak lr 0.05, 20 steps), in ``global``
     and ``tp`` against ``make_ssl_train_step`` from the same parameters,
     batches and permutations: step-0 gradients per parameter and every
     step's loss within 5e-4, the kernels launched, the median step ms of
     both (the collectives' cost at world size 1; printed, not gated);
     (3) ``make_compressed_dp_step`` on the same model and batches, 5 steps:
     ``none``'s losses equal ``make_ssl_train_step``'s within 5e-4, the
     reduced step-0 gradients of bf16 / int8_ef within 0.01 / 0.05 relative
     of ``none``'s (the reference test's bounds) — NCCL takes the f32, bf16,
     int32 and MAX all-reduces; (4) ``ServeEngine`` at the ssl-paper width
     on the 1 x 1 mesh, data-parallel and tp (``model_axis="model"``), 512
     rows: bit for bit the unmeshed engine's; (5) ``probe_metrics`` in
     ``global`` / ``tp`` (VICReg, b = 128) on those rows: the kernel route
     against ``impl="plain"`` and against ``local`` within 5e-4, pmatmul and
     freq_outer launched; (6) ``make_train_step`` on ``gemma2-2b`` at full
     width (2 layers), batch 8 x 128 in 2 microbatches, aux R_sum b = 128, 3
     AdamW steps, unmeshed, on the mesh, and on it with ``grad_shardings``:
     losses and parameters within 5e-4 of the unmeshed run's, pmatmul /
     freq_outer forward and pmatmul / freq_mat backward launched; (7) the
     ``global`` arm (a) run fed by ``ShardedPrefetcher`` from host batches:
     its 20 losses equal the direct run's; (8) the ``tp`` run's state,
     checkpointed and restored by ``elastic_restore`` as a ``global`` state:
     equal parameters and an equal next-step loss.  The meshed paths'
     launches count toward the ``kernels`` line.
  4c. obs — telemetry: (a) ``EmbeddingService`` with an enabled ``Obs`` at
     the ssl-paper width, probe b = 128, 512 requests: an ``encode`` span
     and a ``serve_encode_seconds`` observation a dispatch, request spans a
     request, a first-call gauge for every bucket, ExecTimer calls equal to
     the dispatches, a scrape of ``127.0.0.1:0/metrics`` listing every
     ``metrics()`` series; req/s with telemetry on and off (on, off, on,
     off); (b) ``run_training`` of arm (a), 20 steps, with a registry, a
     health monitor and an ExecTimer: ``train_steps_total`` 20, the
     monitor's gauges against ``probe_metrics``'s plain route within 5e-4;
     step ms with and without the hooks; (d) a ``Profiler`` start / stop
     whose Chrome trace names the port's kernels.  (c), ``LMService`` on
     the bf16 ``gemma2-2b`` with telemetry on (8 requests: a
     ``decode_step`` span, a histogram observation and an ExecTimer call a
     tick, 26 ``paged_attention`` launches a tick) and its decode tick ms
     on / off, runs at the end of phase 5 on that phase's bf16 model.
  5. lm — paged continuous-batching LM serving of ``gemma2-2b`` at its full
     published width and depth (26 layers, d = 2304, 8 query / 4 kv heads of
     256, vocab 256000; random weights from ``init_params(seed=0)``) through
     ``ContinuousLMEngine(paged=True)`` under ``LMService`` with the
     in-flight decorrelation probe: (1) f32, 8 slots, page 16, the
     reference's ``LMLoadConfig()`` (24 requests): (a) paged tokens on the
     plain (gather) route equal the dense engine's bit for bit; (b) on the
     kernel route every decode tick is re-run on the plain route from a
     clone of the pool, logits within 1e-4 x max(1, max |logit|); (c) kernel
     route tokens equal the plain route's, a request's first difference
     allowed only at a step whose plain top-2 logit gap is below twice the
     measured logit difference; ``paged_attention`` launches 26 per decode
     tick, and the probe's cmatmul and ctwiddle launch (counts of this run
     alone); probe vs its oracle < 1e-3; no dispatch error.  (2) the same
     checks on 2 requests of 4160 prompt tokens + 16 new (f32, max_len
     4224), decoding past the 4096 window of the local layers.  Then, f32,
     kernel route: (d) chunked serving prefill (``prefill_chunk=512``, 8
     slots, prompts of 600-2000 tokens) against the unchunked paged engine:
     a request may first differ only at a token whose unchunked top-2 logit
     gap is below twice the measured logit difference (the gap rule); the
     chunk steps and the decode ticks interleaved with them are counted;
     (e) sampling: at temperature 0 the sampling engine's tokens equal the
     greedy engine's bit for bit, seeded tokens at T = 0.8 / top-k 50
     reproduce on a rerun, and every decode tick re-runs on the plain route
     from a cloned pool, the plain route's token drawn with the same Gumbel
     noise: tokens may differ only where the top-2 perturbed gap is below
     2 x the logit difference / T; (f) the prefix radix cache on
     ``SharedPrefixLoadConfig()``: warm tokens == unshared bit for bit,
     fewer peak pages, hits, a copy-on-write, probe vs oracle < 1e-3;
     (g) speculative decoding (draft_k 4) against the unspeculative engine
     under the gap rule, every verify (B = 40) and tick re-run on the plain
     route from a cloned pool (logits 1e-4), 26 paged_attention launches
     each, accepted tokens per verify step printed; (h) one 10240-token
     prompt through ``LMService``: its prefill takes ``_chunked_attention``
     (26 calls), first-token logits within 1e-4 of the same forward on full
     attention, then 8 decode tokens.  (3) the config's own bf16, workload
     (1), timed: tok/s, TTFT, decode tick and prefill ms, a profiled window
     of 10 ticks (idle share, largest device items), kernel-vs-plain logit
     difference (reported, not gated); then one bf16 run each of chunked
     prefill, the prefix cache (cold and warm TTFT against unshared),
     speculative decoding and sampling (its logits-to-host ms a tick), for
     the record, each line with the card's name and power limit.
     Phase 1 also holds paged_attention at the verify's shape (B = 40, each
     slot's 5 lanes on one table row), and at the full head geometry of
     every other attention arch (``arch ...`` labels: 8 slots, page 16,
     lengths up to 2048, f32 and bf16; n_rep 1 to 12, hd 64 to 192).
  5b. fabric — the serving fabric over gemma2-2b at full width, 8 of 26
     layers, f32 (``init_params(seed=0)``, the weights shared read-only by every
     replica), the reference gate's load (12 requests, prompts 4 / 8 / 14,
     8 / 16 new tokens), 4 slots a replica, page 16: (a) a 2-replica
     fabric on a fake clock, r0 killed after 3 ticks, against a 1-replica
     fabric on the kernel route: tokens bit for bit, requeued > 0, one
     death, paged_attention launched; (b) the 1-replica kernel route
     against its plain route under the gap rule; (c) ``compare_fabric``:
     threaded 1 vs 2 replicas (3 repeats), 0 route mismatches, tok/s and
     ``scaling_x`` printed, not gated (one card, one default stream);
     (d) an ssl-paper ``EmbeddingService`` beside each replica's LM
     service, 8 requests of 4 x 3072 rows, one a dispatch: each embedding
     bit for bit one ``ServeEngine``'s; (e) ``python -m
     repro_torch.launch.serve --arch gemma2-2b --batch 4`` exits 0;
     (f) ``obs.catalog.generate`` on the card equals it on the CPU.
  5c. tune — the tuner in a temporary cache directory under ``build/``:
     (a) ``tune.cli --measure --arch ssl-paper --shape 256x8192`` (each
     plan's analytic and measured picks, every candidate's fwd + bwd ms on
     the kernel route, each tile kernel's one launch); (b) the
     regularizer's loss and input gradient under each measured four-step
     plan within 5e-4 relative of the default plan's; (c) after
     ``clear_memory_cache`` ``best_config`` returns the disk entry and a
     second tune times nothing; (d) the page candidates at the LM pool's
     shape, f32 and bf16, beside ``auto_page_size``; (e)
     ``warmup_tune_cache(64, 2304, ...)`` measured and ``launch/train
     --pretune analytic`` at ``--reduced``.  The memo is cleared after, so
     later phases run the default plans.
  6. archs — the nine other LM archs of ``repro_torch.configs`` (random
     weights, seed 0; ``ARCH_RUNS``), every one at full width:
     codeqwen1.5-7b, qwen2-vl-2b, rwkv6-3b and musicgen-large at full
     depth; llama4-scout and qwen1.5-110b at 2 layers, nemotron-4-340b and
     arctic-480b at 1, jamba at one 8-layer period.
     f32 gates: the attention archs run checks (a)-(c) of phase 5 on 12
     requests at 8 slots (paged plain route == dense engine bit for bit,
     unless a decode tick overfilled a MoE expert's seats, see
     ``_DecodeDrops``; kernel vs plain logits every tick within 1e-4;
     tokens under the gap rule; ``paged_attention`` launches = the
     attention layers a tick); rwkv6-3b's continuous dense engine's tokens
     equal to ``greedy_generate``'s; musicgen's cached generate
     against the argmax of one uncached forward, per codebook under the gap
     rule; every run's probe (the LM probe at d = 1536, 2048, 2560, 4096,
     5120 and 64) against its oracle < 1e-3.  Then one bf16 timed line each
     (tok/s, TTFT p50 / p99, decode tick and prefill ms, the card's name and
     power limit).
  7. lmtrain — LM training with the paper's decorrelation aux loss
     (``make_train_step``, the launcher's defaults: AdamW, warmup-cosine
     peak 1e-3, clip 1.0, ``lm_batch`` data) at f32: ``gemma2-2b`` at full
     width, LMTRAIN_DEPTH = 8 of its 26 layers (d = 2304, seed 0),
     batch 8 x seq 128, in four arms — aux off; R_off through the fused
     kernel (xcorr_offdiag); R_sum q = 2 ungrouped (cmatmul, ctwiddle);
     R_sum q = 2, b = 128 (pmatmul, freq_outer, freq_mat) — then
     ``llama4-scout`` at full width, one layer (16 experts, 4.27 B
     parameters), batch 4 x seq 64, R_sum q = 2.  Each aux arm runs 5 steps
     on the kernel route and on the ``impl="plain"`` route from the same
     weights and batches: every step's loss and ``decorr_reg`` within 5e-4
     relative; step 0's aux term alone, its gradient wrt the final hidden
     states within 5e-4 (its forward and backward launches read apart:
     each arm's kernels on both passes, freq_outer's backward being
     freq_mat); finite metrics, a router-balance loss on the MoE arm.  Then
     (gemma2) 5 profiled kernel-route steps: median step ms (CUDA events),
     device busy and idle share, each ported kernel's device ms, and the aux
     loss's share of the step's device time (its forward + backward alone
     at the step's shapes).  Peak bytes per arm.
  7b. fsdp — the 2-D (FSDP over ``data``, TP and the MoE experts over
     ``model``) LM train step (``parallel/fsdp_tp.place_train_state``, then
     ``make_train_step`` on the placed state) on one NCCL rank, a (data 1,
     model 1) mesh: gemma2-2b at full width, 8 of 26 layers, f32, batch 8 x 128,
     phase 7's schedule, in three aux arms (R_sum b = 128, R_sum q = 2
     ungrouped, R_off fused); then, one a kind of layer, R_sum q = 2, full
     width, the config's moments: llama4-scout 1 of 48 layers (4 x 64),
     jamba's first two pattern positions (Mamba + dense, Mamba + MoE;
     4 x 64), rwkv6-3b 4 of 32 layers (8 x 128, the chunk-parallel path),
     one state at a time.  3 steps placed against 3 unplaced steps from the
     same seeded weights and batches: every loss term within 5e-4 relative,
     every gathered parameter within 5e-4 of its leaf's largest entry, each
     arm's kernels launched forward and backward in the placed steps; median
     step ms and peak allocated bytes (steps 2-3) of both.  Phase ``launch``
     (e) prints each dry-run cell's layout (three processes started before
     phase lmtrain, so they run beside it): every cell, train (gemma2-2b,
     llama4-scout, rwkv6-3b ``train_4k`` on (16, 16)) and serving
     (gemma2-2b ``prefill_32k`` / ``decode_32k``, llama4-scout
     ``decode_32k``, rwkv6-3b ``long_500k``), runs the 2-D step, whose
     argument bytes must equal the specs'.
  7c. serve2d — the 2-D serving steps (``train/serve`` on
     ``parallel/fsdp_tp.place_params`` / ``place_caches``: KV caches split by
     sequence over ``model``, Mamba state by channel, RWKV6 state whole):
     (a) paged_attention with a block ``start`` and
     its log-sum-exp on each of 16 blocks of 2048 rows of a 32768-row bf16
     cache (gemma2-2b's heads, softcap 50, 8 slots, lengths spread over the
     cache), a local (window 4096) and a global layer, the blocks merged by
     ``merge_partials`` against the plain version over the whole cache
     (2e-4 of max(1, max |plain|)), each block's LSE against the plain
     block's; event / device ms of one block call (decode_32k's rank block)
     and of the merge, with the call's bound, and of its library call,
     compiled ``flex_attention`` (soft cap as ``score_mod``, lengths, start
     and window as its block mask), held against the plain version at
     LIB_TOL on that block and on a local layer's middle block; a block
     call with no device time fails; (b) on one NCCL rank, a (data
     1, model 1) mesh, at full width, f32: gemma2-2b at full depth,
     llama4-scout 1 of 48 layers, jamba its first 5 pattern positions
     (Mamba + dense, Mamba + MoE twice, attention) and rwkv6-3b 4 of 32
     layers, one model at a time: 8 prompts of 512 tokens prefilled into
     4096-row caches, then 32 greedy decode steps, placed against unplaced:
     logits within 1e-4 of max(1, max |logit|) every step, tokens identical
     under the gap rule, and one ``paged_attention`` launch per attention
     layer per placed decode step (none for rwkv6).
  8. report — one JSON ``kernels`` line, the card's name and power limit,
     and the last line ``{"ok": true, "device": {...}}``.

Times are CUDA-event means over repeated launches with inputs resident in
L2 where they fit (the service finds them warm: each stage reads what the
previous one just wrote); they include the host's launch cost when the
host, not the device, is the slower side.  "device-only" times sum the
durations of the device work per call from a profiler (CUPTI) trace.  ``bound_ms`` is the larger of bytes / 3.35 TB/s
and f32 operations / 67 TFLOP/s (H100 SXM data sheet, non-tensor-core f32),
counting each input read once and each output written once (paged
attention: the live rows only — min(len, window) per slot).
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# kernel vs its plain version: the reference's kernel tolerance (2e-4),
# taken relative to the output's largest magnitude — both sum in f32, in a
# different order, over contractions of up to 512 terms
KERNEL_TOL = 2e-4
# paged_attention's library yardstick (compiled ``flex_attention``) vs the
# plain version on the same q rounded to the pages' dtype: flex takes one
# dtype and, on bf16 pages, rounds the probabilities to bf16 before P @ V
# (2^-8 relative a term)
LIB_TOL = 1e-2
# served embeddings vs the CPU forward: cuBLAS f32 (TF32 off) and the CPU
# BLAS sum 3072-term products in different orders
EMBED_TOL = 1e-4
# probe on the kernel route vs the plain torch.fft route: the reference's
# loss tolerance (5e-4 relative)
PROBE_TOL = 5e-4
# train phase and [grad] lines: losses and gradients, kernel route vs plain
# route, the reference's loss tolerance (5e-4 relative; a gradient relative
# to its own largest magnitude)
LOSS_TOL = 5e-4
N_REQUESTS = 512
SEED = 0
TRAIN_STEPS = 20
PROFILE_STEPS = 10
# peak learning rate of the checked runs (LARS, warmup 2 steps, cosine).  At
# the training CLI's 0.2 the trajectory at this width is chaotic on the card: the
# plain route against itself with every parameter scaled by (1 + 1e-7 noise)
# drifts apart by ~1e-3 in 20 steps, so no two routes that differ at f32
# rounding can agree to 5e-4 there.  The [train] sensitivity line measures
# this each run; the checked runs use a peak lr at which the trajectory
# holds the routes' rounding differences.
TRAIN_LR = 0.05
SENSITIVITY_LR = 0.2
# dist phase: the regularizer at the paper's d = 8192 (b = 128: a 65 x 64 x
# 64 complex accumulator, 2.1 MB an all-reduce); compressed steps run
DIST_N, DIST_D, DIST_BLOCK = 256, 8192, 128
DIST_DP_STEPS = 5
# dist (4)-(6): the meshed ServeEngine on 512 rows at the ssl-paper width;
# the data-parallel LM step on gemma2-2b at full width, depth cut to 2
# layers, batch 8 x 128 in 2 microbatches, aux R_sum b = 128, 3 AdamW steps
DIST_SERVE_ROWS = 512
DIST_LM, DIST_LM_DEPTH, DIST_LM_STEPS, DIST_LM_MICRO = "gemma2-2b", 2, 3, 2
# obs: (c) the LM service with telemetry on and off, gemma2-2b bf16
OBS_LM_REQUESTS = 8
# lm phase: kernel-route logits vs the plain route's on the same pool state,
# relative to max(1, max |logit|) — the reference's 1e-4 logit tolerance
LOGIT_TOL = 1e-4
# lm phase: probe on the served hidden rows vs its offline oracle (the
# reference CLI's gate)
LM_PROBE_TOL = 1e-3
LM_SLOTS = 8
LM_PAGE = 16
# the kernels of the LM path's probe: ungrouped R_sum of the hidden rows at
# d = 2304 through the four-step DFT
LM_PROBE_KERNELS = ("cmatmul", "ctwiddle")
LONG_PROMPT, LONG_NEW, LONG_MAX_LEN = 4160, 16, 4224
LM_PROFILE_TICKS = 10
# (d) chunked serving prefill: prompts of 600-2000 tokens, 512 a tick; the
# unchunked engine runs at the same max_len (the chunk template's 2048 rows
# for a 2000-token prompt, plus decode room, a page multiple)
CHUNK_PREFILL = 512
CHUNK_MIX = dict(n_requests=8, prompt_lens=(600, 1100, 1500, 2000), new_tokens=(8, 16), seed=SEED + 5)
CHUNK_MAX_LEN = 2064
# (e) sampling: the first 8 requests of the reference mix; the sampled runs'
# temperature and top-k
SAMPLE_REQUESTS = 8
SAMPLE_T, SAMPLE_TOP_K = 0.8, 50
# (g) speculative decoding: tokens drafted a verify (lanes = slots x (k + 1))
DRAFT_K = 4
# (h) one prompt past attn_chunk_threshold (8192), a multiple of the 2048-row
# chunk, through the long-prompt (flash-style) prefill; then decode 8 tokens
LONG_PREFILL, LONG_PREFILL_NEW = 10240, 8
# phase fabric: the reference gate's load (serve/cli.py _gate_fabric) on
# gemma2-2b at full width, FABRIC_DEPTH of its 26 layers (the script's time
# limit), f32, 4 slots a replica, page LM_PAGE
FABRIC_DEPTH = 8
FABRIC_LOAD = dict(n_requests=12, prompt_lens=(4, 8, 14), new_tokens=(8, 16), seed=SEED)
FABRIC_SLOTS = 4
FABRIC_REPEATS = 3
# (d): ssl-paper embedding requests riding along (rows each, input_dim 3072)
FABRIC_EMBED, FABRIC_EMBED_ROWS = 8, 4
# (e): the serve launcher at its defaults, full width, on the card
LAUNCH_SERVE_ARGS = ("--arch", "gemma2-2b", "--batch", "4")
# phase tune: the measured plans' loss and input gradient vs the default plan's
TUNE_TOL = 5e-4
TUNE_SHAPES = ("256x8192",)

# [lmtrain]: LM training with the paper's aux loss, the reference launcher's
# defaults (AdamW, warmup_cosine(1e-3, ...), clip 1.0, lm_batch data) at f32.
# gemma2-2b at full width, LMTRAIN_DEPTH of its 26 layers (its local / global
# alternation four times; the script's time limit cut the depth of phases
# lmtrain and fsdp), batch 8 x seq 128 (the aux statistic:
# 8 x 8 = 64 subsampled rows of d = 2304), in four arms; then llama4-scout at
# full width, one layer, batch 4 x seq 64 (32 rows of d = 5120), R_sum.
# Each arm runs LMTRAIN_STEPS steps on the kernel route and on the plain
# route from the same parameters and batches, then (gemma2) a profiled
# window of LMTRAIN_STEPS more on the kernel route.
LMTRAIN_STEPS = 5
LMTRAIN_DEPTH = 8
LMTRAIN_LR = 1e-3
LMTRAIN_BATCH, LMTRAIN_SEQ = 8, 128
LMTRAIN_N = LMTRAIN_BATCH * 8
# arm: (aux DecorrConfig keywords or None, kernels launched on the forward
# pass, kernels launched on the backward pass: R_off's vjp is torch
# products, freq_outer's is freq_mat)
LMTRAIN_ARMS = {
    "aux off": (None, (), ()),
    "r_off fused": (dict(style="vic", reg="off", use_kernel=True), ("xcorr_offdiag",), ()),
    "r_sum q=2": (dict(style="vic", reg="sum", q=2), ("cmatmul", "ctwiddle"), ("cmatmul", "ctwiddle")),
    "r_sum q=2 b=128": (dict(style="vic", reg="sum", q=2, block_size=128), ("pmatmul", "freq_outer"),
                        ("pmatmul", "freq_mat")),
}
LMTRAIN_MOE, LMTRAIN_MOE_DEPTH = "llama4-scout-17b-a16e", 1
LMTRAIN_MOE_BATCH, LMTRAIN_MOE_SEQ = 4, 64
LMTRAIN_MOE_N = LMTRAIN_MOE_BATCH * 8

REPLACES = {
    "cmatmul": "src/repro/kernels/sumvec_fft/kernel.py:54",
    "ctwiddle": "src/repro/kernels/sumvec_fft/kernel.py:131",
    "pmatmul": "src/repro/kernels/grouped_sumvec/kernel.py:49",
    "freq_outer": "src/repro/kernels/grouped_sumvec/kernel.py:115",
    "freq_mat": "src/repro/kernels/grouped_sumvec/kernel.py:153",
    "xcorr_offdiag": "src/repro/kernels/xcorr_offdiag/kernel.py:53",
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:102",
}
SOURCES = {
    "cmatmul": "src/repro_torch/kernels/csrc/sumvec_fft.cu",
    "ctwiddle": "src/repro_torch/kernels/csrc/sumvec_fft.cu",
    "pmatmul": "src/repro_torch/kernels/csrc/grouped_sumvec.cu",
    "freq_outer": "src/repro_torch/kernels/csrc/grouped_sumvec.cu",
    "freq_mat": "src/repro_torch/kernels/csrc/grouped_sumvec.cu",
    "xcorr_offdiag": "src/repro_torch/kernels/csrc/xcorr_offdiag.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
}
# every __global__ function of each kernel's source, by the kernel whose
# wrapper launches it: the profiler's device time of a kernel is the sum over
# these names (freq_outer's register-fed kernel for narrow tiles and staged
# kernel for wide ones, xcorr_offdiag's tile pass and its partials sum, paged
# attention's decode pass and its split combine)
DEVICE_KERNELS = {
    "cmatmul": ("cmatmul_kernel",),
    "ctwiddle": ("ctwiddle_kernel",),
    "pmatmul": ("pmatmul_kernel",),
    "freq_outer": ("freq_outer_kernel", "freq_outer_staged_kernel"),
    "freq_mat": ("freq_mat_kernel",),
    "xcorr_offdiag": ("xcorr_tile_kernel", "sum_partials_kernel"),
    "paged_attention": ("paged_decode_kernel", "paged_combine_kernel"),
}
# the training arms: (DecorrConfig keywords, the kernels the arm runs)
ARMS = {
    "a bt r_sum b=128 q=2": (dict(style="bt", reg="sum", block_size=128, q=2), ("pmatmul", "freq_outer", "freq_mat")),
    "b vic r_sum ungrouped q=1": (dict(style="vic", reg="sum", block_size=None, q=1), ("cmatmul", "ctwiddle")),
    "c bt r_off fused": (dict(style="bt", reg="off", use_kernel=True), ("xcorr_offdiag",)),
}
# kernels whose backward pass is a kernel too (xcorr_offdiag's is torch products)
WITH_KERNEL_BWD = ("cmatmul", "ctwiddle", "pmatmul", "freq_outer", "freq_mat")


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_events(fn):
    """Device-side events (kernels, copies) of one call of ``fn`` under the
    profiler (CUPTI), as (name, microseconds) pairs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.device_time_total) for e in prof.events() if e.device_type == DeviceType.CUDA]


def _device_ms(fn, iters: int = 20, sessions: int = 3):
    """Mean device time per call of ``fn``: the summed durations of the
    device work it enqueues (None if the profiler saw no device events).
    A profiler session now and then returns no device event at all, for
    any work (on the H100 about one of ~150 sessions a run, in any phase),
    so an empty session is taken again, up to ``sessions`` times."""
    fn()
    for _ in range(sessions):
        events = _device_events(lambda: [fn() for _ in range(iters)])
        if events:
            return sum(us for _, us in events) / iters / 1e3
    return None


_OWNER = {sym: kernel for kernel, symbols in DEVICE_KERNELS.items() for sym in symbols}
_SYMBOL = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(_OWNER) + r")(?![A-Za-z0-9_])")


def kernel_of(device_name: str):
    """The ported kernel a profiler device event belongs to (by the
    ``DEVICE_KERNELS`` names, matched as whole identifiers), or None."""
    found = _SYMBOL.search(device_name)
    return _OWNER[found.group(1)] if found else None


def _ported_ms(ph, events, counts, names, where):
    """{kernel: (device ms, device launches)} of ``names`` in a profiled
    window's events; a kernel whose launch counter moved in the window but
    that shows no device time fails the phase."""
    ours = {k: [0.0, 0] for k in names}
    for name, us in events:
        k = kernel_of(name)
        if k in ours:
            ours[k][0] += us / 1e3
            ours[k][1] += 1
    for k in names:
        ph.check(counts.get(k, 0) == 0 or ours[k][0] > 0,
                 f"[profile] {where}: {k} launched {counts.get(k, 0)} times but shows no device time")
    return ours


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.5f}"


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_err(got, want) -> tuple:
    """(max abs error, that error relative to max(1, max |want|))."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = max(float((g - w).abs().max()) for g, w in pairs)
    scale = max(1.0, max(float(w.abs().max()) for _, w in pairs))
    return err, err / scale


class Phase:
    """Collects failures; a phase that raises is recorded, not fatal to the others."""

    def __init__(self):
        self.failures = []

    def check(self, ok: bool, what: str):
        if not ok:
            self.failures.append(what)
            print(f"[chip_smoke] FAIL {what}", flush=True)

    def run(self, name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # a phase boundary: record, report, go on
            traceback.print_exc()
            self.failures.append(f"{name} raised")
            print(f"[chip_smoke] FAIL {name} raised", flush=True)
            return None
        print(f"[chip_smoke] phase {name}: {time.perf_counter() - t0:.1f}s", flush=True)
        return out


# ---------------------------------------------------------------------------
# phase 1: every kernel against its plain version
# ---------------------------------------------------------------------------


def _kernel_cases(dev):
    """(kernel, label, kernel fn, plain fn, library fn, bytes, flops) at the
    serving path's shapes."""
    import torch

    from repro_torch.kernels.grouped_sumvec import kernel as gk
    from repro_torch.kernels.sumvec_fft import kernel as fk
    from repro_torch.kernels.sumvec_fft.ops import fft_plan
    from repro_torch.kernels.utils import dft_matrices, full_dft_adjoint, full_dft_matrices
    from repro_torch.kernels.xcorr_offdiag import kernel as xk

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    rand = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    n, b = 256, 128
    cases = []

    def cmm(label, m, k, nn, real_a, sign=-1, offset=0, basis=None):
        # B: the DFT basis of the plan (k == nn), or a random (k, nn) one
        br, bi = full_dft_matrices(k, sign, dev) if basis is None else (rand(k, nn), rand(k, nn))
        ar = view(offset, m, k)
        ai = None if real_a else rand(m, k)
        if real_a:  # one real product computes the same function: Ar @ [Br | Bi]
            bcat = torch.cat([br, bi], 1)
            lib, yard = (lambda: ar @ bcat), "real ar @ [br|bi]"
        else:
            ac, bc = torch.complex(ar, ai), torch.complex(br, bi)
            lib, yard = (lambda: ac @ bc), "complex @"
        nbytes = 4 * (m * k * (1 if real_a else 2) + 2 * k * nn + 2 * m * nn)
        flops = (4 if real_a else 8) * m * k * nn
        cases.append((
            "cmatmul", f"{label} [library: {yard}]",
            lambda: fk.cmatmul(ar, ai, br, bi),
            lambda: fk.cmatmul_plain(ar, ai, br, bi),
            lib, nbytes, flops,
        ))

    def view(offset, *shape):  # contiguous, ``offset`` floats into its buffer
        return rand(offset + math.prod(shape))[offset:].view(*shape)

    def ctw(label, rows, d, offset=0):
        xr, xi, wr, wi = view(offset, rows, d), rand(rows, d), rand(d), rand(d)
        xc, wc = torch.complex(xr, xi), torch.complex(wr, wi)
        cases.append((
            "ctwiddle", label,
            lambda: fk.ctwiddle(xr, xi, wr, wi),
            lambda: fk.ctwiddle_plain(xr, xi, wr, wi),
            lambda: xc * wc,
            4 * (4 * rows * d + 2 * d), 6 * rows * d,
        ))

    def pmm(label, m, k, nn, basis=None, offset=0):
        a = view(offset, m, k)
        bmat = rand(k, nn) if basis is None else basis
        cases.append((
            "pmatmul", label,
            lambda: gk.pmatmul(a, bmat),
            lambda: gk.pmatmul_plain(a, bmat),
            lambda: torch.matmul(a, bmat),
            4 * (m * k + k * nn + m * nn), 2 * m * k * nn,
        ))

    def cmm_bwd(label, m, k, nn, real_out):
        # the vjp's dA = g @ B^H at the forward's shape; the real-input first
        # stage asks for Re dA only, which one real product computes:
        # [Gr | Gi] @ [BHr ; -BHi]
        bhr, bhi = full_dft_adjoint(k, -1, dev)
        gr, gi = rand(m, nn), rand(m, nn)
        if real_out:
            gcat, bcat = torch.cat([gr, gi], 1), torch.cat([bhr, -bhi], 0)
            lib, yard = (lambda: gcat @ bcat), "real [gr|gi] @ [bhr;-bhi]"
        else:
            gc, bhc = torch.complex(gr, gi), torch.complex(bhr, bhi)
            lib, yard = (lambda: gc @ bhc), "complex @"
        pick = (lambda c: c[0]) if real_out else (lambda c: c)
        nbytes = 4 * (2 * m * nn + 2 * nn * k + (1 if real_out else 2) * m * k)
        flops = (4 if real_out else 8) * m * nn * k
        cases.append((
            "cmatmul", f"{label} [library: {yard}]",
            lambda: pick(fk._cmatmul_launch(gr, gi, bhr, bhi, real_out=real_out)),
            lambda: pick(fk.cmatmul_plain(gr, gi, bhr, bhi)),
            lib, nbytes, flops,
        ))

    def fm(label, f, k, nn, n2, offset=0):
        a, m = view(offset, f, k, nn), rand(f, nn, n2)
        cases.append((
            "freq_mat", label,
            lambda: gk.freq_mat(a, m),
            lambda: gk.freq_mat_plain(a, m),
            lambda: torch.bmm(a, m),
            4 * (f * k * nn + f * nn * n2 + f * k * n2), 2 * f * k * nn * n2,
        ))

    def xc(label, rows, d, offset=0):
        z1, z2 = view(offset, rows, d), rand(rows, d)

        def library():  # cuBLAS C = z1^T z2 (TF32 off), then the square-sum
            c = z1.T @ z2
            return torch.sum(c * c) - torch.sum(torch.diagonal(c) ** 2)

        cases.append((
            "xcorr_offdiag", label,
            lambda: xk.off_diagonal_sq_sum_raw(z1, z2),
            lambda: xk.off_diagonal_sq_sum_plain(z1, z2),
            library,
            4 * (2 * rows * d + 1), 2 * rows * d * d + 2 * d * d,
        ))

    def fo(label, f, k, nn, nb=None, offset=0):
        nb = nn if nb is None else nb
        a, bb = view(offset, f, k, nn), rand(f, k, nb)
        cases.append((
            "freq_outer", label,
            lambda: gk.freq_outer(a, bb),
            lambda: gk.freq_outer_plain(a, bb),
            lambda: torch.bmm(a.mT, bb),
            4 * (f * k * nn + f * k * nb + f * nn * nb), 2 * f * k * nn * nb,
        ))

    nf = b // 2 + 1
    cr, ci = dft_matrices(b, dev)
    block_basis = torch.cat([cr, ci], dim=1).contiguous()
    block_basis_t = block_basis.T.contiguous()
    for d in (2048, 8192):
        p = fft_plan(d)
        cmm(f"d={d} stage1 ({n * p.d2},{p.d1})x({p.d1},{p.d1}) real A", n * p.d2, p.d1, p.d1, True)
        ctw(f"d={d} twiddle ({n},{d})", n, d)
        cmm(f"d={d} stage3 ({n * p.d1},{p.d2})x({p.d2},{p.d2})", n * p.d1, p.d2, p.d2, False)
        nb = d // b
        pmm(f"d={d} block DFT ({n * nb},{b})x({b},{2 * nf})", n * nb, b, 2 * nf, block_basis)
        fo(f"d={d} freq_outer ({nf},{2 * n},{nb})", nf, 2 * n, nb)
        pmm(f"d={d} q=1 synthesis ({nb * nb},{nf})x({nf},{b})", nb * nb, nf, b)
        fm(f"d={d} freq_mat ({nf},{2 * n},{nb})x({nf},{nb},{nb})", nf, 2 * n, nb, nb)
        xc(f"d={d} xcorr ({n},{d})", n, d)
        cmm_bwd(f"bwd d={d} stage1 dA ({n * p.d2},{p.d1})x({p.d1},{p.d1}) real out", n * p.d2, p.d1, p.d1, True)
        cmm_bwd(f"bwd d={d} stage3 dA ({n * p.d1},{p.d2})x({p.d2},{p.d2})", n * p.d1, p.d2, p.d2, False)
        pmm(f"bwd d={d} block DFT dA ({n * nb},{2 * nf})x({2 * nf},{b})", n * nb, 2 * nf, b, block_basis_t)
    # the other paths of the redesigned kernels: ctwiddle with d % 4 != 0 (the
    # padded plan of d = 61), an operand at an odd offset, rows not a multiple
    # of the 4 a thread owns; pmatmul with N = 65 and N = 300 (past a block's
    # 132 columns), the vjp's dB (K = 4096, many ring stages), M = 1, A at an
    # odd offset, K = 130 (A resident, as in the bwd dA above) at an odd
    # offset, K = 257 (too deep to stay resident, a 1-deep last slice)
    ctw(f"edge dp=121 twiddle ({n},121)", n, 121)
    ctw("edge xr at +4 bytes twiddle (256,2048)", n, 2048, offset=1)
    ctw("edge rows=257 twiddle (257,2048)", 257, 2048)
    pmm("edge N=65 (300,128)x(128,65)", 300, 128, 65)
    pmm(f"edge bwd dB ({b},4096)x(4096,{2 * nf})", b, 4096, 2 * nf)
    pmm(f"edge M=1 (1,{b})x({b},{2 * nf})", 1, b, 2 * nf, block_basis)
    pmm(f"edge A at +4 bytes ({16 * n},{b})x({b},{2 * nf})", 16 * n, b, 2 * nf, block_basis, offset=1)
    pmm(f"edge K=130 A at +4 bytes (300,{2 * nf})x({2 * nf},{b})", 300, 2 * nf, b, block_basis_t, offset=1)
    pmm(f"edge K=257 (77,257)x(257,{2 * nf})", 77, 257, 2 * nf)
    pmm("edge N=300 (70,40)x(40,300)", 70, 40, 300)
    # the other paths of the redesigned cmatmul and freq_mat: N = 11 (the
    # dp = 121 plan of d = 61, scalar twin), M = 1, M no multiple of a strip's
    # rows, A 4 bytes off a 16-byte boundary (no bulk copy), K too deep for B
    # to stay resident (a ring of K slices); freq_mat with N = N2 = 9 and a at
    # an odd offset (scalar twin), K no multiple of a block's rows
    cmm("edge dp=121 stage1 (2816,11)x(11,11) real A", 2816, 11, 11, True)
    cmm("edge dp=121 stage3 (2816,11)x(11,11)", 2816, 11, 11, False)
    cmm("edge M=1 (1,64)x(64,64)", 1, 64, 64, False)
    cmm("edge M=8191 (8191,64)x(64,64)", 8191, 64, 64, False)
    cmm("edge A at +4 bytes (8192,64)x(64,64)", 8192, 64, 64, False, offset=1)
    cmm("edge K=600 (64,600)x(600,40)", 64, 600, 40, False, basis="random")
    cmm_bwd("edge bwd M=8191 real out (8191,64)x(64,64)", 8191, 64, 64, True)
    fm(f"edge N=N2=9 freq_mat ({nf},{2 * n},9)x({nf},9,9)", nf, 2 * n, 9, 9)
    fm(f"edge a at +4 bytes freq_mat ({nf},{2 * n},16)x({nf},16,16)", nf, 2 * n, 16, 16, offset=1)
    fm(f"edge K=500 freq_mat ({nf},500,16)x({nf},16,16)", nf, 500, 16, 16)
    # the redesigned freq_outer's other paths (d = 8192's case above is also
    # the shape of freq_mat's vjp dm = freq_outer(a, g)).  The register-fed
    # kernel: N = 1 (d = b = 128 grouped) and N = 9 (4-byte loads), N != NB
    # with N past one 64-wide tile, N = 16 against NB = 64, a single K row,
    # K = 500 and K = 4096 (many rows a thread), a 4 bytes off a 16-byte
    # boundary (4-byte loads).  The staged kernel (N, NB >= 64): K = 1000 (a
    # ring refilled), N = 130 and NB = 100 (a in 4-byte pieces, b's columns by
    # a tensor copy, ragged tiles), a 4 bytes off (4-byte pieces).  Tiles
    # halved below 64 x 64 to fit the register-fed kernel's threads (N = 50
    # against NB = 130, N = 48 at F = 132), and K = 0 at N = 64 (zeros)
    fo(f"edge freq_outer N=1 ({nf},{2 * n},1)", nf, 2 * n, 1)
    fo(f"edge freq_outer N=9 ({nf},{2 * n},9)", nf, 2 * n, 9)
    fo("edge freq_outer N=130 NB=9 (2,70,130)x(2,70,9)", 2, 70, 130, 9)
    fo(f"edge freq_outer N=16 NB=64 ({nf},{2 * n},16)x({nf},{2 * n},64)", nf, 2 * n, 16, 64)
    fo(f"edge freq_outer K=1 ({nf},1,16)", nf, 1, 16)
    fo(f"edge freq_outer K=500 ({nf},500,16)", nf, 500, 16)
    fo(f"edge freq_outer K=4096 ({nf},4096,16)", nf, 4096, 16)
    fo(f"edge freq_outer a at +4 bytes ({nf},{2 * n},16)", nf, 2 * n, 16, offset=1)
    fo(f"edge freq_outer K=1000 ({nf},1000,64)", nf, 1000, 64)
    fo("edge freq_outer N=130 NB=100 (4,300,130)x(4,300,100)", 4, 300, 130, 100)
    fo(f"edge freq_outer N=64 a at +4 bytes ({nf},{2 * n},64)", nf, 2 * n, 64, offset=1)
    fo("edge freq_outer N=50 NB=130 (65,64,50)x(65,64,130)", 65, 64, 50, 130)
    fo("edge freq_outer N=48 F=132 (132,64,48)", 132, 64, 48)
    fo(f"edge freq_outer K=0 ({nf},0,64)", nf, 0, 64)
    # the LM path's probe: ungrouped R_sum of 8-row windows at d = 2304
    p = fft_plan(2304)
    cmm(f"lm d=2304 stage1 ({8 * p.d2},{p.d1})x({p.d1},{p.d1}) real A", 8 * p.d2, p.d1, p.d1, True)
    cmm(f"lm d=2304 stage3 ({8 * p.d1},{p.d2})x({p.d2},{p.d2})", 8 * p.d1, p.d2, p.d2, False)
    # the LM train step's aux loss ([lmtrain]): n = 64 rows of d = 2304
    # (gemma2-2b, batch 8 x 8 subsampled tokens) through every aux arm's
    # kernels, forward and as the vjps call them; n = 32 of d = 5120
    # (llama4-scout, batch 4) through the ungrouped arm's
    for d, rows in ((2304, LMTRAIN_N), (5120, LMTRAIN_MOE_N)):
        p = fft_plan(d)
        tag = f"lmtrain n={rows} d={d}"
        cmm(f"{tag} stage1 ({rows * p.d2},{p.d1})x({p.d1},{p.d1}) real A", rows * p.d2, p.d1, p.d1, True)
        ctw(f"{tag} twiddle ({rows},{d})", rows, d)
        cmm(f"{tag} stage3 ({rows * p.d1},{p.d2})x({p.d2},{p.d2})", rows * p.d1, p.d2, p.d2, False)
        cmm_bwd(f"bwd {tag} stage1 dA ({rows * p.d2},{p.d1})x({p.d1},{p.d1}) real out", rows * p.d2, p.d1, p.d1,
                True)
        cmm_bwd(f"bwd {tag} stage3 dA ({rows * p.d1},{p.d2})x({p.d2},{p.d2})", rows * p.d1, p.d2, p.d2, False)
    nb, tag = 2304 // b, f"lmtrain n={LMTRAIN_N} d=2304"
    pmm(f"{tag} block DFT ({LMTRAIN_N * nb},{b})x({b},{2 * nf})", LMTRAIN_N * nb, b, 2 * nf, block_basis)
    fo(f"{tag} freq_outer ({nf},{2 * LMTRAIN_N},{nb})", nf, 2 * LMTRAIN_N, nb)
    fm(f"bwd {tag} freq_mat ({nf},{2 * LMTRAIN_N},{nb})x({nf},{nb},{nb})", nf, 2 * LMTRAIN_N, nb, nb)
    pmm(f"bwd {tag} block DFT dA ({LMTRAIN_N * nb},{2 * nf})x({2 * nf},{b})", LMTRAIN_N * nb, 2 * nf, b,
        block_basis_t)
    xc(f"{tag} xcorr ({LMTRAIN_N},2304)", LMTRAIN_N, 2304)
    p = fft_plan(2039)  # prime: padded plan, q = 1 needs the inverse pipeline
    cmm(f"d=2039 dp={p.dp} stage1 ({n * p.d2},{p.d1})x({p.d1},{p.d1}) real A", n * p.d2, p.d1, p.d1, True)
    ctw(f"d=2039 dp={p.dp} twiddle ({n},{p.dp})", n, p.dp)
    cmm(f"d=2039 dp={p.dp} stage3 ({n * p.d1},{p.d2})x({p.d2},{p.d2})", n * p.d1, p.d2, p.d2, False)
    cmm(f"d=2039 inverse ({p.d1},{p.d2})x({p.d2},{p.d2})", p.d1, p.d2, p.d2, False, sign=1)
    ctw(f"d=2039 inverse twiddle (1,{p.dp})", 1, p.dp)
    cmm(f"d=2039 inverse ({p.d2},{p.d1})x({p.d1},{p.d1})", p.d2, p.d1, p.d1, False, sign=1)
    xc(f"d=2039 xcorr ({n},2039) ragged tiles", n, 2039)
    # the redesigned xcorr_offdiag's other paths: one tile, a ragged last
    # tile column of 1 or 2 (d % 4 != 0: the scalar twin), a batch of 1, a
    # batch that is no multiple of a ring stage's rows, z1 4 bytes off a
    # 16-byte boundary (the scalar twin at d = 2048)
    xc("edge d=128 xcorr (256,128)", n, 128)
    xc("edge d=129 n=17 xcorr (17,129)", 17, 129)
    xc("edge d=130 n=300 xcorr (300,130)", 300, 130)
    xc("edge n=1 xcorr (1,2039)", 1, 2039)
    xc("edge n=17 xcorr (17,8192)", 17, 8192)
    xc("edge n=300 xcorr (300,2048)", 300, 2048)
    xc("edge z1 at +4 bytes xcorr (256,2048)", n, 2048, offset=1)
    _paged_cases(cases, dev, gen)
    return cases


# paged_attention's phase-1 shape: gemma2-2b's heads (8 query / 4 kv of
# 256) and scale (query_pre_attn_scalar = 256), the LM path's page
PAGED_SHAPE = dict(h=8, kv=4, hd=256, page=LM_PAGE, scale=1.0 / 16.0)
# the other archs' phase-1 lengths (8 slots, up to 2048 rows)
ARCH_LENS = [2048, 1500, 901, 333, 64, 17, 2, 1]
# q gain that lifts |scale * q.k| to ~30-150, where the softcap 50 * tanh(s/50)
# moves the output far more than the tolerance (unit q keeps |s| near 3)
HOT_Q = 40.0


def _paged_inputs(dev, gen, lens, dtype, q_gain=1.0, shape=PAGED_SHAPE, nb=0):
    """q (B, H, hd) f32, k/v page pools in ``dtype``, a permuted block table
    with a ragged page count per slot (unused entries on the sentinel page
    0; at least ``nb`` entries wide) and int32 lengths, all on ``dev``."""
    import torch

    h, kv, hd, page = (shape[k] for k in ("h", "kv", "hd", "page"))
    b = len(lens)
    need = [-(-n // page) for n in lens]
    nb = max(max(need), nb)
    p_total = sum(need) + 1
    ids = (torch.randperm(p_total - 1, generator=gen) + 1).tolist()
    table = torch.zeros((b, nb), dtype=torch.int32)
    for i, k in enumerate(need):
        table[i, :k] = torch.tensor(ids[:k], dtype=torch.int32)
        ids = ids[k:]
    q = (torch.randn(b, h, hd, generator=gen) * q_gain).to(dev)
    kp = torch.randn(p_total, page, kv, hd, generator=gen).to(dtype).to(dev)
    vp = torch.randn(p_total, page, kv, hd, generator=gen).to(dtype).to(dev)
    return q, kp, vp, table.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)


_FLEX = {}


def _flex_library(q, k, v, lens, *, scale, softcap, window, start=0):
    """paged_attention's library yardstick where a soft cap or a window
    applies: ``flex_attention``, compiled (its decode path), on a dense
    (B, rows, KV, hd) block of the slots' rows — the cap as its
    ``score_mod``, the lengths, the block's ``start`` and the window as its
    block mask, GQA by ``enable_gqa``, the log-sum-exp by ``AuxRequest``.
    flex takes one dtype, so q is rounded to the block's.  The mask, the q
    cast and the gather of a paged pool are made outside the timed call;
    ``start`` and the window are tensors, so one compilation serves every
    block of a shape.  Returns the timed call, with ``call.check()``: (out
    error relative to max(1, max |plain|), LSE error over the live slots)
    against the plain version on the rounded q, and ``call.first_s``: the
    seconds of its first call (the compilation where the shape is new)."""
    import torch
    from torch.nn.attention.flex_attention import AuxRequest, create_block_mask, flex_attention

    from repro_torch.kernels.paged_attention.ops import paged_decode_plain

    key = (float(scale), float(softcap))
    if key not in _FLEX:
        cap = float(softcap)
        mod = (lambda s, b, h, qi, ki: cap * torch.tanh(s / cap)) if cap else None

        def run(q4, k4, v4, mask):
            out, aux = flex_attention(q4, k4, v4, score_mod=mod, block_mask=mask, scale=scale, enable_gqa=True,
                                      return_aux=AuxRequest(lse=True))
            return out, aux.lse

        _FLEX[key] = torch.compile(run, dynamic=False)
    fn = _FLEX[key]
    b, rows = k.shape[0], k.shape[1]
    start_t = torch.tensor(start, dtype=torch.int32, device=k.device)
    window_t = torch.tensor(window or 1 << 30, dtype=torch.int32, device=k.device)

    def live(bi, hi, qi, ki):
        pos = ki + start_t
        return (pos < lens[bi]) & (pos >= lens[bi] - window_t)

    mask = create_block_mask(live, b, None, 1, rows, device=k.device)
    qr = q.to(k.dtype)[:, :, None]
    k4, v4 = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # (B, KV, rows, hd) views, no copy

    def call():
        return fn(qr, k4, v4, mask)

    def check():
        out, lse = call()
        table = torch.arange(b, dtype=torch.int32, device=k.device)[:, None]
        want, want_lse = paged_decode_plain(qr[:, :, 0].float(), k, v, table, lens, scale=scale, softcap=softcap,
                                            window=window, start=start, return_lse=True)
        out, lse = out[:, :, 0].float(), lse[:, :, 0].float()
        err = float((out - want).abs().max()) / max(1.0, float(want.abs().max()))
        empty = torch.isinf(want_lse)
        ok_empty = bool(torch.equal(torch.isinf(lse), empty))
        lse_err = float((lse - want_lse)[~empty].abs().max()) if bool((~empty).any()) else 0.0
        return err, lse_err if ok_empty else math.inf

    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    call.first_s = time.perf_counter() - t0
    call.check = check
    return call


def _paged_cases(cases, dev, gen):
    """paged_attention at the LM path's decode shape (8 slots, 8 query / 4
    kv heads of 256, page 16, lengths as the 24-request workload leaves
    them) and at a long-context shape (lengths up to 8192): f32 and bf16
    pages, softcap 0 / 50, window 0 / 4096, a ragged page count per slot
    (permuted physical pages, unused entries on the sentinel) and a length
    of 1; and "hot" cases with q * HOT_Q at softcap 30 / 50, where the cap
    changes the output (``_softcap_control`` shows by how much).  The
    library yardstick is ``scaled_dot_product_attention`` on the
    pre-gathered, head-expanded dense view (gather excluded from its time),
    the one PyTorch call that computes the same function, at softcap 0 and
    window 0; at the JSON line's case (bf16, softcap 50, window 4096), the
    long cases at softcap 50 (window 4096 and 0) and the verify cases (bf16
    and f32) it is compiled ``flex_attention`` on the pre-gathered view
    (``_flex_library``), held against the plain version at LIB_TOL.  The
    other capped or windowed cases time no library call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain
    from repro_torch.kernels.paged_attention.ref import gather_pages

    def case(label, lens, dtype, softcap, window, q_gain=1.0, shape=PAGED_SHAPE, nb=0, flex=False):
        h, kv, hd, page, scale = (shape[k] for k in ("h", "kv", "hd", "page", "scale"))
        b = len(lens)
        nb = max(max(-(-n // page) for n in lens), nb)
        q, kp, vp, table, lens_t = _paged_inputs(dev, gen, lens, dtype, q_gain, shape, nb)
        kw = dict(scale=scale, softcap=softcap, window=window)
        lib = None
        if flex:
            lib = _flex_library(q, gather_pages(kp, table), gather_pages(vp, table), lens_t, **kw)
        elif not softcap and not window:
            kd = gather_pages(kp, table).float().repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
            vd = gather_pages(vp, table).float().repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
            mask = (torch.arange(nb * page, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask, scale=scale)[:, :, 0]
        rows = sum(min(n, window) if window else n for n in lens)
        elt = torch.empty((), dtype=dtype).element_size()
        nbytes = rows * kv * hd * 2 * elt + 2 * 4 * b * h * hd + 4 * (b * nb + b)
        cases.append((
            "paged_attention", label,
            lambda: pk.paged_decode_attention(q, kp, vp, table, lens_t, **kw),
            lambda: paged_decode_plain(q, kp, vp, table, lens_t, **kw),
            lib, nbytes, 4 * rows * h * hd,
        ))

    def verify_case(label, lens, dtype, softcap, window, lanes=DRAFT_K + 1):
        """The speculative verify's shape: each slot's ``lanes`` lanes on
        one table row at lengths len .. len + lanes - 1 (B = slots x lanes).
        The bound counts a slot's rows once (its lanes share them)."""
        h, kv, hd, page, scale = (PAGED_SHAPE[k] for k in ("h", "kv", "hd", "page", "scale"))
        tops = [n + lanes - 1 for n in lens]
        q, kp, vp, table, _ = _paged_inputs(dev, gen, tops, dtype)
        b = len(lens) * lanes
        q = torch.randn(b, h, hd, generator=gen).to(dev)
        table = table.repeat_interleave(lanes, dim=0).contiguous()
        lane_lens = [n + j for n in lens for j in range(lanes)]
        lens_t = torch.tensor(lane_lens, dtype=torch.int32, device=dev)
        kw = dict(scale=scale, softcap=softcap, window=window)
        live = lambda n: min(n, window) if window else n  # noqa: E731
        elt = torch.empty((), dtype=dtype).element_size()
        nbytes = sum(live(n) for n in tops) * kv * hd * 2 * elt + 2 * 4 * b * h * hd + 4 * (b * table.shape[1] + b)
        lib = _flex_library(q, gather_pages(kp, table), gather_pages(vp, table), lens_t, **kw)
        cases.append((
            "paged_attention", label,
            lambda: pk.paged_decode_attention(q, kp, vp, table, lens_t, **kw),
            lambda: paged_decode_plain(q, kp, vp, table, lens_t, **kw),
            lib, nbytes, 4 * sum(live(n) for n in lane_lens) * h * hd,
        ))

    main_lens = [1, 5, 17, 24, 33, 44, 16, 40]
    long_lens = [8192, 7001, 4097, 4096, 2500, 1000, 17, 1]
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        verify_case(f"verify {tag} softcap=50 window=4096 (B=40: 8 slots x {DRAFT_K + 1} lanes on one row each)",
                    main_lens, dtype, 50.0, 4096)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        case(f"main {tag} softcap=50 window=4096 (B=8,H=8,KV=4,hd=256,page=16)", main_lens, dtype, 50.0, 4096,
             flex=dtype == torch.bfloat16)
        case(f"main {tag} softcap=50 window=0", main_lens, dtype, 50.0, 0)
        case(f"main {tag} softcap=0 window=0", main_lens, dtype, 0.0, 0)
    case("long bf16 softcap=50 window=4096 (B=8, lens to 8192)", long_lens, torch.bfloat16, 50.0, 4096, flex=True)
    case("long bf16 softcap=50 window=0", long_lens, torch.bfloat16, 50.0, 0, flex=True)
    case("long bf16 softcap=0 window=0", long_lens, torch.bfloat16, 0.0, 0)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for softcap in (30.0, 50.0):
            case(f"hot {tag} softcap={softcap:g} window=4096 q*{HOT_Q:g}", main_lens, dtype, softcap, 4096, HOT_Q)
    case(f"hot long bf16 softcap=50 window=4096 q*{HOT_Q:g}", long_lens, torch.bfloat16, 50.0, 4096, HOT_Q)
    # the split kernel's edges (CHUNK rows a block): lengths at CHUNK - 1,
    # CHUNK, CHUNK + 1 and past two chunks; a length of 1 in a 4096-row
    # table (15 of 16 chunks empty); a window whose start lo falls inside a
    # page and leaves a ragged last chunk; a window longer than every
    # length; n_rep 1, 4 and 8 with hd 128 and 48 and a page of 5
    ch = pk.CHUNK
    edge = [ch - 1, ch, ch + 1, 1, 2 * ch + 1, 3 * ch - 1, 3 * ch, 3 * ch + 1]
    case(f"edge lens at CHUNK-1/CHUNK/CHUNK+1 bf16 softcap=50 window=0 (lens {edge})", edge, torch.bfloat16, 50.0, 0)
    case("edge len=1 in a wide table f32 softcap=0 window=0 (NB=256)", [1, 1, 2, 1, 1, 3, 1, 1], torch.float32,
         0.0, 0, nb=256)
    case("edge window=700 lo mid-chunk bf16 softcap=50", [1000, 777, 300, 5000, 4097, 17, 2600, 1],
         torch.bfloat16, 50.0, 700)
    case("edge window=9000 > len bf16 softcap=30", long_lens, torch.bfloat16, 30.0, 9000)
    for h_, kv_, hd_, page_ in ((4, 4, 128, 5), (8, 2, 128, 16), (8, 1, 48, 5)):
        shape = dict(h=h_, kv=kv_, hd=hd_, page=page_, scale=hd_ ** -0.5)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            case(f"edge n_rep={h_ // kv_} hd={hd_} page={page_} {tag} softcap=50 window=300",
                 [300, 1, ch + 1, 40, 2 * ch, 999], dtype, 50.0, 300, shape=shape)
        case(f"edge n_rep={h_ // kv_} hd={hd_} page={page_} f32 softcap=0 window=0",
             [300, 1, ch + 1, 40, 2 * ch, 999], torch.float32, 0.0, 0, shape=shape)
    # every other attention arch at its full head geometry (phase 6 serves
    # them at these heads, at a cut depth where the model does not fit one
    # card): 8 slots, page 16, lengths up to 2048, the config's softcap
    # and windows; n_rep 1 to 12 and hd 64, 128 and 192 (nemotron's, whose
    # 12 query rows a kv head split into two blocks of 6, and whose rows the
    # kernel loads element by element: 192 is no 32 * VEC)
    from repro_torch.configs import get_config, list_archs

    for arch in list_archs():
        c = get_config(arch)
        if arch == "gemma2-2b" or c.is_attention_free:
            continue
        shape = dict(h=c.n_heads, kv=c.n_kv_heads, hd=c.hd, page=LM_PAGE, scale=c.attn_scale or c.hd ** -0.5)
        windows = sorted({c.window_size if b.attn_type == "local" else 0 for b in c.pattern if b.mixer == "attn"})
        for window in windows:
            for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                case(f"arch {arch} {tag} softcap={c.attn_softcap or 0:g} window={window} "
                     f"(H={c.n_heads},KV={c.n_kv_heads},hd={c.hd},n_rep={c.n_heads // c.n_kv_heads})",
                     ARCH_LENS, dtype, c.attn_softcap or 0.0, window, shape=shape)


def _softcap_control(ph: Phase, dev):
    """The hot cases' inputs do reach the softcap: their scores run to
    |s| >= 30, and the plain version's output at softcap 30 / 50 differs from
    the uncapped one by more than 100 x the kernel tolerance, so a kernel
    that dropped or mis-scaled the tanh cap fails those cases."""
    import torch

    from repro_torch.kernels.paged_attention.ops import paged_decode_plain
    from repro_torch.kernels.paged_attention.ref import gather_pages

    gen = torch.Generator().manual_seed(SEED + 7)
    q, kp, vp, table, lens_t = _paged_inputs(dev, gen, [1, 5, 17, 24, 33, 44, 16, 40], torch.float32, HOT_Q)
    kv, scale = PAGED_SHAPE["kv"], PAGED_SHAPE["scale"]
    kd = gather_pages(kp, table)  # (B, NB * page, KV, hd)
    s = torch.einsum("bgrd,btgd->bgrt", q.view(q.shape[0], kv, -1, q.shape[-1]), kd) * scale
    live = torch.arange(kd.shape[1], device=dev)[None, :] < lens_t[:, None]
    s_max = float(s.abs().masked_fill(~live[:, None, None, :], 0.0).max())
    uncapped = paged_decode_plain(q, kp, vp, table, lens_t, scale=scale)
    for softcap in (30.0, 50.0):
        capped = paged_decode_plain(q, kp, vp, table, lens_t, scale=scale, softcap=softcap)
        diff = float((capped - uncapped).abs().max())
        tol = KERNEL_TOL * max(1.0, float(capped.abs().max()))
        ph.check(s_max >= 30.0 and diff > 100 * tol,
                 f"paged_attention hot cases: softcap={softcap:g} moves the plain output by {diff:.3g} "
                 f"(needs > 100 x tol {tol:.3g}), max |s| {s_max:.1f} (needs >= 30)")
        print(f"[kernel] paged_attention softcap control: q*{HOT_Q:g} max|s|={s_max:.1f}; plain output at "
              f"softcap={softcap:g} vs uncapped max_abs_diff={diff:.4g} = {diff / tol:.0f} x the kernel tolerance",
              flush=True)


# the case whose numbers stand for each kernel in the JSON line: the main
# path's shape at the served width d = 2048
JSON_CASE = {
    "cmatmul": "d=2048 stage3",
    "ctwiddle": "d=2048 twiddle",
    "pmatmul": "d=2048 block DFT",
    "freq_outer": "d=2048 freq_outer",
    "freq_mat": "d=2048 freq_mat",
    "xcorr_offdiag": "d=2048 xcorr",
    "paged_attention": "main bf16 softcap=50 window=4096",
}


def phase_kernels(ph: Phase, dev):
    import torch

    rows = {}
    for name, label, kern, plain, lib, nbytes, flops in _kernel_cases(dev):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err, rel = _max_err(got, want)
        ph.check(rel <= KERNEL_TOL, f"{name} [{label}] rel err {rel:.3g} > {KERNEL_TOL}")
        k_ms = _time_ms(kern)
        p_ms = _time_ms(plain)
        l_ms = _time_ms(lib) if lib is not None else None
        b_ms, by = _bound(nbytes, flops)
        if lib is None:
            none = ("flex_attention timed on the JSON, long and verify cases" if name == "paged_attention"
                    else "no single PyTorch call")
            lib_txt, lib_dev = f"library_ms=none ({none})", "none"
        else:
            lib_txt = f"library_ms={l_ms:.5f}" + (" (gather excluded)" if name == "paged_attention" else "")
            lib_dev = _fmt(_device_ms(lib))
        if hasattr(lib, "check"):
            l_err, l_lse = lib.check()
            ph.check(l_err <= LIB_TOL and l_lse <= LIB_TOL,
                     f"{name} [{label}] flex_attention vs plain: out rel err {l_err:.3g}, LSE err {l_lse:.3g} > {LIB_TOL}")
            lib_txt += (f" (flex_attention, q in the pages' dtype, mask and q cast excluded; out rel err "
                        f"{l_err:.3g} LSE err {l_lse:.3g}; first call {lib.first_s:.1f}s)")
        print(
            f"[kernel] {name:<10} {label}: max_abs_err={err:.3g} rel={rel:.3g} "
            f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} {lib_txt} "
            f"bound_ms={b_ms:.5f} ({by}) | device-only ms: kernel={_fmt(_device_ms(kern))} "
            f"plain={_fmt(_device_ms(plain))} library={lib_dev}",
            flush=True,
        )
        if label.startswith(JSON_CASE[name]):
            rows[name] = {
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "shape": label, "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": l_ms,
            }
    _softcap_control(ph, dev)
    _grad_checks(ph, dev)
    _oracle_checks(ph, dev)
    return rows


def _grad_checks(ph: Phase, dev):
    """The regularizer's gradient at the paper's width (n = 256, d = 8192),
    kernel route vs ``impl="plain"`` route, b = 128 and ungrouped, q = 2;
    with the time of one forward + backward on each route."""
    import torch

    from repro_torch.core import regularizers as regs

    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    n, d = 256, 8192
    z1 = torch.randn(n, d, generator=gen).to(dev).requires_grad_()
    z2 = (0.6 * z1.detach() + 0.8 * torch.randn(n, d, generator=gen).to(dev)).requires_grad_()
    for block in (128, None):
        def fwd_bwd(impl):
            loss = regs.r_sum_auto(z1, z2, q=2, block_size=block, scale=n, impl=impl)
            return (loss,) + torch.autograd.grad(loss, (z1, z2))

        got, want = fwd_bwd(None), fwd_bwd("plain")
        torch.cuda.synchronize()
        loss_rel = abs(float(got[0].detach()) - float(want[0].detach())) / abs(float(want[0].detach()))
        grad_rel = max(_max_err(g, w)[0] / float(w.abs().max()) for g, w in zip(got[1:], want[1:]))
        tag = f"n={n} d={d} b={block} q=2"
        ph.check(loss_rel <= LOSS_TOL, f"[grad] {tag}: loss rel err {loss_rel:.3g}")
        ph.check(grad_rel <= LOSS_TOL, f"[grad] {tag}: grad rel err {grad_rel:.3g}")
        print(
            f"[grad] {tag}: loss_rel_err={loss_rel:.3g} grad_rel_err={grad_rel:.3g} "
            f"fwd_bwd_ms kernel={_time_ms(lambda: fwd_bwd(None), iters=10):.4f} "
            f"plain={_time_ms(lambda: fwd_bwd('plain'), iters=10):.4f}",
            flush=True,
        )


def _oracle_checks(ph: Phase, dev):
    """The paper's identity on the card: the kernel route's R_sum (Eq. 6,
    four-step) and R_sum^(128) (Eq. 13, grouped) against their definitions
    from the explicit C = Z1^T Z2 / n (``r_sum_from_matrix`` /
    ``r_sum_grouped_from_matrix``, plain PyTorch, TF32 off), at n = 256 and
    d = 8192 (the ssl-paper width) and d = 2039 (prime: the padded plan, a
    ragged last block), q = 2 and 1; and ``sumvec_fourstep`` against the
    O(n d^2) ``sumvec_direct`` at d = 2048.  Bounds are the reference's
    tests': rtol 1e-3 (grouped: + atol 1e-4); the summary vector's absolute
    atol 1e-3 (``tests/test_sumvec.py``).  Each check's kernels must have
    launched (counters cleared just before it)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import regularizers as regs
    from repro_torch.core import sumvec as sv
    from repro_torch.core.losses import standardize
    from repro_torch.kernels.sumvec_fft import ops as fops

    gen = torch.Generator(device="cpu").manual_seed(SEED + 11)
    n = 256

    def views(d):
        """Standardized seeded views sharing a component (corr ~0.8)."""
        base = torch.randn(n, d, generator=gen)
        noise = [torch.randn(n, d, generator=gen) for _ in range(2)]
        return tuple(standardize((base + 0.5 * e).to(dev)) for e in noise)

    def check(tag, route, oracle, names, err_of, bound):
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        got = route()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = oracle()
        torch.cuda.synchronize()
        err, ok, value = err_of(got, want)
        secs = time.perf_counter() - t0
        ph.check(ok, f"[oracle] {tag}: error {err:.3g} over {bound}")
        for k in names:
            ph.check(counts.get(k, 0) > 0, f"[oracle] {tag}: {k} did not launch")
        print(f"[oracle] {tag}: {value} err={err:.3g} bound={bound} "
              f"launches={ {k: counts.get(k, 0) for k in names} } s={secs:.2f}", flush=True)

    def scalar(rtol, atol=0.0):
        def err_of(got, want):
            g, w = float(got), float(want)
            err = abs(g - w)
            return err / abs(w), err <= atol + rtol * abs(w), f"kernel={g:.8g} matrix={w:.8g}"
        return err_of

    for d in (8192, 2039):
        z1, z2 = views(d)
        c = regs.cross_correlation_matrix(z1, z2)
        for q in (2, 1):
            check(f"r_sum n={n} d={d} q={q}", lambda: regs.r_sum(z1, z2, q=q, scale=n, impl="kernel"),
                  lambda: regs.r_sum_from_matrix(c, q), ("cmatmul", "ctwiddle"), scalar(1e-3), "rtol 1e-3")
            check(f"r_sum_grouped n={n} d={d} b=128 q={q}",
                  lambda: regs.r_sum_grouped(z1, z2, 128, q=q, scale=n, impl="kernel"),
                  lambda: regs.r_sum_grouped_from_matrix(c, 128, q), ("pmatmul", "freq_outer"),
                  scalar(1e-3, 1e-4), "rtol 1e-3 atol 1e-4")
        del z1, z2, c

    def vector(got, want):
        err, _ = _max_err(got, want)
        return err, err <= 1e-3, f"sumvec[0]={float(want[0]):.6g} max|sumvec[1:]|={float(want[1:].abs().max()):.4g}"

    z1, z2 = views(2048)
    check(f"sumvec_fourstep vs sumvec_direct n={n} d=2048", lambda: fops.sumvec_fourstep(z1, z2, scale=n),
          lambda: sv.sumvec_direct(z1, z2, scale=n), ("cmatmul", "ctwiddle"), vector, "atol 1e-3")


# ---------------------------------------------------------------------------
# phase 2: the embedding service at the ssl-paper width
# ---------------------------------------------------------------------------


def _paper():
    """(model config, bucket policy) of ``configs/ssl_paper``: full widths,
    buckets up to the paper's batch size."""
    from repro_torch.configs import ssl_paper
    from repro_torch.serve.buckets import BucketPolicy
    from repro_torch.train.ssl import SSLModelConfig

    paper = ssl_paper.config()
    model_cfg = SSLModelConfig(paper.input_dim, paper.backbone_widths, paper.projector_widths)
    return model_cfg, BucketPolicy(max_batch=paper.batch_size)


def _serve_once(ph: Phase, dev, block_size, expect):
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.decorr.probe import probe_metrics
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import LoadConfig, request_stream, run_microbatched
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.service import EmbeddingService
    from repro_torch.train.ssl import init_ssl_model

    tag = f"probe block={block_size}"
    model_cfg, policy = _paper()
    cfg = DecorrConfig(style="vic", reg="sum", q=2, block_size=block_size)
    load = LoadConfig(n_requests=N_REQUESTS, input_dim=model_cfg.input_dim, seed=SEED)

    kernels.reset_launch_counts()
    engine = ServeEngine(model_cfg, init_ssl_model(model_cfg, seed=SEED), policy=policy, device=dev)
    probe = DecorrProbe(cfg, perm_seed=SEED, device=dev)
    service = EmbeddingService(engine, policy=policy, probe=probe).start()
    try:
        summary = run_microbatched(service, load)
        metrics = service.metrics()
    finally:
        service.stop()
    counts = kernels.launch_counts()
    print(f"[serve] {tag}: launches {counts}", flush=True)
    for name in expect:
        ph.check(counts[name] > 0, f"{tag}: kernel {name} never launched on the main path")
    ph.check(metrics["dispatch_errors"] == 0, f"{tag}: dispatch_errors={metrics['dispatch_errors']}")
    ph.check(metrics["decorr_probe_steps"] == N_REQUESTS // 256,
             f"{tag}: probe fired {metrics['decorr_probe_steps']} times")

    rows = summary.pop("rows")
    ph.check(rows.shape == (N_REQUESTS, engine.d) and bool(np.all(np.isfinite(rows))),
             f"{tag}: served rows not finite of shape ({N_REQUESTS}, {engine.d})")
    # embeddings vs the plain route on the CPU (same seed -> same weights)
    xs, _ = request_stream(load)
    with torch.no_grad():
        want = init_ssl_model(model_cfg, seed=SEED)(torch.from_numpy(xs)).numpy()
    e_err = float(np.max(np.abs(rows - want)))
    e_rel = e_err / max(1.0, float(np.max(np.abs(want))))
    ph.check(e_rel <= EMBED_TOL, f"{tag}: embeddings vs CPU rel err {e_rel:.3g} > {EMBED_TOL}")

    # the last probe window (step 1: rows 256..511) on the plain route, on the card
    window = torch.from_numpy(rows[256:512]).to(dev)
    perm = probe.permutation(1, engine.d)
    plain = {k: float(v) for k, v in probe_metrics(window, None, cfg, perm, impl="plain").items()}
    worst = 0.0
    for k, v in plain.items():
        got = metrics[f"decorr_{k}"]
        rel = abs(got - v) / max(abs(v), 1e-12)
        worst = max(worst, rel)
        ph.check(rel <= PROBE_TOL, f"{tag}: probe {k} kernel {got!r} vs plain {v!r} (rel {rel:.3g})")

    # one probe update, kernel route vs plain route, on the same window; one
    # 256-row encode (host rows in, as the dispatch loop does it)
    k_ms = _time_ms(lambda: probe_metrics(window, None, cfg, perm), iters=20)
    p_ms = _time_ms(lambda: probe_metrics(window, None, cfg, perm, impl="plain"), iters=20)
    enc_ms = _time_ms(lambda: engine.encode(xs[:256]), iters=20)
    print(
        f"[serve] {tag}: {N_REQUESTS} requests p50={summary['p50_ms']:.3f}ms "
        f"p99={summary['p99_ms']:.3f}ms throughput={summary['throughput_rps']:.1f} req/s "
        f"mean_batch={summary['mean_batch']:.1f} embed_rel_err={e_rel:.3g} "
        f"probe_worst_rel_err={worst:.3g} r_sum={metrics['decorr_r_sum']:.6g} "
        f"probe_update_ms kernel={k_ms:.4f} plain={p_ms:.4f} encode256_ms={enc_ms:.4f} "
        f"wall_s={summary['wall_s']:.4f} batches={summary['batches']:.0f}",
        flush=True,
    )
    return counts


def _profile_once(ph: Phase, dev, block_size):
    """Serve 512 requests on a warmed service under the profiler: wall time
    vs summed device time, and the device work by kernel name."""
    import time as _time

    from repro_torch import kernels
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import LoadConfig, request_stream
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.service import EmbeddingService
    from repro_torch.train.ssl import init_ssl_model

    model_cfg, policy = _paper()
    cfg = DecorrConfig(style="vic", reg="sum", q=2, block_size=block_size)
    xs, _ = request_stream(LoadConfig(n_requests=N_REQUESTS, input_dim=model_cfg.input_dim, seed=SEED + 1))
    engine = ServeEngine(model_cfg, init_ssl_model(model_cfg, seed=SEED), policy=policy, device=dev)
    service = EmbeddingService(engine, policy=policy, probe=DecorrProbe(cfg, device=dev))
    service.warmup().start()
    wall = [0.0]

    def serve():
        t0 = _time.perf_counter()
        futures = [service.submit(x, block=True, timeout=60) for x in xs]
        for f in futures:
            f.result(timeout=60)
        wall[0] = _time.perf_counter() - t0

    kernels.reset_launch_counts()
    try:
        events = _device_events(serve)
    finally:
        service.stop()
    counts = kernels.launch_counts()
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    tops = "; ".join(f"{n[:60]}={us / 1e3:.4f}ms" for n, us in top)
    ours = _ported_ms(ph, events, counts, REPLACES, f"probe block={block_size}")
    wall_ms = wall[0] * 1e3
    print(
        f"[profile] probe block={block_size}: {N_REQUESTS} requests wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.4f} idle_share={1 - busy_ms / wall_ms:.4f} "
        f"device events={len(events)} | ported kernels ms: "
        + " ".join(f"{k}={ms:.4f}" for k, (ms, _) in ours.items())
        + f" | top: {tops}",
        flush=True,
    )


def phase_profile(ph: Phase, dev):
    for block in (None, 128):
        _profile_once(ph, dev, block)


def phase_service(ph: Phase, dev):
    totals = {}
    for block, expect in ((None, ("cmatmul", "ctwiddle")), (128, ("pmatmul", "freq_outer"))):
        counts = _serve_once(ph, dev, block, expect)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


# ---------------------------------------------------------------------------
# phase 4: SSL training at the ssl-paper width, kernel route vs plain route
# ---------------------------------------------------------------------------


def _grad_rel(got, want) -> float:
    """Worst per-parameter gradient error, each relative to that parameter's
    largest gradient — or to 1e-3 of the largest over all parameters where a
    gradient vanishes in exact arithmetic (the projector's last bias: the
    losses standardize or center it away), so rounding noise is not read as
    a relative error of 1."""
    scales = [float(w.abs().max()) for w in want]
    floor = 1e-3 * max(scales)
    return max(_max_err(g, w)[0] / max(sc, floor) for g, w, sc in zip(got, want, scales))


def _train_setup(dev, loss_kw, impl, lr=TRAIN_LR, perturb=0.0):
    """(state, train_step, loss_fn) from the seeded ssl-paper model;
    ``perturb`` scales every parameter by (1 + perturb * seeded noise)."""
    import torch

    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.optim import lars, warmup_cosine
    from repro_torch.train import create_train_state, init_ssl_model, make_ssl_train_step

    model_cfg, _ = _paper()
    opt = lars(weight_decay=1e-4)
    model = init_ssl_model(model_cfg, seed=SEED, device=dev)
    if perturb:
        gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=gen).to(dev))
    state = create_train_state(model, opt, seed=SEED)
    sched = warmup_cosine(lr, 2, TRAIN_STEPS)
    step, loss_fn = make_ssl_train_step(model_cfg, DecorrConfig(**loss_kw), opt, sched, impl=impl)
    return state, step, loss_fn


def _max_rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _train_route(dev, loss_kw, impl, batches, **setup_kw):
    """Step-0 gradients, then TRAIN_STEPS steps: (grads, losses, step ms,
    fwd launches, bwd launches, final state, step fn).  Launch counters are
    cleared just after the gradient comparison and read after the steps."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.permutation import permutation_for_step

    state, step, loss_fn = _train_setup(dev, loss_kw, impl, **setup_kw)
    perm = permutation_for_step(state.seed, 0, state.model.d).to(dev)
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss_fn(state.model, batches[0], perm)[0], params)
    torch.cuda.synchronize()
    key = f"{loss_kw['style']}_loss"
    losses, step_ms = [], []
    kernels.reset_launch_counts()
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics[key])
    fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
    return grads, torch.stack(losses).cpu().tolist(), step_ms, fwd, bwd, state, step


def _train_batches(dev, n):
    import torch

    from repro_torch.configs import ssl_paper
    from repro_torch.data import SSLDataConfig, ssl_batch

    paper = ssl_paper.config()
    data = SSLDataConfig(input_dim=paper.input_dim, batch=paper.batch_size, seed=SEED)
    out = []
    for s in range(n):
        v1, v2 = ssl_batch(data, s)
        out.append({"view1": torch.from_numpy(v1).to(dev), "view2": torch.from_numpy(v2).to(dev)})
    return out


def phase_train(ph: Phase, dev):
    """The three arms, kernel route (the main path) and plain route; returns
    ({kernel: forward launches}, {kernel: backward launches}) summed over the
    arms' kernel-route runs."""
    import statistics

    batches = _train_batches(dev, TRAIN_STEPS)
    fwd_total, bwd_total = {}, {}
    profiled = []
    for arm, (loss_kw, names) in ARMS.items():
        k_grads, k_loss, k_ms, fwd, bwd, k_state, k_step = _train_route(dev, loss_kw, None, batches)
        p_grads, p_loss, p_ms, _, _, _, _ = _train_route(dev, loss_kw, "plain", batches)
        grad_rel = _grad_rel(k_grads, p_grads)
        loss_rel = _max_rel(k_loss, p_loss)
        ph.check(grad_rel <= LOSS_TOL, f"[train] {arm}: step-0 grad rel err {grad_rel:.3g} > {LOSS_TOL}")
        ph.check(loss_rel <= LOSS_TOL, f"[train] {arm}: loss rel err {loss_rel:.3g} > {LOSS_TOL}")
        ph.check(all(x == x and abs(x) < float("inf") for x in k_loss), f"[train] {arm}: non-finite loss")
        for name in names:
            ph.check(fwd[name] > 0, f"[train] {arm}: kernel {name} never launched")
            if name in WITH_KERNEL_BWD:
                ph.check(bwd[name] > 0, f"[train] {arm}: kernel {name} never launched on the backward pass")
        for k, v in fwd.items():
            fwd_total[k] = fwd_total.get(k, 0) + v
        for k, v in bwd.items():
            bwd_total[k] = bwd_total.get(k, 0) + v
        print(
            f"[train] {arm}: {TRAIN_STEPS} steps, step-0 grad_rel_err={grad_rel:.3g} "
            f"max loss_rel_err={loss_rel:.3g} loss[0]={k_loss[0]:.6g} loss[-1]={k_loss[-1]:.6g} "
            f"median step ms kernel={statistics.median(k_ms):.4f} plain={statistics.median(p_ms):.4f} | "
            f"launches fwd {dict((k, v) for k, v in fwd.items() if v)} bwd {dict((k, v) for k, v in bwd.items() if v)}",
            flush=True,
        )
        profiled.append((arm, names, k_state, k_step))
        if loss_kw is ARMS["a bt r_sum b=128 q=2"][0]:
            _served_from_checkpoint(ph, dev, k_state, batches)
    for prof in profiled:
        _profile_train(ph, dev, batches, *prof)
    _sensitivity(dev, batches)
    return fwd_total, bwd_total


def _served_from_checkpoint(ph: Phase, dev, state, batches):
    """Arm (a)'s trained state saved through ``checkpoint/`` and served by
    ``ServeEngine.from_checkpoint``: the embeddings of a 256-row batch (a
    bucket: no padding, the same products) equal the trained model's
    forward bit for bit."""
    import shutil

    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.serve.engine import ServeEngine

    model_cfg, policy = _paper()
    ckpt = os.path.join(ROOT, "build", "smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        save_checkpoint(ckpt, state.step, state.state_dict())
        engine = ServeEngine.from_checkpoint(ckpt, model_cfg, policy=policy, device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    x = batches[0]["view1"]
    with torch.no_grad():
        want = state.model(x)
    got = engine.encode(x)
    same = got.shape == want.shape and torch.equal(got, want)
    ph.check(same, f"[train] from_checkpoint: served embeddings differ from the trained forward "
                   f"(max abs {float((got - want).abs().max()):.3g})")
    print(f"[train] from_checkpoint: step {state.step} saved, served {tuple(got.shape)} embeddings "
          f"== the trained model's forward bit for bit: {same}", flush=True)


def _sensitivity(dev, batches):
    """Arm (a) at the paper's peak lr: kernel route vs plain route, and the
    plain route vs itself from parameters perturbed by 1e-7 (the yardstick:
    how far rounding-level differences grow in TRAIN_STEPS steps)."""
    loss_kw = ARMS["a bt r_sum b=128 q=2"][0]
    losses = lambda impl, **kw: _train_route(dev, loss_kw, impl, batches, lr=SENSITIVITY_LR, **kw)[1]
    plain, kern, nudged = losses("plain"), losses(None), losses("plain", perturb=1e-7)
    print(
        f"[train] sensitivity arm a, peak lr {SENSITIVITY_LR}: max loss rel diff kernel vs plain="
        f"{_max_rel(kern, plain):.3g}; plain vs plain with params x (1 + 1e-7 noise)={_max_rel(nudged, plain):.3g} "
        f"(unchecked: the trajectory's own sensitivity)",
        flush=True,
    )


def _profile_train(ph: Phase, dev, batches, arm, names, state, step):
    """PROFILE_STEPS warmed steps of one arm under the profiler: wall time vs
    summed device time (idle share), the arm's kernels' device ms and the
    largest device items."""
    import torch

    from repro_torch import kernels

    wall = [0.0]

    def run():
        t0 = time.perf_counter()
        s = state
        for i in range(PROFILE_STEPS):
            s, _ = step(s, batches[i % len(batches)])
        torch.cuda.synchronize()
        wall[0] = time.perf_counter() - t0

    kernels.reset_launch_counts()
    events = _device_events(run)
    counts = kernels.launch_counts()
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = wall[0] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ours = _ported_ms(ph, events, counts, names, f"train {arm}")
    for name in names:
        ph.check(ours[name][0] > 0, f"[profile] train {arm}: no device time of {name}")
    # torch.cat's device copies (arm a: the four around the two freq_outer
    # calls of grouped_sumvec/ops.grouped_frequency_accumulator_kernel)
    cat = [us for name, us in events if "CatArrayBatchedCopy" in name]
    nccl = [us for name, us in events if "nccl" in name.lower()]
    print(
        f"[profile] train {arm}: {PROFILE_STEPS} steps wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.4f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f} device events={len(events)} | ported kernels ms: "
        + " ".join(f"{k}={ms:.4f} ({n} device launches)" for k, (ms, n) in ours.items())
        + f" | torch.cat ms={sum(cat) / 1e3:.4f} ({len(cat)} device launches)"
        + f" | nccl ms={sum(nccl) / 1e3:.4f} ({len(nccl)} device launches)"
        + " | top: " + "; ".join(f"{n[:60]}={us / 1e3:.4f}ms" for n, us in top),
        flush=True,
    )


# ---------------------------------------------------------------------------
# phase 4b: distributed decorrelation and data-parallel steps, one NCCL rank
# ---------------------------------------------------------------------------


def _dist_regularizer(ph: Phase, dev, meshes):
    """BT loss (R_sum, b = 128, q = 2) at n = 256, d = 8192 under ``global``
    and ``tp`` on the kernel route against ``local``'s kernel route, and
    ``global``'s kernel route against its ``impl="plain"`` route: loss and
    input gradients within 5e-4; pmatmul and freq_outer launched on the
    forward, pmatmul and freq_mat on the backward."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.permutation import permutation_for_step
    from repro_torch.decorr import DecorrConfig, engine
    from repro_torch.parallel import sharding as shd

    gen = torch.Generator(device="cpu").manual_seed(SEED + 11)
    n, d = DIST_N, DIST_D
    z1 = torch.randn(n, d, generator=gen).to(dev)
    z2 = (0.6 * z1 + 0.8 * torch.randn(n, d, generator=gen).to(dev))
    perm = permutation_for_step(SEED, 0, d).to(dev)

    def run(mode, impl=None, count=False):
        cfg = DecorrConfig(style="bt", reg="sum", block_size=DIST_BLOCK, q=2, distributed=mode,
                           axis_name=None if mode == "local" else "data", model_axis="model" if mode == "tp" else None)
        a, c = z1.clone().requires_grad_(), z2.clone().requires_grad_()
        with shd.sharding_context(meshes[mode]):
            kernels.reset_launch_counts()
            loss = engine.apply(a, c, cfg, perm, impl=impl)[0]
            torch.cuda.synchronize()
            fwd = kernels.launch_counts()
            grads = torch.autograd.grad(loss, (a, c))
            torch.cuda.synchronize()
            bwd = {k: v - fwd[k] for k, v in kernels.launch_counts().items()}
        if count:
            for name in ("pmatmul", "freq_outer"):
                ph.check(fwd[name] > 0, f"[dist] {mode}: {name} never launched on the forward pass")
            for name in ("pmatmul", "freq_mat"):
                ph.check(bwd[name] > 0, f"[dist] {mode}: {name} never launched on the backward pass")
        return (loss.detach(),) + grads, fwd, bwd

    def rel(got, want):
        loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        return loss_rel, max(_max_err(g, w)[0] / float(w.abs().max()) for g, w in zip(got[1:], want[1:]))

    local, _, _ = run("local")
    plain, _, _ = run("global", impl="plain")
    for mode in ("global", "tp"):
        got, fwd, bwd = run(mode, count=True)
        for what, want in (("local kernel route", local), ("global plain route", plain)):
            if mode == "tp" and what.startswith("global"):
                continue
            loss_rel, grad_rel = rel(got, want)
            ph.check(loss_rel <= LOSS_TOL and grad_rel <= LOSS_TOL,
                     f"[dist] {mode} kernel route vs {what}: loss {loss_rel:.3g} grad {grad_rel:.3g} > {LOSS_TOL}")
            print(f"[dist] n={n} d={d} b={DIST_BLOCK} q=2 {mode} kernel route vs {what}: loss_rel_err={loss_rel:.3g} "
                  f"grad_rel_err={grad_rel:.3g} | launches fwd {_nonzero(fwd)} bwd {_nonzero(bwd)}", flush=True)


def _dist_steps(ph: Phase, dev, meshes, batches):
    """Arm (a) at the ssl-paper width (LARS, peak lr TRAIN_LR), TRAIN_STEPS
    steps of ``make_sharded_ssl_train_step`` in ``global`` and ``tp`` from
    the same parameters, batches and permutations as ``make_ssl_train_step``
    (run here too, the same call): step-0 gradients per parameter and every
    step's loss within 5e-4; median step ms beside the unsharded step's.
    Returns the sharded runs' ({kernel: launches}, {kernel: backward
    launches}, {mode: (losses, final state, step)})."""
    import statistics

    import torch

    from repro_torch import kernels
    from repro_torch.core.permutation import permutation_for_step
    from repro_torch.train.ssl import shard_ssl_batch

    loss_kw, names = ARMS["a bt r_sum b=128 q=2"]
    want_grads, want_loss, want_ms, _, _, _, _ = _train_route(dev, loss_kw, None, batches)
    model_cfg, _ = _paper()
    fwd_total, bwd_total, runs = {}, {}, {}
    for mode in ("global", "tp"):
        mesh = meshes[mode]
        state, step, loss_and_grads = _sharded_arm_a(dev, mesh, mode)
        local = [shard_ssl_batch(b, mesh) for b in batches]
        perm = permutation_for_step(SEED, 0, model_cfg.projector_widths[-1]).to(dev)
        grads = loss_and_grads(state.model, local[0], perm)[2]
        grad_rel = _grad_rel(grads, want_grads)
        losses, step_ms = [], []
        kernels.reset_launch_counts()
        for batch in local:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["bt_loss"])
        fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
        losses = torch.stack(losses).cpu().tolist()
        loss_rel = _max_rel(losses, want_loss)
        ph.check(grad_rel <= LOSS_TOL, f"[dist] {mode} step: step-0 grad rel err {grad_rel:.3g} > {LOSS_TOL}")
        ph.check(loss_rel <= LOSS_TOL, f"[dist] {mode} step: loss rel err {loss_rel:.3g} > {LOSS_TOL}")
        for name in names:
            ph.check(fwd[name] > 0, f"[dist] {mode} step: kernel {name} never launched")
            if name in WITH_KERNEL_BWD:
                ph.check(bwd[name] > 0, f"[dist] {mode} step: kernel {name} never launched on the backward pass")
        for k, v in fwd.items():
            fwd_total[k] = fwd_total.get(k, 0) + v
        for k, v in bwd.items():
            bwd_total[k] = bwd_total.get(k, 0) + v
        print(f"[dist] {mode} sharded step, arm a, {TRAIN_STEPS} steps on a 1 x 1 mesh: step-0 grad_rel_err={grad_rel:.3g} "
              f"max loss_rel_err={loss_rel:.3g} loss[0]={losses[0]:.6g} loss[-1]={losses[-1]:.6g} | median step ms "
              f"sharded={statistics.median(step_ms):.4f} make_ssl_train_step={statistics.median(want_ms):.4f} | "
              f"launches fwd {_nonzero(fwd)} bwd {_nonzero(bwd)}", flush=True)
        # where the collectives' cost lands: device busy vs wall, NCCL's kernels
        _profile_train(ph, dev, local, f"dist {mode}", names, state, step)
        runs[mode] = (losses, state, step)
    return fwd_total, bwd_total, runs


def _sharded_arm_a(dev, mesh, mode):
    """(state, step, loss_and_grads) of train arm (a) sharded in ``mode`` on
    ``mesh``: seeded weights, LARS, the arm's schedule."""
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.optim import lars, warmup_cosine
    from repro_torch.train.ssl import create_sharded_ssl_state, init_ssl_model, make_sharded_ssl_train_step, ssl_param_specs

    loss_kw, _ = ARMS["a bt r_sum b=128 q=2"]
    model_cfg, _ = _paper()
    cfg = DecorrConfig(**loss_kw, distributed=mode)
    opt = lars(weight_decay=1e-4)
    state = create_sharded_ssl_state(init_ssl_model(model_cfg, seed=SEED, device=dev), opt,
                                     ssl_param_specs(model_cfg, cfg, mesh), mesh, seed=SEED)
    step, loss_and_grads = make_sharded_ssl_train_step(model_cfg, cfg, opt, warmup_cosine(TRAIN_LR, 2, TRAIN_STEPS), mesh)
    return state, step, loss_and_grads


def _dist_serve(ph: Phase, dev, mesh):
    """(4) ``ServeEngine`` at the ssl-paper width on the 1 x 1 mesh,
    data-parallel and tp (``model_axis="model"``), 512 rows: bit for bit
    the unmeshed engine's.  Returns the rows."""
    import torch

    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import LoadConfig, request_stream
    from repro_torch.train.ssl import init_ssl_model

    model_cfg, policy = _paper()
    xs, _ = request_stream(LoadConfig(n_requests=DIST_SERVE_ROWS, input_dim=model_cfg.input_dim, seed=SEED + 2))
    model = init_ssl_model(model_cfg, seed=SEED, device=dev)
    base = ServeEngine(model_cfg, model, policy=policy, device=dev)
    want = base.encode(xs)
    base_ms = _time_ms(lambda: base.encode(xs), iters=10)
    for tag, kw in (("dp", {}), ("tp", dict(model_axis="model"))):
        eng = ServeEngine(model_cfg, model, policy=policy, mesh=mesh, device=dev, **kw)
        got = eng.encode(xs)
        err = float((got - want).abs().max())
        ph.check(torch.equal(got, want), f"[dist] ServeEngine {tag} on a 1 x 1 mesh differs from unmeshed (max abs {err:.3g})")
        ms = _time_ms(lambda: eng.encode(xs), iters=10)
        print(f"[dist] ServeEngine {tag} on a 1 x 1 mesh, {DIST_SERVE_ROWS} rows d={eng.d}: bit-identical="
              f"{torch.equal(got, want)} max_abs_err={err:.3g} | encode ms meshed={ms:.4f} unmeshed={base_ms:.4f}",
              flush=True)
    return want


def _dist_probe(ph: Phase, dev, mesh, z):
    """(5) ``probe_metrics`` in ``global`` / ``tp`` (VICReg, R_sum b = 128,
    q = 2) on the served rows: the kernel route against ``impl="plain"``
    and against ``local``'s kernel route within 5e-4 relative; pmatmul and
    freq_outer launched.  Returns the kernel runs' launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.permutation import permutation_for_step
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.decorr.probe import probe_metrics
    from repro_torch.parallel import sharding as shd

    perm = permutation_for_step(SEED, 0, z.shape[1]).to(dev)
    base = dict(style="vic", reg="sum", q=2, block_size=DIST_BLOCK)
    local = probe_metrics(z, None, DecorrConfig(**base), perm)
    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)  # noqa: E731
    totals = {}
    with shd.sharding_context(mesh):
        for mode in ("global", "tp"):
            cfg = DecorrConfig(**base, distributed=mode, axis_name="data", model_axis="model" if mode == "tp" else None)
            kernels.reset_launch_counts()
            got = probe_metrics(z, None, cfg, perm)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            plain = probe_metrics(z, None, cfg, perm, impl="plain")
            for name in ("pmatmul", "freq_outer"):
                ph.check(counts[name] > 0, f"[dist] probe {mode}: {name} never launched")
            vs_plain = max(rel(got[k], plain[k]) for k in got)
            vs_local = max(rel(got[k], local[k]) for k in got)
            ph.check(vs_plain <= PROBE_TOL and vs_local <= PROBE_TOL,
                     f"[dist] probe {mode}: rel err vs plain {vs_plain:.3g}, vs local {vs_local:.3g} > {PROBE_TOL}")
            k_ms = _time_ms(lambda: probe_metrics(z, None, cfg, perm), iters=20)
            p_ms = _time_ms(lambda: probe_metrics(z, None, cfg, perm, impl="plain"), iters=20)
            print(f"[dist] probe_metrics {mode} b={DIST_BLOCK} on {tuple(z.shape)}: kernel vs plain rel err={vs_plain:.3g} "
                  f"vs local={vs_local:.3g} keys={sorted(got)} r_sum={float(got['r_sum']):.6g} | ms kernel={k_ms:.4f} "
                  f"plain={p_ms:.4f} | launches {_nonzero(counts)}", flush=True)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
    return totals


def _dist_lmtrain(ph: Phase, dev, mesh):
    """(6) ``make_train_step`` on gemma2-2b at full width (2 layers), batch
    8 x 128 in 2 microbatches, aux R_sum b = 128: unmeshed, on the 1 x 1
    mesh, and on it with ``grad_shardings`` (dim 0 over "data"); 3 AdamW
    steps each from the same weights and batches.  Losses and parameters of
    the meshed runs within 5e-4 of the unmeshed run's; pmatmul and
    freq_outer launched forward, pmatmul and freq_mat backward.  Returns the
    meshed runs' ({kernel: launches}, {kernel: backward launches})."""
    import statistics

    import torch

    from repro_torch import kernels
    from repro_torch.data.synthetic import LMDataConfig, lm_batch
    from repro_torch.models import ParamTree, init_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import create_train_state, make_train_step

    cfg = _lmtrain_cfg(DIST_LM, DIST_LM_DEPTH, dict(style="vic", reg="sum", q=2, block_size=DIST_BLOCK))
    data = LMDataConfig(vocab_size=cfg.vocab_size, batch=LMTRAIN_BATCH, seq_len=LMTRAIN_SEQ, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in lm_batch(data, s).items()} for s in range(DIST_LM_STEPS)]
    sched = warmup_cosine(LMTRAIN_LR, 1, DIST_LM_STEPS)
    fwd_total, bwd_total, base = {}, {}, None
    for tag in ("unmeshed", "mesh", "mesh grad_shardings"):
        opt = adamw()
        state = create_train_state(ParamTree(init_params(cfg, seed=SEED, device=dev)), opt, seed=SEED)
        kw = {} if tag == "unmeshed" else dict(mesh=mesh)
        if tag.endswith("grad_shardings"):
            kw["grad_shardings"] = [("data",) + (None,) * (p.dim() - 1) for p in state.model.parameters()]
        step = make_train_step(cfg, opt, sched, num_microbatches=DIST_LM_MICRO, **kw)
        kernels.reset_launch_counts()
        metrics, ms = _lmtrain_steps(state, step, batches)
        fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
        losses = [m["loss"] for m in metrics]
        params = [p.detach().clone() for p in state.model.parameters()]
        del state, step, opt
        _free()
        if base is None:
            base = (losses, params)
            what = ""
        else:
            loss_rel = _max_rel(losses, base[0])
            param_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(params, base[1]))
            same = all(torch.equal(a, b) for a, b in zip(params, base[1]))
            ph.check(loss_rel <= LOSS_TOL and param_rel <= LOSS_TOL,
                     f"[dist] lm step {tag}: loss rel err {loss_rel:.3g}, param rel err {param_rel:.3g} > {LOSS_TOL}")
            for name in ("pmatmul", "freq_outer"):
                ph.check(fwd[name] > 0, f"[dist] lm step {tag}: {name} never launched")
            for name in ("pmatmul", "freq_mat"):
                ph.check(bwd[name] > 0, f"[dist] lm step {tag}: {name} never launched on the backward pass")
            fallbacks = metrics[-1].get("grad_shard_fallbacks")
            what = (f" vs unmeshed: max loss_rel_err={loss_rel:.3g} max param_rel_err={param_rel:.3g} "
                    f"params bit-identical={same}" + ("" if fallbacks is None else f" grad_shard_fallbacks={fallbacks:.0f}"))
            for k, v in fwd.items():
                fwd_total[k] = fwd_total.get(k, 0) + v
            for k, v in bwd.items():
                bwd_total[k] = bwd_total.get(k, 0) + v
        print(f"[dist] lm step {tag}: {DIST_LM} full width, {DIST_LM_DEPTH} layers, batch {LMTRAIN_BATCH}x{LMTRAIN_SEQ} "
              f"in {DIST_LM_MICRO} microbatches, aux r_sum b={DIST_BLOCK}, {DIST_LM_STEPS} steps: "
              f"loss={['%.7g' % x for x in losses]} median step ms={statistics.median(ms):.3f}{what} | "
              f"launches fwd {_nonzero(fwd)} bwd {_nonzero(bwd)}", flush=True)
    del base
    _free()
    return fwd_total, bwd_total


def _dist_prefetch(ph: Phase, dev, mesh, batches, direct):
    """(7) Arm (a) sharded in ``global``, fed by ``ShardedPrefetcher`` from
    host batches (pinned copies on a side stream, this rank's block cut by
    the batch's ``NamedSharding``): its losses equal the directly fed run's."""
    import torch

    from repro_torch.data import ShardedPrefetcher
    from repro_torch.parallel import sharding as shd

    with shd.sharding_context(mesh):
        rows = shd.named_sharding(("batch", None))
    host = [{k: v.cpu() for k, v in b.items()} for b in batches]
    state, step, _ = _sharded_arm_a(dev, mesh, "global")
    it = ShardedPrefetcher(iter(host), sharding=rows, depth=2, device=dev)
    losses = []
    t0 = time.perf_counter()
    for batch in it:
        state, metrics = step(state, batch)
        losses.append(metrics["bt_loss"])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    losses = torch.stack(losses).cpu().tolist()
    same = losses == direct
    ph.check(same and len(losses) == len(direct),
             f"[dist] prefetched arm (a): {len(losses)} losses, max diff {max(abs(a - b) for a, b in zip(losses, direct)):.3g}")
    print(f"[dist] arm (a) global fed by ShardedPrefetcher: {len(losses)} losses equal the direct run's={same} "
          f"loss[-1]={losses[-1]:.6g} wall ms={wall_ms:.3f} ({wall_ms / len(losses):.3f} a step)", flush=True)


def _dist_elastic(ph: Phase, dev, mesh, tp_run, batches):
    """(8) The ``tp`` run's state, checkpointed (the full tree), restored by
    ``elastic_restore`` onto the 1 x 1 mesh as a ``global`` state: the
    parameters equal, and so does one more step's loss."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.ft.elastic import elastic_restore
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.train.ssl import shard_ssl_batch, ssl_param_specs

    _, tp_state, tp_step = tp_run
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        tree = tp_state.state_dict()
        save_checkpoint(tmp, tp_state.step, tree)
        state, step, _ = _sharded_arm_a(dev, mesh, "global")
        loss_kw, _ = ARMS["a bt r_sum b=128 q=2"]
        model_cfg, _ = _paper()
        specs = ssl_param_specs(model_cfg, DecorrConfig(**loss_kw, distributed="global"), mesh)
        restored = elastic_restore(tmp, tp_state.step, state.state_dict(), mesh,
                                   spec_fn=lambda path, leaf: specs.get(path[-1]) if path[0] == "params" else None)
        state.load_state_dict(restored)
        same = all(torch.equal(state.model.state_dict()[k], v) for k, v in tree["params"].items())
        ph.check(same and state.step == tp_state.step, "[dist] elastic restore: parameters or step differ from the tp run's")
        batch = shard_ssl_batch(batches[0], mesh)
        a = float(tp_step(tp_state, batch)[1]["bt_loss"])
        b = float(step(state, batch)[1]["bt_loss"])
        ph.check(a == b, f"[dist] elastic restore: one more step's loss {b!r} vs the tp run's {a!r}")
        print(f"[dist] tp checkpoint at step {tree['step']} restored by elastic_restore onto a 1 x 1 global mesh: "
              f"params equal={same}; one more step: loss tp={a!r} restored={b!r} equal={a == b}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dist_compressed(ph: Phase, dev, meshes, batches):
    """``make_compressed_dp_step`` on arm (a)'s model and batches, none /
    bf16 / int8_ef, DIST_DP_STEPS steps: ``none``'s losses equal
    ``make_ssl_train_step``'s within 5e-4; the reduced step-0 gradients of
    bf16 and int8_ef within 0.01 / 0.05 relative (the reference test's
    bounds) of ``none``'s.  NCCL takes the f32, bf16, int32 and MAX
    all-reduces."""
    import torch

    from repro_torch.core.permutation import permutation_for_step
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.optim import compression, lars, warmup_cosine
    from repro_torch.train import create_train_state
    from repro_torch.train.ssl import init_ssl_model, make_ssl_train_step
    from repro_torch.train.step import make_compressed_dp_step

    loss_kw, _ = ARMS["a bt r_sum b=128 q=2"]
    model_cfg, _ = _paper()
    sched = warmup_cosine(TRAIN_LR, 2, TRAIN_STEPS)
    want = _train_route(dev, loss_kw, None, batches[:DIST_DP_STEPS])[1]
    d = model_cfg.projector_widths[-1]
    perm_fn = lambda s: permutation_for_step(SEED, s, d)  # noqa: E731
    first = {}
    for kind, bound in (("none", None), ("bf16", 0.01), ("int8_ef", 0.05)):
        opt = lars(weight_decay=1e-4)
        state = create_train_state(init_ssl_model(model_cfg, seed=SEED, device=dev), opt, seed=SEED)
        _, loss_fn = make_ssl_train_step(model_cfg, DecorrConfig(**loss_kw), opt, sched)
        step = make_compressed_dp_step(loss_fn, opt, sched, "data", kind, mesh=meshes["global"], perm_fn=perm_fn)
        update = state.opt_state.step

        def spy(lr, grads=None, kind=kind):
            first.setdefault(kind, [g.clone() for g in grads])
            return update(lr, grads)

        state.opt_state.step = spy
        ef = compression.init_error_feedback(list(state.model.parameters()))
        losses = []
        for batch in batches[:DIST_DP_STEPS]:
            state, metrics, ef = step(state, batch, ef)
            losses.append(metrics["bt_loss"])
        losses = torch.stack(losses).cpu().tolist()
        if bound is None:
            rel = _max_rel(losses, want)
            ph.check(rel <= LOSS_TOL, f"[dist] compressed none: loss rel err {rel:.3g} vs make_ssl_train_step > {LOSS_TOL}")
            what = f"max loss_rel_err vs make_ssl_train_step={rel:.3g}"
        else:
            num = torch.sqrt(sum(torch.sum((g - w) ** 2) for g, w in zip(first[kind], first["none"])))
            rel = float(num / torch.sqrt(sum(torch.sum(w**2) for w in first["none"])))
            ph.check(rel <= bound, f"[dist] compressed {kind}: step-0 gradient rel err {rel:.3g} > {bound}")
            what = f"step-0 reduced gradient rel err vs none={rel:.3g} (bound {bound})"
        print(f"[dist] make_compressed_dp_step {kind}, {DIST_DP_STEPS} steps: {what} loss[-1]={losses[-1]:.6g}", flush=True)


def phase_dist(ph: Phase, dev):
    """Distributed training and serving on one NCCL rank (a group of one
    through a ``FileStore``): the regularizer, the sharded SSL step and the
    compressed data-parallel step, each against its single-device twin;
    then the meshed ServeEngine, the global / tp probes, the data-parallel
    LM step, the prefetched SSL run and the elastic restore.  Returns the
    meshed paths' ({kernel: launches}, {kernel: backward launches})."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for_devices

    import torch

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    torch.cuda.set_device(dev.index or 0)  # the rank's device, before NCCL and the mesh start
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh_for_devices(1, 1)
        meshes = {"local": None, "global": mesh, "tp": mesh}
        _dist_regularizer(ph, dev, meshes)
        batches = _train_batches(dev, TRAIN_STEPS)
        fwd, bwd, runs = _dist_steps(ph, dev, meshes, batches)
        _dist_compressed(ph, dev, meshes, batches)
        rows = _dist_serve(ph, dev, mesh)
        parts = [_dist_probe(ph, dev, mesh, rows)]
        lm_fwd, lm_bwd = _dist_lmtrain(ph, dev, mesh)
        parts.append(lm_fwd)
        _dist_prefetch(ph, dev, mesh, batches, runs["global"][0])
        _dist_elastic(ph, dev, mesh, runs["tp"], batches)
        for part in parts:
            for k, v in part.items():
                fwd[k] = fwd.get(k, 0) + v
        for k, v in lm_bwd.items():
            bwd[k] = bwd.get(k, 0) + v
        return fwd, bwd
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase obs: telemetry on the serve and train paths
# ---------------------------------------------------------------------------


def _obs_serve(ph: Phase, dev):
    """(a) ``EmbeddingService`` with an enabled ``Obs`` at the ssl-paper
    width, probe b = 128, 512 requests: one ``encode`` span and one
    ``serve_encode_seconds`` observation a dispatch, a queue and a dispatch
    span a request, an ``ExecTimer`` first-call gauge for every bucket and
    rows whose calls sum to the dispatches, and a scrape of
    ``127.0.0.1:0/metrics`` that lists every series of ``metrics()``.  Then
    req/s with telemetry on and off (fresh warmed services, same load).
    Returns the runs' launches."""
    import urllib.request

    from repro_torch import kernels
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.obs import Obs
    from repro_torch.obs.registry import sanitize_name
    from repro_torch.serve.buckets import bucket_sizes
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.loadgen import LoadConfig, run_microbatched
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.service import EmbeddingService
    from repro_torch.train.ssl import init_ssl_model

    model_cfg, policy = _paper()
    cfg = DecorrConfig(style="vic", reg="sum", q=2, block_size=128)
    load = LoadConfig(n_requests=N_REQUESTS, input_dim=model_cfg.input_dim, seed=SEED + 3)
    rps, totals = {}, {}
    for tag in ("on", "off", "on ", "off "):
        obs = Obs() if tag.strip() == "on" else Obs.disabled()
        engine = ServeEngine(model_cfg, init_ssl_model(model_cfg, seed=SEED), policy=policy, device=dev)
        service = EmbeddingService(engine, policy=policy, probe=DecorrProbe(cfg, perm_seed=SEED, device=dev), obs=obs)
        service.warmup().start()
        kernels.reset_launch_counts()
        try:
            summary = run_microbatched(service, load)
            metrics = service.metrics()
        finally:
            service.stop()
        for k, v in kernels.launch_counts().items():
            totals[k] = totals.get(k, 0) + v
        rps.setdefault(tag.strip(), []).append(summary["throughput_rps"])
        if tag != "on":
            continue
        dispatches = service.stats.batches
        events = obs.tracer.to_chrome()["traceEvents"]
        spans = {n: sum(1 for e in events if e["name"] == n) for n in ("encode", "queue", "dispatch", "retire")}
        ph.check(spans["encode"] == dispatches, f"[obs] serve: {spans['encode']} encode spans for {dispatches} dispatches")
        ph.check(spans["queue"] == spans["dispatch"] == spans["retire"] == N_REQUESTS,
                 f"[obs] serve: request spans {spans} for {N_REQUESTS} requests")
        h = obs.registry.get("serve_encode_seconds")
        ph.check(h.count == dispatches, f"[obs] serve: serve_encode_seconds count {h.count} != {dispatches} dispatches")
        rows = {r["executable"]: r for r in obs.perf.snapshot()}
        warmed = [obs.registry.value("exec_compile_seconds", {"executable": f"embed_b{b}"}) for b in bucket_sizes(policy)]
        ph.check(all(v is not None and v > 0 for v in warmed), "[obs] serve: a bucket has no first-call gauge")
        embed_calls = sum(r["calls"] for n, r in rows.items() if n.startswith("embed_b"))
        ph.check(embed_calls == dispatches, f"[obs] serve: ExecTimer embed calls {embed_calls} != {dispatches} dispatches")
        ph.check(rows.get("probe_update", {}).get("calls") == metrics["decorr_probe_steps"],
                 "[obs] serve: probe_update calls != probe steps")
        server = obs.start_server(port=0, metrics_fn=service.metrics)
        try:
            text = urllib.request.urlopen(f"{server.url}/metrics", timeout=10).read().decode()
        finally:
            server.stop()
        exposed = {ln.split("{")[0].split(" ")[0] for ln in text.splitlines() if ln and not ln.startswith("#")}
        missing = [k for k in metrics if sanitize_name(k) not in exposed
                   and not (sanitize_name(k).startswith("heartbeat_age_s_") and "heartbeat_age_s" in exposed)]
        ph.check(not missing, f"[obs] serve: scrape lacks {missing[:8]}")
        top = ", ".join(f"{r['executable']} {r['calls']}x best {r['best_s'] * 1e3:.4f}ms" for r in obs.perf.snapshot(top_k=4))
        print(f"[obs] (a) EmbeddingService, {N_REQUESTS} requests, {dispatches} dispatches: encode spans={spans['encode']} "
              f"request spans queue/dispatch/retire={spans['queue']}/{spans['dispatch']}/{spans['retire']} "
              f"serve_encode_seconds count={h.count} buckets with a first-call gauge={len(warmed)} | scrape "
              f"{len(text.splitlines())} lines, {len(exposed)} series, metrics() keys missing={len(missing)} | "
              f"ExecTimer: {top}", flush=True)
    print(f"[obs] (a) EmbeddingService req/s, telemetry on: {rps['on']} off: {rps['off']} (order on, off, on, off)",
          flush=True)
    return totals


def _obs_train(ph: Phase, dev):
    """(b) ``run_training`` of train arm (a), 20 steps, with a registry, a
    health monitor (log interval 10) and an ExecTimer, then without them:
    ``train_steps_total`` = 20, ``train_step`` timed 20 times, and the
    monitor's gauges at its last update against ``probe_metrics``'s plain
    route on the same rows within 5e-4; step ms with and without the hooks."""
    import torch

    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.decorr.probe import probe_metrics
    from repro_torch.obs import DecorrHealthMonitor, ExecTimer, MetricsRegistry
    from repro_torch.train.loop import LoopConfig, run_training

    loss_kw, _ = ARMS["a bt r_sum b=128 q=2"]
    batches = _train_batches(dev, TRAIN_STEPS)
    pcfg = DecorrConfig(style="vic", reg="sum", q=2, block_size=128)
    ms = {}
    for tag in ("hooks", "none", "hooks ", "none "):
        state, step, _ = _train_setup(dev, loss_kw, None)
        kw = {}
        if tag.strip() == "hooks":
            reg = MetricsRegistry()
            monitor = DecorrHealthMonitor(lambda model, batch: model(batch["view1"]), cfg=pcfg, ema=0.0, device=dev)
            kw = dict(registry=reg, monitor=monitor, perf=ExecTimer(reg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_training(state, step, lambda s: batches[s], LoopConfig(total_steps=TRAIN_STEPS, log_interval=10), **kw)
        torch.cuda.synchronize()
        ms.setdefault(tag.strip(), []).append((time.perf_counter() - t0) * 1e3 / TRAIN_STEPS)
        if tag != "hooks":
            continue
        ph.check(reg.value("train_steps_total") == TRAIN_STEPS, "[obs] train: train_steps_total != 20")
        (row,) = [r for r in kw["perf"].snapshot() if r["executable"] == "train_step"]
        ph.check(row["calls"] == TRAIN_STEPS, f"[obs] train: train_step timed {row['calls']} times")
        got = monitor.metrics()
        with torch.no_grad():
            z = state.model(batches[TRAIN_STEPS - 1]["view1"])
        perm = monitor.probe.permutation(monitor.probe.steps - 1, z.shape[1])
        want = probe_metrics(z, None, pcfg, perm, impl="plain")
        worst = max(abs(got[f"train_decorr_{k}"] - float(v)) / max(abs(float(v)), 1e-12) for k, v in want.items())
        ph.check(worst <= PROBE_TOL, f"[obs] train: monitor gauges vs the plain probe rel err {worst:.3g} > {PROBE_TOL}")
        kernel = probe_metrics(z, None, pcfg, perm)
        vs_kernel = max(abs(got[f"train_decorr_{k}"] - float(v)) / max(abs(float(v)), 1e-12) for k, v in kernel.items())
        print(f"[obs] (b) run_training arm a, {TRAIN_STEPS} steps with registry / monitor / perf: train_steps_total="
              f"{reg.value('train_steps_total'):.0f} train_step calls={row['calls']} monitor updates={monitor.updates} "
              f"gauges vs plain probe worst rel err={worst:.3g} (vs the kernel route {vs_kernel:.3g}) relaxation_gap={got.get('train_decorr_relaxation_gap_ema')} "
              f"param_norm={reg.value('train_param_norm'):.6g}", flush=True)
    print(f"[obs] (b) train step ms (loop wall / steps) with hooks: {ms['hooks']} without: {ms['none']} "
          "(order hooks, none, hooks, none)", flush=True)


def _obs_profile(ph: Phase, dev):
    """(d) A ``Profiler`` start / stop around a b = 128 probe update on the
    card: the Chrome trace it writes names the port's kernels."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.permutation import permutation_for_step
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.decorr.probe import probe_metrics
    from repro_torch.obs import Profiler

    z = torch.randn(256, 2048, generator=torch.Generator().manual_seed(SEED)).to(dev)
    perm = permutation_for_step(SEED, 0, 2048).to(dev)
    cfg = DecorrConfig(style="vic", reg="sum", q=2, block_size=128)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        prof = Profiler(tmp)
        started = prof.start()
        probe_metrics(z, None, cfg, perm)
        torch.cuda.synchronize()
        path = prof.stop()
        text = open(path).read() if path else ""
        named = sorted({sym for sym in _OWNER if sym in text})
        ph.check(started and bool(named), f"[obs] profiler: trace {path} names none of the port's kernels")
        print(f"[obs] (d) Profiler start={started} stop -> {os.path.basename(path or 'None')} "
              f"({len(text)} bytes) names {named}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_obs(ph: Phase, dev):
    """Telemetry: (a) the embedding service, (b) the train loop's hooks,
    (d) the profiler; (c), the LM service, runs in phase lm on its bf16
    model.  Returns the launches."""
    totals = _obs_serve(ph, dev)
    _obs_train(ph, dev)
    _obs_profile(ph, dev)
    return totals


# ---------------------------------------------------------------------------
# phase 5: paged continuous-batching LM serving of gemma2-2b at full width
# ---------------------------------------------------------------------------


def _lm_model(dev, dtype, depth=None):
    """gemma2-2b at its published width and depth (or ``depth`` layers) in
    ``dtype``, random weights from ``init_params(seed=0)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("gemma2-2b")
    cfg = dataclasses.replace(cfg, n_layers=depth or cfg.n_layers, param_dtype=dtype, compute_dtype=dtype)
    return cfg, init_params(cfg, seed=SEED, device=dev)


class _CheckedSteps:
    """Stands in for ``engine.step_logits``: every decode tick runs first on
    the plain (gather) route from a clone of the pool, then on the engine's
    own route on the pool itself.  Records the worst logit difference over
    the live lanes and, per (request, token index), the plain route's top-2
    logit gap and both routes' argmax.  The plain re-runs launch no kernel."""

    def __init__(self, engine):
        self.engine = engine
        self.orig = engine.step_logits
        self.req_index = {}
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.ticks = 0
        self.steps = {}
        engine.step_logits = self

    def __call__(self, caches, lens, toks, block_tables, impl=None):
        import torch

        clone = {name: {k: v.clone() for k, v in leafs.items()} for name, leafs in caches.items()}
        p_logits = self.orig(clone, lens, toks, block_tables, "plain")[0]
        del clone
        logits, hidden, caches = self.orig(caches, lens, toks, block_tables, impl)
        pool = self.engine.pool
        active = pool.active_indices()
        idx = torch.tensor(active, device=logits.device)
        kl, pl = logits[idx], p_logits[idx]
        diff = float((kl - pl).abs().max())
        self.max_abs = max(self.max_abs, diff)
        self.max_rel = max(self.max_rel, diff / max(1.0, float(pl.abs().max())))
        top2 = torch.topk(pl, 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        pa, ka = pl.argmax(-1).tolist(), kl.argmax(-1).tolist()
        for j, i in enumerate(active):
            slot = pool[i]
            self.steps[(self.req_index[id(slot.future)], len(slot.emitted))] = (gaps[j], pa[j], ka[j])
        self.ticks += 1
        return logits, hidden, caches


def _lm_service(cfg, params, dev, n_slots, max_len, max_prompt, probe=False, record=False, obs=None, **engine_kw):
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.service import LMService

    engine = ContinuousLMEngine(cfg, params, n_slots=n_slots, max_len=max_len, max_prompt_len=max_prompt,
                                 device=dev, **engine_kw)
    pr = DecorrProbe(DecorrConfig(style="vic", reg="sum", q=2), perm_seed=SEED, device=dev) if probe else None
    return LMService(engine, probe=pr, record_probe_rows=record, obs=obs).warmup()


def _lm_drive(service, stream, checked=None):
    """Submit the whole stream, drain it; returns (outputs, wall s, futures)."""
    import torch

    futs = [service.submit(t, m) for t, m in stream]
    if checked is not None:
        checked.req_index = {id(f): i for i, f in enumerate(futs)}
    t0 = time.perf_counter()
    service.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [f.result(timeout=60) for f in futs], wall, futs


def _attn_layers(cfg) -> int:
    """The layers of ``cfg`` that attend: paged_attention's launches a tick."""
    return sum(spec.mixer == "attn" for spec in cfg.pattern) * cfg.repeats


class _DecodeDrops:
    """While active, counts the MoE layer calls of decode ticks (``n_slots``
    lanes of one token) whose top-k picks overfill an expert's seats.  Such
    a tick drops picks, and the free lanes take seats too: the dense
    and the paged pool feed the router different free-lane rows, so the
    reference's own dense and paged tokens may then differ
    (``tests/test_torch_archs.py``, jamba at eight slots)."""

    def __init__(self, n_slots):
        self.n_slots, self.calls = n_slots, 0

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.orig = moe.moe_apply

        def counted(params, x, cfg):
            if x.shape[:2] == (self.n_slots, 1):
                probs = torch.softmax(x[:, 0].float() @ params["router"].float(), dim=-1)
                picks = torch.bincount(moe._top_k(probs, cfg.top_k)[1].flatten(), minlength=cfg.n_experts)
                self.calls += int(picks.max()) > moe._capacity(self.n_slots, cfg)
            return self.orig(params, x, cfg)

        moe.moe_apply = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_apply = self.orig


def _lm_checked_run(ph, tag, cfg, params, dev, stream, n_slots, max_len, max_prompt, **engine_kw):
    """Checks (a)-(c) of one f32 workload (``tag`` heads the printed lines);
    returns the kernel run's launch counts."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serve.loadgen import lm_probe_oracle_err

    shape = dict(n_slots=n_slots, max_len=max_len, max_prompt=max_prompt)
    # (a) the dense engine vs the paged engine on the plain route, bit for bit
    # unless a decode tick overfilled a MoE expert's seats (see _DecodeDrops)
    with _DecodeDrops(n_slots) as drops:
        dense, _, _ = _lm_drive(_lm_service(cfg, params, dev, **shape), stream)
        plain_svc = _lm_service(cfg, params, dev, paged=True, page_size=LM_PAGE, impl="plain", **shape, **engine_kw)
        plain, _, _ = _lm_drive(plain_svc, stream)
    bad = [i for i, (a, b) in enumerate(zip(dense, plain)) if not np.array_equal(a, b)]
    ph.check(not bad or drops.calls > 0,
             f"{tag}: (a) paged plain-route tokens differ from the dense engine's in requests {bad}")
    note = (f"; MoE layer calls of decode ticks that overfilled an expert's seats in the two runs: {drops.calls}"
           + (" (requests may differ: the reference's own dense and paged pools route different free-lane rows)"
              if drops.calls else "")) if cfg.n_experts else ""
    print(f"{tag}: (a) paged plain route == dense engine, bit for bit, in {len(stream) - len(bad)}/{len(stream)} "
          f"requests ({sum(len(o) for o in plain)} tokens){note}", flush=True)
    del plain_svc

    # (b) + (c) the kernel route, each tick checked against the plain route
    svc = _lm_service(cfg, params, dev, probe=True, record=True, paged=True, page_size=LM_PAGE, **shape, **engine_kw)
    checked = _CheckedSteps(svc.engine)
    kernels.reset_launch_counts()
    kern, wall, _ = _lm_drive(svc, stream, checked)
    counts = kernels.launch_counts()
    ticks = svc.engine.pool.steps
    ph.check(checked.max_rel <= LOGIT_TOL,
             f"{tag}: (b) kernel vs plain logits rel {checked.max_rel:.3g} > {LOGIT_TOL}")
    n_attn = _attn_layers(cfg)
    ph.check(counts["paged_attention"] > 0 and counts["paged_attention"] == n_attn * ticks,
             f"{tag}: paged_attention launched {counts['paged_attention']} times in {ticks} ticks "
             f"(expected {n_attn} per tick)")
    for name in LM_PROBE_KERNELS:
        ph.check(counts[name] > 0, f"{tag}: the probe never launched {name} in the kernel-route run")
    exempt = differ = 0
    for r, (k, p) in enumerate(zip(kern, plain)):
        if np.array_equal(k, p):
            continue
        differ += 1
        n = min(len(k), len(p))
        t = int(np.argmax(k[:n] != p[:n])) if np.any(k[:n] != p[:n]) else n
        gap = checked.steps.get((r, t), (None,))[0]
        ok = gap is not None and gap < 2 * checked.max_abs
        exempt += ok
        print(f"{tag}: (c) request {r} first differs at token {t}: plain top-2 gap "
              f"{'n/a' if gap is None else f'{gap:.4g}'} vs 2 x logit diff {2 * checked.max_abs:.4g} "
              f"-> {'exempt from here on' if ok else 'FAIL'}", flush=True)
        ph.check(ok, f"{tag}: (c) request {r} differs at token {t} with plain top-2 gap {gap}")
    m = svc.metrics()
    err = lm_probe_oracle_err(svc)
    ph.check(err is not None and err < LM_PROBE_TOL, f"{tag}: probe vs oracle {err} (limit {LM_PROBE_TOL})")
    ph.check(m["dispatch_errors"] == 0, f"{tag}: dispatch_errors={m['dispatch_errors']}")
    ph.check(all(np.isfinite(v) for k, v in m.items() if k.startswith("decorr_")), f"{tag}: probe not finite")
    print(f"{tag}: (b) {checked.ticks} ticks, kernel vs plain logits max_abs={checked.max_abs:.4g} "
          f"rel={checked.max_rel:.4g}; (c) {len(stream) - differ}/{len(stream)} requests' tokens identical, "
          f"{exempt} exempt; paged_attention launches={counts['paged_attention']} over {ticks} ticks "
          f"({counts['paged_attention'] / max(ticks, 1):.1f}/tick); probe launches "
          + ", ".join(f"{k}={counts[k]}" for k in LM_PROBE_KERNELS) + f"; probe_steps={m.get('decorr_probe_steps', 0):.0f} "
          f"probe_oracle_rel_err={err}; dispatch_errors={m['dispatch_errors']:.0f}; "
          f"peak pages={m['paged_pages_peak']:.0f} of {m['paged_pages_total']:.0f}; wall_s={wall:.3f}", flush=True)
    return counts


def _timed(times, key, fn, sync=False):
    """``fn`` that appends its host ms to ``times[key]`` (``sync``: a device
    sync before and after; without it the caller's step must end in one)."""
    import torch

    def run(*a, **k):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if sync:
            torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3)
        return out

    return run


def _lm_timed(ph, cfg, params, dev, stream, max_len, max_prompt):
    """The config's own dtype on the kernel route: tok/s, TTFT, decode tick
    and prefill ms; then a profiled window of ticks and the kernel-vs-plain
    logit difference on a live pool (reported, not gated).  Returns the
    run's launch counts (the main path's)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch import kernels

    svc = _lm_service(cfg, params, dev, n_slots=LM_SLOTS, max_len=max_len, max_prompt=max_prompt,
                      probe=True, paged=True, page_size=LM_PAGE)
    eng = svc.engine
    times = {"decode": [], "insert": []}
    # both end in a host sync (token ids to the host)
    eng.decode_step, eng.insert = _timed(times, "decode", eng.decode_step), _timed(times, "insert", eng.insert)
    kernels.reset_launch_counts()
    outs, wall, futs = _lm_drive(svc, stream)
    counts = kernels.launch_counts()
    ticks = eng.pool.steps
    m = svc.metrics()
    ttft = np.asarray([f.ttft_s for f in futs]) * 1e3
    n_tok = sum(len(o) for o in outs)
    ph.check(counts["paged_attention"] == cfg.n_layers * ticks > 0,
             f"[lm] bf16: paged_attention launched {counts['paged_attention']} times in {ticks} ticks")
    for name in LM_PROBE_KERNELS:
        ph.check(counts[name] > 0, f"[lm] bf16: the probe never launched {name}")
    ph.check(m["dispatch_errors"] == 0, f"[lm] bf16: dispatch_errors={m['dispatch_errors']}")
    ph.check(all(o.shape == (mn,) for o, (_, mn) in zip(outs, stream)), "[lm] bf16: wrong output lengths")
    print(f"[lm] bf16 timed: {len(stream)} requests {n_tok} tokens wall_s={wall:.4f} tok_per_s={n_tok / wall:.1f} "
          f"ttft_p50_ms={np.percentile(ttft, 50):.3f} ttft_p99_ms={np.percentile(ttft, 99):.3f} "
          f"decode_tick_ms median={statistics.median(times['decode']):.3f} mean={statistics.mean(times['decode']):.3f} "
          f"({ticks} ticks, occupancy {m['slots_occupancy']:.3f}) prefill_ms median={statistics.median(times['insert']):.3f} "
          f"mean={statistics.mean(times['insert']):.3f} | launches {dict((k, v) for k, v in counts.items() if v)}",
          flush=True)

    # a full pool, then LM_PROFILE_TICKS ticks under the profiler
    rng = np.random.default_rng(SEED + 3)
    for _ in range(LM_SLOTS):
        svc.submit(rng.integers(0, cfg.vocab_size, 24).astype(np.int32), LM_PROFILE_TICKS + 6)
    svc.step()
    wall_box = [0.0]

    def window():
        t0 = time.perf_counter()
        for _ in range(LM_PROFILE_TICKS):
            svc.step()
        torch.cuda.synchronize()
        wall_box[0] = time.perf_counter() - t0

    kernels.reset_launch_counts()
    events = _device_events(window)
    window_counts = kernels.launch_counts()
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = wall_box[0] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ported = _ported_ms(ph, events, window_counts, ("paged_attention",) + LM_PROBE_KERNELS, "lm bf16")
    ph.check(ported["paged_attention"][0] > 0, "[profile] lm bf16: no device time of paged_attention")
    print(f"[profile] lm bf16: {LM_PROFILE_TICKS} decode ticks, 8 live slots, wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.4f} idle_share={1 - busy_ms / wall_ms:.4f} device events={len(events)} | "
          + " ".join(f"{k} ms={ms:.4f} ({n} device launches, {window_counts[k]} wrapper launches)"
                     for k, (ms, n) in ported.items())
          + " | top: " + "; ".join(f"{n[:60]}={us / 1e3:.4f}ms" for n, us in top),
          flush=True)

    # kernel vs plain on the live pool, a few ticks (reported, not gated)
    worst = 0.0
    for _ in range(3):
        lens = torch.as_tensor(eng.pool.cache_lens(), device=dev)
        toks = torch.as_tensor(eng.pool.last_tokens(), device=dev)
        bt = torch.as_tensor(eng.pager.block_tables(), device=dev)
        got = {}
        for impl in (None, "plain"):
            clone = {n: {k: v.clone() for k, v in leafs.items()} for n, leafs in eng.caches.items()}
            got[impl] = eng.step_logits(clone, lens, toks, bt, impl)[0]
        worst = max(worst, float((got[None] - got["plain"]).abs().max()) / max(1.0, float(got["plain"].abs().max())))
        svc.step()
    print(f"[lm] bf16: kernel vs plain logits rel diff over 3 live ticks = {worst:.4g} (reported, not gated)", flush=True)
    svc.drain()
    return counts


# -- phase 5 (d)-(h): chunked prefill, sampling, prefix cache, speculation,
# the long-prompt prefill ----------------------------------------------------


class _LogitLog:
    """Keeps, on the card, the logits row behind every token a service
    emits, keyed by (request, token index): the first token's from the
    prefill (``insert`` / ``advance_prefill``), the others' from each decode
    tick or verify.  Lane j of a verify predicts token len(emitted) + j; a
    rejected lane's token is logged again by the tick that emits it.  Runs
    with ``impl="plain"`` (a checker's re-runs on a cloned pool) are not
    logged, unless ``log_plain`` (an engine that runs the plain route
    itself)."""

    def __init__(self, engine, log_plain=False):
        self.engine = engine
        self.log_plain = log_plain
        self.rows = {}
        self.req_index = {}
        self.cur = None
        self._step, self._first = engine.step_logits, engine._first_output
        self._insert, self._advance = engine.insert, engine.advance_prefill
        engine.step_logits, engine._first_output = self.step, self.first
        engine.insert = lambda slot: self._with(slot, self._insert)
        engine.advance_prefill = lambda slot: self._with(slot, self._advance)

    def _with(self, slot, fn):
        self.cur = slot
        try:
            return fn(slot)
        finally:
            self.cur = None

    def first(self, logits, hidden):
        self.rows[(self.req_index[id(self.cur.future)], 0)] = logits[0].detach().clone()
        return self._first(logits, hidden)

    def step(self, caches, lens, toks, block_tables, impl=None):
        out = self._step(caches, lens, toks, block_tables, impl)
        if impl != "plain" or self.log_plain:
            pool = self.engine.pool
            width = lens.shape[0] // pool.n_slots
            live = block_tables.any(dim=1).tolist()
            for i in pool.decoding_indices():
                slot = pool[i]
                for j in range(width):
                    if j and not live[i * width + j]:
                        break
                    self.rows[(self.req_index[id(slot.future)], len(slot.emitted) + j)] = out[0][i * width + j].clone()
        return out


def _gap_rule(ph, tag, base_outs, outs, base_log, log):
    """Hold ``outs`` against ``base_outs`` token by token: a request may
    first differ only at a token whose ``base`` top-2 logit gap is below
    twice the measured logit difference (the largest |difference| of the two
    runs' logits over every token up to each request's first difference).
    Returns (logit difference, requests that differ)."""
    import numpy as np
    import torch

    first = {}
    for r, (a, b) in enumerate(zip(base_outs, outs)):
        ph.check(len(a) == len(b), f"{tag}: request {r} emitted {len(b)} tokens, the baseline {len(a)}")
        n = min(len(a), len(b))
        d = np.nonzero(a[:n] != b[:n])[0]
        first[r] = int(d[0]) if d.size else n
    keys = [k for k in base_log.rows if k in log.rows and k[1] <= first[k[0]]]
    diff = max(float((base_log.rows[k] - log.rows[k]).abs().max()) for k in keys)
    differ = 0
    for r, t in first.items():
        if t >= len(base_outs[r]):
            continue
        differ += 1
        top2 = torch.topk(base_log.rows[(r, t)].float(), 2).values
        gap = float(top2[0] - top2[1])
        ok = gap < 2 * diff
        print(f"{tag}: request {r} first differs at token {t}: baseline top-2 gap {gap:.4g} vs 2 x logit diff "
              f"{2 * diff:.4g} -> {'exempt from here on' if ok else 'FAIL'}", flush=True)
        ph.check(ok, f"{tag}: request {r} differs at token {t} with baseline top-2 gap {gap}")
    return diff, differ


def _drive_logged(svc, stream):
    """``_lm_drive`` with a ``_LogitLog`` on the service's engine."""
    log = _LogitLog(svc.engine)
    outs, wall, futs = _lm_drive(svc, stream, log)
    return outs, wall, futs, log


def _lm_chunked(ph, cfg, params, dev):
    """(d) chunked serving prefill, 512 tokens a tick, against the
    unchunked paged engine on the same mix, both on the kernel route."""
    from repro_torch import kernels
    from repro_torch.serve.loadgen import LMLoadConfig

    load = LMLoadConfig(**CHUNK_MIX)
    stream = load.request_stream(cfg.vocab_size)
    shape = dict(n_slots=LM_SLOTS, max_len=CHUNK_MAX_LEN, max_prompt=max(load.prompt_lens), paged=True,
                 page_size=LM_PAGE)
    base, _, _, base_log = _drive_logged(_lm_service(cfg, params, dev, **shape), stream)
    svc = _lm_service(cfg, params, dev, prefill_chunk=CHUNK_PREFILL, **shape)
    eng = svc.engine
    counts = {"chunks": 0, "ticks": 0, "interleaved": 0}
    advance, decode = eng.advance_prefill, eng.decode_step

    def counted_advance(slot):
        counts["chunks"] += 1
        return advance(slot)

    def counted_decode():
        counts["ticks"] += 1
        counts["interleaved"] += any(s.prefilling for s in eng.pool.active())
        return decode()

    eng.advance_prefill, eng.decode_step = counted_advance, counted_decode
    kernels.reset_launch_counts()
    outs, wall, _, log = _drive_logged(svc, stream)
    launches = kernels.launch_counts()
    diff, differ = _gap_rule(ph, "[lm] (d) chunked", base, outs, base_log, log)
    ph.check(counts["interleaved"] > 0, "[lm] (d): no decode tick ran while a prompt was chunk-prefilling")
    ph.check(launches["paged_attention"] == cfg.n_layers * counts["ticks"] > 0,
             f"[lm] (d): paged_attention launched {launches['paged_attention']} times in {counts['ticks']} ticks")
    ph.check(svc.metrics()["dispatch_errors"] == 0, "[lm] (d): dispatch errors")
    print(f"[lm] (d) chunked prefill: {len(stream)} requests, prompts {load.prompt_lens} tokens, "
          f"{CHUNK_PREFILL} a tick, max_len {CHUNK_MAX_LEN}: {counts['chunks']} chunk steps, {counts['ticks']} "
          f"decode ticks of which {counts['interleaved']} interleaved with a chunked prefill; logit diff vs "
          f"unchunked {diff:.4g}; {len(stream) - differ}/{len(stream)} requests' tokens identical to the "
          f"unchunked engine, {differ} within the gap rule; paged_attention launches "
          f"{launches['paged_attention']}; wall_s={wall:.3f}", flush=True)
    return launches


def _perturbed(logits, params, rng):
    """The Gumbel-perturbed scores ``sample_token`` takes the argmax of."""
    import numpy as np

    z = np.asarray(logits, np.float64) / params.temperature
    if params.top_k:
        k = min(int(params.top_k), z.shape[0])
        keep = np.argpartition(z, -k)[-k:]
        masked = np.full_like(z, -np.inf)
        masked[keep] = z[keep]
        z = masked
    return z - np.log(-np.log(rng.uniform(low=np.finfo(np.float64).tiny, high=1.0, size=z.shape)))


class _SampleCheck:
    """Re-runs every decode tick of a sampling service on the plain route
    from a clone of the pool, and for every sampled token also draws the
    plain route's token with the same Gumbel noise (the request's stream
    state copied before the draw).  Records the worst logit difference and,
    where the two tokens differ, the gap between the plain route's top two
    perturbed scores."""

    def __init__(self, svc):
        self.engine = svc.engine
        self.orig, self.orig_pick = svc.engine.step_logits, svc._pick_token
        svc.engine.step_logits, svc._pick_token = self.step, self.pick
        self.plain = {}
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.tokens = 0
        self.gaps = []

    def step(self, caches, lens, toks, block_tables, impl=None):
        import torch

        clone = {name: {k: v.clone() for k, v in leafs.items()} for name, leafs in caches.items()}
        p_logits = self.orig(clone, lens, toks, block_tables, "plain")[0]
        del clone
        out = self.orig(caches, lens, toks, block_tables, impl)
        pool = self.engine.pool
        idx = pool.decoding_indices()
        sel = torch.tensor(idx, device=p_logits.device)
        kl, pl = out[0][sel], p_logits[sel]
        diff = float((kl - pl).abs().max())
        self.max_abs = max(self.max_abs, diff)
        self.max_rel = max(self.max_rel, diff / max(1.0, float(pl.abs().max())))
        rows = pl.float().cpu().numpy()
        self.plain = {id(pool[i]): rows[j] for j, i in enumerate(idx)}
        return out

    def pick(self, slot, out):
        import copy

        import numpy as np

        prow = self.plain.pop(id(slot), None)
        if prow is None or slot.rng is None:
            return self.orig_pick(slot, out)
        state = copy.deepcopy(slot.rng.bit_generator.state)
        tok = self.orig_pick(slot, out)
        rng = np.random.Generator(np.random.PCG64())
        rng.bit_generator.state = state
        scores = _perturbed(prow, slot.request.sampling, rng)
        self.tokens += 1
        if int(np.argmax(scores)) != tok:
            top2 = np.sort(scores)[-2:]
            self.gaps.append(float(top2[1] - top2[0]))
        return tok


def _lm_sampling(ph, cfg, params, dev):
    """(e) sampling: at temperature 0 the sampling engine's tokens equal the
    greedy engine's bit for bit; at temperature 0.8 / top-k 50 fixed seeds
    reproduce on a rerun; kernel route vs plain route on a cloned pool."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serve.loadgen import LMLoadConfig

    load = LMLoadConfig(n_requests=SAMPLE_REQUESTS)
    stream = load.request_stream(cfg.vocab_size)
    max_len = -(-max(load.max_request_len + 8, 32) // LM_PAGE) * LM_PAGE
    shape = dict(n_slots=LM_SLOTS, max_len=max_len, max_prompt=max(load.prompt_lens), paged=True, page_size=LM_PAGE)

    def run(svc, kw):
        futs = [svc.submit(t, m, **kw(i)) for i, (t, m) in enumerate(stream)]
        svc.drain()
        return [f.result(timeout=60) for f in futs]

    greedy = run(_lm_service(cfg, params, dev, **shape), lambda i: {})
    zero = run(_lm_service(cfg, params, dev, sampling=True, **shape), lambda i: dict(seed=i))
    bad_zero = [i for i, (a, b) in enumerate(zip(greedy, zero)) if not np.array_equal(a, b)]
    ph.check(not bad_zero, f"[lm] (e): sampling at temperature 0 differs from the greedy engine in requests {bad_zero}")
    hot = lambda i: dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=100 + i)  # noqa: E731
    svc = _lm_service(cfg, params, dev, sampling=True, **shape)
    check = _SampleCheck(svc)
    kernels.reset_launch_counts()
    first = run(svc, hot)
    launches = kernels.launch_counts()
    again = run(_lm_service(cfg, params, dev, sampling=True, **shape), hot)
    bad_rerun = [i for i, (a, b) in enumerate(zip(first, again)) if not np.array_equal(a, b)]
    ph.check(not bad_rerun, f"[lm] (e): seeded sampled tokens differ on a rerun in requests {bad_rerun}")
    limit = 2 * check.max_abs / SAMPLE_T
    ph.check(check.max_rel <= LOGIT_TOL, f"[lm] (e): kernel vs plain logits rel {check.max_rel:.3g} > {LOGIT_TOL}")
    ph.check(all(g < limit for g in check.gaps),
             f"[lm] (e): sampled tokens differ between routes at perturbed gaps {check.gaps} >= {limit:.4g}")
    ph.check(any(not np.array_equal(a, b) for a, b in zip(first, greedy)), "[lm] (e): temperature changed no token")
    ph.check(launches["paged_attention"] > 0, "[lm] (e): the sampled run launched no paged_attention")
    print(f"[lm] (e) sampling: temperature 0 == greedy engine, bit for bit, in {len(stream) - len(bad_zero)}/"
          f"{len(stream)} requests; T={SAMPLE_T} top_k={SAMPLE_TOP_K} seeded tokens reproduce on a rerun in "
          f"{len(stream) - len(bad_rerun)}/{len(stream)}; kernel vs "
          f"plain route on a cloned pool: logits max_abs={check.max_abs:.4g} rel={check.max_rel:.4g}, "
          f"{check.tokens} sampled decode tokens, {len(check.gaps)} differ between routes (allowed where the "
          f"perturbed top-2 gap < 2 x diff / T = {limit:.4g}: gaps {check.gaps})", flush=True)
    return launches


def _lm_prefix(ph, cfg, params, dev):
    """(f) the prefix radix cache on ``SharedPrefixLoadConfig()``, kernel
    route: warm tokens == unshared, fewer peak pages, hits, a copy-on-write,
    the probe against its oracle."""
    from repro_torch import kernels
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.serve.loadgen import SharedPrefixLoadConfig, compare_prefix_sharing
    from repro_torch.serve.probes import DecorrProbe

    load = SharedPrefixLoadConfig()
    kernels.reset_launch_counts()
    rep = compare_prefix_sharing(
        cfg, params, load, n_slots=4, page_size=LM_PAGE, prefill_chunk=8, device=dev, record_probe_rows=True,
        probe_fn=lambda: DecorrProbe(DecorrConfig(style="vic", reg="sum", q=2), perm_seed=SEED, device=dev),
    )
    launches = kernels.launch_counts()
    g, sh = rep["gate"], rep["shared"]
    err = g.get("probe_oracle_rel_err")
    ph.check(g["token_mismatches"] == 0, f"[lm] (f): warm tokens differ from unshared in {g['token_mismatches']} requests")
    ph.check(g["peak_pages_lt_unshared"], f"[lm] (f): shared peak pages ratio {g['peak_pages_ratio']:.3f} >= 1")
    ph.check(g["prefix_hit_rate"] > 0 and g["prefix_cow_total"] >= 1,
             f"[lm] (f): hit rate {g['prefix_hit_rate']} cow {g['prefix_cow_total']}")
    ph.check(err is not None and err < LM_PROBE_TOL, f"[lm] (f): probe vs oracle {err}")
    for name in ("paged_attention",) + LM_PROBE_KERNELS:
        ph.check(launches[name] > 0, f"[lm] (f): {name} never launched")
    print(f"[lm] (f) prefix cache: {load.n_prefixes} prefixes of {load.prefix_len} tokens, fan-out {load.fan_out}, "
          f"4 slots, page {LM_PAGE}, chunk 8: warm == unshared in {load.n_prefixes * load.fan_out} requests (mismatches {g['token_mismatches']:.0f}); peak pages {sh['peak_pages']:.0f} vs unshared "
          f"{rep['unshared']['peak_pages']:.0f}; hit rate {g['prefix_hit_rate']:.3f}, "
          f"{sh['paged_prefix_hit_tokens_total']:.0f} rows skipped, {g['prefix_cow_total']:.0f} copy-on-write; "
          f"probe_oracle_rel_err={err}; paged_attention launches {launches['paged_attention']}", flush=True)
    return launches


class _VerifyCheck:
    """Every call of ``step_logits`` (decode tick or verify) re-run on the
    plain route from a clone of the pool: the worst logit difference over
    the live lanes, and the kernel route's paged_attention launches per call
    by batch size."""

    def __init__(self, engine):
        self.engine = engine
        self.orig = engine.step_logits
        engine.step_logits = self
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.calls = {}

    def __call__(self, caches, lens, toks, block_tables, impl=None):
        from repro_torch import kernels

        clone = {name: {k: v.clone() for k, v in leafs.items()} for name, leafs in caches.items()}
        p_logits = self.orig(clone, lens, toks, block_tables, "plain")[0]
        del clone
        before = kernels.launch_counts()["paged_attention"]
        out = self.orig(caches, lens, toks, block_tables, impl)
        launched = kernels.launch_counts()["paged_attention"] - before
        b = int(lens.shape[0])
        self.calls.setdefault(b, []).append(launched)
        live = block_tables.any(dim=1)
        if b == self.engine.pool.n_slots:  # a decode tick: the decoding lanes
            live[:] = False
            live[self.engine.pool.decoding_indices()] = True
        kl, pl = out[0][live], p_logits[live]
        diff = float((kl - pl).abs().max())
        self.max_abs = max(self.max_abs, diff)
        self.max_rel = max(self.max_rel, diff / max(1.0, float(pl.abs().max())))
        return out


def _lm_speculative(ph, cfg, params, dev):
    """(g) speculative decoding, draft_k 4, kernel route, against the plain
    (unspeculative) paged greedy engine on the reference mix."""
    from repro_torch import kernels
    from repro_torch.serve.loadgen import LMLoadConfig

    load = LMLoadConfig()
    stream = load.request_stream(cfg.vocab_size)
    max_len = -(-max(load.max_request_len + 8, 32) // LM_PAGE) * LM_PAGE
    shape = dict(n_slots=LM_SLOTS, max_len=max_len, max_prompt=max(load.prompt_lens), paged=True, page_size=LM_PAGE)
    base, _, _, base_log = _drive_logged(_lm_service(cfg, params, dev, **shape), stream)
    svc = _lm_service(cfg, params, dev, speculative=True, draft_k=DRAFT_K, **shape)
    log = _LogitLog(svc.engine)
    check = _VerifyCheck(svc.engine)
    kernels.reset_launch_counts()
    outs, wall, _ = _lm_drive(svc, stream, log)
    launches = kernels.launch_counts()
    diff, differ = _gap_rule(ph, "[lm] (g) speculative", base, outs, base_log, log)
    st = svc.spec_stats
    vb = LM_SLOTS * (DRAFT_K + 1)
    verify = check.calls.get(vb, [])
    ph.check(st.verify_steps > 0 and len(verify) == st.verify_steps,
             f"[lm] (g): {len(verify)} calls at B={vb} for {st.verify_steps} verify steps")
    ph.check(all(n == cfg.n_layers for calls in check.calls.values() for n in calls),
             f"[lm] (g): paged_attention launches per call {check.calls}")
    ph.check(check.max_rel <= LOGIT_TOL, f"[lm] (g): verify logits kernel vs plain rel {check.max_rel:.3g}")
    ph.check(svc.metrics()["dispatch_errors"] == 0, "[lm] (g): dispatch errors")
    print(f"[lm] (g) speculative: draft_k={DRAFT_K}, {len(stream)} requests; {st.verify_steps} verify steps at "
          f"B={vb} ({cfg.n_layers} paged_attention launches each: "
          f"{sorted(set(verify))}), {st.plain_steps} plain ticks; accepted tokens per verify step "
          f"{st.accepted_per_step():.3f}, tokens per slot-lane {st.tokens_emitted / max(st.slot_lanes, 1):.3f}, "
          f"acceptance {st.acceptance_rate():.3f}; kernel vs plain logits on a cloned pool max_abs={check.max_abs:.4g} "
          f"rel={check.max_rel:.4g}; logit diff vs unspeculative {diff:.4g}; {len(stream) - differ}/{len(stream)} "
          f"requests identical, {differ} within the gap rule; paged_attention launches "
          f"{launches['paged_attention']}; wall_s={wall:.3f}", flush=True)
    return launches


def _lm_long_prompt(ph, cfg, params, dev):
    """(h) one prompt of 10240 tokens through ``LMService``: the prefill
    takes ``_chunked_attention`` (26 calls), its first-token logits against
    the same forward with the chunked path bypassed; then 8 decode tokens."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models import attention
    from repro_torch.serve.buckets import bucket_for
    from repro_torch.serve.engine import ContinuousLMEngine
    from repro_torch.serve.service import LMService
    from repro_torch.train.serve import make_prefill_at_step

    n = LONG_PREFILL
    max_len = -(-(n + LONG_PREFILL_NEW) // LM_PAGE) * LM_PAGE
    eng = ContinuousLMEngine(cfg, params, n_slots=1, max_len=max_len, max_prompt_len=n, paged=True,
                             page_size=LM_PAGE, device=dev)
    svc = LMService(eng)
    bucket = bucket_for(n, eng._prompt_policy)
    chunked_calls = [0]
    orig_chunked, orig_first = attention._chunked_attention, eng._first_output
    firsts = []

    def counted(*a, **k):
        chunked_calls[0] += 1
        return orig_chunked(*a, **k)

    def first(logits, hidden):
        firsts.append(logits[0].detach().clone())
        return orig_first(logits, hidden)

    attention._chunked_attention, eng._first_output = counted, first
    prompt = np.random.default_rng(SEED + 9).integers(0, cfg.vocab_size, n).astype(np.int32)
    try:
        kernels.reset_launch_counts()
        fut = svc.submit(prompt, LONG_PREFILL_NEW)
        t0 = time.perf_counter()
        svc.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        attention._chunked_attention = orig_chunked
    toks = fut.result(timeout=60)
    ticks = eng.pool.steps
    full_cfg = dataclasses.replace(cfg, attn_chunk_threshold=1 << 30)
    padded = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    padded[0, :n] = torch.as_tensor(prompt, device=dev)
    with torch.no_grad():
        full = make_prefill_at_step(full_cfg)(params, eng._caches1, padded, n)[0][0]
    err = float((firsts[0] - full).abs().max())
    rel = err / max(1.0, float(full.abs().max()))
    ph.check(bucket > cfg.attn_chunk_threshold and bucket % cfg.attn_chunk_size == 0,
             f"[lm] (h): bucket {bucket} does not take the chunked prefill")
    ph.check(chunked_calls[0] == cfg.n_layers, f"[lm] (h): _chunked_attention ran {chunked_calls[0]} times")
    ph.check(rel <= LOGIT_TOL, f"[lm] (h): chunked vs full-attention first-token logits rel {rel:.3g}")
    ph.check(toks.shape == (LONG_PREFILL_NEW,) and int(toks[0]) == int(torch.argmax(full)),
             f"[lm] (h): tokens {toks}")
    ph.check(launches["paged_attention"] == cfg.n_layers * ticks > 0,
             f"[lm] (h): paged_attention launched {launches['paged_attention']} times in {ticks} ticks")
    print(f"[lm] (h) long prompt: {n} tokens f32 in bucket {bucket} (threshold {cfg.attn_chunk_threshold}, chunks "
          f"of {cfg.attn_chunk_size}): _chunked_attention calls={chunked_calls[0]}; first-token logits vs full "
          f"attention max_abs={err:.4g} rel={rel:.4g}; then {LONG_PREFILL_NEW} tokens in {ticks} decode ticks "
          f"(paged_attention launches {launches['paged_attention']}); wall_s={wall:.3f} "
          f"peak_alloc_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    return launches


def _lm_timed_options(ph, cfg, params, dev, smi):
    """The config's own bf16, kernel route, one run each (for the record,
    not gated): chunked prefill on (d)'s mix, the prefix cache (warm vs cold
    TTFT against unshared), speculative decoding and sampling on the
    reference mix.  Returns the runs' launch counts."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serve.loadgen import LMLoadConfig, SharedPrefixLoadConfig, compare_prefix_sharing

    total = {}

    def counted(fn):
        kernels.reset_launch_counts()
        out = fn()
        for k, v in kernels.launch_counts().items():
            total[k] = total.get(k, 0) + v
        ph.check(kernels.launch_counts()["paged_attention"] > 0, "[lm] bf16 options: a run launched no paged_attention")
        return out

    def line(tag, outs, wall, futs, extra=""):
        ttft = np.asarray([f.ttft_s for f in futs]) * 1e3
        n_tok = sum(len(o) for o in outs)
        print(f"[lm] bf16 {tag}: {len(futs)} requests {n_tok} tokens wall_s={wall:.4f} tok_per_s={n_tok / wall:.1f} "
              f"ttft_p50_ms={np.percentile(ttft, 50):.3f} ttft_p99_ms={np.percentile(ttft, 99):.3f}{extra} | {smi}",
              flush=True)

    chunk = LMLoadConfig(**CHUNK_MIX)
    shape = dict(n_slots=LM_SLOTS, max_len=CHUNK_MAX_LEN, max_prompt=max(chunk.prompt_lens), paged=True,
                 page_size=LM_PAGE)
    for tag, kw in ((f"chunked prefill ({CHUNK_PREFILL} a tick, prompts {chunk.prompt_lens})",
                     dict(prefill_chunk=CHUNK_PREFILL)), ("unchunked, the same mix", {})):
        svc = _lm_service(cfg, params, dev, **kw, **shape)
        outs, wall, futs = counted(lambda: _lm_drive(svc, chunk.request_stream(cfg.vocab_size)))
        line(tag, outs, wall, futs)
        del svc
        torch.cuda.empty_cache()

    rep = counted(lambda: compare_prefix_sharing(cfg, params, SharedPrefixLoadConfig(), n_slots=4,
                                                 page_size=LM_PAGE, prefill_chunk=8, device=dev))
    sh, un = rep["shared"], rep["unshared"]
    print(f"[lm] bf16 prefix cache (SharedPrefixLoadConfig, 4 slots, chunk 8): shared tok_per_s={sh['tok_per_s']:.1f} "
          f"cold_ttft_p50_ms={sh['cold_ttft_p50_ms']:.3f} warm_ttft_p50_ms={sh['warm_ttft_p50_ms']:.3f} "
          f"warm_ttft_p99_ms={sh['warm_ttft_p99_ms']:.3f} | unshared tok_per_s={un['tok_per_s']:.1f} "
          f"cold_ttft_p50_ms={un['cold_ttft_p50_ms']:.3f} warm_ttft_p50_ms={un['warm_ttft_p50_ms']:.3f} "
          f"warm_ttft_p99_ms={un['warm_ttft_p99_ms']:.3f} | peak pages {sh['peak_pages']:.0f} vs {un['peak_pages']:.0f}, "
          f"token mismatches {rep['gate']['token_mismatches']:.0f} | {smi}", flush=True)

    load = LMLoadConfig()
    max_len = -(-max(load.max_request_len + 8, 32) // LM_PAGE) * LM_PAGE
    shape = dict(n_slots=LM_SLOTS, max_len=max_len, max_prompt=max(load.prompt_lens), paged=True, page_size=LM_PAGE)
    stream = load.request_stream(cfg.vocab_size)
    svc = _lm_service(cfg, params, dev, speculative=True, draft_k=DRAFT_K, **shape)
    outs, wall, futs = counted(lambda: _lm_drive(svc, stream))
    st = svc.spec_stats
    line(f"speculative (draft_k={DRAFT_K})", outs, wall, futs,
         f" verify_steps={st.verify_steps} plain_ticks={st.plain_steps} accepted_tokens_per_step="
         f"{st.accepted_per_step():.3f} tokens_per_slot_lane={st.tokens_emitted / max(st.slot_lanes, 1):.3f}")

    svc = _lm_service(cfg, params, dev, sampling=True, **shape)
    host = []
    outputs = svc.engine._outputs

    def timed_outputs(logits):
        t0 = time.perf_counter()
        out = outputs(logits)  # the (N, V) f32 rows to the host (a sync)
        host.append((time.perf_counter() - t0) * 1e3)
        return out

    picks = []
    pick = svc._pick_token

    def timed_pick(slot, out):
        t0 = time.perf_counter()
        tok = pick(slot, out)  # numpy: top-k mask and Gumbel noise over the vocabulary
        picks.append((time.perf_counter() - t0) * 1e3)
        return tok

    svc.engine._outputs, svc._pick_token = timed_outputs, timed_pick
    futs = [svc.submit(t, m, temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, seed=i) for i, (t, m) in enumerate(stream)]
    t0 = time.perf_counter()
    counted(svc.drain)
    wall = time.perf_counter() - t0
    outs = [f.result(timeout=60) for f in futs]
    line(f"sampled (T={SAMPLE_T}, top_k={SAMPLE_TOP_K})", outs, wall, futs,
         f" logits-to-host ms per tick median={float(np.median(host)):.3f} ({len(host)} ticks, "
         f"{LM_SLOTS} x {cfg.vocab_size} f32 = {LM_SLOTS * cfg.vocab_size * 4 / 1e6:.1f} MB); host draw ms per "
         f"token median={float(np.median(picks)):.3f} ({len(picks)} tokens, sum {sum(picks):.1f} ms)")
    return total


def phase_lm(ph: Phase, dev):
    """The LM serving path at full width; returns the bf16 run's launch counts."""
    import gc

    import torch

    from repro_torch.serve.loadgen import LMLoadConfig

    load = LMLoadConfig()
    max_len = -(-max(load.max_request_len + 8, 32) // LM_PAGE) * LM_PAGE
    max_prompt = max(load.prompt_lens)
    cfg, params = _lm_model(dev, torch.float32)
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
          f"hd={cfg.hd} vocab={cfg.vocab_size} params={cfg.param_count() / 1e9:.3f}B; f32 gate: "
          f"{load.n_requests} requests, {LM_SLOTS} slots, page {LM_PAGE}, max_len {max_len}", flush=True)
    stream = load.request_stream(cfg.vocab_size)
    _lm_checked_run(ph, "[lm] f32 24 requests", cfg, params, dev, stream, LM_SLOTS, max_len, max_prompt)
    gc.collect()
    torch.cuda.empty_cache()

    long_load = LMLoadConfig(n_requests=2, prompt_lens=(LONG_PROMPT,), new_tokens=(LONG_NEW,), seed=SEED + 1)
    rows = LONG_PROMPT + LONG_NEW - 1
    total_pages = 2 * (-(-rows // LM_PAGE)) + 1
    print(f"[lm] f32 long context: 2 requests of {LONG_PROMPT} + {LONG_NEW} tokens, max_len {LONG_MAX_LEN}, "
          f"{total_pages} pages of {LM_PAGE} (window {cfg.window_size} on the local layers)", flush=True)
    _lm_checked_run(ph, "[lm] f32 long context", cfg, params, dev, long_load.request_stream(cfg.vocab_size), 2,
                    LONG_MAX_LEN, LONG_PROMPT, total_pages=total_pages)
    for sub in (_lm_chunked, _lm_sampling, _lm_prefix, _lm_speculative, _lm_long_prompt):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sub(ph, cfg, params, dev)
        print(f"[lm] {sub.__name__}: {time.perf_counter() - t0:.1f}s", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg, params = _lm_model(dev, torch.bfloat16)
    counts = _lm_timed(ph, cfg, params, dev, stream, max_len, max_prompt)
    gc.collect()
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for k, v in _lm_timed_options(ph, cfg, params, dev, smi).items():
        counts[k] = counts.get(k, 0) + v
    for k, v in _lm_obs(ph, cfg, params, dev, smi).items():
        counts[k] = counts.get(k, 0) + v
    return counts


def _lm_obs(ph: Phase, cfg, params, dev, smi):
    """obs (c): ``LMService`` on the bf16 model with telemetry on, 8
    requests: one ``decode_step`` span and one ``serve_decode_step_seconds``
    observation a decode tick, the ExecTimer's decode_step calls equal to
    the ticks, 26 ``paged_attention`` launches a tick, a prefill span per
    request; then decode tick ms with telemetry on and off (on, off, on,
    off).  Returns the runs' launches."""
    import statistics

    from repro_torch import kernels
    from repro_torch.obs import Obs
    from repro_torch.serve.loadgen import LMLoadConfig

    load = LMLoadConfig(n_requests=OBS_LM_REQUESTS, seed=SEED + 12)
    max_len = -(-max(load.max_request_len + 8, 32) // LM_PAGE) * LM_PAGE
    stream = load.request_stream(cfg.vocab_size)
    layers = _attn_layers(cfg)
    tick_ms, totals = {}, {}
    for tag in ("on", "off", "on ", "off "):
        obs = Obs() if tag.strip() == "on" else Obs.disabled()
        svc = _lm_service(cfg, params, dev, n_slots=LM_SLOTS, max_len=max_len, max_prompt=max(load.prompt_lens),
                          probe=True, paged=True, page_size=LM_PAGE, obs=obs)
        times = {"decode": []}
        svc.engine.decode_step = _timed(times, "decode", svc.engine.decode_step)
        kernels.reset_launch_counts()
        outs, wall, futs = _lm_drive(svc, stream)
        counts = kernels.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        ticks = len(times["decode"])
        tick_ms.setdefault(tag.strip(), []).append(statistics.median(times["decode"]))
        ph.check(counts["paged_attention"] == layers * ticks,
                 f"[obs] lm {tag}: paged_attention {counts['paged_attention']} launches in {ticks} ticks")
        if tag != "on":
            continue
        events = obs.tracer.to_chrome()["traceEvents"]
        spans = {n: sum(1 for e in events if e["name"] == n) for n in ("decode_step", "prefill_exec", "decode", "retire")}
        row = {r["executable"]: r for r in obs.perf.snapshot()}.get("decode_step", {})
        h = obs.registry.get("serve_decode_step_seconds")
        ph.check(spans["decode_step"] == ticks == h.count == row.get("calls"),
                 f"[obs] lm: {spans['decode_step']} decode spans, {h.count} observations, {row.get('calls')} timer calls "
                 f"for {ticks} ticks")
        ph.check(spans["prefill_exec"] == spans["decode"] == spans["retire"] == OBS_LM_REQUESTS,
                 f"[obs] lm: request spans {spans} for {OBS_LM_REQUESTS} requests")
        rec = obs.recorder.counts()
        ph.check(rec.get("admit") == rec.get("retire") == OBS_LM_REQUESTS, f"[obs] lm: flight recorder {rec}")
        print(f"[obs] (c) LMService {cfg.name} bf16, {OBS_LM_REQUESTS} requests, {ticks} decode ticks: decode_step "
              f"spans={spans['decode_step']} serve_decode_step_seconds count={h.count} ExecTimer decode_step "
              f"calls={row.get('calls')} best={row.get('best_s', 0) * 1e3:.3f}ms | paged_attention "
              f"{counts['paged_attention']} launches = {layers} x {ticks} ticks | request spans "
              f"prefill/decode/retire={spans['prefill_exec']}/{spans['decode']}/{spans['retire']} flight {rec}",
              flush=True)
    print(f"[obs] (c) LMService decode tick ms (median), telemetry on: {tick_ms['on']} off: {tick_ms['off']} "
          f"(order on, off, on, off) | {smi}", flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase fabric: the serving fabric over full-size gemma2-2b replicas
# ---------------------------------------------------------------------------


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _fabric_drive(fab, stream, log=None):
    """Submit ``stream`` to a synchronous fabric and drain it; returns the
    outputs in submit order."""
    futs = [fab.submit_lm(t, m) for t, m in stream]
    if log is not None:
        log.req_index = {id(t.inner): i for i, t in enumerate(fab._inflight.values())}
    fab.drain()
    return [f.result(timeout=60) for f in futs]


def _fabric_checked(ph, cfg, params, dev, load):
    """(a) the 2-replica failover run against the 1-replica kernel route,
    (b) the 1-replica kernel route against its plain route (the gap rule).
    Returns the kernel route's outputs and the runs' launches."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.obs import Obs
    from repro_torch.serve.fabric import FabricConfig
    from repro_torch.serve.loadgen import make_lm_fabric

    kw = dict(n_slots=FABRIC_SLOTS, page_size=LM_PAGE, device=dev)
    stream = load.lm.request_stream(cfg.vocab_size)
    kernels.reset_launch_counts()
    one, _ = make_lm_fabric(cfg, params, FabricConfig(replicas=1, heartbeat_timeout_s=5.0), load, **kw)
    k_log = _LogitLog(one.replicas[0].lm.engine)
    t0 = time.perf_counter()
    k_outs = _fabric_drive(one, stream, k_log)
    one_s = time.perf_counter() - t0
    t = {"now": 0.0}
    obs = Obs()
    fab, _ = make_lm_fabric(cfg, params, FabricConfig(replicas=2, heartbeat_timeout_s=5.0), load, obs=obs,
                            clock=lambda: t["now"], **kw)
    futs = [fab.submit_lm(tok, m) for tok, m in stream]
    for _ in range(3):  # both replicas admit + decode a few ticks
        fab.step()
    fab.kill("r0")
    t["now"] += 10.0  # the heartbeat goes stale; the next step drains r0
    fab.drain()
    f_outs = [f.result(timeout=60) for f in futs]
    counts = kernels.launch_counts()
    bad = [i for i, (a, b) in enumerate(zip(k_outs, f_outs)) if not np.array_equal(a, b)]
    rec = obs.recorder.counts()
    ph.check(not bad, f"[fabric] (a) failover tokens differ from the 1-replica run's in requests {bad}")
    ph.check(fab.requeued_total > 0 and fab.dead_total == 1,
             f"[fabric] (a) requeued={fab.requeued_total} dead={fab.dead_total}")
    ph.check(counts["paged_attention"] > 0, "[fabric] (a) paged_attention never launched")
    ph.check(rec.get("requeue") == rec.get("requeue_done") == fab.requeued_total and rec.get("replica_dead") == 1,
             f"[fabric] (a) flight events {rec}")
    print(f"[fabric] (a) 2 replicas x {FABRIC_SLOTS} slots, r0 killed after 3 ticks: "
          f"{len(stream) - len(bad)}/{len(stream)} requests' tokens == the 1-replica kernel route bit for bit "
          f"({sum(len(o) for o in f_outs)} tokens); requeued={fab.requeued_total} dead={fab.dead_total} "
          f"flight {rec}; launches {_nonzero(counts)}; 1-replica wall {one_s:.3f}s", flush=True)

    plain, _ = make_lm_fabric(cfg, params, FabricConfig(replicas=1, heartbeat_timeout_s=5.0), load,
                              engine_kw=dict(impl="plain"), **kw)
    p_log = _LogitLog(plain.replicas[0].lm.engine, log_plain=True)
    kernels.reset_launch_counts()
    p_outs = _fabric_drive(plain, stream, p_log)
    ph.check(kernels.launch_counts()["paged_attention"] == 0, "[fabric] (b) the plain route launched paged_attention")
    diff, differ = _gap_rule(ph, "[fabric] (b)", p_outs, k_outs, p_log, k_log)
    print(f"[fabric] (b) 1-replica kernel route vs plain route: logit diff {diff:.4g}, {len(stream) - differ}/"
          f"{len(stream)} requests' tokens identical, the rest under the gap rule", flush=True)
    return k_outs, counts


def _fabric_threaded(ph, cfg, params, dev, load, smi):
    """(c) ``compare_fabric``: threaded 1 vs 2 replicas (3 repeats), then the
    failover leg; returns its launches."""
    from repro_torch import kernels
    from repro_torch.serve.loadgen import compare_fabric

    kernels.reset_launch_counts()
    rep = compare_fabric(cfg, params, load, replicas=2, n_slots=FABRIC_SLOTS, page_size=LM_PAGE,
                         repeats=FABRIC_REPEATS, device=dev)
    counts = kernels.launch_counts()
    g = rep["gate"]
    ph.check(g["token_mismatches"] == 0, f"[fabric] (c) {g['token_mismatches']:.0f} route token mismatches")
    ph.check(g["requeue_token_mismatches"] == 0 and g["requeued"] > 0, f"[fabric] (c) failover leg {g}")
    ph.check(counts["paged_attention"] > 0, "[fabric] (c) paged_attention never launched")
    s, m = rep["single"], rep["multi"]
    print(f"[fabric] (c) threaded, best of {FABRIC_REPEATS}: 1 replica {s['tok_per_s']:.1f} tok/s "
          f"(p50 {s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms) | 2 replicas {m['tok_per_s']:.1f} tok/s "
          f"(p50 {m['p50_ms']:.1f} ms, p99 {m['p99_ms']:.1f} ms) | scaling_x={g['scaling_x']:.3f} (reported, "
          f"not gated: one card, one default stream) | route token mismatches {g['token_mismatches']:.0f}, "
          f"failover requeued {g['requeued']:.0f} mismatches {g['requeue_token_mismatches']:.0f} | {smi}", flush=True)
    return counts


def _fabric_mixed(ph, cfg, params, dev, load, k_outs):
    """(d) an ssl-paper embedding service beside the LM service on each
    replica: one request a dispatch (``max_batch`` = its rows), so each
    embedding must equal one ``ServeEngine``'s encode bit for bit."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.obs import Obs
    from repro_torch.serve.buckets import BucketPolicy
    from repro_torch.serve.engine import ContinuousLMEngine, ServeEngine
    from repro_torch.serve.fabric import FabricConfig, ServeFabric
    from repro_torch.serve.loadgen import run_fabric
    from repro_torch.serve.service import EmbeddingService, LMService
    from repro_torch.train.ssl import init_ssl_model

    model_cfg, _ = _paper()
    model = init_ssl_model(model_cfg, seed=SEED)
    policy = BucketPolicy(max_batch=FABRIC_EMBED_ROWS)
    mixed = dataclasses.replace(load, n_embed=FABRIC_EMBED, embed_rows=FABRIC_EMBED_ROWS,
                                input_dim=model_cfg.input_dim)
    max_len = -(-max(load.lm.max_request_len + 8, 32) // LM_PAGE) * LM_PAGE
    fab = ServeFabric(
        FabricConfig(replicas=2, heartbeat_timeout_s=5.0),
        lm_factory=lambda name: LMService(ContinuousLMEngine(
            cfg, params, n_slots=FABRIC_SLOTS, max_len=max_len, max_prompt_len=max(load.lm.prompt_lens), paged=True,
            page_size=LM_PAGE, device=dev), obs=Obs()),
        embed_factory=lambda name: EmbeddingService(ServeEngine(model_cfg, model, policy=policy, device=dev),
                                                    obs=Obs()),
    )
    kernels.reset_launch_counts()
    _, lm_outs, em_outs = run_fabric(fab, mixed)
    counts = kernels.launch_counts()
    engine = ServeEngine(model_cfg, model, policy=policy, device=dev)
    bad = [i for i, x in enumerate(mixed.embed_stream())
           if not np.array_equal(em_outs[i], engine.encode(x).cpu().numpy())]
    lm_bad = [i for i, (a, b) in enumerate(zip(lm_outs, k_outs)) if not np.array_equal(a, b)]
    ph.check(not bad, f"[fabric] (d) embeddings differ from ServeEngine.encode in requests {bad}")
    ph.check(not lm_bad, f"[fabric] (d) LM tokens differ from the 1-replica run's in requests {lm_bad}")
    print(f"[fabric] (d) mixed: {FABRIC_EMBED} ssl-paper embedding requests of {FABRIC_EMBED_ROWS} x "
          f"{model_cfg.input_dim} beside the {len(lm_outs)} LM requests on 2 replicas: embeddings == one ServeEngine's "
          f"bit for bit in {FABRIC_EMBED - len(bad)}/{FABRIC_EMBED}, LM tokens == the 1-replica run's in "
          f"{len(lm_outs) - len(lm_bad)}/{len(lm_outs)}; launches {_nonzero(counts)}", flush=True)
    return counts


def phase_fabric(ph: Phase, dev):
    """The serving fabric on gemma2-2b at full width, FABRIC_DEPTH layers,
    f32 (``init_params(seed=0)``, shared read-only by every replica): (a)-(d) above, (e) ``python -m repro_torch.launch.serve``,
    (f) the metrics catalog on the card == on the CPU.  Returns the
    launches of (a)-(d)."""
    import gc

    import torch

    from repro_torch.obs import catalog
    from repro_torch.serve.loadgen import FabricLoadConfig, LMLoadConfig

    smi = _smi()
    cfg, params = _lm_model(dev, torch.float32, FABRIC_DEPTH)
    load = FabricLoadConfig(lm=LMLoadConfig(**FABRIC_LOAD))
    print(f"[fabric] {cfg.name} f32 {cfg.n_layers} layers d={cfg.d_model}: {load.lm.n_requests} requests, prompts "
          f"{load.lm.prompt_lens}, new tokens {load.lm.new_tokens}, {FABRIC_SLOTS} slots a replica, page {LM_PAGE}",
          flush=True)
    totals = {}
    k_outs, counts = _fabric_checked(ph, cfg, params, dev, load)
    for part in (counts, _fabric_threaded(ph, cfg, params, dev, load, smi),
                 _fabric_mixed(ph, cfg, params, dev, load, k_outs)):
        for k, v in part.items():
            totals[k] = totals.get(k, 0) + v
    del params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH_SERVE_ARGS],
                         env=env, capture_output=True, text=True, timeout=600)
    ph.check(run.returncode == 0, f"[fabric] (e) launch.serve exit {run.returncode}: {run.stderr[-2000:]}")
    print(f"[fabric] (e) python -m repro_torch.launch.serve {' '.join(LAUNCH_SERVE_ARGS)}: exit {run.returncode} in "
          f"{time.perf_counter() - t0:.1f}s | " + " | ".join(run.stdout.strip().splitlines()[-2:]), flush=True)

    t0 = time.perf_counter()
    on_card, on_cpu = catalog.generate(device=dev), catalog.generate(device="cpu")
    ph.check(on_card == on_cpu, "[fabric] (f) the metrics catalog differs between cuda and cpu")
    rows = sum(1 for line in on_card.splitlines() if line.startswith("| `"))
    print(f"[fabric] (f) obs.catalog.generate: cuda == cpu: {on_card == on_cpu} ({rows} table rows) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase tune: the Hopper tuner's measured tier on the card
# ---------------------------------------------------------------------------


def _tune_cli(ph, dev, smi):
    """(a) ``tune.cli --measure --arch ssl-paper --shape 256x8192``: every
    TuneResult of the run, with each plan's analytic pick beside its
    measured one and every candidate's fwd + bwd ms."""
    from repro_torch.tune import cli, dispatch, tuner

    results, real = [], tuner.tune

    def keep(*a, **k):
        results.append(real(*a, **k))
        return results[-1]

    tuner.tune = keep
    t0 = time.perf_counter()
    try:
        rc = cli.main(["--measure", "--arch", "ssl-paper", *sum((["--shape", s] for s in TUNE_SHAPES), []),
                       "--device", str(dev)])
    finally:
        tuner.tune = real
    ph.check(rc == 0, f"[tune] (a) tune.cli exit {rc}")
    print(f"[tune] (a) tune.cli --measure --arch ssl-paper --shape {' '.join(TUNE_SHAPES)}: {len(results)} tuned "
          f"shapes in {time.perf_counter() - t0:.1f}s | {smi}", flush=True)
    for res in results:
        if res.kernel in ("sumvec_fft_plan", "grouped_block_plan"):
            analytic = dispatch._analytic_search(res.kernel, res.shape)
            cands = "; ".join(f"{c.config} {c.time_us / 1e3:.4f}" for c in res.candidates)
            print(f"[tune] (a) {res.kernel} {res.shape}: analytic pick {analytic}, measured pick {res.best}, default "
                  f"{res.default} | fwd + bwd ms by candidate: {cands}", flush=True)
        else:
            t = res.candidates[0].time_us
            ph.check(res.best == res.default and len(res.candidates) == 1, f"[tune] (a) {res.kernel}: {res.best}")
            print(f"[tune] (a) {res.kernel} {res.shape}: kept default {res.best}, one launch "
                  f"{t / 1e3:.4f} ms", flush=True)
    return [r for r in results if r.kernel == "sumvec_fft_plan"]


def _tune_same_loss(ph, dev, plans):
    """(b) the regularizer's loss and input gradient under each measured plan
    against the default plan's (5e-4 relative)."""
    import torch

    from repro_torch import tune
    from repro_torch.core import regularizers as regs

    for res in plans:
        (d,) = res.shape
        gen = torch.Generator(device=dev).manual_seed(SEED)
        z1, z2 = (torch.randn(256, d, device=dev, generator=gen).requires_grad_() for _ in range(2))

        def run(cfg):
            with tune.override("sumvec_fft_plan", **cfg):
                loss = regs.r_sum(z1, z2, q=2, scale=256.0, impl="kernel")
            return loss.detach(), torch.autograd.grad(loss, (z1,))[0]

        (a, ga), (b, gb) = run(res.best), run(res.default)
        loss_rel, grad_rel = _max_rel([float(a)], [float(b)]), _grad_rel([ga], [gb])
        ph.check(loss_rel <= TUNE_TOL and grad_rel <= TUNE_TOL,
                 f"[tune] (b) d={d}: plan {res.best} vs {res.default}: loss rel {loss_rel:.3g} grad rel {grad_rel:.3g}")
        print(f"[tune] (b) d={d}: measured plan {res.best} vs default {res.default}: loss rel err {loss_rel:.3g}, "
              f"input grad rel err {grad_rel:.3g} (limit {TUNE_TOL})", flush=True)


def _tune_cached(ph, dev, plans):
    """(c) after ``clear_memory_cache`` the disk entry answers
    ``best_config``, and a second tune times nothing."""
    from repro_torch import tune
    from repro_torch.tune import cache, cost

    tune.clear_memory_cache()
    timed, real = [], cost.measured_time_us
    cost.measured_time_us = lambda *a, **k: timed.append(1) or real(*a, **k)
    try:
        for res in plans:
            entry = cache.lookup("sumvec_fft_plan", res.shape, "float32", cache.backend_key(dev))
            got = tune.best_config("sumvec_fft_plan", res.shape)
            again = tune.tune("sumvec_fft_plan", res.shape, mode="measure", device=dev)
            ph.check(entry is not None and got == entry["config"] == res.best and again.cached,
                     f"[tune] (c) d={res.shape[0]}: disk {entry}, best_config {got}, cached {again.cached}")
    finally:
        cost.measured_time_us = real
    ph.check(not timed, f"[tune] (c) the second tune timed {len(timed)} candidates")
    print(f"[tune] (c) after clear_memory_cache: best_config == the disk entry ({cache.backend_key(dev)}.json) for "
          f"{len(plans)} plans; a second tune timed {len(timed)} candidates", flush=True)


def _tune_pages(ph, dev, smi):
    """(d) the page candidates at the LM pool's shape (f32 and bf16 pages),
    one paged_attention launch each, beside ``auto_page_size``."""
    import torch

    from repro_torch import tune
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import PAGE_PREFER, auto_page_size
    from repro_torch.tune import dispatch
    from repro_torch.serve.loadgen import LMLoadConfig

    cfg = get_config("gemma2-2b")
    load = LMLoadConfig()
    max_len = -(-max(load.max_request_len + 8, 32) // LM_PAGE) * LM_PAGE
    shape = (LM_SLOTS, max_len, cfg.n_kv_heads, cfg.hd)
    before = auto_page_size(*shape)
    analytic = dispatch._analytic_search("paged_attention", shape)
    for dtype in (torch.float32, torch.bfloat16):
        res = tune.tune("paged_attention", shape, dtype, mode="measure", persist=False, max_candidates=0,
                        guard_default=False, device=dev)
        ms = {c.config["page"]: c.time_us / 1e3 for c in res.candidates}
        ph.check(all(t > 0 for t in ms.values()), f"[tune] (d) page times {ms}")
        small = {p: round(t, 5) for p, t in sorted(ms.items()) if p <= PAGE_PREFER}
        print(f"[tune] (d) paged_attention pool {shape} {str(dtype).replace('torch.', '')}: ms by page up to "
              f"PAGE_PREFER={PAGE_PREFER}: {small}; larger pages {({p: round(t, 5) for p, t in sorted(ms.items()) if p > PAGE_PREFER})}"
              f" | measured pick {res.best['page']}, analytic pick {analytic['page']}, default {res.default['page']}; "
              f"auto_page_size {before} (the analytic pick capped at PAGE_PREFER) | {smi}", flush=True)
    tune.clear_memory_cache()


def _tune_warmup(ph, dev):
    """(e) ``warmup_tune_cache`` measured at the LM aux loss's shape, and the
    LM launcher's ``--pretune analytic`` at ``--reduced``."""
    from repro_torch.decorr import DecorrConfig, warmup_tune_cache
    from repro_torch.launch import train as launch

    t0 = time.perf_counter()
    res = warmup_tune_cache(LMTRAIN_N, 2304, DecorrConfig(style="vic", reg="sum", q=2), mode="measure", device=dev)
    ph.check(len(res) > 0 and all(r.best for r in res), "[tune] (e) warmup_tune_cache")
    moved = [f"{r.kernel} {r.best}" for r in res if r.best != r.default]
    print(f"[tune] (e) warmup_tune_cache({LMTRAIN_N}, 2304, vic R_sum q=2, measure): {len(res)} shapes in "
          f"{time.perf_counter() - t0:.1f}s; moved from the default: {moved or 'none'}", flush=True)
    t0 = time.perf_counter()
    state = launch.train(launch.parse_args(["--arch", "gemma2-2b", "--reduced", "--steps", "2", "--decorr",
                                            "--pretune", "analytic", "--device", str(dev)]))
    ph.check(state.step == 2, f"[tune] (e) launch.train stopped at step {state.step}")
    print(f"[tune] (e) launch/train --reduced --decorr --pretune analytic: 2 steps in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def phase_tune(ph: Phase, dev):
    """The tuner on the card, in a temporary cache directory (under
    ``build/``, removed after): (a)-(e) above.  Every measured candidate
    runs the kernel route, so its launches count; the memo is cleared at the
    end so later phases run the default plans.  Returns the launches."""
    import shutil
    import tempfile

    from repro_torch import kernels, tune

    smi = _smi()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cache_dir = tempfile.mkdtemp(prefix="tune_cache_", dir=os.path.join(ROOT, "build"))
    old = os.environ.get("REPRO_TUNE_CACHE")
    os.environ["REPRO_TUNE_CACHE"] = cache_dir
    tune.clear_memory_cache()
    kernels.reset_launch_counts()
    try:
        plans = _tune_cli(ph, dev, smi)
        _tune_same_loss(ph, dev, plans)
        _tune_cached(ph, dev, plans)
        _tune_pages(ph, dev, smi)
        _tune_warmup(ph, dev)
        return kernels.launch_counts()
    finally:
        tune.clear_memory_cache()
        if old is None:
            os.environ.pop("REPRO_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TUNE_CACHE"] = old
        shutil.rmtree(cache_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 6: the other nine LM archs
# ---------------------------------------------------------------------------

# (arch, depth on the card), every arch at full width: None = every layer;
# an int = that many layers (whole pattern periods), where the f32 model at
# full depth would not fit one card
ARCH_RUNS = (
    ("codeqwen1.5-7b", None),
    ("qwen2-vl-2b", None),
    ("llama4-scout-17b-a16e", 2),
    ("jamba-v0.1-52b", 8),
    ("rwkv6-3b", None),
    ("musicgen-large", None),
    ("qwen1.5-110b", 2),
    ("nemotron-4-340b", 1),
    ("arctic-480b", 1),
)
# each continuous-engine run: 12 requests of the reference mix's ladders
ARCH_LOAD = dict(n_requests=12, seed=SEED + 9)
# musicgen: whole-request generate of (batch, prompt, 4 codebooks)
MUSIC_BATCH, MUSIC_PROMPT, MUSIC_NEW = 4, 16, 12


def _arch_model(name, depth, dtype, dev, positions=False):
    """Arch ``name`` at full width, ``depth`` layers (None: all), in
    ``dtype``, random weights from ``init_params(seed=0)``; ``positions``:
    the first ``depth`` positions of the pattern, one layer each (jamba's
    period is 8 layers)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config(name)
    pattern = cfg.pattern[:depth] if positions else cfg.pattern
    cfg = dataclasses.replace(cfg, pattern=pattern, n_layers=depth or cfg.n_layers, param_dtype=dtype,
                              compute_dtype=dtype)
    return cfg, init_params(cfg, seed=SEED, device=dev)


def _logged_steps(cfg, rows):
    """A greedy ``(prefill, decode)`` pair that keeps every emitted token's
    logits row (batch row 0) in ``rows``."""
    from repro_torch.train.serve import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    def pre(params, caches, tokens, **kw):
        logits, caches = prefill(params, caches, tokens, **kw)
        rows.append(logits[:, 0].detach().clone())
        return logits, caches

    def dec(params, caches, cache_len, tokens, **kw):
        logits, caches = decode(params, caches, cache_len, tokens, **kw)
        rows.append(logits.detach().clone())
        return logits, caches

    return pre, dec


def _probe_err(ph, tag, svc):
    from repro_torch.serve.loadgen import lm_probe_oracle_err

    err = lm_probe_oracle_err(svc)
    ph.check(err is not None and err < LM_PROBE_TOL, f"{tag}: probe vs oracle {err} (limit {LM_PROBE_TOL})")
    return err


def _arch_recurrent(ph, name, cfg, params, dev, stream, max_len, max_prompt):
    """rwkv6-3b (f32): the continuous dense engine's tokens equal to
    ``greedy_generate``'s, request by request; probe vs its oracle."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.train.serve import greedy_generate

    tag = f"[archs] {name} f32"
    base = [greedy_generate(params, cfg, torch.as_tensor(t[None], device=dev), m, max_len=max_len)[0].cpu().numpy()
            for t, m in stream]
    svc = _lm_service(cfg, params, dev, LM_SLOTS, max_len, max_prompt, probe=True, record=True)
    kernels.reset_launch_counts()
    outs, wall, _ = _lm_drive(svc, stream)
    counts = kernels.launch_counts()
    bad = [i for i, (a, b) in enumerate(zip(base, outs)) if not np.array_equal(a, b)]
    ph.check(not bad, f"{tag}: continuous dense engine tokens differ from greedy_generate's in requests {bad}")
    err = _probe_err(ph, tag, svc)
    for k in LM_PROBE_KERNELS:
        ph.check(counts[k] > 0, f"{tag}: the probe never launched {k}")
    print(f"{tag}: continuous dense engine == greedy_generate in {len(stream) - len(bad)}/{len(stream)} requests; "
          f"probe_oracle_rel_err={err}; probe launches " + ", ".join(f"{k}={counts[k]}" for k in LM_PROBE_KERNELS)
          + f"; wall_s={wall:.3f}", flush=True)
    return counts


def _arch_audio(ph, name, cfg, params, dev):
    """musicgen-large (f32): cached ``LMServeEngine.generate`` against the
    argmax of one uncached full forward over the prompt and the generated
    codes, per codebook under the gap rule; the probe on the forward's last
    hidden rows vs its oracle."""
    import torch

    from repro_torch import kernels
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.decorr.probe import probe_metrics
    from repro_torch.models import forward
    from repro_torch.serve.common import make_prompt
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.train.serve import greedy_generate

    tag = f"[archs] {name} f32"
    prompt = make_prompt(cfg, SEED + 10, MUSIC_BATCH, MUSIC_PROMPT, device=dev)
    rows = []
    out = greedy_generate(params, cfg, prompt, MUSIC_NEW, steps=_logged_steps(cfg, rows))
    cached = torch.stack(rows, dim=1)  # (B, N, n_q, V)
    with torch.no_grad():
        full = forward(params, cfg, torch.cat([prompt, out[:, :-1]], dim=1))
    ref = full.logits[:, MUSIC_PROMPT - 1:]  # the same positions, uncached
    ph.check(out.shape == (MUSIC_BATCH, MUSIC_NEW, cfg.n_codebooks), f"{tag}: output shape {tuple(out.shape)}")
    diff = float((cached - ref).abs().max())
    want = ref.argmax(-1).to(out.dtype)
    exempt = 0
    for b in range(MUSIC_BATCH):
        for q in range(cfg.n_codebooks):
            bad = torch.nonzero(out[b, :, q] != want[b, :, q]).flatten().tolist()
            if not bad:
                continue
            t = bad[0]
            top2 = torch.topk(ref[b, t, q].float(), 2).values
            gap = float(top2[0] - top2[1])
            ok = gap < 2 * diff
            exempt += ok
            print(f"{tag}: row {b} codebook {q} first differs at token {t}: uncached top-2 gap {gap:.4g} vs "
                  f"2 x logit diff {2 * diff:.4g} -> {'exempt from here on' if ok else 'FAIL'}", flush=True)
            ph.check(ok, f"{tag}: row {b} codebook {q} differs at token {t} with top-2 gap {gap}")
    probe = DecorrProbe(DecorrConfig(style="vic", reg="sum", q=2), perm_seed=SEED, device=dev)
    window = full.hidden[:, -2:].reshape(-1, cfg.d_model).float().contiguous()
    kernels.reset_launch_counts()
    got = probe.update(window)
    counts = kernels.launch_counts()
    oracle = probe_metrics(window, None, probe.cfg, probe.permutation(0, cfg.d_model), impl="plain")
    err = max(abs(got[k] - float(v)) / max(abs(float(v)), 1e-6) for k, v in oracle.items())
    ph.check(err < LM_PROBE_TOL, f"{tag}: probe vs oracle {err} (limit {LM_PROBE_TOL})")
    for k in LM_PROBE_KERNELS:
        ph.check(counts[k] > 0, f"{tag}: the probe never launched {k}")
    print(f"{tag}: cached generate ({MUSIC_BATCH} x {MUSIC_PROMPT} + {MUSIC_NEW} codes x {cfg.n_codebooks}) vs "
          f"uncached forward argmax: logit diff {diff:.4g}, {MUSIC_BATCH * cfg.n_codebooks - exempt}/"
          f"{MUSIC_BATCH * cfg.n_codebooks} code streams identical, {exempt} exempt; probe on {window.shape[0]} "
          f"hidden rows: oracle rel err {err:.3g}, launches " + ", ".join(f"{k}={counts[k]}" for k in LM_PROBE_KERNELS),
          flush=True)
    return counts


def _arch_audio_timed(ph, name, cfg, params, dev, smi):
    """musicgen-large bf16: three timed generate calls (prefill and decode
    step ms from host clocks around synced steps)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.serve.common import make_prompt
    from repro_torch.train.serve import greedy_generate, make_decode_step, make_prefill_step

    prompt = make_prompt(cfg, SEED + 10, MUSIC_BATCH, MUSIC_PROMPT, device=dev)
    times = {"prefill": [], "decode": []}
    steps = (_timed(times, "prefill", make_prefill_step(cfg), sync=True),
             _timed(times, "decode", make_decode_step(cfg), sync=True))
    greedy_generate(params, cfg, prompt, 2, steps=steps)  # warm-up, not counted
    times["prefill"].clear()
    times["decode"].clear()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = greedy_generate(params, cfg, prompt, MUSIC_NEW, steps=steps)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ph.check(bool(torch.isfinite(out.float()).all()), f"[archs] {name} bf16: non-finite output")
    ttft = np.asarray(times["prefill"])
    n_tok = MUSIC_BATCH * MUSIC_NEW
    print(f"[archs] {name} bf16 timed: generate {MUSIC_BATCH} x ({MUSIC_PROMPT} + {MUSIC_NEW}) x "
          f"{cfg.n_codebooks} codes, 3 runs: tok_per_s={n_tok / statistics.median(walls):.1f} (codes steps per s "
          f"across the batch) ttft_p50_ms={np.percentile(ttft, 50):.3f} ttft_p99_ms={np.percentile(ttft, 99):.3f} "
          f"decode_tick_ms median={statistics.median(times['decode']):.3f} prefill_ms "
          f"median={statistics.median(times['prefill']):.3f} | {smi}", flush=True)


def _arch_timed(ph, name, cfg, params, dev, stream, n_slots, max_len, max_prompt, paged, smi):
    """bf16 on the kernel route: tok/s, TTFT p50 / p99, decode tick and
    prefill ms of one continuous-engine run (host clocks; both steps end in
    a host sync)."""
    import statistics

    import numpy as np

    from repro_torch import kernels

    kw = dict(paged=True, page_size=LM_PAGE) if paged else {}
    svc = _lm_service(cfg, params, dev, n_slots, max_len, max_prompt, probe=True, **kw)
    eng = svc.engine
    times = {"decode": [], "insert": []}
    eng.decode_step, eng.insert = _timed(times, "decode", eng.decode_step), _timed(times, "insert", eng.insert)
    kernels.reset_launch_counts()
    outs, wall, futs = _lm_drive(svc, stream)
    counts = kernels.launch_counts()
    ticks = eng.pool.steps
    m = svc.metrics()
    tag = f"[archs] {name} bf16"
    if paged:
        ph.check(counts["paged_attention"] == _attn_layers(cfg) * ticks > 0,
                 f"{tag}: paged_attention launched {counts['paged_attention']} times in {ticks} ticks")
    for k in LM_PROBE_KERNELS:
        ph.check(counts[k] > 0, f"{tag}: the probe never launched {k}")
    ph.check(m["dispatch_errors"] == 0, f"{tag}: dispatch_errors={m['dispatch_errors']}")
    ph.check(all(o.shape == (mn,) for o, (_, mn) in zip(outs, stream)), f"{tag}: wrong output lengths")
    ttft = np.asarray([f.ttft_s for f in futs]) * 1e3
    n_tok = sum(len(o) for o in outs)
    print(f"{tag} timed: {len(stream)} requests {n_tok} tokens {n_slots} slots "
          f"{'paged' if paged else 'dense'} wall_s={wall:.4f} tok_per_s={n_tok / wall:.1f} "
          f"ttft_p50_ms={np.percentile(ttft, 50):.3f} ttft_p99_ms={np.percentile(ttft, 99):.3f} "
          f"decode_tick_ms median={statistics.median(times['decode']):.3f} ({ticks} ticks) "
          f"prefill_ms median={statistics.median(times['insert']):.3f} max={max(times['insert']):.3f} | launches "
          f"{dict((k, v) for k, v in counts.items() if v)} | {smi}", flush=True)
    return counts


def phase_archs(ph: Phase, dev):
    """The nine other LM archs (``ARCH_RUNS``): f32 gates, then one bf16
    timed line each; returns the launch counts of the runs."""
    import gc

    import torch

    from repro_torch.kernels.utils import next_multiple
    from repro_torch.serve.loadgen import LMLoadConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    load = LMLoadConfig(**ARCH_LOAD)
    max_len = next_multiple(load.max_request_len + 8, LM_PAGE)
    max_prompt = max(load.prompt_lens)
    total = {}
    for name, depth in ARCH_RUNS:
        t0 = time.perf_counter()
        for dtype in (torch.float32, torch.bfloat16):
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            cfg, params = _arch_model(name, depth, dtype, dev)
            gib = (torch.cuda.memory_allocated() - before) / 2**30
            stream = load.request_stream(cfg.vocab_size)
            print(f"[archs] {name}: {cfg.n_layers} layers d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} "
                  f"hd={cfg.hd} vocab={cfg.vocab_size} {str(dtype)[6:]} weights {gib:.2f} GiB; {len(stream)} "
                  f"requests, {LM_SLOTS} slots, max_len {max_len}", flush=True)
            if dtype == torch.float32:
                if cfg.frontend == "audio_codes":
                    counts = _arch_audio(ph, name, cfg, params, dev)
                elif cfg.is_attention_free:
                    counts = _arch_recurrent(ph, name, cfg, params, dev, stream, max_len, max_prompt)
                else:
                    counts = _lm_checked_run(ph, f"[archs] {name} f32", cfg, params, dev, stream, LM_SLOTS,
                                             max_len, max_prompt)
            elif cfg.frontend == "audio_codes":
                _arch_audio_timed(ph, name, cfg, params, dev, smi)
                counts = {}
            else:
                counts = _arch_timed(ph, name, cfg, params, dev, stream, LM_SLOTS, max_len, max_prompt,
                                     not cfg.is_attention_free, smi)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            del params
        print(f"[archs] {name}: {time.perf_counter() - t0:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 7: LM training with the paper's aux loss, kernel route vs plain route
# ---------------------------------------------------------------------------


def _lmtrain_cfg(name, depth, aux_kw):
    """Arch ``name`` at full width, ``depth`` layers (None: all), f32, with
    the aux loss of ``aux_kw`` (None: off) as the launcher's ``--decorr``
    sets it (mu 1, nu 0.04, 8 tokens a sequence)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import LMDecorrConfig
    from repro_torch.decorr.config import DecorrConfig

    cfg = get_config(name)
    decorr = LMDecorrConfig() if aux_kw is None else LMDecorrConfig(enabled=True, decorr=DecorrConfig(**aux_kw),
                                                                     nu=0.04)
    return dataclasses.replace(cfg, n_layers=depth or cfg.n_layers, param_dtype=torch.float32,
                               compute_dtype=torch.float32, decorr=decorr)


def _lmtrain_state(cfg, dev, impl, moments=None):
    """(state, step): seeded random weights (the same for every call of one
    config), a fresh AdamW (moments of dtype ``moments``, f32 by default),
    the launcher's schedule; ``impl`` routes the aux regularizer."""
    from repro_torch.models import ParamTree, init_params
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import create_train_state, make_train_step

    opt = adamw() if moments is None else adamw(moment_dtype=moments)
    state = create_train_state(ParamTree(init_params(cfg, seed=SEED, device=dev)), opt, seed=SEED)
    sched = warmup_cosine(LMTRAIN_LR, max(LMTRAIN_STEPS // 10, 1), LMTRAIN_STEPS)
    return state, make_train_step(cfg, opt, sched, impl=impl)


def _lmtrain_steps(state, step, batches):
    """Run one step a batch: (host metrics per step, host ms per step, each
    ending in a device sync)."""
    import torch

    metrics, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    return [{k: float(v) for k, v in m.items()} for m in metrics], ms


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _lmtrain_aux_grad(ph, tag, cfg, state, batch, dev, kernels_fwd, kernels_bwd):
    """Step 0's aux term alone, kernel route vs plain route, on one set of
    final hidden states: its gradient wrt them (CE would swamp a wrong vjp
    in the full gradient).  The kernel route's launches are read after its
    forward and after its backward.  Returns (relative error, {kernel:
    forward launches}, {kernel: backward launches})."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import lm_decorrelation_loss
    from repro_torch.core.permutation import permutation_for_step
    from repro_torch.models import forward

    perm = permutation_for_step(SEED, 0, cfg.d_model).to(dev)
    with torch.no_grad():
        hidden = forward(state.model.tree(), cfg, tokens=batch["tokens"], head=False).hidden
    hidden.requires_grad_()
    kernels.reset_launch_counts()
    aux = lm_decorrelation_loss(hidden, cfg.decorr, perm)[0]
    fwd = kernels.launch_counts()
    got = torch.autograd.grad(aux, hidden)[0]
    bwd = {k: v - fwd[k] for k, v in kernels.launch_counts().items()}
    want = torch.autograd.grad(lm_decorrelation_loss(hidden, cfg.decorr, perm, impl="plain")[0], hidden)[0]
    rel = _max_err(got, want)[0] / float(want.abs().max())
    ph.check(rel <= LOSS_TOL, f"[lmtrain] {tag}: step-0 aux grad wrt hidden rel err {rel:.3g} > {LOSS_TOL}")
    ph.check(bool(torch.isfinite(got).all()), f"[lmtrain] {tag}: non-finite aux grad")
    for name in kernels_fwd:
        ph.check(fwd[name] > 0, f"[lmtrain] {tag}: kernel {name} never launched on the aux's forward pass")
    for name in kernels_bwd:
        ph.check(bwd[name] > 0, f"[lmtrain] {tag}: kernel {name} never launched on the aux's backward pass")
    return rel, fwd, bwd


def _lmtrain_profile(ph, tag, cfg, names, state, step, batches, dev):
    """LMTRAIN_STEPS warmed kernel-route steps under the profiler: median
    step ms (CUDA events), device busy and idle share, each ported kernel's
    device ms, and the aux loss's share of the step's device time (its
    forward + backward alone at the step's shapes, device time, over the
    step's)."""
    import statistics

    import torch

    from repro_torch import kernels
    from repro_torch.core import lm_decorrelation_loss
    from repro_torch.core.permutation import permutation_for_step

    wall, step_ms = [0.0], []

    def run():
        t0 = time.perf_counter()
        s, ev = state, []
        for batch in batches:
            ev.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
            ev[-1][0].record()
            s, _ = step(s, batch)
            ev[-1][1].record()
        torch.cuda.synchronize()
        wall[0] = time.perf_counter() - t0
        step_ms.extend(a.elapsed_time(b) for a, b in ev)

    kernels.reset_launch_counts()
    events = _device_events(run)
    counts = kernels.launch_counts()
    busy_ms = sum(us for _, us in events) / 1e3
    wall_ms = wall[0] * 1e3
    ours = _ported_ms(ph, events, counts, names, f"lmtrain {tag}")
    for name in names:
        ph.check(ours[name][0] > 0, f"[profile] lmtrain {tag}: no device time of {name}")
    line = (f"[profile] lmtrain {tag}: {len(batches)} steps median_step_ms={statistics.median(step_ms):.3f} "
            f"wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / wall_ms:.4f} "
            f"device events={len(events)}")
    if cfg.decorr.enabled:
        kern_ms = sum(ms for ms, _ in ours.values())
        h = torch.randn((*batches[0]["tokens"].shape, cfg.d_model), device=dev, requires_grad=True)
        perm = permutation_for_step(SEED, 0, cfg.d_model).to(dev)
        aux_ms = _device_ms(lambda: torch.autograd.grad(lm_decorrelation_loss(h, cfg.decorr, perm)[0], h), iters=5)
        step_dev = busy_ms / len(batches)
        line += (" | ported kernels ms: " + " ".join(f"{k}={ms:.4f} ({n} device launches)"
                                                     for k, (ms, n) in ours.items())
                 + f" | kernels' share of device time={kern_ms / busy_ms:.3g}"
                 + f" | aux fwd+bwd alone device_ms={_fmt(aux_ms)} per step; share of the step's device time="
                 + ("not measured" if aux_ms is None else f"{aux_ms / step_dev:.3g}"))
    print(line, flush=True)


def _lmtrain_arm(ph, tag, cfg, kernels_fwd, kernels_bwd, dev, batches, smi, profile):
    """One arm: the kernel route's LMTRAIN_STEPS steps (launch counters
    cleared just before, read just after), then (``profile``) a profiled
    window, then the plain route's steps from the same weights and batches.
    Returns ({kernel: launches}, {kernel: backward launches}) of the kernel
    route's steps."""
    import statistics

    import torch

    from repro_torch import kernels

    aux = cfg.decorr.enabled
    _free()
    torch.cuda.reset_peak_memory_stats()
    state, step = _lmtrain_state(cfg, dev, None)
    if aux:
        grad_rel, aux_fwd, aux_bwd = _lmtrain_aux_grad(ph, tag, cfg, state, batches[0], dev, kernels_fwd,
                                                       kernels_bwd)
    kernels.reset_launch_counts()
    k_m, k_ms = _lmtrain_steps(state, step, batches)
    fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in kernels_fwd + kernels_bwd:
        ph.check(fwd[name] > 0, f"[lmtrain] {tag}: kernel {name} never launched in the steps")
    for name in kernels_bwd:
        ph.check(bwd[name] > 0, f"[lmtrain] {tag}: kernel {name} never launched on the steps' backward passes")
    for i, m in enumerate(k_m):
        ph.check(all(math.isfinite(v) for v in m.values()), f"[lmtrain] {tag}: non-finite metrics at step {i}: {m}")
        if cfg.n_experts:
            ph.check(m["moe_aux"] > 0, f"[lmtrain] {tag}: no router-balance loss at step {i}")
    names = tuple(dict.fromkeys(kernels_fwd + kernels_bwd))
    if profile:
        _lmtrain_profile(ph, tag, cfg, names, state, step, batches, dev)
    del state, step
    _free()
    err, plain = {}, ""
    if aux:
        state, step = _lmtrain_state(cfg, dev, "plain")
        p_m, p_ms = _lmtrain_steps(state, step, batches)
        del state, step
        _free()
        for key in ("loss", "decorr_reg"):
            err[key] = _max_rel([m[key] for m in k_m], [m[key] for m in p_m])
            ph.check(err[key] <= LOSS_TOL, f"[lmtrain] {tag}: {key} rel err {err[key]:.3g} > {LOSS_TOL}")
        plain = (f" | kernel vs plain: max loss_rel_err={err['loss']:.3g} decorr_reg_rel_err={err['decorr_reg']:.3g} "
                 f"step-0 aux grad_rel_err={grad_rel:.3g} | median step ms plain={statistics.median(p_ms[1:]):.3f}"
                 f" | a step's aux launches fwd {_nonzero(aux_fwd)} bwd {_nonzero(aux_bwd)}")
    print(
        f"[lmtrain] {tag}: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
        f"batch {batches[0]['tokens'].shape[0]} x seq {batches[0]['tokens'].shape[1]} f32, {len(batches)} steps | "
        f"loss {k_m[0]['loss']:.6g} -> {k_m[-1]['loss']:.6g} ce {k_m[-1]['ce']:.6g} "
        f"moe_aux {k_m[-1]['moe_aux']:.4g} decorr_aux {k_m[-1]['decorr_aux']:.4g} "
        f"grad_norm {k_m[-1]['grad_norm']:.4g} | median step ms kernel={statistics.median(k_ms[1:]):.3f}{plain} | "
        f"launches in {len(batches)} steps {_nonzero(fwd)}, of them on backward passes {_nonzero(bwd)} | "
        f"peak {peak / 2**30:.2f} GiB | {smi}",
        flush=True,
    )
    return fwd, bwd


def phase_lmtrain(ph: Phase, dev):
    """gemma2-2b at full width (LMTRAIN_DEPTH layers) in the four arms, then llama4-scout
    at full width (one layer) with R_sum; returns ({kernel: launches},
    {kernel: backward launches}) of the kernel routes' steps."""
    import torch

    from repro_torch.data import LMDataConfig
    from repro_torch.launch.train import lm_batch_fn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    fwd_total, bwd_total = {}, {}
    runs = [(tag, "gemma2-2b", LMTRAIN_DEPTH, arm, LMTRAIN_BATCH, LMTRAIN_SEQ, True)
            for tag, arm in LMTRAIN_ARMS.items()]
    runs.append(("moe r_sum q=2", LMTRAIN_MOE, LMTRAIN_MOE_DEPTH, LMTRAIN_ARMS["r_sum q=2"], LMTRAIN_MOE_BATCH,
                 LMTRAIN_MOE_SEQ, False))
    for tag, name, depth, (kw, kernels_fwd, kernels_bwd), batch, seq, profile in runs:
        t0 = time.perf_counter()
        cfg = _lmtrain_cfg(name, depth, kw)
        data = LMDataConfig(cfg.vocab_size, batch=batch, seq_len=seq, seed=SEED)
        batch_fn = lm_batch_fn(cfg, data, dev)
        batches = [batch_fn(i) for i in range(LMTRAIN_STEPS)]
        fwd, bwd = _lmtrain_arm(ph, tag, cfg, kernels_fwd, kernels_bwd, dev, batches, smi, profile)
        for k in fwd:
            fwd_total[k] = fwd_total.get(k, 0) + fwd[k]
            bwd_total[k] = bwd_total.get(k, 0) + bwd[k]
        print(f"[lmtrain] {tag}: {time.perf_counter() - t0:.1f}s", flush=True)
    _free()
    torch.cuda.reset_peak_memory_stats()
    return fwd_total, bwd_total

# ---------------------------------------------------------------------------
# phase fsdp: the 2-D (FSDP over data, TP over model) LM train step
# ---------------------------------------------------------------------------

# gemma2-2b at full width, LMTRAIN_DEPTH layers, f32, batch 8 x 128 (phase
# lmtrain's data and schedule), placed by ``place_train_state`` on a (data 1, model 1)
# mesh of one NCCL rank, against the unplaced step from the same weights
FSDP_STEPS = 3
FSDP_ARMS = ("r_sum q=2 b=128", "r_sum q=2", "r_off fused")
# one arm a kind of layer the MoE / recurrent archs add, at full width (f32
# weights; the config's moments, bf16 for llama4 and jamba, as launch/train
# keeps them: f32 moments and the gathered copies of a layer's experts do
# not fit beside each other), the R_sum q = 2 aux, depth cut by
# ``_fsdp_arch_cfg``: (tag, arch, batch, seq).  rwkv6's 128 tokens take
# the chunk-parallel path (``rwkv_chunk`` 64)
FSDP_ARCH_ARMS = (
    ("llama4 moe", "llama4-scout-17b-a16e", LMTRAIN_MOE_BATCH, LMTRAIN_MOE_SEQ),
    ("jamba mamba+moe", "jamba-v0.1-52b", LMTRAIN_MOE_BATCH, LMTRAIN_MOE_SEQ),
    ("rwkv6", "rwkv6-3b", LMTRAIN_BATCH, LMTRAIN_SEQ),
)


def _fsdp_arch_cfg(arch):
    """The FSDP_ARCH_ARMS config of ``arch``: full width, f32, the R_sum
    q = 2 aux; llama4 1 of 48 layers, jamba its first two pattern positions
    (Mamba + dense, Mamba + MoE; ``n_layers=2`` alone would give 0 repeats
    of the 8-layer period), rwkv6 4 of 32 layers."""
    import dataclasses

    kw = LMTRAIN_ARMS["r_sum q=2"][0]
    if arch.startswith("jamba"):
        cfg = _lmtrain_cfg(arch, None, kw)
        return dataclasses.replace(cfg, pattern=cfg.pattern[:2], n_layers=2)
    return _lmtrain_cfg(arch, 1 if arch.startswith("llama4") else 4, kw)


def _worst_param_rel(state, want, dev):
    """(largest |placed - want| over the leaf's largest |want|, its leaf):
    each parameter of the placed ``state`` gathered and each of ``want``
    (host tensors) brought to the card one leaf at a time."""
    worst, worst_name = 0.0, ""
    for name, p in state.model.named_parameters():
        got = state.shardings[name].gather(p.detach())
        ref = want[name].to(dev)
        rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
        del got, ref
    return worst, worst_name


def _fsdp_arm(ph, tag, cfg, batch, seq, kernels_fwd, kernels_bwd, dev, mesh, smi, profile=False, moments=None):
    """One arm: FSDP_STEPS unplaced steps, then as many placed ones from the
    same seeded weights and batches (launch counters cleared just before
    the placed steps, read just after).  Every loss term within 5e-4
    relative, every parameter within 5e-4 of its leaf's largest entry (the
    unplaced run's kept on the host, compared on the card one leaf at a
    time).  ``moments``: AdamW's moment dtype (None: f32).
    Returns the placed steps' ({kernel: launches}, {kernel: backward
    launches})."""
    import statistics

    import torch

    from repro_torch import kernels
    from repro_torch.data import LMDataConfig
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.parallel.fsdp_tp import place_train_state

    batch_fn = lm_batch_fn(cfg, LMDataConfig(cfg.vocab_size, batch=batch, seq_len=seq, seed=SEED), dev)
    batches = [batch_fn(i) for i in range(FSDP_STEPS)]
    runs = {}
    for placed in (False, True):
        _free()
        state, step = _lmtrain_state(cfg, dev, None, moments=moments)
        if placed:
            state = place_train_state(state, mesh)
        kernels.reset_launch_counts()
        metrics, ms = _lmtrain_steps(state, step, batches[:1])
        # the peak of the steady steps, over what the state holds
        torch.cuda.reset_peak_memory_stats()
        m_rest, ms_rest = _lmtrain_steps(state, step, batches[1:])
        metrics, ms = metrics + m_rest, ms + ms_rest
        counts = (kernels.launch_counts(), kernels.backward_launch_counts())
        peak = torch.cuda.max_memory_allocated()
        held = torch.cuda.memory_allocated()  # what the state holds between steps
        if placed:
            ph.check(type(state).__name__ == "ShardedTrainState", f"[fsdp] {tag}: the state was not placed")
            params = _worst_param_rel(state, runs[False][4], dev)
        else:  # on the host: the placed run's peak holds none of it
            params = {k: v.detach().to("cpu", copy=True) for k, v in state.model.named_parameters()}
        runs[placed] = (metrics, ms, counts, peak, params, held)
        if profile:
            _fsdp_profile(tag, "placed" if placed else "unplaced", state, step, batches[-1], smi)
        del state, step
    (u_m, u_ms, _, u_peak, u_params, u_held), (p_m, p_ms, (fwd, bwd), p_peak, worst, p_held) = runs[False], runs[True]
    worst, worst_name = worst
    keys = ("loss", "ce", "moe_aux", "decorr_aux", "decorr_var", "decorr_reg", "grad_norm")
    # a term that is zero unplaced (no MoE layer) must be zero placed
    zero = [k for k in keys if k in u_m[0] and not any(m[k] for m in u_m)]
    for k in zero:
        ph.check(not any(m[k] for m in p_m), f"[fsdp] {tag}: {k} is zero unplaced, not placed")
    ph.check(cfg.n_experts == 0 or "moe_aux" not in zero, f"[fsdp] {tag}: the MoE router loss is zero")
    loss_rel = {k: _max_rel([m[k] for m in p_m], [m[k] for m in u_m]) for k in keys if k in u_m[0] and k not in zero}
    for k, v in loss_rel.items():
        ph.check(v <= LOSS_TOL, f"[fsdp] {tag}: {k} rel err {v:.3g} > {LOSS_TOL}")
    ph.check(worst <= LOSS_TOL, f"[fsdp] {tag}: parameter {worst_name} rel err {worst:.3g} > {LOSS_TOL}")
    for name in kernels_fwd:
        ph.check(fwd[name] > 0, f"[fsdp] {tag}: kernel {name} never launched in the placed steps")
    for name in kernels_bwd:
        ph.check(bwd[name] > 0, f"[fsdp] {tag}: kernel {name} never launched on the placed steps' backward passes")
    for i, m in enumerate(p_m):
        ph.check(all(math.isfinite(v) for v in m.values()), f"[fsdp] {tag}: non-finite metrics at step {i}: {m}")
    n_params = sum(v.numel() for v in u_params.values())
    print(f"[fsdp] {tag}: {cfg.name} {cfg.n_layers} layers ({n_params} parameters) d={cfg.d_model} batch {batch} x "
          f"seq {seq} f32, moments {moments or torch.float32}, {FSDP_STEPS} steps, mesh (data 1, model 1) on one "
          f"NCCL rank | loss {['%.7g' % m['loss'] for m in p_m]} | placed vs unplaced: max rel err "
          f"{ {k: float('%.3g' % v) for k, v in loss_rel.items()} } max param rel err {worst:.3g} ({worst_name}) | "
          f"median step ms placed={statistics.median(p_ms[1:]):.3f} unplaced={statistics.median(u_ms[1:]):.3f} | "
          f"peak allocated bytes of steps 2-{FSDP_STEPS} placed={p_peak} unplaced={u_peak}, allocated after them "
          f"placed={p_held} unplaced={u_held} | launches fwd {_nonzero(fwd)} bwd "
          f"{_nonzero(bwd)} | {smi}", flush=True)
    del runs, u_params
    _free()
    return fwd, bwd


def _fsdp_profile(tag, which, state, step, batch, smi):
    """One more step under the profiler: device busy ms, the NCCL kernels'
    and the copies' device ms, the largest device items."""
    by_name = {}
    for name, us in _device_events(lambda: step(state, batch)):
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    busy = sum(by_name.values())
    nccl = sum(v for k, v in by_name.items() if "nccl" in k.lower())
    copies = sum(v for k, v in by_name.items() if "memcpy" in k.lower() or "copy" in k.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] fsdp {tag} {which}: one step, device busy {busy:.3f} ms, NCCL {nccl:.3f} ms, copies "
          f"{copies:.3f} ms | top { {k[:60]: round(v, 3) for k, v in top} } | {smi}", flush=True)


def phase_fsdp(ph: Phase, dev):
    """The 2-D LM train step (``parallel/fsdp_tp``) on one NCCL rank: gemma2
    in FSDP_ARMS, then FSDP_ARCH_ARMS in turn (each state freed before the
    next); returns the placed steps' ({kernel: launches}, {kernel: backward
    launches})."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for_devices

    smi = _smi()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    fwd_total, bwd_total = {}, {}
    arms = [(tag, _lmtrain_cfg("gemma2-2b", LMTRAIN_DEPTH, LMTRAIN_ARMS[tag][0]), LMTRAIN_BATCH, LMTRAIN_SEQ,
             LMTRAIN_ARMS[tag][1:], tag == FSDP_ARMS[0], None) for tag in FSDP_ARMS]
    for tag, arch, batch, seq in FSDP_ARCH_ARMS:
        cfg = _fsdp_arch_cfg(arch)
        arms.append((tag, cfg, batch, seq, LMTRAIN_ARMS["r_sum q=2"][1:], False, cfg.optimizer_moment_dtype))
    try:
        mesh = make_mesh_for_devices(1, 1)
        for tag, cfg, batch, seq, (kernels_fwd, kernels_bwd), profile, moments in arms:
            t0 = time.perf_counter()
            fwd, bwd = _fsdp_arm(ph, tag, cfg, batch, seq, kernels_fwd, kernels_bwd, dev, mesh, smi, profile,
                                 moments)
            for k in fwd:
                fwd_total[k] = fwd_total.get(k, 0) + fwd[k]
                bwd_total[k] = bwd_total.get(k, 0) + bwd[k]
            print(f"[fsdp] {tag}: {time.perf_counter() - t0:.1f}s", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    _free()
    torch.cuda.reset_peak_memory_stats()
    return fwd_total, bwd_total


# ---------------------------------------------------------------------------
# phase serve2d: the 2-D serving steps (placed params, KV caches split by
# sequence over "model", flash-decoding on paged_attention)
# ---------------------------------------------------------------------------

# (a) gemma2-2b's heads on a decode_32k slot block: 8 slots of a 32768-row
# cache split into 16 blocks of 2048 rows (a rank's rows on the (16, 16) mesh)
SERVE2D_ROWS, SERVE2D_BLOCKS = 32768, 16
SERVE2D_LENS = [32768, 30001, 20480, 16385, 9000, 4097, 2048, 1]
# (b) the placed steps: 8 prompts of 512 tokens into a 4096-row cache, 32
# greedy decode steps; gemma2-2b at full depth, llama4-scout 1 of 48 layers,
# jamba its first 5 pattern positions (Mamba + dense, Mamba + MoE twice, the
# attention at position 4; ~26 GB of f32 weights) and rwkv6-3b 4 of 32 layers
SERVE2D_SLOTS, SERVE2D_PROMPT, SERVE2D_MAX_LEN, SERVE2D_STEPS = 8, 512, 4096, 32
SERVE2D_ARCHS = (("gemma2-2b", None), ("llama4-scout-17b-a16e", 1), ("jamba-v0.1-52b", 5), ("rwkv6-3b", 4))


def _serve2d_blocks(ph, dev, smi):
    """(a) paged_attention on each 2048-row block of a 32768-row bf16 cache
    with its ``start`` and LSE, merged by ``merge_partials``, against the
    plain version over the whole cache; every block's LSE against the plain
    block's.  Returns the timing line's numbers."""
    import torch

    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention.ops import paged_decode_plain
    from repro_torch.parallel.fsdp_tp import merge_partials

    h, kv, hd = PAGED_SHAPE["h"], PAGED_SHAPE["kv"], PAGED_SHAPE["hd"]
    b, rows = len(SERVE2D_LENS), SERVE2D_ROWS // SERVE2D_BLOCKS
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    q = torch.randn(b, h, hd, device=dev, generator=gen)
    k = torch.randn(b, SERVE2D_ROWS, kv, hd, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, SERVE2D_ROWS, kv, hd, device=dev, generator=gen).to(torch.bfloat16)
    lens = torch.tensor(SERVE2D_LENS, dtype=torch.int32, device=dev)
    table = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
    blocks = [(k[:, i * rows:(i + 1) * rows].contiguous(), v[:, i * rows:(i + 1) * rows].contiguous())
              for i in range(SERVE2D_BLOCKS)]
    timed = {}
    for window in (4096, 0):
        kw = dict(scale=PAGED_SHAPE["scale"], softcap=50.0, window=window)
        tag = f"[serve2d] (a) {'local window 4096' if window else 'global'}"
        outs, lses, lse_err = [], [], 0.0
        for i, (kb, vb) in enumerate(blocks):
            out, lse = K.paged_decode_attention(q, kb, vb, table, lens, start=i * rows, return_lse=True, **kw)
            want, want_lse = paged_decode_plain(q, kb, vb, table, lens, start=i * rows, return_lse=True, **kw)
            empty = torch.isinf(want_lse)
            ph.check(bool(torch.equal(torch.isinf(lse), empty)) and bool((out[empty] == 0).all()),
                     f"{tag}: block {i}'s empty slots are not out 0, LSE -inf")
            if bool((~empty).any()):
                err = float((lse - want_lse)[~empty].abs().max()) / max(1.0, float(want_lse[~empty].abs().max()))
                lse_err = max(lse_err, err)
            outs.append(out)
            lses.append(lse)
        whole = paged_decode_plain(q, k, v, table, lens, **kw)
        got = merge_partials(torch.stack(outs), torch.stack(lses))
        err, rel = _max_err(got, whole)
        ph.check(rel <= KERNEL_TOL, f"{tag}: merged blocks vs the whole plain version, rel err {rel:.3g}")
        ph.check(lse_err <= KERNEL_TOL, f"{tag}: a block's LSE vs the plain block's, rel err {lse_err:.3g}")
        print(f"{tag}: {SERVE2D_BLOCKS} blocks of {rows} rows, {b} slots, lens {SERVE2D_LENS}, H {h} / KV {kv}, "
              f"hd {hd}, bf16, softcap 50 | merged vs whole plain: max abs err {err:.3g} rel {rel:.3g} | "
              f"block LSE rel err {lse_err:.3g} | {smi}", flush=True)
        del whole, got
        # the first block at the global layer: every slot but the last live on all its rows
        if not window:
            kb, vb = blocks[0]
            call = lambda: K.paged_decode_attention(q, kb, vb, table, lens, return_lse=True, **kw)  # noqa: E731
            plain = lambda: paged_decode_plain(q, kb, vb, table, lens, return_lse=True, **kw)  # noqa: E731
            stacked = (torch.stack(outs), torch.stack(lses))
            merge = lambda: merge_partials(*stacked)  # noqa: E731
            live = sum(min(n, rows) for n in SERVE2D_LENS)
            nbytes = live * kv * hd * 2 * 2 + q.numel() * 4 + b * h * hd * 4 + b * h * 4
            bound_ms, bound_by = _bound(nbytes, 4.0 * live * h * hd)
            m_bytes = stacked[0].numel() * 4 + stacked[1].numel() * 4 + b * h * hd * 4
            # the library call: compiled flex_attention on the same block,
            # checked on it and on a local layer's block 8 (one compilation)
            lib = _flex_library(q, kb, vb, lens, **kw)
            lib_err = [lib.check()]
            print(f"[serve2d] (a) flex_attention first call {lib.first_s:.1f}s", flush=True)
            mid = SERVE2D_BLOCKS // 2
            lib_err.append(_flex_library(q, *blocks[mid], lens, start=mid * rows,
                                         **dict(kw, window=4096)).check())
            l_err, l_lse = max(e for e, _ in lib_err), max(e for _, e in lib_err)
            ph.check(l_err <= LIB_TOL and l_lse <= LIB_TOL,
                     f"[serve2d] (a) flex_attention vs plain: out rel err {l_err:.3g}, LSE err {l_lse:.3g} > {LIB_TOL}")
            timed = dict(ms=_time_ms(call), dev_ms=_device_ms(call), plain_ms=_time_ms(plain, iters=10),
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=_time_ms(lib), library_dev_ms=_device_ms(lib),
                         merge_ms=_time_ms(merge), merge_dev_ms=_device_ms(merge),
                         merge_bound_ms=_bound(m_bytes, 0.0)[0])
            ph.check(timed["dev_ms"] is not None,
                     "[serve2d] (a) the block call launched paged_attention but shows no device time")
            print(f"[serve2d] (a) block call at decode_32k's rank block (B {b}, H {h} / KV {kv}, hd {hd}, {rows} rows, "
                  f"bf16, start 0, LSE): event ms {timed['ms']:.5f} device ms {_fmt(timed['dev_ms'])} plain ms "
                  f"{timed['plain_ms']:.5f} bound ms {bound_ms:.5f} ({bound_by}) library ms {timed['library_ms']:.5f} "
                  f"device {_fmt(timed['library_dev_ms'])} (flex_attention compiled, bf16 q, block mask from lens / "
                  f"start / window, mask and q cast excluded; vs plain out rel err {l_err:.3g} LSE err {l_lse:.3g}) | "
                  f"merge of {SERVE2D_BLOCKS} blocks: event ms {timed['merge_ms']:.5f} device "
                  f"ms {_fmt(timed['merge_dev_ms'])} bound ms {timed['merge_bound_ms']:.5f} | {smi}", flush=True)
    return timed


def _serve2d_greedy(cfg, params, caches, prompts):
    """Prefill ``prompts`` and decode SERVE2D_STEPS greedy tokens with the
    ``train/serve`` steps; returns (logits of every step (B, V), tokens
    (B, steps + 1), paged_attention launches of the decode steps)."""
    import torch

    from repro_torch import kernels
    from repro_torch.train.serve import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    with torch.no_grad():
        logits, caches = prefill(params, caches, prompts)
        rows = [logits[:, 0].float()]
        toks = [rows[-1].argmax(-1)]
        kernels.reset_launch_counts()
        for j in range(SERVE2D_STEPS):
            logits, caches = decode(params, caches, SERVE2D_PROMPT + j, toks[-1][:, None])
            rows.append(logits.float())
            toks.append(rows[-1].argmax(-1))
        torch.cuda.synchronize()
        launched = kernels.launch_counts()["paged_attention"]
    return rows, torch.stack(toks, dim=1), launched


def _serve2d_steps(ph, dev, mesh, smi):
    """(b) the placed steps against the unplaced ones, SERVE2D_ARCHS in
    turn (each model freed before the next); returns the placed runs'
    paged_attention launches."""
    import torch

    from repro_torch.models import init_caches
    from repro_torch.parallel.fsdp_tp import place_caches, place_params

    launches = 0
    for name, depth in SERVE2D_ARCHS:
        _free()
        t0 = time.perf_counter()
        cfg, params = _arch_model(name, depth, torch.float32, dev, positions=name.startswith("jamba"))
        gen = torch.Generator(device=dev).manual_seed(SEED + 28)
        prompts = torch.randint(0, cfg.vocab_size, (SERVE2D_SLOTS, SERVE2D_PROMPT), device=dev, generator=gen)
        base, base_toks, _ = _serve2d_greedy(cfg, params, init_caches(cfg, SERVE2D_SLOTS, SERVE2D_MAX_LEN, dev),
                                             prompts)
        placed = place_caches(init_caches(cfg, SERVE2D_SLOTS, SERVE2D_MAX_LEN, dev), cfg, mesh)
        rows, toks, launched = _serve2d_greedy(cfg, place_params(params, mesh), placed, prompts)
        tag = f"[serve2d] (b) {name} {cfg.n_layers} layers"
        ph.check(all(getattr(leaf, "placement", None) is not None for leafs in placed.values()
                     for leaf in leafs.values()), f"{tag}: the caches were not placed")
        # a slot's logits are compared up to its first differing token; a
        # difference is allowed only where the unplaced top-2 gap is below
        # twice the logit difference measured before it
        first = [int(torch.nonzero(base_toks[i] != toks[i])[0]) if bool((base_toks[i] != toks[i]).any())
                 else SERVE2D_STEPS + 1 for i in range(SERVE2D_SLOTS)]
        diff = scale = 0.0
        for j, (a, bb) in enumerate(zip(base, rows)):
            keep = [i for i in range(SERVE2D_SLOTS) if j <= first[i]]
            if keep:
                diff = max(diff, float((a[keep] - bb[keep]).abs().max()))
                scale = max(scale, float(a[keep].abs().max()))
        rel = diff / max(1.0, scale)
        ph.check(rel <= LOGIT_TOL, f"{tag}: placed vs unplaced logits rel err {rel:.3g} > {LOGIT_TOL}")
        differ = 0
        for i, t in enumerate(first):
            if t > SERVE2D_STEPS:
                continue
            differ += 1
            top2 = torch.topk(base[t][i], 2).values
            gap = float(top2[0] - top2[1])
            print(f"{tag}: slot {i} first differs at token {t}: unplaced top-2 gap {gap:.4g} vs 2 x logit diff "
                  f"{2 * diff:.4g} -> {'exempt from here on' if gap < 2 * diff else 'FAIL'}", flush=True)
            ph.check(gap < 2 * diff, f"{tag}: slot {i} differs at token {t} with top-2 gap {gap}")
        # the attention layers a step: jamba 1 of 5, rwkv6 none
        want = sum(sp.mixer == "attn" for sp in cfg.pattern) * cfg.repeats * SERVE2D_STEPS
        ph.check(launched == want, f"{tag}: paged_attention launched {launched} times in the placed decode, "
                                   f"not one per attention layer a step ({want})")
        ph.check(all(bool(torch.isfinite(r).all()) for r in rows), f"{tag}: non-finite logits")
        launches += launched
        print(f"{tag} f32, mesh (data 1, model 1) on one NCCL rank: prefill {SERVE2D_SLOTS} x {SERVE2D_PROMPT} into "
              f"{SERVE2D_MAX_LEN} rows, {SERVE2D_STEPS} greedy decode steps | placed vs unplaced logits max abs err "
              f"{diff:.3g} rel {rel:.3g}, slots whose tokens differ {differ} | paged_attention launches {launched} | "
              f"{time.perf_counter() - t0:.1f}s | {smi}", flush=True)
        del params, placed, base, rows
    _free()
    return launches


def phase_serve2d(ph: Phase, dev):
    """(a) the kernel's ``start`` / LSE on a split cache, merged; (b) the
    placed prefill and decode steps at world size 1 (one NCCL rank) against
    the unplaced ones.  Returns {kernel: launches} of (b)'s placed decodes."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for_devices

    smi = _smi()
    _serve2d_blocks(ph, dev, smi)
    _free()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        launched = _serve2d_steps(ph, dev, make_mesh_for_devices(1, 1), smi)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"paged_attention": launched}


# ---------------------------------------------------------------------------
# phase launch: the op-level analyzer (launch/hlo_cost) and the roofline join
# ---------------------------------------------------------------------------

LAUNCH_TRAIN_STEPS = 3
LAUNCH_AUX = "r_sum q=2 b=128"
LAUNCH_DISAGREE_MIN = 0.95  # best measured / analytic bound: below it the analyzer overcounts
LAUNCH_PEAK_TOL = 0.15
LAUNCH_LM_MAX_PROMPT, LAUNCH_LM_MAX_LEN = 512, 1024
LAUNCH_TIMED_CALLS = 3
# (e) and (f) run in processes of their own, one a group of cells (the
# first also runs (f)), started before phase lmtrain (or with phase
# launch when it runs alone), one thread each at a lower priority, beside
# the device-bound phases lmtrain to serve2d: the dry run makes a fake process group of 256 ranks,
# which must not meet this process's groups.  llama4's train_4k cell
# dispatches 7 of its 16 microbatches of 48 layers
# (``launch/dryrun.analyze_cell``), rwkv6's 64 chunks a layer
LAUNCH_CELLS = ((("gemma2-2b", "train_4k"), ("gemma2-2b", "prefill_32k"), ("gemma2-2b", "decode_32k"),
                 ("rwkv6-3b", "long_500k")),
                (("rwkv6-3b", "train_4k"),),
                (("llama4-scout-17b-a16e", "train_4k"), ("llama4-scout-17b-a16e", "decode_32k")))
_LAUNCH_DRYRUN = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun, perf
for arch, shape in json.loads(sys.argv[1]):
    print("DRYRUN " + json.dumps(dryrun.run_cell(arch, shape, False)), flush=True)
if sys.argv[2] == "perf":
    recs = {v: perf.build_and_analyze("gemma2-2b", "train_4k", perf.VARIANTS[v]) for v in ("baseline", "decorr_sum")}
    print("PERF " + json.dumps(recs), flush=True)
"""


# the dry-run processes, when ``main`` starts them ahead of phase launch
_DRYRUN = []


def _launch_dryrun_start():
    """The dry-run processes of (e) and (f), one a group of LAUNCH_CELLS."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", _LAUNCH_DRYRUN, json.dumps(cells), "perf" if i == 0 else "-"],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             preexec_fn=lambda: os.nice(10))
            for i, cells in enumerate(LAUNCH_CELLS)]


def _launch_model_flops(name, train_tokens, n_active, engines):
    """6 N tokens for the train step, 2 N tokens for a serving executable,
    None where no model's tokens are counted (the probe)."""
    if name == "train_step":
        return 6.0 * n_active * train_tokens
    for prefix, tokens in engines:
        if name.startswith(prefix):
            return 2.0 * tokens(name)
    return None


def _launch_rows(ph, tag, perf, expected, smi, model_flops):
    """Gate (a): every expected executable attached and measured, best
    measured time / bound >= LAUNCH_DISAGREE_MIN; print each row."""
    rows = {r["executable"]: r for r in perf.snapshot()}
    ph.check(perf.analyzed == len(expected), f"[launch] {tag}: {perf.analyzed} executables attached, "
                                             f"expected {len(expected)}: {sorted(expected)}")
    for name in sorted(expected):
        r = rows.get(name)
        if r is None or "bound_s" not in r:
            ph.check(False, f"[launch] {tag}: {name} has no measured row with an analysis")
            continue
        ph.check(r["disagreement"] >= LAUNCH_DISAGREE_MIN,
                 f"[launch] {tag}: {name} best measured / bound = {r['disagreement']:.3g} < {LAUNCH_DISAGREE_MIN}")
        mf = model_flops(name)
        print(f"[launch] (a) {tag} {name}: calls {r['calls']} best_ms={r['best_s'] * 1e3:.4f} "
              f"bound_ms={r['bound_s'] * 1e3:.5f} dominant={r['dominant']} utilization={r['roofline_utilization']:.4g} "
              f"disagreement={r['disagreement']:.4g} flops={r['flops']:.6g} hbm_bytes={r['hbm_bytes']:.6g} "
              + (f"model_flops={mf:.6g} flops/model_flops={r['flops'] / mf:.4g}" if mf else "model_flops=-")
              + f" | {smi}", flush=True)


def _launch_time(perf, name, dev, fn):
    """LAUNCH_TIMED_CALLS calls of an executable, each observed by the timer
    (device work included)."""
    for _ in range(LAUNCH_TIMED_CALLS):
        t0 = perf.start()
        fn()
        perf.block(dev)
        perf.observe(name, perf.elapsed(t0))


def _launch_train(ph, dev, smi):
    """(a) launch/train's path (telemetry on, the step attached by
    attach_train_step) for LAUNCH_TRAIN_STEPS steps on gemma2-2b f32 with the
    b = 128 aux; (b) the analyzer's launches of one step against the
    counters of one real step; (c) its peak against the allocator's."""
    import argparse

    import torch

    from repro_torch import kernels
    from repro_torch.data import LMDataConfig
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.obs_args import attach_train_step, build_train_obs
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.train.loop import LoopConfig, run_training

    cfg = _lmtrain_cfg("gemma2-2b", None, LMTRAIN_ARMS[LAUNCH_AUX][0])
    batch_fn = lm_batch_fn(cfg, LMDataConfig(cfg.vocab_size, batch=LMTRAIN_BATCH, seq_len=LMTRAIN_SEQ, seed=SEED), dev)
    _free()
    state, step = _lmtrain_state(cfg, dev, None)
    obs = build_train_obs(argparse.Namespace(metrics_port=None, alerts=True))
    ph.check(attach_train_step(obs, step, state, batch_fn(0)), "[launch] (a) attach_train_step returned False")
    state = run_training(state, step, batch_fn, LoopConfig(total_steps=LAUNCH_TRAIN_STEPS, log_interval=1),
                         registry=obs.registry, perf=obs.perf)
    n_active = cfg.active_param_count()
    _launch_rows(ph, "train", obs.perf, {"train_step"}, smi,
                 lambda name: _launch_model_flops(name, LMTRAIN_BATCH * LMTRAIN_SEQ, n_active, ()))

    batch = batch_fn(LAUNCH_TRAIN_STEPS)
    analysis = hlo_cost.analyze(step, state, batch)
    _free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    counts = _nonzero(kernels.launch_counts())
    peak_raw = torch.cuda.max_memory_allocated()
    ph.check(analysis.kernel_launches == counts,
             f"[launch] (b) train step: analyzer launches {analysis.kernel_launches} != counters {counts}")
    # the step's own high-water mark over what was allocated before it, plus its arguments
    real = peak_raw - before + analysis.argument_bytes
    rel = analysis.peak_bytes / real - 1.0
    ph.check(abs(rel) <= LAUNCH_PEAK_TOL, f"[launch] (c) analyzer peak {analysis.peak_bytes} vs allocator {real}: "
                                          f"{rel:+.3g} outside {LAUNCH_PEAK_TOL}")
    print(f"[launch] (b) train step (aux {LAUNCH_AUX}): analyzer launches {analysis.kernel_launches} | counters of "
          f"one real step {counts}", flush=True)
    print(f"[launch] (c) train step peak: analyzer argument_bytes={analysis.argument_bytes} temp_bytes="
          f"{analysis.temp_bytes} peak={analysis.peak_bytes} | allocator max_memory_allocated={peak_raw} "
          f"allocated before={before} -> step peak {real} | rel {rel:+.4g} | flops={analysis.flops:.6g} "
          f"hbm_bytes={analysis.hbm_bytes:.6g} | {smi}", flush=True)
    launches = dict(counts)
    del state, step, obs
    _free()
    return cfg, batch_fn, launches


def _launch_remat(ph, dev, cfg, batch_fn, smi):
    """(d) the step's loss and gradients with remat on and off (5e-4
    relative, every leaf), the gradient pass's peak and the median step ms
    of each."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.core.permutation import permutation_for_step
    from repro_torch.models import ParamTree, init_params
    from repro_torch.train.step import _lm_loss_fn

    batch = batch_fn(0)
    perm = permutation_for_step(SEED, 0, cfg.d_model).to(dev)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        _free()
        model = ParamTree(init_params(c, seed=SEED, device=dev))
        params = list(model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, metrics = _lm_loss_fn(model.tree(), batch, c, perm)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        kept = torch.cuda.memory_allocated() - base  # at least the gradients: else something was freed
        print(f"[launch] (d) remat={remat}: allocated before the pass {base} | peak over it {peak} | still held "
              f"after it {kept} (its gradients {sum(g.numel() * g.element_size() for g in grads)})", flush=True)
        loss = float(loss.detach())
        # nothing of this pass may outlive it: a later pass's baseline would
        # count it and then see it freed
        del model, params, metrics
        _free()
        state, step = _lmtrain_state(c, dev, None)
        _, ms = _lmtrain_steps(state, step, [batch_fn(i) for i in range(LAUNCH_TRAIN_STEPS)])
        del state, step
        _free()
        out[remat] = (loss, grads, peak, statistics.median(ms))
    (l_on, g_on, p_on, ms_on), (l_off, g_off, p_off, ms_off) = out[True], out[False]
    loss_rel = abs(l_on - l_off) / abs(l_off)
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(g_on, g_off))
    ph.check(loss_rel <= LOSS_TOL, f"[launch] (d) remat loss rel {loss_rel:.3g} > {LOSS_TOL}")
    ph.check(grad_rel <= LOSS_TOL, f"[launch] (d) remat gradient rel {grad_rel:.3g} > {LOSS_TOL}")
    ph.check(p_on < p_off, f"[launch] (d) remat peak {p_on} not below no-remat {p_off}")
    print(f"[launch] (d) remat on / off: loss rel {loss_rel:.3g}, worst leaf gradient rel {grad_rel:.3g} | "
          f"gradient pass peak over the weights {p_on / 2**30:.3f} / {p_off / 2**30:.3f} GiB | median step ms "
          f"{ms_on:.3f} / {ms_off:.3f} (f32, {cfg.n_layers} layers, batch {LMTRAIN_BATCH} x {LMTRAIN_SEQ}, "
          f"aux {LAUNCH_AUX}) | {smi}", flush=True)
    del out, g_on, g_off
    _free()


def _launch_serving(ph, dev, smi):
    """(a) the phase-5 engine (bf16; paged, speculative, chunked) and the
    ssl-paper embedding service with its probe, warmed with a timer, each
    executable timed LAUNCH_TIMED_CALLS times; (b) the analyzer's launches
    of one decode tick against the counters of one real tick."""
    import torch

    from repro_torch import kernels
    from repro_torch.decorr.config import DecorrConfig
    from repro_torch.launch import hlo_cost
    from repro_torch.obs.perf import ExecTimer
    from repro_torch.serve.engine import ContinuousLMEngine, ServeEngine
    from repro_torch.serve.probes import DecorrProbe
    from repro_torch.serve.buckets import bucket_sizes
    from repro_torch.train.ssl import init_ssl_model

    cfg, params = _lm_model(dev, torch.bfloat16)
    eng = ContinuousLMEngine(cfg, params, n_slots=LM_SLOTS, max_len=LAUNCH_LM_MAX_LEN,
                             max_prompt_len=LAUNCH_LM_MAX_PROMPT, paged=True, page_size=LM_PAGE,
                             prefill_chunk=CHUNK_PREFILL, speculative=True, draft_k=DRAFT_K, device=dev)
    eng.perf = perf = ExecTimer()
    buckets = eng.warmup()
    n = eng.pool.n_slots
    nb = eng.pager.blocks_per_slot
    zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
    bt = torch.zeros((n, nb), dtype=torch.int32, device=dev)
    vb = n * (DRAFT_K + 1)
    vzeros = torch.zeros((vb,), dtype=torch.int32, device=dev)
    vbt = torch.zeros((vb, nb), dtype=torch.int32, device=dev)

    analysis = hlo_cost.analyze(eng._decode, eng.params, eng.caches, zeros, zeros[:, None], block_tables=bt,
                                impl=eng.impl)
    kernels.reset_launch_counts()
    eng.step_logits(eng.caches, zeros, zeros, bt, eng.impl)
    torch.cuda.synchronize()
    counts = _nonzero(kernels.launch_counts())
    ph.check(analysis.kernel_launches == counts,
             f"[launch] (b) decode tick: analyzer launches {analysis.kernel_launches} != counters {counts}")
    print(f"[launch] (b) decode tick: analyzer launches {analysis.kernel_launches} | counters of one real tick "
          f"{counts}", flush=True)
    launches = dict(counts)

    for length in buckets:
        toks = torch.zeros((1, length), dtype=torch.int32, device=dev)
        _launch_time(perf, f"prefill_b{length}", dev, lambda: eng._prefill(eng.params, eng._prefill_template(), toks, 1))
    kernels.reset_launch_counts()
    _launch_time(perf, "decode_step", dev, lambda: eng.step_logits(eng.caches, zeros, zeros, bt, eng.impl))
    _launch_time(perf, "verify_step", dev, lambda: eng.step_logits(eng.caches, vzeros, vzeros, vbt, eng.impl))
    for k, v in kernels.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    ctoks = torch.zeros((1, CHUNK_PREFILL), dtype=torch.int32, device=dev)
    _launch_time(perf, "chunk_prefill", dev, lambda: eng._chunk_step(eng.params, eng._chunk_tree, ctoks, 0, 0))
    expected = {f"prefill_b{b}" for b in buckets} | {"decode_step", "verify_step", "chunk_prefill"}
    n_active = cfg.active_param_count()
    per_exec = (("prefill_b", lambda name: n_active * int(name[len("prefill_b"):])),
                ("decode_step", lambda name: n_active * n), ("verify_step", lambda name: n_active * vb),
                ("chunk_prefill", lambda name: n_active * CHUNK_PREFILL))
    _launch_rows(ph, "lm bf16", perf, expected, smi, lambda name: _launch_model_flops(name, 0, 0, per_exec))
    del eng, params
    _free()

    model_cfg, policy = _paper()
    engine = ServeEngine(model_cfg, init_ssl_model(model_cfg, seed=SEED), policy=policy, device=dev)
    engine.perf = sperf = ExecTimer()
    probe = DecorrProbe(DecorrConfig(style="vic", reg="sum", q=2, block_size=128), perm_seed=SEED, device=dev)
    probe.perf = sperf
    engine.warmup()
    probe.warmup(model_cfg.projector_widths[-1])
    sizes = bucket_sizes(policy)
    kernels.reset_launch_counts()
    for b in sizes:
        x = torch.randn((b, model_cfg.input_dim), device=dev)
        for _ in range(LAUNCH_TIMED_CALLS):
            engine.encode(x)
    z = engine.encode(torch.randn((probe.sample_rows or 8, model_cfg.input_dim), device=dev))
    for _ in range(LAUNCH_TIMED_CALLS):
        probe.update(z)
    for k, v in kernels.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    n_params = sum(p.numel() for p in engine.model.parameters())
    _launch_rows(ph, "ssl-paper serve", sperf, {f"embed_b{b}" for b in sizes} | {"probe_update"}, smi,
                 lambda name: 2.0 * n_params * int(name[len("embed_b"):]) if name.startswith("embed_b") else None)
    del engine, probe
    _free()
    return launches


def _launch_dryrun_finish(ph, procs, smi):
    """(e) the dry-run cells and (f) the perf variants, from the subprocesses."""
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            ph.check(False, "[launch] (e) a dry-run process ran past 600 s")
        ph.check(proc.returncode == 0, f"[launch] (e) a dry-run process exited {proc.returncode}: {out[-3000:]}")
        outs.append(out)
    out = "\n".join(outs)
    cells = [json.loads(ln[len("DRYRUN "):]) for ln in out.splitlines() if ln.startswith("DRYRUN ")]
    n_cells = sum(len(group) for group in LAUNCH_CELLS)
    ph.check(len(cells) == n_cells, f"[launch] (e) {len(cells)} dry-run records of {n_cells}")
    for rec in cells:
        tag = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
        ph.check(rec["status"] == "ok", f"[launch] (e) {tag}: {rec['status']} {rec.get('error')}")
        if rec["status"] != "ok":
            print(rec.get("traceback", ""), flush=True)
            continue
        # every cell, train and serving (rwkv6 long_500k too), runs the 2-D
        # step and holds what the specs' layout holds a rank
        ph.check(rec.get("layout") == "2d", f"[launch] (e) {tag}: layout {rec.get('layout')}, not the 2-D step")
        ph.check(rec["memory"]["argument_bytes"] == rec["reference_argument_bytes"],
                 f"[launch] (e) {tag}: 2-D argument bytes {rec['memory']['argument_bytes']} != the specs' "
                 f"{rec['reference_argument_bytes']}")
        roof = {k: (f"{v:.4g}" if isinstance(v, float) else v) for k, v in rec["roofline"].items()}
        print(f"[launch] (e) {tag}: layout {rec.get('layout')} memory {rec['memory']} "
              f"reference_argument_bytes {rec['reference_argument_bytes']} "
              f"fits_80gb {rec['fits_80gb']} | collectives { {k: f'{v:.4g}' for k, v in rec['collectives'].items()} } "
              f"| roofline {roof} | flops {rec['flops']:.6g} model_flops/device {rec['model_flops_per_device']:.6g} "
              f"| kernels {rec['kernel_launches']} | analysis {rec['compile_s']} s", flush=True)
    perf_line = [ln for ln in out.splitlines() if ln.startswith("PERF ")]
    ph.check(len(perf_line) == 1, "[launch] (f) no perf record")
    if perf_line:
        recs = json.loads(perf_line[0][len("PERF "):])
        base, dec = recs["baseline"], recs["decorr_sum"]
        ph.check(dec["flops"] > base["flops"], "[launch] (f) decorr_sum does not add FLOPs to the baseline")
        print(f"[launch] (f) gemma2-2b train_4k baseline vs decorr_sum: flops {base['flops']:.8g} -> "
              f"{dec['flops']:.8g} (+{dec['flops'] - base['flops']:.6g}, {dec['flops'] / base['flops'] - 1:.3g}) | "
              f"bound_s {base['roofline']['bound_s']:.6g} -> {dec['roofline']['bound_s']:.6g} "
              f"({dec['roofline']['bound_s'] / base['roofline']['bound_s'] - 1:+.3g}) | kernels "
              f"{dec['kernel_launches']} | {smi}", flush=True)


def phase_launch(ph: Phase, dev):
    """The launch analysis tools and the roofline join; returns the kernels'
    launches of the real calls it made."""
    smi = _smi()
    procs = list(_DRYRUN) or _launch_dryrun_start()
    launches = {}
    try:
        cfg, batch_fn, counts = _launch_train(ph, dev, smi)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        _launch_remat(ph, dev, cfg, batch_fn, smi)
        for k, v in _launch_serving(ph, dev, smi).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        _launch_dryrun_finish(ph, procs, smi)
    return launches


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch import resolve_device
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to this script ({e})", file=sys.stderr)
        return 1

    dev = resolve_device("cuda")  # also pins TF32 off for cuBLAS and cuDNN
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    ph = Phase()
    built = ph.run("build", build.build_all)
    if built is None:
        return 1
    rows = ph.run("kernels", phase_kernels, ph, dev) or {}
    launches = ph.run("service", phase_service, ph, dev) or {}
    ph.run("profile", phase_profile, ph, dev)
    train_fwd, train_bwd = ph.run("train", phase_train, ph, dev) or ({}, {})
    dist_fwd, dist_bwd = ph.run("dist", phase_dist, ph, dev) or ({}, {})
    obs = ph.run("obs", phase_obs, ph, dev) or {}
    lm = ph.run("lm", phase_lm, ph, dev) or {}
    fabric = ph.run("fabric", phase_fabric, ph, dev) or {}
    tuned = ph.run("tune", phase_tune, ph, dev) or {}
    archs = ph.run("archs", phase_archs, ph, dev) or {}
    # phase launch's dry-run analyses (CPU only, one thread each, niced) run
    # beside the device-bound phases lmtrain to serve2d
    _DRYRUN.extend(_launch_dryrun_start())
    try:
        lmtrain_fwd, lmtrain_bwd = ph.run("lmtrain", phase_lmtrain, ph, dev) or ({}, {})
        fsdp_fwd, fsdp_bwd = ph.run("fsdp", phase_fsdp, ph, dev) or ({}, {})
        serve2d = ph.run("serve2d", phase_serve2d, ph, dev) or {}
        launch = ph.run("launch", phase_launch, ph, dev) or {}
    finally:
        for proc in _DRYRUN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    parts = dict(service=dict(launches), train=train_fwd, dist=dist_fwd, obs=obs, lm=lm, fabric=fabric, tune=tuned,
                 archs=archs, lmtrain=lmtrain_fwd, fsdp=fsdp_fwd, serve2d=serve2d, launch=launch)
    for part in list(parts.values())[1:]:
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    # the kernels line's launches by phase; phase tune's vary from run to
    # run: every candidate it measures launches, and which plans it then
    # tunes follows its measured picks
    print(f"[chip_smoke] launches by phase: { {p: {k: v for k, v in c.items() if v} for p, c in parts.items()} }",
          flush=True)
    for part in (dist_bwd, lmtrain_bwd, fsdp_bwd):
        for k, v in part.items():
            train_bwd[k] = train_bwd.get(k, 0) + v
    for name in REPLACES:
        ph.check(name in rows, f"no timing row for {name}")
        ph.check(launches.get(name, 0) > 0, f"{name} never launched on the main path")
    for name in WITH_KERNEL_BWD:
        ph.check(train_bwd.get(name, 0) > 0, f"{name} never launched on the training path's backward pass")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    ph.check(smi.returncode == 0, "nvidia-smi failed")
    if ph.failures:
        print(f"[chip_smoke] {len(ph.failures)} check(s) failed: {ph.failures}", flush=True)
        return 1
    line = [dict(rows[name], launches=launches[name], launches_bwd=train_bwd.get(name, 0)) for name in REPLACES]
    print(json.dumps({"kernels": line}))
    print(smi.stdout.strip().splitlines()[0])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
