#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the root of the repository

Phases, each timed, none caught and passed over:

1. environment: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions; fails without a CUDA device;
2. build: every CUDA kernel from ``paddle_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once; ptxas's registers and spills of
   every kernel) and the Triton kernel's first compile; the SASS of the
   GEMM kernels (HGMMA and UTMALDG in every Hopper instance) and of
   ``norm_rope.cu`` (128-bit global loads and stores in every vector-path
   instance of K1 and K2), either missing failing the run;
3. kernels: each kernel against its plain PyTorch version on the same CUDA
   tensors, at the serving path's shapes (Llama-2-7B widths) and at GQA,
   ragged, zero-length, int8 and fp32 variants; ``rms_norm`` and
   ``fused_rope`` at every shape the main paths give them (the train
   step's, a serve prefill's, ``generate``'s prefill and decode step),
   each timed with its host time per call, and at hidden 5120, 8192 and
   20, head dim 20 and 16, fp16 and fp32, fp32 weights and tables, a
   strided q view and misaligned rows, each launched twice and held
   bitwise equal; int8 pools of the paged decode kernel under fp16 and
   fp32 queries; LayerNorm at 4096 x 4096
   with and without residual and bias and at a hidden size that is not a
   power of two, the flash forward with dropout, and the two flash
   backward kernels at the training shape (8 x 2048, 8 heads of 128,
   causal) and at GQA (8/2 and 8/1), ragged (700, 2047), Sq < Sk, Sq > Sk,
   head_dim 64 and dropout variants, each launched twice and held bitwise
   equal to itself,
   ``fused_linear_param_grad_add`` at the seven linears of a Llama-2-7B
   layer (4096 tokens) on its Hopper instance (TMA and wgmma) and on its
   mma.sync instance, and ragged, fp32 and bf16/fp16-dweight variants on
   each instance, ``grouped_matmul`` at the ERNIE-MoE "large" expert GEMMs
   (8192 rows, 64 groups of skewed sizes, empty ones included, fp32 and
   bf16 out) on its Hopper and mma.sync instances, its tile schedule as
   the card builds it against ``group_tile_schedule`` and its tile passes,
   fp32 inputs and ragged sizes on each instance (each GEMM case launched
   twice and held bitwise equal), the
   stock-layout ``paged_attention`` at the 7B decode shape (MHA, GQA, soft
   cap) and the head-batched flash route at the training shape (forward
   and backward, bitwise the per-head kernels' result), with the tolerance
   stated; the attention kernels' other instances beside them: fp32 and
   fp16 flash forward and backward (head dims 64, 128 and the zero-padded
   16 and 96), the bf16 flash kernels at head dims 16 and 96, and the
   decode kernels (K4, K7) in fp32 and fp16, at head dims 16 and 96 and at
   a GQA group of 16, and at the edges of their splits of the context
   (rows ending on a split's boundary, shorter than one split, of length 1
   and 0, a capacity no split divides) and at batch 1 over 4096 tokens;
   the flash forward and every decode case are launched twice and held
   bitwise equal to themselves; K3's prefix-chunk instance (chunked
   prefill) at the 7B widths, chunks of 256 of a 700-token prompt into a
   cache of 1024 (offsets 0, 256, 512, the last chunk partial), MHA and GQA
   32/8, bf16, fp16 and fp32: against its plain version, launched twice,
   and its rows bitwise K3 causal's one-shot rows; the same instance at
   the shapes a warm prefix-cache admission gives it (WARM_TAIL: tails
   under one query tile, offsets where the diagonal starts mid-tile, the
   odd offset of a fully cached prompt, an offset clamped to max_len - C),
   held the same way; then each one's time
   beside its bound, its plain version's and a library call's where one
   PyTorch call computes the same function;
4. kernel against plain, end to end: the 7B widths at 2 layers, on the card
   (kernels) and on the CPU (plain versions), same weights and prompts,
   through the paged engine with bf16 and with int8 pools,
   ``CausalLMEngine.generate`` and the dense ``ContinuousBatchingEngine``:
   prefill logits within a stated tolerance; on the card each engine
   warmed (its decode program captured as a CUDA graph), its greedy
   streams bitwise those of the same engine run uncaptured on the card,
   again after ``reset_state()``, with no capture after ``warmup()``; the
   card's streams equal the CPU's up to the first near-tie; then
   ``FusedMultiTransformer`` at the GPT-3 6.7B widths (batch 1 x 128): the
   context pass and 8 ragged decode steps within a stated tolerance of the
   CPU's, and each decode step within it of the card's own context pass at
   that position; chunked prefill and sampling at 2 layers:
   ``CausalLMEngine(prefill_chunk=64)`` and a chunked paged admission
   against the CPU (last logits within the stated tolerance, greedy streams
   up to a near-tie) and against the card's one-shot prefill, a sampled
   ``generate`` and a mixed greedy and sampled paged serve captured against
   uncaptured on the card (bitwise), and one seeded request served alone
   and in a mixed batch (the same tokens); the prefix cache and
   preemption at 2 layers (PREFIX_E2E: warm streams against cold and
   preempted against unpreempted on the card, the card against the CPU);
   speculative decoding at 2 layers (SPEC: the paged engine with bf16 and
   int8 pools and the dense engine, ``draft_k=4``, host, device and
   ``"self"`` modes, and host and device with oracle drafts, the plain
   streams, so that drafts are accepted: captured against uncaptured
   bitwise, spec against plain on the card up to a near-tie, the card
   against the CPU, no capture after warmup, the decode kernel's launches
   W times a layer a verify step); multi-tenant LoRA at 2 layers (LORA:
   the paged engine with bf16 and with int8 pools and the dense engine,
   a bank of rank 16 on every target projection, one batch of a base row,
   a rank-8 adapter zero-padded and a rank-16 one; the adapters hot-loaded
   after ``warmup()`` with no capture and the bank unmoved, captured
   streams bitwise uncaptured, each row bitwise served alone, the base row
   bitwise a LoRA-free engine's, the card against the CPU up to a near-tie
   under the row's adapter, the merged-weights oracle in fp32 within
   MERGED_ATOL (and two faulty merges read above it),
   and speculation in host and device mode with oracle drafts against the
   plain LoRA streams, launches the path's);
   then the training
   configuration's widths at 2 layers, one Layer-API backward and one
   AdamW train step on the card and on the CPU from the same weights and
   batch: loss, gradients and updated parameters within stated
   tolerances; then the card's step once more
   from the same weights with ``FLAGS_flash_head_batched`` on: the route
   taken at every flash forward, and loss, gradients and parameters
   bitwise those of the step without the flag; the eager twin: one
   ``Model.fit`` step (AdamW, LinearWarmup, global-norm clip,
   CrossEntropyLoss) on the card and on the CPU, loss and parameters
   within the training tolerances, and an fp32 model decorated to fp16 at
   O2 stepped under ``auto_cast(O2, float16)`` and a ``GradScaler``
   (batch 1 x 128), then its scaled gradients again with an inf
   injected: the loss within tolerance, the scales [1024, 512] and the
   step skipped on both sides; C-check-1: 30 AdamW steps of
   that 2-layer model on the card and on the CPU from the same weights, a
   fresh batch each step, the per-step loss gap and whether it grows (a
   measurement); then fp32 on the card
   against the CPU (this slice's path, every kernel it runs counted): the
   ``"tiny"`` Llama preset (head dim 16) through its forward, a Layer-API
   backward, one ``build_train_step`` step, ``CausalLMEngine.generate``
   (one-shot and in chunks of 32) and the paged engine's greedy stream,
   and a 2-layer fp32
   ``FusedMultiTransformer`` at the 6.7B widths, each within a stated
   tolerance;
5. serve: the ``"7b"`` preset at full depth (32 layers, bf16, random
   weights from a seeded generator) through
   ``PagedContinuousBatchingEngine.serve``: 8 prompts of 100-700 tokens,
   32 new tokens each, with bf16 pools and again with int8 pools (the
   first token where the int8 streams part from the bf16 ones, and the
   pools' bytes); then the same model through ``CausalLMEngine.generate``
   (8 prompts of 512 tokens, 32 new tokens) and the dense
   ``ContinuousBatchingEngine.serve`` (the paged run's prompts), with the
   first token where the dense and paged streams part; and this slice's
   serves: the paged engine with ``prefill_chunk=256`` serving the same 8
   prompts through the serving scheduler's gap loop (one ``admit_chunk`` of
   the admission in flight, then one ``decode_segment(8)``), greedy (the
   first token where its streams part from the one-shot serve's), then
   sampled (temperature 0.8, top-k 50, top-p 0.95, seed = request index;
   TPOT against the greedy serve); then the serving front over that
   engine (reset, its graphs kept): ``Server(segment_steps=8,
   warmup=True)`` serving the 8 prompts from 8 client threads at once,
   streamed (TTFT and TPOT from the handles beside the gap loop's, the
   first token where its streams part from the gap loop's, no capture
   after warmup, launches held against the path's); ``serve_http`` with
   the monitor on (one unstreamed and one streamed ``POST /generate``,
   equal, ``/healthz``, ``/metrics`` with the device-memory series,
   ``/stats``), then the graphs dropped and a fresh ``Server(warmup=True)``
   capturing them anew while a thread scrapes ``/metrics`` in a loop; and
   the fault leg: the engine behind ``FaultyEngine``, the second decode
   segment failing, one restart, every request finished, its streams
   against the fault-free serve's, the recovery seconds; and the prefix
   and pressure legs: SHARED's 8 prompts sharing a 512-token system
   prefix through an engine with ``prefix_cache=True``, twice (the
   second round resident whole, copy-on-write), counters against the
   traffic's, streams and TTFT against a prefix-off serve; then
   ``Server(admission_mode="optimistic")`` over the cache with
   ``prefill_chunk=256`` at the smallest pool a search finds in which all
   8 finish under preemption, its streams against a reserved engine's;
   and speculative decoding through the serving front: ``Server(
   segment_steps=8, warmup=True, draft_k=4, speculative=True)`` over the
   ``Server`` leg's engine in host and in device mode, with n-gram drafts
   and with oracle drafts (the plain ``Server``'s streams), the 8 prompts
   from 8 client threads: TTFT, TPOT, tokens per forward and the accepted
   share beside the plain ``Server``'s, where the streams part from its
   (failing at a top-2 margin of NEAR_TIE or more), K4's launches a
   verify step held at layers x W; and this slice's path, multi-tenant
   LoRA through the serving front (LORA_SERVER: the chunked engine with a
   bank of 4 slots of rank 16 on q/k/v/o, ``Server(segment_steps=8,
   warmup=True)``, three adapters loaded through ``Server.load_adapter``):
   base traffic alone (its streams the plain ``Server``'s, its TPOT the
   bank's cost), then the 8 prompts from 8 client threads, 2 base and 2
   under each adapter, a fourth adapter hot-loaded and one in use unloaded
   (deferred, freed after the drain) while they decode (TTFT, TPOT and
   tokens/s beside the plain ``Server``'s, launches the path's), each
   adapter request alone against its mixed stream up to a near-tie,
   ``serve_http``'s ``/adapters/unload``, ``/adapters/load`` from an npz
   and ``/generate`` naming the adapter, ``/healthz``'s ``lora`` block; no
   capture after warmup; then the LoRA ops of one decode step captured and
   timed, their kernels counted.
   Each engine is built, then
   ``warmup()``-ed (``warmup(8)``: greedy and sampled segments;
   ``generate``'s engine ``warmup(batch=8)``: greedy and sampled steps),
   then runs: its decode programs replay captured CUDA graphs, the capture
   count must not move over the run, and every kernel's launch count over
   it (each replay credited with the launches
   its graph holds) is held against the count the path implies; the
   captures, their seconds and their pools' bytes are recorded;
6. train: the repo's training configuration (``bench.py``: llama 350m with
   8 heads of 128, 24 layers, bf16, batch 8 x 2048, full recompute, AdamW
   lr 1e-4, clip 1.0) through ``build_train_step``, one warm-up step and
   ``TRAIN_STEPS`` timed ones on one batch made from ``--seed``: step time,
   tokens/s, MFU and peak memory; the loss must be finite at every step and
   fall; every kernel's launch count over the timed steps is held against
   the count the path implies; then one more step with
   ``FLAGS_flash_head_batched`` on, timed, its launch and route counts
   held against the path's;
6b. the eager training surface, this slice's main path: phase 6's
   configuration through ``Model(model).prepare(AdamW(LinearWarmup),
   ClipGradByGlobalNorm, CrossEntropyLoss)`` and ``fit`` over 4 seeded
   batches (step 0 warms up; step time, tokens/s and peak memory beside
   phase 6's; every kernel's launches over the 3 timed steps held against
   the path's; the optimizer's step alone, device and host ms; under
   ``--profile`` the device busy share of a ``train_batch``); a
   ``Model.save`` before step 3 loaded into a fresh model and optimizer,
   whose step 3 must be bitwise the uninterrupted one's (else the cause
   is recorded); ``MixPrecisionLayer`` + ``MixPrecisionOptimizer(AdamW)``
   for 2 steps against the plain AdamW from the same weights (fp32
   main_grad and masters, bf16 parameters, losses within a bf16 step);
   ``build_train_step`` under remat "full", "attn_out" and "dots" from
   one set of weights, loss and gradients against "full"'s, flash
   forwards (2 L, L, 2 L), peak memory and step time each;
7. fused transformer: ``incubate.nn.FusedMultiTransformer`` at the GPT-3
   6.7B widths (``FMT``: hidden 4096, 32 layers, 32 heads, FFN 16384,
   bf16): a 512-token context pass of batch 8 into caches of 1024, then
   ``FMT["steps"]`` decode steps at ragged ``seq_lens``; every output
   finite, launch counts held against the path's;
8. kernel ops, this slice's main path: the JAX package's public kernel ops
   at full widths, through the port's entry points: the main-gradient
   accumulation of one Llama-2-7B decoder layer's seven linears
   (``fused_linear_param_grad_add``), the expert FFN of an ERNIE-MoE
   "large" layer on 4096 routed tokens (two ``grouped_matmul``), one
   decode step of the 7B model's 32 layers through the stock
   ``paged_attention`` and one attention forward and backward at the
   training shape under ``FLAGS_flash_head_batched``; launch and route
   counts held against the path's, K9 and K10 on their Hopper instances,
   outputs finite and held against the plain versions.

The line before the last is a JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``. ``--record PATH`` also
writes a longer record (every comparison, every serve statistic) there.

``--serve-times TREE`` runs only phase 5's serves and ``generate`` with the
package of the checkout at TREE, each engine warmed as that checkout
allows, and prints one JSON line of TTFT, TPOT and decode tokens/s. Four
options only time kernels of the checkout at TREE, in a process of their
own, and print one JSON line: ``--paged-decode-times TREE`` (K4
and K7 at the serve shape and at batch 1 over 4096 tokens),
``--flash-bwd-times TREE`` (K5, K6 and K3 at the training shape),
``--gemm-times TREE`` (K9 at the seven linears of a 7B layer, K10 at the
MoE up and down GEMMs with fp32 and with bf16 out) and
``--norm-rope-times TREE`` (K1 and K2 at every main-path shape: device
time and host time per call). Run
for a parent and a change in turns (parent, change, change, parent), each
in a fresh process, they compare two trees on one card. ``--lora-times``
runs only the LoRA legs (phase 4's at 2 layers, then a plain ``Server``
and phase 5's LoRA ``Server`` leg twice at 7B) and prints one JSON line:
their readings and their spread in one process.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234                     # dropout seed of the kernel checks
PRESET = "7b"                   # the model whose widths the serve phases use
# the training configuration (bench.py:117-124) and its batch
TRAIN = dict(preset="350m", overrides=dict(
    dtype="bfloat16", num_attention_heads=8, num_key_value_heads=8,
    max_position_embeddings=2048, recompute="full"),
    batch=8, seq=2048, lr=1e-4, clip=1.0)
TRAIN_STEPS = 3                 # timed steps after one warm-up step
TRAIN_E2E = dict(layers=2, batch=1, seq=512)   # phase 4's card-vs-CPU step
# phase 6b, the eager training surface at the training configuration:
# Model.fit over `batches` batches (step 0 warms up), LinearWarmup over
# `warmup_steps` from lr / 10, AdamW's weight decay, the Model.save before
# step `save_after` that a fresh model resumes from, `mix_steps` steps of
# main-gradient mixed precision, and the remat policies held against "full"
EAGER = dict(batches=4, warmup_steps=2, weight_decay=0.01, save_after=2,
             mix_steps=2, remat=("full", "attn_out", "dots"))
# phase 4's eager twin: the fp16 O2 step's initial loss scale (fp16
# gradients of a loss near 10 scaled by 2^10 stay far from fp16's 65504)
# and its sequence: the CPU side's fp16 GEMMs ran at about 0.8 GFLOP/s on
# the card's host (21 s for one 512 x 1024 x 32000 product; the whole
# step at 512 tokens took 118 s of CPU time), so the fp16 step takes 128
# tokens of each row; the bf16 step keeps TRAIN_E2E's 512
EAGER_E2E = dict(scale=1024.0, fp16_seq=128)
# phase 5's dense-cache runs on the 7B model: CausalLMEngine.generate on
# GEN["batch"] prompts of GEN["plen"] tokens, and the dense engine's slots
GEN = dict(batch=8, plen=512, new=32, max_len=1024)
DENSE = dict(max_batch=8, max_len=1024)
# chunked prefill at the 7B widths (phases 3 and 5): chunks of 256 tokens
# into the paged engine's dense mini cache of max_len = 1024 rows; phase 3
# cuts a prompt of 700 tokens (chunks at 0, 256, 512, the last one 188 real
# rows); phase 4 runs chunks of 64 at 2 layers
PREFIX = dict(chunk=256, cache=1024, prompt=700, e2e_chunk=64)
# K3's prefix-chunk instance at warm prefix-cache tails (phase 3): (offset,
# tail bucket width, prompt length) into the mini cache of PREFIX["cache"]
# rows — a tail under one 64-row query tile at a tile-aligned offset (the
# 512-token system prefix of phase 5's prefix leg), offsets at a page
# boundary inside a tile (528, 608, 544), the odd offset plen - 1 of a fully
# cached prompt (one real row), and an offset clamped to max_len - C
WARM_TAIL = ((512, 16, 528), (528, 32, 550), (527, 16, 528),
             (608, 64, 700), (544, 128, 630), (768, 256, 900),
             (512, 64, 576))
WARM_TAIL_TIMED = (512, 64, 576)
# phase 5's prefix and pressure legs: 8 prompts sharing one seeded system
# prefix of 512 tokens, with seeded suffixes of 16-200 tokens; 32 new tokens
# a request in the prefix leg, 192 in the pressure leg, whose pool search
# steps by PRESSURE_STEP pages at most PRESSURE_TRIES times. 64 new tokens
# cannot preempt there: an admission needs its whole claim free (the shared
# 32 pages included) but takes only its private pages, so at least 32 pages
# stay free behind it, and 8 requests grow by at most 3 pages each over 64
# tokens
SHARED = dict(prefix=512, suffix=(16, 200), new=32, pressure_new=192,
              seed=5)
PRESSURE_STEP = 8
PRESSURE_TRIES = 8
# phase 4's prefix and pressure legs at 2 layers: a 48-token shared prefix,
# 4 suffixes, pages of 8 tokens, 8 new tokens; under pressure 24 new tokens
# in a pool of 27 pages (one preemption: the page history does not depend
# on the weights; the fewest decode steps of the pools and budgets that
# preempt, since the CPU side's time is most of phase 4's)
PREFIX_E2E = dict(prefix=48, suffixes=(9, 20, 30, 14), page=8, new=8,
                  pressure_new=24, pool=27)
# speculative decoding (phase 4 at 2 layers, phase 5's Server at 7B): the
# draft window (verify steps of draft_k + 1 tokens); phase 4 runs every
# engine in each (spec_mode, spec_draft) pair and, on the CPU, the first
SPEC = dict(draft_k=4, modes=(("host", "ngram"), ("device", "ngram"),
                              ("device", "self")))
# phase 5's sampled serve (and phase 4's sampled runs): each request's seed
# is its index
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.95)
# multi-tenant LoRA. Phase 4 at 2 layers of the 7B widths: every target
# projection, a bank of rank 16 with 3 slots, one adapter of rank 8 (zero
# padded) and one of rank 16 (alpha 16: scales 2 and 1) beside a base row
# in one batch of 3 prompts. Phase 5 at 32 layers: the reference's default
# targets q/k/v/o, a bank of rank 16 with 4 slots (about 168 MB), adapters
# of rank 16. Factors are seeded normals of std ``scale``: at the 7B widths
# a delta of about a third of its projection's output, so adapter streams
# part from the base ones
LORA = dict(targets=("q", "k", "v", "o", "gate", "up", "down"), rank=16,
            capacity=3, ranks=(8, 16), alpha=16, scale=0.04, seed=17,
            prompts=(100, 37, 64), new=8)
# lora_op_cost: eager steps of the LoRA ops profiled (after a warm-up one)
LORA_PROFILE_STEPS = 4
LORA_SERVER = dict(targets=("q", "k", "v", "o"), rank=16, capacity=4,
                   alpha=16, seed=23,
                   adapters=(None, None, "a0", "a0", "a1", "a1", "a2", "a2"))
# phase 5's /metrics scraper beside a Server's warmup: a scrape every 10 ms
# (back to back, each scrape's host time, about 2.6 ms on the 7B serve's
# registry, holds the GIL the scheduler thread's capture needs)
SCRAPE_PAUSE_S = 0.01
# C-check-1 (phase 4): train steps of the 2-layer bf16 model, card and CPU
DRIFT_STEPS = 30
# GPT-3 6.7B widths (paddle_tpu/models/gpt.py:54, preset "6b7": hidden
# 4096, 32 layers, 32 heads, FFN 4 x hidden) as a FusedMultiTransformer,
# with phase 7's batch, context, cache length and decode steps
FMT = dict(hidden=4096, layers=32, heads=32, ffn=16384, batch=8, context=512,
           max_len=1024, steps=32)
FMT_E2E = dict(layers=2, batch=1, seq=128, steps=8)   # phase 4's twin
# phase 4's fp32 path: the "tiny" Llama preset (hidden 64, 2 layers, 4
# heads of 16, vocab 256, fp32 by default), a batch for the forward,
# backward and train step, and prompts for generate and the paged engine
F32 = dict(preset="tiny", batch=2, seq=64, prompts=(40, 23), new=8)
# phases 3 and 8: fused_linear_param_grad_add at the seven linears of one
# decoder layer of the PRESET model over a batch of 8 x 512 tokens
GRAD_ADD_TOKENS = (8, 512)
# ERNIE-MoE "large" (paddle_tpu/models/ernie.py:56-61: hidden 1024, 64
# experts, FFN 4 x hidden) routing 4096 tokens to 2 experts each: 8192 rows
MOE = dict(hidden=1024, ffn=4096, experts=64, top_k=2, tokens=4096)
# the stock-layout paged_attention at the serve shape of the paged_decode
# row (pools [Hkv, pages, page, D]), pages_per_compute_block 8, and the
# soft cap of its capped case; phase 8 decodes one step of all layers
# K4's serve batch in phase 3 (8 rows, page 16, up to 1024 tokens, one
# dead row) over a pool of 512 pages
PAGED = dict(page=16, max_pages=64, pages=512,
             lens=[1024, 900, 733, 512, 300, 129, 17, 0])
# K4's and K7's split-edge cases (phase 3): at the serve shape's capacity
# of 1024 and at one no split divides (K7: S = 700; K4: 44 pages of 16),
# rows of the lengths edge_lens() takes from each case's own split plan
SPLIT_EDGE_CAPS = {"decode_mha": (1024, 700), "paged_decode": (1024, 704)}
# the batch-1 case of K4 and K7 (phase 3, timed): Llama-2's context
BATCH1_CTX = 4096
STOCK = dict(page=16, pages=512, pages_per_seq=64, ppcb=8, soft_cap=5.0,
             lens=[1024, 900, 733, 512, 300, 129, 17, 0])

# H100 SXM data-sheet peaks (dense): HBM bandwidth, bf16 tensor cores, and
# fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# kernel-vs-plain tolerances on the card, |kernel - plain| <= atol + rtol *
# |plain|. Both sides compute in fp32 and round once to bf16 at the end;
# they differ by the order of fp32 sums (and FMA contraction), so an output
# may land on the neighbouring bf16 value, which is at most 2^-7 of it
# away: that is rtol. atol only covers outputs near zero, so it is set per
# kernel well under the size of its outputs: rms_norm and fused_rope give
# values near 1, the attention kernels values near 0.05 over ~1k keys,
# where a dropped page or key tile, or P.V summed in bf16, moves an output
# by more than 1e-3 (paged_decode's worst case within 2^-7 above was
# 2.4e-4 at bf16 and int8, flash_fwd's 3.9e-3 at outputs near 0.5).
BF16_STEP = 2.0 ** -7
# the suffix of each dtype's entry point
ENTRY = {"torch.bfloat16": "bf16", "torch.float16": "f16",
         "torch.float32": "f32"}
# K3 and its plain version round P to bf16 before P.V, at the running max
# of each 64-key tile, as the JAX kernel does. Where the two sides' fp32
# scores differ in the last ulps (sums in another order), that rounding can
# land on neighbouring bf16 values of one P: an output moves by up to a
# bf16 step of its own size or of a neighbour's. The plain version in fp32
# shows the same against itself in fp64 (42 elements of 16.7M past the
# limit at the training shape, 43 for the kernel against fp64, 61 for the
# kernel against the plain version; at most 1.5e-5 of the elements over 13
# shapes, max 0.0078 at outputs near 1; measured on an H100), so such
# flips are no fault. So flash_fwd's limit holds for all but a share of 1e-4 of
# the elements, and every element is within 2^-5: a wrong mask, scale, tile
# or head mapping moves whole rows of outputs of order 0.05-1.
# The flash backward kernels and their plain version run the same
# arithmetic on the same bf16 inputs, lse and delta, with identical dropout
# masks (the hash is exact), and round dS and P_drop to bf16 before the
# second products, as the JAX kernels do. Where the two sides' fp32 dS (or
# P_drop) differ in the last ulps, which the cancellation in dP - delta
# makes common, that rounding can land on neighbouring bf16 values: one
# term of one sum moves by 2^-8 of itself, and a small output by up to
# dozens of its own bf16 steps. The plain version in fp32 shows the same
# against itself evaluated in fp64 (85, 49 and 27 elements of dq, dk and dv
# past flash_fwd's limit at the training shape, up to 0.0156), so such
# flips are no fault. So flash_fwd's limit holds for all but a share of
# 1e-3 of the elements (up to 1.8e-4 measured), and every element is
# within 2^-5 (0.0156 measured, at outputs up to 5.7): a wrong mask, scale,
# tile or head mapping moves whole rows or tiles of gradients of order
# 0.01-1, which neither bound lets through.
# decode_mha is held as paged_decode (the same fp32 online softmax over
# ~1k keys, outputs near 0.05, where a skipped tile or a wrong kv head moves
# an output by more than 1e-3); its fp32 case has the same limit, far above
# the fp32 sum-order error. fused_layer_norm is held as rms_norm (outputs
# near 1 after normalization; a wrong mean, variance or padded lane moves
# them by far more than one bf16 step).
# fused_linear_param_grad_add and grouped_matmul sum products of bf16
# inputs, exact in fp32, in fp32 over T = 4096 or K = 1024-4096 terms;
# with unit inputs the outputs are of order sqrt(T) = 64 (up to about 300),
# and the two sides' sums, in other orders, differ by a few fp32 ulps of the
# partial sums per element: the largest of 16-45M outputs came to 2.1e-3 on
# the card, so atol is 1e-2. A bf16 accumulator (2^-9 of a running sum near
# 60 at each of 128 chunks, about 1 in all), a dropped chunk of 32 T or K
# terms (about 6) or rows multiplied by another group's weights (about 40)
# miss it by two orders of magnitude or more. grouped_matmul's bf16 output:
# one bf16 step. The stock paged_attention runs K4 and the head-batched
# route K3/K5/K6: their limits.
TOL = {"rms_norm": dict(atol=1e-3, rtol=BF16_STEP),
       "fused_rope": dict(atol=1e-3, rtol=BF16_STEP),
       "flash_fwd": dict(atol=1e-4, rtol=BF16_STEP, outside=1e-4,
                         cap=2.0 ** -5),
       "paged_decode": dict(atol=1e-4, rtol=BF16_STEP),
       "flash_bwd_dq": dict(atol=1e-4, rtol=BF16_STEP, outside=1e-3,
                            cap=2.0 ** -5),
       "flash_bwd_dkv": dict(atol=1e-4, rtol=BF16_STEP, outside=1e-3,
                             cap=2.0 ** -5),
       "decode_mha": dict(atol=1e-4, rtol=BF16_STEP),
       "fused_layer_norm": dict(atol=1e-3, rtol=BF16_STEP),
       "grad_add": dict(atol=1e-2, rtol=1e-5),
       "grouped_matmul": dict(atol=1e-2, rtol=1e-5),
       "grouped_matmul_bf16": dict(atol=1e-3, rtol=BF16_STEP),
       "paged_attention": dict(atol=1e-4, rtol=BF16_STEP),
       "flash_hb": dict(atol=1e-4, rtol=BF16_STEP, outside=1e-4,
                        cap=2.0 ** -5)}
# K3's prefix-chunk instance runs K3's arithmetic (its rows are bitwise K3
# causal's), so it is held to K3's limit
TOL["flash_fwd_prefix"] = TOL["flash_fwd"]
LSE_ATOL = 1e-3                 # fp32 log-sum-exp, a few fp32 ulps of work
# end to end (phase 4): bf16 activations on both sides, matmuls accumulated
# in another order on the card than on the CPU; logits near 5-8 resolve to
# 2^-5 in bf16 and two layers of such rounding reach a few steps
LOGIT_ATOL = 0.125
NEAR_TIE = 2 * LOGIT_ATOL       # top-2 margin under which greedy may flip
# LoRA's merged-weights oracle (phase 4), fp32 on both sides: W x + B (A x)
# against (W + B A) x sums the same products in another order, a few fp32
# ulps of each sum (logits near 5-8 through two layers: about 1e-4); the
# faults it must catch (a wrong scale, a target left out) move the logits
# by units, as LoRA itself does
MERGED_ATOL = 1e-2
# FusedMultiTransformer end to end (phase 4), bf16 on both sides: outputs
# are the residual stream (|x| up to ~6 at 2 layers, std ~1.2), where a
# bf16 step is 2^-5; two layers of bf16 rounding in another order reach a
# few steps (bf16 against fp32 on the CPU differs by up to 0.05 at these
# widths), so four steps
FMT_ATOL = 0.125
# training end to end (phase 4), bf16 on both sides. The loss (about
# ln 32000 = 10.4) is an fp32 mean of bf16 logits that differ by a few bf16
# steps of 2^-5 in either direction, which average out: 2e-2 absolute.
# Gradients: every product rounds to bf16 on both sides in another order,
# a relative error of a few 2^-8 per element that partly averages over a
# tensor; 2e-2 of each gradient's norm. Parameters after one AdamW step at
# lr 1e-4: an element moves by at most about lr (1 + weight decay), and
# where the two gradients differ in sign it can move the other way, so
# 2.5 lr plus one bf16 step of the parameter (rtol 2^-7).
TRAIN_LOSS_ATOL = 2e-2
TRAIN_GRAD_RTOL = 2e-2
TRAIN_PARAM_ATOL = 2.5 * TRAIN["lr"]
# fp32 end to end (phase 4): both sides compute in fp32 (the card's matmuls
# with TF32 off), in other orders, so results differ by a few fp32 ulps of
# the partial sums: about 1e-6 relative. Logits and the loss: 1e-4, which
# a bf16 rounding anywhere on the path (2^-8 relative) or a dropped key
# would exceed at the tiny model's logits; gradients: 1e-4 of each
# gradient's norm; parameters after one AdamW step: 5% of lr (lr m / (sqrt
# v + eps) turns a 1e-6 relative gradient difference into up to ~1e-2 of lr
# where |g| is within a few eps of zero), as the CPU tests hold them; the
# FMT residual stream (|x| up to ~6): 1e-3. Greedy streams may part only at
# a top-2 margin under 1e-3.
F32_ATOL = 1e-4
F32_GRAD_RTOL = 1e-4
F32_PARAM_ATOL = 0.05 * TRAIN["lr"]
F32_NEAR_TIE = 1e-3
FMT_F32_ATOL = 1e-3

REPLACES = {
    "rms_norm": "paddle_tpu/ops/pallas_kernels.py:67",
    "fused_rope": "paddle_tpu/ops/pallas_kernels.py:245",
    "flash_fwd": "paddle_tpu/ops/flash_attention_kernel.py:331",
    "flash_fwd_prefix": "paddle_tpu/ops/pallas.py:167",
    "paged_decode": "paddle_tpu/ops/paged_attention.py:268",
    "flash_bwd_dq": "paddle_tpu/ops/flash_attention_kernel.py:497",
    "flash_bwd_dkv": "paddle_tpu/ops/flash_attention_kernel.py:519",
    "decode_mha": "paddle_tpu/ops/pallas_kernels.py:368",
    "fused_layer_norm": "paddle_tpu/ops/pallas_kernels.py:144",
    "grad_add": "paddle_tpu/ops/pallas_kernels.py:439",
    "grouped_matmul": "paddle_tpu/ops/pallas.py:231",
    "flash_hb": "paddle_tpu/ops/flash_attention_hb.py:167",
    "paged_attention": "paddle_tpu/ops/pallas.py:216",
}
SOURCES = {
    "rms_norm": ("cuda", "paddle_tpu_torch/csrc/norm_rope.cu"),
    "fused_rope": ("cuda", "paddle_tpu_torch/csrc/norm_rope.cu"),
    "flash_fwd": ("cuda", "paddle_tpu_torch/csrc/flash_fwd.cu"),
    "flash_fwd_prefix": ("cuda", "paddle_tpu_torch/csrc/flash_fwd.cu"),
    "paged_decode": ("cuda", "paddle_tpu_torch/csrc/paged_decode.cu"),
    "flash_bwd_dq": ("cuda", "paddle_tpu_torch/csrc/flash_bwd.cu"),
    "flash_bwd_dkv": ("cuda", "paddle_tpu_torch/csrc/flash_bwd.cu"),
    "decode_mha": ("cuda", "paddle_tpu_torch/csrc/decode_mha.cu"),
    "fused_layer_norm": ("triton", "paddle_tpu_torch/ops/fused_kernels.py"),
    "grad_add": ("cuda", "paddle_tpu_torch/csrc/grad_add.cu"),
    "grouped_matmul": ("cuda", "paddle_tpu_torch/csrc/grouped_matmul.cu"),
}
# the routes onto kernels of another row (their calls, not launches)
ROUTE_SOURCES = {
    "flash_hb": ("cuda", "paddle_tpu_torch/ops/flash_attention_hb.py"),
    "paged_attention": ("cuda", "paddle_tpu_torch/ops/paged_attention.py"),
}
SPEC_PATHS = ("server_spec_host", "server_spec_device",
              "server_spec_oracle_host", "server_spec_oracle_device")
PATHS = ("serve", "serve_int8", "generate", "dense_serve", "serve_chunked",
         "serve_sampled", "server", "serve_prefix",
         "server_pressure") + SPEC_PATHS + ("server_lora", "train", "fmt",
                                             "train_hb", "ops", "f32",
                                             "eager_fit")
# this slice's path: the multi-tenant LoRA Server's mixed serve at 7B
# (phase 5), which runs K1, K2, K3 (one-shot and prefix-chunk) and K4
SLICE_PATHS = ("server_lora",)
# earlier slices' paths, in the order their counts stand in for a kernel
# this slice does not run: the decode paths, which run K4 and K7 (phase 5's
# through captured graphs), the chunked and sampled serves, the serving
# front's Server serve, the prefix-cache and memory-pressure legs, the
# speculative Server serves and FMT (K8); then training, the eager
# Model.fit steps among it (K5, K6); then the kernel ops (K9, K10)
EARLIER_PATHS = (("serve", "serve_int8", "generate", "dense_serve",
                  "serve_chunked", "serve_sampled", "server",
                  "serve_prefix", "server_pressure") + SPEC_PATHS
                 + ("fmt",), ("eager_fit", "train", "f32"),
                 ("ops", "train_hb"))
ROUTE_PATHS = ("ops", "train_hb")           # the paths that take the routes


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


SPIN_CYCLES = 4_000_000        # about 2 ms of GPU clock


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Device time of one call: the median of ``reps`` calls, each between
    two CUDA events. Each call is queued behind a GPU spin of about 2 ms,
    so the host has enqueued the whole call before the device reaches it
    and the events time the device's work, not the host's launch latency
    (which the serve phase measures end to end)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
        torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def bound(nbytes: float, flops: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of their type."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_close(torch, name, got, want, atol, rtol, outside=0.0,
                cap=None) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|
    holds for all but a share ``outside`` of the elements and every
    element is within ``cap`` (where given)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    share, worst = bad.float().mean().item(), err.max().item()
    if share > outside or (cap is not None and worst > cap):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version at "
            f"{int(bad.sum())} elements ({share:.2g} of them, {outside:g} "
            f"allowed), max |err| {worst:.3g} (atol {atol}, rtol {rtol}, "
            f"cap {cap})")
    if outside:
        log(f"  {name}: {int(bad.sum())} elements ({share:.2g}) past atol "
            f"+ rtol |plain|, max |err| {worst:.3g} (cap {cap:g})")
    return worst


# -- phase 3: kernels against their plain versions ---------------------------


def kernel_phase(torch, dev, np):
    import torch.nn.functional as F

    from paddle_tpu_torch import llama_config, ops

    g, randn = seeded_randn(torch, dev)
    bf = torch.bfloat16
    mc = llama_config(PRESET)
    H, NH, D = mc.hidden_size, mc.num_attention_heads, mc.head_dim
    GQA = NH // 4                      # 32 query heads over 8 kv heads
    rows = {}          # name -> record for the JSON line
    cases = []         # every comparison made

    norm_rope_cases(torch, ops, F, randn, rows, cases, mc, dev)

    # K3 flash forward: prefill buckets (causal MHA), GQA 32/8, ragged
    # lengths (700, and 2047, which cuts the last tile of queries and of
    # keys), queries fewer than keys, a non-causal case, dropout 0.1 (the
    # kernel and the plain version draw the same mask from the seed); then
    # the other instances: head dims 16 and 96 (zero-padded to 64 and 128
    # around the kernel), fp16 and fp32 (flash_f32.cu) at 128, 64 and 16.
    # Each is launched twice and must give bitwise-equal results.
    f32, f16 = torch.float32, torch.float16
    peak = {bf: BF16_FLOPS, f16: BF16_FLOPS, f32: FP32_FLOPS}
    for sq, sk, hkv, causal, p, d, dt in [
            (128, 128, NH, True, 0.0, D, bf), (512, 512, NH, True, 0.0, D, bf),
            (1024, 1024, NH, True, 0.0, D, bf),
            (512, 512, GQA, True, 0.0, D, bf),
            (700, 700, NH, True, 0.0, D, bf),
            (2047, 2047, NH, True, 0.0, D, bf),
            (100, 300, GQA, True, 0.0, D, bf),
            (200, 200, NH, False, 0.0, D, bf),
            (512, 512, NH, True, 0.1, D, bf),
            (300, 700, GQA, False, 0.1, D, bf),
            (256, 300, 2, True, 0.1, 16, bf),
            (256, 300, GQA, True, 0.0, 96, bf),
            (512, 512, NH, True, 0.0, D, f32),
            (300, 700, GQA, False, 0.1, 64, f32),
            (130, 130, 2, True, 0.0, 16, f32),
            (512, 512, NH, True, 0.0, D, f16),
            (700, 700, GQA, True, 0.1, D, f16),
            (256, 300, 2, True, 0.0, 16, f16)]:
        q = randn(1, sq, NH, d, dtype=dt)
        k = randn(1, sk, hkv, d, dtype=dt)
        v = randn(1, sk, hkv, d, dtype=dt)
        out, lse = ops.flash_attention_bshd(q, k, v, causal, None, p, SEED)
        again = ops.flash_attention_bshd(q, k, v, causal, None, p, SEED)
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError("flash_fwd: two launches gave different "
                                 "results")
        ref, lse_ref = ops.flash_attention_bshd_ref(q, k, v, causal, None, p,
                                                    SEED)
        tag = (f"Sq={sq} Sk={sk} Hkv={hkv} D={d} {str(dt)[6:]} "
               f"causal={causal} dropout={p}")
        err = check_close(torch, f"flash_fwd {tag}", out, ref,
                          **TOL["flash_fwd"])
        check_close(torch, f"flash_fwd lse {tag}", lse, lse_ref, LSE_ATOL,
                    0.0)
        cases.append(("flash_fwd", tag, err))
        if (sq, hkv, causal, p, d) != (512, NH, True, 0.0, D):
            continue
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) \
            * q.element_size() + lse.numel() * 4
        flops = 4 * D * causal_pairs(sq, sk) * NH
        timed = dict(shape=tag, ms=time_ms(torch, lambda: ops.
                                           flash_attention_bshd(
                                               q, k, v, causal=True)),
                     plain_ms=time_ms(torch, lambda: ops.
                                      flash_attention_bshd_ref(
                                          q, k, v, causal=True), reps=5))
        bms, by = bound(nbytes, flops, peak[dt])
        if dt != bf:        # another instance, with its own bound
            entry = f"flash_fwd_{ENTRY[str(dt)]}"
            rows["flash_fwd"]["instances"][entry] = dict(
                **timed, bound_ms=bms, bound_by=by, max_abs_err=err)
            continue
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        rows["flash_fwd"] = dict(
            **timed, bound_ms=bms, bound_by=by,
            library_ms=time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)),
            instances={})

    prefix_cases(torch, ops, F, randn, rows, cases, NH, D, dev)
    warm_tail_cases(torch, ops, F, randn, rows, cases, NH, D, dev)
    flash_bwd_cases(torch, ops, F, randn, rows, cases)

    # K4 paged decode: the serving batch, GQA 32/8, and int8 pools; each
    # decode case is launched twice and must give bitwise-equal results
    table, lens, k4_cases = paged_decode_inputs(torch, g, randn, dev, NH, D)
    lens_l, b = PAGED["lens"], len(PAGED["lens"])
    for hkv, int8, q, kp, vp, sc in k4_cases:
        out = twice(torch, "paged_decode", lambda: ops.paged_decode_mha(
            q, kp, vp, table, lens, *sc))
        ref = ops.paged_decode_mha_ref(q, kp, vp, table, lens, *sc)
        tag = f"B={b} Hkv={hkv} {'int8' if int8 else 'bf16'} lens={lens_l}"
        err = check_close(torch, f"paged_decode {tag}", out, ref,
                          **TOL["paged_decode"])
        if out[-1].abs().max().item() != 0.0:
            raise AssertionError("paged_decode: a zero-length row must "
                                 "return zeros")
        cases.append(("paged_decode", tag, err))
        if hkv == NH and not int8:
            tokens = sum(lens_l)
            nbytes = (tokens * hkv * D * 2 * 2 + 2 * q.numel() * 2
                      + table.numel() * 4 + b * 4)
            bms, by = bound(nbytes, 4 * D * tokens * NH, BF16_FLOPS)
            rows["paged_decode"] = dict(
                shape=tag,
                ms=time_ms(torch, lambda: ops.paged_decode_mha(
                    q, kp, vp, table, lens)),
                plain_ms=time_ms(torch, lambda: ops.paged_decode_mha_ref(
                    q, kp, vp, table, lens), reps=5),
                bound_ms=bms, bound_by=by, library_ms=None, instances={})
    paged_instance_cases(torch, ops, randn, rows, cases, table, lens, NH, D)
    paged_edge_cases(torch, ops, g, randn, rows, cases, dev, NH, D)
    decode_mha_cases(torch, ops, F, randn, rows, cases, NH, D, dev)
    layer_norm_cases(torch, ops, F, randn, rows, cases, H)
    grad_add_cases(torch, ops, randn, rows, cases, mc)
    grouped_matmul_cases(torch, np, ops, randn, rows, cases, dev)
    stock_paged_cases(torch, ops, rows, cases, dev, NH, D)
    hb_route_cases(torch, ops, F, randn, rows, cases)
    for name in rows:
        rows[name]["max_abs_err"] = max(e for n, _, e in cases if n == name)
    for name, tag, err in cases:
        log(f"  {name:13s} {tag:66s} max|kernel-plain| {err:.3g} "
            f"(atol {TOL[name]['atol']:g}, rtol {TOL[name]['rtol']:.3g})")
    return rows, cases


def prefix_cases(torch, ops, F, randn, rows, cases, NH, D, dev):
    """K3's prefix-chunk instance at the chunked serve's shape (7B widths,
    batch 1, chunks of PREFIX["chunk"] into a cache of PREFIX["cache"]
    rows): a prompt of PREFIX["prompt"] tokens in chunks at 0, 256 and 512
    (the last one partial, its pad rows' K/V written as the engine writes
    them), MHA and GQA 32/8, in bf16, fp16 and fp32. Each chunk is launched
    twice (bitwise), held against its plain version at K3's limit, and its
    real rows must be bitwise the rows of K3 causal over the whole prompt
    (the one-shot prefill) on the card. Timed at the last chunk (offset
    512: 256 queries, 188 of them the prompt's, over 768 keys) in each
    dtype, MHA, beside its bound (the chunk's causal pairs), its plain
    version and SDPA with the boolean mask over [C, pos + C]."""
    c, w, n = PREFIX["chunk"], PREFIX["cache"], PREFIX["prompt"]
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    peak = {bf: BF16_FLOPS, f16: BF16_FLOPS, f32: FP32_FLOPS}
    for dt in (bf, f16, f32):
        for hkv in (NH, NH // 4):
            q = randn(1, n, NH, D, dtype=dt)
            k = randn(1, n, hkv, D, dtype=dt)
            v = randn(1, n, hkv, D, dtype=dt)
            one, _ = ops.flash_attention_bshd(q, k, v, causal=True)
            kc = randn(1, w, hkv, D, dtype=dt)     # rows past n: pad K/V
            vc = randn(1, w, hkv, D, dtype=dt)
            kc[:, :n], vc[:, :n] = k, v
            for pos in range(0, n, c):
                r = min(c, n - pos)
                qc = randn(1, c, NH, D, dtype=dt)
                qc[:, :r] = q[:, pos:pos + r]
                at = torch.tensor(pos, dtype=torch.int32, device=dev)
                out = twice(torch, "flash_fwd_prefix",
                            lambda: ops.prefix_chunk_attention(qc, kc, vc,
                                                               at))
                ref = ops.prefix_chunk_attention_ref(qc, kc, vc, at)
                tag = (f"C={c} pos={pos} rows={r} W={w} Hkv={hkv} D={D} "
                       f"{str(dt)[6:]}")
                err = check_close(torch, f"flash_fwd_prefix {tag}", out,
                                  ref, **TOL["flash_fwd_prefix"])
                if not torch.equal(out[:, :r], one[:, pos:pos + r]):
                    raise AssertionError(
                        f"flash_fwd_prefix {tag}: the chunk's rows differ "
                        f"from K3 causal's one-shot rows")
                cases.append(("flash_fwd_prefix", tag, err))
                if pos + c < n or hkv != NH:
                    continue        # timed: the last chunk, MHA
                nbytes = (2 * qc.numel() + 2 * (pos + c) * hkv * D) \
                    * qc.element_size()
                flops = 4 * D * causal_pairs(c, pos + c) * NH
                bms, by = bound(nbytes, flops, peak[dt])
                timed = dict(
                    shape=tag, bound_ms=bms, bound_by=by, max_abs_err=err,
                    bitwise_one_shot=True,
                    ms=time_ms(torch, lambda: ops.prefix_chunk_attention(
                        qc, kc, vc, at)),
                    plain_ms=time_ms(torch, lambda: ops.
                                     prefix_chunk_attention_ref(
                                         qc, kc, vc, at), reps=5))
                if dt != bf:
                    rows["flash_fwd_prefix"]["instances"][
                        f"flash_fwd_prefix_{ENTRY[str(dt)]}"] = timed
                    continue
                qt = qc.transpose(1, 2)
                kt, vt = (t[:, :pos + c].transpose(1, 2) for t in (kc, vc))
                mask = (torch.arange(pos + c, device=dev)[None, :]
                        <= pos + torch.arange(c, device=dev)[:, None])
                timed["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask))
                rows["flash_fwd_prefix"] = dict(**timed, instances={})


def warm_tail_cases(torch, ops, F, randn, rows, cases, NH, D, dev):
    """K3's prefix-chunk instance at the shapes a warm prefix-cache
    admission gives it (the tail of a prompt whose head is resident, at the
    tail's bucket width ``C`` and the device offset ``pos``, into the
    ``max_len`` = PREFIX["cache"] rows of the engine's mini cache):
    WARM_TAIL's (pos, C, prompt length) cases — chunks smaller than one
    64-row query tile, offsets where the diagonal starts mid-tile, the odd
    offset plen - 1 of a fully cached prompt (one real row), and the offset
    clamped to max_len - C — MHA and GQA 32/8, in bf16, fp16 and fp32. Each
    launched twice (bitwise), held against its plain version at K3's limit,
    and its real rows bitwise the rows of K3 causal over the whole prompt
    (the cold one-shot prefill). WARM_TAIL_TIMED, bf16 MHA, is timed beside
    its bound, its plain version and SDPA with the boolean mask."""
    w = PREFIX["cache"]
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    for dt in (bf, f16, f32):
        for hkv in (NH, NH // 4):
            for pos, c, n in WARM_TAIL:
                r = min(c, n - pos)
                q = randn(1, n, NH, D, dtype=dt)
                k = randn(1, n, hkv, D, dtype=dt)
                v = randn(1, n, hkv, D, dtype=dt)
                one, _ = ops.flash_attention_bshd(q, k, v, causal=True)
                kc = randn(1, w, hkv, D, dtype=dt)   # rows past n: junk
                vc = randn(1, w, hkv, D, dtype=dt)
                kc[:, :n], vc[:, :n] = k, v
                qc = randn(1, c, NH, D, dtype=dt)
                qc[:, :r] = q[:, pos:pos + r]
                at = torch.tensor(pos, dtype=torch.int32, device=dev)
                out = twice(torch, "flash_fwd_prefix",
                            lambda: ops.prefix_chunk_attention(qc, kc, vc,
                                                               at))
                ref = ops.prefix_chunk_attention_ref(qc, kc, vc, at)
                tag = (f"warm tail C={c} pos={pos} rows={r} W={w} "
                       f"Hkv={hkv} D={D} {str(dt)[6:]}")
                err = check_close(torch, f"flash_fwd_prefix {tag}", out,
                                  ref, **TOL["flash_fwd_prefix"])
                if not torch.equal(out[:, :r], one[:, pos:pos + r]):
                    raise AssertionError(
                        f"flash_fwd_prefix {tag}: the tail's rows differ "
                        f"from K3 causal's one-shot rows")
                cases.append(("flash_fwd_prefix", tag, err))
                if (pos, c, n) != WARM_TAIL_TIMED or dt != bf \
                        or hkv != NH:
                    continue
                nbytes = (2 * qc.numel() + 2 * (pos + c) * hkv * D) \
                    * qc.element_size()
                flops = 4 * D * causal_pairs(c, pos + c) * NH
                bms, by = bound(nbytes, flops, BF16_FLOPS)
                qt = qc.transpose(1, 2)
                kt, vt = (t[:, :pos + c].transpose(1, 2) for t in (kc, vc))
                mask = (torch.arange(pos + c, device=dev)[None, :]
                        <= pos + torch.arange(c, device=dev)[:, None])
                rows["flash_fwd_prefix"]["instances"][
                    "flash_fwd_prefix_bf16 warm tail"] = dict(
                    shape=tag, bound_ms=bms, bound_by=by, max_abs_err=err,
                    bitwise_one_shot=True,
                    ms=time_ms(torch, lambda: ops.prefix_chunk_attention(
                        qc, kc, vc, at)),
                    plain_ms=time_ms(torch, lambda: ops.
                                     prefix_chunk_attention_ref(
                                         qc, kc, vc, at), reps=5),
                    library_ms=time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask)))


def host_us(torch, fn, n=200, rounds=5, warmup=10) -> float:
    """Host time of one call: ``n`` calls back to back, no synchronize
    between them, the wall clock over them / n, after a warm-up; the
    median of ``rounds`` such runs. Where the device takes longer than the
    host per call, the launch queue fills and this reads the device's time
    instead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per_call.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def kernel_ms(torch, fn, n=50, windows=3) -> float:
    """Device time of one call as ``torch.profiler`` reads it: the kernels'
    own time, summed over ``n`` calls, / n; the median over ``windows``
    such profiles of those that recorded the most kernels (a profile now
    and then comes back with some of the device's events missing). It
    leaves out what ``time_ms`` counts besides the kernels (the device's
    start of each launch between the two events; ``floor_ms`` measures
    it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []           # (kernels recorded, ms a call)
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
                count += e.count
        seen.append((count, us / n / 1e3))
    most = max(c for c, _ in seen)
    return statistics.median(ms for c, ms in seen if c == most)


def floor_ms(torch, dev) -> float:
    """``time_ms`` of a kernel that does nothing of note (one element
    incremented): what the events count besides the work."""
    one = torch.zeros(1, device=dev)
    return time_ms(torch, lambda: one.add_(1.0), reps=50)


def rope_tables(torch, s, d, dtype, dev):
    """RoPE tables cos, sin [s, d/2] (theta 10000), the model's formula."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=dev) / d))
    f = torch.outer(torch.arange(s, dtype=torch.float32, device=dev), inv)
    return torch.cos(f).to(dtype), torch.sin(f).to(dtype)


def main_tables(torch, n, d, dev):
    """K2's tables on a main path: rows [0, n) of bf16 tables of 2048
    positions, or row 700 alone (a decode step's)."""
    c, sn = rope_tables(torch, 2048, d, torch.bfloat16, dev)
    off = 700 if n == 1 else 0
    return c[off:off + n], sn[off:off + n]


def norm_rope_shapes(mc):
    """K1's and K2's shapes on the main paths, ``(name, shape)`` and
    ``(name, x shape, table rows)``: the train step (TRAIN's widths and
    batch; K2's backward runs the same shape with -sin), a serve prefill
    of 512 tokens and ``generate``'s prefill of GEN's batch (PRESET's
    widths), and a decode step of that batch (K2: ``generate``'s, one
    table row that every row shares). The first of each list after the
    train step, the prefill, is the row phase 3 reports."""
    tc = train_config(importlib.import_module(
        "paddle_tpu_torch").llama_config)
    b, s = TRAIN["batch"], TRAIN["seq"]
    h, nh, d = mc.hidden_size, mc.num_attention_heads, mc.head_dim
    gb, gp = GEN["batch"], GEN["plen"]
    k1 = [("train", (b, s, tc.hidden_size)), ("prefill", (1, 512, h)),
          ("generate_prefill", (gb, gp, h)), ("decode", (gb, 1, h))]
    k2 = [("train", (b, s, tc.num_attention_heads, tc.head_dim), s),
          ("prefill", (1, 512, nh, d), 512), ("decode", (gb, 1, nh, d), 1)]
    return k1, k2


def rms_bound(x, w):
    t = x.numel()
    return bound(2 * t * x.element_size() + w.numel() * w.element_size(),
                 4 * t, FP32_FLOPS)


def rope_bound(x, c):
    return bound(2 * x.numel() * x.element_size()
                 + 2 * c.numel() * c.element_size(), 3 * x.numel(),
                 FP32_FLOPS)


def norm_rope_cases(torch, ops, F, randn, rows, cases, mc, dev):
    """K1 and K2 against their plain versions: every main-path shape of
    norm_rope_shapes (timed: device time, bound, plain version, library
    call, host time per call), then the other widths and forms: K1 at
    hidden 5120 and 8192 (two warps a row), fp32 at 4096 and 5120 (two and
    four), hidden 20 (element-wise), the tiny preset's fp32 64, fp16, fp32
    weights under bf16 x, rows of a wider tensor (a row stride of 2 H) and
    rows one element off alignment (element-wise); K2 at the prefill's GQA
    k and buckets 128 and 1024, the backward's -sin, a q view of a fused
    [1, 512, 48, 128] projection (strides of 48 heads), head dim 20
    (element-wise), the tiny preset's fp32 head dim 16, fp16, fp32 tables
    under bf16 x. Each case is launched twice and must be bitwise equal;
    each names the path rms_norm_kernel_for / rope_kernel_for chose."""
    fk = importlib.import_module("paddle_tpu_torch.ops.fused_kernels")
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    k1, k2 = norm_rope_shapes(mc)
    H = mc.hidden_size

    def rms_case(tag, x, w, timed=None):
        x2 = x.reshape(-1, x.shape[-1])
        path = fk.rms_norm_kernel_for(x.dtype, x2.shape[0], x.shape[-1],
                                      x2.stride(0),
                                      (x2.data_ptr(), w.data_ptr()))
        out = twice(torch, "rms_norm", lambda: ops.rms_norm(x, w, 1e-5))
        err = check_close(torch, f"rms_norm {tag}", out,
                          ops.rms_norm_ref(x, w, 1e-5), **TOL["rms_norm"])
        cases.append(("rms_norm", f"{tag} {str(x.dtype)[6:]} {path}", err))
        if timed is None:
            return
        bms, by = rms_bound(x, w)
        lib = (time_ms(torch, lambda: F.rms_norm(x, (x.shape[-1],), w, 1e-5))
               if hasattr(F, "rms_norm") else None)
        r = dict(shape=f"x {list(x.shape)} {str(x.dtype)[6:]} {path}",
                 ms=time_ms(torch, lambda: ops.rms_norm(x, w, 1e-5)),
                 kernel_ms=kernel_ms(torch, lambda: ops.rms_norm(x, w,
                                                                 1e-5)),
                 plain_ms=time_ms(torch, lambda: ops.rms_norm_ref(x, w,
                                                                  1e-5)),
                 bound_ms=bms, bound_by=by, library_ms=lib,
                 host_us=host_us(torch, lambda: ops.rms_norm(x, w, 1e-5)),
                 max_abs_err=err)
        if timed == "prefill":
            rows["rms_norm"] = dict(r, instances={})
        else:
            rows["rms_norm"]["instances"][timed] = r

    def rope_case(tag, x, c, sn, timed=None):
        xs = [st if n > 1 else 0 for n, st in zip(x.shape[:3], x.stride())]
        path = fk.rope_kernel_for(
            x.dtype, c.dtype if c.dtype == x.dtype else f32, tuple(x.shape),
            xs, [t.stride(0) if t.shape[0] > 1 else 0 for t in (c, sn)],
            (x.data_ptr(), c.data_ptr(), sn.data_ptr()))
        out = twice(torch, "fused_rope", lambda: ops.fused_rope(x, c, sn))
        err = check_close(torch, f"fused_rope {tag}", out,
                          ops.fused_rope_ref(x, c, sn), **TOL["fused_rope"])
        cases.append(("fused_rope", f"{tag} {str(x.dtype)[6:]} {path}", err))
        if timed is None:
            return
        bms, by = rope_bound(x, c)
        r = dict(shape=f"x {list(x.shape)} {str(x.dtype)[6:]}, tables "
                       f"{list(c.shape)} {path}",
                 ms=time_ms(torch, lambda: ops.fused_rope(x, c, sn)),
                 kernel_ms=kernel_ms(torch, lambda: ops.fused_rope(x, c,
                                                                   sn)),
                 plain_ms=time_ms(torch, lambda: ops.fused_rope_ref(x, c,
                                                                    sn)),
                 bound_ms=bms, bound_by=by, library_ms=None,
                 host_us=host_us(torch, lambda: ops.fused_rope(x, c, sn)),
                 max_abs_err=err)
        if timed == "prefill":
            rows["fused_rope"] = dict(r, instances={})
        else:
            rows["fused_rope"]["instances"][timed] = r

    # main-path shapes, the prefill first (the row), then the others
    for name, shape in sorted(k1, key=lambda c: c[0] != "prefill"):
        x = randn(*shape, scale=2.0)
        w = randn(shape[-1], scale=0.1) + 1.0
        rms_case(f"{name} {list(shape)}", x, w, timed=name)
        del x
    for shape, dt in [((1, 128, H), bf), ((1, 1024, H), bf),
                      ((1, 300, H), bf), ((4, 64, 5120), bf),
                      ((2, 16, 8192), bf), ((4, 8, 4096), f32),
                      ((4, 8, 5120), f32), ((3, 7, 20), bf),
                      ((2, 64, 64), f32), ((8, 1, H), f16)]:
        x = randn(*shape, scale=2.0, dtype=dt)
        rms_case(f"{list(shape)}", x,
                 randn(shape[-1], scale=0.1, dtype=dt) + 1.0)
    x = randn(1, 512, H, scale=2.0)
    rms_case("[1, 512, H] fp32 weights", x,
             randn(H, scale=0.1, dtype=f32) + 1.0)
    wide = randn(64, 2 * H, scale=2.0)
    w = randn(H, scale=0.1) + 1.0
    rms_case("rows of a [64, 2 H] tensor", wide[:, :H], w)
    rms_case("rows one element off alignment", wide[:, 1:H + 1], w)

    for name, shape, n_tab in sorted(k2, key=lambda c: c[0] != "prefill"):
        x = randn(*shape)
        c, sn = main_tables(torch, n_tab, shape[-1], dev)
        rope_case(f"{name} {list(shape)}", x, c, sn, timed=name)
        if name == "train":
            rope_case(f"{name} backward (-sin) {list(shape)}", x, c, -sn)
        del x
    nh, d = mc.num_attention_heads, mc.head_dim
    for shape, dt, tab_dt in [((1, 512, nh // 4, d), bf, bf),
                              ((1, 128, nh, d), bf, bf),
                              ((1, 1024, nh, d), bf, bf),
                              ((2, 33, 4, 20), bf, bf),
                              ((2, 64, 4, 16), f32, f32),
                              ((1, 512, nh, d), f16, f16),
                              ((1, 64, nh, d), bf, f32)]:
        x = randn(*shape, dtype=dt)
        c, sn = rope_tables(torch, shape[1], shape[-1], tab_dt, dev)
        rope_case(f"{list(shape)} tables {str(tab_dt)[6:]}", x, c, sn)
    qkv = randn(1, 512, nh + nh // 2, d)
    c, sn = rope_tables(torch, 512, d, bf, dev)
    rope_case(f"q view [1, 512, {nh}, {d}] of a fused "
              f"[1, 512, {nh + nh // 2}, {d}]", qkv[:, :, :nh], c, sn)


def norm_rope_times(tree: str) -> dict:
    """K1 and K2 of the checkout at ``tree`` at each main-path shape of
    norm_rope_shapes: the device time of one call (``_ms``: the median of
    50, each between two events behind the 2 ms spin; ``_kernel_ms``: the
    kernels' own time as the profiler reads it), the host time per call
    (``_host_us``: host_us) and the largest difference from that
    checkout's plain version; and ``floor_ms``, what the events read for a
    kernel that does nothing of note. Only the wrappers' public signatures
    are used, so a parent tree runs it as well. Run for two checkouts in
    turns, each in a fresh process, it compares them on one card."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from paddle_tpu_torch import llama_config, ops

    dev = torch.device("cuda")
    _, randn = seeded_randn(torch, dev)
    res = {"tree": os.path.abspath(tree), "card": smi_line()}
    k1, k2 = norm_rope_shapes(llama_config(PRESET))

    def timed(key, fn, ref):
        res[f"{key}_max_abs_err"] = (fn().float() - ref().float()).abs(
        ).max().item()
        res[f"{key}_ms"] = time_ms(torch, fn, reps=50)
        res[f"{key}_kernel_ms"] = kernel_ms(torch, fn)
        res[f"{key}_host_us"] = host_us(torch, fn)

    res["floor_ms"] = floor_ms(torch, dev)
    for name, shape in k1:
        x = randn(*shape, scale=2.0)
        w = randn(shape[-1], scale=0.1) + 1.0
        timed(f"rms_norm_{name}", lambda: ops.rms_norm(x, w, 1e-5),
              lambda: ops.rms_norm_ref(x, w, 1e-5))
    for name, shape, n_tab in k2:
        x = randn(*shape)
        c, sn = main_tables(torch, n_tab, shape[-1], dev)
        timed(f"fused_rope_{name}", lambda: ops.fused_rope(x, c, sn),
              lambda: ops.fused_rope_ref(x, c, sn))
    return res


def twice(torch, name, fn):
    """``fn()`` launched twice; the two results must be bitwise equal (the
    kernels use no atomics). Returns the first."""
    out = fn()
    if not torch.equal(out, fn()):
        raise AssertionError(f"{name}: two launches gave different results")
    return out


def split_of(ops, batch, hkv, group, ctx, unit=64):
    """(tokens per split, splits): the plan the K4/K7 wrappers take."""
    return ops.decode_attention.split_plan(batch, hkv, group, ctx,
                                           torch_sm_count(), unit)


def split_tag(ops, batch, hkv, group, ctx, unit=64) -> str:
    return "split {}x{}".format(*split_of(ops, batch, hkv, group, ctx, unit))


def edge_lens(split: int, cap: int) -> list:
    """8 row lengths at the edges of splits of ``split`` tokens over a
    capacity ``cap``: the capacity, two splits and one (on boundaries), one
    past and one short of a boundary, half a split, 1 and 0."""
    return [min(cap, n) for n in (cap, 2 * split, split, split + 1,
                                  split - 1, split // 2, 1, 0)]


def torch_sm_count() -> int:
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def seeded_randn(torch, dev, seed=SEED):
    """(generator, randn): ``randn(*shape, dtype=bf16, scale=1.0)`` draws
    from the generator on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)
    return g, randn


def paged_table(torch, g, dev, lens_l, max_pages, num_pages):
    """A page table [B, max_pages] of distinct pages in a random order up
    to each length, -1 past it, and the lengths as a tensor."""
    ps = PAGED["page"]
    perm = torch.randperm(num_pages, generator=g, device=dev).int()
    table = torch.full((len(lens_l), max_pages), -1, dtype=torch.int32,
                       device=dev)
    nxt = 0
    for r, n in enumerate(lens_l):
        k_pages = -(-n // ps)
        table[r, :k_pages] = perm[nxt:nxt + k_pages]
        nxt += k_pages
    return table, torch.tensor(lens_l, dtype=torch.int32, device=dev)


def paged_decode_inputs(torch, g, randn, dev, nh, d):
    """K4's serve-shape inputs: the page table and lengths of PAGED's
    batch (pages in a random order), then ``(hkv, int8, q, k_pool, v_pool,
    scales)`` for MHA, GQA nh/(nh/4) and int8 pools with scales."""
    ps, maxp, num_pages = PAGED["page"], PAGED["max_pages"], PAGED["pages"]
    b = len(PAGED["lens"])
    table, lens = paged_table(torch, g, dev, PAGED["lens"], maxp, num_pages)
    cases = []
    for hkv, int8 in [(nh, False), (nh // 4, False), (nh, True)]:
        q = randn(b, nh, d)
        if int8:
            kp = torch.randint(-127, 128, (num_pages, ps, hkv, d),
                               generator=g, device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, (num_pages, ps, hkv, d),
                               generator=g, device=dev, dtype=torch.int8)
            sc = (randn(num_pages, hkv, dtype=torch.float32).abs() + 0.1,
                  randn(num_pages, hkv, dtype=torch.float32).abs() + 0.1)
        else:
            kp = randn(num_pages, ps, hkv, d)
            vp = randn(num_pages, ps, hkv, d)
            sc = ()
        cases.append((hkv, int8, q, kp, vp, sc))
    return table, lens, cases


def paged_instance_cases(torch, ops, randn, rows, cases, table, lens, nh,
                         d_full):
    """K4's other instances on the serve batch's page table: fp32 query
    and pools at head dim 128 (timed against the fp32 bound) and 16, fp16
    at 128 (timed) and 96, and bf16 at head dims 16 (its tile at width 32,
    lanes past 16 masked) and 96 (width 128), with GQA groups of 16 (two
    blocks per kv head) and 4; head dim 20 in bf16 (rows not 16-byte
    aligned) and in fp16 as a view of rows of 32 (a partial last
    16-byte chunk); int8 pools under fp16 and fp32 queries."""
    num_pages, ps = PAGED["pages"], PAGED["page"]
    b = len(PAGED["lens"])
    f32, f16 = torch.float32, torch.float16
    for dt, d, hkv in [(f32, d_full, nh), (f32, 16, nh // 16),
                       (f16, d_full, nh), (f16, 96, nh // 16),
                       (torch.bfloat16, 16, nh // 16),
                       (torch.bfloat16, 96, nh // 4),
                       (torch.bfloat16, 20, nh // 4),
                       (f16, (20, 32), nh)]:
        d, width = d if isinstance(d, tuple) else (d, d)   # as in K7's
        q = randn(b, nh, d, dtype=dt)
        kp = randn(num_pages, ps, hkv, width, dtype=dt)[..., :d]
        vp = randn(num_pages, ps, hkv, width, dtype=dt)[..., :d]
        out = twice(torch, "paged_decode", lambda: ops.paged_decode_mha(
            q, kp, vp, table, lens))
        tag = (f"B={b} Hq={nh} Hkv={hkv} D={d} {str(dt)[6:]} "
               f"lens={PAGED['lens']}")
        err = check_close(torch, f"paged_decode {tag}", out,
                          ops.paged_decode_mha_ref(q, kp, vp, table, lens),
                          **TOL["paged_decode"])
        if out[-1].abs().max().item() != 0.0:
            raise AssertionError("paged_decode: a zero-length row must "
                                 "return zeros")
        cases.append(("paged_decode", tag, err))
        if d == d_full:
            tokens, es = sum(PAGED["lens"]), q.element_size()
            nbytes = (tokens * hkv * d * es * 2 + 2 * q.numel() * es
                      + table.numel() * 4 + b * 4)
            bms, by = bound(nbytes, 4 * d * tokens * nh,
                            FP32_FLOPS if dt == f32 else BF16_FLOPS)
            rows["paged_decode"]["instances"][
                f"paged_decode_{ENTRY[str(dt)]}"] = dict(
                shape=tag, ms=time_ms(torch, lambda: ops.paged_decode_mha(
                    q, kp, vp, table, lens)),
                plain_ms=time_ms(torch, lambda: ops.paged_decode_mha_ref(
                    q, kp, vp, table, lens), reps=5),
                bound_ms=bms, bound_by=by, max_abs_err=err)
    # int8 pools with scales under an fp16 query (MHA) and an fp32 one (GQA
    # nh/(nh/4)), as the JAX package's engine stores them under a model of
    # that dtype; both timed, and fp32 again at head dim 16 (width 32)
    g = torch.Generator(device=table.device).manual_seed(SEED + 8)
    for dt, d, hkv in [(f16, d_full, nh), (f32, d_full, nh // 4),
                       (f32, 16, nh // 16)]:
        q = randn(b, nh, d, dtype=dt)
        kp, vp = (torch.randint(-127, 128, (num_pages, ps, hkv, d),
                                generator=g, device=table.device,
                                dtype=torch.int8) for _ in range(2))
        sc = tuple(randn(num_pages, hkv, dtype=f32).abs() + 0.1
                   for _ in range(2))
        out = twice(torch, "paged_decode", lambda: ops.paged_decode_mha(
            q, kp, vp, table, lens, *sc))
        tag = (f"B={b} Hq={nh} Hkv={hkv} D={d} int8 pools, "
               f"{str(dt)[6:]} query lens={PAGED['lens']}")
        err = check_close(torch, f"paged_decode {tag}", out,
                          ops.paged_decode_mha_ref(q, kp, vp, table, lens,
                                                   *sc),
                          **TOL["paged_decode"])
        if out.dtype != dt or out[-1].abs().max().item() != 0.0:
            raise AssertionError("paged_decode: the output takes the "
                                 "query's dtype, and a zero-length row "
                                 "returns zeros")
        cases.append(("paged_decode", tag, err))
        if d == d_full:
            tokens, es = sum(PAGED["lens"]), q.element_size()
            nbytes = (tokens * hkv * d * 2 + 2 * q.numel() * es
                      + 2 * num_pages * hkv * 4 + table.numel() * 4 + b * 4)
            bms, by = bound(nbytes, 4 * d * tokens * nh,
                            FP32_FLOPS if dt == f32 else BF16_FLOPS)
            rows["paged_decode"]["instances"][
                f"paged_decode_int8_{ENTRY[str(dt)]}"] = dict(
                shape=tag, ms=time_ms(torch, lambda: ops.paged_decode_mha(
                    q, kp, vp, table, lens, *sc)),
                plain_ms=time_ms(torch, lambda: ops.paged_decode_mha_ref(
                    q, kp, vp, table, lens, *sc), reps=5),
                bound_ms=bms, bound_by=by, max_abs_err=err)


def paged_edge_cases(torch, ops, g, randn, rows, cases, dev, nh, d):
    """K4's split-edge cases (edge_lens at SPLIT_EDGE_CAPS) in bf16, MHA
    and GQA nh/(nh/4), and int8 pools over the capacity no split divides;
    then the batch-1 case, one row of BATCH1_CTX tokens over nh heads,
    timed against its bound as the instance ``batch1``."""
    ps, num_pages = PAGED["page"], PAGED["pages"]
    unit = sys.modules["paddle_tpu_torch.ops.paged_attention"].split_unit(ps)
    bf = torch.bfloat16
    full, odd = SPLIT_EDGE_CAPS["paged_decode"]
    for cap, hkv, int8 in [(full, nh, False), (full, nh // 4, False),
                           (odd, nh, False), (odd, nh // 4, True)]:
        b = 8
        lens_l = edge_lens(split_of(ops, b, hkv, nh // hkv, cap, unit)[0],
                           cap)
        table, lens = paged_table(torch, g, dev, lens_l, cap // ps,
                                  num_pages)
        q = randn(b, nh, d)
        if int8:
            kp, vp = (torch.randint(-127, 128, (num_pages, ps, hkv, d),
                                    generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
            sc = tuple(randn(num_pages, hkv, dtype=torch.float32).abs() + 0.1
                       for _ in range(2))
        else:
            kp, vp, sc = randn(num_pages, ps, hkv, d), randn(
                num_pages, ps, hkv, d), ()
        out = twice(torch, "paged_decode", lambda: ops.paged_decode_mha(
            q, kp, vp, table, lens, *sc))
        tag = (f"B={b} Hkv={hkv} {'int8' if int8 else 'bf16'} cap={cap} "
               f"{split_tag(ops, b, hkv, nh // hkv, cap, unit)} "
               f"lens={lens_l}")
        err = check_close(torch, f"paged_decode {tag}", out,
                          ops.paged_decode_mha_ref(q, kp, vp, table, lens,
                                                   *sc),
                          **TOL["paged_decode"])
        if out[-1].abs().max().item() != 0.0:
            raise AssertionError("paged_decode: a zero-length row must "
                                 "return zeros")
        cases.append(("paged_decode", tag, err))
    # batch 1 at BATCH1_CTX tokens
    n_pages = BATCH1_CTX // ps
    table, lens = paged_table(torch, g, dev, [BATCH1_CTX], n_pages, n_pages)
    q = randn(1, nh, d)
    kp, vp = randn(n_pages, ps, nh, d, dtype=bf), randn(n_pages, ps, nh, d,
                                                         dtype=bf)
    out = twice(torch, "paged_decode", lambda: ops.paged_decode_mha(
        q, kp, vp, table, lens))
    tag = (f"B=1 Hkv={nh} D={d} bf16 "
           f"{split_tag(ops, 1, nh, 1, BATCH1_CTX, unit)} lens=[{BATCH1_CTX}]")
    err = check_close(torch, f"paged_decode {tag}", out,
                      ops.paged_decode_mha_ref(q, kp, vp, table, lens),
                      **TOL["paged_decode"])
    cases.append(("paged_decode", tag, err))
    bms, by = bound(BATCH1_CTX * nh * d * 2 * 2 + 2 * q.numel() * 2
                    + table.numel() * 4 + 4, 4 * d * BATCH1_CTX * nh,
                    BF16_FLOPS)
    rows["paged_decode"]["instances"]["batch1"] = dict(
        shape=tag, ms=time_ms(torch, lambda: ops.paged_decode_mha(
            q, kp, vp, table, lens)),
        plain_ms=time_ms(torch, lambda: ops.paged_decode_mha_ref(
            q, kp, vp, table, lens), reps=5),
        bound_ms=bms, bound_by=by, max_abs_err=err)


def paged_decode_times(tree: str) -> dict:
    """The decode kernels of the checkout at ``tree``: K4 at the serve shape
    of phase 3 (MHA, GQA and int8), K7 at the same shape (MHA and GQA
    32/8), and both at the batch-1 case (one row of BATCH1_CTX tokens, 32
    heads of 128): each one's device time (the median of 50 calls) and its
    largest difference from that checkout's plain version. Only the
    wrappers' public signatures are used, so a parent tree runs it as well.
    Run for two checkouts in turns, each in a fresh process, it compares
    them on one card."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from paddle_tpu_torch import llama_config, ops

    dev = torch.device("cuda")
    mc = llama_config(PRESET)
    nh, d = mc.num_attention_heads, mc.head_dim
    g, randn = seeded_randn(torch, dev)
    table, lens, cases = paged_decode_inputs(torch, g, randn, dev, nh, d)
    out = {"tree": os.path.abspath(tree), "card": smi_line()}

    def timed(name, fn, ref):
        out[f"{name}_max_abs_err"] = (fn().float() - ref().float()).abs(
        ).max().item()
        out[f"{name}_ms"] = time_ms(torch, fn, reps=50)

    for hkv, int8, q, kp, vp, sc in cases:
        timed("int8" if int8 else f"bf16_hkv{hkv}",
              lambda: ops.paged_decode_mha(q, kp, vp, table, lens, *sc),
              lambda: ops.paged_decode_mha_ref(q, kp, vp, table, lens, *sc))
    s_max = PAGED["max_pages"] * PAGED["page"]
    for hkv in (nh, nh // 4):
        q = randn(len(PAGED["lens"]), nh, d)
        k, v = (randn(len(PAGED["lens"]), s_max, hkv, d) for _ in range(2))
        timed(f"decode_mha_hkv{hkv}", lambda: ops.decode_mha(q, k, v, lens),
              lambda: ops.decode_mha_ref(q, k, v, lens))
    del k, v, cases
    n_pages = BATCH1_CTX // PAGED["page"]
    table, lens = paged_table(torch, g, dev, [BATCH1_CTX], n_pages, n_pages)
    q = randn(1, nh, d)
    kp, vp = (randn(n_pages, PAGED["page"], nh, d) for _ in range(2))
    timed("batch1_paged", lambda: ops.paged_decode_mha(q, kp, vp, table, lens),
          lambda: ops.paged_decode_mha_ref(q, kp, vp, table, lens))
    k, v = (t.reshape(1, BATCH1_CTX, nh, d) for t in (kp, vp))
    timed("batch1_decode_mha", lambda: ops.decode_mha(q, k, v, lens),
          lambda: ops.decode_mha_ref(q, k, v, lens))
    return out


def decode_mha_cases(torch, ops, F, randn, rows, cases, NH, D, dev):
    """K7 against ``decode_mha_ref``: the 7B serve batch (8 rows of a
    1024-long cache, 32 heads of 128, lens up to 1024 with a dead row), GQA
    32/8, a cache of 700 (no tile divides it) and fp32 inputs; then head
    dims 16 (the tile at width 32, lanes past 16 masked) and 96 (width
    128), in bf16, fp16 and fp32, with a GQA group of 16 (two blocks per
    kv head); head dim 20, whose cache rows are not 16-byte aligned (the
    kernel's element-wise loads) or, read as a view of rows of 32, end in
    a partial 16-byte chunk; the split-edge cases (edge_lens at
    SPLIT_EDGE_CAPS, MHA and GQA 32/8); and
    the batch-1 case, one row of BATCH1_CTX tokens, timed against its bound
    and the masked SDPA as the instance ``batch1``. Each case is launched
    twice and must give bitwise-equal results."""
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    serve_lens = [1024, 900, 733, 512, 300, 129, 17, 0]
    full, odd = SPLIT_EDGE_CAPS["decode_mha"]
    edge = None          # the lengths edge_lens() takes from the case's plan
    for s_max, hkv, dtype, lens_l, d in [
            (1024, NH, bf, serve_lens, D), (1024, NH // 4, bf, serve_lens, D),
            (700, NH, bf, [700, 650, 513, 333, 64, 63, 1, 0], D),
            (full, NH, bf, edge, D), (full, NH // 4, bf, edge, D),
            (odd, NH, bf, edge, D), (odd, NH // 4, f16, edge, D),
            (BATCH1_CTX, NH, bf, [BATCH1_CTX], D),
            (1024, NH, f32, serve_lens, D),
            (1024, NH, f16, serve_lens, D),
            (1024, NH // 16, f16, serve_lens, 96),
            (1024, NH // 16, bf, serve_lens, 16),
            (1024, NH // 16, f32, serve_lens, 96),
            (700, NH, bf, [700, 650, 513, 333, 64, 63, 1, 0], 96),
            (700, NH // 4, f32, [700, 650, 513, 333, 64, 63, 1, 0], 16),
            (1024, NH // 16, bf, serve_lens, 20),
            (1024, NH // 4, f16, serve_lens, (20, 32))]:
        # d = (head dim, row width): a view of the first d columns of
        # wider rows, read in place
        d, width = d if isinstance(d, tuple) else (d, d)
        if lens_l is edge:
            lens_l = edge_lens(split_of(ops, 8, hkv, NH // hkv, s_max)[0],
                               s_max)
        b = len(lens_l)
        q = randn(b, NH, d, dtype=dtype)
        k = randn(b, s_max, hkv, width, dtype=dtype)[..., :d]
        v = randn(b, s_max, hkv, width, dtype=dtype)[..., :d]
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        out = twice(torch, "decode_mha", lambda: ops.decode_mha(
            q, k, v, lens))
        tag = (f"B={b} S={s_max} Hkv={hkv} D={d} {str(dtype)[6:]} "
               f"{split_tag(ops, b, hkv, NH // hkv, s_max)} lens={lens_l}")
        err = check_close(torch, f"decode_mha {tag}", out,
                          ops.decode_mha_ref(q, k, v, lens),
                          **TOL["decode_mha"])
        if lens_l[-1] == 0 and out[-1].abs().max().item() != 0.0:
            raise AssertionError("decode_mha: a zero-length row must return "
                                 "zeros")
        cases.append(("decode_mha", tag, err))
        if s_max == BATCH1_CTX:
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            bms, by = bound(BATCH1_CTX * hkv * d * 2 * 2 + 2 * q.numel() * 2
                            + 4, 4 * d * BATCH1_CTX * NH, BF16_FLOPS)
            rows["decode_mha"]["instances"]["batch1"] = dict(
                shape=tag, ms=time_ms(torch, lambda: ops.decode_mha(
                    q, k, v, lens)),
                plain_ms=time_ms(torch, lambda: ops.decode_mha_ref(
                    q, k, v, lens), reps=5),
                library_ms=time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q[:, :, None], kt, vt)),
                bound_ms=bms, bound_by=by, max_abs_err=err)
            continue
        if lens_l != serve_lens:
            continue
        if (s_max, hkv, d) == (1024, NH, D) and dtype != bf:
            tokens, es = sum(lens_l), q.element_size()
            bms, by = bound(tokens * hkv * d * es * 2 + 2 * q.numel() * es
                            + b * 4, 4 * d * tokens * NH,
                            FP32_FLOPS if dtype == f32 else BF16_FLOPS)
            rows["decode_mha"]["instances"][
                f"decode_mha_{ENTRY[str(dtype)]}"] = dict(
                shape=tag, ms=time_ms(torch, lambda: ops.decode_mha(
                    q, k, v, lens)),
                plain_ms=time_ms(torch, lambda: ops.decode_mha_ref(
                    q, k, v, lens), reps=5),
                bound_ms=bms, bound_by=by, max_abs_err=err)
        if (s_max, hkv, dtype, d) != (1024, NH, bf, D):
            continue
        tokens = sum(lens_l)
        nbytes = tokens * hkv * D * 2 * 2 + 2 * q.numel() * 2 + b * 4
        bms, by = bound(nbytes, 4 * D * tokens * NH, BF16_FLOPS)
        # the library's masked SDPA over [B, H, 1, S] (heads-first copies
        # made outside the timing)
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = (torch.arange(s_max, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        rows["decode_mha"] = dict(
            shape=tag,
            ms=time_ms(torch, lambda: ops.decode_mha(q, k, v, lens)),
            plain_ms=time_ms(torch, lambda: ops.decode_mha_ref(
                q, k, v, lens), reps=5),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=mask)), instances={})


def layer_norm_cases(torch, ops, F, randn, rows, cases, H):
    """K8 against ``fused_layer_norm_ref`` on 4096 rows of the 7B hidden
    size, with and without residual and bias, and at 5120 (not a power of
    two: the kernel's padded lanes must stay out of the variance)."""
    n = 4096
    for h, res, bias in [(H, False, False), (H, True, False),
                         (H, False, True), (H, True, True),
                         (5120, False, False), (5120, True, True)]:
        x = randn(n, h, scale=2.0) + 0.5
        r = randn(n, h) if res else None
        bb = randn(h, scale=0.5) if bias else None
        gamma, beta = randn(h, scale=0.1) + 1.0, randn(h, scale=0.1)
        args = (x, r, bb, gamma, beta, 1e-5)
        tag = f"[{n},{h}] residual={res} bias={bias}"
        err = check_close(torch, f"fused_layer_norm {tag}",
                          ops.fused_layer_norm(*args),
                          ops.fused_layer_norm_ref(*args),
                          **TOL["fused_layer_norm"])
        cases.append(("fused_layer_norm", tag, err))
        if h != H:
            continue
        if res and bias:
            rows["fused_layer_norm"]["residual_bias_ms"] = time_ms(
                torch, lambda: ops.fused_layer_norm(*args))
        elif not (res or bias):
            bms, by = bound(2 * x.numel() * 2 + 2 * h * 2, 8 * x.numel(),
                            FP32_FLOPS)
            rows["fused_layer_norm"] = dict(
                shape=tag,
                ms=time_ms(torch, lambda: ops.fused_layer_norm(*args)),
                plain_ms=time_ms(torch,
                                 lambda: ops.fused_layer_norm_ref(*args)),
                bound_ms=bms, bound_by=by,
                library_ms=time_ms(torch, lambda: F.layer_norm(
                    x, (h,), gamma, beta, 1e-5)))


def seven_linears(mc):
    """(name, K, N, count) of one decoder layer's linears: the weight
    [in, out] of q/k/v/o, gate/up and down."""
    h, i = mc.hidden_size, mc.intermediate_size
    return [("q/k/v/o", h, h, 4), ("gate/up", h, i, 2), ("down", i, h, 1)]


def grad_add_library(torch):
    """(what, fn(dw, x2, dy2)): the one PyTorch call that computes
    dw + x2^T dy2 from bf16 operands into fp32, where this PyTorch has it
    (``addmm`` with ``out_dtype``, PyTorch 2.8 and later); else (reason,
    None)."""
    a = torch.ones(16, 16, device="cuda", dtype=torch.bfloat16)
    try:
        torch.addmm(torch.zeros(16, 16, device="cuda"), a.t(), a,
                    out_dtype=torch.float32)
    except (TypeError, RuntimeError) as ex:
        return (f"none: torch.addmm takes no out_dtype here ({ex})"[:200],
                None)
    return ("torch.addmm(dw, x2.t(), dy2, out_dtype=torch.float32)",
            lambda dw, x2, dy2: torch.addmm(dw, x2.t(), dy2,
                                            out_dtype=torch.float32))


def grad_add_instance(torch, inst, x, dy, dw):
    """``fn()`` launching K9's instance ``inst`` on x, dy and dw directly
    (the instance the dispatch would not choose for these operands), for
    comparing instances on the same inputs; not counted as a launch."""
    ga = importlib.import_module("paddle_tpu_torch.ops.grad_add")
    x2, dy2 = x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1])

    def fn():
        out = torch.empty(dw.shape, dtype=torch.float32, device=dw.device)
        ga._launch(inst, x2, dy2, dw, out)
        return out
    return fn


def grad_add_cases(torch, ops, randn, rows, cases, mc):
    """K9 against ``fused_linear_param_grad_add_ref``: the seven linears of
    one decoder layer (bf16 x and dy over GRAD_ADD_TOKENS tokens, fp32
    dweight) on the Hopper instance, and the same seven through the
    mma.sync instance; then ragged sizes on each instance: fp32 inputs with
    a bf16 dweight, bf16 widths that are multiples of 8 but not of the
    tiles (TMA, bf16 dweight), and widths no 8-column chunk divides with an
    fp16 dweight (mma.sync); then the fp32 instance at q/k/v/o. Every case
    is launched twice and held bitwise equal, and the caller's dweight must
    come back unchanged. The row is the whole layer: times and bounds
    summed over the seven."""
    ga = importlib.import_module("paddle_tpu_torch.ops.grad_add")
    b, s = GRAD_ADD_TOKENS
    t = b * s
    lib_what, lib_fn = grad_add_library(torch)
    row = dict(shape=f"7 linears of a {PRESET} layer, T={t}, bf16 x/dy, "
                     f"fp32 dweight", ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, bound_by="operations", library=lib_what,
               instance="wgmma", per_linear={})
    mma = dict(shape=row["shape"] + ", mma.sync instance", ms=0.0,
               plain_ms=0.0, bound_ms=0.0, bound_by="operations",
               max_abs_err=0.0)
    for name, k, n, count in seven_linears(mc):
        x, dy = randn(b, s, k), randn(b, s, n)
        dw = randn(k, n, dtype=torch.float32)
        before = dw.clone()
        x2, dy2 = x.reshape(t, k), dy.reshape(t, n)
        inst = ga.kernel_for(x.dtype, t, k, n, (k, n),
                             (x.data_ptr(), dy.data_ptr()))
        if inst != "wgmma":
            raise AssertionError(f"grad_add {name}: dispatch chose {inst}, "
                                 f"not the Hopper instance")
        out = twice(torch, "grad_add", lambda: ops.fused_linear_param_grad_add(
            x, dy, dw))
        tag = f"{name} T={t} K={k} N={n} bf16 dw=fp32 ({inst})"
        want = ops.fused_linear_param_grad_add_ref(x, dy, dw)
        err = check_close(torch, f"grad_add {tag}", out, want,
                          **TOL["grad_add"])
        if not torch.equal(dw, before):
            raise AssertionError("grad_add: the caller's dweight changed")
        cases.append(("grad_add", tag, err))
        old = grad_add_instance(torch, "mma_sync", x, dy, dw)
        tag = f"{name} T={t} K={k} N={n} bf16 dw=fp32 (mma_sync)"
        mma_err = check_close(torch, f"grad_add {tag}", twice(
            torch, "grad_add", old), want, **TOL["grad_add"])
        cases.append(("grad_add", tag, mma_err))
        del want
        bms, by = bound((t * k + t * n) * 2 + 2 * k * n * 4, 2 * t * k * n,
                        BF16_FLOPS)
        lib = (None if lib_fn is None
               else time_ms(torch, lambda: lib_fn(dw, x2, dy2)))
        one = dict(
            ms=time_ms(torch, lambda: ops.fused_linear_param_grad_add(
                x, dy, dw)),
            plain_ms=time_ms(
                torch, lambda: ops.fused_linear_param_grad_add_ref(x, dy, dw),
                reps=5),
            library_ms=lib, bound_ms=bms, bound_by=by, count=count,
            mma_sync_ms=time_ms(torch, old))
        row["per_linear"][name] = one
        for key in ("ms", "plain_ms", "bound_ms"):
            row[key] += count * one[key]
        mma["ms"] += count * one["mma_sync_ms"]
        mma["max_abs_err"] = max(mma["max_abs_err"], mma_err)
        row["library_ms"] = (None if lib is None
                             else row["library_ms"] + count * lib)
    mma.update(plain_ms=row["plain_ms"], bound_ms=row["bound_ms"])
    row["instances"] = {"mma_sync": mma}
    rows["grad_add"] = row
    for t, k, n, in_dt, dw_dt, want_inst in [
            (1000, 96, 200, torch.float32, torch.bfloat16, "f32"),
            (1000, 200, 136, torch.bfloat16, torch.bfloat16, "wgmma"),
            (777, 100, 36, torch.bfloat16, torch.float16, "mma_sync")]:
        x, dy = randn(t, k, dtype=in_dt), randn(t, n, dtype=in_dt)
        dw = randn(k, n, dtype=dw_dt)
        before = dw.clone()
        inst = ga.kernel_for(in_dt, t, k, n, (k, n),
                             (x.data_ptr(), dy.data_ptr()))
        if inst != want_inst:
            raise AssertionError(f"grad_add T={t} K={k} N={n}: dispatch "
                                 f"chose {inst}, not {want_inst}")
        tag = (f"ragged T={t} K={k} N={n} {str(in_dt)[6:]} "
               f"dw={str(dw_dt)[6:]} ({inst})")
        err = check_close(torch, f"grad_add {tag}", twice(
            torch, "grad_add", lambda: ops.fused_linear_param_grad_add(
                x, dy, dw)),
                          ops.fused_linear_param_grad_add_ref(x, dy, dw),
                          **TOL["grad_add"])
        if not torch.equal(dw, before):
            raise AssertionError("grad_add: the caller's dweight changed")
        cases.append(("grad_add", tag, err))
    # the fp32 instance at q/k/v/o
    t, k = b * s, mc.hidden_size
    n = k
    x, dy = randn(t, k, dtype=torch.float32), randn(t, n, dtype=torch.float32)
    dw = randn(k, n, dtype=torch.float32)
    fn = lambda: ops.fused_linear_param_grad_add(x, dy, dw)  # noqa: E731
    tag = f"q/k/v/o T={t} K={k} N={n} float32 dw=fp32 (f32)"
    err = check_close(torch, f"grad_add {tag}", twice(torch, "grad_add", fn),
                      ops.fused_linear_param_grad_add_ref(x, dy, dw),
                      **TOL["grad_add"])
    cases.append(("grad_add", tag, err))
    bms, by = bound((t * k + t * n) * 4 + 2 * k * n * 4, 2 * t * k * n,
                    FP32_FLOPS)
    row["instances"]["f32"] = dict(
        shape=tag, ms=time_ms(torch, fn, reps=10),
        plain_ms=time_ms(torch, lambda: ops.fused_linear_param_grad_add_ref(
            x, dy, dw), reps=5), bound_ms=bms, bound_by=by, max_abs_err=err)


def moe_group_sizes(np, rows: int, groups: int, seed: int,
                    empty_first: bool):
    """A skewed draw of ``groups`` sizes summing to ``rows``: multinomial
    over Dirichlet(0.3) weights, with group 0 (or a middle group) emptied
    into its neighbour, so at least one group is empty."""
    rng = np.random.RandomState(seed)
    sizes = rng.multinomial(rows, rng.dirichlet(np.full(groups, 0.3)))
    e = 0 if empty_first else groups // 2
    sizes[e + 1] += sizes[e]
    sizes[e] = 0
    return sizes.astype(np.int32)


def grouped_matmul_library(torch, lhs, rhs, sizes, want):
    """Time of ``torch._grouped_mm`` on the same operands, fp32 out where
    it takes that, else bf16 out (PyTorch 2.11 writes bf16 for bf16
    inputs), where this PyTorch has it and its result agrees with the
    plain version within the limit of the kernel's own bf16 output
    (``TOL["grouped_matmul_bf16"]``: one bf16 step of each output); else
    None and the reason."""
    if not hasattr(torch, "_grouped_mm"):
        return None, "this PyTorch has no torch._grouped_mm (no single call)"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    reason = ""
    for what, out_dt in (("fp32 out", torch.float32), ("bf16 out", None)):
        try:
            got = torch._grouped_mm(lhs, rhs, offs=offs, out_dtype=out_dt)
        except (TypeError, RuntimeError) as ex:
            reason += f"{what}: {str(ex).splitlines()[0][:100]}; "
            continue
        diff = (got.float() - want.float()).abs()
        tol = TOL["grouped_matmul_bf16"]
        if (diff > tol["atol"] + tol["rtol"] * want.float().abs()).any():
            reason += (f"{what}: result differs by "
                       f"{diff.max().item():.3g}; ")
            continue
        ms = time_ms(torch, lambda: torch._grouped_mm(lhs, rhs, offs=offs,
                                                      out_dtype=out_dt))
        return ms, f"torch._grouped_mm(lhs, rhs, offs), {what}"
    return None, "torch._grouped_mm refused these operands: " + reason


def gemm_times(tree: str) -> dict:
    """K9 and K10 of the checkout at ``tree``: K9 at the seven linears of a
    PRESET layer over GRAD_ADD_TOKENS tokens (bf16 x and dy, fp32 dweight)
    and K10 at the ERNIE-MoE up and down GEMMs (phase 3's operands and
    group sizes) with fp32 and with bf16 out: each one's device time (the
    median of 20 calls) and its largest difference from that checkout's
    plain version. Only the wrappers' public signatures are used, so a
    parent tree runs it as well. Run for two checkouts in turns, each in a
    fresh process, it compares them on one card."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from paddle_tpu_torch import llama_config, ops

    dev = torch.device("cuda")
    _, randn = seeded_randn(torch, dev)
    res = {"tree": os.path.abspath(tree), "card": smi_line()}

    def timed(key, fn, ref):
        res[f"{key}_max_abs_err"] = (fn().float() - ref().float()).abs(
        ).max().item()
        res[f"{key}_ms"] = time_ms(torch, fn)
        return res[f"{key}_ms"]

    b, s = GRAD_ADD_TOKENS
    res["grad_add_layer_ms"] = 0.0
    for name, k, n, count in seven_linears(llama_config(PRESET)):
        x, dy = randn(b * s, k), randn(b * s, n)
        dw = randn(k, n, dtype=torch.float32)
        res["grad_add_layer_ms"] += count * timed(
            f"grad_add_{name}",
            lambda: ops.fused_linear_param_grad_add(x, dy, dw),
            lambda: ops.fused_linear_param_grad_add_ref(x, dy, dw))
    e, f, g = MOE["hidden"], MOE["ffn"], MOE["experts"]
    m = MOE["tokens"] * MOE["top_k"]
    for name, k, n, first in (("up", e, f, True), ("down", f, e, False)):
        sizes = torch.from_numpy(moe_group_sizes(
            np, m, g, seed=41 + k, empty_first=first)).to(dev)
        lhs, rhs = randn(m, k), randn(g, k, n)
        for out_dt in (torch.float32, torch.bfloat16):
            key = f"grouped_matmul_{ENTRY[str(out_dt)]}_out"
            ms = timed(f"{key}_{name}",
                       lambda: ops.grouped_matmul(lhs, rhs, sizes, out_dt),
                       lambda: ops.grouped_matmul_ref(lhs, rhs, sizes,
                                                      out_dt))
            res[f"{key}_ms"] = res.get(f"{key}_ms", 0.0) + ms
    return res


def grouped_matmul_instance(torch, inst, lhs, rhs, sizes,
                            out_dt=None, sched=None):
    """``fn()`` launching K10's instance ``inst`` directly (the instance the
    dispatch would not choose for these operands), with the schedule into
    ``sched`` where given; not counted as a launch."""
    gm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
    (m, _), (g, _, n) = lhs.shape, rhs.shape
    ends = torch.cumsum(sizes, 0, dtype=torch.int32)
    if sched is None and inst != "mma_sync":
        sched = torch.empty(3 * gm.max_row_tiles(m, g), dtype=torch.int32,
                            device=lhs.device)

    def fn():
        out = torch.empty((m, n), dtype=out_dt or torch.float32,
                          device=lhs.device)
        gm._launch(inst, lhs, rhs, ends, out, sched)
        return out
    return fn


def grouped_matmul_cases(torch, np, ops, randn, rows, cases, dev):
    """K10 against ``grouped_matmul_ref`` at the ERNIE-MoE "large" expert
    GEMMs: up [M, hidden] x [E, hidden, ffn] with the first group empty,
    down [M, ffn] x [E, ffn, hidden] with a middle group empty, skewed
    sizes summing to M (group edges fall inside 128-row tiles), on the
    Hopper instance with fp32 and with bf16 out, and on the mma.sync
    instance; the up GEMM with fp32 inputs (the fp32 instance); then
    ragged sizes on each instance (groups past the sum, C-ref-5). The
    schedule the card builds is held against ``group_tile_schedule`` as
    integers. Every case is launched twice and held bitwise equal. The row
    is the bf16 up and down GEMMs with fp32 out; ``bf16_out`` beside it is
    the same pair writing bf16, as ``torch._grouped_mm`` does."""
    gm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
    f32, bf = torch.float32, torch.bfloat16
    e, f, g = MOE["hidden"], MOE["ffn"], MOE["experts"]
    m = MOE["tokens"] * MOE["top_k"]
    shape = f"ERNIE-MoE large up+down: M={m}, {g} groups, {e}<->{f}, bf16 in"
    row = dict(shape=shape + ", fp32 out", ms=0.0, plain_ms=0.0,
               bound_ms=0.0, bound_by="bytes", library_ms=0.0,
               library="", instance="wgmma", per_gemm={})
    bf16_out = dict(shape=shape + ", bf16 out", ms=0.0, plain_ms=0.0,
                    bound_ms=0.0, bound_by="bytes", library_ms=0.0,
                    max_abs_err=0.0)
    mma = dict(shape=shape + ", fp32 out, mma.sync instance", ms=0.0,
               plain_ms=0.0, bound_ms=0.0, bound_by="bytes", max_abs_err=0.0)
    row["instances"] = {"bf16_out": bf16_out, "mma_sync": mma}
    for name, k, n, first in (("up", e, f, True), ("down", f, e, False)):
        sizes_np = moe_group_sizes(np, m, g, seed=41 + k, empty_first=first)
        sizes = torch.from_numpy(sizes_np).to(dev)
        lhs, rhs = randn(m, k), randn(g, k, n)
        straddle = sum(1 for c in np.cumsum(sizes_np)[:-1] if c % 128)
        inst = gm.kernel_for(bf, k, n, (lhs.stride(0), rhs.stride(0),
                                        rhs.stride(1)),
                             (lhs.data_ptr(), rhs.data_ptr()))
        if inst != "wgmma":
            raise AssertionError(f"grouped_matmul {name}: dispatch chose "
                                 f"{inst}, not the Hopper instance")
        # the schedule the card builds, as integers
        sched = torch.empty(3 * gm.max_row_tiles(m, g), dtype=torch.int32,
                            device=dev)
        grouped_matmul_instance(torch, "wgmma", lhs, rhs, sizes,
                                sched=sched)()
        card = sched.view(-1, 3).tolist()
        want_sched = [list(t) for t in gm.group_tile_schedule(
            np.cumsum(sizes_np).tolist(), m)]
        if card != want_sched + [[-1, 0, 0]] * (len(card) - len(want_sched)):
            raise AssertionError(f"grouped_matmul {name}: the card's tile "
                                 f"schedule differs from "
                                 f"group_tile_schedule's")
        passes = gm.tile_passes(sizes_np.tolist(), m)
        log(f"  grouped_matmul {name}: schedule of {len(want_sched)} tiles "
            f"(grid {len(card)} row tiles) equal to group_tile_schedule's; "
            f"tile passes made {passes['made']}, by the mma.sync walk "
            f"{passes['walk']}, needed {passes['needed']}")
        want32 = ops.grouped_matmul_ref(lhs, rhs, sizes)
        for out_dt in (f32, bf):
            out = twice(torch, "grouped_matmul",
                        lambda: ops.grouped_matmul(lhs, rhs, sizes, out_dt))
            want = (want32 if out_dt == f32
                    else ops.grouped_matmul_ref(lhs, rhs, sizes, out_dt))
            kname = ("grouped_matmul" if out_dt == f32
                     else "grouped_matmul_bf16")
            tag = (f"{name} M={m} K={k} N={n} G={g} empty="
                   f"{int((sizes_np == 0).sum())} edges-in-tiles={straddle} "
                   f"out={str(out_dt)[6:]} ({inst})")
            err = check_close(torch, f"grouped_matmul {tag}", out, want,
                              **TOL[kname])
            cases.append((kname, tag, err))
            if out_dt == bf:
                bf16_out["max_abs_err"] = max(bf16_out["max_abs_err"], err)
        old = grouped_matmul_instance(torch, "mma_sync", lhs, rhs, sizes)
        tag = f"{name} M={m} K={k} N={n} G={g} out=float32 (mma_sync)"
        mma_err = check_close(torch, f"grouped_matmul {tag}", twice(
            torch, "grouped_matmul", old), want32, **TOL["grouped_matmul"])
        cases.append(("grouped_matmul", tag, mma_err))
        mma["max_abs_err"] = max(mma["max_abs_err"], mma_err)
        live = int((sizes_np > 0).sum())
        if name == "up":      # fp32 inputs: the CUDA-core instance
            l32, r32 = lhs.float(), rhs.float()
            tag = f"up M={m} K={k} N={n} G={g} fp32 in, fp32 out (f32)"
            fn = lambda: ops.grouped_matmul(l32, r32, sizes)  # noqa: E731
            err = check_close(torch, f"grouped_matmul {tag}", twice(
                torch, "grouped_matmul", fn), ops.grouped_matmul_ref(
                    l32, r32, sizes), **TOL["grouped_matmul"])
            cases.append(("grouped_matmul", tag, err))
            bms, by = bound(m * k * 4 + live * k * n * 4 + m * n * 4 + g * 4,
                            2 * m * k * n, FP32_FLOPS)
            row["instances"]["f32"] = dict(
                shape=tag, ms=time_ms(torch, fn),
                plain_ms=time_ms(torch, lambda: ops.grouped_matmul_ref(
                    l32, r32, sizes), reps=5),
                bound_ms=bms, bound_by=by, max_abs_err=err)
            del l32, r32
        bms, by = bound(m * k * 2 + live * k * n * 2 + m * n * 4 + g * 4,
                        2 * m * k * n, BF16_FLOPS)
        bms16, _ = bound(m * k * 2 + live * k * n * 2 + m * n * 2 + g * 4,
                         2 * m * k * n, BF16_FLOPS)
        lib, lib_what = grouped_matmul_library(torch, lhs, rhs, sizes,
                                               want32)
        del want32
        one = dict(
            ms=time_ms(torch, lambda: ops.grouped_matmul(lhs, rhs, sizes)),
            plain_ms=time_ms(torch, lambda: ops.grouped_matmul_ref(
                lhs, rhs, sizes), reps=5),
            bound_ms=bms, bound_by=by, library_ms=lib, library=lib_what,
            bf16_out_ms=time_ms(torch, lambda: ops.grouped_matmul(
                lhs, rhs, sizes, bf)),
            bf16_out_bound_ms=bms16, mma_sync_ms=time_ms(torch, old),
            tile_passes=passes, sizes=sizes_np.tolist())
        row["per_gemm"][name] = one
        for key in ("ms", "plain_ms", "bound_ms"):
            row[key] += one[key]
        bf16_out["ms"] += one["bf16_out_ms"]
        bf16_out["bound_ms"] += bms16
        mma["ms"] += one["mma_sync_ms"]
        row["library"] += f"{name}: {lib_what}. "
        row["library_ms"] = (None if lib is None or row["library_ms"] is None
                             else row["library_ms"] + lib)
        if by == "operations":
            row["bound_by"] = "operations"
        del lhs, rhs
    for part in (bf16_out, mma):
        part["plain_ms"] = row["plain_ms"]
    bf16_out.update(library_ms=row["library_ms"], library=row["library"])
    mma["bound_ms"] = row["bound_ms"]
    # ragged: widths TMA takes but no tile divides (wgmma), widths it does
    # not take (mma_sync), fp32 widths no 16-byte load divides (f32); 108
    # of 300 rows in groups, the rest the last group's (C-ref-5)
    sz = [0, 5, 100, 0, 3]
    for k, n, dt, want_inst in [(72, 136, bf, "wgmma"),
                                (100, 36, bf, "mma_sync"),
                                (70, 36, f32, "f32")]:
        sizes = torch.tensor(sz, dtype=torch.int32, device=dev)
        lhs, rhs = randn(300, k, dtype=dt), randn(len(sz), k, n, dtype=dt)
        inst = gm.kernel_for(dt, k, n, (lhs.stride(0), rhs.stride(0),
                                        rhs.stride(1)),
                             (lhs.data_ptr(), rhs.data_ptr()))
        if inst != want_inst:
            raise AssertionError(f"grouped_matmul K={k} N={n}: dispatch "
                                 f"chose {inst}, not {want_inst}")
        tag = f"ragged M=300 K={k} N={n} sizes={sz} {str(dt)[6:]} ({inst})"
        cases.append(("grouped_matmul", tag, check_close(
            torch, f"grouped_matmul {tag}", twice(
                torch, "grouped_matmul", lambda: ops.grouped_matmul(
                    lhs, rhs, sizes)), ops.grouped_matmul_ref(
                        lhs, rhs, sizes), **TOL["grouped_matmul"])))
    rows["grouped_matmul"] = row


def stock_paged_pools(torch, g, dev, hkv, d):
    """Stock-layout pools [Hkv, pages, page, D] (bf16, unit normal) and a
    page table [B, pages_per_seq] of distinct pages up to each length,
    other valid page ids past it (the stock contract: every entry a page)."""
    ps, pages, maxp = STOCK["page"], STOCK["pages"], STOCK["pages_per_seq"]
    b = len(STOCK["lens"])
    perm = torch.randperm(pages, generator=g, device=dev).int()
    table = torch.randint(0, pages, (b, maxp), generator=g, device=dev,
                          dtype=torch.int32)
    nxt = 0
    for r, n in enumerate(STOCK["lens"]):
        k = -(-n // ps)
        table[r, :k] = perm[nxt:nxt + k]
        nxt += k
    kp = torch.randn(hkv, pages, ps, d, generator=g, device=dev).bfloat16()
    vp = torch.randn(hkv, pages, ps, d, generator=g, device=dev).bfloat16()
    return kp, vp, table


def stock_paged_cases(torch, ops, rows, cases, dev, nh, d):
    """The stock-layout ``paged_attention`` (K4 through permuted views,
    scale 1) against its plain version at the 7B decode shape: q already
    scaled by 1/sqrt(D) as a caller of the stock kernel scales it, MHA and
    GQA 32/8; then unscaled q with the logits soft-capped. The dead row
    must return zeros."""
    g = torch.Generator(device=dev).manual_seed(4321)
    lens_l = STOCK["lens"]
    b = len(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    kw = dict(pages_per_compute_block=STOCK["ppcb"])
    for hkv, cap in [(nh, None), (nh // 4, None), (nh, STOCK["soft_cap"])]:
        kp, vp, table = stock_paged_pools(torch, g, dev, hkv, d)
        q = torch.randn(b, nh, d, generator=g, device=dev)
        q = (q if cap else q / d ** 0.5).bfloat16()
        kw["attn_logits_soft_cap"] = cap
        out = twice(torch, "paged_attention", lambda: ops.paged_attention(
            q, kp, vp, lens, table, **kw))
        tag = f"B={b} Hkv={hkv} stock layout, scale 1, soft cap {cap}"
        err = check_close(torch, f"paged_attention {tag}", out,
                          ops.paged_attention_ref(q, kp, vp, lens, table,
                                                  **kw),
                          **TOL["paged_attention"])
        if out[-1].abs().max().item() != 0.0:
            raise AssertionError("paged_attention: a zero-length row must "
                                 "return zeros")
        cases.append(("paged_attention", tag, err))
        if hkv == nh and cap is None:
            tokens = sum(lens_l)
            nbytes = (tokens * hkv * d * 2 * 2 + 2 * q.numel() * 2
                      + table.numel() * 4 + b * 4)
            bms, by = bound(nbytes, 4 * d * tokens * nh, BF16_FLOPS)
            rows["paged_attention"] = dict(
                shape=tag,
                ms=time_ms(torch, lambda: ops.paged_attention(
                    q, kp, vp, lens, table, **kw)),
                plain_ms=time_ms(torch, lambda: ops.paged_attention_ref(
                    q, kp, vp, lens, table, **kw), reps=5),
                bound_ms=bms, bound_by=by, library_ms=None,
                library="none: no single PyTorch call reads K/V through a "
                        "page table")
        del kp, vp


class hb_flag:
    """``with hb_flag(on):`` sets FLAGS_flash_head_batched for the block
    and puts the old value back after it."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        from paddle_tpu_torch import get_flags, set_flags
        self.old = get_flags("FLAGS_flash_head_batched")
        set_flags({"FLAGS_flash_head_batched": self.on})

    def __exit__(self, *exc):
        from paddle_tpu_torch import set_flags
        set_flags(self.old)
        return False


def hb_route_cases(torch, ops, F, randn, rows, cases):
    """The head-batched route at the training shape (8 x 2048, 8 heads of
    128, causal), reached through ``flash_attention`` with the flag on:
    out, dq, dk and dv bitwise those of the per-head kernels called
    directly, and out within flash_fwd's limit of the plain forward."""
    b, s = TRAIN["batch"], TRAIN["seq"]
    nh = TRAIN["overrides"]["num_attention_heads"]
    d = 128
    q, k, v, do = (randn(b, s, nh, d) for _ in range(4))
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    with hb_flag(True):
        out = ops.flash_attention(qr, kr, vr, causal=True)
        grads = torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True)
    if ops.route_calls()["flash_hb"] != 1:
        raise AssertionError("flash_attention did not take the head-batched "
                             "route with the flag on")
    ref_out, lse = ops.flash_attention_bshd(q, k, v, causal=True)
    ref_grads = ops.flash_attention_bwd(q, k, v, ref_out, lse, do, True)
    for what, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (ref_out, *ref_grads)):
        if not torch.equal(got, want):
            raise AssertionError(f"flash_hb: {what} is not bitwise the "
                                 f"per-head kernels'")
    plain, _ = ops.flash_attention_bshd_ref(q, k, v, causal=True)
    tag = f"B={b} S={s} H={nh} D={d} causal, fwd+bwd bitwise per-head"
    cases.append(("flash_hb", tag, check_close(
        torch, f"flash_hb {tag}", out, plain, **TOL["flash_hb"])))
    nbytes = 4 * q.numel() * 2 + lse.numel() * 4          # q, k, v, out
    bms, by = bound(nbytes, 4 * d * causal_pairs(s, s) * nh * b, BF16_FLOPS)
    with hb_flag(True), torch.no_grad():
        ms = time_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True))
    with hb_flag(True):
        bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            out, (qr, kr, vr), do, retain_graph=True))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    rows["flash_hb"] = dict(
        shape=tag, ms=ms, bwd_ms=bwd_ms,
        plain_ms=time_ms(torch, lambda: ops.flash_attention_bshd_ref(
            q, k, v, causal=True), reps=3, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        library="F.scaled_dot_product_attention causal, forward")
    del qr, kr, vr, out, grads


def causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a bottom-right causal mask lets through."""
    return sum(max(0, min(sk, i + 1 + sk - sq)) for i in range(sq))


def flash_bwd_train_inputs(torch, randn):
    """q, k, v, dO at the training shape (TRAIN: 8 x 2048, 8 heads of
    128), then the causal forward's out and lse and delta."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.flash_attention_kernel import _delta

    b, s = TRAIN["batch"], TRAIN["seq"]
    nh = TRAIN["overrides"]["num_attention_heads"]
    q, k, v, do = (randn(b, s, nh, 128) for _ in range(4))
    out, lse = ops.flash_attention_bshd(q, k, v, causal=True)
    return q, k, v, do, out, lse, _delta(out, do)


def flash_bwd_times(tree: str) -> dict:
    """K5, K6 and K3 of the checkout at ``tree`` at the training shape
    (causal): their device times (the median of 20 calls) and K5's and
    K6's largest difference from that checkout's plain backward. Run for
    two checkouts in turns, each in a fresh process, it compares them on
    one card."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from paddle_tpu_torch import ops

    _, randn = seeded_randn(torch, torch.device("cuda"))
    q, k, v, do, out, lse, delta = flash_bwd_train_inputs(torch, randn)
    res = {"tree": os.path.abspath(tree), "card": smi_line()}
    # K3 first, before the backward kernels' longer runs warm the card
    res["flash_fwd_ms"] = time_ms(torch, lambda: ops.flash_attention_bshd(
        q, k, v, causal=True))
    dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    want = ops.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
    res["flash_bwd_dq_max_abs_err"] = (dq.float() - want[0].float()).abs(
    ).max().item()
    res["flash_bwd_dkv_max_abs_err"] = max(
        (got.float() - w.float()).abs().max().item()
        for got, w in zip((dk, dv), want[1:]))
    del want
    res["flash_bwd_dq_ms"] = time_ms(torch, lambda: ops.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, True))
    res["flash_bwd_dkv_ms"] = time_ms(
        torch, lambda: ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   True))
    return res


def flash_bwd_cases(torch, ops, F, randn, rows, cases):
    """flash_bwd_dq and flash_bwd_dkv against ``flash_attention_bwd_ref``
    on the same q, k, v, dO, out and lse: the training shape (8 x 2048, 8
    heads of 128, causal), GQA 8/2 and 8/1, ragged lengths (700, and 2047,
    which cuts through the last 64-row tile of both kernels), Sq < Sk, Sq >
    Sk (whose first Sq - Sk rows see no key and must get exactly zero dq),
    head_dim 64 with and without dropout, and dropout 0.1 causal and not;
    then the other instances: head dims 16 and 96 in bf16 (zero-padded to
    64 and 128 around the kernels, through ``flash_attention_bwd``, which
    pads once for both), fp16, and fp32 (flash_f32.cu) at 128, 64 and 16.
    Each kernel is launched twice on the same inputs, and the two results
    must be bitwise equal (no atomics: the sums run in a fixed order)."""
    from paddle_tpu_torch.ops.flash_attention_kernel import _delta

    B, S = TRAIN["batch"], TRAIN["seq"]
    NH = TRAIN["overrides"]["num_attention_heads"]
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    for b, sq, sk, hq, hkv, d, causal, p, dt in [
            (B, S, S, NH, NH, 128, True, 0.0, bf),
            (2, 512, 512, NH, 2, 128, True, 0.0, bf),
            (2, 512, 512, NH, 1, 128, True, 0.0, bf),
            (1, 700, 700, NH, NH, 128, True, 0.0, bf),
            (1, 2047, 2047, NH, NH, 128, True, 0.0, bf),
            (1, 300, 1000, NH, 2, 128, True, 0.0, bf),
            (1, 1000, 300, NH, NH, 128, True, 0.0, bf),
            (1, 256, 256, 4, 4, 64, True, 0.0, bf),
            (2, 700, 700, NH, 2, 64, True, 0.1, bf),
            (2, 512, 512, NH, NH, 128, True, 0.1, bf),
            (1, 200, 333, NH, 2, 128, False, 0.1, bf),
            (2, 256, 300, 4, 2, 16, True, 0.1, bf),
            (1, 256, 300, NH, 2, 96, True, 0.0, bf),
            (2, 512, 512, NH, 2, 128, True, 0.0, f32),
            (2, 300, 700, 4, 2, 64, False, 0.1, f32),
            (2, 130, 130, 4, 4, 16, True, 0.0, f32),
            (2, 512, 512, NH, 2, 128, True, 0.0, f16),
            (2, 700, 700, NH, 2, 64, True, 0.1, f16),
            (1, 256, 300, 4, 2, 96, True, 0.0, f16)]:
        if (b, sq) == (B, S):
            q, k, v, do, out, lse, delta = flash_bwd_train_inputs(torch,
                                                                  randn)
        else:
            q, do = randn(b, sq, hq, d, dtype=dt), randn(b, sq, hq, d,
                                                         dtype=dt)
            k, v = randn(b, sk, hkv, d, dtype=dt), randn(b, sk, hkv, d,
                                                         dtype=dt)
            out, lse = ops.flash_attention_bshd(q, k, v, causal, None, p,
                                                SEED)
            delta = _delta(out, do)
        args = (causal, None, p, SEED)
        if d in (64, 128):
            dq = ops.flash_attention_bwd_dq(q, k, v, do, lse, delta, *args)
            dk, dv = ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 *args)
            again = (ops.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                *args),
                     *ops.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                  *args))
        else:
            dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, do, *args)
            again = ops.flash_attention_bwd(q, k, v, out, lse, do, *args)
        for what, x, y in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
            if not torch.equal(x, y):
                raise AssertionError(f"flash backward: two launches gave "
                                     f"different {what}")
        del again
        rdq, rdk, rdv = ops.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                    *args)
        tag = (f"B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} "
               f"{str(dt)[6:]} causal={causal} dropout={p}")
        errs = {"flash_bwd_dq": check_close(torch, f"flash_bwd_dq {tag}",
                                            dq, rdq, **TOL["flash_bwd_dq"]),
                "flash_bwd_dkv": max(
                    check_close(torch, f"flash_bwd_dkv dk {tag}", dk, rdk,
                                **TOL["flash_bwd_dkv"]),
                    check_close(torch, f"flash_bwd_dkv dv {tag}", dv, rdv,
                                **TOL["flash_bwd_dkv"]))}
        if causal and sq > sk and dq[:, :sq - sk].abs().max().item() != 0.0:
            raise AssertionError("flash_bwd_dq: rows with no key must get "
                                 "a zero gradient")
        for name, err in errs.items():
            cases.append((name, tag, err))
        if dt != bf and d == 128:      # the other instances' times
            pairs = causal_pairs(sq, sk) * hq * b
            es = q.element_size()
            io = (q.numel() + k.numel() + v.numel() + do.numel()) * es \
                + (lse.numel() + delta.numel()) * 4
            plain_ms = time_ms(torch, lambda: ops.flash_attention_bwd_ref(
                q, k, v, out, lse, do, *args), reps=3, warmup=1)
            for name, fn, n_out, flops in (
                    ("flash_bwd_dq", lambda: ops.flash_attention_bwd_dq(
                        q, k, v, do, lse, delta, *args), dq.numel(), 6),
                    ("flash_bwd_dkv", lambda: ops.flash_attention_bwd_dkv(
                        q, k, v, do, lse, delta, *args),
                     dk.numel() + dv.numel(), 8)):
                bms, by = bound(io + n_out * es, flops * d * pairs,
                                FP32_FLOPS if dt == f32 else BF16_FLOPS)
                rows[name]["instances"][f"{name}_{ENTRY[str(dt)]}"] = dict(
                    shape=tag, ms=time_ms(torch, fn), plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, max_abs_err=errs[name])
        if (b, sq) != (B, S):
            continue
        # the training shape: times and bounds
        pairs = causal_pairs(sq, sk) * hq * b
        io = (q.numel() + k.numel() + v.numel() + do.numel()) * 2 \
            + (lse.numel() + delta.numel()) * 4
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        do_lib = do.transpose(1, 2).contiguous()
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), do_lib, retain_graph=True))
        plain_ms = time_ms(torch, lambda: ops.flash_attention_bwd_ref(
            q, k, v, out, lse, do, *args), reps=3, warmup=1)
        bms, by = bound(io + dq.numel() * 2, 6 * d * pairs, BF16_FLOPS)
        rows["flash_bwd_dq"] = dict(
            shape=tag, ms=time_ms(torch, lambda: ops.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, *args)),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            instances={})
        bms, by = bound(io + (dk.numel() + dv.numel()) * 2, 8 * d * pairs,
                        BF16_FLOPS)
        rows["flash_bwd_dkv"] = dict(
            shape=tag, ms=time_ms(torch, lambda: ops.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, *args)),
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            instances={})
        rows["flash_fwd"]["train_shape_ms"] = time_ms(
            torch, lambda: ops.flash_attention_bshd(q, k, v, causal=True))
        del qt, kt, vt, o_lib


# -- phase 4: kernel path against plain path, end to end ---------------------


def matched_tokens(torch, np, cpu, prompts, card, plain,
                   near_tie=NEAR_TIE) -> list:
    """Per prompt, how many leading tokens the card's greedy stream shares
    with the CPU's; raises where they part although the plain model's top-2
    margin there is at least ``near_tie``."""
    matched = []
    with torch.no_grad():
        for p, a, c in zip(prompts, card, plain):
            n = next((i for i in range(len(c)) if a[i] != c[i]), len(c))
            matched.append(n)
            if n < len(c):
                seq = torch.from_numpy(
                    np.concatenate([p, c[:n]]).astype(np.int64))[None]
                top2 = cpu(seq)[0, -1].float().topk(2).values
                margin = (top2[0] - top2[1]).item()
                if margin >= near_tie:
                    raise AssertionError(
                        f"end to end: greedy streams split at token {n} "
                        f"where the plain top-2 margin is {margin:.3g} "
                        f">= {near_tie}")
    return matched


def e2e_phase(torch, dev, np):
    from paddle_tpu_torch import (CausalLMEngine, ContinuousBatchingEngine,
                                  GenerationConfig, LlamaForCausalLM,
                                  PagedContinuousBatchingEngine, llama_config)

    cfg = llama_config(PRESET, num_hidden_layers=2, dtype="bfloat16")
    gpu = LlamaForCausalLM(cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(7))
    cpu = LlamaForCausalLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (100, 37)]
    rec = {"layers": 2, "prompts": [len(p) for p in prompts]}
    errs = []
    with torch.no_grad():
        for p in prompts:
            width = 1 << max(4, (len(p) - 1).bit_length())   # its bucket
            ids = np.zeros((1, width), np.int32)
            ids[0, :len(p)] = p
            outs = []
            for m, d in ((gpu, dev), (cpu, "cpu")):
                lg, _ = m.forward_with_cache(
                    torch.from_numpy(ids).to(d), m.init_cache(1, width), 0)
                outs.append(lg[0, :len(p)].float().cpu())
            errs.append((outs[0] - outs[1]).abs().max().item())
    rec["prefill_logit_max_abs_err"] = max(errs)
    if max(errs) > LOGIT_ATOL:
        raise AssertionError(f"end to end: prefill logits differ by "
                             f"{max(errs):.3g} > {LOGIT_ATOL}")
    gen = GenerationConfig(max_new_tokens=8)
    plen = min(len(p) for p in prompts)
    ids = np.stack([p[:plen] for p in prompts])
    engines = {
        "greedy": lambda m: PagedContinuousBatchingEngine(
            m, max_batch=2, num_pages=32, page_size=16, max_pages=16),
        "int8": lambda m: PagedContinuousBatchingEngine(
            m, max_batch=2, num_pages=32, page_size=16, max_pages=16,
            kv_dtype="int8"),
        "dense": lambda m: ContinuousBatchingEngine(m, max_batch=2,
                                                    max_len=256),
        # generate on both prompts cut to the shorter one's length
        "generate": lambda m: CausalLMEngine(m, max_batch=2, max_len=256),
    }
    rec["graphs"] = {}
    card_plain = {}
    for name, make in engines.items():
        if name == "generate":
            def run(e):
                return list(e.generate(ids, gen)[:, plen:])
            warm, firsts = 2, list(ids)
        else:
            def run(e):
                return e.serve(prompts, gen, segment_steps=4)
            warm, firsts = 4, prompts
        eager = make(gpu)
        eager.programs.capture = False
        want = run(eager)
        eng = make(gpu)
        eng.warmup(warm)
        before = dict(eng.programs.captures)
        got = run(eng)
        eng.reset_state()
        again = run(eng)
        for what, out in (("graphed", got), ("after reset_state", again)):
            if [o.tolist() for o in out] != [w.tolist() for w in want]:
                raise AssertionError(
                    f"end to end, {name}: the {what} streams {out} differ "
                    f"from the uncaptured ones {want} on the card")
        if eng.programs.captures != before:
            raise AssertionError(f"end to end, {name}: captures "
                                 f"{eng.programs.captures} after warmup's "
                                 f"{before}")
        rec["graphs"][name] = {str(k): n for k, n in before.items()}
        rec[f"{name}_tokens_matched"] = matched_tokens(
            torch, np, cpu, firsts, got, run(make(cpu)))
        card_plain[name] = got
        del eager, eng
    rec["spec"] = spec_e2e(torch, np, gpu, cpu, prompts, gen,
                           {name: (engines[name], card_plain[name])
                            for name in ("greedy", "int8", "dense")})
    rec["chunked_sampled"] = chunk_sample_e2e(torch, np, gpu, cpu)
    rec["prefix_pressure"] = prefix_pressure_e2e(torch, np, gpu, cpu)
    rec["lora"] = lora_e2e(torch, np, gpu, cpu)
    del gpu, cpu
    torch.cuda.empty_cache()
    return rec


def check_spec_launches(counts, L, W, n_pre, n_steps, n_verify, decode,
                        what, **more):
    """A speculating serve's launches: the prefills' (one-shot), and per
    model forward (prefill, plain step or verify step) one rms_norm a norm;
    the decode kernel once a layer a plain step and W times a layer a
    verify step (once per window position)."""
    check_launches(counts, expect(
        counts, rms_norm=(2 * L + 1) * (n_pre + n_steps + n_verify
                                        + more.get("n_chunks", 0)),
        fused_rope=2 * L * (n_pre + more.get("n_chunks", 0)),
        flash_fwd=L * n_pre,
        flash_fwd_prefix=L * more.get("n_chunks", 0),
        **{decode: L * (n_steps + W * n_verify)}),
        f"{what}: prefills {n_pre}, chunks {more.get('n_chunks', 0)}, "
        f"decode steps {n_steps}, verify steps {n_verify} of {W} tokens, "
        f"layers {L}")


def oracle_drafts(np, eng, prompts, streams):
    """Make ``eng`` draft from known streams (the plain engine's): a
    request whose prompt is ``prompts[i]`` gets ``streams[i]`` as its
    drafts, through a host proposer that reads them off the stream
    (``spec_mode="host"``) and through a history ring seeded with the
    stream and then its first token again, so the device lookup's suffix
    match continues it (``"device"``). With random weights the model's
    text never repeats, so n-gram drafts are all rejected; this forces
    the accepting path (several tokens a verify step, the int8 commit of
    several rows, the ring's shift) while every emitted token stays the
    model's own. Shadows two engine methods on the instance; returns the
    function that removes them."""
    from paddle_tpu_torch.inference.ngram import NgramProposer

    known = {tuple(np.asarray(p).tolist()): [int(t) for t in st]
             for p, st in zip(prompts, streams)}

    class Oracle(NgramProposer):
        def __init__(self, ctx, k, stream, plen):
            super().__init__(ctx, k, 1)
            self.stream, self.plen = stream, plen

        def propose(self, k=None):
            k = self.k if k is None else int(k)
            self.proposed += k
            at = len(self.ctx) - self.plen    # the tokens emitted so far
            d = self.stream[at:at + k] or [self.ctx[-1]]
            return (d + [d[-1]] * k)[:k]

    init_spec, install = eng._init_spec, eng._install_state

    def oracle_init_spec(rid, ids, first, cfg):
        init_spec(rid, ids, first, cfg)
        st = known.get(tuple(np.asarray(ids).reshape(-1).tolist()))
        prop = eng._spec.get(rid)
        if prop is not None and st is not None:
            eng._spec[rid] = Oracle(prop.ctx, prop.k, st, np.size(ids))

    def oracle_install(slot, plen, first, tok_done, cfg, ids=None):
        install(slot, plen, first, tok_done, cfg, ids)
        st = None if ids is None else known.get(
            tuple(np.asarray(ids).reshape(-1).tolist()))
        if st is not None:
            ring = st + st[:1]
            eng.hist[slot, :len(ring)] = eng.hist.new_tensor(ring)
            eng.hist_len[slot] = len(ring)

    eng._init_spec, eng._install_state = oracle_init_spec, oracle_install

    def restore():
        del eng.__dict__["_init_spec"], eng.__dict__["_install_state"]
    return restore


def spec_e2e(torch, np, gpu, cpu, prompts, gen, plain):
    """Speculative decoding at 2 layers of the 7B widths: the paged engine
    with bf16 and with int8 pools and the dense engine (``plain[name]``:
    its maker and the card's plain greedy streams), each with
    ``draft_k=SPEC["draft_k"]`` in every (spec_mode, spec_draft) of
    SPEC["modes"], every request opted in. On the card: the engine run
    uncaptured, then warmed (its spec programs captured) and run again
    and after ``reset_state()``, both bitwise the uncaptured streams, no
    capture after warmup, the launches held against the path's (the
    decode kernel W times a layer a verify step); the first token where
    the spec streams part from the plain ones, with the top-2 margin there
    (the phase fails at a margin of NEAR_TIE or more). On the CPU the same
    engine in the first mode: each mode's card streams against its, up to
    a near-tie. Random weights reject every n-gram draft, so each engine
    runs again in host and device mode with oracle drafts (the card's
    plain streams, :func:`oracle_drafts`), uncaptured and captured: the
    two bitwise equal, spec against plain as above, launches the path's,
    and drafts accepted (the phase fails if none is)."""
    from paddle_tpu_torch import GenerationConfig, ops

    k = SPEC["draft_k"]
    L, W = gpu.config.num_hidden_layers, k + 1
    spec = GenerationConfig(max_new_tokens=gen.max_new_tokens,
                            speculative=True)
    rec = {"draft_k": k, "max_new_tokens": spec.max_new_tokens}
    t_card = t_cpu = 0.0

    def serve(make, m, mode, draft, capture=True, warm=False, oracle=None):
        """(engine, streams) of a fresh ``make(m)`` in the mode (with
        ``oracle``, the streams its drafts come from)."""
        e = make(m)
        e.programs.capture = capture
        e.draft_k, e.spec_mode, e.spec_draft = k, mode, draft
        if oracle is not None:
            oracle_drafts(np, e, prompts, oracle)
        if warm:
            e.warmup(4)
        return e, (None if warm else e.serve(prompts, spec,
                                             segment_steps=4))

    def spec_run(name, tag, make, plain_outs, mode, draft, oracle=None):
        """The uncaptured and the warmed run of one engine and mode, held
        against each other, the path's launches and the plain streams;
        returns (the warmed run's streams, its record)."""
        want = serve(make, gpu, mode, draft, capture=False,
                     oracle=oracle)[1]
        eng = serve(make, gpu, mode, draft, warm=True, oracle=oracle)[0]
        before = dict(eng.programs.captures)
        n0 = (eng.prefills, eng.decode_steps, eng.verify_steps)
        got, counts = counted_run(torch, ops, eng, lambda: eng.serve(
            prompts, spec, segment_steps=4))
        n_pre, n_steps, n_verify = (a - b for a, b in zip(
            (eng.prefills, eng.decode_steps, eng.verify_steps), n0))
        check_spec_launches(counts, L, W, n_pre, n_steps, n_verify,
                            "decode_mha" if name == "dense"
                            else "paged_decode", f"spec e2e {tag}")
        st = eng.spec_stats()
        eng.reset_state()
        again = eng.serve(prompts, spec, segment_steps=4)
        for what, out in (("graphed", got), ("after reset_state", again)):
            if [o.tolist() for o in out] != [w.tolist() for w in want]:
                raise AssertionError(
                    f"spec e2e {tag}: the {what} streams {out} differ "
                    f"from the uncaptured ones {want} on the card")
        if eng.programs.captures != before:
            raise AssertionError(f"spec e2e {tag}: captures "
                                 f"{eng.programs.captures} after "
                                 f"warmup's {before}")
        splits, margins = first_splits(torch, np, gpu, prompts, got,
                                       plain_outs)
        for n, mg in zip(splits, margins):
            if mg is not None and mg >= NEAR_TIE:
                raise AssertionError(
                    f"spec e2e {tag}: spec and plain streams part at "
                    f"token {n} where the top-2 margin is {mg:.3g} >= "
                    f"{NEAR_TIE}")
        if oracle is not None and st["accepted"] < 1:
            raise AssertionError(f"spec e2e {tag}: no oracle draft was "
                                 f"accepted ({st})")
        return got, {"first_split_from_plain": splits,
                     "split_top2_margins": margins,
                     "graphs": {str(key): n for key, n in before.items()},
                     "verify_steps": n_verify, "launches": counts,
                     "tokens_per_forward": st["tokens_per_forward"],
                     "acceptance_rate": st["acceptance_rate"]}

    for name, (make, plain_outs) in plain.items():
        t0 = time.perf_counter()
        cpu_outs = serve(make, cpu, *SPEC["modes"][0])[1]
        t_cpu += time.perf_counter() - t0
        rec[f"{name}_tokens_matched_cpu"] = {}
        for mode, draft in SPEC["modes"]:
            t0 = time.perf_counter()
            tag = f"{name}_{mode}_{draft}"
            got, rec[tag] = spec_run(name, tag, make, plain_outs, mode,
                                     draft)
            t_card += time.perf_counter() - t0
            t0 = time.perf_counter()
            rec[f"{name}_tokens_matched_cpu"][f"{mode}_{draft}"] = \
                matched_tokens(torch, np, cpu, prompts, got, cpu_outs)
            t_cpu += time.perf_counter() - t0
        t0 = time.perf_counter()
        for mode in ("host", "device"):
            tag = f"{name}_{mode}_oracle"
            rec[tag] = spec_run(name, tag, make, plain_outs, mode, "ngram",
                                oracle=plain_outs)[1]
        t_card += time.perf_counter() - t0
    rec.update(card_s=t_card, cpu_s=t_cpu)
    return rec


def prefix_pressure_e2e(torch, np, gpu, cpu):
    """This slice's legs at 2 layers of the 7B widths (PREFIX_E2E): four
    prompts sharing a 48-token prefix, then the same prompts cut inside
    their last full block, through a paged engine with ``prefix_cache=True``
    (warm admissions, copy-on-write of a partial shared page), and the
    prompts again through an optimistic engine with the cache on and a pool
    of PREFIX_E2E["pool"] pages (preemption and replay inside ``serve``).
    On the card, each engine warmed: warm streams equal to the prefix-off
    engine's and preempted streams equal to unpreempted ones, token for
    token (first split and its margin recorded where one parts, and the
    phase fails), no capture after warmup; and the card's streams against
    the same engines' on the CPU (up to a near-tie)."""
    from paddle_tpu_torch import (GenerationConfig,
                                  PagedContinuousBatchingEngine)

    vocab, ps = gpu.config.vocab_size, PREFIX_E2E["page"]
    rng = np.random.RandomState(13)
    shared = rng.randint(0, vocab, (PREFIX_E2E["prefix"],))
    prompts = [np.concatenate([shared, rng.randint(0, vocab, (m,))]).astype(
        np.int32) for m in PREFIX_E2E["suffixes"]]
    cut = cut_prompts(prompts, ps)
    gen = GenerationConfig(max_new_tokens=PREFIX_E2E["new"])
    long = GenerationConfig(max_new_tokens=PREFIX_E2E["pressure_new"])
    kw = dict(max_batch=4, page_size=ps, max_pages=256 // ps)

    def legs(m, warm):
        """(prefix-on streams of both rounds, their counters, the optimistic
        engine's streams and preemptions) on model ``m``."""
        eng = PagedContinuousBatchingEngine(m, num_pages=64,
                                            prefix_cache=True, **kw)
        opt = PagedContinuousBatchingEngine(
            m, num_pages=PREFIX_E2E["pool"], prefix_cache=True,
            admission_mode="optimistic", kv_watermark=1.0, **kw)
        caps = []
        for e in (eng, opt):
            if warm:
                e.warmup(4)
            caps.append(dict(e.programs.captures))
        rounds = [eng.serve(p, gen, segment_steps=4) for p in (prompts, cut)]
        pressed = opt.serve(prompts, long, segment_steps=4)
        if warm and [eng.programs.captures,
                     opt.programs.captures] != caps:
            raise AssertionError(f"prefix e2e: captures after warmup "
                                 f"{eng.programs.captures}, "
                                 f"{opt.programs.captures}")
        a = eng.alloc
        for e in (eng, opt):
            e.alloc.check()
        return (rounds, dict(hits=a.prefix_hits, cow=a.cow_copies,
                             saved=a.prefix_tokens_saved),
                pressed, opt.alloc.preemptions)

    rec = {"prefix": PREFIX_E2E["prefix"], "prompt_lens": [
        len(p) for p in prompts], "cut_lens": [len(p) for p in cut],
        "pool_pages": PREFIX_E2E["pool"]}
    t0 = time.perf_counter()
    rounds, counters, pressed, preempts = legs(gpu, True)
    if preempts < 1 or counters["cow"] < 1 or counters["hits"] < 7:
        raise AssertionError(f"prefix e2e: counters {counters}, "
                             f"preemptions {preempts}")
    plain = PagedContinuousBatchingEngine(gpu, num_pages=64, **kw)
    plain.warmup(4)
    cold = [plain.serve(p, gen, segment_steps=4) for p in (prompts, cut)]
    unpressed = plain.serve(prompts, long, segment_steps=4)
    for i, (p, w, c) in enumerate(zip((prompts, cut), rounds, cold)):
        splits, margins = equal_streams(torch, np, gpu, p, w, c,
                                        f"prefix e2e round {i + 1}")
        rec[f"round{i + 1}_first_split_from_cold"] = splits
        rec[f"round{i + 1}_split_top2_margins"] = margins
    splits, margins = equal_streams(torch, np, gpu, prompts, pressed,
                                    unpressed, "pressure e2e")
    rec.update(preempted_first_split_from_unpreempted=splits,
               preempted_split_top2_margins=margins, counters=counters,
               preemptions=preempts, card_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    c_rounds, c_counters, c_pressed, c_preempts = legs(cpu, False)
    rec["cpu_s"] = time.perf_counter() - t0
    if c_counters != counters:
        raise AssertionError(f"prefix e2e: CPU counters {c_counters} != "
                             f"the card's {counters}")
    for i, (p, w, c) in enumerate(zip((prompts, cut), rounds, c_rounds)):
        rec[f"round{i + 1}_tokens_matched_cpu"] = matched_tokens(
            torch, np, cpu, p, w, c)
    rec["pressure_tokens_matched_cpu"] = matched_tokens(
        torch, np, cpu, prompts, pressed, c_pressed)
    rec["cpu_preemptions"] = c_preempts
    return rec


def lora_factors(np, model, targets, rank, seed, scale=None, per_layer=True):
    """Seeded numpy LoRA factors ``{target: (A, B)}`` at ``model``'s widths
    (``lora_shapes``): A ``[L, rank, d_in]``, B ``[L, d_out, rank]`` (or
    one pair for every layer), normals of std ``scale``."""
    L, shapes = model.lora_shapes(targets)
    rng = np.random.RandomState(seed)
    sd = LORA["scale"] if scale is None else scale
    lead = (L,) if per_layer else ()
    return {t: ((rng.standard_normal(lead + (rank, d_in)) * sd).astype(
                np.float32),
                (rng.standard_normal(lead + (d_out, rank)) * sd).astype(
                np.float32))
            for t, (d_in, d_out) in shapes.items()}


def bank_ptrs(eng) -> list:
    return [t.data_ptr() for ab in eng.adapters.bank.values() for t in ab]


def lora_margin(torch, np, model, bank, aidx, prompt, stream, n) -> float:
    """The top-2 margin of ``model``'s next-token logits after ``prompt``
    and ``stream[:n]``, under the adapter at bank index ``aidx``."""
    seq = np.concatenate([prompt, np.asarray(stream[:n])]).astype(np.int32)
    dev = model.device
    with torch.no_grad():
        lg, _ = model.forward_with_cache(
            torch.from_numpy(seq)[None].to(dev),
            model.init_cache(1, len(seq)), 0,
            lora=(bank, torch.tensor([aidx], dtype=torch.int32,
                                     device=dev)))
    top2 = lg[0, -1].float().topk(2).values
    return (top2[0] - top2[1]).item()


def lora_splits(torch, np, model, bank, aidx, prompts, outs, ref_outs,
                what, near_tie=NEAR_TIE):
    """Per prompt, the first token where ``outs`` parts from ``ref_outs``
    and the top-2 margin there under the row's adapter (``aidx[i]``,
    ``bank``); raises where they part at a margin of ``near_tie`` or
    more."""
    splits, margins = [], []
    for i, (p, o, r) in enumerate(zip(prompts, outs, ref_outs)):
        n = next((j for j in range(len(r)) if o[j] != r[j]), len(r))
        mg = (None if n == len(r) else
              lora_margin(torch, np, model, bank, aidx[i], p, r, n))
        if mg is not None and mg >= near_tie:
            raise AssertionError(
                f"{what}: stream {i} parts at token {n} where the top-2 "
                f"margin under its adapter is {mg:.3g} >= {near_tie}")
        splits.append(n)
        margins.append(mg)
    return splits, margins


def merged_model(torch, np, model, params, scale):
    """A copy of ``model`` with one adapter merged into its weights,
    ``W + (B A)^T * scale`` per layer and target (in fp32, then the
    model's dtype): the merged-weights oracle of a LoRA forward."""
    from paddle_tpu_torch import LlamaForCausalLM

    m = LlamaForCausalLM(model.config, device=model.device)
    m.load_state_dict(model.state_dict())
    with torch.no_grad():
        for i, layer in enumerate(m.model.layers):
            at, mlp = layer.self_attn, layer.mlp
            projs = {"q": at.q_proj, "k": at.k_proj, "v": at.v_proj,
                     "o": at.o_proj, "gate": mlp.gate_proj,
                     "up": mlp.up_proj, "down": mlp.down_proj}
            for t, (a, b) in params.items():
                w = projs[t].weight
                delta = torch.from_numpy((b[i] @ a[i]).T * scale)
                w.copy_((w.float() + delta.to(w.device)).to(w.dtype))
    return m


def merged_oracle(torch, np, model, make, lora_kw, params, prompt) -> dict:
    """The merged-weights oracle of a LoRA prefill, in fp32 on the card, so
    the two association orders' roundings lie far below what it must
    catch: ``model``'s weights in fp32, an engine from ``make`` with
    ``lora_kw`` and ``params`` loaded at index 1, its prefill's last
    logits against a LoRA-free engine's over ``W + (B A)^T * alpha / r``,
    within MERGED_ATOL. Two faulty merges are read beside it and must read
    above the limit: the scale of the bank's rank (alpha / 16 in place of
    alpha / r) and the merge without the ``down`` target."""
    import dataclasses

    from paddle_tpu_torch import LlamaForCausalLM

    m32 = LlamaForCausalLM(dataclasses.replace(model.config, dtype="float32"),
                           device=model.device)
    m32.load_state_dict(model.state_dict())
    eng = make(m32, **lora_kw)
    eng.load_adapter("a1", params, alpha=LORA["alpha"])
    ids = np.asarray([prompt], np.int32)
    plen, width = ids.shape[1], eng._prefill_width(ids.shape[1])
    rank = next(iter(params.values()))[0].shape[-2]

    def last(e, m, **kw):
        return e._run_prefill(ids, plen, m.init_cache(1, width),
                              **kw)[0].float()

    reads = {}
    with torch.no_grad():
        got = last(eng, m32, lora=(eng.adapters.bank, torch.ones(
            1, dtype=torch.int32, device=model.device)))
        moved = (got - last(eng, m32)).abs().max().item()
        for what, p, scale in (
                ("sound", params, LORA["alpha"] / rank),
                ("bank_rank_scale", params, LORA["alpha"] / LORA["rank"]),
                ("no_down", {t: ab for t, ab in params.items()
                             if t != "down"}, LORA["alpha"] / rank)):
            m = merged_model(torch, np, m32, p, scale)
            reads[what] = (got - last(make(m), m)).abs().max().item()
            del m
    del eng, m32
    torch.cuda.empty_cache()
    if reads["sound"] > MERGED_ATOL:
        raise AssertionError(
            f"lora e2e: merged-weights oracle in fp32, last logits differ by "
            f"{reads['sound']:.3g} > {MERGED_ATOL}")
    weak = [w for w in ("bank_rank_scale", "no_down")
            if reads[w] <= MERGED_ATOL]
    if weak:
        raise AssertionError(f"lora e2e: the faulty merges {weak} read "
                             f"within the limit {MERGED_ATOL}: {reads}")
    return {"adapter": "a1", "rank": rank, "prompt": plen,
            "dtype": "float32", "max_abs_err": reads["sound"],
            "faults": {w: reads[w] for w in ("bank_rank_scale", "no_down")},
            "lora_moved_logits_by": moved, "atol": MERGED_ATOL}


def lora_e2e(torch, np, gpu, cpu):
    """Multi-tenant LoRA at 2 layers of the 7B widths (LORA): the paged
    engine with bf16 and with int8 pools and the dense engine, each with a
    bank of 3 slots of rank 16 on every target projection, serving one
    batch of a base request and two adapter requests (rank 8, zero-padded,
    and rank 16), 8 greedy tokens each. On the card: the engine run
    uncaptured, then warmed and the adapters hot-loaded AFTER ``warmup()``
    (no capture; the bank keeps its addresses), its streams bitwise the
    uncaptured ones, each row bitwise the same request served alone, the
    base row bitwise a LoRA-free engine's, launches the path's (LoRA adds
    no kernel); the card's streams against the CPU's, failing at a
    near-tie-free split under the row's adapter. The merged-weights
    oracle (:func:`merged_oracle`, in fp32): the rank-8 adapter's prefill
    logits within MERGED_ATOL of a LoRA-free engine over ``W + (B A)^T *
    alpha / r``. Speculation: the
    paged engine with ``draft_k=4`` in host and device mode with oracle
    drafts (the LoRA streams), every row speculating, against the plain
    LoRA streams up to a near-tie, drafts accepted, launches the path's."""
    from paddle_tpu_torch import (ContinuousBatchingEngine, GenerationConfig,
                                  PagedContinuousBatchingEngine, ops)

    cfg = gpu.config
    L, new, k = cfg.num_hidden_layers, LORA["new"], SPEC["draft_k"]
    rng = np.random.RandomState(LORA["seed"])
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in LORA["prompts"]]
    adapters = {f"a{i + 1}": lora_factors(np, gpu, LORA["targets"], r,
                                          LORA["seed"] + 1 + i)
                for i, r in enumerate(LORA["ranks"])}
    names = (None,) + tuple(adapters)
    aidx = list(range(len(names)))         # the load order's bank indices
    cfgs = [GenerationConfig(max_new_tokens=new, adapter=a) for a in names]
    base = [GenerationConfig(max_new_tokens=new)] * len(prompts)
    lora_kw = dict(lora_capacity=LORA["capacity"], lora_rank=LORA["rank"],
                   lora_targets=LORA["targets"])
    makers = {
        "paged": lambda m, **kw: PagedContinuousBatchingEngine(
            m, max_batch=3, num_pages=48, page_size=16, max_pages=16, **kw),
        "paged_int8": lambda m, **kw: PagedContinuousBatchingEngine(
            m, max_batch=3, num_pages=48, page_size=16, max_pages=16,
            kv_dtype="int8", **kw),
        "dense": lambda m, **kw: ContinuousBatchingEngine(
            m, max_batch=3, max_len=256, **kw)}

    def loaded(e):
        for name, params in adapters.items():
            e.load_adapter(name, params, alpha=LORA["alpha"])
        return e

    rec = {"targets": LORA["targets"], "bank_rank": LORA["rank"],
           "adapter_ranks": LORA["ranks"], "alpha": LORA["alpha"],
           "prompts": [len(p) for p in prompts], "adapters": names,
           "max_new_tokens": new}
    t_card = t_cpu = 0.0
    streams = {}
    for kind, make in makers.items():
        t0 = time.perf_counter()
        decode = "decode_mha" if kind == "dense" else "paged_decode"
        eager = loaded(make(gpu, **lora_kw))
        eager.programs.capture = False
        want = eager.serve(prompts, cfgs, segment_steps=4)
        del eager
        eng = make(gpu, **lora_kw)
        warm = eng.warmup(4)
        before, ptrs = dict(eng.programs.captures), bank_ptrs(eng)
        loaded(eng)                        # hot loads after warmup
        p0, s0 = eng.prefills, eng.decode_steps
        got, counts = counted_run(torch, ops, eng, lambda: eng.serve(
            prompts, cfgs, segment_steps=4))
        check_serve_launches(counts, L, eng.prefills - p0,
                             eng.decode_steps - s0, decode)
        solo = [eng.serve([p], [c], segment_steps=4)[0]
                for p, c in zip(prompts, cfgs)]
        plain = make(gpu).serve(prompts, base, segment_steps=4)
        for what, a, b in (("captured", got, want), ("solo", solo, got)):
            if [o.tolist() for o in a] != [w.tolist() for w in b]:
                raise AssertionError(
                    f"lora e2e {kind}: the {what} streams {a} differ from "
                    f"{b} on the card")
        if got[0].tolist() != plain[0].tolist():
            raise AssertionError(
                f"lora e2e {kind}: the base row {got[0]} differs from the "
                f"LoRA-free engine's {plain[0]}")
        if [o.tolist() for o in got[1:]] == [o.tolist() for o in plain[1:]]:
            raise AssertionError(f"lora e2e {kind}: the adapter rows are "
                                 f"the base model's")
        if eng.programs.captures != before or bank_ptrs(eng) != ptrs:
            raise AssertionError(
                f"lora e2e {kind}: captures {eng.programs.captures} after "
                f"warmup's {before}, or the bank moved")
        t_card += time.perf_counter() - t0
        t0 = time.perf_counter()
        ceng = loaded(make(cpu, **lora_kw))
        cpu_outs = ceng.serve(prompts, cfgs, segment_steps=4)
        splits, margins = lora_splits(torch, np, cpu, ceng.adapters.bank,
                                      aidx, prompts, got, cpu_outs,
                                      f"lora e2e {kind} card against CPU")
        t_cpu += time.perf_counter() - t0
        streams[kind] = got
        rec[kind] = {"graphs": {str(key): n for key, n in before.items()},
                     "lora_install_s": warm["lora_install"],
                     "launches": counts, "tokens_matched_cpu": splits,
                     "split_top2_margins_cpu": margins,
                     "captures_after_warmup": 0}
        if kind == "paged":
            t0 = time.perf_counter()
            rec["merged_oracle"] = merged_oracle(
                torch, np, gpu, make, lora_kw, adapters["a1"], prompts[1])
            t_card += time.perf_counter() - t0
        del eng, ceng
    t0 = time.perf_counter()
    spec = [GenerationConfig(max_new_tokens=new, adapter=a, speculative=True)
            for a in names]
    for mode in ("host", "device"):
        e = makers["paged"](gpu, draft_k=k, spec_mode=mode, **lora_kw)
        restore = oracle_drafts(np, e, prompts, streams["paged"])
        e.warmup(4)
        before = dict(e.programs.captures)
        loaded(e)
        n0 = (e.prefills, e.decode_steps, e.verify_steps)
        outs, counts = counted_run(torch, ops, e, lambda: e.serve(
            prompts, spec, segment_steps=4))
        n_pre, n_steps, n_verify = (a - b for a, b in zip(
            (e.prefills, e.decode_steps, e.verify_steps), n0))
        check_spec_launches(counts, L, k + 1, n_pre, n_steps, n_verify,
                            "paged_decode", f"lora spec e2e ({mode})")
        st = e.spec_stats()
        restore()
        if st["accepted"] < 1 or e.programs.captures != before:
            raise AssertionError(f"lora spec e2e ({mode}): accepted "
                                 f"{st['accepted']}, captures "
                                 f"{e.programs.captures} against {before}")
        splits, margins = lora_splits(
            torch, np, gpu, e.adapters.bank, aidx, prompts, outs,
            streams["paged"], f"lora spec e2e ({mode})")
        rec[f"spec_{mode}_oracle"] = {
            "verify_steps": n_verify, "launches": counts,
            "tokens_per_forward": st["tokens_per_forward"],
            "first_split_from_plain": splits, "split_top2_margins": margins}
        del e
    t_card += time.perf_counter() - t0
    rec.update(card_s=t_card, cpu_s=t_cpu)
    torch.cuda.empty_cache()
    return rec


def chunked_logits(torch, np, m, ids, chunk, width):
    """Last-position logits [B, V] (fp32, on the CPU) of ``ids`` prefilled
    through ``forward_with_cache`` in chunks of ``chunk`` at device offsets
    (the last chunk padded), into a cache of ``width`` rows."""
    dev = m.device
    caches = m.init_cache(ids.shape[0], width)
    with torch.no_grad():
        for pos in range(0, ids.shape[1], chunk):
            part = ids[:, pos:pos + chunk]
            ids_c = np.zeros((ids.shape[0], chunk), np.int32)
            ids_c[:, :part.shape[1]] = part
            lg, caches = m.forward_with_cache(
                torch.from_numpy(ids_c).to(dev), caches,
                torch.tensor(pos, dtype=torch.int32, device=dev))
    return lg[:, part.shape[1] - 1].float().cpu()


def gap_admit(eng, prompts, cfgs, steps=4):
    """Request 1 admitted at once, request 0 admitted chunk by chunk with a
    decode segment between chunks, then both decoded to the end. Returns
    (the two streams in prompt order, the chunked admission's last logits
    [1, V] fp32 on the CPU)."""
    other = eng.add_request(prompts[1], cfgs[1])
    adm = eng.begin_admit(prompts[0], cfgs[0])
    while not eng.admit_chunk(adm):
        eng.decode_segment(steps)
    logits = adm.last_logits.float().cpu()
    while eng.decode_segment(steps):
        pass
    done = eng.collect_finished()
    return [done[adm.rid], done[other]], logits


def chunk_sample_e2e(torch, np, gpu, cpu):
    """Chunked prefill and sampling at 2 layers of the 7B widths (this
    slice's paths): the card's kernels against the CPU's plain versions,
    and the card's captured programs against the same run uncaptured.

    - ``CausalLMEngine(prefill_chunk=64)`` on 2 prompts of 150 tokens
      (chunks at 0, 64, 128, the last partial): last-position logits
      within LOGIT_ATOL of the CPU's and of the card's one-shot prefill;
      greedy streams against the CPU's (up to a near-tie) and against the
      card's one-shot engine's (first split recorded, and only at a
      near-tie).
    - A chunked paged admission (chunks of 64, a decode segment of another
      request between chunks): its last logits and both greedy streams
      against the CPU's.
    - A sampled ``generate`` and a mixed greedy and sampled paged serve,
      warmed (captured) against uncaptured on the card: bitwise.
    - One seeded sampled request served alone and inside the mixed batch
      (another slot, other batch-mates): the same tokens."""
    from paddle_tpu_torch import (CausalLMEngine, GenerationConfig,
                                  PagedContinuousBatchingEngine)

    chunk, vocab = PREFIX["e2e_chunk"], gpu.config.vocab_size
    rng = np.random.RandomState(12)
    ids = rng.randint(0, vocab, (2, 150)).astype(np.int32)
    short = rng.randint(0, vocab, (37,)).astype(np.int32)
    greedy = GenerationConfig(max_new_tokens=8)
    rec = {"chunk": chunk, "prompt_lens": [150, 37]}
    card = chunked_logits(torch, np, gpu, ids, chunk, 256)
    plain = chunked_logits(torch, np, cpu, ids, chunk, 256)
    with torch.no_grad():
        wide = np.zeros((2, 256), np.int32)
        wide[:, :150] = ids
        one, _ = gpu.forward_with_cache(torch.from_numpy(wide).to(
            gpu.device), gpu.init_cache(2, 256), 0)
    one = one[:, 149].float().cpu()
    rec["generate_logit_err_cpu"] = (card - plain).abs().max().item()
    rec["generate_logit_err_one_shot"] = (card - one).abs().max().item()
    if max(rec["generate_logit_err_cpu"],
           rec["generate_logit_err_one_shot"]) > LOGIT_ATOL:
        raise AssertionError(f"chunked prefill: logits {rec} beyond "
                             f"{LOGIT_ATOL}")

    def lm(m, c=chunk):
        return CausalLMEngine(m, max_batch=2, max_len=256, prefill_chunk=c)

    streams = [list(lm(m).generate(ids, greedy)[:, 150:])
               for m in (gpu, cpu)]
    rec["generate_tokens_matched"] = matched_tokens(torch, np, cpu,
                                                    list(ids), *streams)
    one_shot = list(lm(gpu, None).generate(ids, greedy)[:, 150:])
    splits, margins = first_splits(torch, np, gpu, list(ids), streams[0],
                                   one_shot)
    rec.update(generate_first_split_from_one_shot=splits,
               generate_split_top2_margins=margins)
    if any(mg is not None and mg >= NEAR_TIE for mg in margins):
        raise AssertionError(f"chunked generate parts from the one-shot "
                             f"one at {splits}, margins {margins}")

    def paged(m, capture=True, batch=2):
        eng = PagedContinuousBatchingEngine(
            m, max_batch=batch, num_pages=48, page_size=16, max_pages=16,
            prefill_chunk=chunk)
        eng.programs.capture = capture
        return eng

    outs = [gap_admit(paged(m), [ids[0], short], [greedy, greedy])
            for m in (gpu, cpu)]
    rec["admit_logit_err_cpu"] = (outs[0][1] - outs[1][1]).abs().max().item()
    if rec["admit_logit_err_cpu"] > LOGIT_ATOL:
        raise AssertionError(f"chunked admission: logits differ by "
                             f"{rec['admit_logit_err_cpu']:.3g}")
    rec["admit_tokens_matched"] = matched_tokens(
        torch, np, cpu, [ids[0], short], outs[0][0], outs[1][0])

    sampled = [GenerationConfig(max_new_tokens=8, seed=s, **SAMPLED)
               for s in (1, 2)]
    warm = lm(gpu)
    warm.warmup(batch=2)
    before = dict(warm.programs.captures)
    eager = lm(gpu)
    eager.programs.capture = False
    got, want = (e.generate(ids, sampled[0]) for e in (warm, eager))
    if got.tolist() != want.tolist() or warm.programs.captures != before:
        raise AssertionError(f"sampled generate: captured {got.tolist()} "
                             f"against uncaptured {want.tolist()}, captures "
                             f"{warm.programs.captures} after {before}")
    mixed_p = [ids[1], short, ids[0]]
    mixed_c = [sampled[0], greedy, sampled[1]]
    warm = paged(gpu, batch=3)
    warm.warmup(4)
    before = dict(warm.programs.captures)
    got = [o.tolist() for o in warm.serve(mixed_p, mixed_c,
                                          segment_steps=4)]
    want = [o.tolist() for o in paged(gpu, False, 3).serve(
        mixed_p, mixed_c, segment_steps=4)]
    if got != want or warm.programs.captures != before:
        raise AssertionError(f"sampled paged serve: captured {got} against "
                             f"uncaptured {want}")
    alone = warm.serve([ids[0]], [sampled[1]], segment_steps=4)[0].tolist()
    if alone != got[2] or warm.programs.captures != before:
        raise AssertionError(f"a seeded request alone {alone} and in a "
                             f"mixed batch {got[2]}")
    rec.update(sampled_serve_streams=got, sampled_alone=alone,
               captures=dict((str(k), n) for k, n in before.items()))
    return rec


def fmt_e2e_phase(torch, dev, bf=None, atol=FMT_ATOL):
    """FusedMultiTransformer at the 6.7B widths and 2 layers, batch 1 x
    128, on the card and on the CPU from the same weights and inputs in
    ``bf`` (default bf16): the context pass into caches, then
    FMT_E2E["steps"] ragged decode steps; and on the card, each decode
    step against its own context pass over all the tokens at that
    position; every difference within ``atol``."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer

    e, nh, ff = FMT["hidden"], FMT["heads"], FMT["ffn"]
    L, b, s, n = (FMT_E2E[k] for k in ("layers", "batch", "seq", "steps"))
    bf = bf or torch.bfloat16
    gpu = FusedMultiTransformer(e, nh, ff, num_layers=L, device=dev,
                                dtype=bf,
                                generator=torch.Generator(dev).manual_seed(13))
    cpu = FusedMultiTransformer(e, nh, ff, num_layers=L, device="cpu",
                                dtype=bf)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    x = torch.randn(b, s + n, e,
                    generator=torch.Generator().manual_seed(13)).to(bf)
    outs = []
    with torch.no_grad():
        for m, d in ((gpu, dev), (cpu, "cpu")):
            caches = m.make_caches(L, b, s + n, nh, e // nh, bf, d)
            y, caches = m(x[:, :s].to(d), caches=caches)
            steps = []
            for t in range(n):
                yd, caches = m(x[:, s + t:s + t + 1].to(d), caches=caches,
                               time_step=s + t, seq_lens=torch.full(
                                   (b,), s + t, dtype=torch.int32, device=d))
                steps.append(yd)
            outs.append((y.float().cpu(), torch.cat(steps, 1).float().cpu()))
        full = gpu(x.to(dev))[:, s:].float().cpu()
    errs = {"context_max_abs_err": (outs[0][0] - outs[1][0]).abs().max(),
            "decode_max_abs_err": (outs[0][1] - outs[1][1]).abs().max(),
            "decode_vs_context_max_abs_err": (outs[0][1] - full).abs().max()}
    rec = {"layers": L, "batch": b, "context": s, "decode_steps": n,
           "dtype": str(bf), **{k: v.item() for k, v in errs.items()}}
    for k, v in rec.items():
        if k.endswith("err") and not v <= atol:     # NaN fails too
            raise AssertionError(f"fused transformer end to end: {k} {v} "
                                 f"> {atol}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return rec


def train_config(llama_config, **over):
    return llama_config(TRAIN["preset"], **{**TRAIN["overrides"], **over})


def rel_err(torch, got, want) -> float:
    """||got - want|| / ||want|| in fp32 (0 when both are 0)."""
    got, want = got.float(), want.float()
    den = want.norm().item()
    num = (got - want).norm().item()
    return num / den if den else num


def train_e2e_phase(torch, dev, np):
    """The training widths at 2 layers: the Layer API's backward (full
    recompute) and one ``build_train_step`` AdamW step, on the card with
    the kernels and on the CPU with the plain versions, from the same bf16
    weights and batch."""
    from paddle_tpu_torch import (LlamaForCausalLM, build_train_step,
                                  llama_config)

    cfg = train_config(llama_config, num_hidden_layers=TRAIN_E2E["layers"])
    gpu = LlamaForCausalLM(cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(11))
    cpu = LlamaForCausalLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.RandomState(11)
    tok = rng.randint(0, cfg.vocab_size,
                      (TRAIN_E2E["batch"], TRAIN_E2E["seq"] + 1))
    ids = torch.from_numpy(tok[:, :-1].astype(np.int64))
    labels = torch.from_numpy(tok[:, 1:].astype(np.int64))
    rec = {"layers": cfg.num_hidden_layers, "batch": TRAIN_E2E["batch"],
           "seq": TRAIN_E2E["seq"]}

    def compare(what, losses, models, grads_only):
        err = abs(losses[0] - losses[1])
        # the Layer API's loss is a bf16 tensor: one bf16 step more
        atol = TRAIN_LOSS_ATOL + (BF16_STEP * abs(losses[1]) if grads_only
                                  else 0.0)
        if not (np.isfinite(losses).all() and err <= atol):
            raise AssertionError(f"{what}: loss {losses[0]} on the card, "
                                 f"{losses[1]} on the CPU")
        g = {k: rel_err(torch, p.grad.cpu(), models[1].get_parameter(k).grad)
             for k, p in models[0].named_parameters()}
        worst = max(g, key=g.get)
        if g[worst] > TRAIN_GRAD_RTOL:
            raise AssertionError(f"{what}: gradient of {worst} differs by "
                                 f"{g[worst]:.3g} of its norm")
        out = {"loss_card": losses[0], "loss_cpu": losses[1],
               "loss_abs_err": err, "grad_max_rel_err": g[worst],
               "grad_worst": worst}
        if grads_only:
            return out
        pmax = 0.0
        for k, p in models[0].named_parameters():
            want = models[1].get_parameter(k).detach()
            got = p.detach().cpu()
            pmax = max(pmax, check_close(
                torch, f"{what}: updated {k}", got, want, TRAIN_PARAM_ATOL,
                BF16_STEP))
        out["param_max_abs_err"] = pmax
        return out

    # the Layer API: forward with the loss, then backward
    losses = []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        m.train()
        loss = m(ids.to(d), labels.to(d))
        loss.backward()
        losses.append(float(loss.detach()))
    rec["layer_api"] = compare("layer API backward", losses, (gpu, cpu),
                               True)
    # the functional AdamW step
    losses = []
    start = {k: v.detach().clone() for k, v in gpu.state_dict().items()}
    for m, d in ((gpu, dev), (cpu, "cpu")):
        step, init = build_train_step(cfg, lr=TRAIN["lr"],
                                      clip_norm=TRAIN["clip"], remat="full",
                                      device=d)
        losses.append(float(step(m, init(m), ids, labels)))
    rec["train_step"] = compare("train step", losses, (gpu, cpu), False)
    rec["train_step_hb"] = hb_step_bitwise(torch, gpu, cfg, start, ids,
                                           labels, losses[0])
    rec["drift"] = train_drift(torch, np, (gpu, cpu), cfg, start)
    del gpu, cpu
    torch.cuda.empty_cache()
    return rec


def train_drift(torch, np, models, cfg, start):
    """C-check-1: DRIFT_STEPS AdamW steps of the 2-layer bf16 model from the
    same weights, a fresh seeded batch each step, on the card (kernels, with
    their bf16 roundings of P, dS and P_drop) and on the CPU (plain
    versions). Per step the loss on each side and their gap; whether the
    gap grows (its mean over the last 10 steps above twice the first 10's
    and above TRAIN_LOSS_ATOL); the parameters' largest relative gap at
    the end. A measurement, not a gate: only a non-finite loss fails."""
    from paddle_tpu_torch import build_train_step

    losses = ([], [])
    for m, out in zip(models, losses):
        m.load_state_dict({k: v.to(m.device) for k, v in start.items()})
        m.zero_grad(set_to_none=True)
        step, init = build_train_step(cfg, lr=TRAIN["lr"],
                                      clip_norm=TRAIN["clip"], remat="full",
                                      device=m.device)
        state = init(m)
        r = np.random.RandomState(13)
        for _ in range(DRIFT_STEPS):
            tok = r.randint(0, cfg.vocab_size,
                            (TRAIN_E2E["batch"], TRAIN_E2E["seq"] + 1))
            ids = torch.from_numpy(tok[:, :-1].astype(np.int64))
            labels = torch.from_numpy(tok[:, 1:].astype(np.int64))
            out.append(float(step(m, state, ids, labels)))
    gap = [abs(a - b) for a, b in zip(*losses)]
    if not np.isfinite(losses).all():
        raise AssertionError(f"C-check-1: losses {losses}")
    first, last = float(np.mean(gap[:10])), float(np.mean(gap[-10:]))
    slope = float(np.polyfit(np.arange(len(gap)), gap, 1)[0])
    params = {k: rel_err(torch, p.detach().cpu(),
                         models[1].get_parameter(k).detach())
              for k, p in models[0].named_parameters()}
    worst = max(params, key=params.get)
    rec = {"steps": DRIFT_STEPS, "loss_card": losses[0],
           "loss_cpu": losses[1], "loss_gap": gap,
           "gap_mean_first10": first, "gap_mean_last10": last,
           "gap_slope_per_step": slope,
           "grows": bool(last > 2 * first and last > TRAIN_LOSS_ATOL),
           "param_max_rel_err": params[worst], "param_worst": worst}
    log(f"  C-check-1: {DRIFT_STEPS} steps, loss gap per step "
        f"{[round(x, 5) for x in gap]}; mean first 10 {first:.5f}, last 10 "
        f"{last:.5f}, slope {slope:.2e}/step, grows: {rec['grows']}; "
        f"parameters' largest relative gap {params[worst]:.3g} ({worst})")
    return rec


def f32_phase(torch, dev, np):
    """This slice's path: fp32 on the card against the CPU. The "tiny"
    Llama preset (fp32, head dim 16: the flash kernels' fp32 instances at
    width 64, the decode kernels' at width 32) from the same weights: the
    forward's logits, a Layer-API backward with full recompute, one
    ``build_train_step`` AdamW step, ``CausalLMEngine.generate`` and the
    paged engine's greedy stream; then a 2-layer fp32 FusedMultiTransformer
    at the 6.7B widths (head dim 128). Every kernel's launches over the
    path are read just after it, and each kernel the path runs must have
    launched."""
    from paddle_tpu_torch import (CausalLMEngine, GenerationConfig,
                                  LlamaForCausalLM,
                                  PagedContinuousBatchingEngine,
                                  build_train_step, llama_config, ops)

    cfg = llama_config(F32["preset"])
    if cfg.torch_dtype != torch.float32:
        raise AssertionError(f"the {F32['preset']} preset is not fp32")
    gpu = LlamaForCausalLM(cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(17))
    cpu = LlamaForCausalLM(cfg, device="cpu")
    start = {k: v.detach().clone() for k, v in gpu.state_dict().items()}
    cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    rng = np.random.RandomState(17)
    tok = rng.randint(0, cfg.vocab_size, (F32["batch"], F32["seq"] + 1))
    ids = torch.from_numpy(tok[:, :-1].astype(np.int64))
    labels = torch.from_numpy(tok[:, 1:].astype(np.int64))
    rec = {"config": f"{F32['preset']}: hidden {cfg.hidden_size}, "
                     f"{cfg.num_hidden_layers} layers, "
                     f"{cfg.num_attention_heads} heads of {cfg.head_dim}, "
                     f"fp32", "batch": F32["batch"], "seq": F32["seq"]}
    models = (gpu, cpu)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = [m(ids.to(d)).cpu() for m, d in ((gpu, dev), (cpu, "cpu"))]
    rec["logit_max_abs_err"] = check_close(
        torch, "fp32 tiny Llama: logits", logits[0], logits[1], F32_ATOL,
        F32_ATOL)
    losses = []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        m.train()
        loss = m(ids.to(d), labels.to(d))
        loss.backward()
        losses.append(float(loss.detach()))
    g = {k: rel_err(torch, p.grad.cpu(), cpu.get_parameter(k).grad)
         for k, p in gpu.named_parameters()}
    worst = max(g, key=g.get)
    if abs(losses[0] - losses[1]) > F32_ATOL or g[worst] > F32_GRAD_RTOL:
        raise AssertionError(f"fp32 tiny Llama: loss {losses}, gradient of "
                             f"{worst} off by {g[worst]:.3g} of its norm")
    rec["layer_api"] = {"losses": losses, "grad_max_rel_err": g[worst],
                        "grad_worst": worst}
    for m in models:
        m.zero_grad(set_to_none=True)
    losses = []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        step, init = build_train_step(cfg, lr=TRAIN["lr"],
                                      clip_norm=TRAIN["clip"], remat="full",
                                      device=d)
        losses.append(float(step(m, init(m), ids, labels)))
    if abs(losses[0] - losses[1]) > F32_ATOL:
        raise AssertionError(f"fp32 tiny Llama train step: loss {losses}")
    pmax = max(check_close(
        torch, f"fp32 train step: updated {k}", p.detach().cpu(),
        cpu.get_parameter(k).detach(), F32_PARAM_ATOL, 1e-5)
        for k, p in gpu.named_parameters())
    rec["train_step"] = {"losses": losses, "param_max_abs_err": pmax}
    for m in models:
        m.eval()
    gen = GenerationConfig(max_new_tokens=F32["new"])
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in F32["prompts"]]
    plen = min(F32["prompts"])
    pids = np.stack([p[:plen] for p in prompts])
    outs = [CausalLMEngine(m, max_batch=2, max_len=128).generate(pids, gen)
            for m in models]
    rec["generate_tokens_matched"] = matched_tokens(
        torch, np, cpu, list(pids), *[o[:, plen:] for o in outs],
        near_tie=F32_NEAR_TIE)
    # the longer prompt prefilled in chunks of 32 (K3's fp32 prefix-chunk
    # instance at width 64)
    long = prompts[0][None]
    outs = [CausalLMEngine(m, max_batch=1, max_len=128, prefill_chunk=32
                           ).generate(long, gen) for m in models]
    rec["chunked_generate_tokens_matched"] = matched_tokens(
        torch, np, cpu, list(long), *[o[:, long.shape[1]:] for o in outs],
        near_tie=F32_NEAR_TIE)
    streams = [PagedContinuousBatchingEngine(
        m, max_batch=2, num_pages=32, page_size=16, max_pages=8).serve(
            prompts, gen, segment_steps=4) for m in models]
    rec["paged_tokens_matched"] = matched_tokens(
        torch, np, cpu, prompts, *streams, near_tie=F32_NEAR_TIE)
    del gpu, cpu, models
    rec["fmt"] = fmt_e2e_phase(torch, dev, torch.float32, FMT_F32_ATOL)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    rec["launches"] = counts
    ran = ("rms_norm", "fused_rope", "flash_fwd", "flash_fwd_prefix",
           "flash_bwd_dq", "flash_bwd_dkv", "paged_decode", "decode_mha",
           "fused_layer_norm")
    log(f"  kernels: launches {counts} (the fp32 path); each of {ran} "
        f"must have launched, no other")
    if any(counts[k] == 0 for k in ran) or any(
            n for k, n in counts.items() if k not in ran):
        raise AssertionError(f"fp32 path: launch counts {counts}")
    return rec


def hb_step_bitwise(torch, model, cfg, start, ids, labels, loss_off):
    """The card's train step once more from the weights ``start`` with
    FLAGS_flash_head_batched on: one route call per flash forward (2 L
    under full recompute), K5 and K6 L times each, and the loss, every
    gradient and every updated parameter bitwise those of the step that
    just ran without the flag (the same kernels on the same inputs)."""
    from paddle_tpu_torch import build_train_step, ops

    dev = model.device
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    model.load_state_dict(start)
    step, init = build_train_step(cfg, lr=TRAIN["lr"],
                                  clip_norm=TRAIN["clip"], remat="full",
                                  device=dev)
    state = init(model)
    ops.reset_launch_counts()
    with hb_flag(True):
        loss = float(step(model, state, ids.to(dev), labels.to(dev)))
    torch.cuda.synchronize()
    counts, routes = ops.launch_counts(), ops.route_calls()
    L = cfg.num_hidden_layers
    check_launches(counts, expect(
        counts, rms_norm=4 * L + 1, fused_rope=6 * L, flash_fwd=2 * L,
        flash_bwd_dq=L, flash_bwd_dkv=L),
        f"1 step of {L} layers with FLAGS_flash_head_batched")
    if routes != {"flash_hb": 2 * L, "paged_attention": 0}:
        raise AssertionError(f"head-batched route calls {routes}, the step "
                             f"implies {2 * L}")
    if loss != loss_off:
        raise AssertionError(f"head-batched step: loss {loss} != {loss_off}")
    for k, p in model.named_parameters():
        if not torch.equal(p.grad, grads[k]):
            raise AssertionError(f"head-batched step: gradient of {k} "
                                 f"differs")
        if not torch.equal(p.detach(), params[k]):
            raise AssertionError(f"head-batched step: updated {k} differs")
    return {"loss": loss, "route_calls": routes, "launches": counts,
            "bitwise": True}


def train_phase(torch, dev, np, seed, profile=False):
    """The training configuration at full depth: a warm-up step, then
    TRAIN_STEPS timed steps on one batch made from ``seed``."""
    from paddle_tpu_torch import (LlamaForCausalLM, build_train_step,
                                  llama_config, ops)
    from paddle_tpu_torch.models.llama_functional import build_loss_fn

    cfg = train_config(llama_config)
    L, B, S = cfg.num_hidden_layers, TRAIN["batch"], TRAIN["seq"]
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S + 1)))
    ids, labels = tok[:, :-1].to(dev), tok[:, 1:].to(dev)
    step, init = build_train_step(cfg, lr=TRAIN["lr"],
                                  clip_norm=TRAIN["clip"], remat="full",
                                  device=dev)
    state = init(model)
    losses = [float(step(model, state, ids, labels))]      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss = step(model, state, ids, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        final = float(build_loss_fn(cfg, remat="none")(model, ids, labels))
    losses.append(final)
    n = TRAIN_STEPS
    check_launches(counts, expect(
        counts, rms_norm=n * (4 * L + 1), fused_rope=n * 6 * L,
        flash_fwd=n * 2 * L, flash_bwd_dq=n * L, flash_bwd_dkv=n * L),
        f"{n} steps of {L} layers")
    # one more step with the head-batched route on
    ops.reset_launch_counts()
    t = time.perf_counter()
    with hb_flag(True):
        loss_hb = float(step(model, state, ids, labels))
    torch.cuda.synchronize()
    hb_s = time.perf_counter() - t
    hb_counts, hb_routes = ops.launch_counts(), ops.route_calls()
    check_launches(hb_counts, expect(
        hb_counts, rms_norm=4 * L + 1, fused_rope=6 * L, flash_fwd=2 * L,
        flash_bwd_dq=L, flash_bwd_dkv=L),
        f"1 step of {L} layers with FLAGS_flash_head_batched")
    if hb_routes != {"flash_hb": 2 * L, "paged_attention": 0}:
        raise AssertionError(f"train: head-batched route calls {hb_routes}")
    if not np.isfinite(loss_hb):
        raise AssertionError(f"train: non-finite head-batched loss {loss_hb}")
    prof = (profile_run(torch, lambda: step(model, state, ids, labels))
            if profile else None)
    if not np.isfinite(losses).all():
        raise AssertionError(f"train: non-finite loss in {losses}")
    if not final < losses[1]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = B * S
    step_s = statistics.median(times)
    hd, H = cfg.head_dim, cfg.num_attention_heads
    pairs = causal_pairs(S, S) * H * B * L
    attn_model = 3 * 4 * hd * pairs          # forward QK and PV, x3
    attn_run = (2 * 4 + 6 + 8) * hd * pairs  # fwd twice, dq, dkv kernels
    rec = {"config": f"{TRAIN['preset']} {TRAIN['overrides']}",
           "layers": L, "batch": B, "seq": S, "params": n_params,
           "model_init_s": init_s, "losses": losses, "step_s": times,
           "step_s_median": step_s, "tokens_per_s": tokens / step_s,
           "mfu": 6 * n_params * tokens / step_s / BF16_FLOPS,
           "mfu_with_attention": (6 * n_params * tokens + attn_model)
           / step_s / BF16_FLOPS,
           "attention_flops_model": attn_model,
           "attention_flops_executed": attn_run,
           "peak_mem_gb": peak, "launches": counts,
           "hb_step_s": hb_s, "hb_loss": loss_hb, "hb_launches": hb_counts,
           "hb_route_calls": hb_routes}
    if prof:
        rec["profile"] = prof
    del model, state
    torch.cuda.empty_cache()
    return rec


# -- phase 6b: the eager training surface at the training configuration ------

def eager_batches(torch, np, cfg, n, seed, batch, seq, dev):
    """``n`` (ids, labels) batches of next-token pairs from ``seed``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tok = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                           (batch, seq + 1)))
        out.append((tok[:, :-1].to(dev), tok[:, 1:].to(dev)))
    return out


def eager_prepare(torch, net):
    """``Model(net).prepare`` as a PaddlePaddle user trains: AdamW under
    LinearWarmup with the global-norm clip, and CrossEntropyLoss."""
    from paddle_tpu_torch import Model, nn, optimizer

    opt = optimizer.AdamW(
        learning_rate=optimizer.lr.LinearWarmup(
            TRAIN["lr"], EAGER["warmup_steps"], TRAIN["lr"] / 10,
            TRAIN["lr"]),
        parameters=net.parameters(), weight_decay=EAGER["weight_decay"],
        grad_clip=nn.ClipGradByGlobalNorm(TRAIN["clip"]))
    m = Model(net)
    m.prepare(opt, nn.CrossEntropyLoss())
    return m


def eager_step_launches(counts, L, steps=1, flash=2):
    """The launches of ``steps`` eager steps of L layers under full
    recompute (``flash`` flash forwards a layer and step)."""
    return expect(counts, rms_norm=steps * (4 * L + 1),
                  fused_rope=steps * 6 * L, flash_fwd=steps * flash * L,
                  flash_bwd_dq=steps * L, flash_bwd_dkv=steps * L)


def loss_log(out: list):
    """A ``Model.fit`` callback appending each train batch's loss to
    ``out``."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class LossLog(Callback):
        def on_train_batch_end(self, step, logs=None):
            out.append(logs["loss"])

    return LossLog()


def fit_probe(torch, ops, net, ckpt, n):
    """A ``Model.fit`` callback: a step's time (synchronised on both
    sides), the launch counts and peak memory over steps 1..n-1 (step 0
    warms up), a checkpoint ``Model.save`` before step
    EAGER["save_after"] (the state after that many steps) and the
    parameters right after that step."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class Probe(Callback):
        def __init__(self):
            super().__init__()
            self.times, self.losses, self.after = [], [], None

        def on_train_batch_begin(self, step, logs=None):
            torch.cuda.synchronize()
            if step == EAGER["save_after"]:
                self.model.save(ckpt)
            if step == 1:
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - self.t0)
            self.losses.append(logs["loss"])
            if step == EAGER["save_after"]:
                self.after = {k: p.detach().clone()
                              for k, p in net.named_parameters()}
            if step == n - 1:
                self.counts = ops.launch_counts()
                self.peak = torch.cuda.max_memory_allocated() / 2 ** 30

    return Probe()


def resume_check(torch, cfg, dev, seed, ckpt, batch, after, loss_after):
    """A fresh model and optimizer (other weights) load the checkpoint and
    run one ``train_batch`` on the batch the uninterrupted run took next:
    the loss and every parameter against that run's, bitwise; where a
    parameter differs, a second resumed run tells a non-deterministic step
    (the two resumed runs differ) from state the checkpoint lost."""
    from paddle_tpu_torch import LlamaForCausalLM

    def resumed():
        net = LlamaForCausalLM(cfg, device=dev, generator=torch.Generator(
            dev).manual_seed(seed + 1))
        m = eager_prepare(torch, net)
        m.load(ckpt)
        loss = m.train_batch([batch[0]], [batch[1]])[0]
        return net, loss, m._optimizer

    net, loss, opt = resumed()
    rec = {"step": EAGER["save_after"] + 1, "loss": loss,
           "loss_uninterrupted": loss_after,
           "global_step": opt.state_dict()["global_step"]}
    diff = {k: (p.detach() - after[k]).abs().max().item()
            for k, p in net.named_parameters()
            if not torch.equal(p.detach(), after[k])}
    rec["bitwise"] = not diff and loss == loss_after
    rec["differing"] = diff
    if not rec["bitwise"]:
        again = {k: p.detach().clone() for k, p in net.named_parameters()}
        del net, opt
        net2, loss2, _ = resumed()
        rec["resumed_twice_equal"] = loss2 == loss and all(
            torch.equal(p.detach(), again[k])
            for k, p in net2.named_parameters())
        rec["cause"] = ("the step itself is not deterministic"
                        if not rec["resumed_twice_equal"]
                        else "state the checkpoint does not carry")
        log(f"  resume: NOT bitwise: {len(diff)} parameters differ "
            f"({sorted(diff.items(), key=lambda kv: -kv[1])[:4]}), loss "
            f"{loss} vs {loss_after}; {rec['cause']}")
    return rec


def mix_precision_leg(torch, np, cfg, dev, batches):
    """MixPrecisionLayer + MixPrecisionOptimizer(AdamW) against the plain
    AdamW from the same bf16 weights, EAGER["mix_steps"] steps on the same
    batches: main_grad fp32 (and p.grad cleared), masters fp32, parameters
    bf16; the first loss bitwise the plain one's, the later ones within a
    bf16 step of theirs."""
    from paddle_tpu_torch import LlamaForCausalLM, nn, optimizer
    from paddle_tpu_torch.distributed.fleet.utils import (
        MixPrecisionLayer, MixPrecisionOptimizer)

    def net():
        return LlamaForCausalLM(cfg, device=dev, generator=torch.Generator(
            dev).manual_seed(21))

    def adamw(model):
        return optimizer.AdamW(
            learning_rate=TRAIN["lr"], parameters=model.parameters(),
            weight_decay=EAGER["weight_decay"],
            grad_clip=nn.ClipGradByGlobalNorm(TRAIN["clip"]))

    plain, mixed = net(), net()
    po = adamw(plain)
    layer = MixPrecisionLayer(mixed, dtype="bfloat16")
    mo = MixPrecisionOptimizer(adamw(mixed))
    ce = nn.CrossEntropyLoss()
    losses = {"plain": [], "mixed": []}
    for step in range(EAGER["mix_steps"]):
        ids, labels = batches[step]
        for name, model, opt in (("plain", plain, po), ("mixed", layer, mo)):
            loss = ce(model(ids), labels)
            loss.backward()
            if name == "mixed":
                for k, p in mixed.named_parameters():
                    if p.grad is not None or p.main_grad is None or \
                            p.main_grad.dtype != torch.float32:
                        raise AssertionError(f"mix precision: {k} holds "
                                             f"no fp32 main_grad alone")
            opt.step()
            opt.clear_grad()
            losses[name].append(float(loss.detach()))
    for k, p in mixed.named_parameters():
        m = mo._masters[id(p)]
        if p.dtype != torch.bfloat16 or m.dtype != torch.float32 or \
                not torch.equal(p.detach(), m.to(torch.bfloat16)):
            raise AssertionError(f"mix precision: {k} is {p.dtype} with a "
                                 f"{m.dtype} master it does not round from")
    gaps = [abs(a - b) for a, b in zip(losses["mixed"], losses["plain"])]
    if not (np.isfinite(losses["mixed"]).all() and gaps[0] == 0.0 and all(
            g <= BF16_STEP * abs(b) for g, b in zip(gaps, losses["plain"]))):
        raise AssertionError(f"mix precision: losses {losses}")
    rec = {"steps": EAGER["mix_steps"], "losses": losses, "loss_gaps": gaps,
           "masters_gb": sum(m.numel() * 4 for m in mo._masters.values())
           / 2 ** 30}
    del plain, mixed, layer, po, mo
    return rec


def remat_leg(torch, np, cfg, dev, batch):
    """``build_train_step`` under each of EAGER["remat"] from the same
    weights and batch, one warm step and one measured step each: loss and
    (clipped) gradients against "full"'s on this card, flash forwards
    (2 L, L, 2 L), peak memory and step time."""
    from paddle_tpu_torch import LlamaForCausalLM, build_train_step, ops

    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, device=dev, generator=torch.Generator(
        dev).manual_seed(31))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    ids, labels = batch
    rec, ref = {}, None
    for policy in EAGER["remat"]:
        step, init = build_train_step(cfg, lr=TRAIN["lr"],
                                      clip_norm=TRAIN["clip"], remat=policy,
                                      device=dev)
        model.load_state_dict(start)
        step(model, init(model), ids, labels)              # warm-up
        model.load_state_dict(start)
        state = init(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        loss = float(step(model, state, ids, labels))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = ops.launch_counts()
        check_launches(counts, eager_step_launches(
            counts, L, flash=1 if policy == "attn_out" else 2),
            f"1 step of {L} layers, remat={policy!r}")
        r = {"step_s": dt, "loss": loss, "launches": counts,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        grads = {k: p.grad for k, p in model.named_parameters()}
        if ref is None:
            ref = (loss, {k: g.clone() for k, g in grads.items()})
        else:
            g_err = {k: rel_err(torch, g, ref[1][k]) for k, g in grads.items()}
            worst = max(g_err, key=g_err.get)
            r.update(loss_abs_err=abs(loss - ref[0]),
                     grad_max_rel_err=g_err[worst], grad_worst=worst,
                     bitwise=loss == ref[0] and all(
                         torch.equal(g, ref[1][k])
                         for k, g in grads.items()))
            if not (np.isfinite(loss) and r["loss_abs_err"] <= TRAIN_LOSS_ATOL
                    and g_err[worst] <= TRAIN_GRAD_RTOL):
                raise AssertionError(f"remat={policy!r}: loss {loss} vs "
                                     f"{ref[0]}, gradient of {worst} off "
                                     f"by {g_err[worst]:.3g}")
        rec[policy] = r
        log(f"  remat={policy!r}: step {dt:.4f} s, peak {r['peak_mem_gb']:.2f}"
            f" GiB, loss {loss}, bitwise full's: {r.get('bitwise', True)}")
    del model, start, ref
    return rec


def eager_train_phase(torch, dev, np, seed, profile=False):
    """Phase 6b: the training configuration at full depth through the
    eager surface. ``Model.fit`` over EAGER["batches"] batches (AdamW,
    LinearWarmup, global-norm clip, CrossEntropyLoss; step 0 warms up,
    the others are timed), a resume from the ``Model.save`` taken after
    step EAGER["save_after"], main-gradient mixed precision, and the remat
    policies through ``build_train_step``."""
    import tempfile

    from paddle_tpu_torch import LlamaForCausalLM, llama_config, ops

    cfg = train_config(llama_config)
    L, B, S = cfg.num_hidden_layers, TRAIN["batch"], TRAIN["seq"]
    n = EAGER["batches"]
    batches = eager_batches(torch, np, cfg, n, seed, B, S, dev)
    net = LlamaForCausalLM(cfg, device=dev, generator=torch.Generator(
        dev).manual_seed(seed))
    m = eager_prepare(torch, net)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "eager")
        probe = fit_probe(torch, ops, net, ckpt, n)
        ops.reset_launch_counts()
        m.fit(batches, verbose=0, callbacks=[probe])
        counts = probe.counts
        check_launches(counts, eager_step_launches(counts, L, n - 1),
                       f"Model.fit: {n - 1} steps of {L} layers")
        losses = probe.losses
        if not np.isfinite(losses).all():
            raise AssertionError(f"eager fit: non-finite loss in {losses}")
        ckpt_gb = sum(os.path.getsize(ckpt + s) for s in (".pdparams",
                                                          ".pdopt")) / 2 ** 30
        t = time.perf_counter()
        resume = resume_check(torch, cfg, dev, seed, ckpt,
                              batches[EAGER["save_after"]], probe.after,
                              losses[EAGER["save_after"]])
        resume["s"] = time.perf_counter() - t
        resume["checkpoint_gb"] = ckpt_gb
    # the optimizer's step alone, on the fit model's next batch: host time
    # to enqueue it and its time to the device's end
    opt = m._optimizer
    real = opt.step
    step_t = {}

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real()
        step_t["host_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        step_t["ms"] = (time.perf_counter() - t0) * 1e3

    opt.step = timed_step
    m.train_batch([batches[0][0]], [batches[0][1]])
    opt.step = real
    prof = (profile_run(torch, lambda: m.train_batch([batches[1][0]],
                                                     [batches[1][1]]))
            if profile else None)
    step_s = statistics.median(probe.times[1:])
    rec = {"config": f"{TRAIN['preset']} {TRAIN['overrides']}", "layers": L,
           "batch": B, "seq": S, "batches": n, "losses": losses,
           "step_s": probe.times, "step_s_median": step_s,
           "tokens_per_s": B * S / step_s, "peak_mem_gb": probe.peak,
           "launches": counts, "optimizer_step_ms": step_t["ms"],
           "optimizer_step_host_ms": step_t["host_ms"], "resume": resume}
    if prof:
        rec["profile"] = prof
    del m, net, opt, probe
    torch.cuda.empty_cache()
    rec["mix_precision"] = mix_precision_leg(torch, np, cfg, dev, batches)
    torch.cuda.empty_cache()
    rec["remat"] = remat_leg(torch, np, cfg, dev, batches[0])
    torch.cuda.empty_cache()
    return rec


def eager_e2e_phase(torch, dev, np):
    """Phase 4's eager twin: the training widths at 2 layers, on the card
    and on the CPU from the same weights and batch: one ``Model.fit`` step
    (bf16, AdamW, LinearWarmup, clip) at batch 1 x 512 and, from an fp32
    model decorated to fp16 at O2, one ``auto_cast(O2, float16)`` step
    under a ``GradScaler`` at 1 x EAGER_E2E["fp16_seq"], then the same
    scaled gradients with one inf injected: the scaler skips the step and
    halves its scale on both sides."""
    from paddle_tpu_torch import LlamaForCausalLM, amp, llama_config, nn, ops
    from paddle_tpu_torch.optimizer import AdamW

    vocab = train_config(llama_config).vocab_size
    rng = np.random.RandomState(41)
    tok = rng.randint(0, vocab, (TRAIN_E2E["batch"], TRAIN_E2E["seq"] + 1))
    ids = torch.from_numpy(tok[:, :-1].astype(np.int64))
    labels = torch.from_numpy(tok[:, 1:].astype(np.int64))
    L = TRAIN_E2E["layers"]
    rec = {"layers": L, "batch": TRAIN_E2E["batch"], "seq": TRAIN_E2E["seq"],
           "fp16_seq": EAGER_E2E["fp16_seq"]}

    def twins(dtype, seed):
        cfg = train_config(llama_config, num_hidden_layers=L, dtype=dtype)
        gpu = LlamaForCausalLM(cfg, device=dev, generator=torch.Generator(
            dev).manual_seed(seed))
        cpu = LlamaForCausalLM(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        return gpu, cpu

    def params_close(what, models):
        return max(check_close(torch, f"{what}: updated {k}",
                               p.detach().cpu(),
                               models[1].get_parameter(k).detach(),
                               TRAIN_PARAM_ATOL, BF16_STEP)
                   for k, p in models[0].named_parameters())

    # the eager Model.fit step, bf16
    models = twins("bfloat16", 41)
    losses = []
    for net, d in zip(models, (dev, "cpu")):
        m = eager_prepare(torch, net)
        got = []
        ops.reset_launch_counts()
        m.fit([(ids.to(d), labels.to(d))], verbose=0,
              callbacks=[loss_log(got)])
        losses.append(got[0])
        if d == dev:
            counts = ops.launch_counts()
            check_launches(counts, eager_step_launches(counts, L),
                           f"1 eager step of {L} layers")
    # the loss of bf16 logits is a bf16 tensor: one bf16 step more, as the
    # Layer API's loss in train_e2e_phase
    err = abs(losses[0] - losses[1])
    if not (np.isfinite(losses).all()
            and err <= TRAIN_LOSS_ATOL + BF16_STEP * abs(losses[1])):
        raise AssertionError(f"eager fit step: loss {losses[0]} on the card, "
                             f"{losses[1]} on the CPU")
    rec["fit"] = {"loss_card": losses[0], "loss_cpu": losses[1],
                  "loss_abs_err": err,
                  "param_max_abs_err": params_close("eager fit step",
                                                    models)}
    del models
    # fp16 O2 under a GradScaler, then the injected inf
    models = twins("float32", 42)
    runs = []
    for net, d in zip(models, (dev, "cpu")):
        amp.decorate(net, level="O2", dtype="float16")
        opt = AdamW(learning_rate=TRAIN["lr"], parameters=net.parameters(),
                    weight_decay=EAGER["weight_decay"],
                    grad_clip=nn.ClipGradByGlobalNorm(TRAIN["clip"]))
        sc = amp.GradScaler(init_loss_scaling=EAGER_E2E["scale"])
        ops.reset_launch_counts()
        n = EAGER_E2E["fp16_seq"]
        with amp.auto_cast(level="O2", dtype="float16"):
            loss = nn.CrossEntropyLoss()(net(ids[:, :n].to(d)),
                                         labels[:, :n].to(d))
        sc.scale(loss).backward()
        if d == dev:
            counts = ops.launch_counts()
            check_launches(counts, eager_step_launches(counts, L),
                           f"1 fp16 O2 step of {L} layers")
        scaled = [p.grad.clone() for p in net.parameters()]
        dtypes = sorted({str(p.dtype) for p in net.parameters()})
        sc.step(opt)
        sc.update()
        run = {"loss": float(loss.detach()), "loss_dtype": str(loss.dtype),
               "scales": [sc.get_loss_scaling()], "param_dtypes": dtypes}
        after = [p.detach().clone() for p in net.parameters()]
        opt.clear_grad()
        for p, g in zip(net.parameters(), scaled):
            p.grad = g
        scaled[0].view(-1)[0] = float("inf")
        sc.step(opt)
        sc.update()
        run["scales"].append(sc.get_loss_scaling())
        run["skipped"] = all(torch.equal(p.detach(), a)
                             for p, a in zip(net.parameters(), after))
        runs.append(run)
        del opt, sc, scaled, after
    card, cpu = runs
    err = abs(card["loss"] - cpu["loss"])
    want_scales = [EAGER_E2E["scale"], EAGER_E2E["scale"] / 2]
    if not (np.isfinite([card["loss"], cpu["loss"]]).all()
            and err <= TRAIN_LOSS_ATOL and card["scales"] == cpu["scales"]
            == want_scales and card["skipped"] and cpu["skipped"]):
        raise AssertionError(f"fp16 O2 GradScaler step: card {card}, CPU "
                             f"{cpu}")
    rec["fp16_o2"] = {"card": card, "cpu": cpu, "loss_abs_err": err,
                      "param_max_abs_err": params_close("fp16 O2 step",
                                                        models)}
    del models
    torch.cuda.empty_cache()
    return rec


# -- phase 5: serve the 7B preset --------------------------------------------


def expect(counts: dict, **want) -> dict:
    """Every kernel's launch count the path implies: ``want``, 0 for the
    rest."""
    return {name: want.get(name, 0) for name in counts}


def check_launches(counts: dict, want: dict, what: str) -> None:
    log(f"  kernels: launches {counts} ({what}); the path implies {want}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")


def serve_stats(eng, outs, vocab: int, n_new: int) -> dict:
    """TTFT, TPOT and decode rate of an engine's last ``serve``; raises on
    an output of the wrong length or outside the vocabulary."""
    for o in outs:
        if len(o) != n_new or not ((o >= 0) & (o < vocab)).all():
            raise AssertionError(f"serve: bad output {o!r}")
    st = eng.serve_stats
    tpot = [(f - t) / (len(o) - 1)
            for t, f, o in zip(st["ttft_s"], st["finish_s"], outs)]
    return {"ttft_s": st["ttft_s"],
            "ttft_p50_s": statistics.median(st["ttft_s"]),
            "ttft_max_s": max(st["ttft_s"]), "tpot_s": tpot,
            "tpot_p50_s": statistics.median(tpot),
            "decode_tokens_per_s": st["decode_tokens"] / st["decode_s"],
            "decode_tokens": st["decode_tokens"], "decode_s": st["decode_s"],
            "wall_s": st["wall_s"], "segments": st["segments"]}


def graphs_record(eng, warm: dict) -> dict:
    """An engine's ``warmup()`` seconds and its captured programs: captures,
    capture seconds and the private pool's bytes per key."""
    g = eng.programs
    rec = {"warmup_s": warm, "captures": {str(k): n for k, n in
                                          g.captures.items()},
           "capture_s": {str(k): v for k, v in g.capture_s.items()},
           "pool_bytes": {str(k): v for k, v in g.pool_bytes.items()}}
    log(f"  graphs: {rec['captures']}, capture {rec['capture_s']} s, pool "
        f"{rec['pool_bytes']} bytes; warmup {warm['total']:.2f} s")
    return rec


def counted_run(torch, ops, eng, run):
    """``run()`` on a warmed engine, counted: its outputs and every
    kernel's launches (a graph's replays credited). Raises if the run
    captured anything."""
    torch.cuda.synchronize()
    before = dict(eng.programs.captures)
    ops.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if eng.programs.captures != before:
        raise AssertionError(f"captures {eng.programs.captures} after "
                             f"warmup's {before}")
    return out, counts


def run_engine(torch, ops, eng, prompts, gen):
    """``eng.warmup(8)`` (every prefill bucket run once, the serve's
    8-step segment captured), then the counted serve. Returns (outputs,
    launch counts, prefills, decode steps, the graphs' record)."""
    warm = eng.warmup(8)
    p0, s0 = eng.prefills, eng.decode_steps
    outs, counts = counted_run(torch, ops, eng,
                               lambda: eng.serve(prompts, gen))
    return (outs, counts, eng.prefills - p0, eng.decode_steps - s0,
            graphs_record(eng, warm))


def check_serve_launches(counts, L, n_pre, n_steps, decode):
    check_launches(counts, expect(
        counts, rms_norm=(2 * L + 1) * (n_pre + n_steps),
        fused_rope=2 * L * n_pre, flash_fwd=L * n_pre,
        **{decode: L * n_steps}),
        f"prefills {n_pre}, decode steps {n_steps}, layers {L}")


def first_splits(torch, np, model, prompts, outs, ref_outs):
    """Per prompt, the first token where ``outs`` parts from ``ref_outs``
    (its length where they agree throughout), and the uncached model's
    top-2 margin there."""
    splits = [next((i for i in range(len(d)) if d[i] != p[i]), len(d))
              for d, p in zip(outs, ref_outs)]
    margins = []
    with torch.no_grad():
        for p, d, n in zip(prompts, outs, splits):
            if n == len(d):
                margins.append(None)
                continue
            seq = torch.from_numpy(np.concatenate([p, d[:n]]).astype(
                np.int64))[None].to(model.device)
            top2 = model(seq)[0, -1].float().topk(2).values
            margins.append((top2[0] - top2[1]).item())
    return splits, margins


def pool_gb(eng) -> float:
    return sum(t.numel() * t.element_size() for entry in eng.caches
               for t in entry) / 1e9


def serve_phase(torch, dev, np, profile=False):
    """The 7B preset through the paged engine, bf16 then int8 pools, then
    the same model through ``CausalLMEngine.generate`` and the dense
    engine; each engine warmed before its counted run."""
    from paddle_tpu_torch import (GenerationConfig, LlamaForCausalLM,
                                  PagedContinuousBatchingEngine, llama_config,
                                  ops)

    cfg = llama_config(PRESET, dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    plens = [100, 180, 260, 340, 420, 500, 600, 700]
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in plens]
    gen = GenerationConfig(max_new_tokens=32)
    L = cfg.num_hidden_layers
    recs = []
    for kv in ("bf16", "int8"):
        eng = PagedContinuousBatchingEngine(model, max_batch=8,
                                            num_pages=512, page_size=16,
                                            max_pages=64, kv_dtype=kv)
        outs, counts, n_pre, n_steps, graphs = run_engine(
            torch, ops, eng, prompts, gen)
        check_serve_launches(counts, L, n_pre, n_steps, "paged_decode")
        rec = {
            "preset": PRESET, "layers": L, "dtype": "bfloat16",
            "engine": f"PagedContinuousBatchingEngine(max_batch=8, "
                      f"num_pages=512, page_size=16, max_pages=64, "
                      f"kv_dtype={kv!r})",
            "prompt_lens": plens, "max_new_tokens": gen.max_new_tokens,
            "model_init_s": init_s,
            **serve_stats(eng, outs, cfg.vocab_size, gen.max_new_tokens),
            "prefills": n_pre, "decode_steps": n_steps, "launches": counts,
            "graphs": graphs, "pool_gb": pool_gb(eng),
            "page_cost": eng.kv_page_cost(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        }
        if kv == "int8":
            splits, margins = first_splits(torch, np, model, prompts, outs,
                                           recs[0]["outs"])
            rec.update(first_split_from_bf16=splits,
                       split_top2_margins=margins)
        if profile:
            rec["profile"] = profile_run(torch,
                                         lambda: eng.serve(prompts, gen))
        rec["outs"] = outs
        recs.append(rec)
        del eng
        torch.cuda.empty_cache()
    outs = recs[0]["outs"]
    for r in recs:
        del r["outs"]
    chunk_recs = chunked_serve_phase(torch, np, model, prompts, outs,
                                     profile)   # and the Servers' legs
    gen_rec = generate_phase(torch, np, model, profile)
    dense_rec = dense_serve_phase(torch, np, model, prompts, outs, profile)
    t0 = time.perf_counter()
    prefix_rec, shared, long_outs = prefix_serve_phase(torch, np, model,
                                                       profile)
    prefix_rec["leg_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pressure_rec = pressure_serve_phase(torch, np, model, shared, long_outs)
    pressure_rec["leg_s"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    return ((recs[0], recs[1], gen_rec, dense_rec) + chunk_recs
            + (prefix_rec, pressure_rec))


def gap_serve(eng, prompts, cfgs, segment_steps=8):
    """The serving scheduler's gap (``paddle_tpu/serving/scheduler.py``
    :1761-1995) over an engine built with ``prefill_chunk``: while no
    admission is in flight and the oldest pending request fits, begin its
    admission; run one chunk of the admission in flight; then one decode
    segment over the live requests. One admission is in flight at a time
    (its dense mini cache is 512 MiB at the 7B widths). Returns the
    outputs in submission order and sets ``eng.serve_stats`` as
    ``serve()`` does (TTFT from the call to the first token on the host,
    decode time and tokens of the segments)."""
    t0 = time.perf_counter()
    pending = list(range(len(prompts)))
    inflight = None
    order, first_at, done_at, results = {}, {}, {}, {}
    decode_s, segments = 0.0, 0
    while len(results) < len(prompts):
        if inflight is None and pending:
            if eng.can_admit(len(prompts[pending[0]]), cfgs[pending[0]]):
                idx = pending.pop(0)
                inflight = (idx, eng.begin_admit(prompts[idx], cfgs[idx]))
            elif len(order) == len(results):
                raise RuntimeError("gap loop: a request that can never be "
                                   "admitted")
        if inflight is not None and eng.admit_chunk(inflight[1]):
            order[inflight[1].rid] = inflight[0]
            first_at[inflight[0]] = time.perf_counter()
            inflight = None
        if len(order) > len(results):
            t = time.perf_counter()
            eng.decode_segment(segment_steps)
            decode_s += time.perf_counter() - t
            segments += 1
        now = time.perf_counter()
        for rid, seq in eng.collect_finished().items():
            results[order[rid]] = seq
            done_at[order[rid]] = now
    n = len(prompts)
    eng.serve_stats = {
        "ttft_s": [first_at[i] - t0 for i in range(n)],
        "finish_s": [done_at[i] - t0 for i in range(n)],
        "decode_s": decode_s,
        "decode_tokens": sum(len(results[i]) - 1 for i in range(n)),
        "segments": segments, "wall_s": time.perf_counter() - t0}
    return [results[i] for i in range(n)]


def chunked_serve_phase(torch, np, model, prompts, paged_outs,
                        profile=False):
    """This slice's serves on the 7B model: the paged engine built with
    ``prefill_chunk=PREFIX["chunk"]``, warmed (both segment programs
    captured, the chunk program run once), serves phase 5's 8 prompts
    through the gap loop of :func:`gap_serve`, greedy, then sampled
    (SAMPLED, seed = request index). Each counted run captures nothing and
    its launches are held against the path's: one prefill chunk per
    ``admit_chunk`` (K3's prefix-chunk instance in every layer, no one-shot
    prefill), one paged decode step per segment step. The greedy streams'
    first split from the one-shot serve's is recorded with its top-2
    margin; TPOT of the sampled serve against the greedy one."""
    from paddle_tpu_torch import (GenerationConfig,
                                  PagedContinuousBatchingEngine, ops)

    cfg = model.config
    L, n_new = cfg.num_hidden_layers, 32
    eng = PagedContinuousBatchingEngine(
        model, max_batch=8, num_pages=512, page_size=16, max_pages=64,
        prefill_chunk=PREFIX["chunk"])
    warm = eng.warmup(8)
    graphs = graphs_record(eng, warm)
    runs = {"greedy": [GenerationConfig(max_new_tokens=n_new)] * 8,
            "sampled": [GenerationConfig(max_new_tokens=n_new, seed=i,
                                         **SAMPLED) for i in range(8)]}
    recs = []
    for name, cfgs in runs.items():
        c0, s0 = eng.prefill_chunks, eng.decode_steps
        torch.cuda.reset_peak_memory_stats()
        outs, counts = counted_run(torch, ops, eng, lambda: gap_serve(
            eng, prompts, cfgs))
        n_chunks, n_steps = eng.prefill_chunks - c0, eng.decode_steps - s0
        check_launches(counts, expect(
            counts, rms_norm=(2 * L + 1) * (n_chunks + n_steps),
            fused_rope=2 * L * n_chunks, flash_fwd_prefix=L * n_chunks,
            paged_decode=L * n_steps),
            f"{name}: chunks {n_chunks}, decode steps {n_steps}, layers {L}")
        rec = {"engine": f"PagedContinuousBatchingEngine(max_batch=8, "
                         f"num_pages=512, page_size=16, max_pages=64, "
                         f"prefill_chunk={PREFIX['chunk']})",
               "loop": "gap loop: one admit_chunk, then one "
                         "decode_segment(8)",
               "configs": name if name == "greedy" else
               f"{SAMPLED}, seed = request index",
               **serve_stats(eng, outs, cfg.vocab_size, n_new),
               "chunks": n_chunks, "decode_steps": n_steps,
               "launches": counts, "graphs": graphs,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        if name == "greedy":
            splits, margins = first_splits(torch, np, model, prompts, outs,
                                           paged_outs)
            rec.update(first_split_from_one_shot=splits,
                       split_top2_margins=margins)
            if profile:
                rec["profile"] = profile_run(torch, lambda: gap_serve(
                    eng, prompts, cfgs))
        else:
            rec["tpot_p50_over_greedy"] = (rec["tpot_p50_s"]
                                           / recs[0]["tpot_p50_s"])
        rec["outs"] = outs
        recs.append(rec)
    gap_outs = recs[0]["outs"]
    for r in recs:
        del r["outs"]
    eng.reset_state()
    server_rec, server_outs = server_phase(torch, np, model, prompts, eng,
                                           gap_outs, recs[0], profile)
    spec_recs = spec_server_phase(torch, np, model, prompts, eng,
                                  server_outs, server_rec, profile)
    del eng
    torch.cuda.empty_cache()
    lora_rec = lora_server_phase(torch, np, model, prompts, server_outs,
                                 server_rec, profile)
    return tuple(recs) + (server_rec,) + spec_recs + (lora_rec,)


def serve_clients(srv, prompts, cfg, wait_s=600.0, tolerate=()):
    """Submit every prompt from a client thread of its own, in prompt order
    (each thread after the one before it, so the queue's order, and with
    it the scheduler's history, is the same in every run), each streaming
    its tokens at once; ``cfg`` is one config or one per prompt. Returns (outputs, handles) in prompt order; raises
    what a client raised, or if one did not finish within ``wait_s``. A
    request failing with a cause of a type in ``tolerate`` is not raised:
    its output is None and its handle FAILED."""
    import threading

    import numpy as np

    from paddle_tpu_torch.serving import RequestFailed

    n = len(prompts)
    outs, handles, errors = [None] * n, [None] * n, []
    turn = [threading.Event() for _ in range(n + 1)]
    turn[0].set()

    def client(i):
        try:
            turn[i].wait(wait_s)
            try:
                handles[i] = srv.submit(
                    prompts[i], cfg[i] if isinstance(cfg, list) else cfg)
            finally:
                turn[i + 1].set()
            outs[i] = np.asarray(list(handles[i].stream(timeout=wait_s)),
                                 np.int32)
        except RequestFailed as e:
            if not isinstance(e.__cause__, tuple(tolerate)):
                errors.append(e)
        except BaseException as e:          # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(wait_s)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a client did not finish in {wait_s} s")
    return outs, handles


def handle_stats(handles, outs, vocab, n_new, seg0, eng) -> dict:
    """TTFT (submit to the first streamed token) and TPOT ((finish - first
    token) / (n - 1)) from the handles' stamps, the span from the first
    token to the last finish, and the decode rate of the engine's segments
    since ``seg0``; raises on an output of the wrong length or outside the
    vocabulary."""
    for o in outs:
        if len(o) != n_new or not ((o >= 0) & (o < vocab)).all():
            raise AssertionError(f"server: bad output {o!r}")
    ttft = [h.first_token_ts - h.submit_ts for h in handles]
    tpot = [(h.finish_ts - h.first_token_ts) / (len(o) - 1)
            for h, o in zip(handles, outs)]
    segs = eng._segment_log[seg0:]
    dec_s, dec_n = sum(t for t, _ in segs), sum(k for _, k in segs)
    return {"ttft_s": ttft, "ttft_p50_s": statistics.median(ttft),
            "ttft_max_s": max(ttft), "tpot_s": tpot,
            "tpot_p50_s": statistics.median(tpot),
            "decode_tokens_per_s": dec_n / dec_s, "decode_tokens": dec_n,
            "decode_s": dec_s, "segments": len(segs),
            "span_s": (max(h.finish_ts for h in handles)
                       - min(h.first_token_ts for h in handles))}


def http_json(url, body=None, timeout=300):
    """(status, body bytes) of a GET (``body`` None) or a JSON POST."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    data = None if body is None else json.dumps(body).encode()
    try:
        with urlopen(Request(url, data=data), timeout=timeout) as r:
            return r.status, r.read()
    except HTTPError as e:
        return e.code, e.read()


def server_phase(torch, np, model, prompts, eng, gap_outs, gap_rec,
                 profile=False):
    """This slice's serving front on the 7B model, over the gap loop's
    engine (``prefill_chunk=PREFIX["chunk"]``, reset, its graphs kept):

    - serve: ``Server(eng, segment_steps=8, warmup=True)``, the 8 prompts
      submitted from 8 client threads at once, 32 greedy tokens each,
      streamed; TTFT and TPOT from the handles, beside the gap loop's;
      the first token where each stream parts from the gap loop's (with
      its top-2 margin); no capture after warmup; launches held against
      the path's (a prompt up to the chunk admits in one prefill, a longer
      one chunk by chunk); with ``profile``, the serve once more under
      ``torch.profiler``;
    - HTTP: ``serve_http`` on 127.0.0.1 with the monitor on, one
      unstreamed and one streamed ``POST /generate`` (the same request:
      the same tokens), ``GET /healthz`` (200, ``ok``), ``/metrics`` (the
      serving and device-memory series) and ``/stats``; then the engine's
      graphs dropped and a fresh ``Server(warmup=True)`` capturing them
      anew while a thread scrapes ``/metrics`` in a loop: the capture
      succeeds (each segment program captured once more) and a request
      after it captures nothing;
    - fault: the engine behind ``FaultyEngine`` with a plan that fails the
      second ``decode_segment``; the 8 prompts again: one restart, every
      request finished (its replay re-prefills prompt + emitted tokens),
      the streams against the fault-free serve's, no capture after
      warmup, the recovery seconds.

    Every server and HTTP front is shut down and joined before it
    returns."""
    import threading

    from paddle_tpu_torch import GenerationConfig, monitor, ops
    from paddle_tpu_torch.inference.generation import EngineFault
    from paddle_tpu_torch.serving import Server, serve_http
    from paddle_tpu_torch.testing import FaultPlan, FaultyEngine

    cfg = model.config
    L, n_new, vocab = cfg.num_hidden_layers, 32, cfg.vocab_size
    gen = GenerationConfig(max_new_tokens=n_new)
    rec = {"engine": gap_rec["engine"],
           "server": "Server(eng, segment_steps=8, warmup=True)",
           "clients": len(prompts)}

    # -- serve ---------------------------------------------------------------
    t0 = time.perf_counter()
    srv = Server(eng, segment_steps=8, warmup=True)
    try:
        if not srv.wait_ready(600) or srv.status != "ok":
            raise AssertionError(f"server warmup: status {srv.status}")
        rec["warmup_s"] = time.perf_counter() - t0
        p0, c0, s0 = eng.prefills, eng.prefill_chunks, eng.decode_steps
        seg0 = len(eng._segment_log)
        (outs, handles), counts = counted_run(
            torch, ops, eng, lambda: serve_clients(srv, prompts, gen))
        n_pre, n_chunks = eng.prefills - p0, eng.prefill_chunks - c0
        n_steps = eng.decode_steps - s0
        check_launches(counts, expect(
            counts, rms_norm=(2 * L + 1) * (n_pre + n_chunks + n_steps),
            fused_rope=2 * L * (n_pre + n_chunks), flash_fwd=L * n_pre,
            flash_fwd_prefix=L * n_chunks, paged_decode=L * n_steps),
            f"server: prefills {n_pre}, chunks {n_chunks}, decode steps "
            f"{n_steps}, layers {L}")
        rec.update(handle_stats(handles, outs, vocab, n_new, seg0, eng),
                   prefills=n_pre, chunks=n_chunks, decode_steps=n_steps,
                   launches=counts, captures_after_warmup=0)
        if profile:
            rec["profile"] = profile_run(
                torch, lambda: serve_clients(srv, prompts, gen))
    finally:
        srv.shutdown(drain=False, timeout=120)
    if srv.status != "stopped":
        raise AssertionError(f"server did not stop: {srv.status}")
    splits, margins = first_splits(torch, np, model, prompts, outs, gap_outs)
    rec.update(gap_ttft_p50_s=gap_rec["ttft_p50_s"],
               gap_tpot_p50_s=gap_rec["tpot_p50_s"],
               first_split_from_gap=splits, split_top2_margins=margins)

    # -- HTTP ----------------------------------------------------------------
    http = {}
    monitor.enable()
    try:
        srv = Server(eng, segment_steps=8)
        httpd = serve_http(srv)
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            body = {"prompt": prompts[1].tolist(), "max_new_tokens": 16}
            code, raw = http_json(url + "/generate", body)
            if code != 200:
                raise AssertionError(f"POST /generate: {code} {raw[:300]}")
            plain = json.loads(raw)["tokens"]
            code, raw = http_json(url + "/generate", dict(body, stream=True))
            lines = [json.loads(ln) for ln in raw.splitlines()]
            streamed = [ln["token"] for ln in lines[:-1]]
            if (code != 200 or lines[-1].get("status") != "finished"
                    or streamed != plain or len(plain) != 16):
                raise AssertionError(f"streamed {streamed} ({code}, "
                                     f"{lines[-1]}) != unstreamed {plain}")
            code, raw = http_json(url + "/healthz")
            health = json.loads(raw)
            if code != 200 or health["status"] != "ok":
                raise AssertionError(f"/healthz {code} {health}")
            code, raw = http_json(url + "/metrics")
            prom = raw.decode()
            want = ("paddle_tpu_serving_requests_total",
                    "paddle_tpu_serving_ttft_seconds_bucket",
                    "paddle_tpu_generated_tokens_total",
                    'paddle_tpu_hbm_bytes{device="cuda:0",kind="bytes_in_use"}')
            missing = [w for w in want if w not in prom]
            if code != 200 or missing:
                raise AssertionError(f"/metrics {code} lacks {missing}")
            code, raw = http_json(url + "/stats")
            stats = json.loads(raw)
            if code != 200 or stats["metrics"]["ttft"]["*"]["count"] != 2:
                raise AssertionError(f"/stats {code} {stats}")
            http.update(tokens=plain, healthz=health,
                        ttft_p50_ms=stats["metrics"]["ttft"]["*"]["p50"]
                        * 1e3)
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv.shutdown(drain=False, timeout=120)
        if plain != outs[1][:16].tolist():
            http["first_split_from_serve"] = next(
                i for i, (a, b) in enumerate(zip(plain, outs[1])) if a != b)
        # a second warmup, capturing anew, beside a /metrics scraper
        eng.programs.clear()
        caps0 = dict(eng.programs.captures)
        scraper = monitor.start_http_server(port=0)
        stop, scrapes, errors = threading.Event(), [], []

        def scrape():
            u = f"http://127.0.0.1:{scraper.server_address[1]}/metrics"
            while not stop.is_set():
                try:
                    code, raw = http_json(u, timeout=60)
                    if code != 200 or b"paddle_tpu_hbm_bytes" not in raw:
                        raise AssertionError(f"scrape: {code}")
                    scrapes.append(time.perf_counter())
                except BaseException as e:      # re-raised below
                    errors.append(e)
                    return
                time.sleep(SCRAPE_PAUSE_S)

        th = threading.Thread(target=scrape, daemon=True)
        th.start()
        try:
            while not scrapes and not errors and th.is_alive():
                time.sleep(0.001)
            t0 = time.perf_counter()
            srv = Server(eng, segment_steps=8, warmup=True)
            try:
                ready = srv.wait_ready(600)
                t1 = time.perf_counter()
                if not ready or srv.status != "ok":
                    raise AssertionError(f"warmup beside a scraper: "
                                         f"status {srv.status}")
                caps1 = dict(eng.programs.captures)
                h = srv.submit(prompts[0], GenerationConfig(max_new_tokens=8))
                if len(h.result(timeout=600)) != 8:
                    raise AssertionError("request after the second warmup")
            finally:
                srv.shutdown(drain=False, timeout=120)
        finally:
            stop.set()
            th.join(120)
            scraper.shutdown()
            scraper.server_close()
        if errors:
            raise errors[0]
        during = sum(1 for ts in scrapes if t0 <= ts <= t1)
        grew = {str(k): caps1.get(k, 0) - caps0.get(k, 0)
                for k in set(caps1) | set(caps0)}
        if (grew != {"('segment', 8)": 1, "('segment', 8, 'sampled')": 1}
                or eng.programs.captures != caps1 or during < 1):
            raise AssertionError(
                f"second warmup: captures grew {grew}, then "
                f"{eng.programs.captures} against {caps1}; {during} "
                f"scrapes during it")
        http.update(rewarm_s=t1 - t0, scrapes_during_rewarm=during,
                    scrape_pause_s=SCRAPE_PAUSE_S, captures_grew=grew)
    finally:
        monitor.reset()
        monitor.disable()
    rec["http"] = http

    # -- fault ---------------------------------------------------------------
    plan = FaultPlan().raise_at("decode", nth=2,
                                exc=EngineFault("injected device fault"))
    srv = Server(FaultyEngine(eng, plan), segment_steps=8, warmup=True)
    try:
        if not srv.wait_ready(600) or srv.status != "ok":
            raise AssertionError(f"fault leg warmup: status {srv.status}")
        caps = dict(eng.programs.captures)
        f_outs, f_handles = serve_clients(srv, prompts, gen)
        fs = srv.fault_stats()
        if (srv.restarts != 1 or plan.injected != [("decode", 2, "raise")]
                or any(h.status != "finished" for h in f_handles)
                or eng.programs.captures != caps):
            raise AssertionError(
                f"fault leg: restarts {srv.restarts}, injected "
                f"{plan.injected}, statuses "
                f"{[h.status for h in f_handles]}, captures "
                f"{eng.programs.captures} against {caps}")
        for o in f_outs:
            if len(o) != n_new or not ((o >= 0) & (o < vocab)).all():
                raise AssertionError(f"fault leg: bad output {o!r}")
    finally:
        srv.shutdown(drain=False, timeout=120)
        del eng.__dict__["_run_prefill"]        # FaultyEngine's shadow
    splits, margins = first_splits(torch, np, model, prompts, f_outs, outs)
    rec["fault"] = {"plan": "raise EngineFault at decode_segment call 2",
                    "restarts": srv.restarts, "faults": {
                        f"{k[0]}/{k[1]}": n for k, n in fs["faults"].items()},
                    "recovery_s": fs["recovery_s"],
                    "replays": [h._replays for h in f_handles],
                    "first_split_from_serve": splits,
                    "split_top2_margins": margins,
                    "captures_after_warmup": 0}
    return rec, outs


def spec_server_phase(torch, np, model, prompts, eng, plain_outs, plain_rec,
                      profile=False):
    """Speculative decoding through the serving front on the 7B model, over
    the Server legs' engine (reset, its graphs kept): ``Server(eng,
    segment_steps=8, warmup=True, draft_k=SPEC["draft_k"], spec_mode=mode,
    speculative=True)`` for mode "host" and "device", the 8 prompts from 8
    client threads, 32 greedy tokens each (every request speculates by the
    server's default). For each: TTFT and TPOT from the handles beside the
    plain Server's, tokens per forward and the accepted share of the
    drafts (``spec_stats``, this serve's), the first token where each
    stream parts from the plain Server's with its top-2 margin (the phase
    fails at a margin of NEAR_TIE or more), no capture after warmup, the
    launches held against the path's and K4's launches per verify step
    against layers x W. Random weights reject every n-gram draft, so both
    modes run again with oracle drafts (the plain Server's streams,
    :func:`oracle_drafts`): what a verify step costs when its drafts are
    accepted. With ``profile``, the device-mode serves once more under
    ``torch.profiler``. Returns the records of host, device, host with
    oracle drafts and device with oracle drafts."""
    from paddle_tpu_torch import GenerationConfig, ops
    from paddle_tpu_torch.serving import Server

    cfg = model.config
    k = SPEC["draft_k"]
    L, W, n_new = cfg.num_hidden_layers, k + 1, 32
    gen = GenerationConfig(max_new_tokens=n_new)
    recs = []
    for mode, oracle in (("host", False), ("device", False), ("host", True),
                         ("device", True)):
        eng.reset_state()
        restore = (oracle_drafts(np, eng, prompts, plain_outs) if oracle
                   else (lambda: None))
        t0 = time.perf_counter()
        srv = Server(eng, segment_steps=8, warmup=True, draft_k=k,
                     spec_mode=mode, speculative=True)
        try:
            if not srv.wait_ready(600) or srv.status != "ok":
                raise AssertionError(f"spec server ({mode}) warmup: status "
                                     f"{srv.status}")
            warmup_s = time.perf_counter() - t0
            n0 = (eng.prefills, eng.prefill_chunks, eng.decode_steps,
                  eng.verify_steps)
            st0 = eng.spec_stats()
            seg0 = len(eng._segment_log)
            (outs, handles), counts = counted_run(
                torch, ops, eng, lambda: serve_clients(srv, prompts, gen))
            n_pre, n_chunks, n_steps, n_verify = (a - b for a, b in zip(
                (eng.prefills, eng.prefill_chunks, eng.decode_steps,
                 eng.verify_steps), n0))
            check_spec_launches(counts, L, W, n_pre, n_steps, n_verify,
                                "paged_decode", f"spec server ({mode})",
                                n_chunks=n_chunks)
            k4_per_verify = ((counts["paged_decode"] - L * n_steps)
                             / max(n_verify, 1))
            if n_verify < 1 or k4_per_verify != L * W:
                raise AssertionError(
                    f"spec server ({mode}): {n_verify} verify steps, K4 "
                    f"{k4_per_verify} launches a verify step, not "
                    f"{L} x {W}")
            st1 = eng.spec_stats()
            d = {key: st1[key] - st0[key] for key in (
                "proposed", "accepted", "forwards", "slot_steps",
                "emitted", "host_syncs")}
            rec = {"server": f"Server(eng, segment_steps=8, warmup=True, "
                             f"draft_k={k}, spec_mode={mode!r}, "
                             f"speculative=True)",
                   "drafts": ("oracle: the plain Server's streams" if oracle
                              else "n-gram prompt lookup"),
                   "warmup_s": warmup_s,
                   **handle_stats(handles, outs, cfg.vocab_size, n_new,
                                  seg0, eng),
                   "prefills": n_pre, "chunks": n_chunks,
                   "decode_steps": n_steps, "verify_steps": n_verify,
                   "launches": counts, "k4_launches_per_verify": k4_per_verify,
                   "spec": d,
                   "tokens_per_forward": d["emitted"] / max(d["slot_steps"],
                                                            1),
                   "accepted_share": d["accepted"] / max(d["proposed"], 1),
                   "captures_after_warmup": 0,
                   "plain_ttft_p50_s": plain_rec["ttft_p50_s"],
                   "plain_tpot_p50_s": plain_rec["tpot_p50_s"]}
            if profile and mode == "device":
                rec["profile"] = profile_run(
                    torch, lambda: serve_clients(srv, prompts, gen))
        finally:
            srv.shutdown(drain=False, timeout=120)
            restore()
        if srv.status != "stopped":
            raise AssertionError(f"spec server did not stop: {srv.status}")
        if oracle and d["accepted"] < 1:
            raise AssertionError(f"spec server ({mode}): no oracle draft "
                                 f"was accepted ({d})")
        splits, margins = first_splits(torch, np, model, prompts, outs,
                                       plain_outs)
        for n, m in zip(splits, margins):
            if m is not None and m >= NEAR_TIE:
                raise AssertionError(
                    f"spec server ({mode}): stream parts from the plain "
                    f"Server's at token {n}, top-2 margin {m:.3g} >= "
                    f"{NEAR_TIE}")
        rec.update(first_split_from_plain=splits, split_top2_margins=margins)
        recs.append(rec)
    eng.draft_k = 0
    return tuple(recs)


def lora_op_cost(torch, eng, batch: int) -> dict:
    """What the LoRA ops add to one decode step of ``eng`` (its bank, its
    model's layers and target widths, ``batch`` rows spread over the bank's
    indices): the per-layer, per-target gather, shrink and expand of
    ``models/llama.py::_lora_add`` on random activations, captured as one
    CUDA graph (as a decode segment replays them) and timed over 50
    replays by CUDA events; the ops the code launches a step (``L x
    targets x 5``: two gathers, two products, an add) beside the kernels
    ``torch.profiler`` records a step over LORA_PROFILE_STEPS eager steps
    after one warm-up step, and their device time a step (a lower bound
    where it recorded fewer kernels than there are ops); and the
    bound: the bank rows the step gathers (read once) plus the activations
    in and out, over the memory rate."""
    import gc

    from torch.profiler import ProfilerActivity, profile, schedule

    from paddle_tpu_torch.models.llama import _lora_add, _lora_layer

    reg, dev = eng.adapters, eng.device
    L, dt = reg.num_layers, reg.dtype
    idx = (torch.arange(batch, device=dev) % (reg.capacity + 1)).to(
        torch.int32)
    g = torch.Generator(dev).manual_seed(0)
    xs = {t: torch.randn((batch, 1, d_in), generator=g, device=dev,
                         dtype=dt) for t, (d_in, _) in reg.shapes.items()}
    ys = {t: torch.randn((batch, 1, d_out), generator=g, device=dev,
                         dtype=dt) for t, (_, d_out) in reg.shapes.items()}

    def step():
        for i in range(L):
            lay = _lora_layer((reg.bank, idx), i)
            for t in reg.targets:
                _lora_add(xs[t], ys[t], lay, t)

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        n = LORA_PROFILE_STEPS
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n,
                                       repeat=1)) as prof:
            for _ in range(n + 1):
                step()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        profiled = sum(e.count for e in kernels) / n
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for e in kernels) / n
        graph = torch.cuda.CUDAGraph()
        gc.collect()         # no graph destroyed mid-capture (_graphs.py)
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                step()
        finally:
            gc.enable()
        for _ in range(3):
            graph.replay()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(50):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
    ms = a.elapsed_time(b) / 50
    rows = len(set(idx.tolist()) - {0}) + 1
    elt = torch.empty((), dtype=dt).element_size()
    nbytes = L * sum(rows * reg.rank * (d_in + d_out) * elt
                     + batch * (d_in + 2 * d_out) * elt
                     for d_in, d_out in reg.shapes.values())
    flops = 2 * L * batch * reg.rank * sum(d_in + d_out
                                           for d_in, d_out in
                                           reg.shapes.values())
    bound_ms, bound_by = bound(nbytes, flops, 989e12)
    return {"batch": batch, "layers": L, "targets": reg.targets,
            "rank": reg.rank, "graph_ms_per_step": ms,
            "ops_per_step": L * len(reg.targets) * 5,
            "kernels_per_step_profiled": profiled,
            "profiled_steps": n,
            "kernel_names": sorted({e.key[:60] for e in kernels}),
            "device_ms_per_step_eager": dev_us / 1e3,
            "eager_ms_is_lower_bound":
                profiled < L * len(reg.targets) * 5,
            "bound_ms": bound_ms, "bound_by": bound_by}


def step_split(stats, steps) -> dict:
    """A serve's time a decode step, inside the decode segments (the
    segment log's seconds) and outside them (the span from the first token
    to the last finish, less the segments: the gaps, where admissions,
    prefills and the host's bookkeeping run)."""
    return {"decode_steps": steps,
            "segment_ms": stats["decode_s"] * 1e3 / steps,
            "gap_ms": (stats["span_s"] - stats["decode_s"]) * 1e3 / steps}


def lora_server_phase(torch, np, model, prompts, plain_outs, plain_rec,
                      profile=False):
    """Multi-tenant LoRA through the serving front on the 7B model (this
    slice's path): a paged engine configured as the Server leg's
    (``prefill_chunk=PREFIX["chunk"]``) with a bank of 4 slots of rank 16 on
    q/k/v/o (LORA_SERVER), behind ``Server(segment_steps=8,
    warmup=True)``, three adapters loaded through ``Server.load_adapter``
    after the warmup, then:

    - base only: the 8 prompts from 8 client threads, no adapter: TPOT of
      the LoRA engine on base traffic (the bank's cost in every captured
      step), the streams equal to the plain Server leg's;
    - mixed: the 8 prompts from 8 client threads, 2 base and 2 under each
      adapter (this slice's counted path), and while they decode a fourth
      adapter hot-loaded and ``unload_adapter`` of one in use, which must
      answer deferred and free after the drain; TTFT, TPOT and decode
      tokens/s beside the plain Server's; the base streams equal the plain
      Server's; launches held against the path's; for the plain Server,
      base only and mixed, the time a decode step inside the segments and
      in the gaps (:func:`step_split`);
    - solo: the unloaded adapter loaded again (its index recycled), each
      adapter request served alone, its stream against its mixed one,
      failing at a split of top-2 margin NEAR_TIE or more under its
      adapter;
    - HTTP: ``serve_http``, ``POST /adapters/unload`` of an idle adapter,
      ``POST /adapters/load`` from an npz written to a temporary
      directory, a ``POST /generate`` naming it (the tokens of the same
      request through ``Server.submit``), ``GET /healthz``'s ``lora``
      block.

    No capture after the warmup and the bank's addresses unmoved, through
    all of it. Every server and HTTP front is shut down before it returns;
    then the LoRA ops' cost in one decode step (:func:`lora_op_cost`)."""
    import tempfile
    import threading

    from paddle_tpu_torch import (GenerationConfig,
                                  PagedContinuousBatchingEngine, ops)
    from paddle_tpu_torch.serving import Server, serve_http

    cfg = model.config
    L, n_new, vocab = cfg.num_hidden_layers, 32, cfg.vocab_size
    ls = LORA_SERVER
    eng = PagedContinuousBatchingEngine(
        model, max_batch=8, num_pages=512, page_size=16, max_pages=64,
        prefill_chunk=PREFIX["chunk"], lora_capacity=ls["capacity"],
        lora_rank=ls["rank"], lora_targets=ls["targets"])
    names = sorted({a for a in ls["adapters"] if a is not None}) + ["a3"]
    t0 = time.perf_counter()
    adapters = {n: lora_factors(np, model, ls["targets"], ls["rank"],
                                ls["seed"] + i) for i, n in enumerate(names)}
    factors_s = time.perf_counter() - t0
    gen = GenerationConfig(max_new_tokens=n_new)
    cfgs = [GenerationConfig(max_new_tokens=n_new, adapter=a)
            for a in ls["adapters"]]
    rec = {"engine": plain_rec["engine"] + f", lora_capacity="
                     f"{ls['capacity']}, lora_rank={ls['rank']}, "
                     f"lora_targets={ls['targets']}",
           "server": "Server(eng, segment_steps=8, warmup=True)",
           "clients": len(prompts), "adapters": ls["adapters"],
           "bank_mb": sum(t.numel() * t.element_size()
                          for ab in eng.adapters.bank.values()
                          for t in ab) / 1e6,
           "factors_s": factors_s,
           "plain_ttft_p50_s": plain_rec["ttft_p50_s"],
           "plain_tpot_p50_s": plain_rec["tpot_p50_s"],
           "plain_decode_tokens_per_s": plain_rec["decode_tokens_per_s"]}
    t0 = time.perf_counter()
    srv = Server(eng, segment_steps=8, warmup=True)
    httpd = None
    try:
        if not srv.wait_ready(600) or srv.status != "ok":
            raise AssertionError(f"lora server warmup: status {srv.status}")
        rec["warmup_s"] = time.perf_counter() - t0
        caps, ptrs = dict(eng.programs.captures), bank_ptrs(eng)
        t0 = time.perf_counter()
        idx = {n: srv.load_adapter(n, adapters[n], alpha=ls["alpha"])
               for n in names[:3]}
        rec["load_s"] = (time.perf_counter() - t0) / 3

        # -- base traffic only ----------------------------------------------
        seg0, s0 = len(eng._segment_log), eng.decode_steps
        base_outs, base_h = serve_clients(srv, prompts, gen)
        rec["base_only"] = handle_stats(base_h, base_outs, vocab, n_new,
                                        seg0, eng)
        rec["base_only"]["decode_steps"] = eng.decode_steps - s0
        for i, (a, b) in enumerate(zip(base_outs, plain_outs)):
            if a.tolist() != b.tolist():
                raise AssertionError(
                    f"lora server: base stream {i} {a} differs from the "
                    f"plain Server's {b}")

        # -- mixed, with a hot load and a deferred unload mid-decode --------
        n0 = (eng.prefills, eng.prefill_chunks, eng.decode_steps)
        seg0 = len(eng._segment_log)
        admin = {}

        def mixed():
            box, errors = {}, []

            def clients():
                try:
                    box["r"] = serve_clients(srv, prompts, cfgs)
                except BaseException as e:       # re-raised below
                    errors.append(e)

            th = threading.Thread(target=clients, daemon=True)
            th.start()
            refs = eng.adapters._refs
            deadline = time.monotonic() + 600
            # both requests under a0 live in their slots
            while refs.get(idx["a0"], 0) < 2 and th.is_alive():
                if time.monotonic() > deadline:
                    raise AssertionError("lora server: a0 never ran")
                time.sleep(0.001)
            install = eng.adapters.install

            def timed_install(*args):
                # the gap's part of the hot load: the rows' copy alone
                t2 = time.perf_counter()
                try:
                    return install(*args)
                finally:
                    admin["install_in_gap_s"] = time.perf_counter() - t2

            eng.adapters.install = timed_install
            t1 = time.perf_counter()
            try:
                admin["a3_index"] = srv.load_adapter("a3", adapters["a3"],
                                                     alpha=ls["alpha"])
            finally:
                del eng.adapters.install
            admin["hot_load_s"] = time.perf_counter() - t1
            admin["unload_a0"] = srv.unload_adapter("a0")
            admin["draining_after_unload"] = \
                eng.adapters.resident()["draining"]
            th.join(600)
            if errors:
                raise errors[0]
            if th.is_alive():
                raise AssertionError("lora server: clients did not finish")
            return box["r"]

        (outs, handles), counts = counted_run(torch, ops, eng, mixed)
        n_pre, n_chunks, n_steps = (a - b for a, b in zip(
            (eng.prefills, eng.prefill_chunks, eng.decode_steps), n0))
        check_launches(counts, expect(
            counts, rms_norm=(2 * L + 1) * (n_pre + n_chunks + n_steps),
            fused_rope=2 * L * (n_pre + n_chunks), flash_fwd=L * n_pre,
            flash_fwd_prefix=L * n_chunks, paged_decode=L * n_steps),
            f"lora server: prefills {n_pre}, chunks {n_chunks}, decode "
            f"steps {n_steps}, layers {L}")
        res = eng.adapters.resident()
        if (admin["unload_a0"] is not False
                or admin["draining_after_unload"] != ["a0"]
                or res["adapters"] != ["a1", "a2", "a3"]
                or res["draining"] or res["free"] != 1):
            raise AssertionError(f"lora server: the unload of a0 in use "
                                 f"{admin}, afterwards {res}")
        for i, a in enumerate(ls["adapters"]):
            if a is None and outs[i].tolist() != plain_outs[i].tolist():
                raise AssertionError(
                    f"lora server: base stream {i} of the mixed batch "
                    f"{outs[i]} differs from the plain Server's")
        moved = [i for i, a in enumerate(ls["adapters"])
                 if a is not None and outs[i].tolist() != plain_outs[i]
                 .tolist()]
        if not moved:
            raise AssertionError("lora server: every adapter stream is "
                                 "the base model's")
        rec.update(handle_stats(handles, outs, vocab, n_new, seg0, eng),
                   prefills=n_pre, chunks=n_chunks, decode_steps=n_steps,
                   launches=counts, admin=admin, resident_after=res,
                   adapter_streams_off_base=len(moved))
        rec["step_split"] = {
            "plain": step_split(plain_rec, plain_rec["decode_steps"]),
            "base_only": step_split(rec["base_only"],
                                    rec["base_only"]["decode_steps"]),
            "mixed": step_split(rec, n_steps)}

        # -- each adapter request alone --------------------------------------
        idx["a0"] = srv.load_adapter("a0", adapters["a0"],
                                     alpha=ls["alpha"])
        idx["a3"] = admin["a3_index"]
        solo = [None if a is None else np.asarray(
                    srv.submit(p, c).result(timeout=600), np.int32)
                for p, c, a in zip(prompts, cfgs, ls["adapters"])]
        sel = [i for i, a in enumerate(ls["adapters"]) if a is not None]
        splits, margins = lora_splits(
            torch, np, model, eng.adapters.bank,
            [idx[ls["adapters"][i]] for i in sel], [prompts[i] for i in sel],
            [solo[i] for i in sel], [outs[i] for i in sel],
            "lora server: mixed against solo")
        rec.update(solo_first_split=splits, solo_split_top2_margins=margins,
                   a0_index_recycled=idx["a0"])
        if profile:
            rec["profile"] = profile_run(
                torch, lambda: serve_clients(srv, prompts, cfgs))

        # -- HTTP ---------------------------------------------------------
        httpd = serve_http(srv)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        code, raw = http_json(url + "/adapters/unload", {"name": "a3"})
        body = json.loads(raw)
        if code != 200 or body.get("unloaded") is not True:
            raise AssertionError(f"POST /adapters/unload: {code} {body}")
        web = lora_factors(np, model, ls["targets"], ls["rank"],
                           ls["seed"] + 9, per_layer=False)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "web.npz")
            np.savez(path, **{f"{t}.{h}": v for t, (a, b) in web.items()
                              for h, v in (("a", a), ("b", b))})
            code, raw = http_json(url + "/adapters/load",
                                  {"name": "web", "path": path,
                                   "alpha": ls["alpha"]})
        body = json.loads(raw)
        if code != 200 or "web" not in body["adapters"]["adapters"]:
            raise AssertionError(f"POST /adapters/load: {code} {body}")
        req = {"prompt": prompts[1].tolist(), "max_new_tokens": 16,
               "adapter": "web"}
        code, raw = http_json(url + "/generate", req)
        toks = json.loads(raw).get("tokens")
        want = srv.submit(prompts[1], GenerationConfig(
            max_new_tokens=16, adapter="web")).result(timeout=600)
        if code != 200 or toks != [int(t) for t in want]:
            raise AssertionError(f"POST /generate with an adapter: {code} "
                                 f"{toks} against {list(want)}")
        code, raw = http_json(url + "/healthz")
        health = json.loads(raw)
        if code != 200 or "web" not in health.get("lora", {}).get(
                "adapters", ()):
            raise AssertionError(f"/healthz {code} {health}")
        rec["http"] = {"web_index": body["index"], "tokens": toks,
                       "healthz_lora": health["lora"]}
        if eng.programs.captures != caps or bank_ptrs(eng) != ptrs:
            raise AssertionError(
                f"lora server: captures {eng.programs.captures} after "
                f"warmup's {caps}, or the bank moved")
        rec["captures_after_warmup"] = 0
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        srv.shutdown(drain=False, timeout=120)
    if srv.status != "stopped":
        raise AssertionError(f"lora server did not stop: {srv.status}")
    # the LoRA ops of one decode step, with the server stopped
    rec["lora_ops"] = lora_op_cost(torch, eng, 8)
    rec["lora_ops"]["share_of_base_tpot"] = (
        rec["lora_ops"]["graph_ms_per_step"]
        / (rec["base_only"]["tpot_p50_s"] * 1e3))
    del eng
    torch.cuda.empty_cache()
    return rec


def shared_prefix_prompts(np, vocab, n=8):
    """SHARED's traffic: ``n`` prompts that share one seeded system prefix
    and end in distinct seeded suffixes (chat and few-shot traffic)."""
    rng = np.random.RandomState(SHARED["seed"])
    system = rng.randint(0, vocab, (SHARED["prefix"],))
    lens = rng.randint(SHARED["suffix"][0], SHARED["suffix"][1] + 1, n)
    return [np.concatenate([system, rng.randint(0, vocab, (m,))]).astype(
        np.int32) for m in lens]


def cut_prompts(prompts, ps):
    """Each prompt cut inside its last full ``ps``-token block, 1 to 15
    tokens short of the block's end: a second round of these is resident
    whole (its full blocks and a partial block of the first round's), so a
    warm admission recomputes only the last token, at the odd offset plen -
    1, and copies the partial page on write before decode appends to it."""
    out = []
    for i, p in enumerate(prompts):
        f = (len(p) // ps) * ps
        out.append(p[:f - 1 - i % 15].copy())
    return out


def expected_prefix(np, rounds, ps, max_len, buckets):
    """The prefix cache's counters computed from the traffic alone: for
    each admission in order, its coverage is the longest run of resident
    full blocks (every full block of an earlier prompt is resident: the
    pool never evicts in these legs) extended by a partial match into the
    next full block of an earlier prompt. Returns per round ``{"hits",
    "tokens_saved", "cow", "warm", "cold"}``, as the engine counts them (a
    hit recomputes from min(coverage, plen - 1), pulled down so its tail
    bucket fits max_len; a hit ending mid-page copies that page)."""
    def lcp(a, b):
        n = min(len(a), len(b))
        d = np.nonzero(a[:n] != b[:n])[0]
        return int(d[0]) if len(d) else n

    seen, out = [], []
    for prompts in rounds:
        r = dict(hits=0, tokens_saved=0, cow=0)
        for p in prompts:
            cov = 0
            for q in seen:
                full = (len(q) // ps) * ps
                L = min(lcp(p, q), full)
                m = (L // ps) * ps
                cov = max(cov, L if m < full else m)
            plen = len(p)
            if cov:
                c_cmp = min(cov, plen - 1)
                wt = next(b for b in buckets if b >= plen - c_cmp)
                r["hits"] += 1
                r["tokens_saved"] += min(c_cmp, max_len - wt)
                p0 = cov if cov < plen else plen
                r["cow"] += int(p0 % ps != 0)
            seen.append(p)
        r["warm"] = r["hits"]
        r["cold"] = len(prompts) - r["hits"]
        out.append(r)
    return out


def check_streams(torch, np, model, prompts, outs, ref_outs, what):
    """Where each of ``outs`` first parts from ``ref_outs`` and the top-2
    margin there; raises where one parts at a margin of NEAR_TIE or more
    (a split below it is a near-tie of bf16 GEMMs at another M)."""
    splits, margins = first_splits(torch, np, model, prompts, outs, ref_outs)
    bad = [(s, mg) for s, mg in zip(splits, margins)
           if mg is not None and mg >= NEAR_TIE]
    if bad:
        raise AssertionError(f"{what}: streams part from the reference at "
                             f"{splits}, margins {margins}")
    return splits, margins


def equal_streams(torch, np, model, prompts, outs, ref_outs, what):
    """Where each of ``outs`` first parts from ``ref_outs`` and the top-2
    margin there; raises unless every stream equals its reference token for
    token."""
    splits, margins = first_splits(torch, np, model, prompts, outs, ref_outs)
    if ([np.asarray(o).tolist() for o in outs]
            != [np.asarray(r).tolist() for r in ref_outs]):
        raise AssertionError(f"{what}: streams part from the reference at "
                             f"{splits}, margins {margins}")
    return splits, margins


def prefix_serve_phase(torch, np, model, profile=False):
    """This slice's prefix leg on the 7B model: the paged engine with
    ``prefix_cache=True``, warmed, serves SHARED's 8 prompts (32 greedy
    tokens each), then the same prompts cut inside their last full block;
    both rounds' streams against the prefix-off engine's serve of the same
    prompts (first splits and margins), the prefix counters against the
    ones computed from the traffic, every kernel's launches against the
    path's (K3 causal per cold admission, its prefix-chunk instance per
    warm one, K4 per decode step), no capture after warmup, and the
    allocator's invariants at the end. Returns (the leg's record, the
    prompts, the prefix-off engine's 64-token streams of them)."""
    from paddle_tpu_torch import (GenerationConfig,
                                  PagedContinuousBatchingEngine, ops)

    cfg = model.config
    L, vocab, n_new = cfg.num_hidden_layers, cfg.vocab_size, SHARED["new"]
    kw = dict(max_batch=8, num_pages=512, page_size=16, max_pages=64)
    prompts = shared_prefix_prompts(np, vocab)
    cut = cut_prompts(prompts, kw["page_size"])
    gen = GenerationConfig(max_new_tokens=n_new)
    ref = PagedContinuousBatchingEngine(model, **kw)
    ref.warmup(8)
    ref_outs, ref_stats = [], []
    for ps_ in (prompts, cut):
        ref_outs.append(ref.serve(ps_, gen))
        ref_stats.append(serve_stats(ref, ref_outs[-1], vocab, n_new))
    long_outs = ref.serve(prompts, GenerationConfig(
        max_new_tokens=SHARED["pressure_new"]))
    if profile:
        off_profile = profile_run(torch, lambda: ref.serve(cut, gen))
    del ref
    eng = PagedContinuousBatchingEngine(model, prefix_cache=True, **kw)
    warm = eng.warmup(8)
    graphs = graphs_record(eng, warm)
    want = expected_prefix(np, (prompts, cut), kw["page_size"], eng.max_len,
                           eng.prefill_buckets)
    rec = {"engine": "PagedContinuousBatchingEngine(max_batch=8, "
                     "num_pages=512, page_size=16, max_pages=64, "
                     "prefix_cache=True)",
           "prefix": SHARED["prefix"], "prompt_lens": [len(p) for p in
                                                       prompts],
           "cut_lens": [len(p) for p in cut], "max_new_tokens": n_new,
           "graphs": graphs, "rounds": []}
    a = eng.alloc
    for i, (ps_, w) in enumerate(zip((prompts, cut), want)):
        h0, t0, c0 = a.prefix_hits, a.prefix_tokens_saved, a.cow_copies
        p0, q0, s0 = eng.prefills, eng.warm_prefills, eng.decode_steps
        outs, counts = counted_run(torch, ops, eng,
                                   lambda: eng.serve(ps_, gen))
        n_pre, n_warm = eng.prefills - p0, eng.warm_prefills - q0
        n_steps = eng.decode_steps - s0
        got = dict(hits=a.prefix_hits - h0,
                   tokens_saved=a.prefix_tokens_saved - t0,
                   cow=a.cow_copies - c0, warm=n_warm, cold=n_pre - n_warm)
        if got != w:
            raise AssertionError(f"prefix leg round {i + 1}: counters {got}"
                                 f" != {w} computed from the traffic")
        check_launches(counts, expect(
            counts, rms_norm=(2 * L + 1) * (n_pre + n_steps),
            fused_rope=2 * L * n_pre, flash_fwd=L * (n_pre - n_warm),
            flash_fwd_prefix=L * n_warm, paged_decode=L * n_steps),
            f"prefix round {i + 1}: cold {n_pre - n_warm}, warm {n_warm}, "
            f"decode steps {n_steps}, layers {L}")
        splits, margins = check_streams(torch, np, model, ps_, outs,
                                        ref_outs[i],
                                        f"prefix leg round {i + 1}")
        st = serve_stats(eng, outs, vocab, n_new)
        rec["rounds"].append(dict(
            **st, counters=got, launches=counts, decode_steps=n_steps,
            first_split_from_prefix_off=splits, split_top2_margins=margins,
            prefix_off_ttft_p50_s=ref_stats[i]["ttft_p50_s"],
            prefix_off_tpot_p50_s=ref_stats[i]["tpot_p50_s"]))
        rec.setdefault("launches", {})
        for k, n in counts.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + n
    if profile:
        # the second round once more (every admission warm again), beside
        # the prefix-off serve of the same prompts
        rec.update(profile=profile_run(torch, lambda: eng.serve(cut, gen)),
                   prefix_off_profile=off_profile)
    a.check()
    if a.used_pages or eng.free_slots() != 8:
        raise AssertionError(f"prefix leg: {a.used_pages} pages still used")
    rec.update(cached_pages=a.cached_pages, prefix_lookups=a.prefix_lookups)
    del eng
    torch.cuda.empty_cache()
    return rec, prompts, long_outs


def pressure_try(torch, model, prompts, pool, gen):
    """One run of the pressure leg at a pool of ``pool`` pages: a fresh
    engine and ``Server``, warmed, then SHARED's prompts from 8 client
    threads, counted. Returns a dict of the run (its engine under
    ``"eng"``)."""
    from paddle_tpu_torch import PagedContinuousBatchingEngine, ops
    from paddle_tpu_torch.serving import Server
    from paddle_tpu_torch.serving.scheduler import PreemptionBudgetExceeded

    eng = PagedContinuousBatchingEngine(
        model, max_batch=8, num_pages=pool, page_size=16, max_pages=64,
        prefix_cache=True, prefill_chunk=PREFIX["chunk"], kv_watermark=1.0)
    t0 = time.perf_counter()
    srv = Server(eng, segment_steps=8, warmup=True,
                 admission_mode="optimistic")
    try:
        if not srv.wait_ready(600) or srv.status != "ok":
            raise AssertionError(f"pressure leg warmup: {srv.status}")
        run = dict(eng=eng, pool=pool, warmup_s=time.perf_counter() - t0,
                   p0=eng.prefills, q0=eng.warm_prefills,
                   c0=eng.prefill_chunks, s0=eng.decode_steps,
                   seg0=len(eng._segment_log))
        # a request failing its preemption budget says "pool too small"
        (run["outs"], run["handles"]), run["counts"] = counted_run(
            torch, ops, eng, lambda: serve_clients(
                srv, prompts, gen, tolerate=(PreemptionBudgetExceeded,)))
        run.update(pressure=srv.pressure(), faults=srv.fault_stats())
    finally:
        srv.shutdown(drain=False, timeout=120)
    run["not_finished"] = [h.status for h in run["handles"]
                           if h.status != "finished"]
    return run


def pressure_serve_phase(torch, np, model, prompts, ref_outs):
    """This slice's pressure leg on the 7B model: ``Server(segment_steps=8,
    warmup=True, admission_mode="optimistic")`` over a paged engine with
    ``prefix_cache=True``, ``prefill_chunk=PREFIX["chunk"]`` and
    ``kv_watermark=1.0`` (admissions crowd the pool, so growth, not the
    watermark, meets the pressure), SHARED's 8 prompts from 8 client
    threads, SHARED["pressure_new"] greedy tokens each. The pool is the
    smallest the search finds in which all 8 finish under pressure: on a
    1-layer model of the same widths, from the larger of the largest
    request's worst case (prompt + tokens, in pages) and the least pool
    that can preempt (the shared pages plus enough live requests to
    outgrow them) up by PRESSURE_STEP pages until a run has at least one
    preemption and no request failed its ``max_preemptions`` budget; then
    the 32-layer model at that pool (a step up, at most twice, if its run
    differs). There: no FAILED handle, ``pressure()`` reporting the
    preemptions, no capture after warmup, launches against
    the path's, and the streams against the prefix-off reserved
    engine's."""
    import dataclasses

    from paddle_tpu_torch import GenerationConfig, LlamaForCausalLM

    cfg = model.config
    L, vocab = cfg.num_hidden_layers, cfg.vocab_size
    n_new, ps = SHARED["pressure_new"], 16
    gen = GenerationConfig(max_new_tokens=n_new)
    least = max(-(-(len(p) + n_new) // ps) for p in prompts)
    # a lower bound of the pools that can preempt. An admission needs its
    # whole claim (prompt + one page) free, the shared prefix's pages
    # included, but takes only its private pages, so at least the shared
    # pages stay free behind the last admission of the live set, and each
    # live request grows by at most `grow` pages after it: preempting
    # needs k live requests with k * grow > shared. Their pool holds the
    # shared pages, k - 1 private parts (claim less shared) and one whole
    # claim: at least the k smallest claims less k - 2 times the shared
    shared = SHARED["prefix"] // ps
    grow = -(-(n_new - ps) // ps) + 1
    k = shared // grow + 1
    claims = sorted(-(-(len(p) + ps) // ps) for p in prompts)
    start = max(least, sum(claims[:k]) - (k - 2) * shared)
    # the search runs on a 1-layer model of the same widths: the pool's
    # history depends on the prompts, the page size and the queue's order,
    # not on the weights or the depth, and its runs take a fraction of the
    # 32-layer model's time
    small = LlamaForCausalLM(
        dataclasses.replace(cfg, num_hidden_layers=1), device=model.device,
        generator=torch.Generator(model.device).manual_seed(3))
    search = []
    pool = start
    while True:
        t0 = time.perf_counter()
        run = pressure_try(torch, small, prompts, pool, gen)
        search.append(dict(pool=pool, preemptions=run["eng"].alloc.preemptions,
                           not_finished=run["not_finished"],
                           s=time.perf_counter() - t0))
        log(f"  pressure search (1 layer): {search[-1]}")
        if not run["not_finished"] and search[-1]["preemptions"]:
            break
        if len(search) == PRESSURE_TRIES:
            raise AssertionError(f"pressure leg: no pool in {search} "
                                 f"finished all 8 requests under pressure")
        pool += PRESSURE_STEP
    del run, small
    torch.cuda.empty_cache()
    tries = []
    for k in range(3):
        t0 = time.perf_counter()
        run = pressure_try(torch, model, prompts, pool + k * PRESSURE_STEP,
                           gen)
        eng = run["eng"]
        tries.append(dict(pool=run["pool"],
                          preemptions=eng.alloc.preemptions,
                          not_finished=run["not_finished"],
                          s=time.perf_counter() - t0))
        log(f"  pressure leg: {tries[-1]}")
        if not run["not_finished"] and eng.alloc.preemptions:
            break
        del run, eng
        torch.cuda.empty_cache()
    else:
        raise AssertionError(f"pressure leg: the 32-layer runs {tries} "
                             f"after the search {search}")
    outs, handles, counts = run["outs"], run["handles"], run["counts"]
    n_pre, n_warm = eng.prefills - run["p0"], eng.warm_prefills - run["q0"]
    n_chunks = eng.prefill_chunks - run["c0"]
    n_steps = eng.decode_steps - run["s0"]
    check_launches(counts, expect(
        counts, rms_norm=(2 * L + 1) * (n_pre + n_chunks + n_steps),
        fused_rope=2 * L * (n_pre + n_chunks),
        flash_fwd=L * (n_pre - n_warm),
        flash_fwd_prefix=L * (n_chunks + n_warm),
        paged_decode=L * n_steps),
        f"pressure leg: prefills {n_pre} ({n_warm} warm), chunks "
        f"{n_chunks}, decode steps {n_steps}, layers {L}")
    a, pr, fs = eng.alloc, run["pressure"], run["faults"]
    if (pr["preemptions"] != a.preemptions
            or pr["admission_mode"] != "optimistic"
            or sum(h._preempts for h in handles) < 1
            or fs["restarts"] or fs["faults"]):
        raise AssertionError(f"pressure leg: preemptions {a.preemptions}, "
                             f"pressure() {pr}, faults {fs}")
    a.check()
    if a.used_pages or eng.free_slots() != 8:
        raise AssertionError(f"pressure leg: {a.used_pages} pages used")
    splits, margins = check_streams(torch, np, model, prompts, outs,
                                    ref_outs, "pressure leg")
    rec = {"engine": f"PagedContinuousBatchingEngine(max_batch=8, "
                     f"num_pages={run['pool']}, page_size=16, max_pages=64, "
                     f"prefix_cache=True, prefill_chunk={PREFIX['chunk']}, "
                     f"kv_watermark=1.0)",
           "server": "Server(eng, segment_steps=8, warmup=True, "
                     "admission_mode='optimistic')",
           "pool_pages": run["pool"], "least_pool_pages": least,
           "search_start_pages": start, "search_1_layer": search,
           "tries": tries,
           "max_new_tokens": n_new,
           "warmup_s": run["warmup_s"],
           **handle_stats(handles, outs, vocab, n_new, run["seg0"], eng),
           "preemptions": a.preemptions,
           "handle_preempts": [h._preempts for h in handles],
           "pressure": pr, "prefills": n_pre, "warm_prefills": n_warm,
           "chunks": n_chunks, "decode_steps": n_steps, "launches": counts,
           "first_split_from_reserved": splits, "split_top2_margins": margins,
           "captures_after_warmup": 0}
    del run, eng
    torch.cuda.empty_cache()
    return rec


def generate_phase(torch, np, model, profile=False):
    """``CausalLMEngine.generate`` on GEN["batch"] prompts of GEN["plen"]
    tokens, the engine warmed at that batch: one batched prefill, then
    GEN["new"] - 1 replays of the captured step."""
    from paddle_tpu_torch import CausalLMEngine, GenerationConfig, ops

    cfg = model.config
    L, b, plen, new = (cfg.num_hidden_layers, GEN["batch"], GEN["plen"],
                       GEN["new"])
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                           (b, plen)).astype(np.int32)
    eng = CausalLMEngine(model, max_batch=b, max_len=GEN["max_len"])
    torch.cuda.reset_peak_memory_stats()
    warm = eng.warmup(batch=b)
    out, counts = counted_run(torch, ops, eng, lambda: eng.generate(
        ids, GenerationConfig(max_new_tokens=new)))
    graphs = graphs_record(eng, warm)
    steps = new - 1
    check_launches(counts, expect(
        counts, rms_norm=(2 * L + 1) * (1 + steps),
        fused_rope=2 * L * (1 + steps), flash_fwd=L, decode_mha=L * steps),
        f"1 prefill of {b} x {plen}, {steps} steps, layers {L}")
    if (out.shape != (b, plen + new) or not (out[:, :plen] == ids).all()
            or not ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"generate: bad output {out!r}")
    st = eng.generate_stats
    rec = {"engine": f"CausalLMEngine(max_batch={b}, "
                     f"max_len={GEN['max_len']})",
           "batch": b, "prompt_len": plen, "max_new_tokens": new,
           "ttft_s": st["ttft_s"], "decode_s": st["decode_s"],
           "tpot_s": st["decode_s"] / steps,
           "decode_tokens_per_s": b * steps / st["decode_s"],
           "launches": counts, "graphs": graphs,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile:
        rec["profile"] = profile_run(torch, lambda: eng.generate(
            ids, GenerationConfig(max_new_tokens=new)))
    del eng
    torch.cuda.empty_cache()
    return rec


def dense_serve_phase(torch, np, model, prompts, paged_outs, profile=False):
    """The dense ``ContinuousBatchingEngine`` on the paged run's prompts;
    the first token where each dense stream parts from the paged one is
    recorded (K4 and K7 sum in other orders, so near-ties may flip)."""
    from paddle_tpu_torch import (ContinuousBatchingEngine, GenerationConfig,
                                  ops)

    cfg = model.config
    L = cfg.num_hidden_layers
    eng = ContinuousBatchingEngine(model, **DENSE)
    gen = GenerationConfig(max_new_tokens=32)
    outs, counts, n_pre, n_steps, graphs = run_engine(torch, ops, eng,
                                                      prompts, gen)
    check_serve_launches(counts, L, n_pre, n_steps, "decode_mha")
    splits, margins = first_splits(torch, np, model, prompts, outs,
                                   paged_outs)
    rec = {"engine": f"ContinuousBatchingEngine(max_batch="
                     f"{DENSE['max_batch']}, max_len={DENSE['max_len']})",
           **serve_stats(eng, outs, cfg.vocab_size, gen.max_new_tokens),
           "prefills": n_pre, "decode_steps": n_steps, "launches": counts,
           "graphs": graphs, "first_split_from_paged": splits,
           "split_top2_margins": margins}
    if profile:
        rec["profile"] = profile_run(torch, lambda: eng.serve(prompts, gen))
    del eng
    torch.cuda.empty_cache()
    return rec


def lora_times(repeats: int = 2) -> dict:
    """Only the LoRA legs, to read their spread in one process: phase 4's
    :func:`lora_e2e` at 2 layers (its merged-weights oracle kept), then at
    7B a plain ``Server`` serve over the chunked engine and phase 5's
    :func:`lora_server_phase` ``repeats`` times against it (TTFT, TPOT,
    tokens/s, the segment and gap time a step, the LoRA ops' cost and the
    hot load's)."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from paddle_tpu_torch import (GenerationConfig, LlamaForCausalLM,
                                  PagedContinuousBatchingEngine, llama_config)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.serving import Server

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"card": smi_line(), "build_s": _build.build_all()}
    cfg = llama_config(PRESET, num_hidden_layers=2, dtype="bfloat16")
    gpu = LlamaForCausalLM(cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(7))
    cpu = LlamaForCausalLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    out["merged_oracle"] = lora_e2e(torch, np, gpu, cpu)["merged_oracle"]
    del gpu, cpu
    torch.cuda.empty_cache()
    cfg = llama_config(PRESET, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (100, 180, 260, 340, 420, 500, 600, 700)]
    eng = PagedContinuousBatchingEngine(
        model, max_batch=8, num_pages=512, page_size=16, max_pages=64,
        prefill_chunk=PREFIX["chunk"])
    srv = Server(eng, segment_steps=8, warmup=True)
    try:
        if not srv.wait_ready(600) or srv.status != "ok":
            raise AssertionError(f"server warmup: status {srv.status}")
        seg0, s0 = len(eng._segment_log), eng.decode_steps
        outs, handles = serve_clients(srv, prompts,
                                      GenerationConfig(max_new_tokens=32))
        plain = handle_stats(handles, outs, cfg.vocab_size, 32, seg0, eng)
        plain.update(decode_steps=eng.decode_steps - s0,
                     engine="PagedContinuousBatchingEngine(max_batch=8, "
                            "num_pages=512, page_size=16, max_pages=64, "
                            f"prefill_chunk={PREFIX['chunk']})")
    finally:
        srv.shutdown(drain=False, timeout=120)
    del eng, srv
    torch.cuda.empty_cache()
    keys = ("ttft_p50_s", "tpot_p50_s", "decode_tokens_per_s")
    out["plain"] = {k: plain[k] for k in keys}
    out["lora"] = []
    for _ in range(repeats):
        sl = lora_server_phase(torch, np, model, prompts, outs, plain)
        out["lora"].append(dict(
            {k: sl[k] for k in keys},
            base_only_tpot_p50_s=sl["base_only"]["tpot_p50_s"],
            step_split=sl["step_split"], admin=sl["admin"],
            lora_ops={k: v for k, v in sl["lora_ops"].items()
                      if k != "kernel_names"},
            solo_first_split=sl["solo_first_split"]))
    return out


def serve_times(tree: str) -> dict:
    """Phase 5's runs with the package of the checkout at ``tree``: the 7B
    preset through the paged engine (and with int8 pools where that
    checkout takes ``kv_dtype``), the dense engine and
    ``CausalLMEngine.generate``, each engine warmed first as that checkout
    allows (``warmup()`` where it has one, else a warm-up serve of a
    prompt per prefill bucket, or a 2-token ``generate``, as phase 5 did
    before ``warmup()`` existed). TTFT p50, TPOT p50 and decode tokens/s
    of each run. Only public names are used, so a parent tree runs it as
    well. Run for two checkouts in turns, each in a fresh process, it
    compares them on one card."""
    import inspect

    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    from paddle_tpu_torch import (CausalLMEngine, ContinuousBatchingEngine,
                                  GenerationConfig, LlamaForCausalLM,
                                  PagedContinuousBatchingEngine, llama_config)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = llama_config(PRESET, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (100, 180, 260, 340, 420, 500, 600, 700)]
    gen = GenerationConfig(max_new_tokens=32)
    paged = dict(max_batch=8, num_pages=512, page_size=16, max_pages=64)
    engines = [("paged", lambda: PagedContinuousBatchingEngine(model,
                                                               **paged))]
    if "kv_dtype" in inspect.signature(
            PagedContinuousBatchingEngine).parameters:
        engines.append(("int8", lambda: PagedContinuousBatchingEngine(
            model, kv_dtype="int8", **paged)))
    engines.append(("dense", lambda: ContinuousBatchingEngine(model,
                                                               **DENSE)))
    res = {"tree": os.path.abspath(tree), "card": smi_line()}
    for name, make in engines:
        eng = make()
        if hasattr(eng, "warmup"):
            eng.warmup(8)
        else:
            eng.serve([prompts[-1][:n] for n in (100, 200, 400, 700)],
                      GenerationConfig(max_new_tokens=2))
        torch.cuda.synchronize()
        st = serve_stats(eng, eng.serve(prompts, gen), cfg.vocab_size,
                         gen.max_new_tokens)
        res[name] = {k: st[k] for k in ("ttft_p50_s", "tpot_p50_s",
                                        "decode_tokens_per_s")}
        del eng
        torch.cuda.empty_cache()
    b, new = GEN["batch"], GEN["new"]
    ids = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (b, GEN["plen"])).astype(np.int32)
    eng = CausalLMEngine(model, max_batch=b, max_len=GEN["max_len"])
    if hasattr(eng, "warmup"):
        eng.warmup(batch=b)
    else:
        eng.generate(ids, GenerationConfig(max_new_tokens=2))
    torch.cuda.synchronize()
    eng.generate(ids, GenerationConfig(max_new_tokens=new))
    st = eng.generate_stats
    res["generate"] = {"ttft_s": st["ttft_s"],
                       "tpot_s": st["decode_s"] / (new - 1),
                       "decode_tokens_per_s": b * (new - 1) / st["decode_s"]}
    return res


def fmt_phase(torch, dev, profile=False):
    """FusedMultiTransformer at the GPT-3 6.7B widths: a warm-up, then a
    context pass of FMT["batch"] x FMT["context"] tokens into caches of
    FMT["max_len"] and FMT["steps"] decode steps with ragged seq_lens
    (row i holds context - i context / batch tokens)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer

    e, nh, ff, L = FMT["hidden"], FMT["heads"], FMT["ffn"], FMT["layers"]
    b, s, n = FMT["batch"], FMT["context"], FMT["steps"]
    bf = torch.bfloat16
    t0 = time.perf_counter()
    m = FusedMultiTransformer(e, nh, ff, num_layers=L, device=dev, dtype=bf,
                              generator=torch.Generator(dev).manual_seed(21))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g = torch.Generator(dev).manual_seed(22)
    src = torch.randn(b, s, e, generator=g, device=dev).to(bf)
    xs = torch.randn(n, b, 1, e, generator=g, device=dev).to(bf)
    lens0 = torch.tensor([s - s // b * i for i in range(b)],
                         dtype=torch.int32, device=dev)
    caches = m.make_caches(L, b, FMT["max_len"], nh, e // nh, bf, dev)

    def run(steps):
        """(context ms, per-step ms, every output finite)."""
        finite = []
        with torch.no_grad():
            t = time.perf_counter()
            y, _ = m(src, caches=caches)
            finite.append(torch.isfinite(y).all())
            torch.cuda.synchronize()
            ctx_ms = (time.perf_counter() - t) * 1e3
            step_ms = []
            for i in range(steps):
                t = time.perf_counter()
                y, _ = m(xs[i], caches=caches, time_step=s + i,
                         seq_lens=lens0 + i)
                finite.append(torch.isfinite(y).all())
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
        return ctx_ms, step_ms, bool(torch.stack(finite).all())

    run(2)                                                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ctx_ms, step_ms, finite = run(n)
    counts = ops.launch_counts()
    check_launches(counts, expect(counts, fused_layer_norm=2 * L * (1 + n),
                                  flash_fwd=L, decode_mha=L * n),
                   f"1 context pass, {n} decode steps, layers {L}")
    if not finite:
        raise AssertionError("fused transformer: non-finite output")
    step = statistics.median(step_ms)
    rec = {"config": "GPT-3 6.7B widths (paddle_tpu/models/gpt.py:54 "
                     "'6b7'): hidden 4096, 32 layers, 32 heads, FFN 16384, "
                     "bf16, random weights",
           "layers": L, "batch": b, "context": s, "max_len": FMT["max_len"],
           "decode_steps": n, "params": sum(p.numel()
                                             for p in m.parameters()),
           "model_init_s": init_s, "context_ms": ctx_ms,
           "context_tokens_per_s": b * s / ctx_ms * 1e3,
           "decode_step_ms": step_ms, "decode_step_ms_median": step,
           "decode_tokens_per_s": b / step * 1e3, "launches": counts,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    if profile:
        rec["profile"] = profile_run(torch, lambda: run(n))
    del m, caches
    torch.cuda.empty_cache()
    return rec


# -- phase 8: the kernel ops at full widths (this slice's main path) --------


def ops_phase(torch, dev, np):
    """The JAX package's public kernel ops at full widths, through the
    port's entry points, each kernel counted: the main-gradient
    accumulation of one decoder layer's seven linears, the expert FFN of an
    ERNIE-MoE "large" layer on MOE["tokens"] routed tokens, one decode step
    of every layer of the PRESET model through the stock paged_attention,
    and one attention forward and backward at the training shape under
    FLAGS_flash_head_batched. Counts are read just after; the outputs are
    then held against the plain versions."""
    import torch.nn.functional as F

    from paddle_tpu_torch import llama_config, ops

    mc = llama_config(PRESET)
    g = torch.Generator(device=dev).manual_seed(51)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)

    # inputs, made before the counted run
    b, s = GRAD_ADD_TOKENS
    lin = seven_linears(mc)
    acts = {k: randn(b, s, k) for k in {k for _, k, _, _ in lin}}
    grads = {(name, i): randn(b, s, n) for name, _, n, c in lin
             for i in range(c)}
    main = {(name, i): torch.zeros(k, n, device=dev)
            for name, k, n, c in lin for i in range(c)}
    e, f, ne = MOE["hidden"], MOE["ffn"], MOE["experts"]
    tokens, top_k = MOE["tokens"], MOE["top_k"]
    x_moe = randn(tokens, e)
    gate_w = randn(e, ne, scale=e ** -0.5)
    gate_bias = randn(ne, dtype=torch.float32, scale=0.5)   # uneven experts
    w1, w2 = randn(ne, e, f, scale=e ** -0.5), randn(ne, f, e, scale=f ** -0.5)
    L, nh, d = mc.num_hidden_layers, mc.num_attention_heads, mc.head_dim
    pools = [stock_paged_pools(torch, g, dev, mc.num_key_value_heads, d)
             for _ in range(L)]
    lens = torch.tensor(STOCK["lens"], dtype=torch.int32, device=dev)
    q_dec = randn(L, len(STOCK["lens"]), nh, d, scale=d ** -0.5)
    tb, ts = TRAIN["batch"], TRAIN["seq"]
    th = TRAIN["overrides"]["num_attention_heads"]
    qa, ka, va = (randn(tb, ts, th, 128).requires_grad_() for _ in range(3))
    doa = randn(tb, ts, th, 128)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # 1. main gradients of the layer's seven linears
    k_in = {"q/k/v/o": mc.hidden_size, "gate/up": mc.hidden_size,
            "down": mc.intermediate_size}
    for key, dw in main.items():
        main[key] = ops.fused_linear_param_grad_add(acts[k_in[key[0]]],
                                                    grads[key], dw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # 2. the MoE expert FFN: top-2 routing, rows sorted by expert (the
    # group sizes stay on the card), up, GELU, down, gate-weighted combine
    logits = x_moe.float() @ gate_w.float() + gate_bias
    gate_p, expert = torch.topk(torch.softmax(logits, -1), top_k, dim=-1)
    order = torch.argsort(expert.reshape(-1), stable=True)
    sizes = torch.bincount(expert.reshape(-1), minlength=ne).int()
    xs = x_moe[order // top_k]
    h = ops.grouped_matmul(xs, w1, sizes)
    act = F.gelu(h).to(bf)
    y = ops.grouped_matmul(act, w2, sizes)
    moe_out = torch.zeros(tokens, e, device=dev).index_add_(
        0, order // top_k, y * gate_p.reshape(-1)[order, None])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # 3. one decode step of every layer through the stock paged_attention
    dec = [ops.paged_attention(q_dec[i], kp, vp, lens, table,
                               pages_per_compute_block=STOCK["ppcb"])
           for i, (kp, vp, table) in enumerate(pools)]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    # 4. attention forward and backward at the training shape, head-batched
    with hb_flag(True):
        att = ops.flash_attention(qa, ka, va, causal=True)
        att_grads = torch.autograd.grad(att, (qa, ka, va), doa)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    counts, routes = ops.launch_counts(), ops.route_calls()

    n_lin = sum(c for _, _, _, c in lin)
    check_launches(counts, expect(
        counts, grad_add=n_lin, grouped_matmul=2, paged_decode=L,
        flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1),
        f"{n_lin} linears, 1 MoE FFN, {L} stock decode layers, 1 attention")
    if routes != {"flash_hb": 1, "paged_attention": L}:
        raise AssertionError(f"kernel ops: route calls {routes}, the path "
                             f"implies flash_hb 1, paged_attention {L}")
    # the instances the dispatch took: the Hopper ones for every launch
    ga = importlib.import_module("paddle_tpu_torch.ops.grad_add")
    gm = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
    instances = {"grad_add": sorted({ga.kernel_for(
        bf, b * s, k_in[key[0]], grads[key].shape[-1],
        (k_in[key[0]], grads[key].shape[-1]),
        (acts[k_in[key[0]]].data_ptr(), grads[key].data_ptr()))
        for key in main}), "grouped_matmul": sorted({gm.kernel_for(
            bf, a.shape[1], w.shape[2], (a.stride(0), w.stride(0),
                                         w.stride(1)),
            (a.data_ptr(), w.data_ptr())) for a, w in ((xs, w1), (act, w2))})}
    if instances != {"grad_add": ["wgmma"], "grouped_matmul": ["wgmma"]}:
        raise AssertionError(f"kernel ops: the dispatch took {instances}, "
                             f"not the Hopper instances")
    # what came out: finite, of its shape, and equal to the plain versions
    errs = {}
    key = ("down", 0)
    errs["grad_add"] = check_close(
        torch, "ops: main gradient of down", main[key],
        ops.fused_linear_param_grad_add_ref(
            acts[mc.intermediate_size], grads[key],
            torch.zeros_like(main[key])), **TOL["grad_add"])
    h_ref = ops.grouped_matmul_ref(xs, w1, sizes)
    errs["grouped_matmul"] = max(
        check_close(torch, "ops: MoE up", h, h_ref, **TOL["grouped_matmul"]),
        check_close(torch, "ops: MoE down", y, ops.grouped_matmul_ref(
            act, w2, sizes), **TOL["grouped_matmul"]))
    errs["paged_attention"] = max(check_close(
        torch, f"ops: stock decode layer {i}", dec[i],
        ops.paged_attention_ref(q_dec[i], *pools[i][:2], lens, pools[i][2],
                                pages_per_compute_block=STOCK["ppcb"]),
        **TOL["paged_attention"]) for i in (0, L - 1))
    plain, _ = ops.flash_attention_bshd_ref(qa.detach(), ka.detach(),
                                            va.detach(), causal=True)
    errs["flash_hb"] = check_close(torch, "ops: head-batched attention", att,
                                   plain, **TOL["flash_hb"])
    shapes_ok = (moe_out.shape == (tokens, e) and att.shape == qa.shape
                 and all(o.shape == (len(STOCK["lens"]), nh, d) for o in dec)
                 and bool(torch.isfinite(moe_out).all())
                 and all(bool(torch.isfinite(t).all()) for t in att_grads))
    if not shapes_ok:
        raise AssertionError("kernel ops: an output is non-finite or of the "
                             "wrong shape")
    rec = {"model": f"{PRESET} widths (linears, stock decode), ERNIE-MoE "
                    f"large (experts), {TRAIN['preset']}/h128 training "
                    f"attention",
           "linears": n_lin, "tokens": b * s, "moe_rows": tokens * top_k,
           "moe_group_sizes": sizes.tolist(), "decode_layers": L,
           "grad_add_s": t1 - t0, "moe_s": t2 - t1, "stock_decode_s": t3 - t2,
           "attention_s": t4 - t3, "launches": counts, "route_calls": routes,
           "instances": instances, "max_abs_err": errs}
    del acts, grads, main, pools, w1, w2, act, qa, ka, va
    torch.cuda.empty_cache()
    return rec


# kernel name fragments -> where the device time goes
_CATEGORIES = [("rms_norm", ("rms_norm_vec_kernel", "rms_norm_elem_kernel")),
               ("fused_layer_norm", ("_layer_norm_kernel",)),
               ("fused_rope", ("rope_vec_kernel", "rope_elem_kernel")),
               ("flash_fwd", ("flash_fwd_kernel",)),
               ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
               ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
               ("paged_decode", ("paged_decode_kernel",
                                 "paged_decode_combine_kernel")),
               ("decode_mha", ("decode_mha_kernel",
                               "decode_mha_combine_kernel")),
               ("grad_add", ("grad_add_",)),
               ("grouped_matmul", ("grouped_matmul_kernel",)),
               ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma",
                                    "sm90_")),
               ("indexing", ("index", "gather", "scatter")),
               ("elementwise and other", ("",))]


# SASS opcodes counted per kernel (phase 2), and the 128-bit global loads
# and stores (LDG and STG with a .128 modifier)
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "FFMA")
SASS_WIDE = ("LDG.128", "STG.128")


def sass_opcodes(sass: str) -> dict:
    """Per kernel function of ``cuobjdump -sass`` output: how many
    instructions of each of SASS_OPS and SASS_WIDE its code holds."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS + SASS_WIDE, 0)
        elif fn is not None and "*/" in line:
            words = [w for w in line.split("*/", 1)[1].split()
                     if not w.startswith("@")]
            parts = words[0].split(".") if words else [""]
            if parts[0] in SASS_OPS:
                counts[fn][parts[0]] += 1
            elif parts[0] in ("LDG", "STG") and "128" in parts:
                counts[fn][f"{parts[0]}.128"] += 1
    return counts


def kernel_label(mangled: str) -> str:
    """``grad_add_wgmma_kernel<bf16>`` from a GEMM kernel's mangled name:
    the kernel and the type of its template argument (fp32, bf16, fp16)."""
    tail = mangled.split("_cu_", 1)[-1]
    m = re.search(r"(?:grad_add|grouped_matmul)\w*?kernel(?:_[a-z0-9]+)?"
                  r"(?=[IE])", tail)
    if m is None:
        return mangled
    rest = tail[m.end():m.end() + 20]
    arg = ("" if not rest.startswith("I") else "<fp32>" if rest[1] == "f"
           else "<bf16>" if "bfloat16" in rest else "<fp16>")
    return m.group(0) + arg


def gemm_sass(build) -> dict:
    """SASS counts of K9's and K10's kernels; raises unless every Hopper
    instance holds HGMMA and UTMALDG (its products are wgmma, its loads
    TMA)."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    out = {}
    for name in ("grad_add", "grouped_matmul"):
        sass = subprocess.run(
            [cuobjdump, "-sass", str(build.library_path(name))], check=True,
            capture_output=True, text=True, timeout=300).stdout
        for fn, c in sass_opcodes(sass).items():
            key = kernel_label(fn)
            out[key] = c
            if "wgmma" in fn and not (c["HGMMA"] and c["UTMALDG"]):
                raise AssertionError(f"{key}: no HGMMA or UTMALDG in its "
                                     f"SASS: {c}")
    return out


def norm_rope_sass(build) -> dict:
    """SASS counts of K1's and K2's kernels, by demangled name where the
    toolkit's ``cu++filt`` is there; raises unless every vector-path
    instance (``rms_norm_vec_kernel``, ``rope_vec_kernel``) moves x and
    its output with 128-bit global loads and stores."""
    bin_dir = os.path.dirname(build.find_nvcc())
    sass = subprocess.run(
        [os.path.join(bin_dir, "cuobjdump"), "-sass",
         str(build.library_path("norm_rope"))], check=True,
        capture_output=True, text=True, timeout=300).stdout
    counts = sass_opcodes(sass)
    filt = os.path.join(bin_dir, "cu++filt")
    names = list(counts)
    if os.path.exists(filt):
        names = subprocess.run([filt], input="\n".join(names), check=True,
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    out = {}
    for fn, name in zip(counts, names):
        c = counts[fn]
        out[name] = {k: c[k] for k in ("FFMA",) + SASS_WIDE}
        if ("vec_kernel" in fn
                and not (c["LDG.128"] and c["STG.128"])):
            raise AssertionError(f"{name}: no 128-bit global load or store "
                                 f"in its SASS: {out[name]}")
    return out


def profile_run(torch, run):
    """``run()`` once more under ``torch.profiler``: device time by kernel
    category and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cats = {name: 0.0 for name, _ in _CATEGORIES}
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = (us, e.count)
        low = e.key.lower()
        cat = next(n for n, keys in _CATEGORIES
                   if any(k in low for k in keys))
        cats[cat] += us
    busy = sum(cats.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"  profile: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%})")
    for name, us in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"    {name:22s} {us / 1e3:9.2f} ms  {us / max(busy, 1):6.1%}")
    for name, (us, n) in top:
        log(f"    {us / 1e3:9.2f} ms  x{n:<6d} {name[:90]}")
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "categories_ms": {k: v / 1e3 for k, v in cats.items()},
            "top_kernels": [(k, us / 1e3, n) for k, (us, n) in top]}


def kernel_entries(rows: dict, runs: dict) -> list:
    """The JSON line's entries: every kernel, then the two routes (their
    calls in place of launches), each with its phase-3 numbers. A kernel's
    ``launches`` are its count over this slice's paths where it runs there,
    else over the earlier paths that run it; a route's count over the
    paths that take the routes. ``instances`` holds the phase-3 numbers of
    a kernel's other entry points (fp32)."""
    def entry(name, route, src, by_path):
        r = rows[name]
        launches = next((n for n in (sum(by_path.get(p, 0) for p in ps)
                                     for ps in (SLICE_PATHS,)
                                     + EARLIER_PATHS) if n), 0)
        return {"name": name, "route": route, "source": src,
                "replaces": REPLACES[name], "launches": launches,
                "launches_by_path": by_path, **{k: r[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}, "instance": r.get("instance"),
                "instances": r.get("instances", {})}

    out = [entry(name, route, src, {p: runs[p]["launches"][name]
                                    for p in PATHS})
           for name, (route, src) in SOURCES.items()]
    out += [entry(name, route, src, {p: runs[p]["route_calls"][name]
                                     for p in ROUTE_PATHS})
            for name, (route, src) in ROUTE_SOURCES.items()]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--record", metavar="PATH",
                    help="write the run's full record there as JSON")
    ap.add_argument("--profile", action="store_true",
                    help="after each serve, generate, train and fused "
                         "transformer phase, run it once more under "
                         "torch.profiler and print where the device time "
                         "goes")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the train phase's weights and batch")
    ap.add_argument("--paged-decode-times", metavar="TREE",
                    help="only time the decode kernels (paged and dense) of "
                         "the checkout at TREE at the serve shape and at "
                         "batch 1 and print one JSON line (to compare "
                         "checkouts, run it for each in turns)")
    ap.add_argument("--gemm-times", metavar="TREE",
                    help="only time the GEMM kernels (K9 at the seven "
                         "linears of a 7B layer, K10 at the MoE up and down "
                         "GEMMs with fp32 and bf16 out) of the checkout at "
                         "TREE and print one JSON line (to compare "
                         "checkouts, run it for each in turns)")
    ap.add_argument("--serve-times", metavar="TREE",
                    help="only run phase 5's serves and generate with the "
                         "package of the checkout at TREE, each engine "
                         "warmed first, and print one JSON line of TTFT, "
                         "TPOT and decode tokens/s (to compare checkouts, "
                         "run it for each in turns)")
    ap.add_argument("--norm-rope-times", metavar="TREE",
                    help="only time rms_norm and fused_rope of the checkout "
                         "at TREE at the main paths' shapes (device ms and "
                         "host us per call) and print one JSON line (to "
                         "compare checkouts, run it for each in turns)")
    ap.add_argument("--flash-bwd-times", metavar="TREE",
                    help="only time the flash backward kernels and the "
                         "flash forward of the checkout at TREE at the "
                         "training shape and print one JSON line (to "
                         "compare checkouts, run it for each in turns)")
    ap.add_argument("--lora-times", action="store_true",
                    help="only run the LoRA legs (phase 4's at 2 layers, "
                         "then a plain Server and phase 5's LoRA Server "
                         "leg twice at 7B) and print one JSON line (their "
                         "spread in one process)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.paged_decode_times:
        log(json.dumps(paged_decode_times(args.paged_decode_times)))
        return 0
    if args.flash_bwd_times:
        log(json.dumps(flash_bwd_times(args.flash_bwd_times)))
        return 0
    if args.gemm_times:
        log(json.dumps(gemm_times(args.gemm_times)))
        return 0
    if args.serve_times:
        log(json.dumps(serve_times(args.serve_times)))
        return 0
    if args.norm_rope_times:
        log(json.dumps(norm_rope_times(args.norm_rope_times)))
        return 0
    if args.lora_times:
        log(json.dumps(lora_times()))
        return 0
    sys.path.insert(0, ROOT)
    import numpy as np

    from paddle_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {"phases": {}}
    t_all = time.perf_counter()

    # 1. environment
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    record.update(card=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t = time.perf_counter()
    build_s = _build.build_all()
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        lib = _build.library_path(name)
        for line in lib.with_name(lib.name + ".log").read_text().splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                log(f"  {name}: {line.strip()}")
    record["sass"] = gemm_sass(_build)
    record["sass"].update(norm_rope_sass(_build))
    for fn, c in record["sass"].items():
        log(f"  sass {fn}: {c}")
    from paddle_tpu_torch import ops
    x = torch.randn(2, 4, 8, 128, device=dev, dtype=torch.bfloat16)
    ops.rms_norm(x, torch.ones(128, device=dev, dtype=torch.bfloat16))
    ops.fused_rope(x, x[0, :, 0, :64], x[0, :, 0, 64:])
    ops.fused_layer_norm(x)
    torch.cuda.synchronize()
    record["phases"]["build"] = time.perf_counter() - t
    log(f"[build] nvcc {build_s:.2f}s, with Triton's first compile "
        f"{record['phases']['build']:.2f}s")

    # 3. kernels against their plain versions
    t = time.perf_counter()
    rows, cases = kernel_phase(torch, dev, np)
    record["kernel_cases"] = cases
    record["kernel_rows"] = rows
    record["phases"]["kernels"] = time.perf_counter() - t
    for name, r in rows.items():
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        host = (f", host {r['host_us']:.2f} us a call" if "host_us" in r
                else "")
        log(f"  {name:13s} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}){host}  [{smi}]")
        for entry, ri in r.get("instances", {}).items():
            lib = ("" if ri.get("library_ms") is None
                   else f", library {ri['library_ms']:.4f} ms")
            host = (f", host {ri['host_us']:.2f} us a call"
                    if "host_us" in ri else "")
            log(f"  {name:13s} {entry} {ri['shape']}: kernel "
                f"{ri['ms']:.4f} ms, plain {ri['plain_ms']:.4f} ms{lib}, "
                f"bound {ri['bound_ms']:.4f} ms ({ri['bound_by']}), max|err| "
                f"{ri['max_abs_err']:.3g}{host}  [{smi}]")
    ln_rb = rows["fused_layer_norm"]["residual_bias_ms"]
    log(f"  flash_fwd at the training shape: kernel "
        f"{rows['flash_fwd']['train_shape_ms']:.4f} ms, through the "
        f"head-batched route {rows['flash_hb']['ms']:.4f} ms (backward "
        f"{rows['flash_hb']['bwd_ms']:.4f} ms); fused_layer_norm "
        f"with residual and bias {ln_rb:.4f} ms  [{smi}]")
    for name, part in (("grad_add", "per_linear"),
                       ("grouped_matmul", "per_gemm")):
        for what, r in rows[name][part].items():
            lib = ("null" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            log(f"  {name} {what}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {lib} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})  [{smi}]")
        log(f"  {name} library: {rows[name]['library']}")
    r = rows["grouped_matmul"]["instances"]["bf16_out"]
    log(f"  grouped_matmul up+down with bf16 out: kernel {r['ms']:.4f} ms, "
        f"library {r['library_ms']} ms (bf16 out), bound "
        f"{r['bound_ms']:.4f} ms  [{smi}]")
    log(f"[kernels] {record['phases']['kernels']:.1f}s")
    # 4. kernel path against plain path, end to end
    t = time.perf_counter()
    record["e2e"] = e2e_phase(torch, dev, np)
    log(f"[e2e] serve {json.dumps(record['e2e'])}")
    record["fmt_e2e"] = fmt_e2e_phase(torch, dev)
    log(f"[e2e] fused transformer {json.dumps(record['fmt_e2e'])}")
    record["train_e2e"] = train_e2e_phase(torch, dev, np)
    log(f"[e2e] train {json.dumps(record['train_e2e'])}")
    dr = record["train_e2e"]["drift"]
    log(f"[e2e] C-check-1: {dr['steps']} steps of 2 layers, loss gap mean "
        f"{dr['gap_mean_first10']:.5f} over the first 10 and "
        f"{dr['gap_mean_last10']:.5f} over the last 10, grows: "
        f"{dr['grows']}  [{smi}]")
    record["eager_e2e"] = eager_e2e_phase(torch, dev, np)
    ee = record["eager_e2e"]
    log(f"[e2e] eager twin at {ee['layers']} layers, {ee['batch']} x "
        f"{ee['seq']}: Model.fit step loss {ee['fit']['loss_card']:.5f} on "
        f"the card, {ee['fit']['loss_cpu']:.5f} on the CPU, parameters within "
        f"{ee['fit']['param_max_abs_err']:.3g}; fp16 O2 GradScaler step (1 x "
        f"{ee['fp16_seq']}) loss "
        f"{ee['fp16_o2']['card']['loss']:.5f} / "
        f"{ee['fp16_o2']['cpu']['loss']:.5f}, scales "
        f"{ee['fp16_o2']['card']['scales']} on both, the injected inf "
        f"skipped on both  [{smi}]")
    record["f32"] = f32_phase(torch, dev, np)
    record["phases"]["e2e"] = time.perf_counter() - t
    log(f"[e2e] fp32 {json.dumps(record['f32'])}")
    log(f"[e2e] {record['phases']['e2e']:.1f}s")
    # 5. serve the 7B preset
    t = time.perf_counter()
    (sv, sq, gn, ds, sc, ss, sr, *spec_recs, sl,
     sp, sx) = serve_phase(torch, dev, np, profile=args.profile)
    spec_runs = dict(zip(SPEC_PATHS, spec_recs))
    record.update(serve=sv, serve_int8=sq, generate=gn, dense_serve=ds,
                  serve_chunked=sc, serve_sampled=ss, server=sr,
                  serve_prefix=sp, server_pressure=sx, server_lora=sl,
                  **spec_runs)
    record["phases"]["serve"] = time.perf_counter() - t
    for what, r in (("paged", sv), ("paged int8-pool", sq), ("dense", ds),
                    ("paged chunked (gap loop)", sc),
                    ("paged chunked, sampled (gap loop)", ss)):
        log(f"[serve] {PRESET} x{sv['layers']} bf16, {what} engine: TTFT p50 "
            f"{r['ttft_p50_s'] * 1e3:.1f} ms (max "
            f"{r['ttft_max_s'] * 1e3:.1f}), TPOT p50 "
            f"{r['tpot_p50_s'] * 1e3:.2f} ms, decode "
            f"{r['decode_tokens_per_s']:.1f} tok/s  [{smi}]")
    log(f"[serve] pools: bf16 {sv['pool_gb']:.3f} GB, int8 "
        f"{sq['pool_gb']:.3f} GB (scales included); int8 streams part from "
        f"the bf16 ones at tokens {sq['first_split_from_bf16']} (of 32), "
        f"top-2 margins there {sq['split_top2_margins']}")
    log(f"[serve] chunked streams part from the one-shot ones at tokens "
        f"{sc['first_split_from_one_shot']} (of 32), top-2 margins there "
        f"{sc['split_top2_margins']}; {sc['chunks']} chunks; sampled TPOT "
        f"p50 {ss['tpot_p50_over_greedy']:.3f}x the greedy one")
    log(f"[serve] Server over the chunked engine, {sr['clients']} client "
        f"threads: TTFT p50 {sr['ttft_p50_s'] * 1e3:.1f} ms (max "
        f"{sr['ttft_max_s'] * 1e3:.1f}; gap loop "
        f"{sr['gap_ttft_p50_s'] * 1e3:.1f}), TPOT p50 "
        f"{sr['tpot_p50_s'] * 1e3:.2f} ms (gap loop "
        f"{sr['gap_tpot_p50_s'] * 1e3:.2f}), decode "
        f"{sr['decode_tokens_per_s']:.1f} tok/s, warmup "
        f"{sr['warmup_s']:.2f} s, captures after warmup 0; streams part "
        f"from the gap loop's at {sr['first_split_from_gap']} (of 32), "
        f"top-2 margins {sr['split_top2_margins']}  [{smi}]")
    for r in spec_recs:
        log(f"[serve] {r['server']}, {r['drafts']} drafts, "
            f"{sr['clients']} client threads: TTFT "
            f"p50 {r['ttft_p50_s'] * 1e3:.1f} ms (plain Server "
            f"{r['plain_ttft_p50_s'] * 1e3:.1f}), TPOT p50 "
            f"{r['tpot_p50_s'] * 1e3:.2f} ms (plain "
            f"{r['plain_tpot_p50_s'] * 1e3:.2f}), decode "
            f"{r['decode_tokens_per_s']:.1f} tok/s, tokens per forward "
            f"{r['tokens_per_forward']:.3f}, accepted share "
            f"{r['accepted_share']:.3f}, verify steps {r['verify_steps']}, "
            f"K4 launches a verify step {r['k4_launches_per_verify']:.0f}; "
            f"streams part from the plain Server's at "
            f"{r['first_split_from_plain']} (of 32), top-2 margins "
            f"{r['split_top2_margins']}  [{smi}]")
    lo = sl["lora_ops"]
    log(f"[serve] LoRA Server ({sl['engine']}; bank {sl['bank_mb']:.1f} MB), "
        f"{sl['clients']} client threads, adapters {sl['adapters']}: TTFT "
        f"p50 {sl['ttft_p50_s'] * 1e3:.1f} ms (plain Server "
        f"{sl['plain_ttft_p50_s'] * 1e3:.1f}), TPOT p50 "
        f"{sl['tpot_p50_s'] * 1e3:.2f} ms (plain "
        f"{sl['plain_tpot_p50_s'] * 1e3:.2f}; base traffic only on the LoRA "
        f"engine {sl['base_only']['tpot_p50_s'] * 1e3:.2f}), decode "
        f"{sl['decode_tokens_per_s']:.1f} tok/s (plain "
        f"{sl['plain_decode_tokens_per_s']:.1f}); hot load "
        f"{sl['admin']['hot_load_s'] * 1e3:.1f} ms (in the gap "
        f"{sl['admin']['install_in_gap_s'] * 1e3:.1f}), unload in use "
        f"deferred: "
        f"{sl['admin']['unload_a0'] is False}; captures after warmup 0; "
        f"solo streams part from the mixed ones at "
        f"{sl['solo_first_split']} (of 32), top-2 margins "
        f"{sl['solo_split_top2_margins']}  [{smi}]")
    log("[serve] LoRA Server, ms a decode step in the segments / in the "
        "gaps: " + ", ".join(
            f"{leg} {v['segment_ms']:.3f} / {v['gap_ms']:.3f} "
            f"({v['decode_steps']} steps)"
            for leg, v in sl["step_split"].items()) + f"  [{smi}]")
    log(f"[serve] LoRA ops of one decode step ({lo['layers']} layers x "
        f"{len(lo['targets'])} targets, batch {lo['batch']}, rank "
        f"{lo['rank']}): {lo['graph_ms_per_step']:.4f} ms graphed "
        f"({lo['share_of_base_tpot']:.1%} of the base-only TPOT), "
        f"{lo['ops_per_step']} ops launched "
        f"({lo['kernels_per_step_profiled']:.2f} kernels recorded by the "
        f"profiler a step over {lo['profiled_steps']}), "
        f"{lo['device_ms_per_step_eager']:.4f} ms of kernels eager"
        f"{' (a lower bound)' if lo['eager_ms_is_lower_bound'] else ''}, "
        f"bound {lo['bound_ms']:.4f} ms ({lo['bound_by']})  [{smi}]")
    le = record["e2e"]["lora"]
    mo = le["merged_oracle"]
    log(f"[serve] LoRA at 2 layers: merged-weights oracle in fp32 within "
        f"{mo['max_abs_err']:.3g} of the limit {mo['atol']} (faulty merges "
        f"read {mo['faults']}; LoRA moved the logits by "
        f"{mo['lora_moved_logits_by']:.3g}); card "
        f"against CPU, tokens matched: "
        f"{ {k: le[k]['tokens_matched_cpu'] for k in ('paged', 'paged_int8', 'dense')} }"
        f"; spec with oracle drafts, tokens a forward host "
        f"{le['spec_host_oracle']['tokens_per_forward']:.2f}, device "
        f"{le['spec_device_oracle']['tokens_per_forward']:.2f}  [{smi}]")
    hr, fr = sr["http"], sr["fault"]
    log(f"[serve] Server HTTP: /generate streamed == unstreamed (16 tokens), "
        f"/healthz ok, /metrics and /stats served; a second warmup "
        f"re-captured {hr['captures_grew']} in {hr['rewarm_s']:.2f} s "
        f"beside {hr['scrapes_during_rewarm']} /metrics scrapes")
    log(f"[serve] Server fault leg: restarts {fr['restarts']}, faults "
        f"{fr['faults']}, recovery {fr['recovery_s']} s, replays "
        f"{fr['replays']}; streams part from the fault-free serve's at "
        f"{fr['first_split_from_serve']} (of 32), top-2 margins "
        f"{fr['split_top2_margins']}  [{smi}]")
    for i, r in enumerate(sp["rounds"]):
        log(f"[serve] prefix leg round {i + 1} (prefix_cache=True, "
            f"{sp['prefix']}-token shared prefix): TTFT p50 "
            f"{r['ttft_p50_s'] * 1e3:.1f} ms (prefix off "
            f"{r['prefix_off_ttft_p50_s'] * 1e3:.1f}), TPOT p50 "
            f"{r['tpot_p50_s'] * 1e3:.2f} ms (prefix off "
            f"{r['prefix_off_tpot_p50_s'] * 1e3:.2f}), counters "
            f"{r['counters']}; streams part from the prefix-off ones at "
            f"{r['first_split_from_prefix_off']} (of 32), top-2 margins "
            f"{r['split_top2_margins']}  [{smi}]")
    log(f"[serve] pressure leg: pool {sx['pool_pages']} pages (tries "
        f"{sx['tries']}), preemptions {sx['preemptions']} (per request "
        f"{sx['handle_preempts']}), TTFT p50 {sx['ttft_p50_s'] * 1e3:.1f} "
        f"ms, TPOT p50 {sx['tpot_p50_s'] * 1e3:.2f} ms, decode "
        f"{sx['decode_tokens_per_s']:.1f} tok/s; streams part from the "
        f"reserved engine's at {sx['first_split_from_reserved']} (of "
        f"{sx['max_new_tokens']}), top-2 margins "
        f"{sx['split_top2_margins']}  [{smi}]")
    log(f"[serve] dense streams part from the paged ones at tokens "
        f"{ds['first_split_from_paged']} (of 32), where the top-2 logit "
        f"margins are {ds['split_top2_margins']}; peak "
        f"{sv['peak_mem_gb']:.1f} GiB")
    log(f"[serve] {PRESET} generate {gn['batch']} x {gn['prompt_len']} + "
        f"{gn['max_new_tokens']}: TTFT {gn['ttft_s'] * 1e3:.1f} ms, TPOT "
        f"{gn['tpot_s'] * 1e3:.2f} ms, decode "
        f"{gn['decode_tokens_per_s']:.1f} tok/s, peak "
        f"{gn['peak_mem_gb']:.1f} GiB  [{smi}]")
    log(f"[serve] {record['phases']['serve']:.1f}s")
    # 6. train the 350m configuration
    t = time.perf_counter()
    tr = train_phase(torch, dev, np, args.seed, profile=args.profile)
    record["train"] = tr
    record["phases"]["train"] = time.perf_counter() - t
    log(f"[train] {tr['config']} x{tr['layers']}, {tr['batch']}x{tr['seq']}"
        f" tokens, {tr['params']} params: step {tr['step_s_median']:.4f} s "
        f"(steps {tr['step_s']}), {tr['tokens_per_s']:.1f} tokens/s, MFU "
        f"{tr['mfu']:.4f} (6 N tokens; {tr['mfu_with_attention']:.4f} with "
        f"{tr['attention_flops_model']:.4g} attention FLOPs), peak "
        f"{tr['peak_mem_gb']:.2f} GiB, losses {tr['losses']}  [{smi}]")
    log(f"[train] {record['phases']['train']:.1f}s")
    # 6b. the eager training surface at the training configuration
    t = time.perf_counter()
    eg = eager_train_phase(torch, dev, np, args.seed, profile=args.profile)
    record["eager"] = eg
    record["phases"]["eager"] = time.perf_counter() - t
    rs, mx = eg["resume"], eg["mix_precision"]
    log(f"[eager] Model.fit {eg['config']} x{eg['layers']}, {eg['batch']}x"
        f"{eg['seq']} tokens (AdamW, LinearWarmup, global-norm clip): step "
        f"{eg['step_s_median']:.4f} s (steps {eg['step_s']}), "
        f"{eg['tokens_per_s']:.1f} tokens/s, peak {eg['peak_mem_gb']:.2f} GiB"
        f"; phase 6's functional step {tr['step_s_median']:.4f} s, "
        f"{tr['tokens_per_s']:.1f} tokens/s, peak {tr['peak_mem_gb']:.2f} "
        f"GiB; optimizer step {eg['optimizer_step_ms']:.2f} ms (host "
        f"{eg['optimizer_step_host_ms']:.2f} ms); losses {eg['losses']}"
        f"  [{smi}]")
    if "profile" in eg:
        log(f"[eager] device busy {eg['profile']['device_busy_share']:.1%} "
            f"of a train_batch's wall time  [{smi}]")
    log(f"[eager] resume after step {EAGER['save_after']} "
        f"({rs['checkpoint_gb']:.2f} GiB, {rs['s']:.1f} s): the next step "
        f"bitwise the uninterrupted one's: {rs['bitwise']}"
        + ("" if rs["bitwise"] else f" ({rs['cause']})"))
    log(f"[eager] MixPrecisionOptimizer: {mx['steps']} steps, losses "
        f"{mx['losses']['mixed']} against plain AdamW's "
        f"{mx['losses']['plain']}, fp32 masters {mx['masters_gb']:.2f} GiB")
    for pol, r in eg["remat"].items():
        log(f"[eager] remat={pol!r}: step {r['step_s']:.4f} s, peak "
            f"{r['peak_mem_gb']:.2f} GiB, flash forwards "
            f"{r['launches']['flash_fwd']}, bitwise full's: "
            f"{r.get('bitwise', True)}  [{smi}]")
    log(f"[eager] {record['phases']['eager']:.1f}s")
    # 7. the fused transformer at the 6.7B widths
    t = time.perf_counter()
    fm = fmt_phase(torch, dev, profile=args.profile)
    record["fmt"] = fm
    record["phases"]["fmt"] = time.perf_counter() - t
    log(f"[fmt] {fm['config']}, batch {fm['batch']}: context pass of "
        f"{fm['context']} tokens {fm['context_ms']:.1f} ms, decode step "
        f"{fm['decode_step_ms_median']:.2f} ms (median of "
        f"{fm['decode_steps']}), {fm['decode_tokens_per_s']:.1f} tok/s, "
        f"peak {fm['peak_mem_gb']:.1f} GiB  [{smi}]")
    log(f"[fmt] {record['phases']['fmt']:.1f}s")
    log(f"[train] with FLAGS_flash_head_batched: step {tr['hb_step_s']:.4f} s"
        f", loss {tr['hb_loss']}, route calls {tr['hb_route_calls']}  "
        f"[{smi}]")
    # 8. the kernel ops at full widths: this slice's main path
    t = time.perf_counter()
    op = ops_phase(torch, dev, np)
    record["ops"] = op
    record["phases"]["ops"] = time.perf_counter() - t
    log(f"[ops] {op['linears']} main gradients of T={op['tokens']} "
        f"{op['grad_add_s'] * 1e3:.1f} ms, MoE FFN of {op['moe_rows']} rows "
        f"{op['moe_s'] * 1e3:.1f} ms, stock decode of {op['decode_layers']} "
        f"layers {op['stock_decode_s'] * 1e3:.1f} ms, head-batched attention "
        f"fwd+bwd {op['attention_s'] * 1e3:.1f} ms (host clock); max errors "
        f"{op['max_abs_err']}  [{smi}]")
    log(f"[ops] {record['phases']['ops']:.1f}s")
    record["total_s"] = time.perf_counter() - t_all

    runs = dict(serve=sv, serve_int8=sq, generate=gn, dense_serve=ds,
                serve_chunked=sc, serve_sampled=ss, server=sr,
                serve_prefix=sp, server_pressure=sx, **spec_runs,
                server_lora=sl, train=tr, fmt=fm,
                ops=op, train_hb=dict(launches=tr["hb_launches"],
                                      route_calls=tr["hb_route_calls"]),
                f32=record["f32"], eager_fit=eg)
    kernels = kernel_entries(rows, runs)
    record["kernels"] = kernels
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=1, default=str)
    log(f"total {record['total_s']:.1f}s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
