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
   PyTorch call computes the same function; and each kernel row's FLOPs
   and bytes as its wrapper reports them to the program ledger
   (``ops/_launches.py``) beside the counts its bound uses, on the same
   calls, failing where they differ;
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
   plain LoRA streams, launches the path's); the replica fleet at 2 layers
   (FLEET_E2E: the KV-page handoff with bf16 and int8 pools, exported on
   the card, framed and imported on the card and on the CPU with the
   rows and scales byte for byte the exported ones, a re-ship deduped,
   a flipped byte answered 400 naming its block with nothing installed,
   an import past the pages the pool can reclaim leaving each indexed
   page its own block's rows, the decode engine's continuation against
   the colocated stream; a two-replica ``Router`` with one replica killed
   mid-stream against a ``Server``; in fp32, ``DisaggregatedFront`` over
   two ``Server`` replicas behind ``serve_http`` against a monolithic
   ``Server``, token for token up to a near-tie of F32_NEAR_TIE);
   the program ledger at 2 layers (LEDGER_E2E: the reference's
   mixed-feature ledger traffic, chunked prefill, a prefix hit,
   speculative decoding, int8 pools and LoRA, through a ``Server`` with
   the ledger on, on the card and then on the CPU: the same streams, the
   same programs with the same dispatches and FLOPs on both, every
   program counted, compiled, its dispatch counter equal to its record;
   then one decode-segment replay with the ledger on under
   ``torch.cuda.set_sync_debug_mode("error")``);
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
   (batch 1 x 32), then its scaled gradients again with an inf
   injected: the loss within tolerance, the scales [1024, 512] and the
   step skipped on both sides; C-check-1: 20 AdamW steps of
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
   timed, their kernels counted; and this slice's path, the
   ``server_ledger`` leg (after the ``Server`` legs, on their engine with
   its graphs dropped): the program ledger and the monitor on before a
   fresh ``Server(segment_steps=8, warmup=True)``, the 8 prompts from 8
   client threads, 32 greedy tokens each: the streams those of the plain
   ``server`` leg token for token, launches the path's, every program
   counted (FLOPs above 0 but for the data-movement programs, bytes),
   compiled and its dispatch counter equal to its record, its MFU at most
   1.0 and its bandwidth utilization at most 1.05, the decode segments'
   seconds 0.5-1.0x the engine's own segment time; the ``/profile`` body
   over ``serve_http`` printed through ``tools/monitor_report.py
   --profile``, TPOT beside the plain leg's.
   Each engine is built, then
   ``warmup()``-ed (``warmup(8)``: greedy and sampled segments;
   ``generate``'s engine ``warmup(batch=8)``: greedy and sampled steps),
   then runs: its decode programs replay captured CUDA graphs, the capture
   count must not move over the run, and every kernel's launch count over
   it (each replay credited with the launches
   its graph holds) is held against the count the path implies; the
   captures, their seconds and their pools' bytes are recorded;
5b. the replica fleet at the ``"7b"`` preset
   (FLEET: phase 5's chunked engine with ``prefix_cache=True`` behind
   ``Server(segment_steps=8, warmup=True)``): first the ``disagg`` leg,
   two ``python -m paddle_tpu_torch.serving.remote`` processes on the card
   behind ``DisaggregatedFront`` (the prompts under 512 tokens from client
   threads, each replica's kernel launches over that wave read from its
   ``paddle_tpu_kernel_launches`` series and held against the kernels its
   side must run; then fresh prompts of those lengths one at a time
   through the replicas' public calls, per handoff its bytes, /kv/export
   and /kv/import round trips and the decode side's TTFT beside the cold
   prefill's; the 600-token prompt, over the reference's 256 MiB import
   cap, ending FAILED with the 413 while both replicas serve on; a decode
   process killed mid-stream, the request replayed on the prefill
   replica); then the ``fleet`` leg, a single ``Server`` (the
   reference streams and latencies, each short prompt continued over its
   own pages, the handoff timed in process) and a ``Router`` of 2
   replicas, replica 0 killed mid-stream, waves of the 8 prompts while
   the supervisor rebuilds it, a wave under ``rolling_restart`` (zero
   failed): TTFT, TPOT, failovers, recovery and rebuild seconds, peak
   memory, launches over the routed traffic; the waves' streams against
   the single ``Server``'s and the front's against its continuation,
   token for token up to a split at a top-2 margin under NEAR_TIE; the
   front's against the single ``Server``'s own streams up to a split
   where the same weights in fp32 separate the two tokens by less than
   NEAR_TIE (the bf16 and fp32 margins there recorded); the replica
   processes run with ``FLAGS_enable_ledger=1`` and serve non-empty
   ``/profile`` shards; after the rolling restart one more wave with the
   program ledger on, ``Router.profile()`` against ``merge_profiles`` over
   the live replicas' ``Server.profile()`` shards;
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
   outputs finite and held against the plain versions;
9. the tensor surface on the card, this slice's main path, on the default
   place (``set_device`` untouched): every op of the seven ops modules but
   the random ones on CUDA tensors against the same op on CPU copies
   (elementwise ops, reductions and manipulation at [64, 257], sort, search
   and top-k over [8, 32000] fp32 logits, linalg at 256 x 256 and a batch
   of 64 of 32 x 32 with a rank-deficient ``lstsq``; the factors held by
   reconstruction; the gradient sweep's names by their gradients too;
   every output on cuda:0); every random op twice after ``seed``, bitwise
   equal, its moments at 2^24 draws within bounds and torch's generators
   untouched; a ``PyLayer`` with a hand-written backward against the plain
   function's gradient; the ``paddle.device`` CUDA calls; a Llama-2-7B
   decoder layer (bf16, [1, 512] tokens, weights from ``--seed``) written
   with the tensor API against the port's own layer (K1, K2 and K3
   forward, K5 and K6 backward, launches counted), each held against the
   tensor-API layer in fp32: the output's and the input gradient's error
   of the tensor-API route at most twice the kernel route's plus one bf16
   step; both routes' times printed beside each other;
10. ``paddle.nn`` and ``paddle.io`` on the card, this slice's main path:
   every function of ``nn.functional``'s activation, common, norm,
   extension and attention modules and every layer of the activation,
   common, norm and container modules on cuda:0 against its CPU twin
   (the layer's weights carried by ``set_state_dict``), fp32 and bf16,
   forward and gradients; dropout's mask repeated after ``seed``; phase
   9's 7B decoder layer written with ``paddle.nn`` (``Linear`` without
   bias, ``RMSNorm``, ``F.flash_attention(causal=True)``, ``F.silu``; RoPE
   through the tensor ops), phase 9's weights carried in by
   ``set_state_dict``, forward and backward: its error against phase 9's
   fp32 yardstick at most twice the kernel route's plus one bf16 step, its
   K1, K3, K5 and K6 launches counted, its time beside phase 9's routes';
   ``Model.fit`` at phase 6b's configuration over an ``io.TensorDataset``
   of 3 seeded batches through ``io.DataLoader``, its losses bitwise those
   of ``fit`` over the same batches as a list, and the loader with two
   worker processes giving the same batches in order;
11. the GPT and ERNIE-MoE families, this slice's main path: GPT-3 1.3B
   (``gpt_config("1b3")``: hidden 2048, 24 layers, 16 heads of 128, FFN
   8192, vocab 50304; bf16, full recompute) at batch 8 x 2048 and
   ERNIE-MoE base (``ernie_moe_config("base")``: hidden 768, 12 layers, 12
   heads of 64, 8 experts top-2 on every 2nd layer, vocab 40000; bf16) at
   16 x 512 with 15% of the positions labelled, at full depth and width,
   random weights and one batch from ``--seed``, each trained by
   ``loss.backward(); opt.step(); opt.clear_grad()`` with the paddle-style
   ``AdamW`` (lr 1e-4, weight decay 0.01, global-norm clip 1.0): a warm-up
   step and 3 timed ones (step time, tokens/s, MFU, peak memory; ERNIE's
   aux loss, each MoE layer's per-expert load, the share dropped by
   capacity and the dispatch mode), K3/K5/K6 launches held exact (GPT:
   K3 twice and K5, K6 once a layer; ERNIE: each once a layer, non-causal
   at head dim 64); both cut to 2 layers (1 x 512, 2 x 128) on the card
   and on the CPU from the same weights, GShard's random routing off: loss
   and every gradient within phase 4's training tolerances, the GShard
   choices equal up to near-ties (GATE_NEAR_TIE), where the CPU follows the
   card's; and the incubate leg: ``fused_rms_norm`` (K1),
   ``fused_rotary_position_embedding`` (K2) and
   ``memory_efficient_attention`` (K3 non-causal, K5/K6) on cuda:0
   against their CPU twins, forward and backward, within their kernels'
   tolerances, launches counted;
12. the rest of ``paddle.nn`` and ``vision.models``, this slice's main
   path: ResNet-50 v1.5 (1000 classes) trained through ``Model.fit`` at
   256 x 3 x 224 x 224 over a seeded ``io.TensorDataset`` (Momentum 0.1 /
   0.9, ``L2Decay(1e-4)``, ``auto_cast`` O1 bf16; a warm-up step and 3
   timed ones: images/s, step time, peak memory, MFU from the
   convolutions' and the linear's FLOPs), then 3 steps on a batch already
   on the card; every model function of ``resnet.py`` and ``classic.py``
   forward and backward at 2 x 3 x 224 x 224 on the card against its CPU twin in
   fp32 (TF32 convolutions, VISION_TF32_RTOL and VISION_TF32_JOINT);
   ResNet-50 at 2 x 3 x 64 x
   64, one Momentum step on the card (twice) and on the CPU, with TF32 and
   without (loss, every gradient, every batch norm's running statistics),
   and an fp32 ResNet-50 step timed with TF32 on and off;
   ``nn.Transformer`` at the base widths (512, 8 heads, 6 + 6 layers, FFN
   2048, a 37,000-token vocabulary) trained with AdamW under O1 bf16 at 32
   x 128 source and target tokens (tokens/s), greedy decoding of 32 tokens
   through ``Cache`` / ``StaticCache`` held against full decoder passes,
   and a 2-layer fp32 twin against the CPU; ``nn.LSTM`` and ``nn.GRU``
   (512 -> 1024, 2 layers, both ways) at 64 x 128 ragged steps, forward and
   backward in fp32 and bf16 (ms per step), the fp32 LSTM against the CPU,
   ``BeamSearchDecoder`` over an ``LSTMCell`` (beam 4, 32 steps) equal on
   the card and the CPU; and the sweep of every function and layer of the
   convolution, pooling, sequence-loss, recurrent and transformer modules
   on cuda:0 against its CPU twin, fp32 and bf16. These paths launch no
   kernel of the port;
13. the rest of ``paddle.vision``, ``summary`` / ``flops`` and
   ``paddle.text``, this slice's main path: every model function of
   ``classic2.py`` (DenseNet, GoogLeNet, InceptionV3 at 299, MobileNetV3,
   ShuffleNetV2) in eval mode, fp32, forward and backward at 2 x 3 x 224
   x 224 on the card against its CPU twin (the logits by the tests'
   ``near()`` against the CPU twin in fp64, the gradients jointly); one
   model of each family trained for 3 timed steps at batch 64 under O1
   bf16; ``summary`` and ``flops`` of ResNet-50 and MobileNetV3-Large on
   the card equal to the CPU's; MobileNetV3-Large trained through
   ``Model.fit`` over a ``DatasetFolder`` of 1024 seeded ``.npy`` images
   with the ImageNet train transforms and ``DataLoader(num_workers=8)``
   (images/s, the loader's wait a batch, then steps on a batch already on
   the card); the detection operators at published detectors' widths
   (Faster R-CNN's RPN proposals, the R50-C4 RoIAlign / RoIPool /
   PSRoIPool head, FPN's level assignment, YOLOv3's three heads with
   ``yolo_box``, ``yolo_loss``, ``matrix_nms`` and ``nms``, DCNv2 at
   ResNet-50's stage 5, SSD300's priors and box coding), each against its
   CPU twin, forward and backward, with device and host milliseconds; and
   ``viterbi_decode`` at a CoNLL-2003 tagger's shape, bitwise the CPU's.
   These paths launch no kernel of the port either; the kernels line counts
   the earlier paths.
14. ``jit``, the deploy path and incubate's rest, this slice's main path,
   on the training configuration (350m/h128, 24 layers, bf16) built once:
   the Layer-API step (loss, backward, AdamW) eagerly and through
   ``jit.to_static`` (inductor) from the same weights over the same
   batches (a warm-up step and 3 timed ones each): step time, tokens/s,
   MFU, peak memory, compile seconds, one graph, no graph break, no
   recompile after the warm-up, the compiled step's launches equal to the
   eager step's, its losses and parameters within the stated limits of
   the eager ones, and both steps under the profiler; ``jit.save`` with a
   ``[None, None]`` int64 spec (a ``.pt2`` holding no tensor beside the
   weights' ``.pdiparams``), ``create_predictor`` and ``run`` at 1 x 512 and
   8 x 2048 from one program whose graph holds K1, K2 and K3 as
   ``paddle_tpu::`` nodes, their launches counted and the logits held
   against the eager forward; ``Model.save(training=False)`` and
   ``onnx.export`` round trips of a 2-layer twin and ``inference.aot`` of
   one decoder layer; ``asp.prune_model`` (2:4) over the decoder's linears
   through 2 ``asp.decorate(DistributedFusedLamb)`` steps, every mask
   holding; ``DistributedFusedLamb`` against ``Lamb`` on the same
   gradients; ``send_u_recv`` and the segment ops at ogbn-arxiv's size,
   forward and backward, against their CPU twins; ``graph_khop_sampler``
   with GraphSAGE's fanouts; the fused softmaxes at GPT-3 1.3B's scores;
   ``incubate.autograd`` at width 1024 and ``LookAhead`` / ``ModelAverage``
   against the CPU.

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
their readings and their spread in one process. ``--jit-deploy`` builds
the kernels and runs only phase 14, printing its lines and its record as
one JSON line.
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
# step at 512 tokens took 118 s of CPU time), so the fp16 step takes 32
# tokens of each row (the scaler's checks need no longer a row); the bf16
# step keeps TRAIN_E2E's 512
EAGER_E2E = dict(scale=1024.0, fp16_seq=32)
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
# the KV-page handoff and the router at 2 layers (phase 4): the prompts of
# phase 4's engines, 8 new tokens
FLEET_E2E = dict(prompts=(100, 37), new=8)
# the replica fleet at full depth (phase 5): phase 5's chunked engine with
# the prefix cache, 32 new tokens; replica 0 killed once a request of its
# has streamed kill_after tokens; handoffs of prompts under handoff_max
# tokens (the reference's 256 MiB /kv/import cap holds 31 full 7B blocks)
# phase 4's ledger leg at 2 layers: the reference's mixed-feature traffic
# (tests/test_ledger.py) with its page geometry scaled to pages of 16
LEDGER_E2E = dict(page=16, pages=64, max_pages=16, new=6)
FLEET = dict(new=32, kill_after=4, segment_steps=8, handoff_max=512,
             engine=dict(max_batch=8, num_pages=512, page_size=16,
                         max_pages=64, prefill_chunk=256))
REPLICA_DEVICE = "cuda"         # the device the replica processes serve on
SCRAPE_PAUSE_S = 0.01
# C-check-1 (phase 4): train steps of the 2-layer bf16 model, card and CPU
# (the CPU side about 2.7 s a step on the card's host); 20 keeps the first
# and the last 10 steps, which the check compares, apart
DRIFT_STEPS = 20
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
                                             "eager_fit", "fleet", "disagg",
                                             "server_ledger",
                                             "tensor_surface", "nn", "gpt",
                                             "ernie", "incubate", "resnet",
                                             "vision", "transformer", "rnn",
                                             "classic2", "pipeline",
                                             "detection", "text",
                                             "to_static", "deploy",
                                             "incubate_rest")
# this slice's paths: phase 14's compiled to_static steps (K1, K2, K3, K5
# and K6 as paddle_tpu:: library ops inside the inductor program, over the
# timed steps), the Predictor's runs of the exported program (K1, K2, K3)
# and the asp-decorated DistributedFusedLamb steps (eager: K1-K3, K5, K6)
SLICE_PATHS = ("to_static", "deploy", "incubate_rest")
# earlier slices' paths, in the order their counts stand in for a kernel
# this slice does not run: phase 13's classic2 models, the input pipeline,
# the detection operators and Viterbi decoding, and phase 12's ResNet-50,
# vision, transformer and RNN legs (no kernel of the port: torch ops and
# host numpy, as the reference's are XLA ops and numpy); phase 11's GPT-3 1.3B training steps (K3 causal
# at head dim 128 twice a layer under full recompute, K5 and K6 once), the
# ERNIE-MoE base steps and the incubate leg (K1, K2, K3, K5, K6); phase 9's
# comparison route and phase 10's nn
# route (K1, K2); the Server serve with the program ledger on,
# the replica fleet's routed traffic and the
# disaggregated front's wave, the LoRA Server's serve, the decode paths,
# which run K4 and K7 (phase 5's through captured graphs), the chunked and
# sampled serves, the serving
# front's Server serve, the prefix-cache and memory-pressure legs, the
# speculative Server serves and FMT (K8); then training, the eager
# Model.fit steps among it (K5, K6); then the kernel ops (K9, K10)
EARLIER_PATHS = (("classic2", "pipeline", "detection", "text", "resnet",
                  "vision", "transformer", "rnn"),
                 ("gpt", "ernie", "incubate"), ("tensor_surface", "nn"),
                 ("server_ledger", "fleet", "disagg", "server_lora", "serve",
                  "serve_int8",
                  "generate", "dense_serve", "serve_chunked",
                  "serve_sampled", "server", "serve_prefix",
                  "server_pressure") + SPEC_PATHS
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


COST_CHECKS = {}   # kernel -> the wrapper's reported and the bound's counts


def cost_check(torch, name, fn, nbytes, flops) -> None:
    """The kernel wrapper's reported cost (``ops/_launches.py``, what the
    program ledger adds up) against the counts phase 3's bound uses, on the
    same call: ``fn()`` once under a cost tally; raises unless the FLOPs
    and bytes agree; both are added up under ``name`` for the row."""
    from paddle_tpu_torch.ops import _launches

    with _launches.cost_tally() as tally:
        fn()
    torch.cuda.synchronize()
    got, want = (tally.flops, tally.bytes), (int(flops), int(nbytes))
    if got != want:
        raise AssertionError(
            f"{name}: the wrapper reports {got[0]} FLOPs and {got[1]} "
            f"bytes, the bound counts {want[0]} and {want[1]}")
    rec = COST_CHECKS.setdefault(name, {"reported": [0, 0],
                                        "counted": [0, 0]})
    for i in (0, 1):
        rec["reported"][i] += got[i]
        rec["counted"][i] += want[i]


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
        cost_check(torch, "flash_fwd", lambda: ops.flash_attention_bshd(
            q, k, v, causal=True), nbytes, flops)
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
            cost_check(torch, "paged_decode", lambda: ops.paged_decode_mha(
                q, kp, vp, table, lens), nbytes, 4 * D * tokens * NH)
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
    for name in SOURCES:
        if name not in COST_CHECKS:
            raise AssertionError(f"{name}: no cost check in phase 3")
        rows[name]["cost_check"] = COST_CHECKS[name]
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
                if dt == bf:
                    cost_check(torch, "flash_fwd_prefix",
                               lambda: ops.prefix_chunk_attention(
                                   qc, kc, vc, at), nbytes, flops)
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


def rms_counts(x, w):
    """K1's (bytes, operations) on x and w."""
    t = x.numel()
    return 2 * t * x.element_size() + w.numel() * w.element_size(), 4 * t


def rope_counts(x, c):
    """K2's (bytes, operations) on x and a table c."""
    return (2 * x.numel() * x.element_size()
            + 2 * c.numel() * c.element_size(), 3 * x.numel())


def rms_bound(x, w):
    return bound(*rms_counts(x, w), FP32_FLOPS)


def rope_bound(x, c):
    return bound(*rope_counts(x, c), FP32_FLOPS)


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
        if timed == "prefill":
            cost_check(torch, "rms_norm", lambda: ops.rms_norm(x, w, 1e-5),
                       *rms_counts(x, w))
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
        if timed == "prefill":
            cost_check(torch, "fused_rope", lambda: ops.fused_rope(x, c, sn),
                       *rope_counts(x, c))
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
        cost_check(torch, "decode_mha", lambda: ops.decode_mha(
            q, k, v, lens), nbytes, 4 * D * tokens * NH)
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
            cost_check(torch, "fused_layer_norm",
                       lambda: ops.fused_layer_norm(*args),
                       2 * x.numel() * 2 + 2 * h * 2, 8 * x.numel())
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
        for _ in range(count):
            cost_check(torch, "grad_add",
                       lambda: ops.fused_linear_param_grad_add(x, dy, dw),
                       (t * k + t * n) * 2 + 2 * k * n * 4, 2 * t * k * n)
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
        cost_check(torch, "grouped_matmul",
                   lambda: ops.grouped_matmul(lhs, rhs, sizes),
                   m * k * 2 + live * k * n * 2 + m * n * 4 + g * 4,
                   2 * m * k * n)
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
        cost_check(torch, "flash_bwd_dq", lambda: ops.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, *args), io + dq.numel() * 2,
            6 * d * pairs)
        cost_check(torch, "flash_bwd_dkv",
                   lambda: ops.flash_attention_bwd_dkv(
                       q, k, v, do, lse, delta, *args),
                   io + (dk.numel() + dv.numel()) * 2, 8 * d * pairs)
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
    rec["fleet"] = fleet_e2e(torch, np, gpu, cpu)
    rec["ledger"] = ledger_e2e(torch, np, gpu, cpu)
    del gpu, cpu
    torch.cuda.empty_cache()
    return rec


# the programs that only move data (copies, fills, masked fills): their
# cost is counted, and it holds no arithmetic
DATA_MOVEMENT = ("cb_admit_state", "cb_reset_scales", "lora_install")


def check_programs(prof: dict, counter: dict, what: str) -> None:
    """Every program of a ``profile()`` counted (FLOPs, above 0 but for
    DATA_MOVEMENT's; bytes above 0), compiled at least once, its dispatch
    counter (``counter``) equal to its record, its MFU at most 1.0 and its
    bandwidth utilization at most 1.05 where it has a reading (above is a
    counting fault)."""
    for pid, r in prof["programs"].items():
        ok = (r["flops"] is not None and r["bytes_accessed"]
              and r["compiles"] >= 1 and counter.get(pid) == r["dispatches"]
              and (r["flops"] == 0) == (r["name"] in DATA_MOVEMENT)
              and (r.get("mfu") or 0.0) <= 1.0
              and (r.get("bw_util") or 0.0) <= 1.05)
        if not ok:
            raise AssertionError(f"{what}: program {pid} {r} (dispatch "
                                 f"counter {counter.get(pid)})")


def ledger_mixed_run(torch, np, model, shared, adapter) -> tuple:
    """The reference's mixed-feature ledger traffic (``tests/test_ledger.py``
    ``test_acceptance_mixed_feature_run``) at LEDGER_E2E's sizes through a
    ``Server`` over ``model``'s paged engine with the ledger (and the
    monitor) on: two long prompts (chunked, the second a prefix hit), a
    speculating one, one under an adapter, then the same mix again. Returns
    (streams, the server's ``profile()``, the dispatch counter per program,
    the engine), the engine closed if the profile fails."""
    from paddle_tpu_torch import (GenerationConfig, monitor,
                                  PagedContinuousBatchingEngine)
    from paddle_tpu_torch.monitor import ledger
    from paddle_tpu_torch.serving import Server

    le = LEDGER_E2E
    ps = le["page"]
    eng = PagedContinuousBatchingEngine(
        model, max_batch=4, num_pages=le["pages"], page_size=ps,
        max_pages=le["max_pages"], prefill_chunk=2 * ps, prefix_cache=True,
        kv_dtype="int8", draft_k=4, lora_capacity=2, lora_rank=2,
        lora_targets=("q", "v"))
    eng.load_adapter("la", adapter)
    gen = dict(max_new_tokens=le["new"], eos_token_id=None)
    waves = [[(np.concatenate([shared, shared[:ps]]), {}),
              (np.concatenate([shared, shared[ps // 2:3 * ps // 2]]), {}),
              (shared[:3 * ps // 2], dict(speculative=True, draft_k=4)),
              (shared[:2 * ps], dict(adapter="la"))],
             [(np.concatenate([shared, shared[:ps]]), {}),
              (shared[:3 * ps // 2], dict(speculative=True, draft_k=4)),
              (shared[:2 * ps], dict(adapter="la"))]]
    srv = Server(eng, segment_steps=2)
    outs = []
    try:
        for wave in waves:
            hs = [srv.submit(p, GenerationConfig(**gen, **kw))
                  for p, kw in wave]
            outs += [np.asarray(h.result(timeout=600), np.int32)
                     for h in hs]
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        prof = srv.profile()
        m = monitor.snapshot()["metrics"].get(ledger.DISPATCH_COUNTER)
        counter = {x["labels"]["program"]: x["value"]
                   for x in (m or {}).get("samples", [])}
    finally:
        srv.shutdown(drain=False, timeout=120)
    return outs, prof, counter, eng


def ledger_e2e(torch, np, gpu, cpu):
    """This slice's path at 2 layers of the 7B widths (LEDGER_E2E): the
    reference's mixed-feature ledger traffic (chunked prefill, a prefix hit,
    speculative decoding, int8 pools, LoRA) through a ``Server`` with the
    program ledger on, on the card and on the CPU, from the same weights,
    one after the other (the ledger is process-wide): the streams equal,
    the same programs with the same dispatches, the same FLOPs per program
    on both devices; every program as :func:`check_programs` holds it.
    Then one decode-segment replay
    of the card's engine with the ledger on under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.monitor import ledger

    le = LEDGER_E2E
    rng = np.random.RandomState(31)
    shared = rng.randint(0, gpu.config.vocab_size,
                         (3 * le["page"],)).astype(np.int32)
    adapter = lora_factors(np, gpu, ("q", "v"), 2, seed=37,
                           scale=LORA["scale"], per_layer=False)
    runs = {}
    monitor.enable()
    try:
        for name, model in (("card", gpu), ("cpu", cpu)):
            monitor.reset()
            ledger.reset()
            ledger.enable()
            outs, prof, counter, eng = ledger_mixed_run(
                torch, np, model, shared, adapter)
            try:
                check_programs(prof, counter, f"ledger e2e, {name}")
                runs[name] = {"outs": outs, "programs": {
                    pid: (r["name"], r["dispatches"], r["flops"])
                    for pid, r in prof["programs"].items()}}
                if name == "card":
                    runs[name]["sync_check"] = ledger_replay_sync(
                        torch, eng)
            finally:
                eng.close()
                del eng
                ledger.disable()
                ledger.reset()
    finally:
        monitor.reset()
        monitor.disable()
    card, plain = runs["card"], runs["cpu"]
    matched = [next((i for i in range(len(b)) if a[i] != b[i]), len(b))
               for a, b in zip(card["outs"], plain["outs"])]
    if matched != [len(b) for b in plain["outs"]]:
        raise AssertionError(f"ledger e2e: the card's streams part from the "
                             f"CPU's at {matched}")
    if card["programs"] != plain["programs"]:
        raise AssertionError(
            f"ledger e2e: the card's programs (name, dispatches, FLOPs) "
            f"{card['programs']} differ from the CPU's {plain['programs']}")
    return {"programs": {pid: list(v) for pid, v in card["programs"].items()},
            "sync_check": card["sync_check"], "tokens_matched": matched}


def ledger_replay_sync(torch, eng) -> dict:
    """One replay of the idle engine's captured 2-step segment with the
    ledger on, under ``torch.cuda.set_sync_debug_mode("error")``: the
    events around the replay and the resolution of earlier pairs make no
    host sync (a sync there raises). Returns the segment program's
    dispatches before and after."""
    from paddle_tpu_torch.monitor import ledger

    key = eng._segment_key(2, False)
    pid = ledger.program_id("cb_segment", key, eng.programs.signature)
    if not eng.programs.built(key):
        raise AssertionError(f"ledger e2e: {key} was never captured")
    out = eng._seg_out[2]
    torch.cuda.synchronize()
    before = ledger.profile()["programs"][pid]["dispatches"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            eng.programs.run(key, lambda: eng._segment(2, out, False))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = ledger.profile()["programs"][pid]
    if after["dispatches"] != before + 1 or not after["summary"]["count"]:
        raise AssertionError(f"ledger e2e: the replay under sync debug "
                             f"recorded {after}")
    return {"program": pid, "dispatches": [before, after["dispatches"]]}


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
    server_rec["ledger"] = server_ledger_phase(torch, np, model, prompts,
                                               eng, server_outs, server_rec)
    spec_recs = spec_server_phase(torch, np, model, prompts, eng,
                                  server_outs, server_rec, profile)
    del eng
    torch.cuda.empty_cache()
    lora_rec = lora_server_phase(torch, np, model, prompts, server_outs,
                                 server_rec, profile)
    return tuple(recs) + (server_rec,) + spec_recs + (lora_rec,)


def serve_clients(srv, prompts, cfg, wait_s=600.0, tolerate=(), live=None):
    """Submit every prompt from a client thread of its own, in prompt order
    (each thread after the one before it, so the queue's order, and with
    it the scheduler's history, is the same in every run), each streaming
    its tokens at once; ``cfg`` is one config or one per prompt. Returns (outputs, handles) in prompt order; raises
    what a client raised, or if one did not finish within ``wait_s``. A
    request failing with a cause of a type in ``tolerate`` is not raised:
    its output is None and its handle FAILED. Each handle is appended to
    ``live`` (a list) as it is submitted, for a caller that watches the
    requests while they stream."""
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
                if live is not None:
                    live.append(handles[i])
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


def server_ledger_phase(torch, np, model, prompts, eng, plain_outs,
                        plain_rec):
    """This slice's path at 7B, the ``server_ledger`` leg: the ``Server``
    legs' engine, reset and its graphs dropped; the program ledger and the
    monitor turned on before a fresh ``Server(segment_steps=8,
    warmup=True)`` (so its warmup counts every program's cost in its first
    run, before any capture); the 8 prompts from 8 client threads, 32
    greedy tokens each. The streams must equal the plain ``server`` leg's
    token for token (the ledger changes no result), the launches the
    path's; every program counted (FLOPs, above 0 but for DATA_MOVEMENT's;
    bytes above 0), compiled at least once, its dispatch counter equal to
    its record, its MFU at most 1.0 and its bandwidth utilization at most
    1.05 (a reading above is a counting fault); the decode segments'
    seconds 0.5-1.0x the engine's own segment time over the leg. The
    ``/profile`` body, read over ``serve_http``, is printed through
    ``tools/monitor_report.py --profile``; TPOT beside the plain leg's."""
    from paddle_tpu_torch import GenerationConfig, monitor, ops
    from paddle_tpu_torch.monitor import ledger
    from paddle_tpu_torch.serving import Server, serve_http

    cfg = model.config
    L, n_new, vocab = cfg.num_hidden_layers, 32, cfg.vocab_size
    gen = GenerationConfig(max_new_tokens=n_new)
    eng.reset_state()
    eng.programs.clear()
    rec = {"server": "Server(eng, segment_steps=8, warmup=True), "
                     "FLAGS_enable_ledger on", "clients": len(prompts)}
    monitor.enable()
    monitor.reset()
    ledger.reset()
    ledger.enable()
    try:
        t0 = time.perf_counter()
        srv = Server(eng, segment_steps=8, warmup=True)
        httpd = None
        try:
            if not srv.wait_ready(600) or srv.status != "ok":
                raise AssertionError(f"server_ledger warmup: status "
                                     f"{srv.status}")
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
                f"server_ledger: prefills {n_pre}, chunks {n_chunks}, decode "
                f"steps {n_steps}, layers {L}")
            rec.update(handle_stats(handles, outs, vocab, n_new, seg0, eng),
                       prefills=n_pre, chunks=n_chunks, decode_steps=n_steps,
                       launches=counts)
            del handles
            httpd = serve_http(srv)
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            code, raw = http_json(url + "/profile")
            if code != 200:
                raise AssertionError(f"GET /profile: {code} {raw[:300]}")
            prof = json.loads(raw)
            m = monitor.snapshot()["metrics"].get(ledger.DISPATCH_COUNTER)
            counter = {x["labels"]["program"]: x["value"]
                       for x in (m or {}).get("samples", [])}
            table = subprocess.run(
                [sys.executable, os.path.join(ROOT, "tools",
                                              "monitor_report.py"),
                 "--url", url, "--profile"], check=True, capture_output=True,
                text=True, timeout=120).stdout
        finally:
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
            srv.shutdown(drain=False, timeout=120)
    finally:
        ledger.disable()
        ledger.reset()
        monitor.reset()
        monitor.disable()
    log("  /profile through tools/monitor_report.py --profile:")
    for line in table.splitlines():
        log("    " + line)
    if [o.tolist() for o in outs] != [o.tolist() for o in plain_outs]:
        splits, margins = first_splits(torch, np, model, prompts, outs,
                                       plain_outs)
        raise AssertionError(f"server_ledger: the streams part from the "
                             f"plain server leg's at {splits} (margins "
                             f"{margins})")
    check_programs(prof, counter, "server_ledger")
    progs = prof["programs"]
    seg_s = sum(r["total_seconds"] for r in progs.values()
                if r["name"] == "cb_segment")
    ratio = seg_s / rec["decode_s"]
    if not 0.5 <= ratio <= 1.0:
        raise AssertionError(f"server_ledger: the segment programs' "
                             f"{seg_s:.4f} s are {ratio:.3f}x the engine's "
                             f"segment time {rec['decode_s']:.4f} s")
    total = prof["total_seconds"] or 1.0
    rec.update(
        programs=[{"program": pid, "name": progs[pid]["name"],
                   "signature": progs[pid]["signature"],
                   "share": progs[pid]["total_seconds"] / total,
                   **{k: progs[pid].get(k) for k in (
                       "total_seconds", "dispatches", "compiles",
                       "compile_seconds", "flops", "bytes_accessed",
                       "intensity", "mfu", "bw_util", "bound")},
                   "p50_s": progs[pid]["summary"].get("p50")}
                  for pid in sorted(progs, key=lambda p: -progs[p][
                      "total_seconds"])],
        peaks=prof["peaks"], total_seconds=prof["total_seconds"],
        profile_table=table, segment_seconds=seg_s,
        segment_over_decode_s=ratio,
        plain_tpot_p50_s=plain_rec["tpot_p50_s"],
        plain_ttft_p50_s=plain_rec["ttft_p50_s"])
    return rec


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


def handoff_pages_equal(torch, eng, payload, prompt, salt=b""):
    """Whether ``eng``'s pool rows (and int8 scales) at the pages its
    prefix index maps for ``prompt``'s full blocks equal the payload's
    arrays exactly; raises where they do not."""
    pids, _, _ = eng.alloc.lookup_prefix(prompt, salt=salt)
    n = len(payload["blocks"])
    if len(pids) < n:
        raise AssertionError(f"handoff: {len(pids)} pages resident for "
                             f"{n} imported blocks")
    idx = torch.as_tensor(pids[:n], dtype=torch.long).to(eng.device)
    keys = ("k", "v", "k_scale", "v_scale")
    for li, (entry, lay) in enumerate(zip(eng.caches, payload["layers"])):
        for key, pool in zip(keys, entry):
            got = pool.index_select(0, idx).cpu()
            if not torch.equal(got, lay[key]):
                raise AssertionError(f"handoff: layer {li} {key!r} rows "
                                     "differ from the exported ones")


def block_offset(raw: bytes, block: int) -> int:
    """Offset in a framed payload of the first byte of ``block``'s rows in
    layer 0's ``k`` array."""
    n = int.from_bytes(raw[:4], "big")
    meta = json.loads(raw[4:4 + n])["layers"][0]["k"]
    row = 1
    for s in meta["shape"][1:]:
        row *= s
    item = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}[
        meta["dtype"]]
    return 4 + n + block * row * item


def overfull_import(torch, eng, payload) -> list:
    """Import ``payload`` into ``eng`` (a fresh engine) with live rows
    pinning all but half its blocks' pages, so its later blocks reclaim
    pages the same import adopted: every page the prefix index then maps
    for a block must hold that block's rows and scales exactly, and only
    the last blocks stay resident. Returns the resident block indices."""
    a = eng.alloc
    nb = len(payload["blocks"])
    spare = max(1, nb // 2)
    left = a.free_pages - spare
    for slot in range(a.page_table.shape[0]):
        n = min(left, a.page_table.shape[1])
        if n:
            a.ensure(slot, n * eng.page_size)
        left -= n
    if left or a.free_pages != spare:
        raise AssertionError(f"overfull import: {a.free_pages} pages left")
    got = eng.import_kv_pages(payload)
    if got["imported"] != nb:
        raise AssertionError(f"overfull import: {got}")
    a.check()
    keys = ("k", "v", "k_scale", "v_scale")
    resident = []
    for b, blk in enumerate(payload["blocks"]):
        pid = a._index.get(bytes.fromhex(blk["hash"]))
        if pid is None:
            continue
        resident.append(b)
        for li, (entry, lay) in enumerate(zip(eng.caches,
                                              payload["layers"])):
            for key, pool in zip(keys, entry):
                if not torch.equal(pool[pid].cpu(), lay[key][b]):
                    raise AssertionError(
                        f"overfull import: page {pid} of block {b}, layer "
                        f"{li} {key!r}, holds other rows")
    if resident != list(range(nb - spare, nb)):
        raise AssertionError(f"overfull import: blocks {resident} resident")
    return resident


def front_f32(torch, np, gpu, prompts, n_new) -> dict:
    """C-check-3 in fp32 at 2 layers: ``gpu``'s weights in fp32, a
    monolithic ``Server``, then ``DisaggregatedFront`` over a prefill and a
    decode replica, each a ``Server`` behind ``serve_http`` in this process
    reached through ``RemoteReplica`` (the wire, the codec and the /kv
    routes a replica process serves). Every front stream must equal the
    monolithic one token for token, a split failing at a top-2 margin of
    F32_NEAR_TIE or more."""
    from paddle_tpu_torch import GenerationConfig, PagedContinuousBatchingEngine
    from paddle_tpu_torch.serving import (DisaggregatedFront, RemoteReplica,
                                          Server, serve_http)

    kw = dict(max_batch=2, num_pages=32, page_size=16, max_pages=16,
              prefix_cache=True)
    gen = GenerationConfig(max_new_tokens=n_new)
    m32 = f32_twin(torch, gpu)
    mono = Server(PagedContinuousBatchingEngine(m32, **kw), segment_steps=4)
    try:
        want = [np.asarray(mono.submit(p, gen).result(timeout=600), np.int32)
                for p in prompts]
    finally:
        mono.shutdown(drain=False, timeout=60)
    srvs, httpds, reps = [], [], []
    try:
        for m in (m32, f32_twin(torch, gpu)):
            srvs.append(Server(PagedContinuousBatchingEngine(m, **kw),
                               segment_steps=4))
            httpds.append(serve_http(srvs[-1]))
            reps.append(RemoteReplica(
                f"http://127.0.0.1:{httpds[-1].server_address[1]}"))
        front = DisaggregatedFront(*reps)
        outs = [np.asarray(front.generate(p, gen).result(timeout=600),
                           np.int32) for p in prompts]
    finally:
        for r in reps:
            r.close()
        for h in httpds:
            h.shutdown()
        for srv in srvs:
            srv.shutdown(drain=False, timeout=60)
    want_blocks = sum(len(p) // 16 for p in prompts)
    if front.handoffs != want_blocks or front.failovers:
        raise AssertionError(f"front fp32: {front.handoffs} blocks shipped "
                             f"of {want_blocks}, {front.failovers} failovers")
    splits, margins = first_splits(torch, np, m32, prompts, outs, want)
    if any(mg is not None and mg >= F32_NEAR_TIE for mg in margins):
        raise AssertionError(f"front fp32: streams part from the monolithic "
                             f"Server's at {splits}, margins {margins}")
    return {"blocks_shipped": front.handoffs, "first_split": splits,
            "split_margins": margins}


def run_to_end(eng, ids, cfg):
    """One request through an engine's stepwise API; its stream."""
    rid = eng.add_request(ids, cfg)
    while eng.decode_segment(4):
        pass
    return eng.collect_finished()[rid]


def fleet_e2e(torch, np, gpu, cpu):
    """This slice's legs at 2 layers of the 7B widths (FLEET_E2E): the
    KV-page handoff with bf16 and with int8 pools, card against CPU, and a
    two-replica ``Router`` with one replica killed mid-stream.

    Per pool dtype: a card engine (``prefix_cache=True``) serves a prompt
    (the colocated stream), exports its pages; the payload goes through
    ``encode_kv_payload`` / ``decode_kv_payload`` and ``import_kv_pages``
    into a fresh card engine and a CPU engine: the imported rows and scales
    equal the exported ones exactly on both; a re-ship imports 0 and
    dedups every block. Through ``serve_http`` over a ``Server`` on a third
    card engine: the framed bytes with one byte of block 1 flipped answer
    400 ``integrity`` naming block 1 and install nothing, the good bytes
    import every block, and the prompt plus the first token served there
    continues the colocated stream token for token (a split only at a
    top-2 margin under NEAR_TIE); the CPU engine's continuation against the
    card's up to a near-tie. Then ``Router`` over two replicas of the same
    weights, replica 0 behind ``FaultyEngine`` whose third decode segment
    raises a fatal ``EngineFault`` (``max_restarts=0``): every stream
    equals a single ``Server``'s (the margin rule), with a failover."""
    from paddle_tpu_torch import (GenerationConfig, LlamaForCausalLM,
                                  PagedContinuousBatchingEngine)
    from paddle_tpu_torch.inference.generation import EngineFault
    from paddle_tpu_torch.serving import (ReplicaSpec, Router, Server,
                                          decode_kv_payload,
                                          encode_kv_payload, serve_http)
    from paddle_tpu_torch.testing import FaultPlan, FaultyEngine

    cfg = gpu.config
    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in FLEET_E2E["prompts"]]
    prompt, n_new = prompts[0], FLEET_E2E["new"]
    gen = GenerationConfig(max_new_tokens=n_new)
    kw = dict(max_batch=2, num_pages=32, page_size=16, max_pages=16,
              prefix_cache=True)
    rec = {"prompt_lens": [len(p) for p in prompts], "new": n_new}
    for kv in ("bf16", "int8"):
        r = {}
        colo = run_to_end(PagedContinuousBatchingEngine(gpu, kv_dtype=kv,
                                                        **kw), prompt, gen)
        src = PagedContinuousBatchingEngine(gpu, kv_dtype=kv, **kw)
        run_to_end(src, prompt, GenerationConfig(max_new_tokens=1))
        t0 = time.perf_counter()
        payload = src.export_kv_pages(prompt)
        torch.cuda.synchronize()
        r["export_ms"] = (time.perf_counter() - t0) * 1e3
        raw = encode_kv_payload(payload)
        got = decode_kv_payload(raw)
        nb = len(got["blocks"])
        r.update(blocks=nb, bytes=len(raw))
        rest = np.concatenate([prompt, colo[:1]])
        cont = GenerationConfig(max_new_tokens=n_new - 1)
        for name, m in (("card", gpu), ("cpu", cpu)):
            dst = PagedContinuousBatchingEngine(m, kv_dtype=kv, **kw)
            first = dst.import_kv_pages(got)
            again = dst.import_kv_pages(got)
            if (first != {"imported": nb, "deduped": 0, "coverage": nb * 16}
                    or again["imported"] != 0 or again["deduped"] != nb):
                raise AssertionError(f"handoff {kv} into the {name}: "
                                     f"{first}, then {again}")
            handoff_pages_equal(torch, dst, got, prompt)
            dst.alloc.check()
            r[f"{name}_continuation"] = run_to_end(dst, rest, cont)
        r["overfull_resident"] = overfull_import(
            torch, PagedContinuousBatchingEngine(gpu, kv_dtype=kv, **kw), got)
        # over the wire into a Server: a flipped byte, then the good bytes
        srv = Server(PagedContinuousBatchingEngine(gpu, kv_dtype=kv, **kw),
                     segment_steps=4)
        httpd = serve_http(srv)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            bad = bytearray(raw)
            bad[block_offset(raw, 1)] ^= 0xFF
            alloc = srv.engine.alloc
            before = (alloc.free_pages, alloc.cached_pages)
            status, body = http_raw(url + "/kv/import", bytes(bad))
            body = json.loads(body)
            if (status != 400 or body.get("reason") != "integrity"
                    or "block 1" not in body.get("error", "")
                    or (alloc.free_pages, alloc.cached_pages) != before):
                raise AssertionError(f"handoff {kv}: a flipped byte of "
                                     f"block 1 gave {status} {body}")
            status, body = http_raw(url + "/kv/import", raw)
            if status != 200 or json.loads(body)["imported"] != nb:
                raise AssertionError(f"handoff {kv}: /kv/import {status} "
                                     f"{body}")
            h = srv.submit(rest, cont)
            wire = np.asarray(h.result(timeout=600), np.int32)
        finally:
            httpd.shutdown()
            srv.shutdown(drain=False, timeout=60)
        splits, margins = check_streams(
            torch, np, gpu, [rest], [wire], [colo[1:]],
            f"handoff {kv}: the decode engine against the colocated one")
        r.update(integrity_reject="400 naming block 1, nothing installed",
                 wire_first_split=splits[0], wire_split_margin=margins[0],
                 card_cpu_tokens_matched=matched_tokens(
                     torch, np, cpu, [rest], [r.pop("card_continuation")],
                     [r.pop("cpu_continuation")])[0])
        rec[kv] = r

    # the router: replica 0 dies mid-stream, the streams stay a Server's
    def model():
        return LlamaForCausalLM(
            cfg, device=gpu.device,
            generator=torch.Generator(gpu.device).manual_seed(7))

    rkw = dict(max_batch=2, num_pages=32, page_size=16, max_pages=16)
    skw = dict(segment_steps=2, idle_wait_s=0.005)
    ref = Server(PagedContinuousBatchingEngine(model(), **rkw), **skw)
    try:
        want = [np.asarray(ref.submit(p, gen).result(timeout=600), np.int32)
                for p in prompts]
    finally:
        ref.shutdown(drain=False, timeout=60)
    plan = FaultPlan().raise_at("decode", nth=3,
                                exc=EngineFault("injected replica death"))
    builds = []

    def factory():
        eng = PagedContinuousBatchingEngine(model(), **rkw)
        builds.append(eng)
        return FaultyEngine(eng, plan) if len(builds) == 1 else eng

    router = Router(ReplicaSpec(factory, server_kwargs=dict(
        max_restarts=0, **skw)), replicas=2, monitor_interval_s=0.02)
    try:
        hs = [router.submit(p, gen) for p in prompts]
        outs = [np.asarray(h.result(timeout=600), np.int32) for h in hs]
        failovers = router.failovers
        deadline = time.monotonic() + 600
        while router.load()["replicas"][0]["status"] != "ok":
            if time.monotonic() > deadline:
                raise AssertionError("router e2e: replica 0 not rebuilt")
            time.sleep(0.05)
        restarts = router.load()["replicas"][0]["restarts"]
    finally:
        router.shutdown(drain=False, timeout=60)
        del builds[0].__dict__["_run_prefill"]      # FaultyEngine's shadow
    if failovers < 1 or plan.injected != [("decode", 3, "raise")]:
        raise AssertionError(f"router e2e: failovers {failovers}, injected "
                             f"{plan.injected}")
    splits, margins = check_streams(torch, np, gpu, prompts, outs, want,
                                    "router e2e: routed against a Server")
    rec["router"] = {"replicas": 2, "failovers": failovers,
                     "restarts": restarts, "first_split_from_server": splits,
                     "split_top2_margins": margins}
    rec["front_f32"] = front_f32(torch, np, gpu, prompts, n_new)
    return rec


def http_raw(url, data: bytes, timeout=600):
    """(status, body bytes) of an octet-stream POST."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    req = Request(url, data=data,
                  headers={"Content-Type": "application/octet-stream"})
    try:
        with urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except HTTPError as e:
        return e.code, e.read()


def phase5_prompts(np, vocab):
    """Phase 5's 8 prompts (100-700 tokens, seeded)."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, (n,)).astype(np.int32)
            for n in (100, 180, 260, 340, 420, 500, 600, 700)]


def fleet_model(torch, dev):
    """Phase 5's 7B model (the seeded weights every replica shares)."""
    from paddle_tpu_torch import LlamaForCausalLM, llama_config

    return LlamaForCausalLM(llama_config(PRESET, dtype="bfloat16"),
                            device=dev,
                            generator=torch.Generator(dev).manual_seed(0))


def fleet_engine(model):
    from paddle_tpu_torch import PagedContinuousBatchingEngine

    return PagedContinuousBatchingEngine(model, prefix_cache=True,
                                         **FLEET["engine"])


def latency(handles, outs) -> dict:
    """TTFT and TPOT p50 of finished handles (their own stamps)."""
    ttft = [h.first_token_ts - h.submit_ts for h in handles]
    tpot = [(h.finish_ts - h.first_token_ts) / (len(o) - 1)
            for h, o in zip(handles, outs)]
    return {"ttft_p50_s": statistics.median(ttft), "ttft_s": ttft,
            "tpot_p50_s": statistics.median(tpot), "tpot_s": tpot}


def free_cuda(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def replica_errors(router) -> list:
    """Each replica's status and, where its scheduler died, why."""
    return [(rep.index, rep.server.status,
             repr(getattr(rep.server, "_fatal", None)))
            for rep in router._replicas]


def fleet_phase(torch, np, dev):
    """This slice's main path at full depth and width (``fleet`` leg): a
    single ``Server(warmup=True)`` over the 7B model through
    ``PagedContinuousBatchingEngine(prefix_cache=True, prefill_chunk=256)``
    serves phase 5's 8 prompts from 8 client threads (the reference
    streams, TTFT and TPOT), then times the KV-page handoff of every
    prompt under 512 tokens in process (export, encode, decode, import
    into the engine after ``reset_state``). Then ``Router`` over 2
    replicas, each a fresh seeded 7B model and engine behind
    ``Server(warmup=True, max_restarts=0)``, replica 0's first build
    behind ``FaultyEngine``: the 8 prompts from 8 client threads, replica 0
    killed (``FaultPlan.kill``) once one of its requests has streamed
    FLEET["kill_after"] tokens; waves of the 8 prompts keep coming while
    the supervisor rebuilds replica 0 (its warmup captures beside the
    survivor's replays); then a wave during ``rolling_restart``. Every
    stream must equal the single Server's (the margin rule, checked after
    the leg); every kernel's launches over the router's traffic counted.
    Returns (the record, the reference streams, the handoff payloads'
    byte counts by prompt)."""
    from paddle_tpu_torch import GenerationConfig, ops
    from paddle_tpu_torch.monitor import ledger
    from paddle_tpu_torch.serving import (ReplicaSpec, Router, Server,
                                          decode_kv_payload,
                                          encode_kv_payload)
    from paddle_tpu_torch.testing import FaultPlan, FaultyEngine

    torch.cuda.reset_peak_memory_stats()
    gen = GenerationConfig(max_new_tokens=FLEET["new"])
    model = fleet_model(torch, dev)
    L = model.config.num_hidden_layers
    prompts = phase5_prompts(np, model.config.vocab_size)
    rec = {"preset": PRESET, "layers": L, "engine": FLEET["engine"],
           "prompt_lens": [len(p) for p in prompts]}
    eng = fleet_engine(model)
    srv = Server(eng, segment_steps=FLEET["segment_steps"], warmup=True)
    try:
        if not srv.wait_ready(600) or srv.status != "ok":
            raise AssertionError(f"fleet: single Server {srv.status}")
        ref, handles = serve_clients(srv, prompts, gen)
        # the handoff's protocol without the wire: each short prompt plus
        # its first token again, continued from this Server's own cached
        # pages (the decode replica runs the same admission over imported
        # ones)
        short = [p for p in prompts if len(p) < FLEET["handoff_max"]]
        cont = serve_clients(
            srv, [np.concatenate([p, r[:1]]) for p, r in zip(short, ref)],
            GenerationConfig(max_new_tokens=FLEET["new"] - 1))[0]
        local = [np.concatenate([r[:1], c]) for r, c in zip(ref, cont)]
    finally:
        srv.shutdown(drain=False, timeout=120)
    rec["single"] = latency(handles, ref)
    # the handoff in process: the engine's own costs at full width
    payloads, inproc = [], []
    for p in short:
        t0 = time.perf_counter()
        pay = eng.export_kv_pages(p)
        t1 = time.perf_counter()
        raw = encode_kv_payload(pay)
        t2 = time.perf_counter()
        payloads.append(decode_kv_payload(raw))
        t3 = time.perf_counter()
        inproc.append({"prompt": len(p), "blocks": len(pay["blocks"]),
                       "bytes": len(raw), "export_ms": (t1 - t0) * 1e3,
                       "encode_ms": (t2 - t1) * 1e3,
                       "decode_ms": (t3 - t2) * 1e3})
        del pay, raw
    eng.reset_state()
    for p, pay, r in zip(short, payloads, inproc):
        t0 = time.perf_counter()
        out = eng.import_kv_pages(pay)
        torch.cuda.synchronize()
        r["import_ms"] = (time.perf_counter() - t0) * 1e3
        if out["imported"] != len(pay["blocks"]):
            raise AssertionError(f"fleet: in-process import {out}")
        handoff_pages_equal(torch, eng, pay, p)
    rec["handoff_in_process"] = inproc
    del srv, eng, model, payloads, handles
    free_cuda(torch)

    plan = FaultPlan()
    builds = []            # build times only: a dead replica's memory must go

    def factory():
        e = fleet_engine(fleet_model(torch, dev))
        builds.append(time.perf_counter())
        return FaultyEngine(e, plan) if len(builds) == 1 else e

    t0 = time.perf_counter()
    router = Router(ReplicaSpec(factory, server_kwargs=dict(
        segment_steps=FLEET["segment_steps"], warmup=True, max_restarts=0)),
        replicas=2, monitor_interval_s=0.05)
    checks, waves = [], []
    try:
        if not router.wait_ready(600) or router.status != "ok":
            raise AssertionError(f"fleet: the replicas did not warm up: "
                                 f"{replica_errors(router)}")
        rec["fleet_ready_s"] = time.perf_counter() - t0
        subs = []
        ops.reset_launch_counts()
        box = {}

        def wave(tag, live=None):
            w0 = time.perf_counter()
            try:
                outs, hs = serve_clients(router, prompts, gen, live=live)
            except BaseException as e:      # raised by the main thread
                box["error"] = e
                raise
            waves.append((tag, w0, time.perf_counter()))
            checks.append((tag, outs))
            # no handle is kept: one holds its replica's Server, and a
            # replaced replica's memory must go
            box[tag] = ([h.status for h in hs], latency(hs, outs))

        import threading

        first = threading.Thread(target=wave, args=("kill", subs),
                                 daemon=True)
        first.start()
        deadline = time.monotonic() + 600
        while not any(h.replica == 0 and len(h.tokens_so_far())
                      >= FLEET["kill_after"] for h in list(subs)):
            if time.monotonic() > deadline or not first.is_alive():
                raise AssertionError(f"fleet: replica 0 streamed nothing "
                                     f"({box.get('error')!r}; "
                                     f"{replica_errors(router)})")
            time.sleep(0.001)
        victims = {id(h): len(h.tokens_so_far()) for h in list(subs)
                   if h.replica == 0 and not h.done}
        t_kill = time.perf_counter()
        plan.kill("decode")
        while any(id(h) in victims and not h.done
                  and len(h.tokens_so_far()) <= victims[id(h)]
                  for h in list(subs)):
            time.sleep(0.001)
        rec["recovery_s"] = time.perf_counter() - t_kill
        subs.clear()
        first.join(600)
        if "kill" not in box:
            raise AssertionError(f"fleet: the killed wave did not finish "
                                 f"({box.get('error')!r})")
        rec["failovers"] = router.failovers
        if rec["failovers"] < 1:
            raise AssertionError("fleet: no request failed over")
        rec["wave1"] = box["kill"][1]
        n = 0
        while router.load()["replicas"][0]["status"] != "ok":
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: replica 0 was not rebuilt: "
                                     f"{replica_errors(router)}")
            wave(f"rebuild{n}")
            n += 1
        t_ok = time.perf_counter()
        if len(builds) < 3:
            raise AssertionError(f"fleet: {len(builds)} builds")
        t_built = builds[2]
        rec.update(rebuild_s=t_ok - t_kill, rebuild_build_s=t_built - t_kill,
                   rebuild_warmup_s=t_ok - t_built, waves_during_rebuild=n,
                   restarts=router.load()["replicas"][0]["restarts"])
        if not any(w1 > t_built and w0 < t_ok for _, w0, w1 in waves):
            raise AssertionError("fleet: no wave served while the rebuilt "
                                 "replica warmed up")
        # a rolling restart under traffic
        roll = threading.Thread(target=wave, args=("rolling",), daemon=True)
        roll.start()
        t0 = time.perf_counter()
        drained = router.rolling_restart(timeout=600)
        rec["rolling_restart_s"] = time.perf_counter() - t0
        roll.join(600)
        if "error" in box:
            raise box["error"]
        if not drained or "rolling" not in box or any(
                st != "finished" for st in box["rolling"][0]):
            raise AssertionError(f"fleet: rolling restart drained "
                                 f"{drained}, statuses {box.get('rolling')}")
        torch.cuda.synchronize()
        rec["launches"] = ops.launch_counts()
        rec["builds"] = len(builds)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["load"] = router.load()
        # the fleet's program ledger: one wave with the ledger on, then
        # Router.profile against the merge of the live replicas' shards
        ledger.reset()
        ledger.enable()
        wave("ledger")
        if "error" in box:
            raise box["error"]
        torch.cuda.synchronize()
        fleet_prof = router.profile()
        want = ledger.merge_profiles([r.server.profile()
                                      for r in router._replicas
                                      if not r.dead])
        if (not fleet_prof["programs"]
                or fleet_prof["programs"] != want["programs"]
                or fleet_prof["top"] != want["top"]):
            raise AssertionError(f"fleet: Router.profile {fleet_prof} is "
                                 f"not the merge of its replicas' shards "
                                 f"{want}")
        rec["ledger"] = {"replicas": fleet_prof["replicas"],
                         "programs": len(fleet_prof["programs"]),
                         "total_seconds": fleet_prof["total_seconds"]}
    finally:
        ledger.disable()
        ledger.reset()
        router.shutdown(drain=False, timeout=120)
    for name in ("rms_norm", "fused_rope", "paged_decode"):
        if not rec["launches"].get(name):
            raise AssertionError(f"fleet: {name} never launched")
    if not (rec["launches"].get("flash_fwd")
            or rec["launches"].get("flash_fwd_prefix")):
        raise AssertionError("fleet: flash_fwd never launched")
    rec["waves"] = [(tag, w1 - w0) for tag, w0, w1 in waves]
    # every name that reaches a replica goes before the cache is emptied
    del router, builds, box, subs, wave, first, roll
    free_cuda(torch)
    rec["allocated_after_gb"] = torch.cuda.memory_allocated() / 2 ** 30
    return rec, prompts, ref, local, [(tag, outs) for tag, outs in checks]


def replica_launches(rep) -> dict:
    """A replica process's launches per kernel so far: its
    ``paddle_tpu_kernel_launches`` series, read through ``GET
    /metrics.json``."""
    from urllib.request import urlopen

    with urlopen(rep.base_url + "/metrics.json", timeout=60) as r:
        snap = json.loads(r.read())
    return {s["labels"]["kernel"]: int(s["value"]) for s in
            snap["metrics"]["paddle_tpu_kernel_launches"]["samples"]}


# the kernels each side of the front must launch on the leg's wave: the
# prefill replica's cold prefills (K3 one-shot or, past a chunk, its
# prefix-chunk instance), the decode replica's warm tail over imported
# pages (K3's prefix-chunk instance) and its decode steps (K4)
DISAGG_KERNELS = {"prefill": (("rms_norm",), ("fused_rope",),
                              ("flash_fwd", "flash_fwd_prefix")),
                  "decode": (("rms_norm",), ("fused_rope",),
                             ("flash_fwd_prefix",), ("paged_decode",))}


def disagg_phase(torch, np, prompts):
    """The ``disagg`` leg: two ``spawn_replica`` processes on the same card
    (the 7B model at full depth, ``--prefix-cache on --prefill-chunk 256
    --warmup on``), a prefill and a decode replica behind
    ``DisaggregatedFront``. Phase 5's prompts under FLEET["handoff_max"]
    tokens from client threads at once, 32 tokens each, with each
    replica's kernel launches over that wave (its
    ``paddle_tpu_kernel_launches`` series before and after). Then, one at
    a time through the replicas' public calls, fresh prompts of the same
    lengths (seed 1): the prefill replica's cold budget-1 prefill (its
    TTFT), ``/kv/export`` (export, encode and wire), ``/kv/import`` (wire,
    decode, import) and the decode replica's continuation (its TTFT).
    Then a prompt of FLEET["handoff_max"] tokens or more, whose import the
    reference's 256 MiB cap refuses: its handle ends FAILED naming the 413
    and both replicas keep serving (one more request through the front);
    then the decode process killed mid-stream, the request replaying on
    the prefill replica. Runs while this process holds nothing on the
    card. Returns (record, streams): the streams as (tag, prompt indices,
    outputs), checked by the caller against the single ``Server``'s and
    against its continuations over its own pages."""
    import threading
    import types

    from paddle_tpu_torch import GenerationConfig, llama_config
    from paddle_tpu_torch.serving import DisaggregatedFront, RemoteReplica
    from paddle_tpu_torch.serving.remote import spawn_replica
    from paddle_tpu_torch.serving.http import MAX_KV_BODY_BYTES

    gen = GenerationConfig(max_new_tokens=FLEET["new"])
    cfg = llama_config(PRESET)
    ps = FLEET["engine"]["page_size"]
    args = ["--device", REPLICA_DEVICE, "--preset", PRESET, "--layers",
            str(cfg.num_hidden_layers), "--dtype", "bfloat16",
            "--model-seed", "0",
            "--prefix-cache", "on", "--warmup", "on",
            "--segment-steps", str(FLEET["segment_steps"])]
    for k, v in FLEET["engine"].items():
        args += ["--" + k.replace("_", "-"), str(v)]
    reps, errs = [None, None], []

    def start(i):
        try:
            proc, url = spawn_replica(args, startup_timeout_s=600,
                                      env={"FLAGS_enable_ledger": "1"},
                                      stderr=None)
            reps[i] = RemoteReplica(url, proc=proc, stream_timeout_s=600)
        except BaseException as e:          # re-raised below
            errs.append(e)

    t0 = time.perf_counter()
    ts = [threading.Thread(target=start, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    rec = {"spawn_s": time.perf_counter() - t0}
    checks = []
    try:
        if errs:
            raise errs[0]
        prefill, decode = reps
        front = DisaggregatedFront(prefill, decode)
        short = [(i, p) for i, p in enumerate(prompts)
                 if len(p) < FLEET["handoff_max"]]
        before = [replica_launches(r) for r in reps]
        outs, hs = serve_clients(types.SimpleNamespace(submit=front.generate),
                                 [p for _, p in short], gen)
        after = [replica_launches(r) for r in reps]
        by_rep = {side: {k: after[j][k] - before[j].get(k, 0)
                         for k in after[j]}
                  for j, side in enumerate(("prefill", "decode"))}
        rec["launches_by_replica"] = by_rep
        rec["launches"] = {k: by_rep["prefill"][k] + by_rep["decode"][k]
                           for k in by_rep["prefill"]}
        # each replica process's program-ledger shard (started with
        # FLAGS_enable_ledger=1), through RemoteReplica.profile
        rec["ledger"] = {}
        for side, r in zip(("prefill", "decode"), reps):
            shard = r.profile()
            if not shard["programs"]:
                raise AssertionError(f"disagg: the {side} replica's "
                                     f"/profile shard is empty")
            rec["ledger"][side] = {
                "programs": len(shard["programs"]),
                "names": sorted({p["name"]
                                 for p in shard["programs"].values()}),
                "total_seconds": shard["total_seconds"]}
        for side, need in DISAGG_KERNELS.items():
            for names in need:
                if not any(by_rep[side].get(k) for k in names):
                    raise AssertionError(
                        f"disagg: the {side} replica launched none of "
                        f"{names} on the wave: {by_rep[side]}")
        rec["wave"] = [{"index": i, "prompt": len(p),
                        "ttft_s": h.first_token_ts - h.submit_ts}
                       for (i, p), h in zip(short, hs)]
        checks.append(("disagg", [i for i, _ in short], outs))
        del hs
        # per handoff, one at a time, through the public calls
        fresh = np.random.RandomState(1)
        hand = []
        for _, p in short:
            q = fresh.randint(0, cfg.vocab_size, (len(p),)).tolist()
            h1 = prefill.submit(q, GenerationConfig(max_new_tokens=1))
            first = int(h1.result(timeout=600)[0])
            t = time.perf_counter()
            raw = prefill.export_kv_raw(q)
            t_exp = time.perf_counter() - t
            t = time.perf_counter()
            got = decode.import_kv_raw(raw)
            t_imp = time.perf_counter() - t
            if got["imported"] != len(q) // ps:
                raise AssertionError(f"disagg: import of {len(q)} tokens "
                                     f"{got}")
            h2 = decode.submit(q + [first], GenerationConfig(
                max_new_tokens=FLEET["new"] - 1))
            if len(h2.result(timeout=600)) != FLEET["new"] - 1:
                raise AssertionError("disagg: a short continuation")
            hand.append({
                "prompt": len(q), "bytes": len(raw),
                "blocks": got["imported"],
                "export_http_ms": t_exp * 1e3, "import_http_ms": t_imp * 1e3,
                "cold_ttft_s": h1.first_token_ts - h1.submit_ts,
                "decode_ttft_s": h2.first_token_ts - h2.submit_ts})
            del raw
        rec["handoffs"] = hand
        # a prompt whose pages pass the import cap: FAILED with the 413
        # (at the 7B widths; a narrower model's pages fit and must serve),
        # and both replicas serve on
        big = next(i for i, p in enumerate(prompts)
                   if len(p) >= FLEET["handoff_max"])
        page_bytes = (2 * cfg.num_hidden_layers * ps
                      * cfg.num_key_value_heads
                      * (cfg.hidden_size // cfg.num_attention_heads) * 2)
        est = len(prompts[big]) // ps * page_bytes
        h = front.generate(prompts[big], gen)
        try:
            out = np.asarray(h.result(timeout=600), np.int32)
            cause = None
        except Exception as e:              # the FAILED handle's error
            cause = e.__cause__ or e
        over = est > MAX_KV_BODY_BYTES
        if over and (h.status != "failed" or "413" not in str(cause)):
            raise AssertionError(f"disagg: over-cap handoff ({est} bytes of "
                                 f"pages) {h.status} {cause!r}")
        if not over:
            if cause is not None:
                raise cause
            checks.append(("under_cap", [big], [out]))
        rec["over_cap"] = {"prompt": len(prompts[big]), "page_bytes": est,
                           "cap": MAX_KV_BODY_BYTES, "status": h.status,
                           "error": None if cause is None
                           else str(cause)[:300]}
        for rep, name in ((prefill, "prefill"), (decode, "decode")):
            rep.wait_ready(60)
            if rep.status != "ok":
                raise AssertionError(f"disagg: {name} replica {rep.status} "
                                     "after the over-cap handoff")
        h = front.generate(prompts[0], gen)
        checks.append(("after_over_cap", [0],
                       [np.asarray(h.result(timeout=600), np.int32)]))
        # the decode process killed mid-stream
        j = short[len(short) // 2][0]
        h = front.generate(prompts[j], gen)
        deadline = time.monotonic() + 600
        while len(h.tokens_so_far()) < FLEET["kill_after"]:
            if time.monotonic() > deadline or h.done:
                raise AssertionError(f"disagg: no stream to cut ({h.status})")
            time.sleep(0.001)
        t_kill = time.perf_counter()
        decode.proc.kill()
        out = np.asarray(h.result(timeout=600), np.int32)
        rec["decode_kill"] = {"prompt": len(prompts[j]),
                              "tokens_at_kill": FLEET["kill_after"],
                              "replay_s": time.perf_counter() - t_kill,
                              "front_failovers": front.failovers}
        if front.failovers < 1:
            raise AssertionError("disagg: the decode kill did not fail over")
        checks.append(("decode_kill", [j], [out]))
        rec.update(handoffs_blocks=front.handoffs, dedups=front.dedups)
    finally:
        for rep in reps:
            if rep is not None:
                rep.shutdown(drain=False)
    return rec, checks


def f32_twin(torch, model):
    """``model``'s weights in an fp32 model of the same configuration."""
    import dataclasses

    from paddle_tpu_torch import LlamaForCausalLM

    m32 = LlamaForCausalLM(dataclasses.replace(model.config, dtype="float32"),
                           device=model.device)
    m32.load_state_dict(model.state_dict())
    return m32


def f32_gaps(torch, np, model, m32, prompts, outs, ref_outs):
    """Per prompt, the first token where ``outs`` parts from ``ref_outs``
    and, there (None where they agree throughout): the uncached bf16
    model's top-2 margin, the fp32 twin's top-2 margin and its logit gap
    between the two streams' tokens (``ref_outs``' minus ``outs``'), and
    the bf16 forward's error on those two logits against the fp32 one.
    TF32 is off, so the fp32 forward rounds only in fp32."""
    splits = [next((i for i in range(len(d)) if d[i] != w[i]), len(d))
              for d, w in zip(outs, ref_outs)]
    rows = []
    with torch.no_grad():
        for p, d, w, n in zip(prompts, outs, ref_outs, splits):
            if n == len(d):
                rows.append(None)
                continue
            seq = torch.from_numpy(np.concatenate([p, w[:n]]).astype(
                np.int64))[None].to(model.device)
            l16 = model(seq)[0, -1].float()
            l32 = m32(seq)[0, -1].float()
            a, b = int(d[n]), int(w[n])
            t16, t32 = l16.topk(2).values, l32.topk(2).values
            rows.append({
                "split": n, "token": a, "ref_token": b,
                "bf16_margin": (t16[0] - t16[1]).item(),
                "f32_margin": (t32[0] - t32[1]).item(),
                "f32_gap": (l32[b] - l32[a]).item(),
                "f32_top1": int(l32.argmax()),
                "bf16_err": max(abs(l16[t] - l32[t]).item()
                                for t in (a, b))})
    return splits, rows


def fleet_legs(torch, np, dev):
    """Phase 5's disaggregated and fleet legs (the replica processes first,
    while this process holds nothing on the card), their streams checked
    after both. The fleet's waves against the single ``Server``'s streams;
    the front's against the single ``Server``'s continuation of the same
    requests (prompt plus its first token, after a budget-1 prefill) over
    its own cached pages: the handoff without the wire. Each must match
    token for token, a split failing at a top-2 margin of NEAR_TIE or more
    (C-check-2). The front's streams against the single ``Server``'s own
    (monolithic: its first token's KV decoded, where the front's decode
    side prefills it; ROADMAP C-check-3): where one parts, the bf16
    model's margin and, from the same weights in fp32, the gap between
    the two streams' tokens (:func:`f32_gaps`); a split fails where that
    fp32 gap is NEAR_TIE or more. A model is built only where a stream
    parts."""
    from paddle_tpu_torch import llama_config

    prompts = phase5_prompts(np, llama_config(PRESET).vocab_size)
    t0 = time.perf_counter()
    dg, streams = disagg_phase(torch, np, prompts)
    dg["leg_s"] = time.perf_counter() - t0
    free_cuda(torch)
    t0 = time.perf_counter()
    fl, _, ref, local, fleet_checks = fleet_phase(torch, np, dev)
    fl["leg_s"] = time.perf_counter() - t0
    for r in dg["wave"]:
        r["single_server_ttft_s"] = fl["single"]["ttft_s"][r["index"]]
    everything = list(range(len(prompts)))
    local = dict(zip(everything, local))    # by prompt index, short ones
    checks = [(fl, tag, everything, outs, ref, "bf16")
              for tag, outs in fleet_checks]
    for tag, idx, outs in streams:
        if tag == "under_cap":              # no local twin: past the cut
            checks.append((dg, tag, idx, outs, [ref[i] for i in idx],
                           "bf16"))
            continue
        checks.append((dg, tag, idx, outs, [local[i] for i in idx], "bf16"))
        checks.append((dg, tag + "_monolithic", idx, outs,
                       [ref[i] for i in idx], "f32"))
    model = m32 = None
    for rec, tag, idx, outs, want, rule in checks:
        ps = [prompts[i] for i in idx]
        if ([np.asarray(o).tolist() for o in outs]
                == [np.asarray(w).tolist() for w in want]):
            rec.setdefault("first_splits", {})[tag] = None
            continue
        if model is None:
            model = fleet_model(torch, dev)
        if rule == "bf16":
            got = check_streams(torch, np, model, ps, outs, want,
                                f"{tag}: against the single Server")
            rec.setdefault("first_splits", {})[tag] = list(got)
            continue
        if m32 is None:
            m32 = f32_twin(torch, model)
        splits, rows = f32_gaps(torch, np, model, m32, ps, outs, want)
        rec.setdefault("first_splits", {})[tag] = [
            splits, [r and r["bf16_margin"] for r in rows]]
        rec.setdefault("monolithic_f32", {})[tag] = rows
        if any(r and abs(r["f32_gap"]) >= NEAR_TIE for r in rows):
            raise AssertionError(f"{tag}: the front parts from the single "
                                 f"Server where fp32 separates the two "
                                 f"tokens by {NEAR_TIE} or more: {rows}")
    del model, m32
    free_cuda(torch)
    return fl, dg


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


# -- phase 9: the tensor surface on the card ---------------------------------

# the sweep's shapes: elementwise ops, reductions and manipulation at an odd
# width; sort, search and top-k over fp32 logits of the Llama vocabulary;
# linalg at one 256 x 256 matrix and a batch of 64 of 32 x 32
SWEEP = dict(rows=64, cols=257, logits=(8, 32000), mat=256, batch=(64, 32),
             rank=200)
# the card against its CPU twin, |card - cpu| <= atol + rtol |cpu|: fp32 as
# the CPU tests (rtol 1e-5, atol 1e-6), special functions rtol 1e-4, atol
# 1e-5; a sum, scan or product over K terms adds K fp32 roundings of the
# largest output to atol and rtol (the two devices add in other orders);
# linalg at K = the matrix size, its factors by reconstruction
SWEEP_TOL = dict(rtol=1e-5, atol=1e-6)
SWEEP_SPECIAL = dict(rtol=1e-4, atol=1e-5)
FP32_EPS = 2.0 ** -23
# histc's bin of a value on a bin edge may differ between the devices
HIST_ATOL = 2
# the names the gradient sweep (tests/test_check_grad_sweep.py) checks: the
# card's gradient is held against the CPU twin's as well
SWEEP_GRAD = set("""
abs absolute acos acosh add add_n addmm amax amin angle as_real asin
asinh assign atan atan2 atanh bmm broadcast_to cdist ceil cholesky
cholesky_solve chunk clip clone concat cond conj copysign corrcoef cos
cosh cov crop cross cummax cummin cumprod cumsum cumulative_trapezoid
deg2rad det diag diagflat diagonal diff digamma dist divide
divide_no_nan dot eigh eigvalsh einsum erf erfinv exp expand expand_as
expm1 flatten flip floor floor_divide floor_mod fmax fmin frac gather
gather_nd heaviside hypot i0 i0e i1 i1e imag increment index_add
index_fill index_put index_sample index_select inner inv inverse kron
kthvalue ldexp lerp lgamma log log10 log1p log2 logaddexp logcumsumexp
logit logsumexp masked_fill masked_select matmul matrix_power max
maximum mean median meshgrid min minimum mm mod moveaxis multi_dot
multiplex multiply mv nan_to_num nanmean nanquantile nansum neg negative
norm outer pad pinv polygamma pow prod put_along_axis qr quantile
rad2deg real reciprocal remainder renorm repeat_interleave reshape
reverse roll rot90 round rsqrt scale scatter scatter_nd scatter_nd_add
sgn sigmoid sign sin sinh slice slogdet solve sort split sqrt square
squeeze stack stanh std strided_slice subtract sum svd swapaxes t take
take_along_axis tan tanh tensor_split tensordot tile topk trace
transpose trapezoid triangular_solve tril triu trunc unflatten unfold
unsqueeze vander var vsplit where""".split())
SPECIAL_FNS = {"digamma", "lgamma", "polygamma", "erfinv", "i0", "i0e",
               "i1", "i1e", "erf", "logit", "atanh", "acosh", "asinh"}
# 2^24 draws of each random op on the card; moments within 6 standard
# errors (mean) and 1% (standard deviation)
RANDOM_N = 1 << 24
# the tensor-API decoder layer at Llama-2-7B's widths against the port's
# kernel layer, over [1, 512] tokens
TENSOR_LAYER = dict(preset="7b", batch=1, seq=512, reps=3)


def surface_cases(torch, pt, np):
    """name -> [(fn(P, *args), args, tol)]: a case of every op of the seven
    ops modules but the random ones, on CPU tensors made from a fixed seed
    (the card runs them on copies). ``tol`` is None (fp32), "special", an
    int K (a sum of K terms), "exact", "hist" (counts within HIST_ATOL) or
    "recon" (a factorization's reconstruction and invariants, within 1e-4
    of the largest magnitude)."""
    g = torch.Generator().manual_seed(91)
    R, C = SWEEP["rows"], SWEEP["cols"]
    V, L = SWEEP["logits"]
    M, (NB, NM) = SWEEP["mat"], SWEEP["batch"]

    def nrm(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    def uni(*s, lo=0.1, hi=0.9):
        return torch.rand(*s, generator=g) * (hi - lo) + lo

    def ints(*s, lo=0, hi=6):
        return torch.randint(lo, hi, s, generator=g)

    def well(n, *batch):
        """A well-conditioned general matrix: I + G / (2 sqrt(n))."""
        return torch.eye(n) + nrm(*batch, n, n) / (2 * n ** 0.5)

    def spd(n, *batch):
        a = nrm(*batch, n, n) / n ** 0.5
        return a @ a.transpose(-1, -2) + torch.eye(n)

    x, y, yb = uni(R, C), uni(R, C, lo=0.5, hi=1.5), uni(C, lo=0.5, hi=1.5)
    s = nrm(R, C) * 3
    logits = nrm(V, L) * 4
    idx = ints(50, hi=R)
    mask = nrm(R, C) > 0
    cases = {}

    def add(name, fn, args, tol=None):
        cases.setdefault(name, []).append((fn, args, tol))

    unary_signed = {"abs", "absolute", "neg", "negative", "sign", "sgn",
                    "round", "floor", "ceil", "trunc", "frac", "square",
                    "exp", "expm1", "sin", "cos", "tan", "atan", "sinh",
                    "cosh", "tanh", "asinh", "sigmoid", "erf", "deg2rad",
                    "rad2deg", "angle", "conj", "real", "imag", "i0", "i1",
                    "i0e", "i1e", "stanh"}
    unary_pos = {"log", "log2", "log10", "log1p", "sqrt", "rsqrt",
                 "reciprocal", "acos", "asin", "atanh", "erfinv",
                 "digamma", "lgamma", "logit"}
    for name in sorted(unary_signed | unary_pos):
        add(name, lambda P, t, _n=name: getattr(P, _n)(t),
            [s if name in unary_signed else x],
            "special" if name in SPECIAL_FNS else None)
    add("acosh", lambda P, t: P.acosh(t), [x + 1.5], "special")
    add("polygamma", lambda P, t: P.polygamma(t, 1), [x + 1.0], "special")
    for name in ("add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "fmax", "fmin", "atan2", "hypot", "logaddexp",
                 "copysign", "pow", "heaviside", "divide_no_nan", "mod",
                 "remainder", "floor_mod", "floor_divide", "nextafter"):
        add(name, lambda P, a, b, _n=name: getattr(P, _n)(a, b), [s, yb],
            R)                        # yb's gradient sums R rows
        add(name, lambda P, a, b, _n=name: getattr(P, _n)(a, b),
            [x, y] if name != "pow" else [y, x])
    for name in ("gcd", "lcm"):
        add(name, lambda P, a, b, _n=name: getattr(P, _n)(a, b),
            [ints(R, C, lo=1, hi=90), ints(C, lo=1, hi=60)], "exact")
    add("ldexp", lambda P, a, b: P.ldexp(a, b), [s, ints(R, C, lo=-3, hi=4)])
    add("lerp", lambda P, a, b: P.lerp(a, b, 0.3), [s, y])
    add("scale", lambda P, t: P.scale(t, 2.0, 0.5), [s])
    add("clip", lambda P, t: P.clip(t, -1.0, 2.0), [s])
    add("stanh", lambda P, t: P.stanh(t, 0.5, 2.0), [s])
    add("multiplex", lambda P, a, b, i: P.multiplex([a, b], i),
        [s, y, ints(R, 1, hi=2)])
    add("frexp", lambda P, t: P.frexp(t), [s * 100], "exact")
    add("nan_to_num", lambda P, t: P.nan_to_num(
        P.where(t > 2.0, P.full_like(t, float("nan")), t), nan=0.5), [s])
    add("increment", lambda P, t: P.increment(P.clone(t), 2.0), [s])
    add("vander", lambda P, t: P.vander(t, 8), [uni(C)], 8)
    add("renorm", lambda P, t: P.renorm(t, 2.0, 0, 5.0), [s], C)
    for name in ("sum", "mean", "max", "min", "amax", "amin", "nansum",
                 "nanmean", "logsumexp"):
        add(name, lambda P, t, _n=name: getattr(P, _n)(t, axis=-1,
                                                       keepdim=True), [s], C)
        add(name, lambda P, t, _n=name: getattr(P, _n)(t), [s], R * C)
    add("prod", lambda P, t: P.prod(t, axis=0), [uni(R, C, lo=0.9, hi=1.1)],
        R)
    for name in ("all", "any"):
        add(name, lambda P, t, _n=name: getattr(P, _n)(t, axis=-1), [s > -3])
        add(name, lambda P, t, _n=name: getattr(P, _n)(t), [s > -3])
    add("count_nonzero", lambda P, t: P.count_nonzero(t, axis=0),
        [ints(R, C, hi=3)], "exact")
    for name in ("std", "var"):
        add(name, lambda P, t, _n=name: getattr(P, _n)(t, axis=-1), [s], C)
        add(name, lambda P, t, _n=name: getattr(P, _n)(t, unbiased=False),
            [s], R * C)
    for name in ("median", "nanmedian"):
        add(name, lambda P, t, _n=name: getattr(P, _n)(t, axis=-1), [s])
        add(name, lambda P, t, _n=name: getattr(P, _n)(t[:, :-1], axis=-1),
            [s])                                  # an even count
    add("quantile", lambda P, t: P.quantile(t, [0.1, 0.5, 0.9], axis=-1),
        [s])
    add("nanquantile", lambda P, t: P.nanquantile(t, 0.3, axis=0), [s])
    for name in ("cumsum", "logcumsumexp"):
        add(name, lambda P, t, _n=name: getattr(P, _n)(t, axis=-1), [s], C)
    add("cumprod", lambda P, t: P.cumprod(t, dim=1),
        [uni(R, C, lo=0.95, hi=1.05)], C)
    for name in ("cummax", "cummin"):
        add(name, lambda P, t, _n=name: getattr(P, _n)(t, axis=-1), [s])
    add("addmm", lambda P, i, a, b: P.addmm(i, a, b), [nrm(R, R), s, s.T], C)
    add("inner", lambda P, a, b: P.inner(a, b), [s, y], C)
    add("outer", lambda P, a, b: P.outer(a, b), [s[0], y[0]], C)
    add("kron", lambda P, a, b: P.kron(a, b), [s[:8, :8], y[:4, :4]], R)
    add("trace", lambda P, t: P.trace(t, offset=3), [s], R)
    add("diff", lambda P, t: P.diff(t, axis=-1), [s], 4)
    add("diff", lambda P, t: P.diff(t, n=2, axis=0, prepend=1.0), [s], 4)
    add("trapezoid", lambda P, t: P.trapezoid(t, axis=-1), [s], C)
    add("cumulative_trapezoid", lambda P, t: P.cumulative_trapezoid(
        t, axis=-1), [s], C)
    add("add_n", lambda P, a, b: P.add_n([a, b, a]), [s, y])
    # creation, on the default place (the card) and its CPU twin
    add("zeros", lambda P: P.zeros([R, C]), [])
    add("ones", lambda P: P.ones([R, C], dtype="int32"), [])
    add("full", lambda P: P.full([R, C], 1.5), [])
    add("empty", lambda P: P.empty([R, C]).shape, [], "exact")
    add("zeros_like", lambda P, t: P.zeros_like(t), [s])
    add("ones_like", lambda P, t: P.ones_like(t, dtype="bfloat16"), [s])
    add("full_like", lambda P, t: P.full_like(t, 7), [s])
    add("empty_like", lambda P, t: P.empty_like(t).shape, [s], "exact")
    add("arange", lambda P: P.arange(0, C, 3), [])
    add("arange", lambda P: P.arange(0.0, 1.0, 0.125), [])
    add("linspace", lambda P: P.linspace(-1, 1, C), [])
    add("logspace", lambda P: P.logspace(0, 3, 17, base=2.0), [])
    add("eye", lambda P: P.eye(R, C), [])
    add("diag", lambda P, t: P.diag(t), [s])
    add("diag", lambda P, t: P.diag(t, offset=1, padding_value=2.0), [s[0]])
    add("diagflat", lambda P, t: P.diagflat(t), [s[0]])
    add("tril", lambda P, t: P.tril(t, -1), [s])
    add("triu", lambda P, t: P.triu(t, 2), [s])
    add("meshgrid", lambda P, a, b: P.meshgrid(a, b), [s[0], y[0]], C)
    add("assign", lambda P, t: P.assign(t), [s])
    add("clone", lambda P, t: P.clone(t), [s])
    add("to_tensor", lambda P: P.to_tensor([[1.5, 2.0], [3.0, 4.0]]), [])
    add("tril_indices", lambda P: P.tril_indices(R, C, 1), [], "exact")
    add("triu_indices", lambda P: P.triu_indices(R, C, -1), [], "exact")
    add("one_hot", lambda P, t: P.one_hot(t, C), [ints(R, hi=C)])
    add("complex", lambda P, a, b: P.complex(a, b), [s, y])
    add("polar", lambda P, a, b: P.polar(a, b), [y, s])
    add("create_tensor", lambda P: P.create_tensor("float32"), [])
    add("create_parameter", lambda P: P.create_parameter(
        [R, C], "float32",
        default_initializer=P.nn.initializer.Constant(0.5)), [], "exact")
    # manipulation
    v3 = nrm(4, 16, C)
    add("reshape", lambda P, t: P.reshape(t, [C, -1]), [s])
    add("reshape_", lambda P, t: P.reshape_(P.clone(t), [-1]), [s])
    add("flatten", lambda P, t: P.flatten(t, 1, -1), [v3])
    add("unflatten", lambda P, t: P.unflatten(t, 0, [8, 8]), [s])
    add("squeeze", lambda P, t: P.squeeze(P.unsqueeze(t, [0, -1]), [0, -1]),
        [s])
    add("unsqueeze", lambda P, t: P.unsqueeze(t, [-1, 0]), [s])
    add("transpose", lambda P, t: P.transpose(t, [2, 0, 1]), [v3])
    add("moveaxis", lambda P, t: P.moveaxis(t, -1, 0), [v3])
    add("swapaxes", lambda P, t: P.swapaxes(t, 0, -1), [v3])
    add("t", lambda P, t: P.t(t), [s])
    add("concat", lambda P, a, b: P.concat([a, b], axis=-1), [s, y])
    add("stack", lambda P, a, b: P.stack([a, b], axis=-1), [s, y])
    add("unstack", lambda P, t: P.unstack(t, axis=1), [v3])
    add("unbind", lambda P, t: P.unbind(t, axis=0), [v3])
    add("split", lambda P, t: P.split(t, [100, -1, 7], axis=-1), [s])
    add("chunk", lambda P, t: P.chunk(t, 4, axis=0), [s])
    add("tensor_split", lambda P, t: P.tensor_split(t, 3, axis=-1), [s])
    add("vsplit", lambda P, t: P.vsplit(t, 2), [s])
    add("tile", lambda P, t: P.tile(t, [2, 1]), [s], 2)
    add("expand", lambda P, t: P.expand(t, [3, R, C]), [s], 3)
    add("expand_as", lambda P, a, b: P.expand_as(a, b), [yb, s], R)
    add("broadcast_to", lambda P, t: P.broadcast_to(t, [R, C]), [yb], R)
    add("broadcast_tensors", lambda P, a, b: P.broadcast_tensors([a, b]),
        [s[:, :1], yb])
    add("broadcast_shape", lambda P: P.broadcast_shape([R, 1], [1, C]), [],
        "exact")
    add("flip", lambda P, t: P.flip(t, [0, -1]), [s])
    add("reverse", lambda P, t: P.reverse(t, 1), [s])
    add("rot90", lambda P, t: P.rot90(t, 3), [s])
    add("roll", lambda P, t: P.roll(t, 5, axis=-1), [s])
    add("gather", lambda P, t, i: P.gather(t, i, axis=0), [s, idx], 50)
    add("gather_nd", lambda P, t, i: P.gather_nd(t, i),
        [s, torch.stack([ints(40, hi=R), ints(40, hi=C)], -1)], 40)
    add("scatter", lambda P, t, i, u: P.scatter(t, i, u),
        [s, torch.randperm(R, generator=g)[:20], nrm(20, C)])
    add("scatter", lambda P, t, i, u: P.scatter(t, i, u, overwrite=False),
        [s, idx, nrm(50, C)], 50)
    add("scatter_nd_add", lambda P, t, i, u: P.scatter_nd_add(t, i, u),
        [s, idx[:, None], nrm(50, C)], 50)
    add("scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [R, C]),
        [idx[:, None], nrm(50, C)], 50)
    add("index_select", lambda P, t, i: P.index_select(t, i, axis=-1),
        [s, ints(30, hi=C)], 30)
    add("index_sample", lambda P, t, i: P.index_sample(t, i),
        [s, ints(R, 9, hi=C)], 9)
    add("index_add", lambda P, t, i, u: P.index_add(t, i, 0, u),
        [s, idx, nrm(50, C)], 50)
    add("index_put", lambda P, t, i, u: P.index_put(t, [i], u, True),
        [s, idx, nrm(50, C)], 50)
    add("index_fill", lambda P, t, i: P.index_fill(t, i, 1, -2.0),
        [s, ints(10, hi=C)])
    add("index_fill_", lambda P, t, i: P.index_fill_(P.clone(t), i, 0, 3.0),
        [s, idx])
    add("take_along_axis", lambda P, t, i: P.take_along_axis(t, i, axis=-1),
        [s, ints(R, 11, hi=C)], 11)
    add("put_along_axis", lambda P, t, i, u: P.put_along_axis(
        t, i, u, axis=-1), [s, torch.argsort(nrm(R, C), -1)[:, :11],
                            nrm(R, 11)])
    add("put_along_axis", lambda P, t, i: P.put_along_axis(
        t, i, 1.0, axis=0, reduce="add"), [s, ints(5, C, hi=R)], 5)
    add("slice", lambda P, t: P.slice(t, [0, 1], [3, -100], [40, 250]), [s])
    add("strided_slice", lambda P, t: P.strided_slice(
        t, [0, 1], [R - 1, 200], [0, 3], [-2, -5]), [s])
    add("crop", lambda P, t: P.crop(t, [10, -1], [5, 100]), [s])
    add("pad", lambda P, t: P.pad(t, [1, 2, 3, 4]), [s])
    add("pad", lambda P, t: P.pad(t, [2, 3], mode="reflect"), [v3], 4)
    add("pad", lambda P, t: P.pad(t, [1, 1, 2, 2], mode="replicate"),
        [v3[None]], 4)
    add("pad", lambda P, t: P.pad(t, [3, 1], mode="circular",
                                  data_format="NLC"), [v3], 4)
    add("repeat_interleave", lambda P, t: P.repeat_interleave(t, 3, 0), [s],
        3)
    add("as_strided", lambda P, t: _raises(NotImplementedError, P.as_strided,
                                           t, [2], [1]), [s], "exact")
    add("view", lambda P, t: P.view(t, [C, R]), [s])
    add("view", lambda P, t: P.view(t, "int32"), [s], "exact")
    add("view_as", lambda P, a, b: P.view_as(a, b), [s, s.T])
    add("unfold", lambda P, t: P.unfold(t, 1, 16, 8), [s], 2)
    add("masked_fill", lambda P, t, m: P.masked_fill(t, m, 0.5), [s, mask])
    add("masked_select", lambda P, t, m: P.masked_select(t, m), [s, mask])
    add("where", lambda P, c, a, b: P.where(c, a, b), [mask, s, yb], R)
    add("where", lambda P, c: P.where(c), [mask], "exact")
    add("numel", lambda P, t: P.numel(t), [s], "exact")
    add("rank", lambda P, t: P.rank(t), [v3], "exact")
    add("shape", lambda P, t: P.shape(t), [v3], "exact")
    add("shard_index", lambda P, t: P.shard_index(t, 32000, 4, 2),
        [ints(R, C, hi=32000)], "exact")
    add("cast", lambda P, t: P.cast(t, "bfloat16"), [s])
    add("cast", lambda P, t: P.cast(t, "int64"), [s * 10], "exact")
    add("take", lambda P, t, i: P.take(t, i, mode="wrap"),
        [s, ints(100, lo=-R * C, hi=2 * R * C)], 100)
    add("diagonal", lambda P, t: P.diagonal(t, 2, 0, -1), [v3])
    add("as_complex", lambda P, t: P.as_complex(t),
        [s[:, :2 * (C // 2)].reshape(R, -1, 2)])
    add("as_real", lambda P, a, b: P.as_real(P.complex(a, b)), [s, y])
    # logic
    for name in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal"):
        add(name, lambda P, a, b, _n=name: getattr(P, _n)(a, b),
            [torch.round(s), torch.round(yb)], "exact")
    for name in ("logical_and", "logical_or", "logical_xor"):
        add(name, lambda P, a, b, _n=name: getattr(P, _n)(a, b),
            [mask, yb > 1], "exact")
    for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        add(name, lambda P, a, b, _n=name: getattr(P, _n)(a, b),
            [ints(R, C, hi=1 << 20), ints(C, hi=1 << 20)], "exact")
    add("logical_not", lambda P, t: P.logical_not(t), [mask], "exact")
    add("bitwise_not", lambda P, t: P.bitwise_not(t), [ints(R, C, hi=99)],
        "exact")
    inf = torch.where(mask, s, torch.tensor([float("inf"), float("nan"),
                                             -float("inf")]).repeat(C)[:C])
    for name in ("isnan", "isinf", "isfinite"):
        add(name, lambda P, t, _n=name: getattr(P, _n)(t), [inf], "exact")
    add("equal_all", lambda P, a, b: (P.equal_all(a, b), P.equal_all(a, a)),
        [s, y], "exact")
    add("allclose", lambda P, a, b: P.allclose(a, a + 1e-7), [s, y], "exact")
    add("isclose", lambda P, a, b: P.isclose(a, b, atol=0.5), [s, y],
        "exact")
    add("is_empty", lambda P, t: (P.is_empty(t), P.is_empty(t[:0])), [s],
        "exact")
    add("isin", lambda P, a, b: P.isin(a, b),
        [ints(R, C, hi=500), ints(100, hi=500)], "exact")
    add("is_complex", lambda P, t: P.is_complex(t), [s], "exact")
    add("is_floating_point", lambda P, t: P.is_floating_point(t), [s],
        "exact")
    add("is_integer", lambda P, t: P.is_integer(t), [idx], "exact")
    # search, sort and top-k over the vocabulary's logits
    add("argmax", lambda P, t: P.argmax(t, axis=-1), [logits], "exact")
    add("argmax", lambda P, t: P.argmax(t), [logits], "exact")
    add("argmin", lambda P, t: P.argmin(t, axis=-1, keepdim=True), [logits],
        "exact")
    add("argsort", lambda P, t: P.argsort(t, descending=True), [logits],
        "exact")
    add("sort", lambda P, t: P.sort(t, axis=-1), [logits])
    add("topk", lambda P, t: P.topk(t, 50), [logits])
    add("topk", lambda P, t: P.topk(t, 20, largest=False), [logits])
    add("kthvalue", lambda P, t: P.kthvalue(t, 1000, axis=-1), [logits])
    add("mode", lambda P, t: P.mode(P.round(t), axis=-1), [logits])
    add("nonzero", lambda P, t: P.nonzero(t > 9.0), [logits], "exact")
    add("masked_select", lambda P, t: P.masked_select(t, t > 9.0), [logits])
    srt = torch.sort(logits[0]).values
    add("searchsorted", lambda P, a, b: P.searchsorted(a, b, right=True),
        [srt, logits[1:]], "exact")
    add("bucketize", lambda P, a, b: P.bucketize(a, b), [logits, srt],
        "exact")
    add("unique", lambda P, t: P.unique(P.round(t), return_index=True,
                                        return_inverse=True,
                                        return_counts=True), [logits],
        "exact")
    add("unique_consecutive", lambda P, t: P.unique_consecutive(
        P.round(t), return_inverse=True, return_counts=True), [logits],
        "exact")
    # linalg: [256, 256] and a batch [64, 32, 32]
    A, B = well(M), nrm(M, 8)
    Ab, Bb = well(NM, NB), nrm(NB, NM, 4)
    S, Sb = spd(M), spd(NM, NB)
    for a, b, k in ((A, B, M), (Ab, Bb, NM)):
        add("matmul", lambda P, p, q: P.matmul(p, q, transpose_x=True),
            [a, a], k)
        add("mm", lambda P, p, q: P.mm(p, q), [a, b], k)
        add("bmm", lambda P, p, q: P.bmm(p, q), [a, b], k)
        add("solve", lambda P, p, q: P.solve(p, q), [a, b], k)
        add("inverse", lambda P, p: P.inverse(p), [a], k)
        add("inv", lambda P, p: P.inv(p), [a], k)
        add("det", lambda P, p: P.det(p), [a], k)
        add("slogdet", lambda P, p: P.slogdet(p), [a], k)
        add("matrix_power", lambda P, p: P.matrix_power(p, 3), [a], k)
        add("pinv", lambda P, p: P.pinv(p), [a], k)
        add("cond", lambda P, p: P.cond(p), [a], k)
        add("matrix_rank", lambda P, p: P.matrix_rank(p), [a], "exact")
        add("norm", lambda P, p: P.norm(p, p="fro", axis=[-2, -1]), [a], k)
        add("norm", lambda P, p: P.norm(p, p=2, axis=[-2, -1]), [a], k)
        add("cholesky", lambda P, p: P.cholesky(p), [S if k == M else Sb], k)
        add("cholesky_solve", lambda P, q, p: P.cholesky_solve(
            q, P.cholesky(p)), [b, S if k == M else Sb], k)
        add("triangular_solve", lambda P, p, q: P.triangular_solve(
            P.triu(p), q), [a, b], k)
        add("eigvalsh", lambda P, p: P.eigvalsh(p), [S if k == M else Sb], k)
        add("lu", lambda P, p: P.lu(p), [a], k)
        add("householder_product", lambda P, p, q: P.householder_product(
            p, q), [a[:, :8] if k == M else a,
                    uni(8, lo=0.0, hi=1.0) if k == M else uni(NB, NM,
                                                               lo=0.0,
                                                               hi=1.0)], k)
        for name in ("qr", "svd", "eigh", "eig", "eigvals", "lu_unpack"):
            add(name, _recon(name), [S if name == "eigh" and k == M else
                                     Sb if name == "eigh" else a], "recon")
    add("dot", lambda P, p, q: P.dot(p, q), [s, y], C)
    add("mv", lambda P, p, q: P.mv(p, q), [A, B[:, 0]], M)
    add("multi_dot", lambda P, p, q, r: P.multi_dot([p, q, r]),
        [A, A, B], 2 * M)
    add("einsum", lambda P, p, q: P.einsum("bij,bjk->bik", p, q),
        [Ab, Bb], NM)
    add("tensordot", lambda P, p, q: P.tensordot(p, q, 1), [A, B], M)
    add("norm", lambda P, t: P.norm(t, p=3, axis=-1), [s], C)
    add("dist", lambda P, p, q: P.dist(p, q, 1), [s, y], R * C)
    add("cross", lambda P, p, q: P.cross(p, q, axis=-1), [nrm(R, 3),
                                                          nrm(R, 3)])
    add("cdist", lambda P, p, q: P.cdist(p, q), [nrm(R, 16), nrm(40, 16)], 16)
    add("histogram", lambda P, t: P.histogram(t, bins=32), [s], "hist")
    add("bincount", lambda P, t: P.bincount(t, minlength=100),
        [ints(R * C, hi=90)], "exact")
    add("corrcoef", lambda P, t: P.corrcoef(t), [s[:16]], C)
    add("cov", lambda P, t: P.cov(t, rowvar=False), [s[:, :16]], R)
    # rank 200: singular values in [1, 2] and 56 zeros
    r = SWEEP["rank"]
    qa, _ = torch.linalg.qr(nrm(M, M))
    qb, _ = torch.linalg.qr(nrm(M, M))
    rd = (qa[:, :r] * uni(r, lo=1.0, hi=2.0)) @ qb[:, :r].T
    add("lstsq", lambda P, p, q: P.lstsq(p, q), [rd, nrm(M, 4)], "recon")
    add("lstsq", lambda P, p, q: P.lstsq(p, q), [A, B], "recon")
    return cases


def _raises(exc, fn, *args):
    try:
        fn(*args)
    except exc:
        return True
    return False


def _recon(name):
    """A factorization whose factors are free up to signs, phases or
    order, as a function returning what is unique: the reconstruction of
    the input from the factors and the factors' invariants."""
    def fn(P, a):
        import torch

        if name == "qr":
            q, r = P.qr(a)
            return q @ r, q.transpose(-1, -2) @ q, torch.abs(
                torch.diagonal(r, dim1=-2, dim2=-1))
        if name == "svd":
            u, s, vh = P.svd(a)
            return (u * s[..., None, :]) @ vh, u.transpose(-1, -2) @ u, s
        if name == "eigh":
            w, v = P.eigh(a)
            return a @ v - v * w[..., None, :], w
        if name == "eig":
            w, v = P.eig(a)
            ac = a.to(v.dtype)
            return torch.abs(ac @ v - v * w[..., None, :]), \
                torch.sort(torch.abs(w), -1).values
        if name == "eigvals":
            return torch.sort(torch.abs(P.eigvals(a)), -1).values
        p, l_, u = P.lu_unpack(*P.lu(a))
        return p @ l_ @ u
    return fn


def _tensors(x):
    """Every tensor in a nested output, in order; other leaves as they
    are."""
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return [x]


def _sweep_tol(tol, want):
    scale = max(float(want.abs().max()), 1.0)
    if tol == "bf16":
        return dict(rtol=NN_BF16_REL,
                    atol=NN_BF16_TOP * float(want.abs().max()))
    if tol == "special":
        return SWEEP_SPECIAL
    if tol == "recon":
        return dict(rtol=1e-4, atol=1e-4 * scale)
    if tol == "tf32":
        return dict(rtol=TF32_SWEEP["rtol"],
                    atol=TF32_SWEEP["top"] * float(want.abs().max()))
    if isinstance(tol, int):
        return dict(rtol=max(1e-5, 4 * tol * FP32_EPS),
                    atol=1e-6 + 4 * tol * FP32_EPS * scale)
    return SWEEP_TOL


def sweep_compare(torch, name, got, want, tol, dev):
    """The card's output against the CPU twin's; raises unless every
    tensor of it lies on ``dev``. Returns the largest |error| of a float
    output (0 for exact ones)."""
    g, w = _tensors(got), _tensors(want)
    if len(g) != len(w):
        raise AssertionError(f"sweep {name}: {len(g)} outputs on the card, "
                             f"{len(w)} on the CPU")
    worst = 0.0
    for a, b in zip(g, w):
        if not isinstance(a, torch.Tensor):
            if a != b:
                raise AssertionError(f"sweep {name}: {a!r} != {b!r}")
            continue
        if a.device != dev:
            raise AssertionError(f"sweep {name}: an output on {a.device}, "
                                 f"not {dev}")
        a, b = a.detach().cpu(), b.detach()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"sweep {name}: {a.shape} {a.dtype} on the "
                                 f"card, {b.shape} {b.dtype} on the CPU")
        if tol == "hist":
            if a.numel() and float((a - b).abs().max()) > HIST_ATOL:
                raise AssertionError(f"sweep {name}: counts differ by more "
                                     f"than {HIST_ATOL}")
            continue
        if not (a.is_floating_point() or a.is_complex()) or tol == "exact":
            if not torch.equal(a, b):
                raise AssertionError(f"sweep {name}: exact outputs differ")
            continue
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        a, b = a.double(), b.double()
        if a.numel() == 0:
            continue
        t = _sweep_tol(tol, b)
        nan = torch.isnan(a) | torch.isnan(b)
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            raise AssertionError(f"sweep {name}: NaNs differ")
        err = (a - b).abs().masked_fill(nan, 0)
        inf_same = torch.isinf(b) & (a == b)
        err = err.masked_fill(inf_same, 0)
        bad = err > t["atol"] + t["rtol"] * b.abs().masked_fill(nan, 0)
        if bad.any():
            raise AssertionError(
                f"sweep {name}: {int(bad.sum())} elements past atol "
                f"{t['atol']:.3g} + rtol {t['rtol']:.3g} |cpu|, max |err| "
                f"{float(err.max()):.3g}")
        worst = max(worst, float(err.max()))
    return worst


class _cpu_place:
    """Make the CPU the current place for a CPU twin's creation ops and put
    the card's default back after."""

    def __enter__(self):
        from paddle_tpu_torch.core import place

        self.prev = place._current[0]
        place.set_device("cpu")

    def __exit__(self, *exc):
        from paddle_tpu_torch.core import place

        place._current[0] = self.prev
        return False


def _leaves(torch, args, dev, grad):
    out = []
    for a in args:
        t = a.to(dev) if isinstance(a, torch.Tensor) else a
        if grad and isinstance(t, torch.Tensor) and t.is_floating_point():
            t = t.clone().requires_grad_()
        out.append(t)
    return out


def _grads(torch, pt, out, leaves):
    """The gradients of sum(out * w) (w a fixed ramp) with respect to the
    float leaves; zeros for a leaf the graph leaves unused."""
    ts = [t for t in _tensors(out) if isinstance(t, torch.Tensor)]
    out = ts[0]
    if not (out.is_floating_point() and out.requires_grad):
        return None
    w = torch.linspace(-1, 1, out.numel(), dtype=out.dtype,
                       device=out.device).reshape(out.shape)
    fl = [t for t in leaves if isinstance(t, torch.Tensor)
          and t.requires_grad]
    gs = pt.grad(pt.sum(out * w), fl, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(fl, gs)]


def surface_sweep(torch, pt, np, dev):
    """Every op of the seven ops modules but the random ones, on CUDA
    tensors on the default place, against the same op on CPU copies (the
    CPU twin's creation ops under ``set_device("cpu")``); the gradient sweep's
    names by their gradients as well. Returns counts, the largest errors by
    name and the seconds."""
    from paddle_tpu_torch.ops import (creation, linalg, logic, manipulation,
                                      math, random, search)

    t0 = time.perf_counter()
    cases = surface_cases(torch, pt, np)
    names = {n for m in (creation, math, manipulation, logic, search, linalg)
             for n in m.__all__} - {"pca_lowrank"}
    missing = sorted(names - set(cases))
    if missing or set(cases) - names:
        raise AssertionError(f"sweep: no case for {missing}, or cases of "
                             f"unknown ops {sorted(set(cases) - names)}")
    worst, n_cases, n_grads = {}, 0, 0
    for name in sorted(cases):
        for i, (fn, args, tol) in enumerate(cases[name]):
            grad = name in SWEEP_GRAD and tol not in ("exact", "recon")
            card_in = _leaves(torch, args, dev, grad)
            got = fn(pt, *card_in)
            with _cpu_place():
                cpu_in = _leaves(torch, args, torch.device("cpu"), grad)
                want = fn(pt, *cpu_in)
            err = sweep_compare(torch, f"{name}[{i}]", got, want, tol, dev)
            if grad:
                g_card = _grads(torch, pt, got, card_in)
                g_cpu = _grads(torch, pt, want, cpu_in)
                if (g_card is None) != (g_cpu is None):
                    raise AssertionError(f"sweep {name}[{i}]: a gradient on "
                                         f"one device only")
                if g_card is not None:
                    err = max(err, sweep_compare(
                        torch, f"{name}[{i}] grad", g_card, g_cpu,
                        tol if tol is not None else 1, dev))
                    n_grads += 1
            worst[name] = max(worst.get(name, 0.0), err)
            n_cases += 1
    torch.cuda.synchronize()
    return {"ops": len(cases), "cases": n_cases, "grad_cases": n_grads,
            "max_abs_err": worst, "s": time.perf_counter() - t0}


RANDOM_OPS = {
    # name: (draw, mean, std) of the distribution drawn
    "rand": (lambda pt, n: pt.rand([n]), 0.5, (1 / 12) ** 0.5),
    "randn": (lambda pt, n: pt.randn([n]), 0.0, 1.0),
    "standard_normal": (lambda pt, n: pt.standard_normal([n]), 0.0, 1.0),
    "uniform": (lambda pt, n: pt.uniform([n], min=-2.0, max=3.0), 0.5,
                (25 / 12) ** 0.5),
    "uniform_": (lambda pt, n: pt.uniform_(pt.zeros([n]), 0.0, 2.0), 1.0,
                 (4 / 12) ** 0.5),
    "normal": (lambda pt, n: pt.normal(1.0, 2.0, [n]), 1.0, 2.0),
    "normal_like": (lambda pt, n: pt.normal_like(pt.zeros([n]), -1.0, 0.5),
                    -1.0, 0.5),
    "rand_like": (lambda pt, n: pt.rand_like(pt.zeros([n])), 0.5,
                  (1 / 12) ** 0.5),
    "randn_like": (lambda pt, n: pt.randn_like(pt.zeros([n])), 0.0, 1.0),
    "exponential_": (lambda pt, n: pt.exponential_(pt.zeros([n]), 2.0), 0.5,
                     0.5),
    "randint": (lambda pt, n: pt.randint(0, 10, [n]), 4.5, (99 / 12) ** 0.5),
    "randint_like": (lambda pt, n: pt.randint_like(pt.zeros([n]), 0, 10),
                     4.5, (99 / 12) ** 0.5),
    "randperm": (lambda pt, n: pt.randperm(n), None, None),
    "poisson": (lambda pt, n: pt.poisson(pt.full([n], 3.0)), 3.0, 3 ** 0.5),
    "bernoulli": (lambda pt, n: pt.bernoulli(pt.full([n], 0.3)), 0.3,
                  (0.21) ** 0.5),
    "multinomial": (lambda pt, n: pt.multinomial(
        pt.to_tensor([0.1, 0.2, 0.7]), n // 16, replacement=True), 1.6,
        (0.44) ** 0.5),
    "pca_lowrank": (lambda pt, n: pt.pca_lowrank(pt.randn([512, 64]), q=8)[1],
                    None, None),
}


def random_on_card(torch, pt, dev):
    """Each random op twice after ``seed``: bitwise equal draws, on the
    card; 2^24 draws (2^20 for multinomial) with the mean within 6 standard
    errors and the standard deviation within 1% of the distribution's."""
    from paddle_tpu_torch.ops import random as rmod

    t0 = time.perf_counter()
    if set(RANDOM_OPS) != set(rmod.__all__) | {"pca_lowrank"}:
        raise AssertionError("random: the checked ops are not the module's")
    before = torch.cuda.get_rng_state()
    moments = {}
    for name, (draw, mean, std) in sorted(RANDOM_OPS.items()):
        pt.seed(2024)
        a = draw(pt, RANDOM_N)
        pt.seed(2024)
        b = draw(pt, RANDOM_N)
        if a.device != dev or not torch.equal(a, b):
            raise AssertionError(f"random {name}: on {a.device}, or two "
                                 f"draws after one seed differ")
        if name == "randperm":
            if not torch.equal(torch.sort(a).values,
                               torch.arange(RANDOM_N, device=dev)):
                raise AssertionError("randperm: not a permutation")
            continue
        if mean is None:
            continue
        v = a.double()
        m, sd = float(v.mean()), float(v.std())
        se = std / v.numel() ** 0.5
        moments[name] = {"mean": m, "std": sd}
        if abs(m - mean) > 6 * se or abs(sd / std - 1) > 0.01:
            raise AssertionError(f"random {name}: mean {m} std {sd}, the "
                                 f"distribution's {mean} and {std}")
    if not torch.equal(torch.cuda.get_rng_state(), before):
        raise AssertionError("random: seed moved torch's CUDA generator")
    torch.cuda.synchronize()
    return {"draws": RANDOM_N, "moments": moments,
            "s": time.perf_counter() - t0}


def _decoder_layer(P, x, w, cos, sin, n_heads, eps):
    """One Llama decoder layer with only the tensor surface's names (the
    CPU test's ``decoder_layer``, tests/test_torch_tensor_core.py): RMSNorm,
    RoPE and the softmax in fp32, the products in x's dtype."""
    dt = x.dtype
    b, s, h = x.shape
    d = h // n_heads

    def rms(t, g):
        tf = P.cast(t, "float32")
        y = tf * P.rsqrt(P.mean(P.multiply(tf, tf), axis=-1, keepdim=True)
                         + eps)
        return P.cast(y * P.cast(g, "float32"), dt)

    def rope(t):
        t1, t2 = P.split(P.cast(t, "float32"), 2, axis=-1)
        c = P.reshape(P.cast(cos, "float32"), [1, s, 1, d // 2])
        sn = P.reshape(P.cast(sin, "float32"), [1, s, 1, d // 2])
        return P.cast(P.concat([t1 * c - t2 * sn, t2 * c + t1 * sn],
                               axis=-1), dt)

    def heads(t):
        return P.transpose(P.reshape(t, [b, s, n_heads, d]), [0, 2, 1, 3])

    hn = rms(x, w["ln1"])
    q = rope(P.reshape(P.matmul(hn, w["wq"]), [b, s, n_heads, d]))
    k = rope(P.reshape(P.matmul(hn, w["wk"]), [b, s, n_heads, d]))
    q, k = P.transpose(q, [0, 2, 1, 3]), P.transpose(k, [0, 2, 1, 3])
    v = heads(P.matmul(hn, w["wv"]))
    scores = P.matmul(P.cast(q, "float32"), P.cast(k, "float32"),
                      transpose_y=True) * (1.0 / float(d) ** 0.5)
    causal = P.cast(P.tril(P.ones([s, s], dtype="float32")), "bool")
    scores = P.where(causal, scores, P.full([s, s], -1e30, dtype="float32"))
    e = P.exp(scores - P.max(scores, axis=-1, keepdim=True))
    p = P.cast(e / P.sum(e, axis=-1, keepdim=True), dt)
    ctx = P.reshape(P.transpose(P.matmul(p, v), [0, 2, 1, 3]), [b, s, h])
    x = x + P.matmul(ctx, w["wo"])
    hn = rms(x, w["ln2"])
    g = P.matmul(hn, w["wg"])
    act = P.multiply(P.multiply(g, P.sigmoid(g)), P.matmul(hn, w["wu"]))
    return x + P.matmul(act, w["wd"])


def _event_ms(torch, fn, reps):
    """Median device ms of ``fn`` over ``reps`` calls after one warm-up,
    each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def layer_setup(torch, dev, seed):
    """Phase 9's Llama-2-7B decoder layer: the port's model layer from
    random weights made from ``seed`` (RMSNorm gains moved off 1), the
    bf16 input [1, 512], the gradient weight and the RoPE tables."""
    from paddle_tpu_torch import LlamaForCausalLM, llama_config

    cfg = llama_config(TENSOR_LAYER["preset"], num_hidden_layers=1,
                       dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = LlamaForCausalLM(cfg, device=dev, generator=gen)
    layer = model.model.layers[0]
    with torch.no_grad():
        for norm in (layer.input_layernorm, layer.post_attention_layernorm):
            norm.weight.add_(0.1 * torch.randn(norm.weight.shape,
                                               generator=gen, device=dev))
    parts = {"wq": layer.self_attn.q_proj, "wk": layer.self_attn.k_proj,
             "wv": layer.self_attn.v_proj, "wo": layer.self_attn.o_proj,
             "wg": layer.mlp.gate_proj, "wu": layer.mlp.up_proj,
             "wd": layer.mlp.down_proj, "ln1": layer.input_layernorm,
             "ln2": layer.post_attention_layernorm}
    w16 = {k: m.weight.detach() for k, m in parts.items()}
    b, s = TENSOR_LAYER["batch"], TENSOR_LAYER["seq"]
    x16 = torch.randn(b, s, cfg.hidden_size, generator=gen,
                      device=dev).to(torch.bfloat16)
    gw = torch.randn(b, s, cfg.hidden_size, generator=gen, device=dev)
    cos, sin = model.model._tables(s, x16)
    return dict(cfg=cfg, model=model, layer=layer, w16=w16, x16=x16, gw=gw,
                cos=cos, sin=sin)


def tensor_layer(torch, pt, dev, seed):
    """A Llama-2-7B decoder layer (hidden 4096, 32 heads of 128, FFN 11008,
    bf16) from random weights made from ``seed``, over [1, 512] tokens, two
    ways: the tensor-API layer (``_decoder_layer``, plain torch ops) and the
    port's own LlamaForCausalLM layer (K1, K2 and K3 forward, K5 and K6
    backward); the tensor-API layer in fp32 on the same weights is the
    yardstick of both. Output and input gradient (``paddle_tpu_torch.grad``
    of sum(out * w)): the tensor-API route's max error against the yardstick
    must be at most twice the kernel route's plus one bf16 step (2^-7 of
    the yardstick's largest magnitude). The kernel route's launches are
    counted; the tensor-API route must launch none."""
    from paddle_tpu_torch import ops

    st = layer_setup(torch, dev, seed)
    cfg, model, layer = st["cfg"], st["model"], st["layer"]
    w16, x16, gw, cos, sin = (st[k] for k in ("w16", "x16", "gw", "cos",
                                              "sin"))
    w32 = {k: v.float() for k, v in w16.items()}
    b, s = TENSOR_LAYER["batch"], TENSOR_LAYER["seq"]
    nh, eps = cfg.num_attention_heads, cfg.rms_norm_eps

    def api(xin, w):
        return _decoder_layer(pt, xin, w, cos, sin, nh, eps)

    def run(route, xin, w=None):
        xin = xin.detach().requires_grad_()
        out = (api(xin, w) if route == "api"
               else layer(xin, cos, sin))
        (g,) = pt.grad(pt.sum(out.float() * gw), [xin])
        return out.detach().float(), g.float()

    ref_out, ref_g = run("api", x16.float(), w32)
    ops.reset_launch_counts()
    api_out, api_g = run("api", x16, w16)
    api_counts = ops.launch_counts()
    ops.reset_launch_counts()
    k_out, k_g = run("kernel", x16)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    if any(api_counts.values()):
        raise AssertionError(f"tensor layer: the tensor-API route launched "
                             f"{api_counts}")
    check_launches(counts, expect(counts, rms_norm=2, fused_rope=4,
                                  flash_fwd=1, flash_bwd_dq=1,
                                  flash_bwd_dkv=1),
                   "the kernel layer, forward and backward")
    rec = {"config": f"{TENSOR_LAYER['preset']} x1 bf16, {b} x {s} tokens",
           "launches": counts}
    for what, ref, a, k in (("output", ref_out, api_out, k_out),
                            ("input_grad", ref_g, api_g, k_g)):
        if not (torch.isfinite(a).all() and torch.isfinite(k).all()):
            raise AssertionError(f"tensor layer {what}: non-finite")
        step = BF16_STEP * float(ref.abs().max())
        e_api = float((a - ref).abs().max())
        e_k = float((k - ref).abs().max())
        rec[what] = {"api_max_abs_err": e_api, "kernel_max_abs_err": e_k,
                     "bf16_step": step}
        if e_api > 2 * e_k + step:
            raise AssertionError(
                f"tensor layer {what}: the tensor-API route's max |err| "
                f"{e_api:.4g} against the fp32 yardstick exceeds twice the "
                f"kernel route's {e_k:.4g} plus one bf16 step {step:.4g}")
    reps = TENSOR_LAYER["reps"]
    rec["api_ms"] = _event_ms(torch, lambda: run("api", x16, w16), reps)
    rec["kernel_ms"] = _event_ms(torch, lambda: run("kernel", x16), reps)
    del st, model, layer, w16, w32
    torch.cuda.empty_cache()
    return rec


def pylayer_on_card(torch, pt, dev):
    """A PyLayer with a hand-written backward on CUDA tensors against the
    gradient of the plain function."""
    class Swish(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, beta):
            sg = torch.sigmoid(beta * x)
            ctx.save_for_backward(x, sg)
            ctx.beta = beta
            return x * sg

        @staticmethod
        def backward(ctx, g):
            x, sg = ctx.saved_tensor()
            return g * (sg + ctx.beta * x * sg * (1 - sg))

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(SWEEP["rows"], SWEEP["cols"], generator=gen, device=dev)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = Swish.apply(a, 1.7)
    (ga,) = pt.grad(pt.sum(out * out), [a])
    plain = b * torch.sigmoid(1.7 * b)
    (gb,) = pt.grad(pt.sum(plain * plain), [b])
    if out.device != dev or ga.device != dev:
        raise AssertionError("PyLayer: an output off the card")
    return {"out_max_abs_err": check_close(torch, "PyLayer forward", out,
                                           plain, **SWEEP_TOL),
            "grad_max_abs_err": check_close(torch, "PyLayer grad", ga, gb,
                                            **SWEEP_SPECIAL)}


def device_api_on_card(torch, pt, dev):
    """paddle.device's CUDA calls on the card: streams, events, the memory
    counters and the properties."""
    c = pt.device.cuda
    s = c.Stream()
    with c.stream_guard(s):
        y = pt.ones([1024, 1024]) * 2
        ev = c.Event(enable_timing=True)
        ev.record()
    ev.synchronize()
    c.synchronize()
    pt.device.synchronize()
    rec = {"name": c.get_device_name(), "capability": c.get_device_capability(),
           "sm": c.get_device_properties().multi_processor_count,
           "allocated": c.memory_allocated(), "reserved": c.memory_reserved(),
           "peak": c.max_memory_allocated(),
           "current_stream_is_default": c.current_stream() ==
           torch.cuda.default_stream(), "device_count": c.device_count(),
           "get_device": pt.get_device()}
    if not (float(y.sum()) == 2 * 1024 * 1024 and rec["allocated"] > 0
            and rec["name"] == torch.cuda.get_device_name(0)
            and rec["get_device"] == "gpu:0"):
        raise AssertionError(f"device API on the card: {rec}")
    return rec


def tensor_phase(torch, dev, np, seed):
    """Phase 9: the tensor surface on the card (default place, set_device
    untouched): the sweep, random repeatability and moments, PyLayer, the
    device API, and the 7B-width decoder layer of the tensor API against
    the port's kernel layer; the kernel route's launch counts are this
    slice's path."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)      # every output must land there
    rec = {"sweep": surface_sweep(torch, pt, np, dev),
           "random": random_on_card(torch, pt, dev),
           "pylayer": pylayer_on_card(torch, pt, dev),
           "device_api": device_api_on_card(torch, pt, dev)}
    rec["layer"] = tensor_layer(torch, pt, dev, seed)
    rec["launches"] = rec["layer"]["launches"]
    from paddle_tpu_torch import ops

    rec["route_calls"] = {name: 0 for name in ops.ROUTES}
    rec["s"] = time.perf_counter() - t0
    return rec


# -- phase 10: paddle.nn and paddle.io on the card ---------------------------

# the nn sweep's inputs: a spec is a shape (normal floats), ("pos", shape)
# (floats in [0.5, 1.5]), ("const", shape) (normal floats taking no
# gradient), ("ids", shape, hi) (int64 in [0, hi)) or an array as it is
S3 = (2, 3, 4)
# every function of nn.functional's activation, common, norm, extension and
# flash_attention modules: name -> [call(F, *tensors), specs]; the random
# ones in their deterministic mode (training=False), class_center_sample
# and sdp_kernel by themselves
NN_FUNCTIONS = {
    "relu": (lambda F, x: F.relu(x), [S3]),
    "relu_": (lambda F, x: F.relu_(x), [S3]),
    "relu6": (lambda F, x: F.relu6(x * 4), [S3]),
    "elu": (lambda F, x: F.elu(x, 0.7), [S3]),
    "elu_": (lambda F, x: F.elu_(x), [S3]),
    "selu": (lambda F, x: F.selu(x), [S3]),
    "celu": (lambda F, x: F.celu(x, 0.8), [S3]),
    "gelu": (lambda F, x: F.gelu(x, True) + F.gelu(x), [S3]),
    "silu": (lambda F, x: F.silu(x), [S3]),
    "swish": (lambda F, x: F.swish(x), [S3]),
    "sigmoid": (lambda F, x: F.sigmoid(x), [S3]),
    "hardsigmoid": (lambda F, x: F.hardsigmoid(x * 4), [S3]),
    "hardswish": (lambda F, x: F.hardswish(x * 4), [S3]),
    "hardtanh": (lambda F, x: F.hardtanh(x, -0.5, 0.7), [S3]),
    "hardshrink": (lambda F, x: F.hardshrink(x, 0.4), [S3]),
    "softshrink": (lambda F, x: F.softshrink(x, 0.3), [S3]),
    "tanhshrink": (lambda F, x: F.tanhshrink(x), [S3]),
    "leaky_relu": (lambda F, x: F.leaky_relu(x, 0.1), [S3]),
    "log_sigmoid": (lambda F, x: F.log_sigmoid(x), [S3]),
    "log_softmax": (lambda F, x: F.log_softmax(x, 1), [S3]),
    "maxout": (lambda F, x: F.maxout(x, 2, 1), [(2, 4, 3, 3)]),
    "prelu": (lambda F, x, w: F.prelu(x, w), [(2, 3, 4, 4), (3,)]),
    "rrelu": (lambda F, x: F.rrelu(x, 0.1, 0.3), [S3]),
    "softmax": (lambda F, x: F.softmax(x, 1), [S3]),
    "softmax_": (lambda F, x: F.softmax_(x, -1), [S3]),
    "softplus": (lambda F, x: F.softplus(x * 5, 2.0, 3.0), [S3]),
    "softsign": (lambda F, x: F.softsign(x), [S3]),
    "mish": (lambda F, x: F.mish(x), [S3]),
    "tanh": (lambda F, x: F.tanh(x), [S3]),
    "tanh_": (lambda F, x: F.tanh_(x), [S3]),
    "thresholded_relu": (lambda F, x: F.thresholded_relu(x, 0.5), [S3]),
    "glu": (lambda F, x: F.glu(x, -1), [(2, 3, 8)]),
    "gumbel_softmax": (lambda F, x: F.gumbel_softmax(x * 1e4, 0.5, True),
                       [S3]),
    "linear": (lambda F, x, w, b: F.linear(x, w, b), [S3, (4, 5), (5,)]),
    "dropout": (lambda F, x: F.dropout(x, 0.3, training=False,
                                       mode="downscale_in_infer"), [S3]),
    "dropout2d": (lambda F, x: F.dropout2d(x, training=False),
                  [(2, 3, 4, 4)]),
    "dropout3d": (lambda F, x: F.dropout3d(x, training=False),
                  [(2, 3, 2, 2, 2)]),
    "alpha_dropout": (lambda F, x: F.alpha_dropout(x, 0.3, training=False),
                      [S3]),
    "embedding": (lambda F, i, w: F.embedding(i, w, 2),
                  [("ids", (2, 5), 6), (6, 4)]),
    "one_hot": (lambda F, i: F.one_hot(i, 7), [("ids", (2, 5), 7)]),
    "pad": (lambda F, x: F.pad(x, [1, 2, 0, 1], value=0.5) .sum()
            + F.pad(x, [2, 1, 1, 0], mode="reflect").sum()
            + F.pad(x, [1, 1, 1, 1], mode="circular").sum()
            + F.pad(x, [1, 0, 2, 1], mode="replicate").sum(),
            [(1, 2, 3, 4)]),
    "zeropad2d": (lambda F, x: F.zeropad2d(x, [1, 0, 0, 2]), [(1, 2, 3, 3)]),
    "interpolate": (lambda F, x: F.interpolate(x, size=[5, 7]).sum()
                    + F.interpolate(x, size=[6, 9], mode="bilinear").sum()
                    + F.interpolate(x, scale_factor=2, mode="bicubic",
                                    align_corners=True).sum()
                    + F.interpolate(x, size=[2, 3], mode="area").sum(),
                    [(1, 2, 3, 4)]),
    "upsample": (lambda F, x: F.upsample(x, scale_factor=2), [(1, 2, 3, 4)]),
    "bilinear": (lambda F, a, b, w, c: F.bilinear(a, b, w, c),
                 [(2, 3), (2, 4), (5, 3, 4), (5,)]),
    "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b, 1),
                          [(3, 5), (3, 5)]),
    "pixel_shuffle": (lambda F, x: F.pixel_shuffle(x, 2), [(1, 8, 3, 3)]),
    "pixel_unshuffle": (lambda F, x: F.pixel_unshuffle(x, 2),
                        [(1, 2, 4, 6)]),
    "channel_shuffle": (lambda F, x: F.channel_shuffle(x, 2),
                        [(1, 4, 3, 3)]),
    "label_smooth": (lambda F, x: F.label_smooth(x, epsilon=0.2), [(2, 5)]),
    "unfold": (lambda F, x: F.unfold(x, [2, 3], 1, [1, 0, 0, 1]),
               [(1, 2, 4, 5)]),
    "fold": (lambda F, x: F.fold(x, [3, 3], 2, 1, 1), [(1, 8, 16)]),
    "batch_norm": (lambda F, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b, training=True), [(4, 3, 2, 2), ("const", (3,)),
                                        ("pos", (3,)), (3,), (3,)]),
    "layer_norm": (lambda F, x, w, b: F.layer_norm(x, [3, 4], w, b),
                   [S3, (3, 4), (3, 4)]),
    "instance_norm": (lambda F, x, w, b: F.instance_norm(x, weight=w,
                                                         bias=b),
                      [(2, 3, 4, 4), (3,), (3,)]),
    "group_norm": (lambda F, x, w, b: F.group_norm(x, 2, 1e-5, w, b),
                   [(2, 4, 3, 3), (4,), (4,)]),
    "local_response_norm": (lambda F, x: F.local_response_norm(x, 3),
                            [(2, 5, 3, 3)]),
    "normalize": (lambda F, x: F.normalize(x), [(3, 5)]),
    "pairwise_distance": (lambda F, a, b: F.pairwise_distance(a, b),
                          [(3, 5), (3, 5)]),
    "pdist": (lambda F, x: F.pdist(x), [(4, 3)]),
    "sequence_mask": (lambda F, x: F.sequence_mask(x, 6),
                      [("ids", (2, 3), 6)]),
    "diag_embed": (lambda F, x: F.diag_embed(x, 1), [(2, 3)]),
    "temporal_shift": (lambda F, x: F.temporal_shift(x, 2, 0.25),
                       [(4, 4, 2, 2)]),
    "affine_grid": (lambda F, t: F.affine_grid(t, [2, 1, 3, 4]), [(2, 2, 3)]),
    "grid_sample": (lambda F, x, g: F.grid_sample(x, g * 0.6)
                    + F.grid_sample(x, g * 0.8, mode="nearest",
                                    padding_mode="reflection",
                                    align_corners=False),
                    [(1, 2, 4, 5), (1, 3, 3, 2)]),
    "npair_loss": (lambda F, a, p, l: F.npair_loss(a, p, l),
                   [(4, 3), (4, 3), ("ids", (4,), 2)]),
    "flash_attention": (lambda F, q, k, v: F.flash_attention(
        q, k, v, causal=True)[0],
        [(2, 8, 4, 16), (2, 16, 2, 16), (2, 16, 2, 16)]),
    "flash_attn_unpadded": (lambda F, q, k, v: F.flash_attn_unpadded(
        q, k, v, torch_cu(q, [0, 4, 9]), torch_cu(q, [0, 4, 9]), 5, 5, 0.3,
        causal=True)[0], [(9, 2, 8), (9, 2, 8), (9, 2, 8)]),
    "scaled_dot_product_attention": (
        lambda F, q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, m, is_causal=True),
        [(2, 6, 2, 8), (2, 6, 2, 8), (2, 6, 2, 8), ("const", (2, 1, 6, 6))]),
    "sparse_attention": (lambda F, q, k, v: F.sparse_attention(
        q, k, v, torch_cu(q, list(range(0, 33, 2))).reshape(1, 1, 17),
        torch_cu(q, [c for i in range(16) for c in (i, (i + 3) % 16)])
        .reshape(1, 1, 32)), [(1, 1, 16, 8), (1, 1, 16, 8), (1, 1, 16, 8)]),
}
# every layer of nn.layer's activation, common, norm and container
# modules: name -> (ctor args, ctor kwargs, input specs, eval mode)
NN_LAYERS = {
    "CELU": ((0.8,), {}, [S3]), "ELU": ((0.7,), {}, [S3]),
    "GELU": ((), {}, [S3]), "GLU": ((-1,), {}, [(2, 3, 8)]),
    "Hardshrink": ((0.4,), {}, [S3]), "Hardsigmoid": ((), {}, [S3]),
    "Hardswish": ((), {}, [S3]), "Hardtanh": ((-0.5, 0.7), {}, [S3]),
    "LeakyReLU": ((0.1,), {}, [S3]), "LogSigmoid": ((), {}, [S3]),
    "LogSoftmax": ((1,), {}, [S3]), "Maxout": ((2, 1), {}, [(2, 4, 3, 3)]),
    "Mish": ((), {}, [S3]), "PReLU": ((3, 0.2), {}, [(2, 3, 4, 4)]),
    "ReLU": ((), {}, [S3]), "ReLU6": ((), {}, [S3]),
    "RReLU": ((0.1, 0.3), {}, [S3], "eval"), "SELU": ((), {}, [S3]),
    "Sigmoid": ((), {}, [S3]), "Silu": ((), {}, [S3]),
    "Softmax": ((1,), {}, [S3]), "Softplus": ((2.0, 3.0), {}, [S3]),
    "Softshrink": ((0.3,), {}, [S3]), "Softsign": ((), {}, [S3]),
    "Swish": ((), {}, [S3]), "Tanh": ((), {}, [S3]),
    "Tanhshrink": ((), {}, [S3]), "ThresholdedReLU": ((0.5,), {}, [S3]),
    "Softmax2D": ((), {}, [(2, 3, 4, 4)]),
    "Linear": ((4, 6), {}, [S3]), "LinearCompress": ((4, 6), {}, [S3]),
    "Dropout": ((0.3,), {}, [S3], "eval"),
    "Dropout2D": ((0.3,), {}, [(2, 3, 4, 4)], "eval"),
    "Dropout3D": ((0.3,), {}, [(2, 3, 2, 2, 2)], "eval"),
    "AlphaDropout": ((0.3,), {}, [S3], "eval"),
    "Embedding": ((10, 4), {"padding_idx": 1}, [("ids", (2, 5), 10)]),
    "Flatten": ((), {}, [S3]), "Unflatten": ((1, [2, 3]), {}, [(2, 6, 4)]),
    "Identity": ((), {}, [(2, 3)]),
    "Upsample": ((), {"size": [6, 7], "mode": "bilinear"}, [(1, 2, 3, 4)]),
    "UpsamplingBilinear2D": ((), {"scale_factor": 2}, [(1, 2, 3, 4)]),
    "UpsamplingNearest2D": ((), {"scale_factor": 2}, [(1, 2, 3, 4)]),
    "Pad1D": (([1, 2],), {"mode": "reflect"}, [(2, 3, 5)]),
    "Pad2D": (([1, 0, 2, 1],), {"mode": "replicate"}, [(1, 2, 4, 5)]),
    "Pad3D": ((1,), {"mode": "circular"}, [(1, 1, 3, 3, 3)]),
    "ZeroPad2D": (([1, 1, 2, 0],), {}, [(1, 2, 3, 3)]),
    "Bilinear": ((3, 4, 5), {}, [(2, 3), (2, 4)]),
    "CosineSimilarity": ((), {"axis": 1}, [(3, 5), (3, 5)]),
    "PairwiseDistance": ((), {}, [(3, 5), (3, 5)]),
    "PixelShuffle": ((2,), {}, [(1, 8, 3, 3)]),
    "PixelUnshuffle": ((2,), {}, [(1, 2, 4, 6)]),
    "ChannelShuffle": ((2,), {}, [(1, 4, 3, 3)]),
    "Fold": (([4, 5], 2), {}, [(1, 12, 12)]),
    "Unfold": ((2,), {"paddings": 1}, [(1, 2, 4, 4)]),
    "BatchNorm": ((3,), {}, [(4, 3, 2, 2)]),
    "BatchNorm1D": ((3,), {}, [(4, 3, 5)]),
    "BatchNorm2D": ((3,), {}, [(4, 3, 2, 2)]),
    "BatchNorm3D": ((3,), {}, [(2, 3, 2, 2, 2)]),
    "SyncBatchNorm": ((3,), {}, [(4, 3, 2, 2)]),
    "LayerNorm": (([4],), {}, [S3]), "GroupNorm": ((2, 4), {}, [(2, 4, 3, 3)]),
    "InstanceNorm1D": ((3,), {}, [(2, 3, 6)]),
    "InstanceNorm2D": ((3,), {}, [(2, 3, 4, 4)]),
    "InstanceNorm3D": ((3,), {}, [(2, 3, 2, 3, 3)]),
    "LocalResponseNorm": ((3,), {}, [(2, 5, 3, 3)]),
    "SpectralNorm": (([4, 6],), {"power_iters": 2}, [(4, 6)]),
    "RMSNorm": ((4,), {}, [S3]),
    "Sequential": ("seq", {}, [S3]), "LayerList": ("list", {}, [S3]),
    "LayerDict": ("dict", {}, [S3]), "ParameterList": ("params", {}, [S3]),
}
# the card against its CPU twin: fp32 as phase 9's sums over K = 64 terms;
# bf16 rtol 2^-6 and atol 2^-4 of the compared tensor's largest magnitude:
# the two devices round a bf16 chain's intermediates in other places, and
# a gradient through a normalization sums products that cancel, so one
# element of InstanceNorm2D's bf16 input gradient moved by 2^-5 of the top
# on an H100, where a wrong formula moves elements by the top
NN_K = 64
NN_BF16_REL = 2.0 ** -6
NN_BF16_TOP = 2.0 ** -4
# the nn route's 7B layer (phase 9's weights and input) and phase 10's
# Model.fit through io.DataLoader (phase 6b's configuration, 3 batches;
# the worker pass waits at most `timeout` seconds a batch)
NN_IO = dict(batches=3, workers=2, timeout=300)


def torch_cu(like, values):
    import torch

    return torch.tensor(values, dtype=torch.int64, device=like.device)


def nn_inputs(torch, np, specs, seed, dtype):
    """(tensor, differentiable) per spec, on the CPU."""
    rng = np.random.RandomState(seed)
    out = []
    for s in specs:
        if isinstance(s, tuple) and s and s[0] == "ids":
            out.append((torch.from_numpy(rng.randint(0, s[2], s[1])), False))
            continue
        kind, shape = (s[0], s[1]) if isinstance(s[0], str) else ("n", s)
        a = rng.rand(*shape) + 0.5 if kind == "pos" else rng.randn(*shape)
        out.append((torch.from_numpy(a.astype(np.float32)).to(dtype),
                    kind != "const"))
    return out


def _nn_container(nn, kind):
    if kind == "seq":
        return nn.Sequential(nn.Linear(4, 5), nn.GELU(), nn.Linear(5, 2))
    if kind == "list":
        class Stack(nn.Layer):
            def __init__(self):
                super().__init__()
                self.layers = nn.LayerList([nn.Linear(4, 4) for _ in range(2)])

            def forward(self, x):
                for layer in self.layers:
                    x = layer(x)
                return x
        return Stack()
    if kind == "dict":
        class Heads(nn.Layer):
            def __init__(self):
                super().__init__()
                self.heads = nn.LayerDict({"a": nn.Linear(4, 3),
                                           "b": nn.Linear(4, 3)})

            def forward(self, x):
                return self.heads["a"](x) * self.heads["b"](x)
        return Heads()

    class Scaled(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ws = nn.ParameterList(
                [self.create_parameter([4]) for _ in range(2)])

        def forward(self, x):
            return x * self.ws[0] + self.ws[1]
    return Scaled()


def _nn_layer(pt, name, spec, dtype):
    """A layer of NN_LAYERS built in ``dtype`` on the current place."""
    args, kwargs = spec[0], spec[1]
    prev = pt.get_default_dtype()
    pt.set_default_dtype(dtype)
    try:
        if isinstance(args, str):
            layer = _nn_container(pt.nn, args)
        elif name == "RMSNorm":
            from paddle_tpu_torch.core.place import resolve_device

            layer = pt.nn.RMSNorm(*args, device=resolve_device(),
                                  dtype=pt.get_default_dtype())
        else:
            layer = getattr(pt.nn, name)(*args, **kwargs)
    finally:
        pt.set_default_dtype(prev)
    if len(spec) > 3:
        layer.eval()
    return layer


def _nn_tol(dtype, k=NN_K):
    return "bf16" if dtype == "bfloat16" else k


def nn_sweep(torch, pt, np, dev):
    """Every function and layer of this slice on ``dev`` against its CPU
    twin, fp32 and bf16, forward and the gradients of sum(out * w) for
    every float input (and, for a layer, every parameter: the card's layer
    takes the CPU twin's weights through ``set_state_dict``)."""
    import copy

    F = pt.nn.functional
    t0 = time.perf_counter()
    fn_names = {n for m in ("activation", "common", "norm", "extension",
                            "flash_attention")
                for n in importlib.import_module(
                    f"paddle_tpu_torch.nn.functional.{m}").__all__}
    missing = fn_names - set(NN_FUNCTIONS) - {"class_center_sample",
                                              "sdp_kernel"}
    layer_names = {n for m in ("activation", "common", "norm", "container")
                   for n in importlib.import_module(
                       f"paddle_tpu_torch.nn.layer.{m}").__all__}
    missing |= layer_names - set(NN_LAYERS)
    if missing:
        raise AssertionError(f"nn sweep: no case for {sorted(missing)}")
    worst, n_cases = {}, 0
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for i, name in enumerate(sorted(NN_FUNCTIONS) + sorted(NN_LAYERS)):
            is_layer = name in NN_LAYERS
            call, specs = ((None, NN_LAYERS[name][2]) if is_layer
                           else NN_FUNCTIONS[name])
            ins = nn_inputs(torch, np, specs, i, tdt)
            with _cpu_place():
                layer = _nn_layer(pt, name, NN_LAYERS[name], dtype) \
                    if is_layer else None
            if is_layer and name == "RMSNorm":
                card = copy.deepcopy(layer).to(dev)
            elif is_layer:
                card = _nn_layer(pt, name, NN_LAYERS[name], dtype)
                card.set_state_dict(layer.state_dict())
            outs = {}
            for where, model in (("card", card if is_layer else None),
                                 ("cpu", layer)):
                d = dev if where == "card" else torch.device("cpu")
                xs = [t.to(d).requires_grad_() if g else t.to(d)
                      for t, g in ins]
                out = model(*xs) if is_layer else call(F, *xs)
                leaves = [x for x in xs if x.requires_grad]
                if is_layer:
                    leaves += [p for p in model.parameters()
                               if p.requires_grad]
                grads = (_grads(torch, pt, out, leaves)
                         if leaves and out.is_floating_point() else None)
                outs[where] = (out, grads)
            (got, g_card), (want, g_cpu) = outs["card"], outs["cpu"]
            what = f"{name} {dtype}"
            err = sweep_compare(torch, what, got, want, _nn_tol(dtype), dev)
            if g_card is not None:
                err = max(err, sweep_compare(torch, f"{what} grad", g_card,
                                             g_cpu, _nn_tol(dtype), dev))
            worst[what] = err
            n_cases += 1
    torch.cuda.synchronize()
    return {"functions": len(NN_FUNCTIONS), "layers": len(NN_LAYERS),
            "cases": n_cases, "max_abs_err": worst,
            "s": time.perf_counter() - t0}


def nn_random_on_card(torch, pt, dev):
    """The random functions on the card: a dropout mask repeats after the
    same seed and drops its share; class_center_sample keeps every
    positive; sdp_kernel is a no-op context."""
    F = pt.nn.functional
    x = torch.randn(1024, 1024, device=dev)
    pt.seed(3)
    a = F.dropout(x, 0.25)
    pt.seed(3)
    b = F.dropout(x, 0.25)
    share = float((a == 0).float().mean())
    label = torch.tensor([3, 7, 3, 9], device=dev)
    remapped, centers = F.class_center_sample(label, 100, 8)
    with F.sdp_kernel():
        pass
    ok = (torch.equal(a, b) and abs(share - 0.25) < 0.01
          and remapped.device == dev
          and torch.equal(centers[remapped], label) and len(centers) == 8)
    if not ok:
        raise AssertionError(f"nn random ops on the card: dropout share "
                             f"{share}, class centers {centers.tolist()}")
    return {"dropout_share": share}


def nn_decoder_layer(pt, cfg):
    """A Llama decoder layer written with ``paddle.nn``: ``Linear`` without
    bias ([in, out] weights), ``RMSNorm``, RoPE through the tensor ops,
    ``F.flash_attention(causal=True)`` and ``F.silu``; built on the current
    place in the default dtype."""
    nn, F = pt.nn, pt.nn.functional
    h, f = cfg.hidden_size, cfg.intermediate_size
    nh = cfg.num_attention_heads
    d = h // nh

    class DecoderLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            for name, (i, o) in (("q_proj", (h, h)), ("k_proj", (h, h)),
                                 ("v_proj", (h, h)), ("o_proj", (h, h)),
                                 ("gate_proj", (h, f)), ("up_proj", (h, f)),
                                 ("down_proj", (f, h))):
                setattr(self, name, nn.Linear(i, o, bias_attr=False))
            from paddle_tpu_torch.core.place import resolve_device

            kw = dict(device=resolve_device(), dtype=pt.get_default_dtype())
            self.input_layernorm = nn.RMSNorm(h, cfg.rms_norm_eps, **kw)
            self.post_attention_layernorm = nn.RMSNorm(h, cfg.rms_norm_eps,
                                                       **kw)

        def forward(self, x, cos, sin):
            b, s, _ = x.shape

            def rope(t):
                t1, t2 = pt.split(pt.cast(t, "float32"), 2, axis=-1)
                c = pt.reshape(pt.cast(cos, "float32"), [1, s, 1, d // 2])
                sn = pt.reshape(pt.cast(sin, "float32"), [1, s, 1, d // 2])
                return pt.cast(pt.concat([t1 * c - t2 * sn, t2 * c + t1 * sn],
                                         axis=-1), x.dtype)

            hn = self.input_layernorm(x)
            q = rope(pt.reshape(self.q_proj(hn), [b, s, nh, d]))
            k = rope(pt.reshape(self.k_proj(hn), [b, s, nh, d]))
            v = pt.reshape(self.v_proj(hn), [b, s, nh, d])
            ctx, _ = F.flash_attention(q, k, v, causal=True)
            x = x + self.o_proj(pt.reshape(ctx, [b, s, h]))
            hn = self.post_attention_layernorm(x)
            return x + self.down_proj(F.silu(self.gate_proj(hn))
                                      * self.up_proj(hn))

    return DecoderLayer()


NN_LAYER_KEYS = {"q_proj.weight": "wq", "k_proj.weight": "wk",
                 "v_proj.weight": "wv", "o_proj.weight": "wo",
                 "gate_proj.weight": "wg", "up_proj.weight": "wu",
                 "down_proj.weight": "wd", "input_layernorm.weight": "ln1",
                 "post_attention_layernorm.weight": "ln2"}


def nn_layer(torch, pt, dev, seed, tensor_rec):
    """The nn route at full width: phase 9's 7B decoder layer written with
    ``paddle.nn`` (bf16, [1, 512]), its weights carried in from phase 9's
    routes by ``set_state_dict``, forward and backward; its max error
    against phase 9's fp32 yardstick (the tensor-API layer in fp32) at most
    twice the kernel route's plus one bf16 step, its K1, K3, K5 and K6
    launches held against the path's, its time by CUDA events."""
    from paddle_tpu_torch import ops

    st = layer_setup(torch, dev, seed)
    cfg, w16, x16, gw = st["cfg"], st["w16"], st["x16"], st["gw"]
    cos, sin = st["cos"], st["sin"]
    w32 = {k: v.float() for k, v in w16.items()}
    prev = pt.get_default_dtype()
    pt.set_default_dtype("bfloat16")
    try:
        layer = nn_decoder_layer(pt, cfg)
    finally:
        pt.set_default_dtype(prev)
    missing, unexpected = layer.set_state_dict(
        {k: w16[v] for k, v in NN_LAYER_KEYS.items()})
    if missing or unexpected:
        raise AssertionError(f"nn layer: state dict keys {missing} "
                             f"{unexpected}")
    nh, eps = cfg.num_attention_heads, cfg.rms_norm_eps

    def run(route, xin):
        xin = xin.detach().requires_grad_()
        out = (_decoder_layer(pt, xin, w32, cos, sin, nh, eps)
               if route == "yardstick" else layer(xin, cos, sin))
        (g,) = pt.grad(pt.sum(out.float() * gw), [xin])
        return out.detach().float(), g.float()

    ref_out, ref_g = run("yardstick", x16.float())
    ops.reset_launch_counts()
    out, g = run("nn", x16)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    check_launches(counts, expect(counts, rms_norm=2, flash_fwd=1,
                                  flash_bwd_dq=1, flash_bwd_dkv=1),
                   "the nn layer, forward and backward")
    rec = {"config": tensor_rec["config"], "launches": counts}
    for what, ref, got in (("output", ref_out, out), ("input_grad", ref_g, g)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"nn layer {what}: non-finite")
        step = BF16_STEP * float(ref.abs().max())
        e_nn = float((got - ref).abs().max())
        e_k = tensor_rec[what]["kernel_max_abs_err"]
        rec[what] = {"nn_max_abs_err": e_nn, "bf16_step": step,
                     "api_max_abs_err": tensor_rec[what]["api_max_abs_err"],
                     "kernel_max_abs_err": e_k}
        if e_nn > 2 * e_k + step:
            raise AssertionError(
                f"nn layer {what}: max |err| {e_nn:.4g} against the fp32 "
                f"yardstick exceeds twice the kernel route's {e_k:.4g} plus "
                f"one bf16 step {step:.4g}")
    rec["nn_ms"] = _event_ms(torch, lambda: run("nn", x16),
                             TENSOR_LAYER["reps"])
    del st, layer, w16, w32
    torch.cuda.empty_cache()
    return rec


def io_fit(torch, np, dev, seed):
    """``Model.fit`` at phase 6b's configuration over an ``io.TensorDataset``
    of NN_IO["batches"] seeded batches through ``io.DataLoader(batch_size=
    B)``, against ``Model.fit`` over the same batches passed as a list,
    each from the same initial weights and a fresh optimizer: the losses
    bitwise equal and the launch counts equal; then the DataLoader with
    NN_IO["workers"] worker processes yields the batches of
    ``num_workers=0`` in the same order."""
    from paddle_tpu_torch import LlamaForCausalLM, io, llama_config, ops
    from paddle_tpu_torch.hapi.callbacks import Callback

    cfg = train_config(llama_config)
    B, S, n = TRAIN["batch"], TRAIN["seq"], NN_IO["batches"]
    net = LlamaForCausalLM(cfg, device=dev, generator=torch.Generator(
        dev).manual_seed(seed))
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    tok = torch.from_numpy(np.random.RandomState(seed + 1).randint(
        0, cfg.vocab_size, (n * B, S + 1)))
    ids, labels = tok[:, :-1].contiguous(), tok[:, 1:].contiguous()
    ds = io.TensorDataset([ids, labels])

    class Losses(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    def fit(data):
        net.load_state_dict(init)
        m = eager_prepare(torch, net)
        cb = Losses()
        ops.reset_launch_counts()
        t = time.perf_counter()
        m.fit(data, batch_size=B, shuffle=False, verbose=0, callbacks=[cb])
        torch.cuda.synchronize()
        return cb.losses, ops.launch_counts(), time.perf_counter() - t

    l_ds, c_ds, s_ds = fit(ds)
    l_it, c_it, s_it = fit([(ids[i * B:(i + 1) * B], labels[i * B:(i + 1) * B])
                            for i in range(n)])
    if l_ds != l_it or c_ds != c_it or len(l_ds) != n:
        raise AssertionError(f"io: Model.fit over a Dataset {l_ds} {c_ds}, "
                             f"over the batches {l_it} {c_it}")
    if not np.isfinite(np.asarray(l_ds, np.float64)).all():
        raise AssertionError(f"io: non-finite loss in {l_ds}")
    t = time.perf_counter()
    plain = list(io.DataLoader(ds, batch_size=B))
    workers = list(io.DataLoader(ds, batch_size=B,
                                 num_workers=NN_IO["workers"],
                                 timeout=NN_IO["timeout"]))
    workers_s = time.perf_counter() - t
    if len(plain) != n or len(workers) != n or not all(
            torch.equal(a, b) for p, w in zip(plain, workers)
            for a, b in zip(p, w)):
        raise AssertionError("io: the worker processes' batches differ from "
                             "num_workers=0's")
    del net, init
    torch.cuda.empty_cache()
    return {"config": f"{TRAIN['preset']} {TRAIN['overrides']}",
            "layers": cfg.num_hidden_layers, "batch": B, "seq": S,
            "losses": l_ds, "launches": c_ds, "fit_dataset_s": s_ds,
            "fit_batches_s": s_it, "workers_s": workers_s}


def nn_phase(torch, dev, np, seed, tensor_rec):
    """Phase 10: paddle.nn and paddle.io on the card (default place): the
    sweep of every layer and function against its CPU twin, the random
    functions, the 7B nn-route layer (this slice's path) and Model.fit
    through io.DataLoader."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    if dev.type == "cuda":         # every output must land on this device
        dev = torch.device("cuda", torch.cuda.current_device())
    rec = {"sweep": nn_sweep(torch, pt, np, dev),
           "random": nn_random_on_card(torch, pt, dev)}
    rec["layer"] = nn_layer(torch, pt, dev, seed, tensor_rec)
    rec["launches"] = rec["layer"]["launches"]
    rec["io"] = io_fit(torch, np, dev, seed)
    from paddle_tpu_torch import ops

    rec["route_calls"] = {name: 0 for name in ops.ROUTES}
    rec["s"] = time.perf_counter() - t0
    return rec


# -- phase 11: the GPT and ERNIE-MoE families, and the incubate entry points --

# the two families at full depth and width (paddle_tpu/models/gpt.py:54,
# "1b3": GPT-3 1.3B; paddle_tpu/models/ernie.py:58, "base": ERNIE-MoE base),
# bf16, random weights from --seed, one batch from --seed: GPT causal LM
# batches of next tokens, ERNIE MLM batches with MASK_SHARE of the positions
# labelled and two segments of token types. Each trains through the loop a
# PaddlePaddle user writes (loss.backward(); opt.step(); opt.clear_grad())
# with the paddle-style AdamW at FAMILY_OPT; one warm-up step, then
# TRAIN_STEPS timed ones
FAMILIES = {
    "gpt": dict(preset="1b3", overrides=dict(dtype="bfloat16",
                                             recompute="full"),
                batch=8, seq=2048),
    "ernie": dict(preset="base", overrides=dict(dtype="bfloat16"),
                  batch=16, seq=512),
}
FAMILY_OPT = dict(lr=1e-4, weight_decay=0.01, clip=1.0)
MASK_SHARE = 0.15
# the card-against-CPU twins: each family cut to 2 layers, batches (rows,
# tokens), the same weights, GShard's random routing off on both sides (a
# CUDA and a CPU generator draw different numbers)
FAMILY_E2E = dict(layers=2, gpt=(1, 512), ernie=(2, 128))
# a GShard choice may differ between the card and the CPU only where the
# CPU's gate scores of the two experts involved are within GATE_NEAR_TIE:
# the scores (|s| up to about 2 at these widths) are bf16 outputs of a
# 768-term dot product whose inputs differ between the two sides by a bf16
# step in a few elements, so they differ by one or two bf16 steps of the
# score (2^-8 to 2^-6); 2^-5 is two steps at |s| in [1, 2). A wrong top-k,
# gate or dispatch flips choices at gaps of order 0.3 (the scores' spread)
GATE_NEAR_TIE = 2.0 ** -5
# the incubate leg: fused_rms_norm at GPT-3 1.3B's hidden over one
# 2048-token row, fused_rotary_position_embedding on its q and k (16 heads
# of 128), memory_efficient_attention at ERNIE-MoE base's attention (12
# heads of 64, 512 tokens, non-causal), batch 1, bf16, forward and backward
INCUBATE = dict(tokens=2048, hidden=2048, heads=16, head_dim=128,
                mea=(1, 512, 12, 64))


def family_config(kind, **over):
    from paddle_tpu_torch.models import ernie_moe_config, gpt_config

    spec = FAMILIES[kind]
    make = gpt_config if kind == "gpt" else ernie_moe_config
    return make(spec["preset"], **{**spec["overrides"], **over})


def family_model(torch, kind, cfg, dev, seed):
    from paddle_tpu_torch.models import ErnieMoEForMaskedLM, GPTForCausalLM

    cls = GPTForCausalLM if kind == "gpt" else ErnieMoEForMaskedLM
    return cls(cfg, device=dev,
               generator=torch.Generator(dev).manual_seed(seed))


def family_batch(torch, np, kind, cfg, rows, seq, seed, dev):
    """GPT: (ids, next-token labels); ERNIE: (ids, MLM labels with
    MASK_SHARE of the positions kept, token types of two segments)."""
    rng = np.random.RandomState(seed)
    if kind == "gpt":
        tok = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                           (rows, seq + 1)))
        return tok[:, :-1].to(dev), tok[:, 1:].to(dev)
    ids = rng.randint(0, cfg.vocab_size, (rows, seq))
    labels = np.where(rng.rand(rows, seq) < MASK_SHARE, ids, -100)
    types = (np.arange(seq)[None, :] >= seq // 2).repeat(rows, 0)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(dev)
                 for a in (ids, labels, types))


def family_loss(kind, model, batch):
    return model(*batch) if kind == "gpt" else model(*batch)[0]


def routing_off(model) -> None:
    for moe in model.ernie.moe_layers():
        moe.gate.random_routing = False


def routing_stats(torch, model) -> list:
    """Per MoE layer of the latest forward: the dispatch mode, the
    capacity, each expert's assignments (the gate's choices after its
    random drop) and the share of them dropped by capacity."""
    out = []
    for moe in model.ernie.moe_layers():
        r = moe.last_routing
        idx = r["idx"].reshape(-1)
        load = torch.bincount(idx[idx >= 0], minlength=moe.num_expert)
        dropped = (load - r["capacity"]).clamp_min(0).sum().item()
        out.append({"mode": r["mode"], "capacity": r["capacity"],
                    "load": load.tolist(),
                    "dropped_share": dropped / max(int(load.sum()), 1)})
    return out


def family_train(torch, np, dev, seed, kind, profile=False):
    """One family at full depth and width: a warm-up step, then
    TRAIN_STEPS timed ones, launches held exact; with ``profile`` one more
    step under ``torch.profiler``."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    spec = FAMILIES[kind]
    cfg = family_config(kind)
    L, B, S = cfg.num_hidden_layers, spec["batch"], spec["seq"]
    # what earlier phases still hold on the card, inside the peak below
    base = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    model = family_model(torch, kind, cfg, dev, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model.train()
    opt = AdamW(learning_rate=FAMILY_OPT["lr"],
                parameters=model.parameters(),
                weight_decay=FAMILY_OPT["weight_decay"],
                grad_clip=ClipGradByGlobalNorm(FAMILY_OPT["clip"]))
    batch = family_batch(torch, np, kind, cfg, B, S, seed, dev)

    def step():
        loss = family_loss(kind, model, batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    losses = [step()]                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = TRAIN_STEPS
    fwd = 2 if getattr(cfg, "recompute", "none") == "full" else 1
    check_launches(counts, expect(
        counts, flash_fwd=n * fwd * L, flash_bwd_dq=n * L,
        flash_bwd_dkv=n * L), f"{kind}: {n} steps of {L} layers")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{kind}: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{kind}: the loss did not fall: {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = B * S
    step_s = statistics.median(times)
    rec = {"config": f"{spec['preset']} {spec['overrides']}", "layers": L,
           "hidden": cfg.hidden_size, "heads": cfg.num_attention_heads,
           "head_dim": cfg.head_dim, "batch": B, "seq": S,
           "params": n_params, "model_init_s": init_s, "losses": losses,
           "step_s": times, "step_s_median": step_s,
           "tokens_per_s": tokens / step_s, "peak_mem_gb": peak,
           "base_mem_gb": base, "launches": counts,
           "route_calls": ops.route_calls()}
    if kind == "gpt":
        pairs = causal_pairs(S, S) * cfg.num_attention_heads * B * L
        attn = 3 * 4 * cfg.head_dim * pairs     # QK and PV, forward x3
        rec.update(mfu=6 * n_params * tokens / step_s / BF16_FLOPS,
                   mfu_with_attention=(6 * n_params * tokens + attn)
                   / step_s / BF16_FLOPS, attention_flops_model=attn)
    else:
        moe = model.ernie.moe_layers()
        expert = sum(p.numel() for p in moe[0].experts[0].parameters())
        # a token runs top_k experts, not all of them
        active = n_params - len(moe) * (cfg.num_experts - cfg.top_k) * expert
        rec.update(routing=routing_stats(torch, model), params_active=active,
                   mfu_active=6 * active * tokens / step_s / BF16_FLOPS)
        with torch.no_grad():
            model(batch[0], None, batch[2])
            rec["aux_loss"] = [m.gate.get_loss().item() for m in moe]
        for r in rec["routing"]:
            # the reference's policy: the sort plan past 2^24 elements of
            # the dense [T, E, C] form
            want = ("sort" if tokens * cfg.num_experts * r["capacity"]
                    > 1 << 24 else "dense")
            if r["mode"] != want:
                raise AssertionError(f"ernie: auto dispatch took "
                                     f"{r['mode']} at T = {tokens}, C = "
                                     f"{r['capacity']}, not {want}")
    if profile:
        rec["profile"] = profile_run(torch, step)
    del model, opt, batch
    torch.cuda.empty_cache()
    return rec


def follow_card_routing(torch, gpu, cpu) -> dict:
    """Hooks on the CPU twin's GShard gates that hold each choice equal to
    the card's latest one (``gpu``'s forward has run): where the two
    differ, the CPU's scores of the two experts involved must be within
    GATE_NEAR_TIE, else it raises; there the CPU takes the card's expert,
    its weight the CPU's own probability of that expert, so both sides
    dispatch each token alike and the loss and gradients compare the
    kernels, not a near-tie's two outcomes (as greedy streams are compared
    up to a near-tie). Returns the tally the hooks fill."""
    tally = {"choices": 0, "near_tie_flips": 0, "flip_max_score_gap": 0.0}

    def hook(i, card_idx):
        def follow(gate, inputs, out):
            val, idx = out
            tally["choices"] += int((idx >= 0).sum())
            flipped = (idx != card_idx).nonzero().tolist()
            if not flipped:
                return None
            scores = gate.gate(inputs[0]).float()
            s = scores.detach()
            for t, j in flipped:
                a, b = int(card_idx[t, j]), int(idx[t, j])
                gap = (s[t, a] - s[t, b]).abs().item()
                if min(a, b) < 0 or gap > GATE_NEAR_TIE:
                    raise AssertionError(
                        f"ernie twin: MoE layer {i} token {t} choice {j}: "
                        f"expert {a} on the card, {b} on the CPU, score "
                        f"gap {gap:.4g} > {GATE_NEAR_TIE}")
                tally["near_tie_flips"] += 1
                tally["flip_max_score_gap"] = max(
                    tally["flip_max_score_gap"], gap)
            probs = torch.softmax(scores, dim=-1)
            return probs.gather(-1, card_idx), card_idx
        return follow

    for i, (mg, mc) in enumerate(zip(gpu.ernie.moe_layers(),
                                     cpu.ernie.moe_layers())):
        mc.gate.register_forward_hook(
            hook(i, mg.last_routing["idx"].cpu()))
    return tally


def family_e2e(torch, np, dev, kind):
    """One family at FAMILY_E2E["layers"] layers on the card (kernels) and
    on the CPU (plain versions) from the same bf16 weights and batch: the
    Layer API's loss and gradients within phase 6's tolerances, the card's
    launches exact; ERNIE's GShard choices equal on both sides up to
    near-ties, where the CPU follows the card's (``follow_card_routing``)."""
    from paddle_tpu_torch import ops

    L = FAMILY_E2E["layers"]
    rows, seq = FAMILY_E2E[kind]
    cfg = family_config(kind, num_hidden_layers=L)
    gpu = family_model(torch, kind, cfg, dev, 11)
    cpu = family_model(torch, kind, cfg, "cpu", 11)
    cpu.set_state_dict({k: v.detach().cpu()
                        for k, v in gpu.named_parameters()})
    if kind == "ernie":
        for m in (gpu, cpu):
            routing_off(m)
    batch = family_batch(torch, np, kind, cfg, rows, seq, 11, "cpu")
    losses, routing = [], None
    for m, d in ((gpu, dev), (cpu, "cpu")):
        m.train()
        if m is cpu and kind == "ernie":
            routing = follow_card_routing(torch, gpu, cpu)
        ops.reset_launch_counts()
        loss = family_loss(kind, m, tuple(t.to(d) for t in batch))
        loss.backward()
        losses.append(float(loss.detach()))
        if m is gpu:
            counts = ops.launch_counts()
    fwd = 2 if kind == "gpt" else 1           # GPT recomputes its layers
    check_launches(counts, expect(counts, flash_fwd=fwd * L, flash_bwd_dq=L,
                                  flash_bwd_dkv=L),
                   f"{kind} twin: one step of {L} layers")
    err = abs(losses[0] - losses[1])
    # the loss is a bf16 tensor on both sides: one bf16 step more
    if not (np.isfinite(losses).all()
            and err <= TRAIN_LOSS_ATOL + BF16_STEP * abs(losses[1])):
        raise AssertionError(f"{kind} twin: loss {losses[0]} on the card, "
                             f"{losses[1]} on the CPU")
    g = {k: rel_err(torch, p.grad.cpu(), cpu.get_parameter(k).grad)
         for k, p in gpu.named_parameters()}
    worst = max(g, key=g.get)
    if g[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"{kind} twin: gradient of {worst} differs by "
                             f"{g[worst]:.3g} of its norm")
    rec = {"layers": L, "batch": rows, "seq": seq, "loss_card": losses[0],
           "loss_cpu": losses[1], "loss_abs_err": err,
           "grad_max_rel_err": g[worst], "grad_worst": worst,
           "launches": counts}
    if routing is not None:
        rec["routing"] = routing
    del gpu, cpu
    torch.cuda.empty_cache()
    return rec


def incubate_leg(torch, np, dev):
    """incubate.nn.functional's kernel entry points on cuda:0 against
    their CPU twins, forward and backward: ``fused_rms_norm`` (K1),
    ``fused_rotary_position_embedding`` (K2 on q and k),
    ``memory_efficient_attention`` (K3 non-causal, K5/K6 in its backward),
    each within its kernel's tolerance, launches counted."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.incubate.nn import memory_efficient_attention

    g = torch.Generator().manual_seed(SEED)
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(bf)

    T, H, NH, D = (INCUBATE[k] for k in ("tokens", "hidden", "heads",
                                          "head_dim"))
    inv = 1.0 / (10000 ** (torch.arange(0, D, 2).double() / D))
    ang = torch.outer(torch.arange(T).double(), inv)
    cos, sin = ang.cos().to(bf), ang.sin().to(bf)
    mb, ms, mh, md = INCUBATE["mea"]
    # (function, inputs, the outputs' limit, the gradients' limit): K1's
    # and K2's backward run their forward's arithmetic (RMSNorm's plain
    # fp32 backward on both sides, K2 with -sin), the flash backward K5/K6
    cases = {
        "fused_rms_norm": (lambda x, w: IF.fused_rms_norm(x, w, 1e-5),
                           [rand(1, T, H), 1.0 + rand(H, scale=0.1)],
                           TOL["rms_norm"], TOL["rms_norm"]),
        "fused_rotary_position_embedding": (
            lambda q, k: IF.fused_rotary_position_embedding(
                q, k, None, sin=sin.to(q.device), cos=cos.to(q.device))[:2],
            [rand(1, T, NH, D), rand(1, T, NH, D)], TOL["fused_rope"],
            TOL["fused_rope"]),
        "memory_efficient_attention": (
            memory_efficient_attention,
            [rand(mb, ms, mh, md) for _ in range(3)], TOL["flash_fwd"],
            TOL["flash_bwd_dq"]),
    }
    rec = {"max_abs_err": {}}
    ops.reset_launch_counts()
    for name, (fn, args, tol_out, tol_grad) in cases.items():
        outs = {}
        for d in (dev, "cpu"):
            xs = [a.to(d).requires_grad_() for a in args]
            out = fn(*xs)
            out = out if isinstance(out, tuple) else (out,)
            ct = torch.Generator().manual_seed(SEED + 1)
            sum((o.float() * torch.randn(o.shape, generator=ct).to(d)).sum()
                for o in out).backward()
            outs[d] = ([(o.detach().cpu(), tol_out) for o in out]
                       + [(x.grad.cpu(), tol_grad) for x in xs])
            if d == dev:
                counts = ops.launch_counts()
        rec["max_abs_err"][name] = max(
            check_close(torch, f"incubate {name} [{i}]", got, want,
                        tol["atol"], tol["rtol"], tol.get("outside", 0.0),
                        tol.get("cap"))
            for i, ((got, tol), (want, _)) in enumerate(
                zip(outs[dev], outs["cpu"])))
    check_launches(counts, expect(counts, rms_norm=1, fused_rope=4,
                                  flash_fwd=1, flash_bwd_dq=1,
                                  flash_bwd_dkv=1),
                   "the incubate leg, forward and backward")
    rec.update(launches=counts, route_calls=ops.route_calls())
    return rec


def log_families(fam, smi) -> None:
    """Phase 11's lines: each family's training steps, its twin against
    the CPU, the incubate leg."""
    for kind in ("gpt", "ernie"):
        r = fam[kind]
        rate = (f"MFU {r['mfu']:.4f} (6 N tokens; {r['mfu_with_attention']:.4f}"
                f" with {r['attention_flops_model']:.4g} attention FLOPs)"
                if kind == "gpt" else
                f"MFU on the active parameters {r['mfu_active']:.4f} "
                f"({r['params_active']} active a token)")
        log(f"[families] {kind} {r['config']} x{r['layers']}, {r['batch']}x"
            f"{r['seq']} tokens, {r['params']} params: step "
            f"{r['step_s_median']:.4f} s (steps {r['step_s']}), "
            f"{r['tokens_per_s']:.1f} tokens/s, {rate}, peak "
            f"{r['peak_mem_gb']:.2f} GiB ({r['base_mem_gb']:.2f} of it held "
            f"before the phase), losses {r['losses']}, init "
            f"{r['model_init_s']:.1f} s  [{smi}]")
        if "profile" in r:
            log(f"[families] {kind} step under the profiler: device busy "
                f"{r['profile']['device_busy_share']:.1%} of "
                f"{r['profile']['wall_ms']:.1f} ms, by category "
                f"{ {k: round(v, 2) for k, v in r['profile']['categories_ms'].items() if v} }"
                f"  [{smi}]")
        e = fam[f"{kind}_e2e"]
        log(f"[families] {kind} at {e['layers']} layers, {e['batch']}x"
            f"{e['seq']}: loss {e['loss_card']:.5f} on the card, "
            f"{e['loss_cpu']:.5f} on the CPU, gradients within "
            f"{e['grad_max_rel_err']:.3g} of their norm ({e['grad_worst']})"
            + (f"; GShard choices {e['routing']}" if "routing" in e else ""))
    for i, (r, aux) in enumerate(zip(fam["ernie"]["routing"],
                                     fam["ernie"]["aux_loss"])):
        log(f"[families] ernie MoE layer {i}: {r['mode']} dispatch, capacity "
            f"{r['capacity']}, load {r['load']}, dropped by capacity "
            f"{r['dropped_share']:.4f}, aux loss {aux:.5f}")
    inc = fam["incubate"]
    log(f"[families] incubate leg: max |err| {inc['max_abs_err']}, "
        f"launches {inc['launches']}")


def family_phase(torch, dev, np, seed, profile=False):
    """Phase 11: GPT-3 1.3B and ERNIE-MoE base trained at full width and
    depth (this slice's paths), their 2-layer twins against the CPU, and
    the incubate leg."""
    t0 = time.perf_counter()
    rec = {"gpt": family_train(torch, np, dev, seed, "gpt", profile),
           "ernie": family_train(torch, np, dev, seed, "ernie", profile),
           "gpt_e2e": family_e2e(torch, np, dev, "gpt"),
           "ernie_e2e": family_e2e(torch, np, dev, "ernie"),
           "incubate": incubate_leg(torch, np, dev)}
    rec["s"] = time.perf_counter() - t0
    return rec


# -- phase 12: the rest of paddle.nn and vision.models ------------------------

# ResNet-50 v1.5 at full width and depth (paddle_tpu/vision/models/
# resnet.py:178), 1000 classes, random weights from --seed, trained through
# hapi.Model.fit over an io.TensorDataset of seeded 224 x 224 images and
# labels: the per-GPU batch of NVIDIA's public ResNet-50 v1.5 AMP recipe for
# 80 GB cards (256), Momentum (lr 0.1, momentum 0.9, L2Decay 1e-4),
# CrossEntropyLoss, auto_cast O1 bf16, batch norms in training mode; one
# warm-up step, then TRAIN_STEPS timed ones
RESNET = dict(batch=256, image=224, classes=1000, lr=0.1, momentum=0.9,
              weight_decay=1e-4)
# every model function of resnet.py and classic.py, one forward and
# backward at 2 x 3 x 224 x 224 (LeNet 2 x 1 x 28 x 28) on the card against its CPU twin
# in fp32: the ResNets in training mode, the classic families (which hold
# dropout) in eval mode
VISION_MODELS = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext101_32x8d", "resnext152_32x4d",
    "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2", "LeNet",
    "alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
    "mobilenet_v1", "mobilenet_v2", "squeezenet1_0", "squeezenet1_1")
VISION_TWIN = dict(batch=2, image=224)
# fp32 convolutions run in TF32 on the card (the port's policy: cuDNN's
# default, nn/functional/conv.py). The models run in eval mode (the
# classic families hold dropout; in training mode a batch norm over a batch
# of 2 makes the gradients ill-conditioned, which the ResNet-50 twin below
# handles). With TF32 each product carries up to 2^-10 of relative error,
# which a layer's sums average down: on an H100 the outputs lay at most
# 9.4e-4 of their largest magnitude from the CPU's (VGG-19; ResNet-152
# 3.8e-4) and all the gradients together at most 5.3e-2 of their joint
# norm (VGG-11 with batch norm; the ResNets 5.2e-3 to 7.2e-3), so outputs
# are held within VISION_TF32_RTOL (5.3 times the worst reading) and the
# joint gradients within VISION_TF32_JOINT (2.8 times); each tensor's
# gradient distance is recorded: single tensors at the end of the
# backward chain read up to 0.17 of their norm (MobileNetV1's
# features.1.pw.1.bias; VGG-19's features.0.bias 0.15), as on the CPU
# fp32 against fp64 already moves ResNet-152's gradients by 1.4e-5 of
# their joint norm, 235 fp32 epsilons, which at TF32's 2^-11 is about
# 0.1. With TF32 off the card computes in fp32 in other orders,
# and cuDNN may pick its Winograd or FFT algorithms, whose transforms add
# rounding: the output within F32_GRAD_RTOL of its top and all the
# gradients within 1e-3 of their joint norm (1.4e-5 fp32 against fp64 on
# the CPU; the card against the CPU 1.26e-4 on ResNet-34, an H100). Each
# tensor's distance is recorded, not held: where the signal fades with
# depth (VGG has no batch norm; its logits are of order 1e-6 at
# initialization) an early layer's gradient is a small remainder, and fp32
# on the CPU already lies 4.8e-3 of its norm from fp64 (VGG-19's
# features.2.bias)
VISION_TF32_RTOL = 5e-3
VISION_TF32_JOINT = 0.15
VISION_F32_JOINT = 1e-3
# the ResNet-50 twin in training mode is held against an fp64 twin on the
# CPU: with TF32 off the card's loss within TWIN_F32_LOSS_ATOL of it (the
# CPU's fp32 1.9e-5, the card's 9.8e-5 on an H100, cuDNN's fp32
# algorithms adding rounding), and its gradients (jointly) and every
# running statistic at most TWIN_FACTOR times as far from it as the CPU's
# fp32 twin is, plus 1e-6
# (ResNet-50's gradients at initialization are ill-conditioned: fp32 on
# the CPU lies 1.1e-2 of their joint norm from fp64 at 2 x 3 x 64 x 64,
# 1.3e-2 at 8 x 3 x 64 x 64); with TF32 the loss within TF32_TWIN_LOSS_ATOL
# (the last stage normalizes 8 values a channel, which amplifies TF32's
# errors of the forward), the rest recorded
TWIN_FACTOR = 3.0
TWIN_F32_LOSS_ATOL = 1e-3
TF32_TWIN_LOSS_ATOL = 0.125
# ResNet-50 at 2 x 3 x 64 x 64 in fp32 on the card against the CPU, one
# Momentum step: the loss, every gradient by relative norm, every batch
# norm's running statistics; twice on the card (cuDNN's backward may add
# in another order each run: the gap is recorded, not required to be 0);
# then the TF32 effect: the same twin with TF32 off, and a ResNet-50 fp32
# training step at `tf32_batch` timed both ways
RESNET_TWIN = dict(batch=2, image=64, tf32_batch=64, reps=3)
# nn.Transformer at the base widths of Vaswani et al. 2017 (d_model 512, 8
# heads, 6 + 6 layers, FFN 2048, dropout 0.1), token embeddings shared by
# source and target over a 37,000-token vocabulary and an untied output
# Linear, sinusoidal positions; 32 x 128 source tokens (ragged lengths
# 64-128, padding masked) and 32 x 128 target tokens (causal), auto_cast O1
# bf16, AdamW; then greedy decoding of `decode` tokens through the
# decoder's Cache / StaticCache, each token held against a full decoder
# pass over the prefix; a `twin_layers`-layer twin in fp32 against the CPU
# (dropout 0, batch `twin`)
TRANSFORMER = dict(d_model=512, heads=8, layers=6, ffn=2048, dropout=0.1,
                   vocab=37000, batch=32, src=128, tgt=128, src_min=64,
                   lr=1e-4, weight_decay=0.01, decode=32, twin_layers=2,
                   twin=(2, 32))
# the recurrent layers: LSTM and GRU, 512 -> 1024, 2 layers, both ways, at
# batch 64 x 128 steps with ragged lengths 64-128, forward and backward in
# fp32 and bf16 (CUDA events, median of `reps`); the fp32 LSTM's forward
# against its CPU twin; BeamSearchDecoder over an LSTMCell (beam 4, 32
# steps) on the card against the CPU
RNN = dict(input=512, hidden=1024, layers=2, batch=64, steps=128, min_len=64,
           reps=3)
BEAM = dict(beam=4, steps=32, batch=8, vocab=1000, embed=256, hidden=512)
# the fp32 LSTM twin: fp32 matmuls both sides (TF32 off for them) through
# 128 contracting steps, |h| < 1
RNN_F32_ATOL = 1e-4
# the sweep's fp32 tolerance where a convolution runs: TF32 products
# (2^-10 each) summed over up to ~128 terms with random signs move a sum
# by about sqrt(128) 2^-10 = 2^-6.5 of its terms' scale
TF32_SWEEP = dict(rtol=2.0 ** -8, top=2.0 ** -6)
# a greedy step may take another token than the full pass only where the
# full pass's top-2 margin is under this (bf16 logits of |z| ~ 10: a few
# bf16 steps)
DECODE_NEAR_TIE = 2.0 ** -3
# the sweep's transformer layers keep ReLU in bf16: where a pre-activation
# lies within a rounding of 0 the two devices can take opposite sides of
# the kink, which switches that unit's gradient (one element past the bf16
# limit in the 2-layer encoder and decoder on an H100). The CPU twin
# follows the card's side wherever the two differ, and each such unit must
# be a near-tie: its CPU pre-activation within RELU_NEAR_TIE of the call's
# largest magnitude (the bf16 sweep allows NN_BF16_TOP = 2^-4 of the top;
# 2^-5 is eight bf16 steps at the top), and at most RELU_FLIP_SHARE of a
# case's units. A wrong activation or projection flips units far from 0,
# or many of them
RELU_NEAR_TIE = 2.0 ** -5
RELU_FLIP_SHARE = 2.0 ** -6


def _vision_model(M, name):
    if name == "vgg11_bn":
        return lambda: M.vgg11(batch_norm=True)
    return getattr(M, name)


def conv_flops(torch, model, shape, dev):
    """Forward FLOPs of one input of ``shape`` [1, C, H, W] from the
    convolutions' and the linears' shapes (2 per multiply-add), read with
    forward hooks on one no-grad forward in eval mode."""
    from paddle_tpu_torch import nn

    total = [0]

    def conv_hook(m, inp, out):
        k = 1
        for s in m.weight.shape[1:]:
            k *= s
        total[0] += 2 * out.numel() * k

    def linear_hook(m, inp, out):
        total[0] += 2 * out.numel() * m.weight.shape[0]

    hooks = [m.register_forward_hook(conv_hook) for m in model.sublayers()
             if isinstance(m, (nn.Conv1D, nn.Conv2D, nn.Conv3D))]
    hooks += [m.register_forward_hook(linear_hook) for m in model.sublayers()
              if isinstance(m, nn.Linear)]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros(shape, device=dev))
    model.train(was)
    for h in hooks:
        h.remove()
    return total[0]


def resnet_train(torch, np, dev, seed, profile=False):
    """ResNet-50 trained through Model.fit at RESNET over an
    io.TensorDataset in host memory (the loader stacks each batch on the
    host, and train_batch moves it to the card, as a user's fit does): the
    step time (from the callbacks' batch begin to its end: the batch's copy
    to the card, forward, backward, the Momentum step), images/s, peak
    memory, MFU (3x the forward FLOPs of the convolutions and the linear,
    against the card's bf16 peak from device.peaks); then TRAIN_STEPS more
    steps through Model.train_batch on a batch already on the card."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io, ops
    from paddle_tpu_torch.device.peaks import peaks
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.vision import models

    B, S = RESNET["batch"], RESNET["image"]
    n = 1 + TRAIN_STEPS
    base = torch.cuda.memory_allocated() / 2 ** 30
    pt.seed(seed)
    t0 = time.perf_counter()
    net = models.resnet50(num_classes=RESNET["classes"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flops_image = conv_flops(torch, net, (1, 3, S, S), dev)
    g = torch.Generator().manual_seed(seed)
    images = torch.randn(n * B, 3, S, S, generator=g)
    labels = torch.randint(0, RESNET["classes"], (n * B,), generator=g)
    ds = io.TensorDataset([images, labels])
    opt = pt.optimizer.Momentum(
        learning_rate=RESNET["lr"], momentum=RESNET["momentum"],
        parameters=net.parameters(),
        weight_decay=pt.optimizer.L2Decay(RESNET["weight_decay"]))
    model = pt.Model(net)
    model.prepare(opt, pt.nn.CrossEntropyLoss(),
                  amp_configs={"level": "O1", "dtype": "bfloat16"})

    class Steps(Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.times, self.t = [], [], None

        def on_train_batch_begin(self, step, logs=None):
            if step == 1:
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
            self.t = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - self.t)
            self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))

    cb = Steps()
    model.fit(ds, batch_size=B, shuffle=False, verbose=0, callbacks=[cb])
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = cb.losses
    if len(losses) != n or not np.isfinite(losses).all():
        raise AssertionError(f"resnet: {len(losses)} steps, losses {losses}")
    ins, labs = images[:B].to(dev), labels[:B].to(dev)
    staged = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        loss = model.train_batch([ins], [labs])[0]
        torch.cuda.synchronize()
        staged.append(time.perf_counter() - t)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"resnet: losses {losses}")
    step_s = statistics.median(cb.times[1:])
    staged_s = statistics.median(staged)
    pk = peaks()
    flops_step = 3 * flops_image * B
    rec = {"config": "resnet50 v1.5, 1000 classes, O1 bf16", "batch": B,
           "image": S, "params": sum(p.numel() for p in net.parameters()),
           "model_init_s": init_s, "losses": losses, "step_s": cb.times,
           "step_s_median": step_s, "images_per_s": B / step_s,
           "staged_step_s": staged, "staged_step_s_median": staged_s,
           "staged_images_per_s": B / staged_s,
           "flops_per_image_fwd": flops_image, "flops_per_step": flops_step,
           "mfu": flops_step / step_s / pk["peak_flops"],
           "staged_mfu": flops_step / staged_s / pk["peak_flops"],
           "peak_flops": pk["peak_flops"], "peak_source": pk["source"],
           "peak_mem_gb": peak, "base_mem_gb": base, "launches": counts,
           "route_calls": ops.route_calls()}
    if profile:
        rec["profile"] = profile_run(
            torch, lambda: model.train_batch([ins], [labs]))
    del model, net, opt, ds, images, labels, ins, labs
    torch.cuda.empty_cache()
    return rec


def _twin_pair(torch, make, dev, seed):
    """A model built on the CPU from ``seed`` and its copy on ``dev``."""
    import copy

    import paddle_tpu_torch as pt

    with _cpu_place():
        pt.seed(seed)
        cpu = make()
    return copy.deepcopy(cpu).to(dev), cpu


def _fwd_bwd(torch, model, x, dev):
    """Output and gradients (input first, then the parameters by name; a
    parameter the forward does not use, such as GoogLeNet's auxiliary
    heads in eval mode, has none) of sum(out * w), w a fixed ramp, for
    ``x`` moved to ``dev``."""
    xs = x.detach().to(dev).requires_grad_()
    out = model(xs)
    w = torch.linspace(-1, 1, out.numel(), device=out.device).reshape(
        out.shape)
    (out.float() * w).sum().backward()
    grads = {"input": xs.grad.detach().cpu()}
    grads.update({k: p.grad.detach().cpu()
                  for k, p in model.named_parameters() if p.grad is not None})
    return out.detach().cpu(), grads


def _rel_max(torch, got, want):
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), 1e-30))


def _grad_errs(torch, got, want):
    """Each tensor's gradient error relative to its norm, the worst one,
    and all the gradients' together relative to their joint norm."""
    errs = {k: rel_err(torch, got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    num = sum(float((got[k].float() - want[k].float()).norm()) ** 2
              for k in want)
    den = sum(float(want[k].float().norm()) ** 2 for k in want)
    return errs[worst], worst, (num / den) ** 0.5 if den else 0.0


def vision_twins(torch, np, dev):
    """Every model function of resnet.py and classic.py in eval mode, fp32,
    on the card against its CPU twin: with TF32 convolutions (the port's policy)
    the output within VISION_TF32_RTOL of its largest magnitude and all
    the gradients together within VISION_TF32_JOINT of their joint norm,
    each tensor's distance recorded; with TF32 off the output within
    F32_GRAD_RTOL and all the gradients (input and parameters) together
    within VISION_F32_JOINT of their joint norm, each tensor's distance
    recorded."""
    from paddle_tpu_torch.vision import models

    t0 = time.perf_counter()
    rec = {}
    prev = torch.backends.cudnn.allow_tf32
    try:
        for i, name in enumerate(VISION_MODELS):
            gpu, cpu = _twin_pair(torch, _vision_model(models, name), dev,
                                  i)
            for m in (gpu, cpu):
                m.eval()
            b = VISION_TWIN["batch"]
            shape = ((b, 1, 28, 28) if name == "LeNet"
                     else (b, 3, VISION_TWIN["image"], VISION_TWIN["image"]))
            x = torch.randn(shape, generator=torch.Generator().manual_seed(i))
            want, g_cpu = _fwd_bwd(torch, cpu, x, "cpu")
            r = {"params": sum(p.numel() for p in cpu.parameters())}
            for mode, tf32 in (("tf32", True), ("ieee", False)):
                torch.backends.cudnn.allow_tf32 = tf32
                gpu.zero_grad(set_to_none=True)
                got, g_gpu = _fwd_bwd(torch, gpu, x, dev)
                out_err = _rel_max(torch, got, want)
                worst_err, worst, total = _grad_errs(torch, g_gpu, g_cpu)
                bad = (out_err > VISION_TF32_RTOL
                       or total > VISION_TF32_JOINT if tf32 else
                       out_err > F32_GRAD_RTOL or total > VISION_F32_JOINT)
                if bad or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"vision {name} ({mode}): output off by "
                        f"{out_err:.3g} of its top, gradients by {total:.3g}"
                        f" of their norm, {worst} by {worst_err:.3g} of its "
                        f"norm")
                r[mode] = {"out_rel_err": out_err, "grad_rel_err": total,
                           "grad_max_rel_err": worst_err,
                           "grad_worst": worst}
            rec[name] = r
            del gpu, cpu
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    torch.cuda.empty_cache()
    return {"models": rec, "s": time.perf_counter() - t0}


def _momentum_step(torch, model, x, y, dev):
    """One fp32 training step of ``model`` on ``dev``: (loss, gradients by
    name, the batch norms' running statistics after a Momentum step)."""
    import paddle_tpu_torch as pt

    model.train()
    opt = pt.optimizer.Momentum(
        learning_rate=RESNET["lr"], momentum=RESNET["momentum"],
        parameters=model.parameters(),
        weight_decay=pt.optimizer.L2Decay(RESNET["weight_decay"]))
    loss = pt.nn.CrossEntropyLoss()(model(x.to(dev)), y.to(dev))
    loss.backward()
    grads = {k: p.grad.detach().cpu().clone()
             for k, p in model.named_parameters()}
    opt.step()
    stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
             if k.endswith(("_mean", "_variance"))}
    return float(loss.detach()), grads, stats


def _step_errs(torch, a, b):
    gw_err, gw, g_all = _grad_errs(torch, a[1], b[1])
    s = {k: rel_err(torch, a[2][k], b[2][k]) for k in b[2]}
    sw = max(s, key=s.get)
    return {"loss_abs_err": abs(a[0] - b[0]), "grad_rel_err": g_all,
            "grad_max_rel_err": gw_err, "grad_worst": gw,
            "stats_max_rel_err": s[sw], "stats_worst": sw}


def resnet_twin(torch, np, dev):
    """ResNet-50 at RESNET_TWIN, one Momentum step in training mode on the
    card (twice) and on the CPU in fp32 and fp64 from the same weights and
    batch: with TF32 off the card's loss within TWIN_F32_LOSS_ATOL of the
    fp64 twin's, its gradients and running statistics at most TWIN_FACTOR times
    as far from the fp64 twin as the CPU's fp32 twin is; with TF32 (the
    policy) the loss within TF32_TWIN_LOSS_ATOL, the distances recorded.
    Then an fp32 training step at ``tf32_batch`` timed with TF32 on and
    off."""
    import copy

    from paddle_tpu_torch.vision import models

    t0 = time.perf_counter()
    gpu0, cpu = _twin_pair(torch, models.resnet50, dev, 21)
    b, s = RESNET_TWIN["batch"], RESNET_TWIN["image"]
    g = torch.Generator().manual_seed(21)
    x = torch.randn(b, 3, s, s, generator=g)
    y = torch.randint(0, RESNET["classes"], (b,), generator=g)
    exact = _momentum_step(torch, copy.deepcopy(cpu).double(), x.double(), y,
                           "cpu")
    base = _step_errs(torch, _momentum_step(torch, cpu, x, y, "cpu"), exact)
    prev = torch.backends.cudnn.allow_tf32
    rec = {"batch": b, "image": s, "cpu_f32": base, "loss_f64": exact[0]}
    try:
        for mode, tf32 in (("tf32", True), ("ieee", False)):
            torch.backends.cudnn.allow_tf32 = tf32
            runs = [_momentum_step(torch, copy.deepcopy(gpu0), x, y, dev)
                    for _ in range(2)]
            e = _step_errs(torch, runs[0], exact)
            if tf32:
                bad = e["loss_abs_err"] > TF32_TWIN_LOSS_ATOL
            else:
                bad = (e["loss_abs_err"] > TWIN_F32_LOSS_ATOL
                       or e["grad_rel_err"] > TWIN_FACTOR
                       * base["grad_rel_err"] + 1e-6
                       or e["stats_max_rel_err"] > TWIN_FACTOR
                       * base["stats_max_rel_err"] + 1e-6)
            if bad or not all(torch.isfinite(v).all()
                              for v in runs[0][1].values()):
                raise AssertionError(
                    f"resnet twin ({mode}): loss {runs[0][0]} on the card, "
                    f"{exact[0]} in fp64; {e}; the CPU's fp32: {base}")
            rec[mode] = dict(e, loss_card=runs[0][0],
                             rerun_gap=_step_errs(torch, runs[1], runs[0]))
        rec["tf32_time"] = tf32_step_times(torch, dev)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    del gpu0, cpu
    torch.cuda.empty_cache()
    rec["s"] = time.perf_counter() - t0
    return rec


def tf32_step_times(torch, dev):
    """A ResNet-50 fp32 training step (forward, backward) at
    RESNET_TWIN["tf32_batch"] x 3 x RESNET["image"]^2, CUDA events, median of
    RESNET_TWIN["reps"] after a warm-up, with cuDNN's TF32 on and off."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision import models

    pt.seed(5)
    net = models.resnet50()
    net.train()
    b, S = RESNET_TWIN["tf32_batch"], RESNET["image"]
    x = torch.randn(b, 3, S, S, device=dev)
    y = torch.randint(0, 1000, (b,), device=dev)
    loss_fn = pt.nn.CrossEntropyLoss()

    def step():
        loss_fn(net(x), y).backward()
        net.clear_gradients()

    out = {"batch": b}
    for mode, tf32 in (("tf32", True), ("ieee", False)):
        torch.backends.cudnn.allow_tf32 = tf32
        out[f"{mode}_ms"] = _event_ms(torch, step, RESNET_TWIN["reps"])
        out[f"{mode}_images_per_s"] = b / out[f"{mode}_ms"] * 1e3
    del net, x
    torch.cuda.empty_cache()
    return out


def _seq2seq(pt, cfg, layers, dropout):
    """nn.Transformer with shared token embeddings, sinusoidal positions
    and an untied output Linear, on the current place."""
    import math

    import torch

    nn = pt.nn
    d = cfg["d_model"]

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(cfg["vocab"], d)
            self.transformer = nn.Transformer(d, cfg["heads"], layers, layers,
                                              cfg["ffn"], dropout)
            self.proj = nn.Linear(d, cfg["vocab"])
            pos = torch.arange(1024, dtype=torch.float64)[:, None]
            inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float64)
                            * (-math.log(10000.0) / d))
            pe = torch.zeros(1024, d, dtype=torch.float64)
            pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * inv), torch.cos(
                pos * inv)
            self.register_buffer("pos", pe.float().to(
                self.embed.weight.device), persistable=False)

        def emb(self, ids, start=0):
            x = self.embed(ids) * math.sqrt(d)
            return x + self.pos[start:start + ids.shape[1]].to(x.dtype)

        def encode(self, src, src_mask):
            return self.transformer.encoder(self.emb(src), src_mask)

        def decode(self, tgt, memory, src_mask, start=0, cache=None):
            y = self.emb(tgt, start)
            causal = None
            if cache is None:
                causal = self.transformer.generate_square_subsequent_mask(
                    tgt.shape[1]).to(y.device)
            out = self.transformer.decoder(y, memory, causal, src_mask,
                                           cache)
            if cache is None:
                return self.proj(out)
            return self.proj(out[0]), out[1]

        def forward(self, src, tgt, src_mask):
            return self.decode(tgt, self.encode(src, src_mask), src_mask)

    return Seq2Seq()


def _seq2seq_batch(torch, cfg, rows, src_len, tgt_len, seed, dev):
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(3, cfg["vocab"], (rows, src_len), generator=g)
    tgt = torch.randint(3, cfg["vocab"], (rows, tgt_len + 1), generator=g)
    tgt[:, 0] = 1                                   # BOS
    lo = min(cfg["src_min"], src_len)
    lens = torch.randint(lo, src_len + 1, (rows,), generator=g)
    lens[0] = src_len
    keep = torch.arange(src_len)[None, :] < lens[:, None]
    src = torch.where(keep, src, torch.zeros_like(src))   # PAD 0
    mask = keep[:, None, None, :]
    return src.to(dev), tgt.to(dev), mask.to(dev), lens


def transformer_leg(torch, np, dev, seed, profile=False):
    """nn.Transformer at TRANSFORMER: AdamW steps under auto_cast O1 bf16
    (tokens/s, step time), greedy decoding through the caches held against
    full decoder passes, the fp32 twin against the CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import ops

    cfg = TRANSFORMER
    F = pt.nn.functional
    pt.seed(seed)
    model = _seq2seq(pt, cfg, cfg["layers"], cfg["dropout"])
    opt = pt.optimizer.AdamW(learning_rate=cfg["lr"],
                             parameters=model.parameters(),
                             weight_decay=cfg["weight_decay"])
    B, S, T = cfg["batch"], cfg["src"], cfg["tgt"]
    src, tgt, mask, lens = _seq2seq_batch(torch, cfg, B, S, T, seed, dev)

    def step():
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(src, tgt[:, :-1], mask)
            loss = F.cross_entropy(logits.reshape(-1, cfg["vocab"]),
                                   tgt[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    model.train()
    losses = [step()]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    if not np.isfinite(losses).all():
        raise AssertionError(f"transformer: losses {losses}")
    step_s = statistics.median(times)
    rec = {"config": (f"d_model {cfg['d_model']}, {cfg['heads']} heads, "
                      f"{cfg['layers']}+{cfg['layers']} layers, FFN "
                      f"{cfg['ffn']}, vocab {cfg['vocab']}, O1 bf16"),
           "params": sum(p.numel() for p in model.parameters()),
           "batch": B, "src": S, "tgt": T,
           "src_tokens": int(lens.sum()), "losses": losses, "step_s": times,
           "step_s_median": step_s, "tgt_tokens_per_s": B * T / step_s,
           "tokens_per_s": (int(lens.sum()) + B * T) / step_s,
           "launches": counts, "route_calls": ops.route_calls()}
    if profile:
        rec["profile"] = profile_run(torch, step)
    rec["decode"] = greedy_decode(torch, model, src, mask, cfg)
    del model, opt
    torch.cuda.empty_cache()
    rec["twin"] = transformer_twin(torch, np, dev)
    return rec


def greedy_decode(torch, model, src, mask, cfg):
    """``cfg["decode"]`` greedy tokens through the decoder's Cache (self
    attention) and StaticCache (cross attention, from ``gen_cache``), in
    eval mode under auto_cast O1 bf16; at every step the full decoder pass
    over the prefix so far must pick the same token, or the full pass's
    top-2 margin there is under DECODE_NEAR_TIE."""
    import paddle_tpu_torch as pt

    model.eval()
    B = src.shape[0]
    tok = torch.ones(B, 1, dtype=torch.long, device=src.device)   # BOS
    near, worst_gap = 0, 0.0
    t0 = time.perf_counter()
    with torch.no_grad(), pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        memory = model.encode(src, mask)
        cache = model.transformer.decoder.gen_cache(memory)
        cache_s = 0.0
        for t in range(cfg["decode"]):
            ts = time.perf_counter()
            logits, cache = model.decode(tok[:, -1:], memory, mask, t, cache)
            nxt = logits[:, -1].float().argmax(-1)
            torch.cuda.synchronize()
            cache_s += time.perf_counter() - ts
            full = model.decode(tok, memory, mask)[:, -1].float()
            pick = full.argmax(-1)
            top2 = full.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            diff = pick != nxt
            if diff.any():
                gap = float(margin[diff].max())
                if gap > DECODE_NEAR_TIE:
                    raise AssertionError(
                        f"transformer decode step {t}: the cached step took "
                        f"another token than the full pass at a top-2 "
                        f"margin of {gap:.4g}")
                near += int(diff.sum())
                worst_gap = max(worst_gap, gap)
            tok = torch.cat([tok, nxt[:, None]], 1)
    model.train()
    return {"tokens": cfg["decode"], "rows": B, "near_tie_flips": near,
            "flip_max_margin": worst_gap, "cached_s": cache_s,
            "cached_ms_per_token": cache_s / cfg["decode"] * 1e3,
            "s": time.perf_counter() - t0,
            "cache_len": int(cache[0][0].k.shape[1])}


def transformer_twin(torch, np, dev):
    """The Seq2Seq model at ``twin_layers`` layers, dropout 0, fp32, one
    forward and backward on the card and on the CPU from the same weights
    and batch: the loss within F32_ATOL, every gradient within
    F32_GRAD_RTOL of its norm (fp32 matmuls both sides)."""
    import paddle_tpu_torch as pt

    cfg = TRANSFORMER
    rows, n = cfg["twin"]
    gpu, cpu = _twin_pair(torch, lambda: _seq2seq(
        pt, cfg, cfg["twin_layers"], 0.0), dev, 31)
    src, tgt, mask, _ = _seq2seq_batch(torch, dict(cfg, src_min=n // 2),
                                       rows, n, n, 31, "cpu")
    losses = []
    for m, d in ((gpu, dev), (cpu, "cpu")):
        m.train()
        logits = m(src.to(d), tgt[:, :-1].to(d), mask.to(d))
        loss = pt.nn.functional.cross_entropy(
            logits.reshape(-1, cfg["vocab"]), tgt[:, 1:].reshape(-1).to(d))
        loss.backward()
        losses.append(float(loss.detach()))
    # the key projection's bias has a gradient of 0 (a shift of every key
    # moves a query's scores alike, which the softmax cancels): both sides'
    # values are rounding noise, held against its weight's gradient
    g = {}
    for k, p in gpu.named_parameters():
        got, want = p.grad.cpu(), cpu.get_parameter(k).grad
        g[k] = (float((got - want).norm()) / float(cpu.get_parameter(
            k[:-4] + "weight").grad.norm()) if k.endswith("k_proj.bias")
                else rel_err(torch, got, want))
    worst = max(g, key=g.get)
    err = abs(losses[0] - losses[1])
    if err > F32_ATOL or g[worst] > F32_GRAD_RTOL:
        raise AssertionError(f"transformer twin: loss {losses}, gradient of "
                             f"{worst} off by {g[worst]:.3g} of its norm")
    del gpu, cpu
    return {"layers": cfg["twin_layers"], "rows": rows, "tokens": n,
            "loss_card": losses[0], "loss_cpu": losses[1],
            "loss_abs_err": err, "grad_max_rel_err": g[worst],
            "grad_worst": worst}


def rnn_leg(torch, np, dev):
    """LSTM and GRU at RNN in fp32 and bf16: forward + backward time
    (CUDA events), the padding's outputs zero, finite gradients; the fp32
    LSTM's forward against its CPU twin; the beam search leg."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import ops

    c = RNN
    B, T = c["batch"], c["steps"]
    g = torch.Generator().manual_seed(41)
    lens = torch.randint(c["min_len"], T + 1, (B,), generator=g)
    lens[0] = T
    pad = torch.arange(T)[None, :] >= lens[:, None]
    x32 = torch.randn(B, T, c["input"], generator=g)
    rec = {"batch": B, "steps": T, "input": c["input"],
           "hidden": c["hidden"], "layers": c["layers"]}
    ops.reset_launch_counts()
    for kind in ("LSTM", "GRU"):
        for dtype in ("float32", "bfloat16"):
            pt.seed(41)
            prev = pt.get_default_dtype()
            pt.set_default_dtype(dtype)
            try:
                layer = getattr(pt.nn, kind)(c["input"], c["hidden"],
                                             c["layers"],
                                             direction="bidirect")
            finally:
                pt.set_default_dtype(prev)
            x = x32.to(dev, getattr(torch, dtype)).requires_grad_()
            sl = lens.to(dev)

            def fwd():
                return layer(x, None, sl)

            def fwd_bwd():
                out, _ = fwd()
                out.float().sum().backward()

            out, st = fwd()
            if bool(out[pad.to(dev)].any()) or not torch.isfinite(
                    out.float()).all():
                raise AssertionError(f"rnn {kind} {dtype}: a padded step's "
                                     f"output is not 0, or non-finite")
            fb_ms = _event_ms(torch, fwd_bwd, c["reps"])
            if not all(torch.isfinite(p.grad.float()).all()
                       for p in layer.parameters()):
                raise AssertionError(f"rnn {kind} {dtype}: non-finite grad")
            with torch.no_grad():
                f_ms = _event_ms(torch, fwd, c["reps"])
            rec[f"{kind}_{dtype}"] = {
                "fwd_ms": f_ms, "fwd_bwd_ms": fb_ms,
                "fwd_bwd_ms_per_step": fb_ms / T}
            if kind == "LSTM" and dtype == "float32":
                cpu = copy.deepcopy(layer).to("cpu")
                with torch.no_grad():
                    want, _ = cpu(x32, None, lens)
                err = float((out.detach().cpu() - want).abs().max())
                if err > RNN_F32_ATOL:
                    raise AssertionError(f"rnn LSTM fp32: card against CPU "
                                         f"{err:.3g} > {RNN_F32_ATOL}")
                rec["lstm_f32_max_abs_err"] = err
            del layer, x, out, st
    rec["launches"] = ops.launch_counts()
    rec["route_calls"] = ops.route_calls()
    rec["beam"] = beam_leg(torch, np, dev)
    torch.cuda.empty_cache()
    return rec


def beam_leg(torch, np, dev):
    """BeamSearchDecoder over an LSTMCell with an embedding and an output
    Linear, through dynamic_decode at BEAM, on the card and on the CPU from
    the same weights and initial states: the ids and the lengths equal."""
    import paddle_tpu_torch as pt

    c = BEAM
    nn = pt.nn

    def make():
        return nn.LayerList([nn.LSTMCell(c["embed"], c["hidden"]),
                             nn.Embedding(c["vocab"], c["embed"]),
                             nn.Linear(c["hidden"], c["vocab"])])

    gpu, cpu = _twin_pair(torch, make, dev, 51)
    g = torch.Generator().manual_seed(51)
    h0, c0 = (torch.randn(c["batch"], c["hidden"], generator=g)
              for _ in range(2))
    outs = {}
    t0 = time.perf_counter()
    for where, (cell, emb, proj), d in (("card", gpu, dev),
                                        ("cpu", cpu, "cpu")):
        dec = nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                   beam_size=c["beam"], embedding_fn=emb,
                                   output_fn=proj)
        with torch.no_grad():
            ids, lengths = nn.dynamic_decode(dec, (h0.to(d), c0.to(d)),
                                             max_step_num=c["steps"],
                                             return_length=True)
        outs[where] = (ids.cpu(), lengths.cpu())
    if not (torch.equal(outs["card"][0], outs["cpu"][0])
            and torch.equal(outs["card"][1], outs["cpu"][1])):
        raise AssertionError("beam search: the card's ids or lengths differ "
                             "from the CPU's")
    return {"beam": c["beam"], "steps": int(outs["card"][0].shape[1]),
            "batch": c["batch"], "s": time.perf_counter() - t0}


# this slice's functions and layers (A14b) on the card against their CPU
# twins: name -> (call(F, *tensors), input specs) / (ctor args, kwargs,
# input specs[, call(layer, *tensors)])
def _ctc(F, x):
    return F.ctc_loss(x, torch_cu(x, [[1, 2, 2], [3, 1, 0]]),
                      torch_cu(x, [8, 6]), torch_cu(x, [3, 2]))


def _rnnt(F, x):
    return F.rnnt_loss(x, torch_cu(x, [[1, 2, 3], [4, 5, 0]]),
                       torch_cu(x, [5, 4]), torch_cu(x, [3, 2]))


A14B_FUNCTIONS = {
    "conv1d": (lambda F, x, w, b: F.conv1d(x, w, b, 2, 1),
               [(2, 3, 9), (4, 3, 3), (4,)]),
    "conv1d_nlc": (lambda F, x, w: F.conv1d(x, w, padding=[1, 2],
                                            data_format="NLC"),
                   [(2, 9, 3), (4, 3, 3)]),
    "conv2d": (lambda F, x, w, b: F.conv2d(x, w, b, 1, [1, 2], 2, 2),
               [(2, 4, 7, 8), (6, 2, 3, 3), (6,)]),
    "conv2d_same_stride2": (lambda F, x, w: F.conv2d(
        x, w, stride=2, padding="SAME"), [(1, 3, 9, 8), (4, 3, 3, 3)]),
    "conv2d_nhwc": (lambda F, x, w: F.conv2d(
        x, w, padding=[0, 1, 1, 2], data_format="NHWC"),
        [(1, 6, 7, 3), (4, 3, 3, 3)]),
    "conv2d_depthwise": (lambda F, x, w: F.conv2d(
        x, w, stride=2, padding=1, groups=4), [(1, 4, 7, 7), (4, 1, 3, 3)]),
    "conv3d": (lambda F, x, w: F.conv3d(x, w, None, (1, 2, 2), 1),
               [(1, 2, 4, 5, 5), (3, 2, 2, 3, 3)]),
    "conv3d_ndhwc_same": (lambda F, x, w: F.conv3d(
        x, w, stride=2, padding="SAME", data_format="NDHWC"),
        [(1, 5, 4, 5, 2), (3, 2, 3, 2, 3)]),
    "conv1d_transpose": (lambda F, x, w, b: F.conv1d_transpose(
        x, w, b, 2, 1, 1), [(2, 4, 5), (4, 3, 3), (3,)]),
    "conv2d_transpose": (lambda F, x, w, b: F.conv2d_transpose(
        x, w, b, 2, [1, 0], 1, 2), [(1, 4, 4, 5), (4, 2, 3, 3), (4,)]),
    "conv2d_transpose_same": (lambda F, x, w: F.conv2d_transpose(
        x, w, stride=2, padding="SAME", dilation=2, data_format="NHWC"),
        [(1, 4, 4, 3), (3, 2, 3, 3)]),
    "conv3d_transpose": (lambda F, x, w: F.conv3d_transpose(x, w, None, 2,
                                                            1, 1),
                         [(1, 2, 3, 3, 3), (2, 3, 3, 3, 3)]),
    "avg_pool1d_ceil": (lambda F, x: F.avg_pool1d(x, 3, 2, 1,
                                                  ceil_mode=True),
                        [(2, 3, 10)]),
    "avg_pool2d_inclusive": (lambda F, x: F.avg_pool2d(
        x, 3, 2, 1, exclusive=False), [(2, 3, 7, 7)]),
    "avg_pool2d_ceil_exclusive": (lambda F, x: F.avg_pool2d(
        x, 3, 2, [1, 0], ceil_mode=True), [(1, 3, 8, 7)]),
    "avg_pool2d_divisor_nhwc": (lambda F, x: F.avg_pool2d(
        x, 2, 1, 1, divisor_override=3, data_format="NHWC"),
        [(1, 5, 5, 2)]),
    "avg_pool3d": (lambda F, x: F.avg_pool3d(x, 2, 2, 1, ceil_mode=True),
                   [(1, 2, 5, 4, 5)]),
    "max_pool1d": (lambda F, x: F.max_pool1d(x, 3, 2, 1), [(2, 3, 9)]),
    "max_pool2d_mask": (lambda F, x: F.max_pool2d(x, 3, 2, 1,
                                                  return_mask=True),
                        [(2, 3, 7, 7)]),
    "max_pool2d_ceil_same": (lambda F, x: F.max_pool2d(x, 3, 2, 0,
                                                       ceil_mode=True)
                             + 0 * F.max_pool2d(x, 3, 2, "SAME").sum(),
                             [(1, 3, 8, 6)]),
    "max_pool3d_mask": (lambda F, x: F.max_pool3d(x, 2, 2, 1,
                                                  return_mask=True),
                        [(1, 2, 4, 5, 4)]),
    "adaptive_avg_pool1d": (lambda F, x: F.adaptive_avg_pool1d(x, 4),
                            [(2, 3, 9)]),
    "adaptive_avg_pool2d_nhwc": (lambda F, x: F.adaptive_avg_pool2d(
        x, 3, "NHWC"), [(1, 5, 7, 2)]),
    "adaptive_avg_pool3d": (lambda F, x: F.adaptive_avg_pool3d(x, [2, 3, 1]),
                            [(1, 2, 4, 5, 3)]),
    "adaptive_max_pool1d": (lambda F, x: F.adaptive_max_pool1d(x, 4),
                            [(2, 3, 10)]),
    "adaptive_max_pool2d": (lambda F, x: F.adaptive_max_pool2d(x, [3, 4]),
                            [(1, 3, 7, 8)]),
    "adaptive_max_pool3d": (lambda F, x: F.adaptive_max_pool3d(x, 2),
                            [(1, 2, 5, 4, 3)]),
    "max_unpool1d": (lambda F, x: F.max_unpool1d(
        *F.max_pool1d(x, 2, return_mask=True), 2), [(2, 3, 8)]),
    "max_unpool2d": (lambda F, x: F.max_unpool2d(
        *F.max_pool2d(x, 2, return_mask=True), 2, output_size=[6, 6]),
        [(1, 2, 6, 6)]),
    "max_unpool3d": (lambda F, x: F.max_unpool3d(
        *F.max_pool3d(x, 2, return_mask=True), 2), [(1, 2, 4, 4, 4)]),
    "gather_tree": (lambda F, i, p: F.gather_tree(i, p),
                    [("ids", (5, 2, 3), 9), ("ids", (5, 2, 3), 3)]),
    "hsigmoid_loss": (lambda F, x, y, w, b: F.hsigmoid_loss(x, y, 7, w, b),
                      [(4, 6), ("ids", (4,), 7), (6, 6), (6,)]),
    "rnnt_loss": (_rnnt, [(2, 5, 4, 6)]),
    "multi_margin_loss": (lambda F, x, y: F.multi_margin_loss(
        x, y, p=2, margin=0.5), [(4, 5), ("ids", (4,), 5)]),
    "margin_cross_entropy": (lambda F, x, y: F.margin_cross_entropy(
        x.tanh() * 0.9, y, 1.0, 0.3, 0.1, 8.0), [(4, 6), ("ids", (4,), 6)]),
    "ctc_loss": (_ctc, [(8, 2, 5)]),
}


def _rnn_out(layer, x, lens):
    return layer(x, None, lens)


def _mha_cache(layer, q, kv):
    cache = layer.gen_cache(q)
    out1, cache = layer(q, q, q, None, cache)
    out2, cache = layer(kv, kv, kv, None, cache)
    return out1, out2, cache.k, cache.v


def _mha_static(layer, q, mem):
    out, cache = layer(q, mem, mem, None,
                       layer.gen_cache(mem, mem, type=layer.StaticCache))
    return out, cache.k


def _decoder_cached(layer, tgt, mem):
    cache = layer.gen_cache(mem)
    out1, cache = layer(tgt[:, :2], mem, None, None, cache)
    out2, _ = layer(tgt[:, 2:], mem, None, None, cache)
    return out1, out2


A14B_LAYERS = {
    "Conv1D": ((3, 4, 3), {"stride": 2, "padding": 1}, [(2, 3, 9)]),
    "Conv2D": ((4, 6, 3), {"padding": "SAME", "stride": 2, "groups": 2,
                           "data_format": "NHWC"}, [(1, 7, 6, 4)]),
    "Conv3D": ((2, 3, [2, 3, 3]), {"padding": 1, "bias_attr": False},
               [(1, 2, 4, 6, 5)]),
    "Conv1DTranspose": ((4, 3, 3), {"stride": 2, "padding": 1,
                                    "output_padding": 1}, [(2, 4, 5)]),
    "Conv2DTranspose": ((4, 6, 3), {"stride": 2, "groups": 2},
                        [(1, 4, 4, 5)]),
    "Conv3DTranspose": ((2, 3, 2), {"stride": 2}, [(1, 2, 3, 2, 3)]),
    "AvgPool1D": ((3, 2, 1), {"ceil_mode": True}, [(2, 3, 10)]),
    "AvgPool2D": ((3, 2, 1), {"exclusive": False}, [(2, 3, 7, 7)]),
    "AvgPool3D": ((2, 2), {"divisor_override": 3}, [(1, 2, 4, 4, 4)]),
    "MaxPool1D": ((3, 2, 1), {"return_mask": True}, [(2, 3, 9)]),
    "MaxPool2D": ((3, 2, 1), {"ceil_mode": True}, [(1, 3, 8, 8)]),
    "MaxPool3D": ((2,), {}, [(1, 2, 4, 4, 4)]),
    "AdaptiveAvgPool1D": ((4,), {}, [(2, 3, 9)]),
    "AdaptiveAvgPool2D": (((1, 1),), {}, [(2, 8, 7, 7)]),
    "AdaptiveAvgPool3D": ((2,), {}, [(1, 2, 5, 4, 3)]),
    "AdaptiveMaxPool1D": ((3,), {}, [(2, 3, 8)]),
    "AdaptiveMaxPool2D": (([3, 2],), {}, [(1, 3, 7, 5)]),
    "AdaptiveMaxPool3D": ((2,), {}, [(1, 2, 4, 5, 3)]),
    "MaxUnPool1D": ((2,), {}, [(2, 3, 8)],
                    lambda l, x: l(*pt_functional().max_pool1d(
                        x, 2, return_mask=True))),
    "MaxUnPool2D": ((2,), {"output_size": [6, 6]}, [(1, 2, 6, 6)],
                    lambda l, x: l(*pt_functional().max_pool2d(
                        x, 2, return_mask=True))),
    "MaxUnPool3D": ((2, 2), {}, [(1, 2, 4, 4, 4)],
                    lambda l, x: l(*pt_functional().max_pool3d(
                        x, 2, return_mask=True))),
    "CTCLoss": ((), {}, [(8, 2, 5)], lambda l, x: l(
        x, torch_cu(x, [[1, 2, 2], [3, 1, 0]]), torch_cu(x, [8, 6]),
        torch_cu(x, [3, 2]))),
    "HSigmoidLoss": ((6, 7), {}, [(4, 6), ("ids", (4,), 7)]),
    "MultiMarginLoss": ((), {"margin": 0.7}, [(4, 5), ("ids", (4,), 5)]),
    "RNNTLoss": ((), {"fastemit_lambda": 0.01}, [(2, 5, 4, 6)],
                 lambda l, x: l(x, torch_cu(x, [[1, 2, 3], [4, 5, 0]]),
                                torch_cu(x, [5, 4]), torch_cu(x, [3, 2]))),
    "SimpleRNNCell": ((5, 7), {}, [(3, 5), (3, 7)]),
    "LSTMCell": ((5, 7), {}, [(3, 5), (3, 7), (3, 7)],
                 lambda l, x, h, c: l(x, (h, c))),
    "GRUCell": ((5, 7), {}, [(3, 5), (3, 7)]),
    "RNN": ("rnn", {}, [(3, 6, 5), ("ids", (3,), 7)], _rnn_out),
    "BiRNN": ("birnn", {}, [(3, 6, 5), ("ids", (3,), 7)], _rnn_out),
    "SimpleRNN": ((5, 7, 2), {"activation": "relu"}, [(3, 6, 5)]),
    "LSTM": ((5, 7, 2), {"direction": "bidirect"},
             [(3, 6, 5), ("ids", (3,), 7)], _rnn_out),
    "GRU": ((5, 7, 2), {"direction": "bidirectional", "time_major": True},
            [(6, 3, 5)]),
    "MultiHeadAttention": ((16, 4), {}, [(2, 3, 16), (2, 1, 16)],
                           _mha_cache),
    "MultiHeadAttention_static": ((16, 4), {"kdim": 16}, [(2, 4, 16),
                                                          (2, 6, 16)],
                                  _mha_static),
    "TransformerEncoderLayer": ((16, 4, 32, 0.0), {"normalize_before": True},
                                [(2, 7, 16)]),
    "TransformerEncoder": ("encoder", {}, [(2, 7, 16)]),
    "TransformerDecoderLayer": ((16, 4, 32, 0.0), {}, [(2, 4, 16),
                                                       (2, 6, 16)],
                                _decoder_cached),
    "TransformerDecoder": ("decoder", {}, [(2, 5, 16), (2, 7, 16)]),
    "Transformer": ((16, 4, 1, 1, 32, 0.0), {}, [(2, 7, 16), (2, 5, 16)]),
}
# the sweep's cases that run a convolution (TF32 in fp32 on the card)
A14B_TF32 = {n for n in list(A14B_FUNCTIONS) + list(A14B_LAYERS)
             if n.lower().startswith("conv")}


def pt_functional():
    import paddle_tpu_torch as pt

    return pt.nn.functional


def _a14b_layer(pt, name, spec, dtype):
    """A layer of A14B_LAYERS built in ``dtype`` on the current place."""
    nn = pt.nn
    args, kwargs = spec[0], spec[1]
    prev = pt.get_default_dtype()
    pt.set_default_dtype(dtype)
    try:
        if args == "rnn":
            return nn.RNN(nn.GRUCell(5, 7), is_reverse=True)
        if args == "birnn":
            return nn.BiRNN(nn.LSTMCell(5, 7), nn.LSTMCell(5, 7))
        if args == "encoder":
            return nn.TransformerEncoder(
                nn.TransformerEncoderLayer(16, 4, 32, 0.0), 2,
                nn.LayerNorm(16))
        if args == "decoder":
            return nn.TransformerDecoder(
                nn.TransformerDecoderLayer(16, 4, 32, 0.0,
                                           normalize_before=True), 2)
        return getattr(nn, name.split("_")[0])(*args, **kwargs)
    finally:
        pt.set_default_dtype(prev)


def follow_card_relu(torch, F, card, cpu) -> dict:
    """Wraps the ReLU activations of ``card``'s sublayers and of their
    twins in ``cpu`` (the same layer on the CPU). The card's wrapper runs
    F.relu and records which units each call passes; the CPU's, called in
    the same order, passes the card's units: where the two sides differ,
    the CPU's pre-activation must lie within RELU_NEAR_TIE of the call's
    largest magnitude, else it raises. So both sides take the same side of
    the kink, and the gradients compare the layers, not a near-tie's two
    outcomes. Returns the tally the wrappers fill (``sites``: the ReLUs
    wrapped)."""
    tally = {"sites": 0, "units": 0, "flips": 0, "flip_max_pre": 0.0,
             "left": []}

    def wrap(a, b, where):
        masks = []

        def record(x):
            masks.append((x > 0).detach().cpu())
            return F.relu(x)

        def follow(x):
            if not masks:
                raise AssertionError(f"{where}: ReLU called more often on "
                                     f"the CPU than on the card")
            keep = masks.pop(0)
            pre = x.detach().float().abs()
            flipped = keep != (x.detach() > 0)
            tally["units"] += x.numel()
            if bool(flipped.any()):
                top = float(pre.max())
                far = float(pre[flipped].max())
                if far > RELU_NEAR_TIE * top:
                    raise AssertionError(
                        f"{where}: ReLU passes other units on the card and "
                        f"the CPU, at a CPU pre-activation of {far:.4g} "
                        f"> {RELU_NEAR_TIE} x {top:.4g}")
                tally["flips"] += int(flipped.sum())
                tally["flip_max_pre"] = max(tally["flip_max_pre"],
                                            far / top)
            return torch.where(keep, x, torch.zeros_like(x))

        a.activation, b.activation = record, follow
        tally["left"].append(masks)

    for (n, a), (_, b) in zip(card.named_sublayers(include_self=True),
                              cpu.named_sublayers(include_self=True)):
        if getattr(a, "activation", None) is F.relu:
            wrap(a, b, n or type(a).__name__)
            tally["sites"] += 1
    return tally


def a14b_sweep(torch, pt, np, dev):
    """Every function and layer of this slice's nn modules on ``dev``
    against its CPU twin, fp32 and bf16, forward and the gradients of
    sum(out * w) for every float input and parameter, as nn_sweep does;
    fp32 cases that run a convolution within TF32_SWEEP. The transformer
    layers keep their default ReLU; the CPU follows the card's side of
    its kink up to RELU_NEAR_TIE (follow_card_relu), at most
    RELU_FLIP_SHARE of the units a case."""
    F = pt.nn.functional
    t0 = time.perf_counter()
    fns = {n for m in ("conv", "pooling", "sequence_loss")
           for n in importlib.import_module(
               f"paddle_tpu_torch.nn.functional.{m}").__all__} | {"ctc_loss"}
    have = {n.split("_")[0] if n[0].isupper() else n for n in A14B_LAYERS}
    have |= {re.sub(r"_(nlc|nhwc|same.*|stride2|depthwise|ndhwc.*|"
                    r"inclusive|ceil.*|divisor.*|mask)$", "", n)
             for n in A14B_FUNCTIONS}
    layers = {n for m in ("conv", "pooling", "rnn", "transformer")
              for n in importlib.import_module(
                  f"paddle_tpu_torch.nn.layer.{m}").__all__}
    layers |= {"CTCLoss", "HSigmoidLoss", "MultiMarginLoss", "RNNTLoss"}
    missing = (fns | layers) - have - {"RNNCellBase"}
    if missing:
        raise AssertionError(f"A14b sweep: no case for {sorted(missing)}")
    worst, n_cases, failed, relu_flips = {}, 0, [], {}
    names = sorted(A14B_FUNCTIONS) + sorted(A14B_LAYERS)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for i, name in enumerate(names):
            is_layer = name in A14B_LAYERS
            if is_layer:
                spec = A14B_LAYERS[name]
                specs = spec[2]
                call = spec[3] if len(spec) > 3 else (lambda l, *xs: l(*xs))
            else:
                fcall, specs = A14B_FUNCTIONS[name]
            ins = nn_inputs(torch, np, specs, i, tdt)
            if is_layer:
                with _cpu_place():
                    layer = _a14b_layer(pt, name, spec, dtype)
                card = _a14b_layer(pt, name, spec, dtype)
                card.set_state_dict(layer.state_dict())
                for m in (layer, card):
                    m.eval()
                relu = follow_card_relu(torch, F, card, layer)
                if name.startswith("Transformer") and not relu["sites"]:
                    raise AssertionError(f"A14b sweep: {name} runs no ReLU")
            outs = {}
            for where, model in (("card", card if is_layer else None),
                                 ("cpu", layer if is_layer else None)):
                d = dev if where == "card" else torch.device("cpu")
                xs = [t.to(d).requires_grad_() if g else t.to(d)
                      for t, g in ins]
                out = call(model, *xs) if is_layer else fcall(F, *xs)
                leaves = [x for x in xs if x.requires_grad]
                if is_layer:
                    # the key projection's bias has a gradient of 0 (the
                    # softmax cancels a shift of every key): its values are
                    # rounding noise on both sides, and its forward is held
                    # through the outputs
                    leaves += [p for n, p in model.named_parameters()
                               if p.requires_grad
                               and not n.endswith("k_proj.bias")]
                first = _tensors(out)[0]
                grads = (_grads(torch, pt, out, leaves)
                         if leaves and first.is_floating_point() else None)
                outs[where] = (out, grads)
            (got, g_card), (want, g_cpu) = outs["card"], outs["cpu"]
            tol = ("tf32" if dtype == "float32" and name in A14B_TF32
                   else _nn_tol(dtype))
            what = f"{name} {dtype}"
            if is_layer and relu["sites"]:
                if any(relu.pop("left")) or relu["flips"] > (
                        RELU_FLIP_SHARE * relu["units"]):
                    failed.append(f"{what}: ReLU calls or flips off: {relu}")
                    continue
                relu_flips[what] = relu
            try:
                err = sweep_compare(torch, what, got, want, tol, dev)
                if g_card is not None:
                    err = max(err, sweep_compare(torch, f"{what} grad",
                                                 g_card, g_cpu, tol, dev))
            except AssertionError as e:     # every case runs, then raise
                failed.append(str(e))
                continue
            worst[what] = err
            n_cases += 1
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"A14b sweep: {len(failed)} cases failed: "
                             + "; ".join(failed))
    return {"functions": len(A14B_FUNCTIONS), "layers": len(A14B_LAYERS),
            "cases": n_cases, "max_abs_err": worst, "relu": relu_flips,
            "s": time.perf_counter() - t0}


def nn_vision_phase(torch, dev, np, seed, profile=False):
    """Phase 12: ResNet-50 trained at full width and depth, every vision
    model against its CPU twin, the ResNet-50 twin and the TF32 effect,
    nn.Transformer at the base widths with cached greedy decoding, the
    LSTM / GRU leg with beam search, and the A14b sweep."""
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rec = {"resnet": resnet_train(torch, np, dev, seed, profile)}
    rec["vision"] = vision_twins(torch, np, dev)
    rec["resnet_twin"] = resnet_twin(torch, np, dev)
    rec["transformer"] = transformer_leg(torch, np, dev, seed, profile)
    rec["rnn"] = rnn_leg(torch, np, dev)
    from paddle_tpu_torch import ops

    ops.reset_launch_counts()
    rec["sweep"] = a14b_sweep(torch, pt, np, dev)
    # the vision leg and the sweep run no kernel of the port: their counts
    rec["vision"].update(launches=ops.launch_counts(),
                         route_calls=ops.route_calls())
    rec["s"] = time.perf_counter() - t0
    return rec


def log_nn_vision(rec, smi) -> None:
    """Phase 12's lines."""
    r = rec["resnet"]
    log(f"[nn-vision] resnet50 {r['batch']}x3x{r['image']}x{r['image']} "
        f"({r['config']}, {r['params']} params) through Model.fit: step "
        f"{r['step_s_median']:.4f} s (steps {r['step_s']}), "
        f"{r['images_per_s']:.1f} images/s, MFU {r['mfu']:.4f}; on a batch "
        f"already on the card {r['staged_step_s_median']:.4f} s, "
        f"{r['staged_images_per_s']:.1f} images/s, MFU "
        f"{r['staged_mfu']:.4f} "
        f"({r['flops_per_image_fwd'] / 1e9:.3f} GFLOPs forward per image, "
        f"3x for a step, against {r['peak_flops'] / 1e12:.1f} TFLOP/s "
        f"{r['peak_source']}), peak {r['peak_mem_gb']:.2f} GiB "
        f"({r['base_mem_gb']:.2f} held before), losses {r['losses']}, init "
        f"{r['model_init_s']:.1f} s  [{smi}]")
    if "profile" in r:
        log(f"[nn-vision] resnet50 step under the profiler: device busy "
            f"{r['profile']['device_busy_share']:.1%} of "
            f"{r['profile']['wall_ms']:.1f} ms  [{smi}]")
    v = rec["vision"]
    for mode in ("tf32", "ieee"):
        worst = sorted(v["models"].items(),
                       key=lambda kv: -kv[1][mode]["grad_rel_err"])[:4]
        out_errs = [m[mode]["out_rel_err"] for m in v["models"].values()]
        log(f"[nn-vision] {len(v['models'])} vision models in eval mode, "
            f"fp32 ({mode} convolutions) on the card against the CPU: "
            f"largest output error {max(out_errs):.3g} of the top; "
            f"largest gradient errors " + ", ".join(
                f"{k} {m[mode]['grad_rel_err']:.3g} (worst tensor "
                f"{m[mode]['grad_max_rel_err']:.3g})" for k, m in worst)
            + f" ({v['s']:.1f} s both)")
    t = rec["resnet_twin"]
    c = t["cpu_f32"]
    log(f"[nn-vision] resnet50 twin {t['batch']}x3x{t['image']}x"
        f"{t['image']}, training mode, one Momentum step, against fp64 on "
        f"the CPU: the CPU's fp32 loss off by {c['loss_abs_err']:.3g}, "
        f"gradients {c['grad_rel_err']:.3g} of their norm, statistics "
        f"{c['stats_max_rel_err']:.3g}")
    for mode in ("tf32", "ieee"):
        e = t[mode]
        log(f"[nn-vision] resnet50 twin ({mode}): loss {e['loss_card']:.6f} "
            f"on the card ({t['loss_f64']:.6f} fp64), off by "
            f"{e['loss_abs_err']:.3g}; gradients {e['grad_rel_err']:.3g} of "
            f"their norm (worst tensor {e['grad_max_rel_err']:.3g}, "
            f"{e['grad_worst']}), statistics {e['stats_max_rel_err']:.3g}; "
            f"a second card run: loss gap "
            f"{e['rerun_gap']['loss_abs_err']:.3g}, gradients "
            f"{e['rerun_gap']['grad_rel_err']:.3g}")
    tt = t["tf32_time"]
    log(f"[nn-vision] resnet50 fp32 step at batch {tt['batch']}: TF32 "
        f"{tt['tf32_ms']:.2f} ms ({tt['tf32_images_per_s']:.1f} images/s), "
        f"IEEE {tt['ieee_ms']:.2f} ms ({tt['ieee_images_per_s']:.1f} "
        f"images/s)  [{smi}]")
    tr = rec["transformer"]
    d, tw = tr["decode"], tr["twin"]
    log(f"[nn-vision] transformer ({tr['config']}, {tr['params']} params), "
        f"{tr['batch']}x{tr['src']} source ({tr['src_tokens']} real) + "
        f"{tr['batch']}x{tr['tgt']} target tokens: step "
        f"{tr['step_s_median']:.4f} s (steps {tr['step_s']}), "
        f"{tr['tgt_tokens_per_s']:.1f} target tokens/s, "
        f"{tr['tokens_per_s']:.1f} tokens/s, losses {tr['losses']}; greedy "
        f"decode of {d['tokens']} tokens x {d['rows']} rows through the "
        f"caches {d['cached_ms_per_token']:.2f} ms/token, equal to the full "
        f"passes but {d['near_tie_flips']} near-tie flips; {tw['layers']}"
        f"-layer fp32 twin: loss {tw['loss_card']:.6f} / {tw['loss_cpu']:.6f},"
        f" gradients within {tw['grad_max_rel_err']:.3g}  [{smi}]")
    rn = rec["rnn"]
    for kind in ("LSTM", "GRU"):
        for dt in ("float32", "bfloat16"):
            x = rn[f"{kind}_{dt}"]
            log(f"[nn-vision] {kind} {rn['input']}->{rn['hidden']} x"
                f"{rn['layers']} bidirect, {rn['batch']}x{rn['steps']} "
                f"ragged, {dt}: forward {x['fwd_ms']:.2f} ms, forward + "
                f"backward {x['fwd_bwd_ms']:.2f} ms "
                f"({x['fwd_bwd_ms_per_step']:.3f} ms a step)  [{smi}]")
    log(f"[nn-vision] LSTM fp32 forward against the CPU "
        f"{rn['lstm_f32_max_abs_err']:.3g}; beam search ({rn['beam']['beam']}"
        f" beams, {rn['beam']['steps']} steps, batch {rn['beam']['batch']}) "
        f"ids equal on the card and the CPU")
    sw = rec["sweep"]
    log(f"[nn-vision] A14b sweep: {sw['functions']} functions and "
        f"{sw['layers']} layers in fp32 and bf16 ({sw['cases']} cases) in "
        f"{sw['s']:.1f} s; largest errors " + ", ".join(
            f"{k} {v:.3g}" for k, v in sorted(
                sw["max_abs_err"].items(), key=lambda kv: -kv[1])[:6]))


# phase 13: the rest of paddle.vision, hapi's summary and flops and
# paddle.text. Every model function of classic2.py in eval mode, fp32, on
# the card against its CPU twin at CLASSIC2_TWIN (InceptionV3 at 299): the
# logits held by the tests' near() rule against the CPU twin in fp64 (the
# card and the CPU's fp32 each at most TWIN_FACTOR times as far from it as
# the other, plus 1e-6 of its largest magnitude), all the gradients (the
# input's and every parameter's) within VISION_F32_JOINT of their joint
# norm; one model of each family trained for CLASSIC2_TRAIN["steps"] timed
# steps at batch 64 under O1 bf16 (Momentum, as phase 12's ResNet-50);
# summary and flops of SUMMARY_MODELS on the card equal to the CPU's
CLASSIC2_TWIN = dict(batch=2, image=224, inception=299)
CLASSIC2_TRAIN = dict(batch=64, steps=3, lr=0.1, momentum=0.9,
                      weight_decay=1e-4,
                      models=("densenet121", "googlenet", "inception_v3",
                              "mobilenet_v3_small", "shufflenet_v2_x1_0"))
GOOGLENET_AUX = 0.3         # the auxiliary losses' weight, Szegedy et al. 2015
SUMMARY_MODELS = ("resnet50", "mobilenet_v3_large")
# MobileNetV3-Large through the ImageNet input pipeline: the per-GPU batch,
# RMSProp's learning rate, momentum, decay rate (alpha 0.9) and epsilon
# (0.0316, torchvision's train.py for RMSProp) and the weight decay of
# torchvision's public MobileNetV3-Large recipe; a DatasetFolder of seeded
# uint8 .npy images in class folders; the train transforms in PaddleClas's
# order (RandomResizedCrop, RandomHorizontalFlip, then CHW and the
# ImageNet mean and std in 0-255 units); DataLoader with 8 worker
# processes into Model.fit (a warm-up batch and `timed` ones), then
# `staged` steps on a batch already on the card
PIPELINE = dict(batch=128, images=1024, classes=8, side=(300, 500),
                workers=8, timed=6, staged=3, lr=0.064,
                momentum=0.9, rho=0.9, epsilon=0.0316, weight_decay=1e-5,
                mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
# the detection operators at published detectors' widths, each on the card
# against its CPU twin on the same inputs: Faster R-CNN's RPN at
# py-faster-rcnn's test configuration (two 800 x 1333 images, a stride-16
# feature of 50 x 84, 9 anchors of scales 128 / 256 / 512 and ratios 0.5 /
# 1 / 2, 6000 boxes before NMS and 300 after at IoU 0.7, RPN_MIN_SIZE 16);
# the R50-C4 RoI head (Detectron's e2e_faster_rcnn_R-50-C4: 1024 channels,
# RoIAlign to 14 x 14 at 1/16, sampling_ratio 0, aligned) over those
# proposals, RoIPool and PSRoIPool (490 = 10 x 7 x 7 channels to 7 x 7)
# at its shapes, the CPU twins over the first `twin_rois` proposals of
# each image (the card runs and times all of them); FPN's level
# assignment (Lin et al. 2017, eq. 1); YOLOv3 at 608 (Redmon & Farhadi
# 2018: 80 classes, the nine COCO anchors, masks 6-8 / 3-5 / 0-2 at strides
# 32 / 16 / 8) at batch 8, 50 ground-truth rows an image of which a seeded
# share is padding, and matrix_nms and nms over the decoded boxes; DCNv2
# (Zhu et al. 2019) as ResNet-50's stage-5 3x3 at an 800 x 1333 input;
# SSD300's conv4_3 priors and box coding
RPN = dict(images=2, height=800, width=1333, stride=16,
           scales=(128, 256, 512), ratios=(0.5, 1.0, 2.0),
           pre_nms_top_n=6000, post_nms_top_n=300, nms_thresh=0.7,
           min_size=16.0)
ROI_HEAD = dict(channels=1024, output=14, ps_channels=490, ps_output=7,
                twin_rois=32)
FPN = dict(rois=1000, min_level=2, max_level=5, refer_level=4,
           refer_scale=224)
YOLO = dict(batch=8, image=608, classes=80,
            anchors=[10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116,
                     90, 156, 198, 373, 326],
            masks=((6, 7, 8), (3, 4, 5), (0, 1, 2)), strides=(32, 16, 8),
            conf_thresh=0.005, ignore_thresh=0.7, gt=50, pad_share=0.4,
            nms_boxes=2000, nms_iou=0.45, nms_keep=100, score_keep=0.05,
            matrix=dict(score_threshold=0.01, post_threshold=0.01,
                        nms_top_k=400, keep_top_k=100, background_label=-1))
DCN = dict(batch=8, channels=512, height=25, width=42)
SSD = dict(feature=38, channels=512, image=300, min_size=30.0,
           max_size=60.0, ratio=2.0, gt=50, batch=8)
# a CoNLL-2003 NER tagger's decoding: 9 BIO tags plus BOS and EOS, 64
# sentences of 20-128 tokens padded to 128
TEXT = dict(tags=9, batch=64, length=128, min_len=20, reps=5)
# the detection operators' fp32 tolerance against the CPU: 1e-5 of the
# output's largest magnitude plus 1e-5 of each element (the same formulas
# summed in other orders: atomics in the gathers' backward, cuBLAS in
# deform_conv2d's contraction); the selections (indices, RoIs, levels,
# counts, the Viterbi paths and scores) bitwise
DET_REL = 1e-5


def _near_twin(torch, got, ref, exact):
    """The tests' near(): ``got`` and ``ref`` each at most TWIN_FACTOR
    times as far from ``exact`` as the other (max norm), plus 1e-6 of
    ``exact``'s largest magnitude. Returns the two distances and whether
    they pass."""
    exact = exact.double()
    e_got = float((got.double() - exact).abs().max())
    e_ref = float((ref.double() - exact).abs().max())
    floor = 1e-6 * max(float(exact.abs().max()), 1e-30)
    ok = (e_got <= TWIN_FACTOR * e_ref + floor
          and e_ref <= TWIN_FACTOR * e_got + floor)
    return e_got, e_ref, ok


def classic2_twins(torch, np, dev):
    """Every classic2 model function in eval mode, fp32 (TF32 off), forward
    and backward of sum(out * ramp) on the card and on the CPU, the fp64
    CPU twin's forward as the yardstick."""
    import copy

    from paddle_tpu_torch.vision.models import classic2

    t0 = time.perf_counter()
    rec = {}
    for i, name in enumerate(n for n in classic2.__all__ if n[0].islower()):
        gpu, cpu = _twin_pair(torch, getattr(classic2, name), dev, 100 + i)
        for m in (gpu, cpu):
            m.eval()
        s = CLASSIC2_TWIN["inception" if name == "inception_v3" else "image"]
        x = torch.randn(CLASSIC2_TWIN["batch"], 3, s, s,
                        generator=torch.Generator().manual_seed(100 + i))
        want, g_cpu = _fwd_bwd(torch, cpu, x, "cpu")
        got, g_gpu = _fwd_bwd(torch, gpu, x, dev)
        with torch.no_grad():
            exact = copy.deepcopy(cpu).double()(x.double())
        e_card, e_cpu, ok = _near_twin(torch, got, want, exact)
        worst_err, worst, total = _grad_errs(torch, g_gpu, g_cpu)
        if (not ok or total > VISION_F32_JOINT
                or not torch.isfinite(got).all()):
            raise AssertionError(
                f"classic2 {name}: logits {e_card:.3g} from fp64 on the "
                f"card, {e_cpu:.3g} on the CPU; gradients {total:.3g} of "
                f"their norm ({worst} {worst_err:.3g})")
        rec[name] = {"image": s, "out_err_card": e_card,
                     "out_err_cpu": e_cpu,
                     "out_scale": float(exact.abs().max()),
                     "grad_rel_err": total, "grad_max_rel_err": worst_err,
                     "grad_worst": worst,
                     "params": sum(p.numel() for p in cpu.parameters())}
        del gpu, cpu
    torch.cuda.empty_cache()
    return {"models": rec, "s": time.perf_counter() - t0}


def _googlenet_loss(pt):
    """GoogLeNet's training loss: the main cross entropy plus GOOGLENET_AUX
    times each auxiliary head's."""
    ce = pt.nn.CrossEntropyLoss()

    class Loss(pt.nn.Layer):
        def forward(self, out, aux1, aux2, label):
            return ce(out, label) + GOOGLENET_AUX * (ce(aux1, label)
                                                     + ce(aux2, label))

    return Loss()


def classic2_train(torch, np, dev, seed):
    """One model of each classic2 family: a warm-up step and
    CLASSIC2_TRAIN["steps"] timed ones through Model.train_batch at batch
    64 on a batch already on the card, O1 bf16, Momentum."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision import models

    rec = {}
    b = CLASSIC2_TRAIN["batch"]
    for name in CLASSIC2_TRAIN["models"]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pt.seed(seed)
        net = getattr(models, name)()
        s = CLASSIC2_TWIN["inception" if name == "inception_v3" else "image"]
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(b, 3, s, s, generator=g).to(dev)
        y = torch.randint(0, 1000, (b,), generator=g).to(dev)
        opt = pt.optimizer.Momentum(
            learning_rate=CLASSIC2_TRAIN["lr"],
            momentum=CLASSIC2_TRAIN["momentum"], parameters=net.parameters(),
            weight_decay=pt.optimizer.L2Decay(CLASSIC2_TRAIN["weight_decay"]))
        model = pt.Model(net)
        loss = (_googlenet_loss(pt) if name == "googlenet"
                else pt.nn.CrossEntropyLoss())
        model.prepare(opt, loss,
                      amp_configs={"level": "O1", "dtype": "bfloat16"})
        losses, times = [], []
        for _ in range(1 + CLASSIC2_TRAIN["steps"]):
            t = time.perf_counter()
            losses.append(model.train_batch([x], [y])[0])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        if not np.isfinite(losses).all():
            raise AssertionError(f"classic2 {name}: losses {losses}")
        step = statistics.median(times[1:])
        rec[name] = {"image": s, "batch": b, "losses": losses,
                     "step_s": times, "step_s_median": step,
                     "images_per_s": b / step,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "params": sum(p.numel() for p in net.parameters())}
        del model, net, opt, x, y
    torch.cuda.empty_cache()
    return rec


def summary_flops(torch, dev):
    """``summary`` and ``flops`` of SUMMARY_MODELS at 1 x 3 x 224 x 224 on
    the card and on the CPU (their tables printed into a buffer): equal
    totals, equal tables."""
    import contextlib
    import copy
    import io

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision import models

    rec = {}
    size = (1, 3, 224, 224)
    for name in SUMMARY_MODELS:
        pt.seed(0)
        gpu = getattr(models, name)()
        cpu = copy.deepcopy(gpu).to("cpu")
        out = {}
        for where, net in (("card", gpu), ("cpu", cpu)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                s = pt.summary(net, size)
            out[where] = (s, buf.getvalue(), pt.flops(net, list(size)))
        if out["card"] != out["cpu"] or out["card"][2] <= 0:
            raise AssertionError(f"summary/flops {name}: card "
                                 f"{out['card'][0]} {out['card'][2]}, CPU "
                                 f"{out['cpu'][0]} {out['cpu'][2]}")
        rec[name] = dict(out["card"][0], flops=out["card"][2],
                         table_rows=len(out["card"][1].splitlines()) - 8)
        del gpu, cpu
    return rec


def classic2_leg(torch, np, dev, seed):
    from paddle_tpu_torch import ops

    ops.reset_launch_counts()
    rec = {"twins": classic2_twins(torch, np, dev),
           "train": classic2_train(torch, np, dev, seed),
           "summary": summary_flops(torch, dev)}
    rec.update(launches=ops.launch_counts(), route_calls=ops.route_calls())
    return rec


def write_image_folder(np, root, seed):
    """PIPELINE["images"] seeded uint8 HWC images of 300-500 x 300-500 as
    .npy files in PIPELINE["classes"] class folders under ``root``."""
    rng = np.random.RandomState(seed)
    lo, hi = PIPELINE["side"]
    nbytes = 0
    for i in range(PIPELINE["images"]):
        d = os.path.join(root, f"class_{i % PIPELINE['classes']:02d}")
        os.makedirs(d, exist_ok=True)
        h, w = rng.randint(lo, hi + 1, 2)
        arr = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        np.save(os.path.join(d, f"{i:05d}.npy"), arr)
        nbytes += arr.nbytes
    return nbytes


def pipeline_leg(torch, np, dev, seed, profile=False):
    """MobileNetV3-Large trained through the ImageNet input pipeline
    (PIPELINE): Model.fit over a DataLoader of 8 worker processes, the
    step time from the callbacks (the batch's copy to the card, forward,
    backward, RMSProp), the consumer's wait for each batch (the
    loader's paddle_tpu_dataloader_wait_seconds histogram, the monitor
    on), images/s; then steps on a batch already on the card; the image
    folder is written to a temporary directory and removed after."""
    import shutil
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io, monitor, ops
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.vision import datasets, models
    from paddle_tpu_torch.vision import transforms as T

    P = PIPELINE
    root = tempfile.mkdtemp(prefix="chip_smoke_images_")
    try:
        t = time.perf_counter()
        nbytes = write_image_folder(np, root, seed)
        write_s = time.perf_counter() - t
        ds = datasets.DatasetFolder(root, transform=T.Compose([
            T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
            T.Transpose(), T.Normalize(P["mean"], P["std"])]))
        pt.seed(seed)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = models.mobilenet_v3_large()
        opt = pt.optimizer.RMSProp(
            learning_rate=P["lr"], rho=P["rho"], epsilon=P["epsilon"],
            momentum=P["momentum"], parameters=net.parameters(),
            weight_decay=pt.optimizer.L2Decay(P["weight_decay"]))
        model = pt.Model(net)
        model.prepare(opt, pt.nn.CrossEntropyLoss(),
                      amp_configs={"level": "O1", "dtype": "bfloat16"})
        loader = io.DataLoader(ds, batch_size=P["batch"], shuffle=True,
                               drop_last=True, num_workers=P["workers"],
                               timeout=600)

        class Steps(Callback):
            def __init__(self):
                super().__init__()
                self.times, self.waits, self.losses = [], [], []
                self.t = self.end = None

            def on_train_batch_begin(self, step, logs=None):
                self.t = time.perf_counter()
                if self.end is not None:
                    self.waits.append(self.t - self.end)

            def on_train_batch_end(self, step, logs=None):
                torch.cuda.synchronize()
                self.end = time.perf_counter()
                self.times.append(self.end - self.t)
                self.losses.append(float(np.asarray(logs["loss"]).reshape(
                    -1)[0]))

        cb = Steps()
        monitor.reset()
        monitor.enable()
        ops.reset_launch_counts()
        try:
            t = time.perf_counter()
            model.fit(loader, epochs=1, verbose=0, callbacks=[cb],
                      num_iters=1 + P["timed"])
            fit_s = time.perf_counter() - t
            wait = monitor.histogram(
                "paddle_tpu_dataloader_wait_seconds").value
        finally:
            monitor.disable()
        counts, routes = ops.launch_counts(), ops.route_calls()
        n = 1 + P["timed"]
        if len(cb.losses) != n or not np.isfinite(cb.losses).all():
            raise AssertionError(f"pipeline: {len(cb.losses)} steps, losses "
                                 f"{cb.losses}")
        timed = cb.times[1:]
        images, labels = io.default_collate_fn(
            [ds[i] for i in range(P["batch"])])
        ins, labs = images.to(dev), labels.to(dev)
        staged = []
        for _ in range(P["staged"]):
            t = time.perf_counter()
            cb.losses.append(model.train_batch([ins], [labs])[0])
            torch.cuda.synchronize()
            staged.append(time.perf_counter() - t)
        step_s = statistics.median(timed)
        # the waits are the gaps before steps 1..n-1: with one warm-up
        # step, the timed steps' own
        timed_wall = sum(timed) + sum(cb.waits)
        rec = {"config": "mobilenet_v3_large, 1000 classes, O1 bf16, "
                         "RMSProp", "batch": P["batch"],
               "images": P["images"], "workers": P["workers"],
               "dataset_gb": nbytes / 2 ** 30, "write_s": write_s,
               "fit_s": fit_s, "losses": cb.losses, "step_s": cb.times,
               "step_s_median": step_s, "waits_s": cb.waits,
               "loader_wait_s_mean": wait["sum"] / max(wait["count"], 1),
               "loader_wait_count": wait["count"],
               "loader_wait_sum_s": wait["sum"],
               "images_per_s": P["batch"] * P["timed"] / timed_wall,
               "images_per_s_step_only": P["batch"] / step_s,
               "staged_step_s": staged,
               "staged_images_per_s": P["batch"] / statistics.median(staged),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "params": sum(p.numel() for p in net.parameters()),
               "launches": counts, "route_calls": routes}
        if profile:
            rec["profile"] = profile_run(
                torch, lambda: model.train_batch([ins], [labs]))
        del model, net, opt, ins, labs
        torch.cuda.empty_cache()
        return rec
    finally:
        shutil.rmtree(root, ignore_errors=True)


def op_times(torch, fn, reps=3, warmup=True, windows=3):
    """``fn`` (which ends its work on the card) timed after a warm-up: the
    host clock over the call and a synchronize (median of ``reps``), and
    the device time of its kernels under torch.profiler, one call a
    window: the median over ``windows`` of those that recorded the most
    kernels (a profile now and then comes back with some of the device's
    events missing, as ``kernel_ms`` finds)."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
        torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t)
    seen = []           # (kernels recorded, device us)
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                v = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if v is None else v
                count += e.count
        seen.append((count, us))
    most = max(c for c, _ in seen)
    return {"host_ms": statistics.median(host) * 1e3,
            "device_ms": statistics.median(
                us for c, us in seen if c == most) / 1e3,
            "kernels": most}


def _det_close(torch, what, got, want):
    """fp32 within DET_REL of the output's largest magnitude plus DET_REL
    of each element; returns the largest error over that scale."""
    got = got.detach().cpu().double()
    want = want.detach().cpu().double()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} on the card, "
                             f"{tuple(want.shape)} on the CPU")
    scale = max(float(want.abs().max()), 1e-30) if want.numel() else 1.0
    err = (got - want).abs()
    if not torch.isfinite(got).all() or bool(
            (err > DET_REL * scale + DET_REL * want.abs()).any()):
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3g} at "
                             f"a scale of {scale:.3g}")
    return float(err.max()) / scale if err.numel() else 0.0


def _det_equal(torch, what, got, want):
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: card and CPU differ ({tuple(got.shape)}"
                             f" / {tuple(want.shape)})")


def _ramp(torch, shape):
    """The backward's fixed cotangent: a ramp over [-1, 1], made on the
    host so the card and the CPU share it bitwise."""
    n = 1
    for s in shape:
        n *= s
    return torch.linspace(-1, 1, n).reshape(shape)


def _fwd_grads(torch, op, inputs, dev, wrt=(0,)):
    """``op(*inputs)`` on ``dev`` and the gradients of sum(out * ramp) in
    the inputs ``wrt`` names."""
    xs = [t.detach().to(dev).requires_grad_() if i in wrt else t.to(dev)
          for i, t in enumerate(inputs)]
    out = op(*xs)
    (out.float() * _ramp(torch, out.shape).to(out.device)).sum().backward()
    return out.detach(), [xs[i].grad for i in wrt]


def _twin_check(torch, what, op, inputs, dev, rec, time_grad=True,
                wrt=(0,)):
    """``op`` with the gradients in the inputs ``wrt`` names on the card and
    on the CPU from the same inputs, held by _det_close; its forward and
    forward + backward timed on the card."""
    got, g_card = _fwd_grads(torch, op, inputs, dev, wrt)
    want, g_cpu = _fwd_grads(torch, op, inputs, torch.device("cpu"), wrt)
    r = {"shape": list(got.shape),
         "max_rel_err": _det_close(torch, what, got, want),
         "grad_max_rel_err": max((_det_close(torch, f"{what} grad {i}", g,
                                             w)
                                  for i, (g, w) in enumerate(zip(g_card,
                                                                 g_cpu))),
                                 default=0.0)}
    card = [t.to(dev) for t in inputs]
    with torch.no_grad():
        r["fwd"] = op_times(torch, lambda: op(*card))
    if time_grad:
        r["fwd_bwd"] = op_times(torch, lambda: _fwd_grads(torch, op, card,
                                                          dev, wrt))
    rec[what] = r
    return got


def rpn_inputs(torch, np, seed):
    """Tie-free RPN scores [N, 9, H, W], deltas [N, 36, H, W], the image
    sizes, the anchors [H, W, 9, 4] (py-faster-rcnn's: centred on each
    stride cell, area scale^2 at each ratio) and unit variances."""
    P = RPN
    H, W = -(-P["height"] // P["stride"]), -(-P["width"] // P["stride"])
    a = len(P["scales"]) * len(P["ratios"])
    n = P["images"] * a * H * W
    rng = np.random.RandomState(seed)
    scores = ((rng.permutation(n) + 0.5) / n).astype(np.float32)
    if len(np.unique(scores)) != n:
        raise AssertionError("rpn: the scores have ties")
    deltas = (rng.randn(P["images"], 4 * a, H, W) * 0.1).astype(np.float32)
    sizes = [(np.sqrt(s * s / r), np.sqrt(s * s / r) * r)
             for r in P["ratios"] for s in P["scales"]]
    cy, cx = np.meshgrid((np.arange(H) + 0.5) * P["stride"],
                         (np.arange(W) + 0.5) * P["stride"], indexing="ij")
    anchors = np.stack([np.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                  cy + h / 2], -1) for w, h in sizes], 2)
    img = np.asarray([[P["height"], P["width"]]] * P["images"], np.float32)
    return [torch.from_numpy(v) for v in (
        scores.reshape(P["images"], a, H, W), deltas, img,
        anchors.astype(np.float32), np.ones_like(anchors, np.float32))]


def rpn_leg(torch, np, dev, seed, rec):
    from paddle_tpu_torch.vision import ops as V

    P = RPN
    inputs = rpn_inputs(torch, np, seed)
    kw = dict(pre_nms_top_n=P["pre_nms_top_n"],
              post_nms_top_n=P["post_nms_top_n"],
              nms_thresh=P["nms_thresh"], min_size=P["min_size"],
              return_rois_num=True)
    card = [t.to(dev) for t in inputs]
    got = V.generate_proposals(*card, **kw)
    want = V.generate_proposals(*inputs, **kw)
    for what, g, w in zip(("rois", "scores", "rois_num"), got, want):
        _det_equal(torch, f"generate_proposals {what}", g, w)
        if g.device.type != dev.type:
            raise AssertionError(f"generate_proposals {what} on {g.device}")
    r = op_times(torch, lambda: V.generate_proposals(*card, **kw))
    rec["generate_proposals"] = dict(
        r, shape=list(got[0].shape), rois_num=got[2].tolist())
    return got[0], got[2]


def roi_head_leg(torch, np, dev, seed, rois, rois_num, rec):
    """RoIAlign, RoIPool and PSRoIPool over the proposals: every RoI on the
    card (timed, finite), the CPU twin over the first ROI_HEAD["twin_rois"]
    of each image, forward and the gradient into x."""
    from paddle_tpu_torch.vision import ops as V

    P = ROI_HEAD
    H, W = -(-RPN["height"] // RPN["stride"]), -(-RPN["width"] // RPN["stride"])
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(RPN["images"], P["channels"], H, W, generator=g)
    xps = torch.randn(RPN["images"], P["ps_channels"], H, W, generator=g)
    nums = rois_num.cpu().tolist()
    starts = np.cumsum([0] + nums[:-1])
    k = P["twin_rois"]
    sub = torch.cat([rois.cpu()[s:s + min(k, n)]
                     for s, n in zip(starts, nums)])
    sub_num = torch.tensor([min(k, n) for n in nums], dtype=torch.int32)
    scale = 1.0 / RPN["stride"]
    cases = {
        "roi_align": (x, lambda a, b, c: V.roi_align(
            a, b, c, P["output"], scale, sampling_ratio=0, aligned=True)),
        "roi_pool": (x, lambda a, b, c: V.roi_pool(a, b, c, P["output"],
                                                   scale)),
        "psroi_pool": (xps, lambda a, b, c: V.psroi_pool(
            a, b, c, P["ps_output"], scale)),
    }
    for name, (feat, op) in cases.items():
        _twin_check(torch, f"{name}_twin", op, [feat, sub, sub_num], dev,
                    rec, time_grad=False)
        full = [feat.to(dev), rois, rois_num]
        out, _ = _fwd_grads(torch, op, full, dev)
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        with torch.no_grad():
            r = {"fwd": op_times(torch, lambda: op(*full))}
        r["fwd_bwd"] = op_times(torch, lambda: _fwd_grads(torch, op, full,
                                                          dev))
        rec[name] = dict(r, shape=list(out.shape))


def fpn_leg(torch, np, dev, seed, rec):
    from paddle_tpu_torch.vision import ops as V

    P = FPN
    rng = np.random.RandomState(seed)
    n = P["rois"] * RPN["images"]
    xy = rng.uniform(0, 1, (n, 2)) * [RPN["width"], RPN["height"]]
    wh = np.exp(rng.uniform(np.log(8), np.log(800), (n, 2)))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(
        np.float32))
    num = torch.tensor([P["rois"]] * RPN["images"], dtype=torch.int32)
    kw = {k: P[k] for k in ("min_level", "max_level", "refer_level",
                            "refer_scale")}
    got = V.distribute_fpn_proposals(rois.to(dev), rois_num=num.to(dev), **kw)
    want = V.distribute_fpn_proposals(rois, rois_num=num, **kw)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        _det_equal(torch, f"distribute_fpn_proposals level {i}", g, w)
    _det_equal(torch, "distribute_fpn_proposals restore", got[1], want[1])
    for g, w in zip(got[2], want[2]):
        _det_equal(torch, "distribute_fpn_proposals counts", g, w)
    card = [rois.to(dev), num.to(dev)]
    rec["distribute_fpn_proposals"] = dict(
        op_times(torch, lambda: V.distribute_fpn_proposals(
            card[0], rois_num=card[1], **kw)),
        per_level=[len(g) for g in got[0]])


def _yolo_truth(torch, np, rng):
    """Ground truth [B, gt, 4] (normalized cx, cy, w, h) with a seeded
    share of each image's rows zero (padding, at the end), and labels."""
    P = YOLO
    b, n = P["batch"], P["gt"]
    gt = np.concatenate([rng.uniform(0.05, 0.95, (b, n, 2)),
                         np.exp(rng.uniform(np.log(0.02), np.log(0.8),
                                            (b, n, 2)))], -1)
    pads = rng.binomial(n, P["pad_share"], b)
    for i, p in enumerate(pads):
        gt[i, n - p:] = 0.0
    labels = rng.randint(0, P["classes"], (b, n))
    return (torch.from_numpy(gt.astype(np.float32)),
            torch.from_numpy(labels.astype(np.int32)), int(pads.sum()))


def yolo_leg(torch, np, dev, seed, rec):
    """YOLOv3's three heads: yolo_box and yolo_loss (forward and the
    gradient in x) against the CPU; then matrix_nms over every decoded box
    and nms over an image's best YOLO["nms_boxes"], both with tie-free
    scores drawn from the seed."""
    from paddle_tpu_torch.vision import ops as V

    P = YOLO
    rng = np.random.RandomState(seed)
    g = torch.Generator().manual_seed(seed)
    gt, labels, pads = _yolo_truth(torch, np, rng)
    img = torch.tensor([[P["image"]] * 2] * P["batch"], dtype=torch.int32)
    boxes, scores = [], []
    for h, (mask, stride) in enumerate(zip(P["masks"], P["strides"])):
        side = P["image"] // stride
        x = torch.randn(P["batch"], len(mask) * (5 + P["classes"]), side,
                        side, generator=g)
        anchors = [v for m in mask for v in P["anchors"][2 * m:2 * m + 2]]
        bkw = dict(anchors=anchors, class_num=P["classes"],
                   conf_thresh=P["conf_thresh"], downsample_ratio=stride)
        got = V.yolo_box(x.to(dev), img.to(dev), **bkw)
        want = V.yolo_box(x, img, **bkw)
        _det_close(torch, f"yolo_box head {h} boxes", got[0], want[0])
        _det_close(torch, f"yolo_box head {h} scores", got[1], want[1])
        card = [x.to(dev), img.to(dev)]
        with torch.no_grad():
            rec[f"yolo_box_{side}"] = dict(
                op_times(torch, lambda: V.yolo_box(*card, **bkw)),
                shape=list(got[0].shape))
        boxes.append(got[0])
        scores.append(got[1])

        def loss(xv, _mask=mask, _stride=stride):
            return V.yolo_loss(xv, gt.to(xv.device), labels.to(xv.device),
                               P["anchors"], list(_mask), P["classes"],
                               P["ignore_thresh"], _stride)

        out = _twin_check(torch, f"yolo_loss_{side}", loss, [x], dev, rec)
        if not torch.isfinite(out).all():
            raise AssertionError(f"yolo_loss head {h}: {out}")
    bboxes = torch.cat(boxes, 1)                           # [B, M, 4]
    m = bboxes.shape[1]
    # tie-free scores: a permutation a (image, class), most cells below
    # the score threshold (zeros, excluded before any ordering)
    vals = (np.stack([rng.permutation(m) for _ in range(
        P["batch"] * P["classes"])]) + 1.0) / (m + 1.0)
    vals *= rng.rand(*vals.shape) < P["score_keep"]
    ms = torch.from_numpy(vals.astype(np.float32).reshape(
        P["batch"], P["classes"], m))
    for row in ms.reshape(-1, m):
        kept = row[row > P["matrix"]["score_threshold"]]
        if kept.numel() != kept.unique().numel():
            raise AssertionError("matrix_nms: the scores have ties")
    mkw = dict(P["matrix"], return_index=True)
    got = V.matrix_nms(bboxes, ms.to(dev), **mkw)
    want = V.matrix_nms(bboxes.cpu(), ms, **mkw)
    for what, gv, wv in zip(("rows", "index", "rois_num"), got, want):
        _det_equal(torch, f"matrix_nms {what}", gv, wv)
    card_ms = ms.to(dev)
    rec["matrix_nms"] = dict(op_times(torch, lambda: V.matrix_nms(
        bboxes, card_ms, **mkw), reps=1, warmup=False, windows=1),
        rois_num=got[2].tolist())
    best = torch.cat(scores, 1)[0].max(-1)
    top = best.values.argsort(descending=True)[:P["nms_boxes"]]
    nb = bboxes[0, top]
    cats = best.indices[top]
    ns = torch.from_numpy(((rng.permutation(len(top)) + 0.5)
                           / len(top)).astype(np.float32))
    if ns.unique().numel() != ns.numel():
        raise AssertionError("nms: the scores have ties")
    nkw = dict(iou_threshold=P["nms_iou"], top_k=P["nms_keep"])
    got = V.nms(nb, scores=ns.to(dev), category_idxs=cats, **nkw)
    want = V.nms(nb.cpu(), scores=ns, category_idxs=cats.cpu(), **nkw)
    _det_equal(torch, "nms", got, want)
    card_ns = ns.to(dev)
    rec["nms"] = dict(op_times(torch, lambda: V.nms(
        nb, scores=card_ns, category_idxs=cats, **nkw)), kept=len(got),
        boxes=len(top))
    rec["yolo_padding_rows"] = pads


def dcn_leg(torch, np, dev, seed, rec):
    """DCNv2 at ResNet-50's stage-5 3x3: offsets and masks from a seeded
    Conv2D(C, 27, 3, padding=1) (18 offsets, 9 sigmoid masks), then
    DeformConv2D(C, C, 3, padding=1), forward and the gradients in x, the
    offsets, the masks, the weight and the bias, against the CPU."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision import ops as V

    P = DCN
    c = P["channels"]
    with _cpu_place():
        pt.seed(seed)
        om_conv = pt.nn.Conv2D(c, 27, 3, padding=1)
        layer = V.DeformConv2D(c, c, 3, padding=1)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(P["batch"], c, P["height"], P["width"], generator=g)
    with torch.no_grad():
        om = om_conv(x)
    offset, mask = om[:, :18].contiguous(), torch.sigmoid(om[:, 18:])
    gpu = copy.deepcopy(layer).to(dev)
    runs = []
    for net in (gpu, layer):
        d = net.weight.device
        ins = [t.detach().to(d).requires_grad_() for t in (x, offset, mask)]
        out = net(*ins)
        (out * _ramp(torch, out.shape).to(d)).sum().backward()
        runs.append((out.detach(), [t.grad for t in ins]
                     + [net.weight.grad, net.bias.grad]))
    (o_card, g_card), (o_cpu, g_cpu) = runs
    r = {"shape": list(o_card.shape),
         "max_rel_err": _det_close(torch, "deform_conv2d", o_card, o_cpu),
         "grad_max_rel_err": max(
             _det_close(torch, f"deform_conv2d grad {n}", a, b)
             for n, a, b in zip(("x", "offset", "mask", "weight", "bias"),
                                g_card, g_cpu))}
    card = [t.to(dev) for t in (x, offset, mask)]
    with torch.no_grad():
        r["fwd"] = op_times(torch, lambda: gpu(*card))

    def fwd_bwd():
        ins = [t.detach().requires_grad_() for t in card]
        gpu(*ins).sum().backward()

    r["fwd_bwd"] = op_times(torch, fwd_bwd)
    rec["deform_conv2d"] = r
    del gpu


def ssd_leg(torch, np, dev, seed, rec):
    """SSD300's conv4_3 priors (38 x 38, min 30, max 60, ratio 2 flipped,
    clipped) on the card and on the CPU; box_coder encoding ground truth
    against them and decoding seeded deltas (and its gradient)."""
    from paddle_tpu_torch.vision import ops as V

    P = SSD
    feat = torch.zeros(1, P["channels"], P["feature"], P["feature"])
    image = torch.zeros(1, 3, P["image"], P["image"])
    kw = dict(min_sizes=[P["min_size"]], max_sizes=[P["max_size"]],
              aspect_ratios=[P["ratio"]], flip=True, clip=True)
    got = V.prior_box(feat.to(dev), image.to(dev), **kw)
    with _cpu_place():
        want = V.prior_box(feat, image, **kw)
    for what, a, b in zip(("boxes", "variances"), got, want):
        _det_equal(torch, f"prior_box {what}", a, b)
        if a.device.type != dev.type:
            raise AssertionError(f"prior_box {what} on {a.device}")
    rec["prior_box"] = dict(op_times(torch, lambda: V.prior_box(
        feat, image, **kw)), shape=list(got[0].shape))
    prior, var = (t.reshape(-1, 4).cpu() for t in want)
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 0.8, (P["gt"], 2))
    gt = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(0.05, 0.2, (P["gt"], 2))], 1).astype(
            np.float32))
    deltas = torch.from_numpy((rng.randn(P["batch"], len(prior), 4)
                               * 0.5).astype(np.float32))
    _twin_check(torch, "box_coder_encode", lambda p, v, t: V.box_coder(
        p, v, t, "encode_center_size"), [prior, var, gt], dev, rec,
        time_grad=False, wrt=(2,))
    _twin_check(torch, "box_coder_decode", lambda p, v, t: V.box_coder(
        p, v, t, "decode_center_size"), [prior, var, deltas], dev, rec,
        wrt=(2,))


def detection_leg(torch, np, dev, seed):
    from paddle_tpu_torch import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    rec = {}
    rois, rois_num = rpn_leg(torch, np, dev, seed, rec)
    roi_head_leg(torch, np, dev, seed, rois, rois_num, rec)
    fpn_leg(torch, np, dev, seed, rec)
    yolo_leg(torch, np, dev, seed, rec)
    dcn_leg(torch, np, dev, seed, rec)
    ssd_leg(torch, np, dev, seed, rec)
    torch.cuda.empty_cache()
    rec.update(launches=ops.launch_counts(), route_calls=ops.route_calls(),
               s=time.perf_counter() - t0)
    return rec


def text_leg(torch, np, dev, seed):
    """viterbi_decode at TEXT with BOS/EOS tags on the card and the CPU:
    scores and paths bitwise equal; the card's time."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.text import ViterbiDecoder, viterbi_decode

    P = TEXT
    ops.reset_launch_counts()
    n = P["tags"] + 2
    g = torch.Generator().manual_seed(seed)
    pot = torch.randn(P["batch"], P["length"], n, generator=g)
    trans = torch.randn(n, n, generator=g)
    lens = torch.randint(P["min_len"], P["length"] + 1, (P["batch"],),
                         generator=g)
    lens[0] = P["length"]
    got = ViterbiDecoder(trans.to(dev))(pot.to(dev), lens.to(dev))
    want = viterbi_decode(pot, trans, lens)
    for what, a, b in zip(("scores", "paths"), got, want):
        _det_equal(torch, f"viterbi_decode {what}", a, b)
    card = [pot.to(dev), trans.to(dev), lens.to(dev)]
    r = op_times(torch, lambda: viterbi_decode(*card), reps=P["reps"])
    return dict(r, tags=n, batch=P["batch"], length=P["length"],
                path_shape=list(got[1].shape),
                tokens=int(lens.sum()), launches=ops.launch_counts(),
                route_calls=ops.route_calls())


def vision2_phase(torch, dev, np, seed, profile=False):
    """Phase 13: the classic2 models (twins, training steps, summary and
    flops), MobileNetV3-Large through the input pipeline, the detection
    operators at published widths and Viterbi decoding."""
    t0 = time.perf_counter()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rec = {"classic2": classic2_leg(torch, np, dev, seed)}
    rec["pipeline"] = pipeline_leg(torch, np, dev, seed, profile)
    rec["detection"] = detection_leg(torch, np, dev, seed)
    rec["text"] = text_leg(torch, np, dev, seed)
    rec["s"] = time.perf_counter() - t0
    return rec


def log_vision2(rec, smi) -> None:
    """Phase 13's lines."""
    c = rec["classic2"]
    tw = c["twins"]
    worst = sorted(tw["models"].items(),
                   key=lambda kv: -kv[1]["grad_rel_err"])[:4]
    log(f"[vision2] {len(tw['models'])} classic2 models in eval mode, fp32 "
        f"on the card against the CPU (near() to fp64, logits): largest "
        f"card / CPU distances " + ", ".join(
            f"{k} {m['out_err_card']:.3g} / {m['out_err_cpu']:.3g}"
            for k, m in sorted(tw["models"].items(),
                               key=lambda kv: -kv[1]["out_err_card"])[:3])
        + "; gradients " + ", ".join(
            f"{k} {m['grad_rel_err']:.3g}" for k, m in worst)
        + f" of their norm ({tw['s']:.1f} s)")
    for name, r in c["train"].items():
        log(f"[vision2] {name} {r['batch']}x3x{r['image']}x{r['image']} O1 "
            f"bf16 ({r['params']} params): step {r['step_s_median']:.4f} s "
            f"(steps {r['step_s']}), {r['images_per_s']:.1f} images/s, peak "
            f"{r['peak_mem_gb']:.2f} GiB, losses {r['losses']}  [{smi}]")
    for name, r in c["summary"].items():
        log(f"[vision2] summary/flops {name} 1x3x224x224 on the card = the "
            f"CPU's: {r['total_params']} params ({r['trainable_params']} "
            f"trainable), {r['flops']} FLOPs, {r['table_rows']} rows")
    p = rec["pipeline"]
    log(f"[vision2] pipeline {p['config']}, {p['batch']}x3x224x224 from "
        f"{p['images']} .npy images ({p['dataset_gb']:.2f} GiB written in "
        f"{p['write_s']:.1f} s) through {p['workers']} loader workers: "
        f"{p['images_per_s']:.1f} images/s (steps alone "
        f"{p['images_per_s_step_only']:.1f}); step {p['step_s_median']:.4f} "
        f"s, the loader's wait a batch {p['loader_wait_s_mean']:.4f} s "
        f"(waits {[round(w, 4) for w in p['waits_s']]}); on a batch already "
        f"on the card {p['staged_images_per_s']:.1f} images/s; peak "
        f"{p['peak_mem_gb']:.2f} GiB; fit {p['fit_s']:.1f} s; losses "
        f"{p['losses']}  [{smi}]")
    if "profile" in p:
        log(f"[vision2] pipeline step under the profiler: device busy "
            f"{p['profile']['device_busy_share']:.1%} of "
            f"{p['profile']['wall_ms']:.1f} ms  [{smi}]")
    d = rec["detection"]
    for name, r in d.items():
        if not isinstance(r, dict) or "fwd" not in r and "host_ms" not in r:
            continue
        parts = []
        for k in ("fwd", "fwd_bwd"):
            if k in r:
                parts.append(f"{k} device {r[k]['device_ms']:.3f} ms, host "
                             f"{r[k]['host_ms']:.3f} ms")
        if "host_ms" in r:
            parts.append(f"device {r['device_ms']:.3f} ms, host "
                         f"{r['host_ms']:.3f} ms")
        errs = "".join(f", {k} {r[k]:.3g}" for k in ("max_rel_err",
                                                     "grad_max_rel_err")
                       if k in r)
        log(f"[vision2] {name} {r.get('shape', '')}: " + "; ".join(parts)
            + errs + f"  [{smi}]")
    t = rec["text"]
    log(f"[vision2] viterbi_decode {t['batch']}x{t['length']}x{t['tags']} "
        f"({t['tokens']} tokens): device {t['device_ms']:.3f} ms, host "
        f"{t['host_ms']:.3f} ms, equal to the CPU's  [{smi}]")


# -- phase 14: jit, the deploy path and incubate's rest -----------------------

# the to_static leg: the Layer-API step (loss, backward, AdamW) eagerly, then
# compiled by jit.to_static (inductor), from the same weights over the same
# batches: one warm-up step and TRAIN_STEPS timed ones each. The compiled
# step against the eager one on the same card: inductor fuses the
# elementwise passes the eager step runs one by one (RMSNorm's plain
# backward, SwiGLU, the loss) and keeps fp32 inside a fused kernel where
# eager rounds each op's output to bf16, so the two part by bf16 rounding:
# losses within TRAIN_LOSS_ATOL (phase 4's card-vs-CPU limit). Parameters
# after the 4 AdamW steps at lr 1e-4: an element moves by at most about lr a
# step (Adam's normalized update in its first steps), so two runs whose
# gradients differ in sign part by at most 2 lr a step, 8 lr in all; and
# each step rounds the bf16 parameter once in each run (up to half a bf16
# step each), four bf16 steps of the parameter in all (rtol 4 x 2^-7)
STATIC_PARAM_ATOL = 8 * TRAIN["lr"]
STATIC_PARAM_RTOL = 4 * 2.0 ** -7
# the deploy leg: jit.save with a [None, None] int64 spec, one Predictor run
# at each shape from one program; the exported program runs the eager
# forward's ops (the same kernels, the same cuBLAS GEMMs) op by op, held to
# phase 4's logit limit LOGIT_ATOL; Model.save(training=False) and
# onnx.export round-trip a 2-layer twin at the same widths (DEPLOY_TWIN
# layers), which keeps three exports of the 24-layer model out of the phase
DEPLOY_SHAPES = ((1, 512), (8, 2048))
DEPLOY_TWIN = 2
# incubate's rest: ogbn-arxiv's size (Hu et al. 2020, OGB: 169,343 nodes,
# 1,166,243 edges, 128 features) for message passing; GraphSAGE's fanouts
# [25, 10] over 1,024 seed nodes for the k-hop sampler; GPT-3 1.3B's
# attention scores [8, 16, 2048, 2048] for the fused softmaxes, twinned on
# the CPU at [2, 4, 256, 256]; a 2-layer MLP at width 1024 for the autograd
# functionals
OGBN_ARXIV = dict(nodes=169_343, edges=1_166_243, features=128)
KHOP = dict(fanouts=(25, 10), seeds=1024)
SOFTMAX_SCORES = (8, 16, 2048, 2048)
SOFTMAX_TWIN = (2, 4, 256, 256)
MLP_WIDTH = 1024
# the softmaxes in bf16, card against CPU: probabilities in [0, 1], each
# side rounding its exp and its quotient once; two bf16 steps at 1 (2^-7)
SOFTMAX_ATOL = 2.0 ** -7
# the autograd functionals in fp32 (TF32 off): Jacobians and Hessians of a
# width-1024 MLP sum 1024 products in another order on each side
AUTOGRAD_TOL = dict(atol=1e-5, rtol=1e-4)
OPT_TWIN = dict(width=256, steps=3, lr=0.05)


def _static_steps(torch, model, batches, fwd):
    """Layer-API steps over ``batches`` (loss, backward, AdamW at TRAIN's
    lr, clear_grad) from the model's weights: losses, seconds and launches
    of each step, the seconds of each step's optimizer part (AdamW and
    clear_grad, after a synchronize that ends the backward), and the peak
    memory of the steps after the first."""
    from paddle_tpu_torch import ops, optimizer

    opt = optimizer.AdamW(learning_rate=TRAIN["lr"],
                          parameters=model.parameters(),
                          weight_decay=EAGER["weight_decay"])
    losses, times, opt_times, launches = [], [], [], []
    for i, (ids, labels) in enumerate(batches):
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        loss = fwd(ids, labels)
        loss.backward()
        torch.cuda.synchronize()
        t_opt = time.perf_counter()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        opt_times.append(time.perf_counter() - t_opt)
        launches.append(ops.launch_counts())
        losses.append(float(loss.detach()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return losses, times, opt_times, launches, peak


def _step_fwd_bwd(model, fwd, ids, labels):
    """A forward and backward of the Layer-API step (for the profiler),
    the gradients dropped after."""
    def run():
        fwd(ids, labels).backward()
        model.zero_grad(set_to_none=True)
    return run


def to_static_leg(torch, np, dev, cfg, model, batches, n_params):
    """Phase 14's first leg: the eager Layer-API step, then the same step
    through ``jit.to_static``, from one set of weights."""
    from torch._dynamo.utils import counters

    from paddle_tpu_torch import jit

    L, B, S = cfg.num_hidden_layers, TRAIN["batch"], TRAIN["seq"]
    tokens = B * S
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.train()
    e_loss, e_times, e_opt, e_launch, e_peak = _static_steps(
        torch, model, batches, model)
    eager_params = {k: p.detach().clone()
                    for k, p in model.named_parameters()}
    one = eager_step_launches(e_launch[0], L)
    for i, c in enumerate(e_launch):
        check_launches(c, one, f"eager step {i} of {L} layers")
    e_prof = profile_run(torch, _step_fwd_bwd(model, model, *batches[0]))
    model.load_state_dict(init)
    del init
    breaks0 = sum(counters["graph_break"].values())
    static = jit.to_static(model)
    sf = model.forward
    s_loss, s_times, s_opt, s_launch, s_peak = _static_steps(
        torch, model, batches, model)
    graphs = sf.compiles
    for i, c in enumerate(s_launch):
        check_launches(c, e_launch[i], f"compiled step {i}: the eager "
                                       f"step's launches")
    worst_param, rel = 0.0, 0.0
    for k, p in model.named_parameters():
        want = eager_params[k].float()
        err = (p.detach().float() - want).abs()
        lim = STATIC_PARAM_ATOL + STATIC_PARAM_RTOL * want.abs()
        if bool((err > lim).any()):
            i = int((err - lim).argmax())
            raise AssertionError(
                f"to_static: parameter {k} parts from the eager step's by "
                f"{float(err.flatten()[i]):.3g} at a weight of "
                f"{float(want.flatten()[i]):.3g} after {len(batches)} steps")
        worst_param = max(worst_param, float(err.max()))
        rel = max(rel, rel_err(torch, p.detach(), eager_params[k]))
    del eager_params
    loss_gap = max(abs(a - b) for a, b in zip(s_loss, e_loss))
    if not loss_gap <= TRAIN_LOSS_ATOL:
        raise AssertionError(f"to_static: losses {s_loss} against eager "
                             f"{e_loss}")
    s_prof = profile_run(torch, _step_fwd_bwd(model, static, *batches[0]))
    breaks = sum(counters["graph_break"].values()) - breaks0
    recompiles = sf.compiles - graphs
    if breaks or recompiles or graphs != 1:
        raise AssertionError(f"to_static: {graphs} graphs, {breaks} graph "
                             f"breaks, {recompiles} recompiles after the "
                             f"warm-up")
    del model.forward                   # the eager forward again
    # what the routing adds to an eager kernel call: the wrappers ask
    # torch.compiler.is_compiling() once a call
    routing_us = host_us(torch, torch.compiler.is_compiling, n=10000)
    e_med, s_med = (statistics.median(t[1:]) for t in (e_times, s_times))
    mfu = 6 * n_params * tokens / BF16_FLOPS
    return {"layers": L, "batch": B, "seq": S, "params": n_params,
            "eager": {"losses": e_loss, "step_s": e_times,
                      "step_s_median": e_med, "opt_s": e_opt,
                      "tokens_per_s": tokens / e_med,
                      "mfu": mfu / e_med, "peak_mem_gb": e_peak,
                      "profile": e_prof},
            "compiled": {"losses": s_loss, "step_s": s_times,
                         "step_s_median": s_med, "opt_s": s_opt,
                         "tokens_per_s": tokens / s_med, "mfu": mfu / s_med,
                         "peak_mem_gb": s_peak,
                         "compile_s": s_times[0] - s_med,
                         "graphs": graphs, "graph_breaks": breaks,
                         "recompiles_after_warmup": recompiles,
                         "profile": s_prof},
            "launches_per_step": s_launch[-1],
            "launches": {k: sum(c[k] for c in s_launch[1:])
                         for k in s_launch[0]},
            "loss_max_gap": loss_gap, "param_max_abs_err": worst_param,
            "param_max_rel_err": rel, "routing_host_us": routing_us}


def _op_nodes(ep) -> dict:
    out = {}
    for n in ep.graph.nodes:
        if n.op == "call_function" and str(n.target).startswith(
                "paddle_tpu."):
            name = str(n.target).split(".")[1]
            out[name] = out.get(name, 0) + 1
    return out


def _predict(torch, pred, ids):
    """One ``run`` through the input handle (the logits stay on the card:
    the predictor's outputs before ``copy_to_cpu``), its seconds."""
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(ids)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pred.run()
    torch.cuda.synchronize()
    return pred._outputs[0], time.perf_counter() - t


def deploy_leg(torch, np, dev, cfg, model, seed):
    """Phase 14's second leg: jit.save of the 24-layer model, a Predictor at
    two shapes from one program, Model.save / onnx.export round trips of a
    2-layer twin and inference.aot of one decoder layer."""
    import tempfile
    import warnings

    from paddle_tpu_torch import (LlamaForCausalLM, Model, inference, jit,
                                  llama_config, onnx, ops)
    from paddle_tpu_torch.inference import aot
    from paddle_tpu_torch.static import InputSpec

    L = cfg.num_hidden_layers
    model.eval()
    spec = [InputSpec([None, None], "int64")]
    rng = np.random.RandomState(seed + 14)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    rec = {"layers": L, "weights_gb": weights / 2 ** 30}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "llama")
        t = time.perf_counter()
        jit.save(model, path, input_spec=spec)
        rec["save_s"] = time.perf_counter() - t
        rec["pt2_mb"] = os.path.getsize(path + ".pt2") / 2 ** 20
        rec["pdiparams_mb"] = os.path.getsize(path + ".pdiparams") / 2 ** 20
        t = time.perf_counter()
        pred = inference.create_predictor(inference.Config(path))
        rec["load_s"] = time.perf_counter() - t
        ep = pred._exported
        rec["program_tensor_bytes"] = sum(
            v.numel() * v.element_size()
            for v in list(ep.state_dict.values()) + list(ep.constants.values())
            if isinstance(v, torch.Tensor))
        if rec["program_tensor_bytes"] or not (
                rec["pt2_mb"] * 2 ** 20 < weights / 2):
            raise AssertionError(f"deploy: the program ({rec['pt2_mb']:.1f} "
                                 f"MB) holds {rec['program_tensor_bytes']} "
                                 f"bytes of tensors: the weights belong to "
                                 f".pdiparams")
        rec["nodes"] = _op_nodes(pred._exported)
        want_nodes = {"rms_norm": 2 * L + 1, "fused_rope": 2 * L,
                      "flash_fwd": L}
        if rec["nodes"] != want_nodes:
            raise AssertionError(f"deploy: the program's paddle_tpu:: nodes "
                                 f"{rec['nodes']} != {want_nodes}")
        rec["runs"] = []
        total = None
        first = None
        for b, s in DEPLOY_SHAPES:
            ids = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int64)
            ops.reset_launch_counts()
            got, run_s = _predict(torch, pred, ids)
            counts = ops.launch_counts()
            check_launches(counts, expect(counts, rms_norm=2 * L + 1,
                                          fused_rope=2 * L, flash_fwd=L),
                           f"Predictor.run at {b} x {s}")
            total = counts if total is None else {
                k: total[k] + counts[k] for k in counts}
            _, again_s = _predict(torch, pred, ids)
            with torch.no_grad():
                want = model(torch.from_numpy(ids).to(dev))
            err = (got.float() - want.float()).abs().max().item()
            if not err <= LOGIT_ATOL:
                raise AssertionError(f"deploy: Predictor logits at {b} x {s} "
                                     f"differ from eager by {err:.3g}")
            if first is None:
                first = (ids, got.clone())
            rec["runs"].append({"shape": [b, s], "run_s": run_s,
                                "again_s": again_s,
                                "logit_max_abs_err": err})
            del got, want
        rec["launches"] = total
        del pred
        torch.cuda.empty_cache()
        # Model.save(training=False) and onnx.export of a 2-layer twin
        tcfg = train_config(llama_config, num_hidden_layers=DEPLOY_TWIN)
        twin = LlamaForCausalLM(tcfg, device=dev, generator=torch.Generator(
            dev).manual_seed(seed))
        twin.eval()
        ids = first[0]
        with torch.no_grad():
            want = twin(torch.from_numpy(ids).to(dev))
        p2 = os.path.join(tmp, "model")
        Model(twin, inputs=spec).save(p2, training=False)
        got, _ = _predict(torch, inference.create_predictor(
            inference.Config(p2)), ids)
        rec["model_save_logit_max_abs_err"] = (
            got.float() - want.float()).abs().max().item()
        p3 = os.path.join(tmp, "onnx")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            onnx.export(twin, p3, input_spec=spec)
        if not any("NOT a .onnx file" in str(w.message) for w in caught):
            raise AssertionError("onnx.export: no warning that its artifact "
                                 "is not ONNX")
        if os.path.exists(p3 + ".onnx") or not os.path.exists(p3 + ".pt2"):
            raise AssertionError("onnx.export: not the jit.save artifact")
        got3, _ = _predict(torch, inference.create_predictor(
            inference.Config(p3)), ids)
        rec["onnx_equal_model_save"] = bool(torch.equal(got3, got))
        for what, e in (("Model.save", rec["model_save_logit_max_abs_err"]),
                        ("onnx.export", (got3.float() - want.float()).abs()
                         .max().item())):
            if not e <= LOGIT_ATOL:
                raise AssertionError(f"deploy: {what} Predictor logits "
                                     f"differ from eager by {e:.3g}")
        del twin, got, got3, want
        # inference.aot of one decoder layer of the 24-layer model
        layer = model.model.layers[0]
        x = torch.randn(1, DEPLOY_SHAPES[0][1], cfg.hidden_size, device=dev,
                        dtype=torch.bfloat16, generator=torch.Generator(
                            dev).manual_seed(seed))
        cos, sin = model.model._tables(x.shape[1], x)
        p4 = os.path.join(tmp, "layer.pt2")
        with torch.no_grad():
            aot.save_exported(aot.export_fn(layer, x, cos, sin), p4)
            ep = aot.load_exported(p4)
            got = ep.module()(x, cos, sin)
            want = layer(x, cos, sin)
        rec["aot_layer"] = {"nodes": _op_nodes(ep), "max_abs_err": (
            got.float() - want.float()).abs().max().item(),
            "pt2_kb": os.path.getsize(p4) / 2 ** 10}
        if rec["aot_layer"]["nodes"] != {"rms_norm": 2, "fused_rope": 2,
                                         "flash_fwd": 1}:
            raise AssertionError(f"aot: layer nodes {rec['aot_layer']}")
        if not rec["aot_layer"]["max_abs_err"] <= LOGIT_ATOL:
            raise AssertionError(f"aot: layer output {rec['aot_layer']}")
    torch.cuda.empty_cache()
    return rec


def _graph_close(torch, what, got, want):
    """_det_close over the finite elements; the infinite ones (empty
    segments of a max or min) equal on both sides."""
    got, want = got.detach().cpu(), want.detach().cpu()
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin], want[~fin]):
        raise AssertionError(f"{what}: the empty segments differ")
    return _det_close(torch, what, got[fin], want[fin])


def _graph_twin(torch, what, op, inputs, dev, rec):
    """``op`` forward and backward on the card and on the CPU from the same
    inputs (the gradient in input 0), held by _graph_close; the forward and
    forward + backward (the cotangent already on the card) timed by CUDA
    events (``time_ms``), with the host's seconds a call (``host_us``)."""
    got, g_card = _fwd_grads(torch, op, inputs, dev)
    want, g_cpu = _fwd_grads(torch, op, inputs, torch.device("cpu"))
    r = {"max_rel_err": _graph_close(torch, what, got, want),
         "grad_max_rel_err": _graph_close(torch, f"{what} grad", g_card[0],
                                          g_cpu[0])}
    x = inputs[0].detach().to(dev).requires_grad_()
    rest = [t.to(dev) for t in inputs[1:]]
    ct = _ramp(torch, got.shape).to(dev)

    def fwd():
        with torch.no_grad():
            op(x, *rest)

    def fwd_bwd():
        x.grad = None
        torch.autograd.backward(op(x, *rest), ct)

    r["fwd_ms"] = time_ms(torch, fwd, reps=10, warmup=2)
    r["fwd_bwd_ms"] = time_ms(torch, fwd_bwd, reps=10, warmup=2)
    r["fwd_host_us"] = host_us(torch, fwd, n=20, rounds=3, warmup=2)
    rec[what] = r


def incubate_rest_leg(torch, np, dev, cfg, model, batches, seed):
    """Phase 14's third leg: ASP over the 24-layer model's linears through
    DistributedFusedLamb steps, DistributedFusedLamb against Lamb, message
    passing at ogbn-arxiv's size, the k-hop sampler, the fused softmaxes,
    the autograd functionals, LookAhead and ModelAverage."""
    from paddle_tpu_torch import geometric, incubate, nn, ops, optimizer
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.incubate import autograd as iag
    from paddle_tpu_torch.incubate.optimizer import DistributedFusedLamb

    L = cfg.num_hidden_layers
    rec = {}
    model.train()
    # ASP: 2:4 masks on the decoder's linears, held through 2 steps
    asp.set_excluded_layers(model, ["embed_tokens", "lm_head"])
    t = time.perf_counter()
    masks = asp.prune_model(model, 2, 4)
    rec["asp"] = {"prune_s": time.perf_counter() - t, "weights": len(masks),
                  "elements": int(sum(m.size for m in masks.values()))}
    if len(masks) != 7 * L:
        raise AssertionError(f"asp: {len(masks)} weights pruned, the "
                             f"{L} layers hold {7 * L} linears")
    dfl = asp.decorate(DistributedFusedLamb(learning_rate=TRAIN["lr"],
                                            parameters=model.parameters()),
                       model)
    params = dict(model.named_parameters())
    ops.reset_launch_counts()
    densities = []
    from concurrent.futures import ThreadPoolExecutor

    def held(k):
        """(check_sparsity, density) of one pruned weight (host numpy)."""
        w = params[k].detach().float().cpu().numpy()
        return asp.check_sparsity(w, n=2, m=4), asp.calculate_density(w)

    for ids, labels in batches[:2]:
        model(ids, labels).backward()
        dfl.step()
        dfl.clear_grad()
        with ThreadPoolExecutor(max_workers=8) as ex:
            checks = dict(zip(masks, ex.map(held, masks)))
        bad = [k for k, (ok, _) in checks.items() if not ok]
        d = [dens for _, dens in checks.values()]
        if bad or max(d) > 0.5:
            raise AssertionError(f"asp: after a step {len(bad)} weights "
                                 f"fail check_sparsity, densities up to "
                                 f"{max(d)}")
        densities.append([min(d), max(d)])
    counts = ops.launch_counts()
    check_launches(counts, eager_step_launches(counts, L, 2),
                   f"2 asp-decorated DistributedFusedLamb steps of {L} "
                   f"layers")
    rec["asp"].update(densities=densities, launches=counts)
    object.__delattr__(model, "_asp_masks")
    # DistributedFusedLamb against Lamb on the same gradients
    model(*batches[2]).backward()
    plist = list(model.parameters())
    shadow = [p.detach().clone().requires_grad_() for p in plist]
    for s_, p in zip(shadow, plist):
        s_.grad = p.grad.detach().clone()
    DistributedFusedLamb(learning_rate=TRAIN["lr"], parameters=plist).step()
    optimizer.Lamb(learning_rate=TRAIN["lr"], parameters=shadow).step()
    rec["dfl_equal_lamb"] = all(torch.equal(p, s_)
                                for p, s_ in zip(plist, shadow))
    if not rec["dfl_equal_lamb"]:
        raise AssertionError("DistributedFusedLamb's step differs from "
                             "Lamb's on the same gradients")
    model.zero_grad(set_to_none=True)
    del shadow
    torch.cuda.empty_cache()
    # message passing and the segment ops at ogbn-arxiv's size
    g = OGBN_ARXIV
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(g["nodes"], g["features"]).astype(
        np.float32))
    src = torch.from_numpy(rng.randint(0, g["nodes"], g["edges"]))
    dst = torch.from_numpy(rng.randint(0, g["nodes"], g["edges"]))
    graph = {"nodes": g["nodes"], "edges": g["edges"],
             "features": g["features"]}
    for op in ("sum", "mean", "max"):
        _graph_twin(torch, f"send_u_recv_{op}",
                    lambda a, s, d, op=op: geometric.send_u_recv(a, s, d, op),
                    [x, src, dst], dev, graph)
    msg = x[src]
    for op in ("sum", "mean", "max", "min"):
        fn = getattr(geometric, f"segment_{op}")
        _graph_twin(torch, f"segment_{op}", lambda d, i, fn=fn: fn(d, i),
                    [msg, dst], dev, graph)
    rec["graph"] = graph
    del msg
    # the k-hop sampler over the same graph (CSC: the sources of each
    # destination, sorted by destination)
    order = np.argsort(dst.numpy(), kind="stable")
    row = src.numpy()[order]
    colptr = np.concatenate([[0], np.cumsum(np.bincount(
        dst.numpy(), minlength=g["nodes"]))]).astype(np.int64)
    seeds = torch.from_numpy(rng.choice(g["nodes"], KHOP["seeds"],
                                        replace=False)).to(dev)
    t = time.perf_counter()
    s_src, s_dst, nodes = incubate.graph_khop_sampler(
        torch.from_numpy(row), torch.from_numpy(colptr), seeds,
        list(KHOP["fanouts"]))
    rec["khop"] = {"host_ms": (time.perf_counter() - t) * 1e3,
                   "edges": int(s_src.numel()), "nodes": int(nodes.numel()),
                   "fanouts": list(KHOP["fanouts"]), "seeds": KHOP["seeds"]}
    if not (torch.equal(nodes[:KHOP["seeds"]], seeds)
            and s_src.numel() == s_dst.numel()
            and int(s_src.max()) < nodes.numel()):
        raise AssertionError(f"graph_khop_sampler: {rec['khop']}")
    # the fused softmaxes at GPT-3 1.3B's scores, twinned at a cut size
    sm = {}
    gen = torch.Generator(dev).manual_seed(seed)
    scores = torch.randn(SOFTMAX_SCORES, device=dev, dtype=torch.bfloat16,
                         generator=gen)
    mask = torch.where(torch.rand((SOFTMAX_SCORES[0], 1) + SOFTMAX_SCORES[2:],
                                  device=dev, generator=gen) < 0.1,
                       -1e4, 0.0).to(torch.bfloat16)
    for name, fn in (("softmax_mask_fuse",
                      lambda: incubate.softmax_mask_fuse(scores, mask)),
                     ("softmax_mask_fuse_upper_triangle",
                      lambda: incubate.softmax_mask_fuse_upper_triangle(
                          scores))):
        sm[name] = {"shape": list(SOFTMAX_SCORES),
                    "ms": time_ms(torch, fn, reps=5, warmup=1)}
    del scores, mask
    torch.cuda.empty_cache()
    tw = torch.randn(SOFTMAX_TWIN, generator=torch.Generator().manual_seed(
        seed)).to(torch.bfloat16)
    tmask = torch.where(torch.arange(SOFTMAX_TWIN[-1]) % 7 == 0, -1e4,
                        0.0).to(torch.bfloat16).expand(SOFTMAX_TWIN)
    for name, fn in (("softmax_mask_fuse",
                      lambda a: incubate.softmax_mask_fuse(a, tmask.to(
                          a.device))),
                     ("softmax_mask_fuse_upper_triangle",
                      incubate.softmax_mask_fuse_upper_triangle)):
        err = (fn(tw.to(dev)).float().cpu() - fn(tw).float()).abs().max()
        sm[name]["twin_shape"] = list(SOFTMAX_TWIN)
        sm[name]["twin_max_abs_err"] = float(err)
        if not float(err) <= SOFTMAX_ATOL:
            raise AssertionError(f"{name}: card against CPU {float(err)}")
    rec["softmax"] = sm
    # the autograd functionals of a 2-layer MLP at width 1024, fp32
    w = MLP_WIDTH
    gcpu = torch.Generator().manual_seed(seed)
    W1, W2 = (torch.randn(w, w, generator=gcpu) / w ** 0.5 for _ in "12")
    xv, tv = torch.randn(w, generator=gcpu), torch.randn(w, generator=gcpu)

    def fns(d):
        a, b = W1.to(d), W2.to(d)

        def mlp(v):
            return torch.tanh(v @ a) @ b

        def scalar(v):
            return (torch.tanh(v @ a) @ b).pow(2).sum()
        return mlp, scalar

    ag = {}
    for name, run in (
            ("jacobian", lambda d: iag.Jacobian(fns(d)[0], xv.to(d))[:]),
            ("hessian", lambda d: iag.Hessian(fns(d)[1], xv.to(d))[:]),
            ("jvp", lambda d: iag.jvp(fns(d)[0], xv.to(d), tv.to(d))[1]),
            ("vjp", lambda d: iag.vjp(fns(d)[0], xv.to(d), tv.to(d))[1])):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = run(dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        want = run(torch.device("cpu"))
        bad = ((got.cpu() - want).abs() > AUTOGRAD_TOL["atol"]
               + AUTOGRAD_TOL["rtol"] * want.abs())
        ag[name] = {"shape": list(got.shape), "card_s": card_s,
                    "max_abs_err": float((got.cpu() - want).abs().max())}
        if bool(bad.any()):
            raise AssertionError(f"incubate.autograd {name}: {ag[name]}")
    rec["autograd"] = ag
    # LookAhead and ModelAverage over 3 SGD steps, card against CPU
    ow = OPT_TWIN["width"]
    xs = torch.randn(32, ow, generator=gcpu)
    ys = torch.randn(32, ow, generator=gcpu)
    opt_rec = {}
    for wrap in ("LookAhead", "ModelAverage"):
        outs = []
        for d in (dev, torch.device("cpu")):
            lin = nn.Linear(ow, ow)
            lin.to(d)
            with torch.no_grad():
                lin.weight.copy_(W1[:ow, :ow])
                lin.bias.zero_()
            sgd = optimizer.SGD(learning_rate=OPT_TWIN["lr"],
                                parameters=lin.parameters())
            opt = (incubate.LookAhead(sgd, alpha=0.5, k=2)
                   if wrap == "LookAhead" else sgd)
            avg = (incubate.ModelAverage(0.15,
                                         parameters=list(lin.parameters()))
                   if wrap == "ModelAverage" else None)
            for _ in range(OPT_TWIN["steps"]):
                ((lin(xs.to(d)) - ys.to(d)) ** 2).mean().backward()
                opt.step()
                opt.clear_grad()
                if avg is not None:
                    avg.step()
            if avg is not None:
                with avg.apply():
                    outs.append(lin.weight.detach().cpu().clone())
            else:
                outs.append(lin.weight.detach().cpu().clone())
        err = float((outs[0] - outs[1]).abs().max())
        opt_rec[wrap] = {"steps": OPT_TWIN["steps"], "max_abs_err": err}
        if not err <= AUTOGRAD_TOL["atol"]:
            raise AssertionError(f"{wrap}: card against CPU {err}")
    rec["optimizers"] = opt_rec
    return rec


def jit_deploy_phase(torch, dev, np, seed, profile=False):
    """Phase 14: jit.to_static training, the deploy path and incubate's rest
    at the training configuration (bench.py:117-124), on one model built
    once."""
    from paddle_tpu_torch import LlamaForCausalLM, llama_config

    t0 = time.perf_counter()
    cfg = train_config(llama_config)
    model = LlamaForCausalLM(cfg, device=dev, generator=torch.Generator(
        dev).manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    batches = eager_batches(torch, np, cfg, 1 + TRAIN_STEPS, seed,
                            TRAIN["batch"], TRAIN["seq"], dev)
    rec = {"config": f"{TRAIN['preset']} {TRAIN['overrides']}"}
    t = time.perf_counter()
    rec["to_static"] = to_static_leg(torch, np, dev, cfg, model, batches,
                                     n_params)
    rec["to_static"]["s"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["deploy"] = deploy_leg(torch, np, dev, cfg, model, seed)
    rec["deploy"]["s"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["incubate_rest"] = incubate_rest_leg(torch, np, dev, cfg, model,
                                             batches, seed)
    rec["incubate_rest"]["s"] = time.perf_counter() - t
    del model, batches
    torch.cuda.empty_cache()
    rec["s"] = time.perf_counter() - t0
    return rec


def log_jit_deploy(rec, smi) -> None:
    """Phase 14's lines."""
    ts = rec["to_static"]
    e, c = ts["eager"], ts["compiled"]
    log(f"[jit] {rec['config']} x{ts['layers']}, {ts['batch']}x{ts['seq']} "
        f"tokens, Layer-API step (loss, backward, AdamW): eager "
        f"{e['step_s_median']:.4f} s (steps {e['step_s']}; AdamW and "
        f"clear_grad {[round(x, 4) for x in e['opt_s']]}), "
        f"{e['tokens_per_s']:.1f} tokens/s, MFU {e['mfu']:.4f}, peak "
        f"{e['peak_mem_gb']:.2f} GiB; to_static {c['step_s_median']:.4f} s "
        f"(steps {c['step_s']}; AdamW and clear_grad "
        f"{[round(x, 4) for x in c['opt_s']]}), {c['tokens_per_s']:.1f} "
        f"tokens/s, MFU "
        f"{c['mfu']:.4f}, peak {c['peak_mem_gb']:.2f} GiB; compile "
        f"{c['compile_s']:.1f} s, {c['graphs']} graph, {c['graph_breaks']} "
        f"graph breaks, {c['recompiles_after_warmup']} recompiles after the "
        f"warm-up  [{smi}]")
    log(f"[jit] launches a step, compiled = eager: {ts['launches_per_step']}"
        f"; losses {c['losses']} against eager {e['losses']} (max gap "
        f"{ts['loss_max_gap']:.3g}, limit {TRAIN_LOSS_ATOL}); parameters "
        f"after {len(c['losses'])} steps within {ts['param_max_abs_err']:.3g}"
        f" (limit {STATIC_PARAM_ATOL:g} + 2^-5 |w|), relative "
        f"{ts['param_max_rel_err']:.3g}; the eager wrappers' routing "
        f"(is_compiling) {ts['routing_host_us']:.3f} us a call  [{smi}]")
    for what, p in (("eager", e["profile"]), ("to_static", c["profile"])):
        log(f"[jit] {what} forward + backward under the profiler: wall "
            f"{p['wall_ms']:.1f} ms, device busy {p['device_busy_ms']:.1f} ms"
            f" ({p['device_busy_share']:.1%}): " + ", ".join(
                f"{k} {v:.2f}" for k, v in sorted(
                    p["categories_ms"].items(), key=lambda kv: -kv[1])
                if v) + f" ms  [{smi}]")
    d = rec["deploy"]
    log(f"[deploy] jit.save {d['save_s']:.1f} s (.pt2 {d['pt2_mb']:.2f} MB "
        f"holding {d['program_tensor_bytes']} bytes of tensors, .pdiparams "
        f"{d['pdiparams_mb']:.1f} MB of {d['weights_gb']:.2f} GiB weights), "
        f"create_predictor {d['load_s']:.1f} s, paddle_tpu:: nodes "
        f"{d['nodes']}; " + "; ".join(
            f"run {r['shape'][0]} x {r['shape'][1]} {r['run_s'] * 1e3:.1f} "
            f"ms (again {r['again_s'] * 1e3:.1f}), logits within "
            f"{r['logit_max_abs_err']:.3g} of eager" for r in d["runs"])
        + f"; launches {d['launches']}  [{smi}]")
    log(f"[deploy] Model.save(training=False) -> Predictor at "
        f"{DEPLOY_TWIN} layers within {d['model_save_logit_max_abs_err']:.3g}"
        f" of eager, onnx.export warned and wrote the same artifact "
        f"(logits equal: {d['onnx_equal_model_save']}); aot of one decoder "
        f"layer: nodes {d['aot_layer']['nodes']}, {d['aot_layer']['pt2_kb']:.1f}"
        f" KB, within {d['aot_layer']['max_abs_err']:.3g}  [{smi}]")
    ir = rec["incubate_rest"]
    a = ir["asp"]
    log(f"[incubate] asp.prune_model 2:4 over {a['weights']} linears "
        f"({a['elements']} elements) in {a['prune_s']:.1f} s; densities "
        f"after each DistributedFusedLamb step {a['densities']}; its step "
        f"equal to Lamb's: {ir['dfl_equal_lamb']}  [{smi}]")
    g = ir["graph"]
    for name in ("send_u_recv_sum", "send_u_recv_mean", "send_u_recv_max",
                 "segment_sum", "segment_mean", "segment_max",
                 "segment_min"):
        r = g[name]
        log(f"[incubate] {name} at {g['nodes']} nodes, {g['edges']} edges, "
            f"{g['features']} features: {r['fwd_ms']:.3f} ms (host "
            f"{r['fwd_host_us']:.1f} us a call), with the backward "
            f"{r['fwd_bwd_ms']:.3f} ms; against the CPU "
            f"{r['max_rel_err']:.3g}, gradient {r['grad_max_rel_err']:.3g}"
            f"  [{smi}]")
    k = ir["khop"]
    log(f"[incubate] graph_khop_sampler fanouts {k['fanouts']} over "
        f"{k['seeds']} seeds: {k['host_ms']:.1f} ms on the host, "
        f"{k['edges']} edges, {k['nodes']} nodes  [{smi}]")
    for name, r in ir["softmax"].items():
        log(f"[incubate] {name} {r['shape']} bf16: {r['ms']:.3f} ms; at "
            f"{r['twin_shape']} within {r['twin_max_abs_err']:.3g} of the "
            f"CPU  [{smi}]")
    log(f"[incubate] autograd at width {MLP_WIDTH}: " + ", ".join(
        f"{k} {v['shape']} {v['card_s'] * 1e3:.1f} ms, within "
        f"{v['max_abs_err']:.3g}" for k, v in ir["autograd"].items())
        + "; " + ", ".join(f"{k} {v['steps']} steps within "
                           f"{v['max_abs_err']:.3g}"
                           for k, v in ir["optimizers"].items())
        + f"  [{smi}]")


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


def log_fleet(fl, dg, fe, smi) -> None:
    """The fleet legs' lines (phase 4's handoff and router at 2 layers,
    phase 5's fleet and disaggregated legs)."""
    for kv in ("bf16", "int8"):
        r = fe[kv]
        log(f"[fleet] 2-layer handoff {kv}: {r['blocks']} blocks, "
            f"{r['bytes']} bytes, export {r['export_ms']:.2f} ms; bytes and "
            f"scales exact card->card and card->CPU, re-ship dedups all, "
            f"{r['integrity_reject']}; the decode engine's stream parts from "
            f"the colocated one at {r['wire_first_split']} (margin "
            f"{r['wire_split_margin']}), card/CPU tokens matched "
            f"{r['card_cpu_tokens_matched']}")
    ro, ff = fe["router"], fe["front_f32"]
    log(f"[fleet] 2-layer router, replica 0 killed at its third segment: "
        f"failovers {ro['failovers']}, streams part from a Server's at "
        f"{ro['first_split_from_server']}")
    log(f"[fleet] 2-layer fp32 front over 2 HTTP replicas: "
        f"{ff['blocks_shipped']} blocks shipped, streams part from the "
        f"monolithic Server's at {ff['first_split']} (margins "
        f"{ff['split_margins']}); over-full imports kept blocks "
        f"{fe['bf16']['overfull_resident']} (bf16), "
        f"{fe['int8']['overfull_resident']} (int8)")
    s, w = fl["single"], fl["wave1"]
    log(f"[fleet] {PRESET} x{fl['layers']} Router of 2 replicas "
        f"{fl['engine']}: ready in {fl['fleet_ready_s']:.1f} s; wave with "
        f"the kill: TTFT p50 {w['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
        f"{w['tpot_p50_s'] * 1e3:.2f} ms (single Server "
        f"{s['ttft_p50_s'] * 1e3:.1f} / {s['tpot_p50_s'] * 1e3:.2f} ms); "
        f"failovers {fl['failovers']}, recovery {fl['recovery_s']:.3f} s, "
        f"rebuild {fl['rebuild_s']:.1f} s (build "
        f"{fl['rebuild_build_s']:.1f}, warmup {fl['rebuild_warmup_s']:.1f}) "
        f"beside {fl['waves_during_rebuild']} waves; rolling restart "
        f"{fl['rolling_restart_s']:.1f} s with 0 failed; peak "
        f"{fl['peak_mem_gb']:.1f} GiB; streams' splits {fl['first_splits']}"
        f"  [{smi}]")
    for r in fl["handoff_in_process"]:
        log(f"[fleet] in-process handoff of {r['prompt']} tokens: "
            f"{r['blocks']} blocks, {r['bytes']} bytes, export "
            f"{r['export_ms']:.1f} ms, encode {r['encode_ms']:.1f} ms, decode "
            f"{r['decode_ms']:.1f} ms, import {r['import_ms']:.1f} ms  "
            f"[{smi}]")
    log(f"[disagg] 2 replica processes ready in {dg['spawn_s']:.1f} s")
    log(f"[disagg] wave of {len(dg['wave'])} prompts through the front: "
        f"TTFT " + ", ".join(f"{r['ttft_s'] * 1e3:.1f}" for r in dg["wave"])
        + " ms (single Server " + ", ".join(
            f"{r['single_server_ttft_s'] * 1e3:.1f}" for r in dg["wave"])
        + f" ms); launches prefill {dg['launches_by_replica']['prefill']}, "
        f"decode {dg['launches_by_replica']['decode']}")
    for r in dg["handoffs"]:
        log(f"[disagg] handoff of {r['prompt']} tokens: {r['bytes']} bytes, "
            f"/kv/export {r['export_http_ms']:.1f} ms, /kv/import "
            f"{r['import_http_ms']:.1f} ms, decode TTFT "
            f"{r['decode_ttft_s'] * 1e3:.1f} ms (cold prefill TTFT "
            f"{r['cold_ttft_s'] * 1e3:.1f} ms)  [{smi}]")
    oc, dk = dg["over_cap"], dg["decode_kill"]
    log(f"[disagg] {oc['prompt']} tokens ({oc['page_bytes']} bytes of pages, "
        f"cap {oc['cap']}): {oc['status']} {oc['error']}; decode process "
        f"killed after {dk['tokens_at_kill']} tokens: replayed on the "
        f"prefill replica in {dk['replay_s']:.2f} s; streams' splits "
        f"{dg['first_splits']}; against the single Server in fp32 "
        f"{dg.get('monolithic_f32')}")


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
    ap.add_argument("--jit-deploy", action="store_true",
                    help="only build the kernels and run phase 14 (jit."
                         "to_static training, the deploy path, incubate's "
                         "rest) and print its lines and one JSON line")
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
    if args.jit_deploy:
        sys.path.insert(0, ROOT)
        import numpy as np

        from paddle_tpu_torch.ops import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = smi_line()
        log(smi)
        log(f"[build] nvcc {_build.build_all():.2f}s")
        jd = jit_deploy_phase(torch, torch.device("cuda"), np, args.seed)
        log_jit_deploy(jd, smi)
        log(json.dumps(jd, default=str))
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
        if "cost_check" in r:
            cc = r["cost_check"]
            log(f"  {name:13s} cost: the wrapper reports "
                f"{cc['reported'][0]} FLOPs, {cc['reported'][1]} bytes; the "
                f"bound counts {cc['counted'][0]} FLOPs, "
                f"{cc['counted'][1]} bytes")
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
    le = record["e2e"]["ledger"]
    log(f"[e2e] program ledger at 2 layers, card and CPU: the same "
        f"{len(le['programs'])} programs, dispatches and FLOPs "
        f"{le['programs']}; a segment replay under sync debug mode 'error' "
        f"recorded {le['sync_check']}  [{smi}]")
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
    lg = sr["ledger"]
    log(f"[serve] server_ledger (the program ledger on, "
        f"{lg['clients']} client threads): TTFT p50 "
        f"{lg['ttft_p50_s'] * 1e3:.1f} ms (plain Server "
        f"{lg['plain_ttft_p50_s'] * 1e3:.1f}), TPOT p50 "
        f"{lg['tpot_p50_s'] * 1e3:.2f} ms (plain "
        f"{lg['plain_tpot_p50_s'] * 1e3:.2f}), streams equal the plain "
        f"leg's; segment programs {lg['segment_seconds']:.4f} s = "
        f"{lg['segment_over_decode_s']:.3f}x the engine's segment time "
        f"{lg['decode_s']:.4f} s; peaks {lg['peaks']['device_kind']} "
        f"({lg['peaks']['source']})  [{smi}]")
    for r in lg["programs"]:
        log(f"[serve] server_ledger {r['program']} {r['signature']}: "
            f"{r['share']:.1%} of {lg['total_seconds']:.4f} s, "
            f"{r['dispatches']} dispatches ({r['compiles']} compiles), "
            f"p50 {r['p50_s']} s, MFU {r['mfu']}, bw_util {r['bw_util']}, "
            f"{r['bound']}  [{smi}]")
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
    # 5b. the replica fleet at 7B
    t = time.perf_counter()
    fl, dg = fleet_legs(torch, np, dev)
    record.update(fleet=fl, disagg=dg)
    record["phases"]["fleet"] = time.perf_counter() - t
    log_fleet(fl, dg, record["e2e"]["fleet"], smi)
    log(f"[fleet] Router.profile over {fl['ledger']['replicas']} replicas "
        f"equals the merge of their shards ({fl['ledger']['programs']} "
        f"programs); the disagg replica processes' /profile shards: "
        f"{ {k: v['names'] for k, v in dg['ledger'].items()} }")
    log(f"[fleet] {record['phases']['fleet']:.1f}s")
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
    # 9. the tensor surface on the card: this slice's main path
    t = time.perf_counter()
    tp = tensor_phase(torch, dev, np, args.seed)
    record["tensor"] = tp
    record["phases"]["tensor"] = time.perf_counter() - t
    sw, rd, ly = tp["sweep"], tp["random"], tp["layer"]
    log(f"[tensor] sweep: {sw['ops']} ops, {sw['cases']} cases ("
        f"{sw['grad_cases']} with gradients) on cuda:0 against their CPU "
        f"twins in {sw['s']:.1f} s; largest errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
            sw["max_abs_err"].items(), key=lambda kv: -kv[1])[:6]))
    log(f"[tensor] random: {len(RANDOM_OPS)} ops, two draws after one seed "
        f"bitwise equal, {rd['draws']} draws within the moments, torch's "
        f"generators untouched ({rd['s']:.1f} s); PyLayer forward "
        f"{tp['pylayer']['out_max_abs_err']:.3g}, gradient "
        f"{tp['pylayer']['grad_max_abs_err']:.3g}; device API "
        f"{tp['device_api']['get_device']} {tp['device_api']['name']}")
    for what in ("output", "input_grad"):
        r = ly[what]
        log(f"[tensor] {ly['config']} layer {what}: max |err| against the "
            f"fp32 yardstick, tensor API {r['api_max_abs_err']:.4g}, kernel "
            f"layer {r['kernel_max_abs_err']:.4g} (bf16 step "
            f"{r['bf16_step']:.4g})")
    log(f"[tensor] {ly['config']} layer forward + backward: tensor API "
        f"{ly['api_ms']:.3f} ms, kernel layer {ly['kernel_ms']:.3f} ms "
        f"(CUDA events, median of {TENSOR_LAYER['reps']})  [{smi}]")
    log(f"[tensor] {record['phases']['tensor']:.1f}s")
    # 10. paddle.nn and paddle.io on the card: this slice's main path
    t = time.perf_counter()
    nnp = nn_phase(torch, dev, np, args.seed, ly)
    record["nn"] = nnp
    record["phases"]["nn"] = time.perf_counter() - t
    sw, nl, fio = nnp["sweep"], nnp["layer"], nnp["io"]
    log(f"[nn] sweep: {sw['functions']} functions and {sw['layers']} layers "
        f"in fp32 and bf16 ({sw['cases']} cases, forward and gradients) on "
        f"cuda:0 against their CPU twins in {sw['s']:.1f} s; largest errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(
            sw["max_abs_err"].items(), key=lambda kv: -kv[1])[:6]))
    for what in ("output", "input_grad"):
        r = nl[what]
        log(f"[nn] {nl['config']} layer {what}: max |err| against the fp32 "
            f"yardstick, nn route {r['nn_max_abs_err']:.4g}, tensor API "
            f"{r['api_max_abs_err']:.4g}, kernel layer "
            f"{r['kernel_max_abs_err']:.4g} (bf16 step {r['bf16_step']:.4g})")
    log(f"[nn] {nl['config']} layer forward + backward: nn route "
        f"{nl['nn_ms']:.3f} ms, tensor API {ly['api_ms']:.3f} ms, kernel "
        f"layer {ly['kernel_ms']:.3f} ms (CUDA events, median of "
        f"{TENSOR_LAYER['reps']})  [{smi}]")
    log(f"[nn] io: Model.fit {fio['config']} x{fio['layers']}, "
        f"{fio['batch']}x{fio['seq']} tokens, over an io.TensorDataset "
        f"through io.DataLoader: losses {fio['losses']}, bitwise those of "
        f"fit over the same batches as a list ({fio['fit_dataset_s']:.1f} s "
        f"and {fio['fit_batches_s']:.1f} s); {NN_IO['workers']} worker "
        f"processes gave the same batches in order ({fio['workers_s']:.1f} "
        f"s)  [{smi}]")
    log(f"[nn] {record['phases']['nn']:.1f}s")
    # 11. the GPT and ERNIE-MoE families and the incubate entry points:
    # this slice's main path
    t = time.perf_counter()
    fam = family_phase(torch, dev, np, args.seed, profile=args.profile)
    record["families"] = fam
    record["phases"]["families"] = time.perf_counter() - t
    log_families(fam, smi)
    log(f"[families] {record['phases']['families']:.1f}s")
    # 12. the rest of paddle.nn and vision.models: this slice's main path
    t = time.perf_counter()
    nv = nn_vision_phase(torch, dev, np, args.seed, profile=args.profile)
    record["nn_vision"] = nv
    record["phases"]["nn_vision"] = time.perf_counter() - t
    log_nn_vision(nv, smi)
    log(f"[nn-vision] {record['phases']['nn_vision']:.1f}s")
    # 13. the rest of paddle.vision, summary and flops, paddle.text: this
    # slice's main path
    t = time.perf_counter()
    v2 = vision2_phase(torch, dev, np, args.seed, profile=args.profile)
    record["vision2"] = v2
    record["phases"]["vision2"] = time.perf_counter() - t
    log_vision2(v2, smi)
    log(f"[vision2] {record['phases']['vision2']:.1f}s")
    # 14. jit.to_static, the deploy path and incubate's rest: this slice's
    # main path
    t = time.perf_counter()
    jd = jit_deploy_phase(torch, dev, np, args.seed, profile=args.profile)
    record["jit_deploy"] = jd
    record["phases"]["jit_deploy"] = time.perf_counter() - t
    log_jit_deploy(jd, smi)
    log(f"[jit-deploy] {record['phases']['jit_deploy']:.1f}s")
    record["total_s"] = time.perf_counter() - t_all

    runs = dict(serve=sv, serve_int8=sq, generate=gn, dense_serve=ds,
                serve_chunked=sc, serve_sampled=ss, server=sr,
                serve_prefix=sp, server_pressure=sx, **spec_runs,
                server_lora=sl, train=tr, fmt=fm,
                ops=op, train_hb=dict(launches=tr["hb_launches"],
                                      route_calls=tr["hb_route_calls"]),
                f32=record["f32"], eager_fit=eg, fleet=fl, disagg=dg,
                server_ledger=sr["ledger"], tensor_surface=tp, nn=nnp,
                gpt=fam["gpt"], ernie=fam["ernie"], incubate=fam["incubate"],
                resnet=nv["resnet"], vision=nv["vision"],
                transformer=nv["transformer"], rnn=nv["rnn"],
                classic2=v2["classic2"], pipeline=v2["pipeline"],
                detection=v2["detection"], text=v2["text"],
                to_static=jd["to_static"], deploy=jd["deploy"],
                incubate_rest=jd["incubate_rest"]["asp"])
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
