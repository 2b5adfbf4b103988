#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card.  Without one — or run from a directory that holds
this file and nothing else of the repo — it exits non-zero and prints no
result.  Phases, each of which fails the run by raising:

  1. environment: torch / CUDA versions, the card's name and power limit;
     TF32 off for matmuls and cuDNN.
  2. build: ``nvcc`` of every kernel source, one process per source, all
     started together.
  3. kernels vs their plain PyTorch versions on the card, at the shapes
     the main paths give them (``flash_attention`` also at the profiler's
     (1, 4096, 32/8, 128); zamba2's head_dim 80 and (h 80, n 64) too;
     qwen3-moe's GQA group of 8: prefill, training and decode; whisper's
     non-causal encoder at 1500 frames, cross-attention at 416 and 1
     query against 1500, and its decode; paligemma's head_dim 256 with
     its 256-token bidirectional image prefix at B4 S768 H8 KV1, prefill
     and gradient, and its decode against 800 slots, linear and a ring;
     ragged prefixes at hd 64 and 128, a prefix under a window, a prefix
     given to a non-causal call; a grid member's decode on its block of a
     longer cache, with the block's slot offset and each head's
     log-sum-exp, at phase 42 (a)'s sequence-sharded, (b)'s and (f)'s
     cross-attention shapes,
     linear, ring and with no live slot, bf16 and fp32, and two members'
     partials combined against the whole cache) and
     at edge cases, in fp32, bf16 and fp16 (``TOL``; fp16 ``ssd_scan``
     is the CUDA-core kernel), and the gradients of the three
     autograd Functions (``flash_attention`` and ``rmsnorm`` in all
     three dtypes, ``ssd_scan`` in fp32)
     against the gradients of plain versions written apart from the ones
     their backward passes recompute; timed with CUDA events and profiler
     device time beside one PyTorch library call (where there is one) and
     the card's bound for the same work, in bf16 at every main path's
     shape and in fp16 at the serving / training / profile shape.
  4. serving path: ``repro_torch.launch.serve`` serves granite-8b at full
     width and depth (36 layers, bf16) from seeded random weights, batch
     4, prompt 512, 32 generated tokens; every attention call of prefill
     and decode must have launched a kernel (launch counts).
  5. kernel path vs plain path end to end: granite-8b at full width cut
     to 4 layers, prefill and 4 decode steps, ``--backend kernel`` vs
     ``--backend einsum`` in bf16 and in fp16 (bf16's limits).
  6. where the time goes in serving: the same 36-layer model, warm
     prefill and decode steps timed untraced, then traced with
     ``torch.profiler`` (tables in ``build/chip_smoke/profile_*.txt``).
  7. training path: ``repro_torch.launch.train`` trains mamba2-780m at
     full width and depth (48 layers, bf16), batch 4 x seq 2048, 6 steps;
     the losses must be finite and fall, and every SSM layer must have
     launched ``ssd_scan`` in the forward and in the remat recompute.
  8. where the time goes in a warm mamba2-780m train step (profiler,
     table in ``build/chip_smoke/profile_train.txt``).
  9. kernel path vs plain path in training: mamba2-780m width cut to 4
     layers, 3 steps from the same weights and batches with
     ``--backend kernel`` and ``--backend einsum``, in fp32 (the CUDA-core
     ``ssd_scan``), in bf16 (the tensor-core one) and in fp16 (the
     CUDA-core one reading fp16; bf16's limits).
 10. SSM serving: mamba2-780m, 48 layers, batch 4, prompt 512, 32 tokens;
     one ``ssd_scan`` per layer in the prefill.
 11. dense training through ``flash_attention``'s gradient: qwen1.5-0.5b
     at full size, batch 2 x seq 1024, 3 steps.
 12. the measured auto-profiler: ``repro_torch.core.profiler.
     measure_layer_profile`` times granite-8b at full width at seq 4096
     through ``flash_attention``, ``rmsnorm`` and ``flash_decode`` (launch
     counts), and the cost model and the schedule simulator price one
     plan with and without those times laid over one chip type.
 13. hybrid training path: ``repro_torch.launch.train`` trains
     zamba2-2.7b at full width and depth (54 ssm layers in 9 groups, each
     followed by the shared attention block; bf16), batch 4 x seq 2048, 4
     steps; the losses must be finite and fall, and each step must launch
     2 x 54 ``ssd_scan`` and 2 x 9 ``flash_attention`` (one checkpoint a
     group); then a warm step traced (``profile_train_hybrid.txt``).
 14. kernel path vs plain path, hybrid: zamba2 width cut to 12 layers (2
     groups of 6), training as phase 9 (fp32 and bf16, phase 9's limits)
     and prefill + 4 decode steps as phase 5 in fp32 and bf16 (phase 5's
     limits, or the plain path's own spread where it is wider:
     ``E2E_SPREAD``).
 15. hybrid serving: zamba2-2.7b, 54 layers, batch 4, prompt 512, 32
     tokens; the prefill launches 54 ``ssd_scan`` and 9
     ``flash_attention``, each decode call 9 ``flash_decode``.
 16. HeteroPP on one card: ``repro_torch.launch.train --plan`` on two
     ranks sharing the card (``--p2p host``: gloo through pinned host
     memory), each plan two stages on different chip types with a
     non-uniform split: (a) qwen1.5-0.5b at full width cut to 8 of 24
     layers, 3 / 5, recompute on / off, 4 microbatches of 2 x 1024, 2
     steps under 1f1b and again under zb_v (v 2: stage 0 hosts global
     stages 0 and 3), 4 x (3 x 2 + 5) = 44 ``flash_attention`` a step over
     both ranks; (b) mamba2-780m at full width cut to 16 of 48 layers, 6 /
     10, both recompute, 4 microbatches of 1 x 2048, 2 steps, 4 x 16 x 2 =
     128 ``ssd_scan`` a step (the depth cuts of 16-19, ``PP_QWEN``: room
     for phase 41 under the time limit); losses finite and falling; (c) both widths cut to 4 layers
     (1 / 3), every library schedule against the single-device loss and
     gradient in fp32 and bf16 at phase 9's limits, the single-chunk
     schedules' losses equal bit for bit and the chunked ones equal to
     them, and in fp32 1f1b's loss and gradient with the tracer's clock
     in the tick loop equal those without it bit for bit.  (a)'s 1f1b run
     also passes ``--trace``: ``trace_check`` holds its run directory
     (``obs.validate.validate_run_dir(require_trace=True)`` without an
     error, the executed ticks the priced ones, one ``F`` span per active
     cell of the copied tick tables, one step's launches in the traced
     pass, the denominator check) and prints each stage's executed ``F``
     and ``B`` seconds beside the predicted ``F`` share, each rank's
     exchange share of its traced wall, and the traced wall beside the
     step p50.
 17. HeteroPP over tensor and data parallelism on one card: four ranks
     sharing it through ``--p2p host``.  (a) phase 16 (a)'s qwen1.5-0.5b
     3 / 5 plan under 1f1b with tp 2 a stage (Megatron blocks, each
     member's 8 of 16 heads through ``flash_attention``): 2 steps, 2 x
     44 = 88 ``flash_attention`` a step over the ranks, twice phase 16
     (a)'s; (b) qwen1.5-0.5b cut to 8 layers, ``--pipeline-parallel 2
     --data-parallel 2 --grad-sync reduce_scatter`` (ZeRO-1), 8
     microbatches of 2 x 1024 (4 a replica), 3 steps, 2 x 4 x 8 x 2 = 128
     ``flash_attention`` a step, each rank's optimizer state half of what
     its stage holds at dp 1; (c) mamba2-780m at full width cut to 8 of
     48 layers (4 / 4), dp 2 x pipe 2 under psum in 25 MB buckets, 8
     microbatches of 1 x 2048, 2 steps, 128 ``ssd_scan`` a step; losses finite and falling, step, memory and
     the collectives' ms a step by rank and group; (d) both widths at 4
     layers (1 / 3) against the single device in fp32 and bf16 at phase
     16 (c)'s limits under (pipe 2, tp 2) (qwen only, tp shards dense
     blocks; and granite-8b's width, for its GQA) and (dp 2, pipe 2)
     with psum and ZeRO-1; one gradient synced by bucketed and by
     per-leaf psum must agree bit for bit, and ZeRO-1's master weights
     after one step equal psum's to 1e-6 of each leaf's largest entry.

 18. HeteroPP with grouped non-uniform tp on one card: Σ tp_s = 3 ranks
     sharing it through ``--p2p host``, ``launch.train --plan`` of
     qwen1.5-0.5b at full width cut to 8 layers (5 / 3, phase 16 (a)'s
     batch, 2 steps) whose stages disagree on tp: (a) tp (2, 1), once with
     ``--reshard sr_ag`` and once with ``naive``; (b) tp (1, 2) with
     ``sr_ag``.  ``flash_attention`` launches a step = Σ_s tp_s x stage
     s's launches at tp 1; the boundary's bytes per exchange each way
     exactly what the strategy moves (one copy each way under ``sr_ag``,
     tp_dst forward and tp_src back under ``naive``), beside the copied
     closed forms; (c) qwen's width at 4 layers (1 / 3), both layouts
     and both strategies, fp32, against the single device at phase 17
     (d)'s limits.  (a) under ``sr_ag`` passes ``--trace``, held as phase
     16 (a)'s, its exchange printed tick by tick too.
 19. HeteroPP with an uneven batch domain on one card: four ranks, (dp
     2, pipe 2), replica 0 taking 4 microbatches and replica 1 taking 3:
     mamba2-780m at full width cut to phase 17 (c)'s 8 layers, 7 x (1 x
     2048) a step, 2 steps under ZeRO-1, per-leaf psum and bucketed psum
     (7 x 8 x 2 = 112 ``ssd_scan`` a step; each replica's tick count its
     own allocation's); at 4 layers in fp32 against the single device on
     the same 7 microbatches, the padded token layout and the padded one
     with its pad slots overwritten giving the tight layout's loss bit
     for bit and its gradient within a second tight backward's spread.
     The ZeRO-1 run passes ``--trace``, held as phase 16 (a)'s (the
     pacing replica's 5 ticks, replica stragglers against 4 : 3).
     The script starts the ranks of each world size once (``rank_pool``):
     phases 16-19, 24 and 33-42 run their launcher runs and parity checks
     one after another in the same rank processes, so only the first run
     of each size pays their start (the processes' imports, CUDA and the
     libraries' first calls: a first step of 13-36 s, which a warm
     process does not pay again).
 20. MoE serving: ``repro_torch.launch.serve`` serves qwen3-moe-30b-a3b
     at full width and depth (48 layers of 128 experts, top 8, 61 GB of
     bf16 weights), batch 4, prompt 512, 32 tokens; the prefill launches
     48 ``flash_attention``, each decode call 48 ``flash_decode``; then
     where the time goes (phase 6's method, with the device time of each
     stage of the blocks: attention, routing, dispatch, expert products,
     combine).
 21. MoE training: qwen3-moe-30b-a3b at full width cut to 4 layers,
     batch 2 x seq 2048, 4 steps; losses finite and falling, 2 x 4
     ``flash_attention`` a step; layer 0's ``moe_drop_frac`` and aux
     losses on one batch at capacity factor 1.25; a warm step traced.
 22. kernel path vs plain path, MoE: qwen3-moe's width at 2 layers,
     training as phase 9 (fp32 and bf16) and serving as phase 5 (fp32
     and bf16).
 23. the measured auto-profiler on MoE: ``measure_layer_profile`` times
     a ``moe`` block of qwen3-moe at full width (4 layers for the decode
     step) at seq 4096, launches pinned as in phase 12; a plan of the
     whole model priced with and without the times.
 24. HeteroPP with moe stages on one card, two ranks, ``--p2p host``:
     (a) ``launch.train --plan`` of qwen3-moe at full width cut to 2
     layers, one a stage on chips A and B (a stage's layers are padded to
     the largest stage's, each slot with its AdamW state: a 1 / 3 split of
     4 layers does not fit two ranks on one card), 1f1b, 4 microbatches of
     1 x 2048, 2 steps, 4 x (1 x 2 + 1) = 12 ``flash_attention`` a step
     over both ranks, traced as phase 16 (a); (b) its width at 2 layers (1 / 1) in
     fp32 under 1f1b and zb_v against the mean over the microbatches of
     the single-device ``loss_fn``: the loss and each leaf's gradient
     norm at phase 16 (c)'s limits, each layer's router gradient within
     1e-3 of its largest entry, the loss nearer the oracle than the
     value the JAX package's SPMD pipeline gives (it divides the summed
     aux by the stage count).
 25. audio serving: ``repro_torch.launch.serve`` serves whisper-base at
     full width and depth (6 encoder + 6 decoder layers, 1500 encoder
     frames), batch 8, prompt 416, 32 tokens; the prefill launches 18
     ``flash_attention`` (encoder, decoder self, cross), each decode call
     6 ``flash_decode`` and 6 ``flash_attention`` (cross-attention at Sq
     = 1 through the prefill kernel); then where the time goes (phase 6's
     method, ``profile_*_whisper_base.txt``) and the measured profiler at
     seq 448 (a dense block without RoPE, a whole whisper decode step;
     launches pinned) pricing a plan as phase 12.
 26. audio training: whisper-base at full width and depth, batch 16 x
     seq 448, 6 steps; losses finite and falling, 2 x 18
     ``flash_attention`` a step; then a warm step traced.
 27. kernel path vs plain path, audio, at full depth: training as phase
     9 (b 16 x 448, fp32 and bf16; bf16 gradients held to the einsum
     path's own spread with its keys reversed) and serving as phase 5 (b
     8 x 416, fp32 and bf16; phase 5's limits or E2E_SPREAD x that
     spread).
 28. VLM serving: ``repro_torch.launch.serve`` serves paligemma-3b at
     full width and depth (18 layers, head_dim 256, one kv head; 5.0 GB of
     bf16 weights), batch 4 x (256 stub image tokens + prompt 512) + 32
     tokens against an 800-slot cache; the prefill launches 18
     ``flash_attention`` (the image prefix bidirectional), each decode
     call 18 ``flash_decode``; then where the time goes (phase 6's
     method, ``profile_*_paligemma_3b.txt``: the device's idle share of a
     decode step) and the measured profiler at seq 768 (launches pinned)
     pricing a plan as phase 12.
 29. VLM training: paligemma-3b at full width and depth, batch 4 x 512
     text behind the 256 image tokens, 5 steps at peak learning rate
     3e-5; losses finite and falling, 2 x 18 ``flash_attention`` a step;
     then a warm step traced.
 30. kernel path vs plain path, VLM: paligemma-3b's width cut to 4
     layers, b 2 x (256 image + 256 text): training as phase 9 and
     serving as phase 5, fp32 and bf16 (bf16 as phase 27).
 31. the DiTorch precision harness (``repro_torch.precision``), operator
     level: ``operator_sweep`` on the card, 6 ops x 4 regimes (bf16 and
     fp16, one and several accumulation chunks) against the fp32 one in
     IEEE fp32 (TF32 off, the reduced-precision fp16 / bf16 reductions at
     PyTorch's defaults, printed); every op and regime present, every
     bf16 regime inside the 0.1 tolerance, every error finite.
 32. the harness, model level: qwen1.5-0.5b at full width and depth (24
     layers, vocab 151936), b 4 x 512, trained 50 iterations each in
     fp32, bf16 and fp16 from one seed on one stream through the card's
     kernels in each dtype; first and last loss, step p50, peak memory,
     24 ``flash_attention`` a step (pinned), the share of embedding rows
     whose first gradient is zero; bf16's loss-curve MRE against fp32
     under the paper's 1.5%, every loss finite, fp16's MRE printed (the
     reference, without loss scaling, drops fp16's softmax gradient at
     this vocabulary: ``ALIGN_HELD``).
 33. the (data, model) grid (``repro_torch.sharding.spmd``: the JAX
     launcher's GSPMD path, its state placed by the copied sharding
     rules, Megatron blocks over the model axis): ``launch.train
     --model-parallel 2 --data-parallel 2 --p2p host`` on four ranks
     sharing the card, qwen1.5-0.5b at full size (bf16), b 8 x 512, 2
     steps; losses finite and falling, each loss within the larger of
     phase 9's bf16 limit and 3.5 x the single device's own spread of its
     losses under the data axis's order of sums (``GRID_LOSS_SPREAD``) of
     the single-device port's on the same seed and batches, and the first
     step's gradient norm within the same of that reading's spread
     (``--grid-faults`` below shows what these limits refuse); each rank's
     persistent bytes equal to the rules' blocks' closed form, exactly;
     2 x 24 ``flash_attention`` a rank a step (8 of 16 heads each); the
     step p50 beside the single device's, tokens/s, peak memory by rank,
     each rank's all-gather, reduce-scatter and all-reduce bytes and ms a
     step by axis and its step time outside them.
 34. the same grid on granite-8b at full width (32 / 8 heads of 128, GQA)
     cut to 2 of 36 layers (``GSPMD_GQA``: at full depth its state does
     not fit four ranks on one card; 4 until phase 44 needed room under
     the time limit), b 4 x 512, 2 steps at peak lr 1e-5;
     phase 33's checks against the single device at the same cut.
 35. ZeRO-1 (``training/manual_dp.py``) on the same four ranks:
     qwen1.5-0.5b at full size, data 2 x model 2, phase 33's batches, 2
     steps; each rank's optimizer bytes equal to the ``_scatter_dim``
     closed form, the losses within phase 33's limit of phase 33's,
     2 x 24 ``flash_attention`` a rank a step.
 36. the grid at model axis 1: mamba2-780m at full width cut to 8 of 48
     layers (16 until phase 44, 48 until phase 42 needed room under the
     time limit), ``--model-parallel 1
     --data-parallel 2`` on two ranks, b 4 x 2048, 2 steps; phase 33's
     checks against the single device at the same cut in the phase (same
     seed and batches); 2 x 8 ``ssd_scan`` a rank a step.
     Every time and size of phases 33-36 is printed beside the card's
     ``nvidia-smi`` name and power limit.
 37. the grid's model axis for moe (expert parallelism: each member
     holds, fills and runs 64 of the 128 experts and the members sum
     their combines): qwen3-moe-30b-a3b at full width cut to 2 of 48
     layers (phase 22's cut; at 4, the single device's ``--accum 2``
     yardstick does not fit the card), ``--model-parallel 2
     --data-parallel 2`` on four ranks sharing the card, b 2 x 2048, 2
     steps; phase 33's checks against the single device at the same cut
     in the phase (same seed and batches); 2 x 2 ``flash_attention`` a
     rank a step (16 / 2 heads).
 38. ssm (mamba2 head sharding: 24 of 48 heads a member, B and C whole,
     the gated norm's sum of squares over the model group): mamba2-780m
     at full width cut to 16 of 48 layers, 2 x 2, b 4 x
     2048, 2 steps, against the single device at the same cut in the
     phase; 2 x 16 ``ssd_scan`` a rank a step (h 24).
 39. hybrid: zamba2-2.7b at full width cut to one group of 6 (to make
     room for phase 42), 2 x 2, b 4 x 2048, 2 steps at peak lr 1e-4,
     against the single device at the same cut in the phase; 2 x 6
     ``ssd_scan`` (h 40) and 2 x 1 ``flash_attention`` (the shared block's
     16 / 16 heads of 80) a rank a step.
 40. audio (whisper's encoder, decoder and cross-attention heads, the
     cross K/V from the replicated encoder output): whisper-base at full
     size, 2 x 2, b 16 x 448, 2 steps, against phase 26's first two
     losses; 2 x 18 ``flash_attention`` a rank a step (4 / 4 heads).
     Phases 37-40 hold every rank's step to a model-axis sum
     (``model_reduce_bytes`` > 0).  A member rounds its part of each
     row-parallel product to bf16 before the members' sum, so the model
     axis moves the bf16 forward's roundings, which the data axis's
     ``--accum 2`` yardstick does not: the first gradient norm's limit
     also takes 3.5 x how far bf16 moves that reading on the single
     device (its first step in fp32 at the phase's shapes,
     ``grid_limit``).  38, 39 and 40 then run the model axis in fp32 at a
     depth cut (``GSPMD_FP32``: mamba2 2 layers, zamba2 2 groups of 1,
     whisper at full depth; b 4, 2 steps), held to the fp32 single
     device at the CPU tests' limits (``FP32_LIMITS``: first loss 1e-5,
     first gradient norm 1e-4, second loss 1e-4 relative), with no
     rounding allowance.  Phase 3 holds each kernel at the member shapes
     of 37-40 against its plain version and times it beside its library
     call and bound.
 41. the dry-run against the card (``repro_torch.launch.dryrun``: the
     port's train step on the meta device as one rank of a grid of
     counting stand-ins): (a) each grid phase of 33-40, estimated on the
     host's CPU at its arch, cut, mesh, batch and dp mode by a process
     started after phase 2 (``Estimator``), held exactly to what the
     phase measured (each rank's persistent bytes, rank 0's collective
     bytes and calls a step by axis and kind, ZeRO-1's optimizer bytes)
     and its peak to ``PEAK_BAND`` of each rank's
     ``max_memory_allocated``; (b) phase 11's run again under
     ``--remat-policy dots`` (each layer's checkpoint keeping its
     projections' outputs): its losses phase 11's within 1e-6 relative,
     its peak above phase 11's, both step p50s and the estimate's two
     peaks printed; 2 x 24 ``flash_attention`` a step; (e), after 42: the
     serve estimate (``dryrun.estimate_serve``) of each bf16 case of 42, its
     prefill and a decode step, made on the host beside phases 3-41: its
     argument bytes and its collectives' bytes and calls rank 0's exactly,
     its peak within ``PEAK_BAND`` of each rank's.
 42. the grid's serve steps (``sharding/spmd.py``: ``make_prefill_step``,
     ``make_decode_step``, the JAX dry-run's sharded serve steps under the
     copied cache rules) on four ranks sharing the card (data 2 x model
     2, ``--p2p host``), every case in one call of the four-rank pool, bf16
     at full width, b 4 x 512 (+ 256 image tokens) into a cache of 8 more
     slots, 2 of the 8 decode steps: (a) paligemma-3b cut to 2 of 18
     layers, the cache sharded over its sequence (388 of 776 slots a
     member, the partial softmaxes combined); (b) granite-8b cut to 2 of 36 (4
     until phase 44 needed room under the time limit), the cache's 8 kv
     heads 4 a member; (c) mamba2-780m cut to 8 of 48, 24 of 48 heads'
     state a member, the conv cache whole; (d) qwen3-moe cut to 1 of 48 (2
     until phase 44),
     64 experts a member; (e) zamba2-2.7b cut to one group of 6 ssm layers
     and the shared block, the rule's ssm cache (its per over data, its
     batch over model) moved to the blocks the group computes on and back;
     (f) whisper-base at full depth (6 + 6 layers, a prompt of 440), the
     cross cache over its encoder sequence (750 of 1500 slots a member,
     decoded through ``flash_decode``'s slot offset and log-sum-exp); (a)
     and (c) again in fp32 at 1 layer, (e) at one group of 2 and (f) at 1
     + 1 layers (1 decode step).  Each held to the single device at the same cut in the phase,
     on the same seed and prompts, each decode step fed its tokens: every
     rank's cache bytes the closed form exactly; its logits within phase
     5's bf16 limit (an ssm or hybrid case: or ``E2E_SPREAD`` x the single device's
     own spread at other SSD chunks and in fp32; a moe case with the single
     device's routing replayed), fp32 within ``GRID_SERVE_FP32_RTOL``;
     launches pinned a rank a call; prefill ms, decode p50, peak memory by
     rank and each call's collectives by axis printed beside the card's
     name and power limit.
 43. the examples and the card rules (``repro_torch.examples``,
     ``repro_torch.analysis.card_lint``): (a) ``quickstart`` on the card
     for granite-8b and mamba2-780m (smoke configs, bf16): its forward
     logits held to the same call through ``--backend einsum`` at phase
     5's limits (an ssm model's: or ``E2E_SPREAD`` x the einsum path's own
     spread at other SSD chunks), its loss finite, its launches pinned
     (granite: 3 x L ``flash_attention`` for the forward, the step and
     the prefill, 7 x L ``flash_decode``; mamba2: 3 x L ``ssd_scan``);
     (b) ``serve_batch`` at its defaults (mamba2-780m smoke, 8 x 64 + 48)
     and on granite-8b: its prefill logits held as (a)'s, its greedy
     tokens to ``E2E_MIN_AGREE`` of the first 4 against the einsum path
     where the einsum path meets that against itself (its keys reversed,
     or other SSD chunks), launches pinned (L ``ssd_scan``; L
     ``flash_attention`` and 47 x L ``flash_decode``), prefill ms and
     decode tok/s printed beside the card's name and power limit; (c)
     ``train_e2e --full-100m`` (e2e-100m, 12 layers, fp32 with TF32 off,
     its own b8 x 256 batches, 120 steps, checkpoints every 50 steps and
     the resume check): every loss finite, the first within
     ``TRAIN_LOSS_RTOL`` of the einsum path's first loss, the example's
     own drop above its 0.5, the resume check within its 1e-5,
     2 x 12 ``flash_attention`` a step (forward and recompute; the
     resume check's two steps too); step ms, tokens/s, peak memory
     printed; and the fp32 ``flash_attention`` (the CUDA-core
     ``attn_fwd``) timed at its shape, B8 S256 H12/4 hd64 causal, beside
     its plain version, SDPA in fp32 and its bound; (d) the card rules
     against the card: each shape ``CARD_PLANTED`` plants (hd 96, hd 32,
     a decode group G 16 x hd 256, an ``ssd_scan`` of p 128, n 256,
     chunk 512, a bf16 ``ssd_scan`` of p 60) named by the lint's code and
     refused by the kernel's wrapper on the card with the lint's message,
     no launch counted; every catalog config, full and smoke, at 1, 2 and
     4 members' shapes, clean in the lint and one small launch of each
     kernel on its path held to its plain version (``TOL``,
     ``SSD_TOL``); both verdicts printed side by side.
 44. a model axis that does not divide a block's count
     (``sharding/spmd.py::whole_parts``; ``UNDIVIDED_SERVE``,
     ``UNDIVIDED_TRAIN``): (a) starcoder2-7b (36 heads over 4 kv heads,
     window 4096) served on the single device at full width and depth,
     b4 x 512 + 32, through ``repro_torch.launch.serve``, and held to its
     einsum path at phase 5's limits; (b) starcoder2-7b cut to 1 of 32
     layers (its attention whole, its MLP sharded) and (c) whisper-base 6
     + 6 (every part whole) on data 1 x model 3, three ranks sharing the
     card: a prefill and 2 decode steps (fp32 cuts: 1) held as phase 42
     holds its cases, one train step from the seeded state held to the
     single device's loss and first gradient norm (bf16 at phases 33-40's
     limits, fp32 at 1e-5 / 1e-4), the parts computed whole named, cache
     and persistent bytes the closed forms; then (41 (f)) the dry-run's
     estimates of (b), (c) held to the ranks' bytes and calls exactly and
     their peaks to ``PEAK_BAND``.  Prints ``phase 44: <s> s``.

Prints one ``{"kernels": [...]}`` line (each kernel's ``launches`` summed
over the main paths that run it, phases 4, 7, 12, 13, 15–21, 23–26, 28,
29, 32–42 (42's bf16 cases), 43 (a)–(c) and 44 (bf16), each kernel's fp16 row under
``"float16"``,
each counted from 0; the pipeline phases in each rank's own process,
summed over the ranks), the ``nvidia-smi`` name/power line, and last
``{"ok": true, "device": {...}}``.  Each phase's heading carries the
seconds since the script started.

    python3 chip_smoke.py --transports

needs two cards and runs phases 1, 2 and phase 16 (a)'s 1f1b run only,
with one card a rank, once through each stage-to-stage transport:
``--p2p device`` (NCCL, card to card) and ``--p2p host`` (gloo through
pinned host memory), the NCCL run traced as phase 16 (a)'s; with four
cards also granite-8b at full size,
pipe 2 x tp 2 through ``--p2p device`` (3 steps, batch 4 x 2048, peak
learning rate 1e-5; losses finite and falling, launches pinned), which
one card cannot hold, phase 17 (d)'s (pipe 2, tp 2) parity cases and
phase 17 (b)'s ZeRO-1 run with NCCL's reduce-scatter and all-gather;
with three cards or more also phase 18 (a) through ``--p2p device``,
``sr_ag`` (traced) against ``naive``.

    python3 chip_smoke.py --grid-faults

needs one card and runs phases 1, 2 and the controls of phases 33, 36,
37, 38, 42 and 44's checks: phase 33's grid (qwen1.5-0.5b, 2 x 2, its batches
and steps), phase 36's (mamba2-780m, 1 x 2), phase 37's (qwen3-moe, 2
layers, 2 x 2), phase 38's (mamba2-780m, 2 x 2) and phase 42 (a)'s, (e)'s
and (f)'s serve steps (paligemma-3b, 2 layers, the cache sharded over its
sequence; zamba2-2.7b, one group of 6; whisper-base, 6 + 6 layers) with
no fault and then with each fault of ``GRID_FAULTS`` planted in the
ranks' processes (the data axis's gradient sum dropped, every data rank
training on data rank 0's rows, the Megatron all-reduce dropped; in 37
the expert combine's model all-reduce dropped; in 38 the gated norm's
model sum of squares dropped; in 42 (a) the members' partial softmaxes
kept uncombined, and the decode's slot offset dropped to 0; in (e) the
hybrid ssm cache never moved back to the rule's placement; in (f) the
members' cross partials summed without their log-sum-exp weights; in 44
(b)'s train step, starcoder2-7b at 1 layer on data 1 x model 3, a whole
part's gradient summed over the members instead of sliced), each held to the
single device by those phases' checks (38's fp32 model-axis check among
them); it prints each check's reading and limit and which checks refuse
the run, and fails if a faulty run passes them all or the run without a
fault does not.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import queue
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of a kernel against its plain version on the same inputs.
# fp32: both do the same fp32 arithmetic, summed in another order (64-wide
# tiles, fused multiply-adds, an online softmax); that moves O(1) outputs
# by ~1e-6, so 1e-4 absolute holds with margin.
# bf16: both compute in fp32 and round the result to bf16 once; they can
# land one bf16 step apart, at most 2^-7 = 0.8% of the value, hence
# 1e-2 rel.  The largest error measured on an H100 over all bf16 cases
# was 1.95e-3, so 4e-3 abs gives it twice that margin: still about 5% of
# a typical output at the serving shape (~0.07), so a dropped key or a
# wrongly masked tile shows.
# fp16: both compute in fp32 and round the result to fp16 once, so they
# may land one fp16 step apart (2^-10 of the value, inside 2e-3 rel).  The
# tensor-core flash_attention also rounds P to fp16 (11 significant bits)
# before P V: at most 2^-11 of each P, so at most 2^-11 x max |v| on an
# output (about 2.6e-3 at the ~5-sigma |v| of these draws); the CPU
# rehearsal (tests/test_torch_kernels.py) reads 2.8e-3 over 2e-3 rel at
# worst.  So fp16 keeps bf16's atol and a fifth of its rtol: no looser.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (4e-3, 1e-2), "float16": (4e-3, 2e-3)}
# scaled_dot_product_attention (a yardstick for time only) rounds the
# probabilities to bf16 before the product with V, as the einsum path
# does; it sat 1.56e-2 from the plain version on an H100.
LIB_TOL = (3e-2, 2e-2)

# End to end in bf16, kernel path vs einsum path.  The einsum path rounds
# the scores and the probabilities to bf16 before the products (as the
# JAX einsum path does); the kernels keep them in fp32.  Each layer's
# attention output then differs by about a bf16 step, and four layers
# compound it; logits are O(1).  Bound the relative L2 error of the
# logits and their largest absolute error.
E2E_REL_L2 = 3e-2
E2E_MAX_ABS = 0.25
E2E_MIN_AGREE = 3                    # greedy tokens equal on >= 3 of 4 steps
# Phase 14 (zamba2 width, 12 layers): the einsum path moved only by its
# SSD chunk (the same fp32 sums in another order) lands 3.4e-2 to 8.8e-2
# rel L2 and up to 0.76 max abs from itself in bf16, and its greedy
# tokens agree with its own on 1 of 4 steps (measured on an H100, batch
# 4 x prompt 512): every flipped bf16 rounding is carried through 12
# layers, three times phase 5's depth, so phase 5's limits sit inside
# the plain path's own spread.  There each logit limit is the larger of
# phase 5's and E2E_SPREAD x that spread, measured in the same run at
# chunk / 2 and / 4 (the kernel path read 0.55-1.14x it; a wrong tile or
# mask moves the logits by O(1)), and the tokens are held to
# E2E_MIN_AGREE only where the einsum path meets it against itself.  In
# fp32, run beside it, the kernel path reads 1.1e-4 to 2.4e-4 and the
# spread 7.2e-5 to 1.9e-4, and phase 5's limits hold, tokens included.
# The multiple is phase 9's.
E2E_SPREAD = 3.5

# ssd_scan against ssd_ref: both read the same inputs (bf16 ones too) and
# compute in fp32, the kernel chunk by chunk and the reference position by
# position, so fp32's tolerance holds for both input types (as
# tests/test_kernels.py: rtol 1e-3, atol 1e-4).  The bf16 kernels hand
# their fp32 intermediates to the tensor cores as hi + lo bf16 pairs
# (about 16 significant bits), which keeps them inside it.
SSD_TOL = (1e-4, 1e-3)
# Gradients of an autograd Function against an independent plain
# version's: both differentiate fp32 math (flash_attention: against
# ``plain_attention`` below, written apart from ``ref``; ssd_scan: the
# chunked form against the sequential ``ref.ssd_ref``), so they agree to
# fp32 rounding, or to one bf16 step of the gradient; atol as a share of
# the largest entry.
# fp16: both round their fp32 gradient to fp16 once, one fp16 step
# (2^-10 of an entry, so at most ~1e-3 of the largest) apart.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2e-3}
# Training, kernel path vs einsum path in fp32 (phase 9): the SSD forward
# differs in summation order only (~1e-6 relative), and three AdamW steps
# keep that size: losses within 1e-4 relative, per-leaf gradient norms
# at step 1 within 1e-3 relative.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GNORM_RTOL = 1e-3
# The same in bf16 (phase 9's twin, the tensor-core ssd_scan): both paths
# compute the SSD in fp32 from bf16 inputs and differ by ~1e-5 relative
# there, but the block rounds the SSD output to bf16, so a difference
# that small flips some roundings by one bf16 step (0.4%), and layers and
# steps carry the flips on.  The losses, sums over every token, stay
# within 1e-3 relative.  A gradient norm can move far more, and by a
# different amount in each leaf: one whose gradient is a small residual
# of large terms (A_log, dt_bias) amplifies the flips.  The chunked path
# moves each leaf as much when only its chunk, its summation order,
# changes.  So each leaf is held to its own spread, measured in the same
# run: the kernel path's relative norm difference from the chunked path
# is at most 3.5x the larger of that leaf's differences at chunk / 2 and
# chunk / 4, or of 2e-3 where a leaf barely moves.  The CPU rehearsal
# (tests/test_torch_ssm.py::test_bf16_kernel_path_training_rehearsal,
# batch 1 x seq 512) puts the kernels' arithmetic at most 2.5x that
# yardstick on every leaf and one bf16 rounding of the fp32
# intermediates (no hi + lo split) at 5x on its worst leaf; 3.5 lies
# between.  A wrong tile or mask moves the SSD output by O(1) and the
# gradients by far more.
TRAIN_BF16_LOSS_RTOL = 1e-3
TRAIN_BF16_GNORM_SPREAD = 3.5
TRAIN_BF16_GNORM_FLOOR = 2e-3
TRAIN_BF16_CHUNK_DIVISORS = (2, 4)

FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FD_SOURCE = "src/repro_torch/kernels/csrc/flash_decode.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:31"
FD_REPLACES = "src/repro/kernels/flash_decode.py:49"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:27"
RN_SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
RN_REPLACES = "src/repro/kernels/rmsnorm.py:17"

# rmsnorm: (label, rows, d, misaligned x).  The profile's shape first
# (t_rmsnorm at seq 4096, d_model 4096); then row counts that are no
# multiple of any tile, d not a multiple of a 16-byte vector (an unaligned
# head and a scalar tail in every row but some), narrow rows (one warp a
# row), and x starting one element past a 16-byte boundary (scalar path).
RN_PROFILE = ("profile: 4096 x 4096", 4096, 4096, False)
RN_CASES = [
    ("37 x 1000", 37, 1000, False),
    ("37 x 1001", 37, 1001, False),
    ("129 x 4100", 129, 4100, False),
    ("3 x 20 (d < one vector of fp32 x 2)", 3, 20, False),
    ("300 x 14336 (more than 8 vectors a thread)", 300, 14336, False),
    ("65 x 2048, x misaligned", 65, 2048, True),
]
RN_GRAD = [("grad: 512 x 4096", 512, 4096, False), ("grad: 37 x 1001", 37, 1001, False)]

# Phase 12: the profiler at the main path's model, and the plan it prices:
# the A:4 + B:4 two-type plan of tests/test_dataparallel.py:351 at tp 1,
# granite-8b's 36 layers split 18 / 18 over two stages a type, dp 2.
# t_wgrad is the median of iters pairs of backward passes on one graph,
# the full one less the input-only one, each timed on the card's clock
# behind a sleep of the card that outlasts the host's launches, so that
# neither a stalled host nor the host's launch cadence (which hid a small
# block's weight-gradient GEMMs and read t_wgrad 0.0) enters the difference.
PROFILE_ARCH, PROFILE_SEQ, PROFILE_ITERS = "granite_8b", 4096, 20

# (label, b, S, h, p, g, n, chunk)
SSD_TRAIN = ("training: b4 S2048 h48 p64 g1 n128", 4, 2048, 48, 64, 1, 128, 256)
SSD_CASES = [
    ("prefill: b4 S512 h48 p64 g1 n128", 4, 512, 48, 64, 1, 128, 256),
    ("g 2, S = chunk 128, p32 n64", 2, 128, 8, 32, 2, 64, 128),
    ("smoke: S96 chunk 32, p32 n16", 2, 96, 4, 32, 1, 16, 32),
    # a pipeline microbatch of mamba2-780m (phases 16, 17, 19)
    ("pipeline: b1 S2048 h48 p64 g1 n128", 1, 2048, 48, 64, 1, 128, 256),
]
SSD_GRAD = ("grad: b1 S512 h48 p64 g1 n128", 1, 512, 48, 64, 1, 128, 256)
FA_GRAD = [
    ("grad: qwen B2 S1024 H16 hd64", 2, 1024, 1024, 16, 16, 64, True, 0, 0, 0),
    ("grad: window 96, q_offset 64, GQA 8/2", 1, 256, 320, 8, 2, 128, True, 96, 64, 0),
    ("grad: zamba2 heads B1 S512 H32 hd80", 1, 512, 512, 32, 32, 80, True, 0, 0, 0),
    # qwen3-moe-30b-a3b's training shape: a GQA group of 8
    ("grad: qwen3-moe B2 S2048 H32 KV4 hd128", 2, 2048, 2048, 32, 4, 128, True, 0, 0, 0),
    # whisper-base's encoder at its training batch: non-causal, ragged Sk
    ("grad: whisper encoder B16 S1500 H8 hd64", 16, 1500, 1500, 8, 8, 64, False, 0, 0, 0),
    # paligemma-3b's training shape: b 4 x (256 image + 512 text), MQA, hd 256
    ("grad: paligemma B4 S768 H8 KV1 hd256 prefix 256", 4, 768, 768, 8, 1, 256, True, 0, 0,
     256),
]
# zamba2-2.7b's ssd_scan shapes: h 80 heads of p 64, state n 64
SSD_ZAMBA2 = [
    ("zamba2 training: b4 S2048 h80 p64 g1 n64", 4, 2048, 80, 64, 1, 64, 256),
    ("zamba2 prefill: b4 S512 h80 p64 g1 n64", 4, 512, 80, 64, 1, 64, 256),
]

# a model member's ssd_scan at 2 x 2 (phases 38, 39): half of mamba2-780m's 48
# and of zamba2-2.7b's 80 heads, at half of the batch of 4
SSD_MEMBERS = [
    ("mamba2 member: b2 S2048 h24 p64 g1 n128", 2, 2048, 24, 64, 1, 128, 256),
    ("zamba2 member: b2 S2048 h40 p64 g1 n64", 2, 2048, 40, 64, 1, 64, 256),
]

TRAIN_ARGS = ["--arch", "mamba2_780m", "--batch", "4", "--seq", "2048",
              "--steps", "6", "--backend", "auto", "--device", "cuda",
              "--log-every", "1"]
SSM_SERVE_ARGS = ["--arch", "mamba2_780m", "--batch", "4", "--prompt-len", "512",
                  "--gen", "32", "--backend", "auto", "--device", "cuda"]
DENSE_TRAIN_ARGS = ["--arch", "qwen1p5_0p5b", "--batch", "2", "--seq", "1024",
                    "--steps", "3", "--backend", "auto", "--device", "cuda",
                    "--log-every", "1"]
HYBRID_TRAIN_ARGS = ["--arch", "zamba2_2p7b", "--batch", "4", "--seq", "2048",
                     "--steps", "4", "--backend", "auto", "--device", "cuda",
                     "--log-every", "1"]
HYBRID_SERVE_ARGS = ["--arch", "zamba2_2p7b", "--batch", "4", "--prompt-len", "512",
                     "--gen", "32", "--backend", "auto", "--device", "cuda"]
# Phase 14: zamba2 at full width cut to 2 groups of 6 ssm layers
HYBRID_CUT_LAYERS = 12

# (label, B, Sq, Sk, H, KV, hd, causal, window, q_offset, prefix): prefix
# keys visible to every query under causal (a bidirectional prefix)
FA_CASES = [
    ("ragged S=200, hd 64", 2, 200, 200, 4, 4, 64, True, 0, 0, 0),
    ("GQA 8/2, hd 128", 2, 256, 256, 8, 2, 128, True, 0, 0, 0),
    ("causal + window 96", 2, 320, 320, 8, 8, 128, True, 96, 0, 0),
    ("q_offset 320", 1, 100, 420, 4, 2, 128, True, 0, 320, 0),
    ("non-causal, ragged Sk", 2, 130, 150, 4, 4, 64, False, 0, 0, 0),
    ("window 50, GQA, hd 64", 1, 300, 300, 8, 4, 64, True, 50, 0, 0),
    ("ragged S=200, hd 80", 2, 200, 200, 4, 4, 80, True, 0, 0, 0),
    ("window 96, GQA 8/4, hd 80", 2, 320, 320, 8, 4, 80, True, 96, 0, 0),
    # a qwen1.5-0.5b microbatch on a tp-2 member (phases 17, 18): 8 of 16 heads
    ("qwen tp 2: B2 S1024 H8 hd64", 2, 1024, 1024, 8, 8, 64, True, 0, 0, 0),
    # qwen3-moe-30b-a3b's grouping (phases 20-24): 32 query heads over 4 kv heads
    ("GQA 32/4, hd 128", 1, 256, 256, 32, 4, 128, True, 0, 0, 0),
    # paligemma-3b's prefix-LM mask and head_dim 256 (phases 28-30): ragged
    # prefixes (no multiple of the 64-key tile) at hd 64 and 128, a prefix
    # under a window, a prefix past the queries with a q_offset (every key
    # visible), hd 256 alone and with MQA, and a prefix given to a
    # non-causal call, where it changes nothing
    ("prefix 100, GQA 4/2, hd 64", 2, 300, 300, 4, 2, 64, True, 0, 0, 100),
    ("prefix 70, MQA 8/1, hd 128", 1, 260, 260, 8, 1, 128, True, 0, 0, 70),
    ("prefix 130 + window 96, hd 256", 2, 400, 400, 8, 1, 256, True, 96, 0, 130),
    ("prefix 300, q_offset 100, hd 64", 1, 200, 300, 4, 2, 64, True, 0, 100, 300),
    ("ragged S=200, hd 256", 2, 200, 200, 4, 4, 256, True, 0, 0, 0),
    ("non-causal, prefix 50 ignored", 2, 130, 150, 4, 4, 64, False, 0, 0, 50),
]
FA_SERVE = ("serving: B4 S512 H32 KV8 hd128", 4, 512, 512, 32, 8, 128, True, 0, 0, 0)
# t_attn of the profile (phase 12): granite-8b's heads at seq 4096
FA_PROFILE = ("profile: B1 S4096 H32 KV8 hd128", 1, 4096, 4096, 32, 8, 128, True, 0, 0, 0)
# zamba2-2.7b's shared block: 32 heads of 2560 / 32 = 80, kv 32
FA_ZAMBA2 = [
    ("zamba2 prefill: B4 S512 H32 KV32 hd80", 4, 512, 512, 32, 32, 80, True, 0, 0, 0),
    ("zamba2 training: B4 S2048 H32 KV32 hd80", 4, 2048, 2048, 32, 32, 80, True, 0, 0, 0),
]

# (label, B, KV, G, S, hd, pos, window, softcap, ring, q_scale)
FD_CASES = [
    ("linear pos 520", 4, 8, 4, 544, 128, 520, 0, 0.0, False, 1.0),
    ("ring + window 300", 4, 8, 4, 544, 128, 1000, 300, 0.0, True, 1.0),
    ("ring, unwritten slots", 4, 8, 4, 544, 128, 300, 0, 0.0, True, 1.0),
    ("softcap 50", 4, 8, 4, 544, 128, 543, 0, 50.0, False, 40.0),
    ("pages past pos masked", 4, 8, 4, 544, 128, 40, 0, 0.0, False, 1.0),
    ("pages before window masked", 4, 8, 4, 544, 128, 520, 100, 0.0, False, 1.0),
    ("hd 64, G 1", 2, 16, 1, 200, 64, 150, 0, 0.0, False, 1.0),
    ("G 9 (starcoder2 heads)", 2, 4, 9, 333, 128, 300, 0, 0.0, False, 1.0),
    ("hd 80, G 4", 4, 8, 4, 544, 80, 520, 0, 0.0, False, 1.0),
    ("hd 80, ring + window 300", 4, 8, 4, 544, 80, 1000, 300, 0.0, True, 1.0),
    ("hd 80, G 25 (the most at hd 80)", 2, 4, 25, 333, 80, 300, 0, 0.0, False, 1.0),
]
FD_SERVE = ("serving: B4 KV8 G4 hd128 S544", 4, 8, 4, 544, 128, 543, 0, 0.0, False, 1.0)
# qwen3-moe-30b-a3b's shapes: 32 query heads over 4 kv heads (GQA 8),
# hd 128; prefill (phase 20), a training batch (phases 21, 22) and decode
FA_QWEN3_MOE = [
    ("qwen3-moe prefill: B4 S512 H32 KV4 hd128", 4, 512, 512, 32, 4, 128, True, 0, 0, 0),
    ("qwen3-moe training: B2 S2048 H32 KV4 hd128", 2, 2048, 2048, 32, 4, 128, True, 0, 0, 0),
]
FD_QWEN3_MOE = ("qwen3-moe decode: B4 KV4 G8 hd128 S544", 4, 4, 8, 544, 128, 543, 0, 0.0,
                False, 1.0)
FD_ZAMBA2 = ("zamba2 decode: B4 KV32 G1 hd80 S544", 4, 32, 1, 544, 80, 543, 0, 0.0, False,
             1.0)
# whisper-base's shapes (phases 25-27): 8 heads of 64, kv 8, 1500 encoder
# frames (23 x 64 + 28: a ragged last key tile that no causal bound
# masks), the decoder's 448 positions; each with the q_offset ``attend``
# passes (Sk - Sq), which a non-causal call must ignore.  The encoder and
# the cross-attention at the serving batch (8, prompt 416), decode's
# cross-attention through the prefill kernel at Sq = 1, and the decoder's
# self-attention at the training batch (16 x 448)
FA_WHISPER = [
    ("whisper encoder: B8 S1500 H8 hd64", 8, 1500, 1500, 8, 8, 64, False, 0, 0, 0),
    ("whisper cross: B8 Sq416 Sk1500 H8", 8, 416, 1500, 8, 8, 64, False, 0, 1084, 0),
    ("whisper decode cross: B8 Sq1 Sk1500", 8, 1, 1500, 8, 8, 64, False, 0, 1499, 0),
    ("whisper self: B16 S448 H8 hd64", 16, 448, 448, 8, 8, 64, True, 0, 0, 0),
]
# a model member's flash_attention at 2 x 2 (phases 37, 39, 40): half of
# the heads at half of the batch; qwen3-moe's 32 / 4, zamba2's shared
# block's 32 / 32 at hd 80, whisper-base's 8 / 8 in its encoder, decoder
# and cross-attention
FA_MEMBERS = [
    ("qwen3-moe member: B1 S2048 H16 KV2 hd128", 1, 2048, 2048, 16, 2, 128, True, 0, 0, 0),
    ("zamba2 member: B2 S2048 H16 KV16 hd80", 2, 2048, 2048, 16, 16, 80, True, 0, 0, 0),
    ("whisper enc member: B8 S1500 H4 hd64", 8, 1500, 1500, 4, 4, 64, False, 0, 0, 0),
    ("whisper self member: B8 S448 H4 hd64", 8, 448, 448, 4, 4, 64, True, 0, 0, 0),
    ("whisper cross member: B8 448x1500 H4", 8, 448, 1500, 4, 4, 64, False, 0, 1052, 0),
]
FD_WHISPER = ("whisper decode: B8 KV8 G1 hd64 S448", 8, 8, 1, 448, 64, 447, 0, 0.0, False,
              1.0)
# starcoder2-7b's shapes (phase 44 (a)): 36 query heads over 4 kv heads
# (GQA 9) of 128 under its window of 4096, which the prefill of 512 never
# reaches (so the library call's causal mask is the same mask) and the
# decode against the 544-slot cache (512 + 32) takes as a window
FA_STARCODER2 = ("starcoder2 prefill: B4 S512 H36 KV4 hd128 w4096", 4, 512, 512, 36, 4, 128,
                 True, 4096, 0, 0)
FD_STARCODER2 = ("starcoder2 decode: B4 KV4 G9 hd128 S544", 4, 4, 9, 544, 128, 543, 4096,
                 0.0, False, 1.0)
# paligemma-3b's shapes (phases 28-30): 8 query heads over one kv head of
# 256, so G x hd = 2048, the most the decode kernel takes.  The prefill
# (and the training batch): B 4 x (256 image + 512 text) positions, the
# first 256 a bidirectional prefix; decode against the 800-slot cache (256
# + 512 + 32), linear at its last position, and a ring with a window
FA_PALIGEMMA = ("paligemma prefill: B4 S768 H8 KV1 hd256 prefix 256", 4, 768, 768, 8, 1,
                256, True, 0, 0, 256)
FD_PALIGEMMA = ("paligemma decode: B4 KV1 G8 hd256 S800", 4, 1, 8, 800, 256, 799, 0, 0.0,
                False, 1.0)
FD_PALIGEMMA_RING = ("paligemma ring + window 300: hd256 S800", 4, 1, 8, 800, 256, 1500, 300,
                     0.0, True, 1.0)
# A model member's decode on the grid's serve path (phase 42): a block of a
# longer cache, (label, B, KV, G, S, hd, pos, window, softcap, ring,
# q_scale, slot0, the whole cache's length), the kernel also returning each
# head's log-sum-exp.  (a) paligemma at 2 x 2: the cache of 256 image + 512
# + 8 slots sharded over its sequence, 388 of 776 slots a member, every one
# of its 8 heads over the one kv head; (b) granite-8b at 2 x 2: 4 of 8 kv
# heads a member, 16 / 4 heads, the whole 520 slots (and, for the offset,
# half of them); (f) whisper-base at 2 x 2: the cross cache over its 1500
# encoder slots, 750 a member, every one of its 8 heads over the 8 kv heads
# at the last slot's position (every slot live).  Each at the block's last
# decode position, in a ring with a window, and where the block holds no
# live slot (out 0, lse -inf).
FD_MEMBERS = [
    ("paligemma member: 388 of 776 at 388", 2, 1, 8, 388, 256, 775, 0, 0.0, False, 1.0,
     388, 776),
    ("paligemma member 0: 388 of 776 at 0", 2, 1, 8, 388, 256, 775, 0, 0.0, False, 1.0,
     0, 776),
    ("paligemma member ring + window 300", 2, 1, 8, 388, 256, 1500, 300, 0.0, True, 1.0,
     388, 776),
    ("paligemma member, no live slot", 2, 1, 8, 388, 256, 300, 0, 0.0, False, 1.0, 388, 776),
    ("granite member: B2 KV4 G4 hd128 S520", 2, 4, 4, 520, 128, 519, 0, 0.0, False, 1.0,
     0, 520),
    ("granite member: 260 of 520 at 260", 2, 4, 4, 260, 128, 519, 0, 0.0, False, 1.0,
     260, 520),
    ("granite member ring + window 300", 2, 4, 4, 260, 128, 1000, 300, 0.0, True, 1.0,
     260, 520),
    ("whisper cross member: 750 of 1500 at 750", 2, 8, 1, 750, 64, 1499, 0, 0.0, False,
     1.0, 750, 1500),
    ("whisper cross member 0: 750 of 1500 at 0", 2, 8, 1, 750, 64, 1499, 0, 0.0, False,
     1.0, 0, 1500),
    # phase 44 at model 3: (b) starcoder2's cache of 522 slots over its
    # sequence, 174 a member, all 36 heads over the 4 kv heads under the
    # window; (c) whisper's cross cache, 500 of 1500 a member
    ("starcoder2 member: 174 of 522 at 348", 4, 4, 9, 174, 128, 521, 4096, 0.0, False, 1.0,
     348, 522),
    ("whisper cross member: 500 of 1500 at 1000", 4, 8, 1, 500, 64, 1499, 0, 0.0, False,
     1.0, 1000, 1500),
]
FD_MEMBER_ROWS = (FD_MEMBERS[0], FD_MEMBERS[4], FD_MEMBERS[7])   # timed: (a)'s, (b)'s, (f)'s
# the log-sum-exp against the plain version's: both fp32 from the same
# inputs, summed in another order (the kernel's splits); ~10 in size
LSE_TOL = (1e-4, 1e-5)

SERVE_ARGS = ["--arch", "granite_8b", "--batch", "4", "--prompt-len", "512",
              "--gen", "32", "--backend", "auto", "--device", "cuda"]
# Phases 20-24: qwen3-moe-30b-a3b (E 128, k 8, d 2048, expert d_ff 768, 48
# layers, vocab 151936, 30.5 B parameters).  Serving at full width and
# depth (61 GB of bf16 weights); training at full width cut to 4 of 48
# layers (AdamW's fp32 master, m and v beside the bf16 weights and
# gradients, 16 bytes a parameter: 49.8 GB at 4 layers, 69.8 GB at 6)
MOE_ARCH = "qwen3_moe_30b_a3b"
MOE_SERVE_ARGS = ["--arch", MOE_ARCH, "--batch", "4", "--prompt-len", "512",
                  "--gen", "32", "--backend", "auto", "--device", "cuda"]
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_ARGS = ["--arch", MOE_ARCH, "--batch", "2", "--seq", "2048", "--steps", "4",
                  "--backend", "auto", "--device", "cuda", "--log-every", "1"]
# Phase 22: the kernel path against the plain path at qwen3-moe's width
MOE_CUT_LAYERS = 2
# Phase 24: (a) qwen3-moe cut to 2 layers, one a stage on chips A and B
# (recompute on / off), 4 microbatches of 1 x 2048, 2 steps.  Every rank
# holds its stage's layers padded to the largest stage's count (the JAX
# package's stage layout), each slot with its fp32 AdamW state and
# gradient accumulator, and a copy of the 0.62 B-parameter embedding and
# head: at 4 layers split 1 / 3 that is 2.49 B parameters, ~45 GB, a rank,
# and the two ranks do not fit one card (rank 0 ran out of memory at 32.8
# GiB allocated); at 1 / 1 it is 1.25 B, ~25 GB.  (b) 2 layers (1 / 1) in
# fp32, 4 microbatches of 1 x 2048, under 1f1b and zb_v
MOE_PP_LAYERS = 2
MOE_PP_STAGES = (("A", 1, True), ("B", 1, False))
MOE_PP_ARGS = ["--batch", "4", "--seq", "2048", "--steps", "2"]
MOE_PP_PARITY = (MOE_ARCH, 2, 1, 2048)
MOE_PP_PARITY_SPLIT = (1, 1)
MOE_PP_PARITY_SCHEDULES = ("1f1b", "zb_v")
# Phases 25-27: whisper-base (6 encoder + 6 decoder layers, d 512, 8 heads
# of 64, vocab 51865, 1500 encoder frames; 98.0 M parameters), at full
# width and depth.  Serving fills the decoder's 448 positions (prompt 416
# + 32 tokens, the largest cross-attention Sq); training b 16 x 448
WHISPER_ARCH = "whisper_base"
WHISPER_LAYERS = 6
WHISPER_SERVE_ARGS = ["--arch", WHISPER_ARCH, "--batch", "8", "--prompt-len", "416",
                      "--gen", "32", "--backend", "auto", "--device", "cuda"]
WHISPER_TRAIN_ARGS = ["--arch", WHISPER_ARCH, "--batch", "16", "--seq", "448", "--steps",
                      "6", "--backend", "auto", "--device", "cuda", "--log-every", "1"]
WHISPER_SEQ = 448
# whisper's block is host-bound on the card: its wgrad is a few percent of
# its ~5 ms backward, so its profile takes more pairs than phase 12's
WHISPER_PROFILE_ITERS = 100

# Phases 28-30: paligemma-3b (the Gemma-2B language model of 18 layers, d
# 2048, 8 query heads over 1 kv head of 256, GeGLU d_ff 16384, vocab
# 257216, tied embeddings; 2.51 B parameters, 5.0 GB in bf16) behind 256
# stub image tokens that enter as a bidirectional prefix, at full width
# and depth.  Serving: batch 4 x (256 image + 512 prompt) + 32 tokens, an
# 800-slot cache; training b 4 x 512 text (768 positions with the prefix):
# 16 bytes a parameter of weights, gradients and AdamW state (~40 GB) and
# the 2.1 GB of fp32 logits of the loss's one chunk fit the card whole.  At
# the launcher's peak learning rate (3e-4, reached at step 5) a random-init
# paligemma's loss falls from step 1 to 2 (lr 6e-5) and then rises past
# its first value (12.88, 11.46, 16.13, 13.84, 13.86 on an H100 80GB HBM3
# at 700 W); it is trained at peak 3e-5, as the four-card granite-8b run
# at 1e-5
PALIGEMMA_ARCH = "paligemma_3b"
PALIGEMMA_LAYERS = 18
PALIGEMMA_SERVE_ARGS = ["--arch", PALIGEMMA_ARCH, "--batch", "4", "--prompt-len", "512",
                        "--gen", "32", "--backend", "auto", "--device", "cuda"]
PALIGEMMA_TRAIN_ARGS = ["--arch", PALIGEMMA_ARCH, "--batch", "4", "--seq", "512", "--steps",
                        "5", "--lr", "3e-5", "--backend", "auto", "--device", "cuda",
                        "--log-every", "1"]
PALIGEMMA_SEQ = 768                  # the profiler's length: 256 image + 512 text
PALIGEMMA_PROFILE_ITERS = 40
# Phase 30: the kernel path against the einsum path at full width cut to 4
# layers, b 2 x (256 image + 256 text)
PALIGEMMA_CUT_LAYERS = 4
PALIGEMMA_CUT_BATCH = (2, 256)

# Phase 16: HeteroPP on one card, two ranks sharing it through gloo
# ("--p2p host": NCCL refuses two ranks on one card).  Each plan is two
# stages on different chip types of core/chips.py with a non-uniform
# split, as HeteroAuto gives a heterogeneous cluster: (chip, layers,
# recompute) a stage.  b microbatches of batch / b rows each.
PP_ARGS = ["--backend", "auto", "--device", "cuda", "--log-every", "1"]
# Both models at full width cut in depth (qwen1.5-0.5b to 8 of 24 layers,
# mamba2-780m to 16 of 48; phases 17-19 likewise, PIPELINE_CUT): the full
# depth ran here until phase 41 needed room under the time limit, and
# what the full depth adds is more of the same layers and their bytes.
PP_QWEN = ("qwen1p5_0p5b", (("A", 3, True), ("B", 5, False)), 4,
           ["--batch", "8", "--seq", "1024", "--steps", "2"])
PP_MAMBA2 = ("mamba2_780m", (("A", 6, True), ("B", 10, True)), 4,
             ["--batch", "4", "--seq", "2048", "--steps", "2"])
# Phase 16 (c): both widths cut to 4 layers split 1 / 3, every schedule
# of the library, against the single-device loss and gradient on the
# same weights and microbatches, at phase 9's limits.  gpipe, 1f1b and
# zb_h1 run one tick program, so their losses must agree bit for bit,
# and the chunked schedules run the same layers on the same inputs, so
# theirs must equal them.
PP_PARITY_SCHEDULES = ("gpipe", "1f1b", "zb_h1", "interleaved", "interleaved3", "zb_v",
                       "wave")
PP_PARITY = [("qwen1p5_0p5b", 4, 2, 1024), ("mamba2_780m", 4, 1, 2048)]
PP_PARITY_SPLIT = (1, 3)
PP_PARITY_DTYPES = ("float32", "bfloat16")
# One hop's cost alone, at (a)'s and (b)'s activation shapes in bf16
PP_HOPS = [("qwen 2 x 1024 x 1024", (2, 1024, 1024)),
           ("mamba2 1 x 2048 x 1536", (1, 2048, 1536))]
PP_HOP_ITERS = 20
# Phase 17: tensor and data parallelism in HeteroPP, four ranks sharing
# the card through gloo.  (a) phase 16 (a)'s qwen1.5-0.5b 3 / 5 plan
# with two Megatron members a stage; (b) qwen1.5-0.5b cut to 8 layers,
# even split, two replicas under ZeRO-1, 4 microbatches of 2 x 1024 each;
# (c) mamba2-780m at full width cut to 8 of 48 layers (to stay inside the
# time limit), two replicas under bucketed psum, 4 microbatches of 1 x
# 2048 each; (d) parity at 4 layers against the single device, phase 16
# (c)'s limits, with bucketed psum bit for bit per-leaf psum and ZeRO-1's
# master weights after one step within ZERO_MASTER_RTOL of psum's.
GRID_TP, GRID_DP = 2, 2
GRID_DENSE_DP = ("qwen1p5_0p5b", 8, ["--pipeline-parallel", "2", "--data-parallel", "2",
                                      "--grad-sync", "reduce_scatter", "--microbatches",
                                      "4", "--batch", "16", "--seq", "1024", "--steps", "3"])
GRID_SSM_DP = ("mamba2_780m", 8, ["--pipeline-parallel", "2", "--data-parallel", "2",
                                   "--grad-sync", "psum", "--bucket-bytes", "25000000",
                                   "--microbatches", "4", "--batch", "8", "--seq", "2048",
                                   "--steps", "2"])
# (d)'s cases: phase 16 (c)'s widths at 4 layers under the grids each
# family runs (tp shards dense blocks only), and granite-8b's width, whose
# GQA (32 / 8 heads, 16 / 4 a tp member) qwen's 16 / 16 does not cover
GRID_PARITY = [("qwen1p5_0p5b", 4, 2, 1024, ("tp", "dp")),
               ("mamba2_780m", 4, 1, 2048, ("dp",)),
               ("granite_8b", 4, 1, 2048, ("tp",))]
GRID_PARITY_BUCKET = 25_000_000
ZERO_MASTER_RTOL = 1e-6
# ZeRO-1's optimizer state a rank: half of the 12 bytes a parameter
# (fp32 master, m, v) its stage holds at dp 1, within this share (leaves
# with no dim the dp degree divides stay whole)
ZERO_OPT_SHARE = (0.5, 0.02)
# --transports with four cards: granite-8b at full size, pipe 2 x tp 2,
# one card a rank through NCCL.  At the launcher's peak learning rate
# (3e-4) a random-init granite-8b's loss rises over its first steps, on
# the single device as on the grid; at 1e-5 it falls
TRANSPORT_TP = ("granite_8b", 36, ["--pipeline-parallel", "2", "--tensor-parallel", "2",
                                   "--microbatches", "4", "--batch", "4", "--seq", "2048",
                                   "--steps", "3", "--lr", "1e-5"])
# ... and phase 17 (d)'s tp cases through NCCL (the dp cases stay on the
# host transport: NCCL's ring sums four ranks in an order that depends on
# the buffer, so bucketed and per-leaf psum need not agree bit for bit)
GRID_PARITY_NCCL = [(a, n, mb, seq, ("tp",)) for a, n, mb, seq, k in GRID_PARITY
                    if "tp" in k]
# Phase 18: grouped non-uniform tp, Σ tp_s = 3 ranks sharing the card
# through gloo.  qwen1.5-0.5b at full width, phase 16 (a)'s batch (4
# microbatches of 2 x 1024), 5 / 3 layers (of 24) between a stage of one tp
# degree on chip A and one of another on chip B: (a) tp (2, 1) under
# each boundary strategy, (b) tp (1, 2) under the one choose_strategy
# picks (sr_ag).  (chip, tp, layers, recompute) a stage.
HETERO_QWEN = ("qwen1p5_0p5b", 4, 2, 1024, ["--batch", "8", "--seq", "1024", "--steps", "2"])
HETERO_RUNS = [("(a)", (("A", 2, 5, True), ("B", 1, 3, False)), ("sr_ag", "naive")),
               ("(b)", (("A", 1, 5, True), ("B", 2, 3, False)), ("sr_ag",))]
# (c): qwen's width at 4 layers split 1 / 3, both layouts, both
# strategies, fp32, against the single device at phase 17 (d)'s limits
HETERO_PARITY = ("qwen1p5_0p5b", 4, 2, 1024)
HETERO_LAYOUTS = ((2, 1), (1, 2))
HETERO_STRATEGIES = ("sr_ag", "naive")
# Phase 19: an uneven batch domain, replica 0 taking 4 microbatches and
# replica 1 taking 3, on a (dp 2, pipe 2, tp 1) grid of four ranks sharing
# the card: mamba2-780m at full width cut to phase 17 (c)'s 8 layers (4 /
# 4), 7 microbatches of 1 x 2048 a step, 2 steps in each dp sync mode
# ((name, dp_sync, bucket_bytes); ZeRO-1 ignores the bucket size, and the
# plan verifier prices in buckets only, refusing bucket_bytes 0, so the
# per-leaf psum run passes --no-verify-plan); and at 4 layers in fp32 against the single device on
# the same 7 microbatches
DOMAIN = (4, 3)
DOMAIN_SSM = ("mamba2_780m", 8, 48, 1, 2048, ["--batch", "7", "--seq", "2048",
                                             "--steps", "2"])
DOMAIN_SYNCS = [("ZeRO-1", "reduce_scatter", GRID_PARITY_BUCKET), ("per-leaf psum", "psum", 0),
                ("bucketed psum", "psum", GRID_PARITY_BUCKET)]
DOMAIN_PARITY = ("mamba2_780m", 4, 1, 2048)


# Phases 31-32, the DiTorch precision harness (repro_torch.precision): the
# operator sweep at the reference's tolerance, and qwen1.5-0.5b (the
# harness's own model in the reference's tests) at full width and depth,
# trained under fp32, bf16 and fp16 for the reference's default 50
# iterations each from one seed on one stream, b 4 x 512 (2048 tokens a
# step, as phase 11), remat off as in the reference's curves: one
# flash_attention a layer a step (the backward recomputes the plain
# version).
# bf16's curve is held to the paper's criterion.  fp16's is held to finite
# losses, its MRE printed: the reference has no loss scaling, and at this
# vocabulary (151936) and batch (2048 tokens) the logits' gradient
# p_j / 2048 (~3e-9) rounds to zero in fp16, so the softmax gradient of
# every token absent from a batch is dropped, in the JAX package as in the
# port (tests/test_torch_fp16.py; ROADMAP C).  The phase prints the share
# of the tied embedding's rows whose first gradient is exactly zero.
SWEEP_TOL = 0.1
ALIGN_ARCH, ALIGN_ITERS, ALIGN_BATCH, ALIGN_SEQ = "qwen1p5_0p5b", 50, 4, 512
ALIGN_DTYPES = ("float32", "bfloat16", "float16")
ALIGN_HELD = ("bfloat16",)
# Phases 33-40, the (data, model) grid (repro_torch.sharding.spmd, the JAX
# launcher's GSPMD path; training/manual_dp.py's ZeRO-1) on one card, its
# ranks sharing it through --p2p host.  Each run is held to the single
# device's port run on the same seed and batches.  The grid sums its data
# ranks' bf16 gradients (and its model members' bf16 partial outputs)
# through fp32 and rounds them back, an order of sums the single device
# does not take, and a random-init model's losses carry such roundings on
# from step to step: qwen1.5-0.5b's sixth loss on the 2 x 2 grid lay
# 1.03e-3 from the single device's, its first five within 3e-4.  So each
# step's loss is held, as phase 9 holds its bf16 gradients, to the larger
# of phase 9's bf16 loss limit (TRAIN_BF16_LOSS_RTOL) and GRID_LOSS_SPREAD
# x the single device's own spread of its losses under the data axis's
# order of sums, measured in the same run: the single device with the
# batch split in two (--accum 2: two half-batch bf16 gradients summed in
# fp32).  The first step's gradient norm, taken on the same weights and
# batch, is held to the same of that reading's spread: a grid that sums
# its gradients wrongly shows there at once, where its losses may stay
# close for a few steps (--grid-faults).  The model axis (37-40) moves
# the forward's bf16 roundings too, which --accum 2 does not, so there
# that spread also takes the single device's bf16-vs-fp32 one, and the
# model axis is held in fp32 besides (GSPMD_FP32).
GRID_LOSS_SPREAD = 3.5
# granite-8b at full depth is ~113 GB of bf16 parameters and fp32 AdamW
# state, and four ranks share one 80 GB card, so phase 34 cuts its depth.
# Phase 40's single-device reference is phase 26's run (same seed, batches
# and, in the first 5 warmup steps, learning rates); 36's and 38's, at their
# cut, are made in the phase.  granite-8b trains at peak lr 1e-5, as
# --transports' granite run: at 3e-4 its random-init loss rises (11.29,
# 17.36, 12.88 on the single device as on the grid).  Every collective of
# these phases goes through host memory (~100-400 MB/s a rank on one card's
# host, and 15-30% slower on some hosts than on others), so a qwen step
# takes ~5-9 s and a 2 x 2 step of phases 37-40 5-25 s.  To keep the script
# inside its limit phases 33-40 take 2 steps each, and the pipeline's qwen
# plans (16-18) 2: at 3 steps (4 for the qwen plans) the script reached
# phase 39 at 1204 s on a host that ran phases 1-32 in 832 s.
GSPMD_ARGS = ["--p2p", "host", "--backend", "auto", "--device", "cuda", "--log-every", "1"]
GSPMD_DENSE = ("qwen1p5_0p5b", 24, ["--model-parallel", "2", "--data-parallel", "2"],
               ["--batch", "8", "--seq", "512", "--steps", "2"])
GSPMD_GQA = ("granite_8b", 2, 36, ["--model-parallel", "2", "--data-parallel", "2"],
             ["--batch", "4", "--seq", "512", "--steps", "2", "--lr", "1e-5"])
GSPMD_ZERO1 = ("qwen1p5_0p5b", 2, 2, 8, 512, 2)      # arch, model, data, b, seq, steps
GSPMD_SSM = ("mamba2_780m", 8, 48, ["--model-parallel", "1", "--data-parallel", "2"],
             ["--batch", "4", "--seq", "2048", "--steps", "2"])
# Phases 37-40: the model axis of the moe, ssm, hybrid and audio families
# (each model member's share of a block: experts, mamba2 heads, attention
# heads), data 2 x model 2 on four ranks sharing the card, held by phase
# 33's checks.  (phase, arch, layers, the config's depth, args, the single
# device's run it is held to (an earlier phase's first steps; None: one
# made in the phase at the same cut), each kernel's launches a rank a
# step, what a member's kernel call sees).  qwen3-moe takes phase 22's cut
# of 2 layers at phase 21's batch: the limit's yardstick, the single
# device with --accum 2, adds an fp32 gradient accumulator to the state,
# and at phase 21's 4 layers (3.1 B parameters) that ran out of the card's
# 80 GB.  zamba2 trains at peak lr 1e-4: at 3e-4 its random-init loss rose
# at step 3 (10.89, 9.88, 14.70) on the single device as on the grid.
# Since phase 42 needed room under the time limit, 36 and 38 run mamba2
# cut to 16 of 48 layers and 39 zamba2 to one group of 6 (were 48, 48 and
# 2 groups of 6: 47, 52 and 67 s of a run on an H100 at 700 W that
# reached 1061.7 s with 42; 27, 23 and 31 s at the cut).
# Each is held to single device runs at its cut made in the phase.  Since
# phase 44 needed room as well, 34 runs granite-8b at 2 of 36 layers (was
# 4), 36 mamba2 at 8 of 48 (was 16), and 42 (b) granite-8b at 2 and (d)
# qwen3-moe at 1 (were 4 and 2): what a deeper cut adds is more of the same
# layers, their bytes and their launches.  38 stays at 16: at 8 layers its
# bf16 first gradient norm read 3.09e-2 from the single device's against a
# limit of 4.25e-3 (the single device's own bf16 spread there, 1.21e-3, is
# smaller than at 16), on an H100 at 700 W.
GSPMD_FAMILY_GRID = ["--model-parallel", "2", "--data-parallel", "2"]
GSPMD_FAMILIES = [
    ("37", MOE_ARCH, MOE_CUT_LAYERS, 48, ["--batch", "2", "--seq", "2048", "--steps", "2"],
     None, {"flash_attention": 2 * MOE_CUT_LAYERS},
     "64 of 128 experts; flash_attention B1 S2048 H16 KV2 hd128"),
    ("38", "mamba2_780m", 16, 48, ["--batch", "4", "--seq", "2048", "--steps", "2"],
     None, {"ssd_scan": 2 * 16}, "ssd_scan b2 S2048 h24 p64 n128"),
    ("39", "zamba2_2p7b", 6, 54,
     ["--batch", "4", "--seq", "2048", "--steps", "2", "--lr", "1e-4"], None,
     {"ssd_scan": 2 * 6, "flash_attention": 2 * 1},
     "ssd_scan b2 S2048 h40 p64 n64; flash_attention B2 S2048 H16 KV16 hd80"),
    ("40", WHISPER_ARCH, WHISPER_LAYERS, WHISPER_LAYERS,
     ["--batch", "16", "--seq", str(WHISPER_SEQ), "--steps", "2"], "train_whisper_base",
     {"flash_attention": 2 * 3 * WHISPER_LAYERS},
     "flash_attention H4 KV4 hd64: encoder B8 S1500, self B8 S448, cross B8 448 x 1500"),
]
# The model axis in fp32 (phases 38-40): the config fields that cut it
# (depth; zamba2 to 2 groups of 1 ssm layer and the shared block) and the
# args, the grid held to the fp32 single device at tests/test_torch_gspmd.py's
# limits on the first loss, first gradient norm and second loss (relative).
# qwen3-moe has none: at one layer its fp32 state is 3.7 GB of gathers a
# step through host memory (~30 s of the script's limit).
GSPMD_FP32 = {
    "38": ({"num_layers": 2}, ["--batch", "4", "--seq", "512", "--steps", "2"]),
    "39": ({"num_layers": 2, "hybrid_attn_every": 1},
           ["--batch", "4", "--seq", "512", "--steps", "2", "--lr", "1e-4"]),
    "40": ({}, ["--batch", "4", "--seq", str(WHISPER_SEQ), "--steps", "2"]),
}
FP32_LIMITS = (1e-5, 1e-4, 1e-4)
_SINGLE = {}                  # single-device results by run name or by single_run's key
# --grid-faults: each fault planted in the grid's ranks (``planted``) and
# the phases whose grid runs with it
GRID_FAULTS = {
    "data-sum": ("the data axis's gradient sum dropped: each rank keeps its "
                 "own slice of its own gradient", ("33", "36")),
    "rows": ("every data rank trains on data rank 0's rows", ("33", "36")),
    "megatron": ("the Megatron blocks' model all-reduce dropped: each "
                 "member's partial output alone", ("33",)),
    "experts": ("the expert combine's model all-reduce dropped: each member's "
                "experts' part of the moe output alone", ("37",)),
    "ssm-norm": ("the gated norm's model sum of squares dropped: each member "
                 "normalises by its own heads' channels", ("38",)),
    "combine": ("the serve decode's combine of the members' partial softmaxes skipped: "
                "each member keeps its own block's", ("42 (a)",)),
    "slot0": ("the serve decode's slot offset dropped to 0: each member masks its block "
              "as the cache's first slots", ("42 (a)",)),
    "ssm-out": ("the hybrid ssm cache never moved back to the rule's placement after a "
                "group: the cache keeps its zeros", ("42 (e)",)),
    "cross-lse": ("the whisper members' cross-attention partials summed without their "
                  "log-sum-exp weights", ("42 (f)",)),
    "whole-sum": ("a whole part's gradient summed over the members instead of sliced to "
                  "each member's block", ("44 (b)",)),
}

# Phase 41: the dry-run (repro_torch.launch.dryrun: the port's train step
# on the meta device as one rank of a grid of counting stand-ins) against
# the card.  (a) every grid phase of 33-40, estimated on the host's CPU at
# the phase's arch, cut, mesh, batch, sequence, dp mode and dtype, in a
# process of its own started after phase 2 (``Estimator``), held exactly
# to what the phase measured (each rank's persistent bytes, rank 0's bytes
# and calls a step by axis and kind, ZeRO-1's optimizer bytes), its peak
# to PEAK_BAND of each rank's max_memory_allocated (stated before the
# first run on the card).  (b) remat_policy "dots" on the single device
# at phase 11's run (qwen1.5-0.5b, b2 x S1024, through flash_attention):
# the losses phase 11's ("full") within DOTS_LOSS_RTOL, and more memory.
PEAK_BAND = (0.8, 1.25)
DOTS_LOSS_RTOL = 1e-6
# Phase 42: the grid's serve steps (sharding/spmd.py: make_prefill_step,
# make_decode_step; the JAX dry-run's jitted serve steps under the copied
# rules) on four ranks sharing the card (data 2 x model 2, --p2p host), in
# one call, each case at full width from the single device's seeded weights
# and prompts: (label, arch, layers, the config's depth, dtype, launches a
# rank a prefill, a rank a decode step, what a member holds; a hybrid model
# cut to one group of its layers, an audio model's encoder to as many).
# Batch 4 x prompt 512 (a vlm model behind its 256 image tokens; whisper
# 440, its positions ending at 448), a cache of prompt + 8 slots, GRID_SERVE_STEPS of the 8 decode steps run (fp32:
# GRID_SERVE_FP32_STEPS), each fed the single device's token.  The weights
# are gathered through host memory on every step (FSDP over data, as the
# rules place them), so a step moves 0.2-1.6 GiB a rank and takes 1-8 s
# (0.2-0.25 GB/s on an H100 host); at 4 decode steps (and 2 in fp32) the
# phase took 124 s there, so the bf16 cases run 2 and fp32 1.  Held: each
# rank's cache bytes to the closed form exactly, the logits of its rows to
# the single device's at the same cut in the phase (bf16: phase 5's rel-L2
# limit; fp32 at 1 layer: GRID_SERVE_FP32_RTOL, no rounding allowance), each
# kernel's launches a rank a call.  In bf16 a member rounds its part of each
# row-parallel product before the members' sum, which the single device does
# not: on an H100, mamba2 (c) read 3.0e-2 to 5.9e-2 rel L2 over its 8 layers
# and qwen3-moe (d) 5.8e-2 and 6.9e-2 at two decode steps, a routing flip
# (max abs 0.43).  So, as phases 14 and 22 hold those families' kernel paths:
# an ssm or hybrid case's bf16 limit is the larger of phase 5's and E2E_SPREAD x the
# single device's own spread at SSD chunk / 2 and / 4 (the same sums in
# another order) and in fp32 (bf16's reach, as phases 37-40 take it), and a
# moe case is held with the single device's routing replayed on the ranks
# (each rank its rows of it).
GRID_SERVE = [
    ("(a)", PALIGEMMA_ARCH, 2, PALIGEMMA_LAYERS, "bfloat16", {"flash_attention": 2},
     {"flash_decode": 2}, "the cache sharded over its sequence: 388 of 776 slots of the one "
     "kv head, 4 of 8 heads (every head over the member's slots, the partials combined)"),
    ("(b)", "granite_8b", 2, 36, "bfloat16", {"flash_attention": 2}, {"flash_decode": 2},
     "the cache sharded over its kv heads: 4 of 8, 16 of 32 heads"),
    ("(c)", "mamba2_780m", 8, 48, "bfloat16", {"ssd_scan": 8}, {},
     "24 of 48 heads' state, the conv cache whole"),
    ("(d)", MOE_ARCH, 1, 48, "bfloat16", {"flash_attention": 1}, {"flash_decode": 1},
     "64 of 128 experts; the cache's kv heads 2 of 4, 16 of 32 heads"),
    ("(e)", "zamba2_2p7b", 6, 54, "bfloat16", {"ssd_scan": 6, "flash_attention": 1},
     {"flash_decode": 1}, "one group of 6 ssm layers: the rule's ssm cache, its per over "
     "data and its batch over model, moved to the member's rows, 40 of 80 heads' state and "
     "every conv channel for the group and back; the shared block's cache 16 of 32 kv heads"),
    ("(f)", WHISPER_ARCH, 6, 6, "bfloat16", {"flash_attention": 18}, {"flash_decode": 12},
     "the cross cache over its encoder sequence: 750 of 1500 slots, all 8 kv heads (every "
     "head over the member's slots through flash_decode, the partials combined); the self "
     "cache 4 of 8 kv heads"),
    ("(a) fp32", PALIGEMMA_ARCH, 1, PALIGEMMA_LAYERS, "float32", {"flash_attention": 1},
     {"flash_decode": 1}, "as (a)"),
    ("(c) fp32", "mamba2_780m", 1, 48, "float32", {"ssd_scan": 1}, {}, "as (c)"),
    ("(e) fp32", "zamba2_2p7b", 2, 54, "float32", {"ssd_scan": 2, "flash_attention": 1},
     {"flash_decode": 1}, "as (e), one group of 2 (per 2 over data)"),
    ("(f) fp32", WHISPER_ARCH, 1, 6, "float32", {"flash_attention": 3}, {"flash_decode": 2},
     "as (f), 1 encoder and 1 decoder layer"),
]
GRID_SERVE_BATCH, GRID_SERVE_PROMPT, GRID_SERVE_GEN = 4, 512, 8
GRID_SERVE_STEPS, GRID_SERVE_FP32_STEPS = 2, 1
GRID_SERVE_FP32_RTOL = 1e-4
# Phase 44: the grid at a model axis that does not divide a block's count
# (sharding/spmd.py: whole_parts; each such part computed whole on every
# member, the others sharded).  (a) starcoder2-7b (36 heads over 4 kv
# heads, GQA 9, window 4096, qkv biases, LayerNorm, GELU; 32 layers, vocab
# 49152 untied) served on the single device at full width and depth, b4 x
# 512 + 32 tokens, held to its einsum path at phase 5's limits.  (b)
# starcoder2-7b at full width cut to 1 of 32 layers and (c) whisper-base
# at full width and depth (6 + 6) on data 1 x model 3, three ranks sharing
# the card (--p2p host): a prefill and GRID_SERVE_STEPS decode steps (fp32:
# GRID_SERVE_FP32_STEPS) as phase 42 runs them, and one train step from the
# seeded state on a SyntheticTokens batch, each held to the single device
# at the same cut: logits at phase 42's limits, the train step's loss and
# first gradient norm at phases 33-40's (bf16: grid_limit of the single
# device's spread at --accum 2; fp32: FP32_LIMITS' first two).  At 3,
# starcoder2's kv heads (4) do not split, so its attention is whole while
# its MLP (d_ff 18432) is sharded; its cache holds 512 + 10 = 522 = 3 x 174
# slots, so the rule shards it over its sequence.  whisper-base's heads
# (8) and d_ff (2048) do not split: every part is whole, its cross cache
# over its 1500 = 3 x 500 encoder frames, its self cache (448 slots) whole.
STARCODER_ARCH = "starcoder2_7b"
STARCODER_LAYERS = 32
STARCODER_SERVE_ARGS = ["--arch", STARCODER_ARCH, "--batch", "4", "--prompt-len", "512",
                        "--gen", "32", "--backend", "auto", "--device", "cuda"]
UNDIVIDED_MODEL = 3
SERVE_GEN = {STARCODER_ARCH: 10}
UNDIVIDED_SERVE = [
    ("(b)", STARCODER_ARCH, 1, STARCODER_LAYERS, "bfloat16", {"flash_attention": 1},
     {"flash_decode": 1}, "the attention whole (num_kv_heads=4): all 36 heads over 174 of 522 "
     "slots of the 4 kv heads, the partials combined, wo whole; the MLP 6144 of 18432"),
    ("(c)", WHISPER_ARCH, 6, 6, "bfloat16", {"flash_attention": 18}, {"flash_decode": 12},
     "every part whole (num_heads=8, d_ff=2048): the cross cache over its encoder sequence, "
     "500 of 1500 slots of all 8 kv heads; the self cache (448 slots) whole"),
    ("(b) fp32", STARCODER_ARCH, 1, STARCODER_LAYERS, "float32", {"flash_attention": 1},
     {"flash_decode": 1}, "as (b)"),
    ("(c) fp32", WHISPER_ARCH, 1, 6, "float32", {"flash_attention": 3}, {"flash_decode": 2},
     "as (c), 1 encoder and 1 decoder layer"),
]
# (label, arch, layers, dtype, batch, seq): the train step of each case
UNDIVIDED_TRAIN = [("(b)", STARCODER_ARCH, 1, "bfloat16", 4, 512),
                   ("(c)", WHISPER_ARCH, 6, "bfloat16", 4, WHISPER_SEQ),
                   ("(b) fp32", STARCODER_ARCH, 1, "float32", 4, 512),
                   ("(c) fp32", WHISPER_ARCH, 1, "float32", 4, WHISPER_SEQ)]
UNDIVIDED_OPT = dict(lr=1e-4, warmup_steps=0, total_steps=10)
# the parts each case computes whole, as whole_parts names them
UNDIVIDED_WHOLE = {STARCODER_ARCH: {"attention": "num_kv_heads=4"},
                   WHISPER_ARCH: {"attention": "num_heads=8", "mlp": "d_ff=2048"}}
# Phase 43: the examples (``repro_torch.examples``) and the card rules.
EXAMPLE_ARCHS = ("granite_8b", "mamba2_780m")        # (a) quickstart
SERVE_BATCH_ARCHS = (None, "granite_8b")             # (b): its default arch, then granite
E2E_ARGV = ["--full-100m", "--steps", "120"]        # (c): its own b8 x 256 batches
EXAMPLE_AGREE_STEPS = 4                              # the first tokens held, as phase 5
FA_E2E = ("train_e2e fp32: B8 S256 H12 KV4 hd64", 8, 256, 256, 12, 4, 64, True, 0, 0, 0)
CARD_MEMBERS = (1, 2, 4)
CARD_SEQ = 64                                        # (d)'s small launches
CARD_SSD_SEQ = 128
# (d): shapes the card rules refuse, at a tiny B and S: (label, the smoke
# config whose fields are replaced, the replacement, the sequence the lint
# is given, the lint's code)
CARD_PLANTED = [
    ("hd 96", "granite_8b", dict(head_dim=96), None, "H2E511"),
    ("hd 32", "granite_8b", dict(head_dim=32), None, "H2E511"),
    ("decode G 16 x hd 256 = 4096", "granite_8b",
     dict(num_heads=16, num_kv_heads=1, head_dim=256), None, "H2E512"),
    ("ssd_scan p 128, n 256, chunk 512", "mamba2_780m",
     dict(ssm_headdim=128, ssm_state=256, ssm_chunk=512), 512, "H2E513"),
    ("bf16 ssd_scan p 60", "mamba2_780m", dict(ssm_headdim=60), 64, "H2E514"),
]

_SERVE_RUNS = {}              # phase 42's ranks' results by case, for 41 (e)
_GRID_RUNS = {}               # what each grid phase measured, by phase
_UNDIVIDED_TRAINS = {}        # phase 44's ranks' train steps by case, for 41 (f)
_PEAKS = {}                   # train_and_check's peak memory, by run
_ESTIMATOR = None             # phase 41's estimates, made beside phases 3-40

T0 = time.perf_counter()


def log(msg=""):
    """Print a line; a phase's heading (``== ``) with the seconds since the
    script started."""
    if msg.startswith("== "):
        msg += f"  [{time.perf_counter() - T0:.1f} s]"
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(nvcc_output):
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its
    (mangled) name, registers, spills and static shared memory."""
    lines, name, spills = [], None, ""
    for line in nvcc_output.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name, spills = None, ""
        elif "error" in line or "warning" in line:
            lines.append(line.strip())
    return lines


def compare(got, want, dtype_name, what, tol=None):
    atol, rtol = tol or TOL[dtype_name]
    g, w = got.float(), want.float()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} elements off; "
            f"max abs err {float(err.max()):.3e} (atol {atol}, rtol {rtol})")
    return float(err.max())


def time_ms(fn, iters, warmup=3):
    """Mean ms per call over ``iters`` calls, timed with CUDA events;
    ``fn(i)`` gets the call index (to rotate inputs)."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters, warmup=2):
    """Device time per call (ms) of every kernel that ``iters`` calls of
    ``fn(i)`` launch, by kernel name, from ``torch.profiler``'s CUDA
    activity.  Unlike ``time_ms`` it leaves out the host's time between
    launches.  Empty where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / iters
    return out


def summed(times, part=""):
    """Sum of ``device_ms`` entries whose name contains ``part``; None
    (not measured) when the profiler gave no device time."""
    return sum(v for k, v in times.items() if part in k) if times else None


def kernel_name(signature):
    """A kernel's function name from the profiler's demangled signature."""
    m = re.search(r"(\w+)(?:<[^(]*>)?\(", signature)
    return m.group(1) if m else signature[:40]


def kernel_dtypes():
    """The kernels' input types, by name: each check runs in all three."""
    import torch
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}


def fa_kw(case):
    """The mask arguments of an FA case, as ``flash_attention`` takes them."""
    *_, causal, window, q_offset, prefix = case
    return dict(causal=causal, window=window, q_offset=q_offset, prefix_len=prefix)


def fa_inputs(case, dtype, gen):
    import torch
    _, B, Sq, Sk, H, KV, hd, *_ = case
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return mk(B, Sq, H, hd), mk(B, Sk, KV, hd), mk(B, Sk, KV, hd)


def fd_block(case):
    """(slot0, the whole cache's length) of an FD case: a member's block
    (``FD_MEMBERS``) or the whole cache."""
    return tuple(case[11:13]) if len(case) > 11 else (0, case[4])


def fd_inputs(case, dtype, gen, n_caches=1):
    import torch
    _, B, KV, G, S, hd, *_, q_scale = case[:11]
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
    q = (mk(B, KV * G, hd) * q_scale).to(dtype)
    caches = [(mk(B, KV, S, hd).to(dtype), mk(B, KV, S, hd).to(dtype))
              for _ in range(n_caches)]
    return q, caches


def phase_kernels():
    """The attention kernels against their plain versions in fp32, bf16
    and fp16 at every case; their rows of times in bf16 (the kernels
    line) and in fp16 at the serving shape.  Returns (bf16 rows, fp16
    rows) by kernel."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = kernel_dtypes()
    err16 = {"flash_attention": 0.0, "flash_decode": 0.0}
    fa_err = fd_err = 0.0
    for case in (FA_CASES + [FA_SERVE] + FA_ZAMBA2 + FA_QWEN3_MOE + FA_WHISPER
                 + [FA_PALIGEMMA, FA_STARCODER2] + FA_MEMBERS):
        label, kw = case[0], fa_kw(case)
        for dname, dt in dtypes.items():
            q, k, v = fa_inputs(case, dt, gen)
            got = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, **kw)
            e = compare(got, want, dname, f"flash_attention [{label}, {dname}]")
            log(f"  flash_attention {label:32s} {dname:9s} max_abs_err={e:.3e}")
            fa_err = max(fa_err, e) if dname == "bfloat16" else fa_err
            if dname == "float16":
                err16["flash_attention"] = max(err16["flash_attention"], e)
    for case in FD_CASES + [FD_SERVE, FD_ZAMBA2, FD_QWEN3_MOE, FD_WHISPER, FD_PALIGEMMA,
                            FD_PALIGEMMA_RING, FD_STARCODER2]:
        label, *_, pos, window, softcap, ring, _ = case
        for dname, dt in dtypes.items():
            q, [(k, v)] = fd_inputs(case, dt, gen)
            got = ops.flash_decode(q, k, v, pos, window=window,
                                   softcap=softcap, ring=ring)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, pos, window=window,
                                            softcap=softcap, ring=ring)
            e = compare(got, want, dname, f"flash_decode [{label}, {dname}]")
            log(f"  flash_decode    {label:32s} {dname:9s} max_abs_err={e:.3e}")
            fd_err = max(fd_err, e) if dname == "bfloat16" else fd_err
            if dname == "float16":
                err16["flash_decode"] = max(err16["flash_decode"], e)
    fd_err = max(fd_err, fd_member_checks(gen))

    # ---- times at the serving shapes (the profile's, zamba2's, qwen3-moe's,
    # whisper's, paligemma's), bf16 ----
    rows = {}
    fa_rows = {}
    for case in (FA_SERVE, FA_PROFILE, *FA_ZAMBA2, *FA_QWEN3_MOE, *FA_WHISPER,
                 FA_PALIGEMMA, FA_STARCODER2, *FA_MEMBERS):
        fa_rows[case[0]], err = fa_timed(case, gen)
        fa_err = max(fa_err, err)
        torch.cuda.empty_cache()
    rows["flash_attention"] = dict(fa_rows[FA_SERVE[0]], max_abs_err=fa_err)

    fd_rows = {case[0]: fd_timed(case, gen, fd_err)
               for case in (FD_SERVE, FD_ZAMBA2, FD_QWEN3_MOE, FD_WHISPER, FD_PALIGEMMA,
                            FD_STARCODER2, *FD_MEMBER_ROWS)}
    rows["flash_decode"] = fd_rows[FD_SERVE[0]]
    # the serving shapes in fp16
    row16, err = fa_timed(FA_SERVE, gen, torch.float16)
    rows16 = {"flash_attention": dict(row16, max_abs_err=max(err, err16["flash_attention"])),
              "flash_decode": fd_timed(FD_SERVE, gen, err16["flash_decode"], torch.float16)}
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    shown = list(fa_rows.items()) + list(fd_rows.items()) + [
        (f"{FA_SERVE[0]}, fp16", rows16["flash_attention"]),
        (f"{FD_SERVE[0]}, fp16", rows16["flash_decode"])]
    for label, r in shown:
        log(f"  {r['name']} per call [{label}], CUDA events: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        log(f"  {r['name']} per call [{label}], device time (profiler): kernel "
            f"{fmt(r['device_ms'])}, whole wrapper {fmt(r['wrapper_device_ms'])}, "
            f"plain {fmt(r['plain_device_ms'])}, library {fmt(r['library_device_ms'])}")
    return rows, rows16


def fa_timed(case, gen, dtype=None):
    """``flash_attention``'s row of times at ``case`` (bf16 unless
    ``dtype`` says otherwise; the bound is the same for fp16, fp32's reads
    twice the bytes at the CUDA cores' peak), beside its
    plain version, ``scaled_dot_product_attention`` and the bound, and its
    error against the plain version.  The bound is the package's closed
    form (``kernels/cost.py``, which the dry-run counts with too): the
    (query, key) pairs the mask keeps, a prefix included.
    A prefix goes to the library call as a boolean mask.  A single-query call (whisper's decode cross-attention) takes
    its K/V from a rotation of sets, at least 64 MB of them, so every
    call reads them from device memory as each decoder layer does."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost, ops, ref

    label, B, Sq, Sk, H, KV, hd, causal, window, q_offset, prefix = case
    # a causal window that reaches every key masks what the causal mask does
    if (window and not (causal and window >= Sk)) or (causal and q_offset) \
            or (prefix and Sq != Sk):
        raise ValueError(f"fa_timed: no library mask for the mask of {label}")
    kw = fa_kw(case)
    dtype = dtype or torch.bfloat16
    dname = str(dtype).split(".")[-1]
    q, k, v = fa_inputs(case, dtype, gen)
    # SDPA's own causal flag, or the prefix-LM mask (True: attend)
    lib_kw = dict(is_causal=causal)
    if causal and prefix:
        pos = torch.arange(Sq, device="cuda")
        lib_kw = dict(attn_mask=(pos[None, :] <= pos[:, None]) | (pos[None, :] < prefix))
    kv_bytes = 2 * (k.numel() + v.numel())
    n = max(1, math.ceil(64e6 / kv_bytes)) if Sq == 1 else 1
    sets = [(k, v)] + [fa_inputs(case, dtype, gen)[1:] for _ in range(n - 1)]
    want = ref.flash_attention_ref(q, k, v, **kw)
    err = compare(ops.flash_attention(q, k, v, **kw), want, dname,
                  f"flash_attention [{label}, {dname}]")
    log(f"  flash_attention {label:32s} {dname:9s} max_abs_err={err:.3e}")
    qt = q.transpose(1, 2)
    sets_t = [(kk.transpose(1, 2), vv.transpose(1, 2)) for kk, vv in sets]
    lib = F.scaled_dot_product_attention(qt, *sets_t[0], **lib_kw,
                                         enable_gqa=True).transpose(1, 2)
    lib_err = compare(lib, want, dname,
                      "scaled_dot_product_attention yardstick", tol=LIB_TOL)
    log(f"  scaled_dot_product_attention vs plain [{label}, {dname}]: "
        f"max_abs_err={lib_err:.3e}")
    del lib, want
    b_ms, b_by = cost.bound(*cost.flash_attention_cost(q.shape, k.shape, q.element_size(),
                                                       **kw), dname)
    if n > 1:
        log(f"  flash_attention [{label}]: K/V taken in turn from {n} sets "
            f"({n * kv_bytes / 1e6:.1f} MB)")
    row = dict(
        name="flash_attention", route="cuda", source=FA_SOURCE,
        replaces=FA_REPLACES, bound_ms=b_ms, bound_by=b_by,
        **timed(lambda i: ops.flash_attention(q, *sets[i % n], **kw),
                lambda i: ref.flash_attention_ref(q, *sets[i % n], **kw),
                lambda i: F.scaled_dot_product_attention(
                    qt, *sets_t[i % n], **lib_kw, enable_gqa=True),
                "attn_fwd", iters=200 if Sq == 1 else 20))
    return row, err


def fd_member_checks(gen):
    """``flash_decode`` on a member's block of a longer cache
    (``FD_MEMBERS``: ``slot0``, the whole cache's length, the log-sum-exp)
    against its plain version in bf16 and fp32, the output at ``TOL`` and
    the log-sum-exp at ``LSE_TOL`` (-inf, with an output of 0, where the
    block holds no live slot); and (a)'s two members' partials combined
    against the plain version over the whole cache.  Returns the worst
    bf16 error."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.sharding import spmd

    worst = 0.0
    for case in FD_MEMBERS:
        label, *_, pos, window, softcap, ring, _ = case[:11]
        slot0, total = fd_block(case)
        kw = dict(window=window, softcap=softcap, ring=ring, slot0=slot0, cache_len=total,
                  return_lse=True)
        for dname in ("float32", "bfloat16"):
            q, [(k, v)] = fd_inputs(case, kernel_dtypes()[dname], gen)
            got, lse = ops.flash_decode(q, k, v, pos, **kw)
            torch.cuda.synchronize()
            want, want_lse = ref.decode_attention_ref(q, k, v, pos, **kw)
            e = compare(got, want, dname, f"flash_decode [{label}, {dname}]")
            dead = torch.isinf(want_lse)
            if not torch.equal(torch.isinf(lse), dead) or bool((got[dead] != 0).any()):
                raise AssertionError(f"flash_decode [{label}, {dname}]: a head with no live "
                                     "slot is not out 0, lse -inf")
            le = compare(lse[~dead], want_lse[~dead], "float32",
                         f"flash_decode lse [{label}, {dname}]", tol=LSE_TOL) \
                if bool((~dead).any()) else 0.0
            log(f"  flash_decode    {label:32s} {dname:9s} max_abs_err={e:.3e}, lse "
                f"{le:.3e}" + (" (no live slot: out 0, lse -inf)" if bool(dead.all()) else ""))
            worst = max(worst, e) if dname == "bfloat16" else worst
    # (a)'s whole cache of 776 slots as its two members' blocks, combined
    _, B, KV, G, _, hd, pos, *_ = FD_MEMBERS[0]
    total = FD_MEMBERS[0][12]
    for dname in ("float32", "bfloat16"):
        q, [(k, v)] = fd_inputs(FD_MEMBERS[0][:4] + (total,) + FD_MEMBERS[0][5:11],
                                kernel_dtypes()[dname], gen)
        n = total // 2
        parts = [ops.flash_decode(q, k[:, :, i * n:(i + 1) * n].contiguous(),
                                  v[:, :, i * n:(i + 1) * n].contiguous(), pos, slot0=i * n,
                                  cache_len=total, return_lse=True) for i in range(2)]
        every = torch.cat([torch.cat([o.float(), l[..., None]], -1)[None] for o, l in parts])
        got = spmd.combine_partials(parts[0][0], parts[0][1], _Members(every))
        e = compare(got, ref.decode_attention_ref(q, k, v, pos), dname,
                    f"flash_decode [two members combined, {dname}]")
        log(f"  flash_decode    {'two members of 388, combined':32s} {dname:9s} "
            f"max_abs_err={e:.3e}")
        worst = max(worst, e) if dname == "bfloat16" else worst
    return worst


class _Members:
    """The model group's all-gather of ``combine_partials``, handed the
    members' partials already stacked."""

    def __init__(self, every):
        self.every, self.world_size = every, every.shape[0]

    def all_gather_(self, out, part, dim):
        return out.copy_(self.every)


def fd_timed(case, gen, err, dtype=None):
    """``flash_decode``'s row of times at ``case`` (bf16 unless ``dtype``
    says otherwise), beside its plain version,
    ``scaled_dot_product_attention`` and the bound.  A member's block
    (``FD_MEMBERS``) runs with its slot offset and returns its
    log-sum-exp, as on the grid's serve path; its bound counts the
    block's live slots."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost, ops, ref

    _, B, KV, G, S, hd, pos, window, softcap, ring, _ = case[:11]
    slot0, total = fd_block(case)
    member = len(case) > 11
    kw = dict(slot0=slot0, cache_len=total, return_lse=True) if member else {}
    # caches taken in turn, at least eight and at least 64 MB of them (71
    # MB at the granite shape, 178 MB at zamba2's, 67 MB in 15 at
    # qwen3-moe's: more than the 50 MB L2), so every call reads its cache
    # from device memory, as each layer's decode does
    per_cache = 2 * B * KV * S * hd * 2
    q, caches = fd_inputs(case, dtype or torch.bfloat16, gen,
                          n_caches=max(8, math.ceil(64e6 / per_cache)))
    valid = ref.decode_valid(pos, total, device="cuda", slot0=slot0, n=S)
    live = int(valid.sum())
    # the library call needs the mask as a bias; the kernel computes it
    zero = torch.zeros((), device="cuda")
    bias = torch.where(valid, zero, torch.full_like(zero, ops.NEG_INF)).view(1, 1, 1, S)
    q4 = q.view(B, KV * G, 1, hd)
    b_ms, b_by = cost.bound(*cost.flash_decode_cost(B, KV, G, hd, live, 2))
    n = len(caches)
    log(f"  flash_decode [{case[0]}] splits the {S}-slot "
        + (f"block (slots {slot0}-{slot0 + S - 1} of {total}) " if member else "cache ")
        + f"{ops.decode_splits(B * KV, S)} ways: "
        f"{B * KV * ops.decode_splits(B * KV, S)} blocks in pass 1")
    return dict(
        name="flash_decode", route="cuda", source=FD_SOURCE,
        replaces=FD_REPLACES, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timed(lambda i: ops.flash_decode(q, *caches[i % n], pos, **kw),
                lambda i: ref.decode_attention_ref(q, *caches[i % n], pos, **kw),
                lambda i: F.scaled_dot_product_attention(
                    q4, *caches[i % n], attn_mask=bias, enable_gqa=True),
                "decode_", iters=200))


def timed(kernel, plain, library, tag, iters):
    """Per-call times of a kernel's wrapper, its plain version and the
    library yardstick: CUDA events around back-to-back calls (what a
    caller waits for, host gaps included) and profiler device time (the
    kernel named ``tag`` alone, and everything each call launched)."""
    dev = device_ms(kernel, iters)
    return dict(
        ms=time_ms(kernel, iters), plain_ms=time_ms(plain, max(5, iters // 4)),
        library_ms=time_ms(library, iters),
        device_ms=summed(dev, tag), wrapper_device_ms=summed(dev),
        plain_device_ms=summed(device_ms(plain, 5)),
        library_device_ms=summed(device_ms(library, iters)))


def serve_and_check(args, run, layers, want):
    """One ``repro_torch.launch.serve`` run: the model must have
    ``layers`` layers, each kernel launch ``want(decode_calls)[name]``
    times, the logits be finite and the tokens in the vocabulary.
    Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    run_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    ops.reset_launches()
    res = serve.main(args + ["--run-dir", run_dir])
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    L, calls = res["num_layers"], res["decode_calls"]
    if L != layers:
        raise AssertionError(f"{res['arch']} ran {L} layers, expected {layers}")
    for name, n in want(calls).items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times over 1 "
                                 f"prefill + {calls} decode calls, expected {n}")
    for key in ("prefill_logits", "last_logits"):
        if not bool(res[key].float().isfinite().all()):
            raise AssertionError(f"{key} are not finite")
    toks = res["tokens"]
    flag = lambda name: int(args[args.index(name) + 1])
    if toks.shape != (flag("--batch"), flag("--gen")) or int(toks.min()) < 0 \
            or int(toks.max()) >= res["vocab_size"]:
        raise AssertionError(f"tokens of shape {tuple(toks.shape)} "
                             f"outside [0, {res['vocab_size']})")
    log(f"  launches: {launches} over 1 prefill + {calls} decode calls")
    log(f"  prefill {res['prefill_s'] * 1e3:.2f} ms, decode p50 "
        f"{res['decode_p50_s'] * 1e3:.3f} ms p95 {res['decode_p95_s'] * 1e3:.3f} ms, "
        f"{res['decode_tok_per_s']:.1f} tok/s, peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
    del res
    torch.cuda.empty_cache()
    return launches


def phase_main_path():
    """granite-8b: every attention call of the prefill and of each decode
    call launches a kernel."""
    L = 36
    return serve_and_check(SERVE_ARGS, "serve_granite_8b", L, lambda calls: {
        "flash_attention": L, "flash_decode": L * calls})


def serve_logits(params, cfg, batch, backend, steps, feed=None):
    """Prefill and ``steps`` decode steps: the logits of each (the
    prefill's last position first) and the tokens fed, ``feed`` or else
    the run's own greedy tokens."""
    import torch
    from repro_torch.models import model as M

    cache, lg, plen = M.prefill(params, cfg, batch,
                                cfg.num_prefix_tokens + batch["tokens"].shape[1] + steps,
                                backend=backend)
    out, fed = [lg.float()], []
    for i in range(steps):
        tok = feed[i] if feed else torch.argmax(out[-1], -1).to(torch.int32)[:, None]
        lg, _ = M.decode_step(params, cfg, tok, cache, plen + i, backend=backend)
        out.append(lg.float())
        fed.append(tok)
    return out, fed


def phase_end_to_end(arch="granite_8b", layers=4, dtype="bfloat16", B=4, S=512):
    """``arch`` at full width cut to ``layers`` layers: prefill and 4
    decode steps through the kernels against the einsum paths, both fed
    the einsum path's greedy tokens, batch ``B`` x prompt ``S`` (an audio
    model's frames from the same stream).  For a model with ssm layers
    each limit is the larger of phase 5's and E2E_SPREAD x the einsum
    path's own distance from itself at other chunks, for an audio model
    from itself with its prefill attention's keys reversed (the same sums
    in another order; a vlm model likewise, its image prefix from the same
    stream), measured on the same weights and tokens (see E2E_SPREAD)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    steps = 4
    diff = lambda a, b: (float((a - b).norm() / b.norm()), float((a - b).abs().max()))
    moe = cfg.family == "moe"
    routes = []
    with torch.inference_mode():
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        toks = SyntheticTokens(cfg, DataConfig(batch_size=B, seq_len=S)).next_batch()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in toks.items()}
        with moe_routing(routes) if moe else contextlib.nullcontext():
            le, feed = serve_logits(params, cfg, batch, "einsum", steps)
        lk, _ = serve_logits(params, cfg, batch, "kernel", steps, feed)
        chunks = [cfg.ssm_chunk // k for k in TRAIN_BF16_CHUNK_DIVISORS] \
            if cfg.family in ("ssm", "hybrid") else []
        ys = [serve_logits(params, dataclasses.replace(cfg, ssm_chunk=c), batch,
                           "einsum", steps, feed)[0] for c in chunks]
        spreads = [f"einsum at chunk {c}" for c in chunks]
        if cfg.family in ("audio", "vlm"):
            with keys_reversed():
                ys.append(serve_logits(params, cfg, batch, "einsum", steps, feed)[0])
            spreads.append("einsum with its keys reversed")
        if moe and dtype == "bfloat16":
            with keys_reversed():
                own = serve_logits(params, cfg, batch, "einsum", steps, feed)[0]
            for i, (k, e) in enumerate(zip(lk, le)):
                (rel, mx), (r, m) = diff(k, e), diff(own[i], e)
                log(f"  {dtype} free-running (printed, not held) "
                    + ("prefill last logits" if i == 0 else f"decode step {i - 1} logits")
                    + f": kernel vs einsum rel L2 {rel:.3e}, max abs {mx:.3e}; the einsum "
                    f"path with its keys reversed {r:.3e}, {m:.3e} (limits "
                    f"{max(E2E_REL_L2, E2E_SPREAD * r):.3e}, "
                    f"{max(E2E_MAX_ABS, E2E_SPREAD * m):.3e})")
            with moe_routing(routes, replay=True):
                lk, _ = serve_logits(params, cfg, batch, "kernel", steps, feed)
            log(f"  {dtype}: held with the einsum path's routing replayed on the kernel "
                "path:")
    agree = lambda xs: sum(int(torch.equal(a.argmax(-1), b.argmax(-1)))
                           for a, b in zip(xs[1:], le[1:]))
    # a token criterion the plain path fails against itself judges nothing
    gated = min([steps] + [agree(y) for y in ys]) >= E2E_MIN_AGREE
    ok = True
    for i, (k, e) in enumerate(zip(lk, le)):
        what = "prefill last logits" if i == 0 else f"decode step {i - 1} logits"
        rel, mx = diff(k, e)
        own = [diff(y[i], e) for y in ys]
        lim_rel = max([E2E_REL_L2] + [E2E_SPREAD * r for r, _ in own])
        lim_mx = max([E2E_MAX_ABS] + [E2E_SPREAD * m for _, m in own])
        good = bool(k.isfinite().all()) and rel <= lim_rel and mx <= lim_mx
        ok = ok and good
        log(f"  {dtype} {what}: kernel vs einsum rel L2 {rel:.3e} (limit {lim_rel:.3e}), "
            f"max abs {mx:.3e} (limit {lim_mx:.3e})"
            + "".join(f"; {c}: {r:.3e}, {m:.3e}"
                      for c, (r, m) in zip(spreads, own)) + ("" if good else "  OVER"))
    log(f"  {dtype} greedy tokens agree on {agree(lk)} of {steps} decode steps ("
        + (f"limit {E2E_MIN_AGREE}" if gated else "not held: the einsum path "
           f"agrees with itself on fewer than {E2E_MIN_AGREE}")
        + "".join(f"; {c}: {agree(y)}" for c, y in zip(spreads, ys)) + ")")
    if not ok or (gated and agree(lk) < E2E_MIN_AGREE):
        raise AssertionError(f"serving ({dtype}): kernel path and einsum path disagree")
    del params
    torch.cuda.empty_cache()


def phase_profile(arch="granite_8b", B=4, S=512):
    """Where the time goes on a serving path's model at full width and
    depth (granite-8b, 36 layers; qwen3-moe-30b-a3b, 48; whisper-base, 6 +
    6; paligemma-3b, 18, behind its 256 image tokens), bf16, batch ``B``,
    prompt ``S``.  After a warm-up, one prefill and 4 decode steps are
    timed on the host clock untraced, then again under ``torch.profiler``
    for the device time by kernel (a separate traced run, so the serve
    phase's numbers carry no tracing cost); a moe model's traced runs
    take the CPU activity too, inside ``stage_ranges``, for the device
    time of each stage of its blocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    cfg = get_config(arch)
    moe = cfg.family == "moe"
    steps = 4
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with torch.inference_mode():
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        toks = SyntheticTokens(cfg, DataConfig(batch_size=B, seq_len=S)).next_batch()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in toks.items()}
        cache_len = cfg.num_prefix_tokens + S + steps      # a vlm's image prefix too
        cache, logits, plen = M.prefill(params, cfg, batch, cache_len)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def run(label):
            if label == "prefill":
                M.prefill(params, cfg, batch, cache_len)
            else:                     # each step writes its own slot in place
                for i in range(steps):
                    M.decode_step(params, cfg, tok, cache, plen + i)

        for label, n in (("prefill", 1), ("decode", steps)):
            run(label)                # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(label)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
            acts = [ProfilerActivity.CPU] * moe + [ProfilerActivity.CUDA]
            with profile(activities=acts) as prof, \
                    (stage_ranges() if moe else contextlib.nullcontext()):
                t0 = time.perf_counter()
                run(label)
                torch.cuda.synchronize()
                traced = (time.perf_counter() - t0) * 1e3 / n
            by_name = {}
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", 0) or 0
                # with CPU activity on, sum the kernels' own rows only
                if us > 0 and e.key not in STAGE_RANGES and (
                        not moe or e.device_type == torch.autograd.DeviceType.CUDA):
                    by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / n
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])
            suffix = "" if arch == "granite_8b" else f"_{arch}"
            with open(os.path.join(out_dir, f"profile_{label}{suffix}.txt"), "w") as f:
                for name, ms in top:
                    f.write(f"{ms:12.4f} ms  {name}\n")
            if not by_name:
                log(f"  {label}: {wall:.2f} ms a call untraced; device time "
                    "not measured (the profiler recorded none)")
                continue
            log(f"  {label}: {wall:.2f} ms a call untraced, {traced:.2f} ms traced; "
                f"device busy {busy:.2f} ms = {100 * busy / wall:.1f}% of the "
                f"untraced time (idle share {100 * (1 - busy / wall):.1f}%)")
            if moe:
                stages = {k: v / n for k, v in range_device_ms(prof).items()}
                log(f"  {label} by stage, device ms a call (the kernels each range "
                    "launched): " + "; ".join(
                        f"{k} {v:.3f} ({100 * v / busy:.1f}%)" for k, v in stages.items())
                    + f"; outside them (embedding, norms, unembedding) "
                    f"{busy - sum(stages.values()):.3f}")
            for name, ms in top[:6]:
                log(f"    {ms:9.4f} ms {100 * ms / busy:5.1f}%  {name[:90]}")
    del params, cache
    torch.cuda.empty_cache()


def ssd_inputs(case, dtype, gen):
    import torch
    import torch.nn.functional as F
    _, b, S, h, p, g, n, _ = case
    mk = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    x = mk(b, S, h, p).to(dtype)
    dt = F.softplus(mk(b, S, h)) * 0.5
    A = -torch.exp(mk(h) * 0.3)
    Bm = (mk(b, S, g, n) * 0.3).to(dtype)
    Cm = (mk(b, S, g, n) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


def ssd_bound(case, x_bytes):
    """(bound ms, what bounds it) of one ssd_scan call: the package's
    closed form (``kernels/cost.py``) at the bf16 tensor-core peak."""
    from repro_torch.kernels import cost
    _, b, S, h, p, g, n, chunk = case
    return cost.bound(*cost.ssd_scan_cost(b, S, h, p, g, n, chunk, x_bytes))


def phase_ssd_kernel():
    """``ssd_scan`` against ``ref.ssd_ref`` in fp32, bf16 and fp16 (the
    CUDA-core kernel, as fp32) at every case; its rows of times in bf16
    (the kernels line) and fp16 at the training shape.  Returns (the bf16
    row, the fp16 row)."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    err = err16 = 0.0
    for case in [SSD_TRAIN] + SSD_CASES + SSD_ZAMBA2 + SSD_MEMBERS:
        label, *_, chunk = case
        for dname, dt_ in kernel_dtypes().items():
            x, dt, A, Bm, Cm = ssd_inputs(case, dt_, gen)
            y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
            torch.cuda.synchronize()
            yr, fr = ref.ssd_ref(x, dt, A, Bm, Cm)
            e = max(compare(y, yr, dname, f"ssd_scan y [{label}, {dname}]", tol=SSD_TOL),
                    compare(fin, fr, dname, f"ssd_scan state [{label}, {dname}]",
                            tol=SSD_TOL))
            log(f"  ssd_scan        {label:36s} {dname:9s} max_abs_err={e:.3e} "
                f"(|y| <= {float(yr.abs().max()):.2f})")
            if dname == "float16":
                err16 = max(err16, e)
            else:
                err = max(err, e)
    # B and C as column slices of one tensor, read in place (the model's layout)
    label, b, S, h, p, g, n, chunk = SSD_CASES[0]
    for dname, dt_ in (("bfloat16", torch.bfloat16), ("float16", torch.float16)):
        x, dt, A, _, _ = ssd_inputs(SSD_CASES[0], dt_, gen)
        BC = torch.randn(b, S, 2 * g * n, generator=gen, device="cuda").to(dt_) * 0.3
        Bm, Cm = BC[..., :g * n].view(b, S, g, n), BC[..., g * n:].view(b, S, g, n)
        y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        yr, fr = ref.ssd_ref(x, dt, A, Bm, Cm)
        e = max(compare(y, yr, dname, "ssd_scan, strided B/C", tol=SSD_TOL),
                compare(fin, fr, dname, "ssd_scan state, strided B/C", tol=SSD_TOL))
        log(f"  ssd_scan        {'B/C column slices of one tensor':36s} {dname:9s} "
            f"max_abs_err={e:.3e}")

    # per call at the prefill shape, and the row's times at the training
    # shape, bf16 x/B/C as in the model
    label, *_, chunk = SSD_CASES[0]
    x, dt, A, Bm, Cm = ssd_inputs(SSD_CASES[0], torch.bfloat16, gen)
    pre = lambda i: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    pre_ms, pre_dev = time_ms(pre, 20), device_ms(pre, 20)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    log(f"  ssd_scan per call [{label}, bf16], CUDA events: kernel {pre_ms:.4f} ms; "
        f"device time {fmt(summed(pre_dev, 'ssd_fwd'))}; "
        f"bound {ssd_bound(SSD_CASES[0], 2)[0]:.4f} ms")
    rows = [ssd_timed(case, gen, err) for case in [SSD_TRAIN] + SSD_ZAMBA2 + SSD_MEMBERS]
    return rows[0], ssd_timed(SSD_TRAIN, gen, err16, torch.float16)


def ssd_timed(case, gen, err, dtype=None):
    """``ssd_scan``'s row of times at ``case`` (bf16 x/B/C as in the
    model unless ``dtype`` says otherwise; fp16 reads as many bytes),
    beside the plain ``ssd_ref`` and the bound, with the device time split
    over its kernels."""
    from repro_torch.kernels import ops, ref
    import torch

    label, *_, chunk = case
    dtype = dtype or torch.bfloat16
    tag = "fp16" if dtype == torch.float16 else "bf16"
    x, dt, A, Bm, Cm = ssd_inputs(case, dtype, gen)
    b_ms, b_by = ssd_bound(case, 2)
    kern = lambda i: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    plain = lambda i: ref.ssd_ref(x, dt, A, Bm, Cm)
    dev = device_ms(kern, 10)
    row = dict(name="ssd_scan", route="cuda", source=SSD_SOURCE,
               replaces=SSD_REPLACES, max_abs_err=err, bound_ms=b_ms,
               bound_by=b_by, ms=time_ms(kern, 10), plain_ms=time_ms(plain, 2, warmup=1),
               library_ms=None, device_ms=summed(dev, "ssd_fwd"),
               wrapper_device_ms=summed(dev))
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    log(f"  ssd_scan per call [{label}, {tag}], CUDA events: kernel {row['ms']:.4f} ms, "
        f"plain ssd_ref {row['plain_ms']:.4f} ms, no single PyTorch call; bound "
        f"{b_ms:.4f} ms ({b_by}); device time {fmt(row['device_ms'])} "
        f"(whole wrapper {fmt(row['wrapper_device_ms'])}): "
        + ", ".join(f"{kernel_name(k)} {v:.4f} ms" for k, v in dev.items()))
    return row


def rn_inputs(case, dtype, scale_dtype, gen):
    import torch
    _, rows, d, misaligned = case
    buf = torch.randn(rows * d + 1, generator=gen, device="cuda").to(dtype)
    x = buf[1:].view(rows, d) if misaligned else buf[:-1].view(rows, d)
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(scale_dtype)
    return x, scale


def phase_rmsnorm_kernel():
    """``rmsnorm`` against ``ref.rmsnorm_ref`` on the card, x in fp32, bf16
    and fp16 with the scale in any of them, and its rows of times at the
    profile's shape (bf16 x and bf16 scale, as the profiler times it; and
    fp16 x and scale).  Returns (the bf16 row, the fp16 row)."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    dtypes = kernel_dtypes()
    err = err16 = 0.0
    for case in [RN_PROFILE] + RN_CASES:
        label = case[0]
        for dname, dt in dtypes.items():
            for sname, st in dtypes.items():
                x, scale = rn_inputs(case, dt, st, gen)
                got = ops.rmsnorm(x, scale)
                torch.cuda.synchronize()
                e = compare(got, ref.rmsnorm_ref(x, scale), dname,
                            f"rmsnorm [{label}, x {dname}, scale {sname}]")
                log(f"  rmsnorm         {label:44s} x {dname:9s} scale {sname:9s} "
                    f"max_abs_err={e:.3e}")
                err = max(err, e) if dname == "bfloat16" else err
                err16 = max(err16, e) if dname == "float16" else err16
    x, _ = rn_inputs(RN_PROFILE, torch.float32, torch.float32, gen)
    try:
        ops.rmsnorm(x.t(), torch.ones(x.shape[0], device="cuda"))
    except ValueError as e:
        log(f"  rmsnorm refuses a non-contiguous x: {e}")
    else:
        raise AssertionError("rmsnorm took a non-contiguous x")
    return rn_timed(gen, err), rn_timed(gen, err16, torch.float16)


def rn_timed(gen, err, dtype=None):
    """``rmsnorm``'s row of times at the profile's shape, x and scale in
    ``dtype`` (bf16 unless it says otherwise; fp16 moves as many bytes),
    beside its plain version, ``F.rms_norm`` and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost, ops, ref

    dtype = dtype or torch.bfloat16
    tag = "fp16" if dtype == torch.float16 else "bf16"
    _, rows, d, _ = RN_PROFILE
    # three inputs taken in turn (200 MB with the outputs, > the 50 MB L2),
    # so every call reads x from device memory
    xs = [rn_inputs(RN_PROFILE, dtype, dtype, gen)[0] for _ in range(3)]
    scale = torch.ones(d, dtype=dtype, device="cuda")
    lib = F.rms_norm(xs[0], (d,), scale, 1e-6)
    lib_err = float((lib.float() - ref.rmsnorm_ref(xs[0], scale).float()).abs().max())
    b_ms, b_by = cost.bound(*cost.rmsnorm_cost(rows, d, 2, 2))
    n = len(xs)
    row = dict(name="rmsnorm", route="cuda", source=RN_SOURCE, replaces=RN_REPLACES,
               max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               **timed(lambda i: ops.rmsnorm(xs[i % n], scale),
                       lambda i: ref.rmsnorm_ref(xs[i % n], scale),
                       lambda i: F.rms_norm(xs[i % n], (d,), scale, 1e-6),
                       "rmsnorm_fwd", iters=200))
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
    log(f"  torch.nn.functional.rms_norm vs plain [{tag}]: max_abs_err={lib_err:.3e} "
        "(a yardstick for time only)")
    log(f"  rmsnorm per call [4096 x 4096 {tag}], CUDA events: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by})")
    log(f"  rmsnorm per call [{tag}], device time (profiler): kernel {fmt(row['device_ms'])}, "
        f"whole wrapper {fmt(row['wrapper_device_ms'])}, plain "
        f"{fmt(row['plain_device_ms'])}, library {fmt(row['library_device_ms'])}")
    return row


def plain_rmsnorm(x, scale, eps=1e-6):
    """RMSNorm written apart from ``ref.rmsnorm_ref`` (the function
    ``rmsnorm``'s backward differentiates): the root mean square from a
    vector norm, fp32 math."""
    import torch
    xf = x.float()
    rms = torch.linalg.vector_norm(xf, dim=-1, keepdim=True) / math.sqrt(x.shape[-1])
    return (xf / torch.sqrt(rms * rms + eps) * scale.float()).to(x.dtype)


def grad_compare(got, want, dtype_name, what):
    import torch
    worst = 0.0
    for g, w in zip(got, want):
        if g is None or not bool(g.float().isfinite().all()):
            raise AssertionError(f"{what}: a gradient is missing or not finite")
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        if err > GRAD_TOL[dtype_name] * max(scale, 1e-6):
            raise AssertionError(f"{what}: max abs err {err:.3e} over a largest "
                                 f"entry of {scale:.3e} (tol {GRAD_TOL[dtype_name]})")
        worst = max(worst, err / max(scale, 1e-6))
    return worst


def plain_attention(q, k, v, causal, window, q_offset, prefix_len):
    """Softmax attention written apart from ``ref.flash_attention_ref``
    (the function ``flash_attention``'s backward differentiates), so a
    wrong mask or head mapping in that backward shows: GQA by
    ``repeat_interleave``, the mask from explicit positions (the prefix
    visible to every query under causal), fp32 math."""
    import torch
    r = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(r, dim=2).float(), v.repeat_interleave(r, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(q.shape[-1])
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        keep &= (kpos <= qpos) | (kpos < prefix_len)
    if window:
        keep &= qpos - kpos < window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).to(q.dtype)


def phase_grads():
    """The gradients of the two autograd Functions (kernel forward,
    recomputed plain backward) against autograd through plain versions
    written apart from the ones their backward passes differentiate, on
    the same inputs."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    for case in FA_GRAD:
        label, kw = case[0], fa_kw(case)
        for dname, dt_ in kernel_dtypes().items():
            q, k, v = [t.requires_grad_() for t in fa_inputs(case, dt_, gen)]
            go = torch.randn(q.shape, generator=gen, device="cuda").to(dt_)
            out = ops.flash_attention(q, k, v, **kw)
            if out.grad_fn is None:
                raise AssertionError("flash_attention: the output has no grad_fn")
            got = torch.autograd.grad(out, (q, k, v), go)
            want = torch.autograd.grad(plain_attention(q, k, v, **kw), (q, k, v), go)
            e = grad_compare(got, want, dname, f"flash_attention grad [{label}, {dname}]")
            log(f"  flash_attention grad {label:38s} {dname:9s} "
                f"worst err / max = {e:.3e}")
    for case in RN_GRAD:
        label = case[0]
        for dname, dt_ in kernel_dtypes().items():
            x, scale = [t.requires_grad_() for t in
                        rn_inputs(case, dt_, torch.float32, gen)]
            go = torch.randn(x.shape, generator=gen, device="cuda").to(dt_)
            out = ops.rmsnorm(x, scale)
            if out.grad_fn is None:
                raise AssertionError("rmsnorm: the output has no grad_fn")
            got = torch.autograd.grad(out, (x, scale), go)
            want = torch.autograd.grad(plain_rmsnorm(x, scale), (x, scale), go)
            e = grad_compare(got, want, dname, f"rmsnorm grad [{label}, {dname}]")
            log(f"  rmsnorm grad         {label:38s} {dname:9s} "
                f"worst err / max = {e:.3e}")
    label, *_, chunk = SSD_GRAD
    x, dt, A, Bm, Cm = [t.requires_grad_() for t in
                        ssd_inputs(SSD_GRAD, torch.float32, gen)]
    ins = (x, dt, A, Bm, Cm)
    y, fin = ops.ssd_scan(*ins, chunk=chunk)
    gy = torch.randn(y.shape, generator=gen, device="cuda")
    gf = torch.randn(fin.shape, generator=gen, device="cuda")
    got = torch.autograd.grad((y, fin), ins, (gy, gf))
    yr, fr = ref.ssd_ref(*ins)
    want = torch.autograd.grad((yr, fr), ins, (gy, gf))
    e = grad_compare(got, want, "float32", f"ssd_scan grad [{label}]")
    log(f"  ssd_scan grad        {label:38s} float32   worst err / max = {e:.3e}")


def train_and_check(args, run, layers, per_step):
    """One ``repro_torch.launch.train`` run: the model must have
    ``layers`` layers, its losses be finite and fall, and each kernel in
    ``per_step`` launch that many times a step.  Returns (launches, the
    final train state)."""
    import statistics

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    run_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    ops.reset_launches()
    res = train.main(args + ["--run-dir", run_dir])
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    L, losses, times = res["num_layers"], res["losses"], res["step_times_s"]
    _SINGLE[run] = {k: res[k] for k in ("losses", "grad_norms", "step_times_s")}
    _PEAKS[run] = res["peak_mem_bytes"]
    steps = len(losses)
    if L != layers:
        raise AssertionError(f"{res['arch']} trained {L} layers, expected {layers}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses} are not finite and falling")
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"{steps} steps, expected {n} a step")
    p50 = statistics.median(times[1:])
    log(f"  losses: {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"  launches: {launches} over {steps} steps = " + ", ".join(
        f"{launches[name] // steps} {name}" for name in per_step) + " a step")
    log(f"  step time p50 over steps 2-{steps}: {p50 * 1e3:.1f} ms "
        f"(all: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms); "
        f"{res['tokens_per_step'] / p50:.0f} tok/s; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
    return launches, res["state"]


def phase_train():
    """mamba2-780m: each layer's forward launches ssd_scan once, and the
    remat recompute of the layer in the backward once more; the backward
    itself differentiates the chunked form and launches none."""
    return train_and_check(TRAIN_ARGS, "train_mamba2_780m", 48, {"ssd_scan": 2 * 48})


def phase_hybrid_train():
    """zamba2-2.7b: one checkpoint a group of 6 ssm layers and the shared
    block (nothing checkpointed inside it), so each group's kernels run
    in the forward and once more in the backward's recompute: 2 x 54
    ``ssd_scan`` and 2 x 9 ``flash_attention`` a step."""
    return train_and_check(HYBRID_TRAIN_ARGS, "train_zamba2_2p7b", 54,
                           {"ssd_scan": 2 * 54, "flash_attention": 2 * 9})


def bf16_gnorm_rows(names, got, want, yardsticks):
    """Phase 9's bf16 gradient check, leaf by leaf: (name, the kernel
    path's relative norm difference from the chunked path, the leaf's own
    spread: the largest relative difference of the chunked path at the
    other chunks, ``yardsticks``, and the leaf's limit)."""
    rel = lambda a, b: abs(a - b) / max(b, 1e-12)
    rows = []
    for i, name in enumerate(names):
        spread = max(rel(y[i], want[i]) for y in yardsticks)
        rows.append((name, rel(got[i], want[i]), spread,
                     TRAIN_BF16_GNORM_SPREAD * max(spread, TRAIN_BF16_GNORM_FLOOR)))
    return rows


def phase_train_kernel_vs_plain(dtype="float32", arch="mamba2_780m", layers=4, B=4,
                                S=2048):
    """``arch`` at full width cut to ``layers`` layers: the kernel path
    against the einsum (chunked) path, three steps from the same weights
    and batches of ``B`` x ``S``, in fp32 (the CUDA-core kernels) or bf16
    (the tensor-core ones; each leaf's gradient held to the einsum path's
    own spread at other chunks).  A moe model in bf16 is held with the
    einsum path's routing replayed on the kernel path (``moe_routing``),
    its spread the einsum path's with its attention keys reversed, and the
    free-running kernel path is printed beside it; an audio or vlm model
    (no ssm chunk to vary) takes that spread too."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import make_train_state, make_train_step
    from repro_torch.tree import flatten

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    steps = 3
    opt = AdamWConfig(lr=3e-4, total_steps=steps, warmup_steps=5)

    def run(cfg, backend, steps, ctx=None):
        with ctx or contextlib.nullcontext():
            return run_steps(cfg, backend, steps)

    def run_steps(cfg, backend, steps):
        state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                                 device=dev)
        loader = make_loader(cfg, DataConfig(batch_size=B, seq_len=S, seed=1234),
                             device=dev)
        batch = next(loader)
        flat = flatten(state.params)
        loss, _ = M.loss_fn(state.params, cfg, batch, backend=backend)
        norms = [float(g.float().norm())
                 for g in torch.autograd.grad(loss, list(flat.values()))]
        step = make_train_step(cfg, opt, backend=backend)
        losses = []
        for i in range(steps):
            state, m = step(state, batch if i == 0 else next(loader))
            losses.append(float(m["loss"]))
        del state, loader, batch
        torch.cuda.empty_cache()
        return list(flat), norms, losses

    moe = cfg.family == "moe"
    routes = []
    names, ne, le = run(cfg, "einsum", steps, moe_routing(routes) if moe else None)
    _, nk, lk = run(cfg, "kernel", steps)
    loss_rtol = TRAIN_LOSS_RTOL if dtype == "float32" else TRAIN_BF16_LOSS_RTOL
    if cfg.family in ("audio", "vlm") and dtype == "bfloat16":
        _, ny, _ = run(cfg, "einsum", 0, keys_reversed())
    if moe and dtype == "bfloat16":
        rel = max(abs(a - b) / b for a, b in zip(lk, le))
        _, ny, ly = run(cfg, "einsum", steps, keys_reversed())
        own = max(abs(a - b) / b for a, b in zip(ly, le))
        log(f"  {dtype}, free-running (printed, not held): losses kernel "
            f"{', '.join(f'{x:.6f}' for x in lk)}; worst rel diff {rel:.2e} (limit "
            f"{loss_rtol}; the einsum path with its keys reversed: {own:.2e}); worst "
            f"per-leaf gradient norm rel diff "
            f"{max(abs(a - b) / max(b, 1e-12) for a, b in zip(nk, ne)):.2e}")
        _, nk, lk = run(cfg, "kernel", steps, moe_routing(routes, replay=True))
        log(f"  {dtype}: held with the einsum path's routing replayed on the kernel path:")
    rel = max(abs(a - b) / b for a, b in zip(lk, le))
    log(f"  {dtype}: losses kernel {', '.join(f'{x:.6f}' for x in lk)}; "
        f"einsum {', '.join(f'{x:.6f}' for x in le)}; worst rel diff {rel:.2e} "
        f"(limit {loss_rtol})")
    if dtype == "float32":
        worst = max(abs(a - b) / max(b, 1e-12) for a, b in zip(nk, ne))
        log(f"  {dtype}: step-1 gradients: worst relative per-leaf norm difference "
            f"{worst:.2e} over {len(nk)} leaves (limit {TRAIN_GNORM_RTOL:.0e})")
        grads_ok = worst <= TRAIN_GNORM_RTOL
    else:
        if moe or cfg.family in ("audio", "vlm"):
            rows = bf16_gnorm_rows(names, nk, ne, [ny])
            what = "the einsum path's own spread with its attention keys reversed"
        else:
            chunks = [cfg.ssm_chunk // k for k in TRAIN_BF16_CHUNK_DIVISORS]
            rows = bf16_gnorm_rows(names, nk, ne, [
                run(dataclasses.replace(cfg, ssm_chunk=c), "einsum", 0)[1] for c in chunks])
            what = (f"the chunked path's own spread at chunk "
                    f"{' and '.join(map(str, chunks))}")
        log(f"  {dtype}: step-1 gradients, per leaf: relative norm difference, "
            f"{what}, limit = {TRAIN_BF16_GNORM_SPREAD} x max(spread, "
            f"{TRAIN_BF16_GNORM_FLOOR:.0e})")
        for name, d, spread, limit in rows:
            log(f"    {name:30s} {d:.2e}  spread {spread:.2e}  limit {limit:.2e}"
                + ("  OVER" if d > limit else ""))
        grads_ok = all(d <= limit for _, d, _, limit in rows)
    if not all(map(math.isfinite, lk + nk)) or rel > loss_rtol or not grads_ok:
        raise AssertionError(f"training ({dtype}): kernel path and einsum path disagree")
    torch.cuda.empty_cache()


def phase_ssm_serve():
    """mamba2-780m: one ``ssd_scan`` a layer in the prefill; decode takes
    the recurrent update."""
    serve_and_check(SSM_SERVE_ARGS, "serve_mamba2_780m", 48,
                    lambda calls: {"ssd_scan": 48})


def phase_hybrid_serve():
    """zamba2-2.7b: one ``ssd_scan`` a layer and one ``flash_attention``
    a group (the shared block) in the prefill; one ``flash_decode`` a
    group in each decode call."""
    L, G = 54, 9
    return serve_and_check(HYBRID_SERVE_ARGS, "serve_zamba2_2p7b", L, lambda calls: {
        "ssd_scan": L, "flash_attention": G, "flash_decode": G * calls,
        "rmsnorm": 0})


def phase_dense_train():
    """qwen1.5-0.5b: each layer's forward and its remat recompute launch
    ``flash_attention``; the gradient reaches the attention weights."""
    import torch

    _, state = train_and_check(DENSE_TRAIN_ARGS, "train_qwen1p5_0p5b", 24,
                               {"flash_attention": 2 * 24})
    if not float(state.opt_state["m"]["blocks"]["attn"]["wq"].abs().max()) > 0:
        raise AssertionError("no gradient reached the attention weights")
    del state
    torch.cuda.empty_cache()


def phase_train_profile(state, args, out_name, layers=None):
    """Where the time goes in a warm train step of the model and batch of
    ``args`` (the state its training phase left; ``layers`` the depth it
    was cut to): one step timed untraced, one traced with the CPU
    activity too, so the backward ranges (``ssd_scan.backward``,
    ``flash_attention.backward``) get their device time; for a moe model
    the traced step runs inside ``stage_ranges``, whose ranges (the
    forward and the recompute) get theirs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training.train_step import make_train_step

    flag = lambda name: args[args.index(name) + 1]
    dev = torch.device("cuda")
    cfg = get_config(flag("--arch"))
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, total_steps=10, warmup_steps=5))
    loader = make_loader(cfg, DataConfig(batch_size=int(flag("--batch")),
                                         seq_len=int(flag("--seq")), seed=99),
                         device=dev)
    state, _ = step(state, next(loader))              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, next(loader))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    batch = next(loader)
    ranges = ("ssd_scan.backward", "flash_attention.backward")
    moe = cfg.family == "moe"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            (stage_ranges() if moe else contextlib.nullcontext()):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    kernels, bwd = {}, {}
    stages = range_device_ms(prof) if moe else {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if e.key in ranges:
            # the named range: its span on the device, over its kernels
            bwd[e.key] = dev_us / 1e3
        elif e.key in STAGE_RANGES:
            continue
        elif dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            # with CPU activity on, an operator's row repeats its kernels'
            # device time: sum the kernels' own rows only
            kernels[e.key] = kernels.get(e.key, 0.0) + dev_us / 1e3
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    with open(os.path.join(out_dir, out_name), "w") as f:
        for name, ms in top:
            f.write(f"{ms:12.4f} ms  {name}\n")
    if not kernels:
        log(f"  train step: {wall:.1f} ms untraced; device time not measured "
            "(the profiler recorded none)")
        return
    busy = sum(kernels.values())
    pct = lambda v: f"{v:.1f} ms ({100 * v / busy:.1f}%)"
    ssd = sum(v for k, v in kernels.items() if "ssd_fwd" in k)
    attn = sum(v for k, v in kernels.items() if "attn_fwd" in k)
    gemm = sum(v for k, v in kernels.items()
               if any(t in k.lower() for t in ("gemm", "cutlass", "xmma", "nvjet")))
    log(f"  train step: {wall:.1f} ms untraced, {traced:.1f} ms traced; device busy "
        f"{busy:.1f} ms = {100 * busy / wall:.1f}% of the untraced step "
        f"(idle share {100 * (1 - busy / wall):.1f}%)")
    log(f"    ssd_scan kernels (ssd_fwd*: three a call in bf16) {pct(ssd)}; "
        f"flash_attention kernel (attn_fwd*) {pct(attn)}; "
        + "; ".join(f"{r} (its plain recompute included) "
                    + (pct(bwd[r]) if r in bwd else "not measured") for r in ranges)
        + f"; every other kernel {busy - ssd - attn - sum(bwd.values()):.1f} ms; "
        f"GEMMs anywhere (the backward's included) {pct(gemm)}")
    if stages:
        log("    forward and recompute by stage (device time of the kernels each "
            "range launched): " + "; ".join(f"{k} {pct(v)}" for k, v in stages.items())
            + f"; the backward (outside the ranges) and the optimizer "
            f"{busy - sum(stages.values()):.1f} ms")
    for name, ms in top[:8]:
        log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}%  {name[:90]}")
    del state
    torch.cuda.empty_cache()


def phase_profiler(arch=PROFILE_ARCH, layers=None, seq=PROFILE_SEQ,
                   iters=PROFILE_ITERS):
    """The measured auto-profiler on the card: ``arch`` at full width (cut
    to ``layers`` layers, which only the decode step sees) at ``seq``
    through the kernels, each time the median of ``iters`` calls, then one plan of the whole model priced with and
    without the card's times laid over chip type A.  An audio model's
    decode step also launches ``flash_attention`` once a decoder layer
    (its cross-attention at Sq = 1)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import chips, cost_model, profiler, schedule
    from repro_torch.kernels import ops

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    ops.reset_launches()
    t0 = time.perf_counter()
    meas = profiler.measure_layer_profile(cfg, seq, iters=iters,
                                          backend="kernel")
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    torch.cuda.empty_cache()
    log(f"  measure_layer_profile({cfg.name}, {seq}, iters={iters}, "
        f"backend='kernel') in {wall:.1f} s: " + json.dumps(meas))
    log(f"  launches: {launches}")
    times = {k: v for k, v in meas.items() if k != "backend"}
    bad = [k for k, v in times.items() if not (math.isfinite(v) and v > 0)]
    if bad or meas["backend"] != "kernel":
        raise AssertionError(f"profile fields {bad} are not finite and > 0, or the "
                             f"backend is {meas['backend']!r}: {meas}")
    calls = iters + 1                            # one warm call, then the timed ones
    cross = cfg.num_layers if cfg.family == "audio" else 0
    want = {"rmsnorm": calls,
            # block forward, forward + full backward, attention, an
            # audio decode step's cross-attention; and the one forward
            # whose graph the wgrad pairs' backward passes share
            "flash_attention": (3 + cross) * calls + 1,
            "flash_decode": cfg.num_layers * calls,   # every layer of each decode step
            "ssd_scan": 0}
    if launches != want:
        raise AssertionError(f"profiler launches {launches}, expected {want}")

    cfg = full
    analytic = profiler.analytic_layer_profile(chips.CHIPS["A"], cfg, 1, seq)
    log(f"  chip A's analytic layer at tp 1 (the profile it replaces): "
        f"t_fwd {analytic.t_fwd:.6f} s, t_bwd {analytic.t_bwd:.6f} s, "
        f"wgrad_frac {analytic.wgrad_frac:.4f}")
    group = lambda name: chips.ChipGroup(chips.CHIPS[name], 4)
    half = cfg.num_layers // 2
    plan = cost_model.ParallelPlan(
        [cost_model.StagePlan(group("A"), 1, 2, half, False),
         cost_model.StagePlan(group("B"), 1, 2, cfg.num_layers - half, False)],
        dp=2, microbatches=4)
    log(f"  plan {plan.describe()}: the card's profile laid over chip type A "
        "only to show that measured numbers reach the ranker; this is not a "
        "plan for an H100 cluster")
    gbs = plan.batch_seqs * seq
    measured = {"A": meas}
    base = cost_model.evaluate(plan, cfg, seq, gbs)
    over = cost_model.evaluate(plan, cfg, seq, gbs, measured=measured)
    sim0 = schedule.simulate_plan(plan, cfg, seq)
    sim1 = schedule.simulate_plan(plan, cfg, seq, measured=measured)
    for label, c, r in (("analytic", base, sim0), ("measured on A", over, sim1)):
        log(f"  {label:14s} evaluate: iter_time {c.iter_time:.6f} s, tgs {c.tgs:.3f}, "
            f"t_comp {[round(t, 6) for t in c.t_comp]}, bubble {c.bubble_frac:.4f}, "
            f"feasible {c.feasible}; simulate_plan makespan {r.makespan:.6f} s")
    if not (math.isfinite(over.iter_time) and over.iter_time != base.iter_time
            and sim1.makespan != sim0.makespan):
        raise AssertionError("the measured profile did not reach evaluate and "
                             "simulate_plan")
    return launches


def pp_plan(stages, microbatches, dp=1, schedule="1f1b", **extra):
    """A ``ParallelPlan`` JSON (``to_dict``) of one-stage chip groups,
    (chip, tp, layers, recompute) a stage, each of tp x dp chips;
    ``extra`` adds plan fields (``batch_domain``, ``dp_sync``, ...)."""
    return {"dp": dp, "microbatches": microbatches, "schedule": schedule,
            "stages": [{"chip": chip, "count": tp * dp, "label": "", "tp": tp, "pp": 1,
                        "layers": layers, "recompute": rec}
                       for chip, tp, layers, rec in stages], **extra}


def write_plan(run, plan):
    """``plan`` as ``build/chip_smoke/<run>/plan.json``; returns its path."""
    out_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "plan.json")
    with open(path, "w") as f:
        json.dump(plan, f)
    return path


def plan_and_check(arch, stages, microbatches, args, schedule, kernel, transport="host",
                   tp=1, trace=False):
    """``repro_torch.launch.train --plan`` of ``stages`` with ``tp``
    members a stage: ``kernel`` launches tp x b x sum_s L_s x (2 if
    recompute[s] else 1) times a step over the ranks; with ``trace`` also
    ``--trace`` (``trace_check``).  Returns the launcher's result
    (``pipeline_and_check``)."""
    run = f"pipeline_{arch}_{schedule}_{transport}" + (f"_tp{tp}" if tp > 1 else "")
    path = write_plan(run, pp_plan([(chip, tp, L, rec) for chip, L, rec in stages],
                                   microbatches, schedule=schedule))
    per_step = tp * microbatches * sum(L * (2 if rec else 1) for _, L, rec in stages)
    layers = sum(L for _, L, _ in stages)
    with plan_cut(arch, layers, schedule):
        return pipeline_and_check(run, ["--arch", arch, "--plan", path] + args, kernel,
                                  per_step, layers, schedule, transport,
                                  trace=(schedule, len(stages), (microbatches,), False)
                                  if trace else None)


def plan_cut(arch, layers, label):
    """``cut_depth`` to a plan's ``layers`` where they are fewer than the
    config's (the cut printed)."""
    from repro_torch.configs import get_config
    full = get_config(arch).num_layers
    if layers < full:
        log(f"  {label}: {arch} cut to {layers} of {full} layers (full width)")
    return cut_depth(layers if layers < full else None)


def pipeline_and_check(run, argv, kernel, per_step, layers, label, transport="host",
                       trace=None):
    """``repro_torch.launch.train`` on a rank grid (its ranks sharing the
    card under ``--p2p host`` on one card; one card a rank otherwise): the
    losses must be finite and fall, and ``kernel`` launch
    ``per_step`` times a step, summed over the ranks (each counts from 0
    in its own process).  Prints the step, the memory and the collectives
    a step by rank and group.  ``trace`` (schedule, stages, allocations,
    by tick) adds ``--trace`` and holds its run directory
    (``trace_check``).  Returns the launcher's result."""
    import statistics

    import torch
    from repro_torch.kernels import ops

    out_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = launch_pipeline(argv + ["--run-dir", out_dir, "--p2p", transport] + PP_ARGS
                          + (["--trace"] if trace else []))
    wall = time.perf_counter() - t0
    launches, losses, times = res["launches"], res["losses"], res["step_times_s"]
    steps = len(losses)
    if res["num_layers"] != layers:
        raise AssertionError(f"{res['arch']} trained {res['num_layers']} layers")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses} are not finite and falling")
    if launches[kernel] != per_step * steps:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times in {steps} "
                             f"steps over the ranks, expected {per_step} a step")
    p50 = statistics.median(times[1:]) if steps > 1 else times[0]
    ticks = res["ticks"]
    # a grouped layout hops across its stage boundaries, the others along
    # their pipe groups: one of the two counts is 0
    hop = lambda key, i: res[f"p2p_{key}_per_step"][i] + res[f"boundary_{key}_per_step"][i]
    p2p_b = hop("bytes", -1)
    steady = lambda xs: statistics.median(xs[1:] or xs)
    p2p_s = steady([hop("s", i) for i in range(steps)])
    copy_s = steady([hop("copy_s", i) for i in range(steps)])
    n = len(res["peak_mem_bytes_per_rank"])
    log(f"  {label}: losses {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"  {label}: launches over the {n} ranks {launches} in {steps} steps = "
        f"{launches[kernel] // steps} {kernel} a step (expected {per_step})")
    log(f"  {label}: step p50{' over steps 2-' + str(steps) if steps > 1 else ''} "
        f"{p50 * 1e3:.1f} ms (all: {', '.join(f'{t * 1e3:.1f}' for t in times)} ms); "
        f"{res['tokens_per_step'] / p50:.0f} tok/s; {ticks} ticks a step; rank 0's "
        f"P2P {p2p_b / ticks / 2**20:.2f} MiB and {p2p_s * 1e3 / ticks:.2f} ms a tick "
        f"({p2p_s * 1e3:.1f} ms a step, forward and backward, waits for the peer "
        f"included; host staging copies {copy_s * 1e3 / ticks:.2f} ms a tick); peak "
        f"memory by rank "
        + ", ".join(f"{b / 2**30:.2f}" for b in res["peak_mem_bytes_per_rank"])
        + f" GiB; {wall:.1f} s of wall time")
    ms = lambda key, r: steady(res[key + "_per_step_per_rank"][r]) * 1e3
    hop_ms = lambda key, r: ms("p2p_" + key, r) + ms("boundary_" + key, r)
    log(f"  {label}: collectives a step by rank (d, s, k), wall ms: " + "; ".join(
        f"rank {r} {tuple(res['grid_per_rank'][r])}: hops {hop_ms('s', r):.1f} (copies "
        f"{hop_ms('copy_s', r):.1f}), boundary all-gather {ms('boundary_gather_s', r):.1f}, "
        f"tp all-reduce {ms('tp_s', r):.1f}, dp all-reduce "
        f"{ms('dp_s', r):.1f}, dp reduce-scatter {ms('dp_scatter_s', r):.1f}, dp "
        f"all-gather {ms('dp_gather_s', r):.1f}, replicated all-reduce "
        f"{ms('reduce_s', r):.1f}, norm {ms('norm_s', r):.1f}" for r in range(n)))
    if trace:
        trace_check(res, out_dir, kernel, per_step, label, trace, p50)
    return res


def trace_check(res, run_dir, kernel, per_step, label, tables, p50):
    """A ``--trace`` run's directory: ``validate_run_dir(require_trace=True)``
    finds no error, the executed ticks are the priced ones, the executed
    trace has one ``F`` span per active (replica, stage, tick) cell of the
    copied tick tables (``tables``: schedule, stages, each replica's
    allocation; and whether to print the exchange tick by tick), the
    traced pass launched ``kernel`` one step's ``per_step`` times over the
    ranks, and the denominator check held (the tokens the CE consumed
    and the loss's denominator, each the closed form).  Prints each
    stage's executed ``F`` and ``B`` seconds beside the predicted ``F``
    share, each rank's exchange seconds (hop and wait, forward and
    backward) as a share of its traced wall time, and the traced wall
    beside the step p50: a fenced pass, each tick synchronized, not the
    step."""
    from repro_torch.core.tickprogram import spmd_tick_tables
    from repro_torch.obs.validate import validate_run_dir

    schedule, S, allocs, by_tick = tables
    errs = validate_run_dir(run_dir, require_trace=True)
    with open(os.path.join(run_dir, "trace_executed.json")) as f:
        exe = json.load(f)
    with open(os.path.join(run_dir, "align.json")) as f:
        align = json.load(f)
    meta, summary = exe["metadata"], res["trace"]
    cells = sum(int(spmd_tick_tables(schedule, S, a).active.sum()) for a in allocs)
    spans = sum(1 for e in exe["traceEvents"]
                if e.get("ph") == "X" and e["args"]["kind"] == "F")
    launched, denom = res["trace_launches"][kernel], meta["denom_check"]
    log(f"  {label} trace: validate_run_dir errors {errs}; ticks {align['executed_ticks']} "
        f"executed, {align['priced_ticks']} priced (match {align['ticks_match']}); {spans} "
        f"F spans, {cells} active cells of the copied tick tables; {launched} {kernel} in "
        f"the traced pass over the ranks (a step: {per_step}); denominator: the CE "
        f"consumed {denom['measured']} tokens, the loss divided by {denom['loss_denom']}, "
        f"{denom['expected']} expected")
    log(f"  {label} trace by stage (executed F / B ms; F share executed vs predicted): "
        + "; ".join(f"stage {row['stage']}: F {row['executed_s'] * 1e3:.1f} / B "
                    f"{summary['stage_b_s'][row['stage']] * 1e3:.1f} ms, share "
                    f"{row['executed_share']:.4f} vs {row['predicted_share']:.4f}"
                    for row in align["per_stage"])
        + f"; max_abs_rel_err {summary['max_abs_rel_err']:.4f}; stragglers flagged "
        + ", ".join(f"{k} {v['flagged']}" for k, v in align["stragglers"].items()))
    exch = [sum(x["forward"]) + sum(x["backward"]) for x in meta["exchange_s"]]
    log(f"  {label} trace: exchange (hop and wait) as a share of each rank's traced "
        f"wall, rank (d, s, k): " + "; ".join(
            f"{r} {tuple(g)}: {e * 1e3:.1f} of {w * 1e3:.1f} ms = {e / w:.3f}"
            for r, (g, e, w) in enumerate(zip(meta["grid"], exch, meta["rank_wall_s"]))))
    if by_tick:
        for r, (g, x) in enumerate(zip(meta["grid"], meta["exchange_s"])):
            log(f"  {label} trace: rank {r} {tuple(g)} exchange ms by tick, forward "
                + ", ".join(f"{v * 1e3:.1f}" for v in x["forward"]) + "; backward "
                + ", ".join(f"{v * 1e3:.1f}" for v in x["backward"]))
    log(f"  {label} trace: traced wall {meta['wall_s'] * 1e3:.1f} ms (one fenced forward "
        f"and backward, no update) beside the step p50 {p50 * 1e3:.1f} ms")
    bad = [f"validate_run_dir: {errs}"] if errs else []
    if not summary["ticks_match"]:
        bad.append("the executed ticks are not the priced ones")
    if spans != cells:
        bad.append(f"{spans} F spans for {cells} active cells")
    if launched != per_step:
        bad.append(f"the traced pass launched {kernel} {launched} times, not {per_step}")
    if not denom["measured"] == denom["loss_denom"] == denom["expected"]:
        bad.append(f"denominator {denom}")
    if bad:
        raise AssertionError(f"{label} trace: " + "; ".join(bad))


def _parity_rank(rank, world, device, cases, microbatches, phys, schedules):
    """Phase 16 (c) on one rank: for each (arch, layers, mb, seq) case and
    dtype, the pipeline's loss and its gradient's squared norm per leaf
    in fp64 (block leaves over this rank's slots, the replicated ones on
    rank 0 only) under every schedule; and for each case, whether 1f1b's
    fp32 loss and gradient with the tracer's clock in the tick loop equal
    those without it bit for bit."""
    import torch
    from repro_torch.comm.p2p import Grid
    from repro_torch.core import heteropp as HP
    from repro_torch.core.schedules import get_schedule
    from repro_torch.kernels import build
    from repro_torch.obs.runtime import fenced_clock
    from repro_torch.tree import flatten, tree_leaves

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build.load()
    grid = Grid.build("host", dev, pipe=world)
    p2p = grid.pipe
    out = {}
    for arch, layers, mb, seq in cases:
        for dtype in PP_PARITY_DTYPES:
            cfg, params, tokens = parity_inputs(arch, layers, dtype, mb, seq,
                                                microbatches, dev)
            for name in schedules:
                sched = get_schedule(name)
                spec = HP.PipelineSpec(world, HP.chunk_layer_counts(phys, sched),
                                       microbatches, schedule=name,
                                       n_chunks=sched.n_chunks)
                local = HP.local_stage_params(params, cfg, spec, rank)
                for t in flatten(local).values():
                    t.requires_grad_()
                loss, grads = HP.make_pipeline_loss(cfg, spec, grid)(local, tokens)
                if dtype == "float32" and name == "1f1b":
                    # the tracer's clock in the loop changes no bit of the result
                    loss_c, grads_c = HP.make_pipeline_loss(
                        cfg, spec, grid, clock=fenced_clock(dev))(local, tokens)
                    out[f"{arch} clock"] = bool(torch.equal(loss, loss_c)) and all(
                        torch.equal(a, c) for a, c in zip(tree_leaves(grads),
                                                          tree_leaves(grads_c)))
                    del grads_c
                grads = HP.make_grad_sync(spec, grid, "psum")(
                    grads, HP.zero1_dims(local, spec, "psum"))
                sq = {k: float(torch.sum(torch.square(g.double())))
                      for k, g in flatten(grads).items()
                      if k.startswith("blocks/") or rank == 0}
                out[f"{arch} {dtype} {name}"] = {"loss": float(loss), "sq": sq}
                del local, grads
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    # one hop alone: both ranks exchange one activation each way, the
    # tick's exchange with no compute around it
    for label, shape in PP_HOPS:
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        for _ in range(3):
            p2p.ppermute([(x, [(0, 1), (1, 0)])], x)
        torch.distributed.barrier()
        p2p.reset_counts()
        for _ in range(PP_HOP_ITERS):
            p2p.ppermute([(x, [(0, 1), (1, 0)])], x)
        out[f"hop {label}"] = {"ms": p2p.seconds / PP_HOP_ITERS * 1e3,
                               "copy_ms": p2p.copy_seconds / PP_HOP_ITERS * 1e3,
                               "mib": x.numel() * x.element_size() / 2 ** 20}
    return out


def parity_inputs(arch, layers, dtype, mb, seq, microbatches, dev):
    """The cut config, its seeded weights and ``microbatches`` batches of
    (mb, seq) tokens, the same in every process on one card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    loader = make_loader(cfg, DataConfig(batch_size=mb * microbatches, seq_len=seq,
                                         seed=1234), device=dev)
    return cfg, params, next(loader)["tokens"].reshape(microbatches, mb, seq)


def phase_pipeline_parity(device="cuda:0", microbatches=4):
    """Phase 16 (c): the pipeline (two ranks on the card, one spawn for
    every case) against the single-device ``loss_fn`` and its gradient,
    in fp32 and bf16."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import flatten

    dev = torch.device(device)
    t0 = time.perf_counter()
    res = spawn_ranks(_parity_rank, 2, (device, PP_PARITY, microbatches,
                                        PP_PARITY_SPLIT, PP_PARITY_SCHEDULES),
                      workdir=os.path.join(ROOT, "build", "chip_smoke", "parity"),
                      transport="host", timeout=600)
    log(f"  (c) parity: both ranks done in {time.perf_counter() - t0:.1f} s with "
        "their start")
    for label, _ in PP_HOPS:
        log(f"  one hop alone, {label} bf16 ({res[0]['hop ' + label]['mib']:.2f} MiB each "
            f"way, --p2p host), mean of {PP_HOP_ITERS}: " + "; ".join(
                f"rank {r}: {o['hop ' + label]['ms']:.3f} ms, of which host staging "
                f"copies {o['hop ' + label]['copy_ms']:.3f} ms" for r, o in enumerate(res)))
    for arch, layers, mb, seq in PP_PARITY:
        log(f"  (c) {arch} width, {layers} layers split "
            f"{' / '.join(map(str, PP_PARITY_SPLIT))}, {microbatches} microbatches "
            f"of {mb} x {seq}")
        same = [r[f"{arch} clock"] for r in res]
        log(f"  float32 1f1b with the tracer's clock in the tick loop against without: "
            f"loss and gradient the same bit for bit on every rank: {all(same)}")
        if not all(same):
            raise AssertionError(f"phase 16 (c) {arch}: the clock changed the result on "
                                 f"ranks {[r for r, ok in enumerate(same) if not ok]}")
        for dtype in PP_PARITY_DTYPES:
            cfg, params, tokens = parity_inputs(arch, layers, dtype, mb, seq,
                                                microbatches, dev)
            flat = flatten(params)
            for t in flat.values():
                t.requires_grad_()
            loss, _ = M.loss_fn(params, cfg, {"tokens": tokens.reshape(-1, seq)})
            norms = {k: float(g.double().norm())
                     for k, g in zip(flat, torch.autograd.grad(loss, list(flat.values())))}
            want = float(loss.detach())
            del params, flat
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            runs = {name: [r[f"{arch} {dtype} {name}"] for r in res]
                    for name in PP_PARITY_SCHEDULES}
            losses = {name: rs[0]["loss"] for name, rs in runs.items()}
            if len({r["loss"] for rs in runs.values() for r in rs}) != 1:
                raise AssertionError(f"pipeline losses differ between schedules or "
                                     f"ranks: {losses}")
            rel = abs(losses["1f1b"] - want) / abs(want)
            loss_rtol = TRAIN_LOSS_RTOL if dtype == "float32" else TRAIN_BF16_LOSS_RTOL
            log(f"  {dtype}: pipeline loss {losses['1f1b']:.7f}, the same bit for bit "
                f"under {', '.join(PP_PARITY_SCHEDULES)}; single device {want:.7f}; "
                f"rel diff {rel:.2e} (limit {loss_rtol})")
            worst = {}
            for name, rs in runs.items():
                got = {k: math.sqrt(sum(r["sq"].get(k, 0.0) for r in rs)) for k in norms}
                worst[name] = max((abs(got[k] - norms[k]) / max(norms[k], 1e-12), k)
                                  for k in norms)
            log(f"  {dtype}: worst relative per-leaf gradient norm difference over "
                f"{len(norms)} leaves: " + ", ".join(f"{k} {v:.2e} ({leaf})"
                                                     for k, (v, leaf) in worst.items())
                + (f" (limit {TRAIN_GNORM_RTOL:.0e})" if dtype == "float32"
                   else " (reported, not held in bf16)"))
            if not math.isfinite(rel) or rel > loss_rtol or (
                    dtype == "float32"
                    and max(v for v, _ in worst.values()) > TRAIN_GNORM_RTOL):
                raise AssertionError(f"pipeline ({arch}, {dtype}) and the single "
                                     "device disagree")


def phase_pipeline(device="cuda:0"):
    """Phase 16: HeteroPP on one card: (a) qwen1.5-0.5b from the 3 / 5
    plan under 1f1b and zb_v, (b) mamba2-780m from the 6 / 10 plan, (c)
    parity at 4 layers.  Returns the launches of (a) and (b)."""
    arch, stages, b, args = PP_QWEN
    launches, per_step = {}, {}
    for schedule in ("1f1b", "zb_v"):
        res = plan_and_check(arch, stages, b, args, schedule, "flash_attention",
                             trace=schedule == "1f1b")
        per_step[schedule] = res["launches"]["flash_attention"] // len(res["losses"])
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    arch, stages, b, args = PP_MAMBA2
    got = plan_and_check(arch, stages, b, args, "1f1b", "ssd_scan")["launches"]
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    phase_pipeline_parity(device)
    return launches, per_step["1f1b"]


@contextlib.contextmanager
def cut_depth(layers, **fields):
    """The launcher's full-size configs cut to ``layers`` layers (where
    given) and ``fields`` replaced (a dtype, say) while the context lasts
    (ranks the launcher spawns get the config from it; the ranks of a
    ``rank_pool`` apply the same cut themselves)."""
    global _CUT
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    if layers is not None:
        fields = dict(fields, num_layers=layers)
    if not fields:
        yield
        return
    before, _CUT = _CUT, fields
    try:
        with mock.patch.object(train, "get_config", lambda name: dataclasses.replace(
                get_config(name), **fields)):
            yield
    finally:
        _CUT = before


_CUT = None                           # the config fields cut_depth replaces, if any
_POOL = None                          # the rank_pool of the running phase, if any
_POOLS = {}                           # world -> RankPool, kept until close_pools


class RankPool:
    """``world`` ranks started once (``ranks.spawn``'s fresh processes and
    process group) that run calls one after another: ``call(fn, args)``
    runs ``fn(rank, world, *args)`` on every rank and returns their
    results in rank order, as ``ranks.spawn`` does.  A phase's launcher
    runs and its parity check share the ranks' start: their imports, CUDA
    context and the libraries' first calls.  A rank that raises or dies,
    or a call that outlives its timeout, fails the call with the ranks'
    tracebacks, and every rank is stopped."""

    def __init__(self, world, workdir, transport="host"):
        import torch.multiprocessing as mp
        self.world, self.workdir = world, os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        store = os.path.join(self.workdir, "store")
        if os.path.exists(store):
            os.remove(store)
        ctx = mp.get_context("spawn")
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.procs = mp.start_processes(
            _pool_rank, args=(world, transport, self.workdir, self.inboxes, self.outbox),
            nprocs=world, join=False, start_method="spawn")

    def call(self, fn, args=(), timeout=1800.0):
        for box in self.inboxes:
            box.put((fn.__name__, tuple(args), _CUT))
        done, errs = set(), {}
        deadline = time.monotonic() + timeout
        while len(done) < self.world:
            try:
                rank, err = self.outbox.get(timeout=5.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs.processes) if not p.is_alive()]
                if dead or time.monotonic() >= deadline:
                    self.close(kill=True)
                    raise RuntimeError(f"{fn.__name__}: rank(s) {dead} exited" if dead
                                       else f"{fn.__name__}: ranks still running after "
                                       f"{timeout:.0f} s")
                continue
            done.add(rank)
            if err:
                errs[rank] = err
                self.close(kill=True)
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{err}")
        import torch
        return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), weights_only=True)
                for r in range(self.world)]

    def close(self, kill=False):
        for box in self.inboxes:
            box.put(None)
        for p in self.procs.processes:
            if kill and p.is_alive():
                p.kill()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()


def _pool_rank(rank, world, transport, workdir, inboxes, outbox):
    """A ``RankPool`` rank: join the group, then run each call it is sent
    (under its depth cut; only rank 0 prints), its result written to
    ``rank<r>.pt``, until it is sent None."""
    import gc

    import torch
    from repro_torch.launch import ranks
    if transport == "device":
        torch.cuda.set_device(rank)
    ranks.init_group(rank, world, transport, "file://" + os.path.join(workdir, "store"),
                     1800.0)
    quiet = open(os.devnull, "w")
    try:
        while True:
            item = inboxes[rank].get()
            if item is None:
                return
            name, args, cut = item
            try:
                with cut_depth(None, **(cut or {})), contextlib.redirect_stdout(
                        sys.stdout if rank == 0 else quiet):
                    if torch.cuda.is_available():
                        print(f"  [pool of {world}] rank {rank} holds "
                              f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB "
                              f"before {name}", flush=True)
                    out = globals()[name](rank, world, *args)
                path = os.path.join(workdir, f"rank{rank}.pt")
                torch.save(out, path + ".tmp")
                os.replace(path + ".tmp", path)
                del out
                gc.collect()
                if torch.cuda.is_available():
                    # the cuBLAS workspaces back to the allocator as well:
                    # the next call starts from what a fresh rank holds,
                    # so that its peak memory is its own
                    torch._C._cuda_clearCublasWorkspaces()
                    torch.cuda.empty_cache()
                outbox.put((rank, ""))
            except BaseException:
                outbox.put((rank, traceback.format_exc()))
                return
    finally:
        quiet.close()
        torch.distributed.destroy_process_group()


@contextlib.contextmanager
def rank_pool(world):
    """The ``RankPool`` of ``world`` ranks while the context lasts:
    ``launch_pipeline`` and ``spawn_ranks`` calls of that many ranks on
    the host transport run in it.  The pool is started on the first use
    of its size and kept for the later ones until ``close_pools``: an
    idle rank holds its CUDA context and no cached blocks."""
    global _POOL
    pool = _POOLS.get(world)
    if pool is None:
        pool = _POOLS[world] = RankPool(
            world, os.path.join(ROOT, "build", "chip_smoke", f"pool_{world}"))
    _POOL = pool
    try:
        yield pool
    finally:
        _POOL = None


def close_pools():
    """Stop every rank of every ``rank_pool``."""
    while _POOLS:
        _POOLS.popitem()[1].close()


def _in_pool(world, transport):
    """Whether a call of ``world`` ranks runs in the phase's ``rank_pool``
    (there is one); a call the pool cannot run raises."""
    if _POOL is None:
        return False
    if world != _POOL.world or transport != "host":
        raise ValueError(f"a call of {world} ranks on {transport} inside a pool of "
                         f"{_POOL.world} ranks on host")
    return True


def spawn_ranks(fn, world, args, *, workdir, transport="host", timeout=600):
    """``ranks.spawn(fn, world, args)``, or the same call in the phase's
    ``rank_pool``."""
    from repro_torch.launch import ranks
    if _in_pool(world, transport):
        return _POOL.call(fn, args, timeout)
    return ranks.spawn(fn, world, args, workdir=workdir, transport=transport,
                       timeout=timeout)


def _launcher_rank(rank, world, argv):
    """One rank of a launcher run in a ``rank_pool``: the launcher joins the
    ranks' process group and runs this rank."""
    import torch
    from repro_torch.launch import train
    res = train.main(argv)
    # the rank's cached blocks back to the card before the next run, the
    # main process's among them
    torch.cuda.empty_cache()
    return res


def launch_pipeline(argv):
    """``repro_torch.launch.train`` on a rank grid: in the phase's
    ``rank_pool`` (the launcher inside each rank, the ranks' results
    merged as the launcher merges its own), or else the launcher spawning
    its ranks."""
    from repro_torch.launch import train
    if _POOL is None:
        return train.main(argv)
    return train.merge_rank_results(_POOL.call(_launcher_rank, (argv,), 1800.0))


def grid_and_check(run, arch, layers, args, kernel, per_step, label, transport="host",
                   full_layers=None, trace=None):
    """A launcher run on a (dp, pipe, tp) grid from ``args``; ``layers``
    below the config's depth (``full_layers``) cuts it, which the output
    says; ``trace`` as ``pipeline_and_check``'s."""
    cut = full_layers is not None and layers < full_layers
    if cut:
        log(f"  {label}: {arch} cut to {layers} of {full_layers} layers (full width)")
    with cut_depth(layers if cut else None):
        return pipeline_and_check(run, ["--arch", arch] + args, kernel, per_step, layers,
                                  label, transport, trace=trace)


def check_zero1_state(res, label):
    """Each rank's optimizer-state bytes against the 12 bytes a parameter
    its stage holds at dp 1."""
    share, tol = ZERO_OPT_SHARE
    rows = []
    for r, (b, n) in enumerate(zip(res["opt_state_bytes_per_rank"],
                                   res["param_count_per_rank"])):
        got = b / (12 * n)
        rows.append(f"rank {r}: {b / 2**20:.1f} MiB = {got:.4f} x the "
                    f"{12 * n / 2**20:.1f} MiB of dp 1")
        if abs(got - share) > tol:
            raise AssertionError(f"{label}: rank {r} holds {got:.4f} of its stage's "
                                 f"optimizer state, expected {share} +- {tol}")
    log(f"  {label}: optimizer state (fp32 master, m, v) by rank: " + "; ".join(rows))


def phase_grid(qwen_1f1b_per_step, device="cuda:0"):
    """Phase 17: HeteroPP over tp and dp on one card, four ranks.
    Returns the launches of (a)-(c)."""
    launches = {}

    def add(res):
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v

    arch, stages, b, args = PP_QWEN
    log(f"  (a) {arch} {' / '.join(str(L) for _, L, _ in stages)}, tp {GRID_TP} a stage, "
        "1f1b")
    res = plan_and_check(arch, stages, b, args, "1f1b", "flash_attention", tp=GRID_TP)
    got = res["launches"]["flash_attention"] // len(res["losses"])
    if got != GRID_TP * qwen_1f1b_per_step:
        raise AssertionError(f"(a) launched {got} flash_attention a step, not {GRID_TP} x "
                             f"phase 16 (a)'s {qwen_1f1b_per_step}")
    log(f"  (a): {got} flash_attention a step = {GRID_TP} x phase 16 (a)'s "
        f"{qwen_1f1b_per_step} (each member on its {16 // GRID_TP} of 16 heads)")
    add(res)

    arch, layers, args = GRID_DENSE_DP
    label = f"(b) dp {GRID_DP} x pipe 2, ZeRO-1"
    res = grid_and_check("grid_dense_dp", arch, layers, args, "flash_attention",
                         GRID_DP * 4 * layers * 2, label, full_layers=24)
    check_zero1_state(res, "(b)")
    add(res)

    arch, layers, args = GRID_SSM_DP
    label = f"(c) dp {GRID_DP} x pipe 2, bucketed psum"
    res = grid_and_check("grid_ssm_dp", arch, layers, args, "ssd_scan",
                         GRID_DP * 4 * layers * 2, label, full_layers=48)
    add(res)

    phase_grid_parity(device)
    return launches


def _grid_parity_rank(rank, world, device, cases, microbatches, phys, transport):
    """Phase 17 (d) on one rank: for each (arch, layers, mb, seq) case and
    dtype, under (pipe 2, tp 2) (dense only) and under (dp 2, pipe 2)
    with psum and ZeRO-1: the loss and the squared norm of each leaf of
    the synced gradient in fp64, counted on the rank that holds it first
    (``heteropp.leaf_axes``); the largest difference between one
    gradient synced by bucketed and by per-leaf psum (a second backward
    would differ by the card's atomic adds), and ZeRO-1's master weights
    after one step against psum's (largest difference over the leaf's
    largest entry).  ``transport`` ``device`` runs rank r on card r."""
    import torch
    from repro_torch.comm.p2p import Grid
    from repro_torch.core import heteropp as HP
    from repro_torch.kernels import build
    from repro_torch.training.train_step import train_state_from
    from repro_torch.tree import flatten, tree_leaves, tree_map

    dev = torch.device(f"cuda:{rank}" if transport == "device" else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build.load()
    kinds = {k for case in cases for k in case[4]}
    grids = {"tp": Grid.build(transport, dev, pipe=2, tp=GRID_TP) if "tp" in kinds else None,
             "dp": Grid.build(transport, dev, dp=GRID_DP, pipe=2) if "dp" in kinds else None}
    out = {}

    def run(cfg, params, tokens, grid, sync):
        spec = HP.PipelineSpec(grid.S, phys, microbatches // grid.D,
                               tensor_parallel=grid.T, data_parallel=grid.D)
        local = HP.local_stage_params(params, cfg, spec, grid.s, grid.k)
        for t in flatten(local).values():
            t.requires_grad_()
        loss_fn = HP.make_pipeline_loss(cfg, spec, grid)
        loss, grads = loss_fn(local, tokens)
        dims = HP.zero1_dims(local, spec, sync)
        got = {"loss": float(loss)}
        if grid.D > 1 and sync == "psum":
            twin = tree_map(torch.clone, grads)
            bucketed = dataclasses.replace(spec, bucket_bytes=GRID_PARITY_BUCKET)
            HP.make_grad_sync(bucketed, grid, "psum")(twin, dims)
        grads = HP.make_grad_sync(spec, grid, sync)(grads, dims)
        if grid.D > 1 and sync == "psum":
            got["bucket diff"] = max(float((a - b).abs().max()) for a, b in
                                     zip(tree_leaves(grads), tree_leaves(twin)))
        coord = {"pipe": grid.s, "tp": grid.k, "dp": grid.d}
        got["sq"] = {k: float(torch.sum(torch.square(g.double())))
                     for (k, g), axes in zip(flatten(grads).items(),
                                             HP.leaf_axes(local, spec, dims))
                     if all(c == 0 for a, c in coord.items() if a not in axes)}
        master = None
        if grid.D > 1:
            del grads
            state = train_state_from(local, HP.stage_opt_state(local, spec, grid, sync), 0)
            HP.make_pipeline_train_step(cfg, spec, grid, grad_sync=sync)(state, tokens)
            master = (state.opt_state["master"], dims)
        return got, master

    for arch, layers, mb, seq, kinds in cases:
        for dtype in PP_PARITY_DTYPES:
            cfg, params, tokens = parity_inputs(arch, layers, dtype, mb, seq,
                                                microbatches, dev)
            key = f"{arch} {dtype}"
            if "tp" in kinds:
                out[f"{key} tp"] = run(cfg, params, tokens, grids["tp"], "psum")[0]
            if "dp" not in kinds:
                del params
                continue
            dp = grids["dp"]
            out[f"{key} psum"], (m_psum, _) = run(cfg, params, tokens, dp, "psum")
            out[f"{key} reduce_scatter"], (m_zero, dims) = run(cfg, params, tokens, dp,
                                                               "reduce_scatter")
            out[f"{key} zero diff"] = max(
                float((z - (p if d is None else p.chunk(GRID_DP, d)[dp.d])).abs().max())
                / max(float(p.abs().max()), 1e-30)
                for z, p, d in zip(tree_leaves(m_zero), tree_leaves(m_psum),
                                   tree_leaves(dims)))
            del params, m_psum, m_zero
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def phase_grid_parity(device="cuda:0", microbatches=4, transport="host",
                      cases=GRID_PARITY):
    """Phase 17 (d): the (pipe 2, tp 2) and (dp 2, pipe 2) grids (four
    ranks on the card under ``host``, one spawn for every case; one card
    a rank under ``device``) against the single-device ``loss_fn`` and
    its gradient, in fp32 and bf16."""
    import torch

    dev = torch.device(device)
    t0 = time.perf_counter()
    res = spawn_ranks(_grid_parity_rank, 4, (device, cases, microbatches,
                                             PP_PARITY_SPLIT, transport),
                      workdir=os.path.join(ROOT, "build", "chip_smoke", "grid_parity"),
                      transport=transport, timeout=600)
    log(f"  (d) parity: the four ranks done in {time.perf_counter() - t0:.1f} s with "
        "their start")
    for arch, layers, mb, seq, kinds in cases:
        log(f"  (d) {arch} width, {layers} layers split "
            f"{' / '.join(map(str, PP_PARITY_SPLIT))}, {microbatches} microbatches "
            f"of {mb} x {seq}"
            + (f" ({microbatches // GRID_DP} a replica under dp)" if "dp" in kinds else ""))
        for dtype in PP_PARITY_DTYPES:
            want, norms = single_device_grads(arch, layers, dtype, mb, seq, microbatches,
                                              dev)
            key = f"{arch} {dtype}"
            modes = (["tp"] if "tp" in kinds else []) + (
                ["psum", "reduce_scatter"] if "dp" in kinds else [])
            bad = []
            for mode in modes:
                bad += hold_parity([r[f"{key} {mode}"] for r in res], want, norms, dtype,
                                   mode)
            if "dp" in kinds:
                bucket = max(r[f"{key} psum"]["bucket diff"] for r in res)
                zero = max(r[f"{key} zero diff"] for r in res)
                log(f"  {dtype}: one gradient synced by bucketed psum "
                    f"({GRID_PARITY_BUCKET} bytes) and by per-leaf psum, largest "
                    f"difference {bucket:.3e} (must be 0); ZeRO-1 master weights after "
                    f"one step against psum's, largest difference / largest entry "
                    f"{zero:.2e} (limit {ZERO_MASTER_RTOL:.0e})")
                if bucket != 0.0:
                    bad.append("bucketed psum differs from per-leaf psum")
                if not zero <= ZERO_MASTER_RTOL:
                    bad.append("ZeRO-1 and psum updates differ")
            if bad:
                raise AssertionError(f"phase 17 (d) {arch} {dtype}: " + "; ".join(bad))


def boundary_report(res, label, stages, strategy, act_bytes):
    """A grouped run's stage-boundary traffic: the bytes that crossed it
    per exchange forward (stage 0's members sent them) and backward
    (stage 1's), the all-gather bytes a member of an ``sr_ag``
    destination brought in, and each rank's wall ms a step, beside the
    copied closed forms (``naive_cost`` / ``sr_ag_cost`` and
    ``boundary_time`` priced for the plan's chips).  The bytes must be
    what the strategy moves: one copy each way under ``sr_ag``, tp_dst
    copies forward and tp_src back under ``naive``."""
    import statistics

    from repro_torch.core import chips, resharding as RS
    t_src, t_dst = (tp for _, tp, _, _ in stages)
    hops = res["ticks"] - 1                      # exchanges a step, each way
    steady = lambda xs: statistics.median(xs[1:] or xs)
    per_rank = lambda key: [res[f"{key}_per_step_per_rank"][r][-1]
                            for r in range(len(res["grid_per_rank"]))]
    stage_of = [g[1] for g in res["grid_per_rank"]]
    sent = per_rank("boundary_bytes")
    fwd = sum(b for b, s in zip(sent, stage_of) if s == 0) / hops
    bwd = sum(b for b, s in zip(sent, stage_of) if s == 1) / hops
    gathered = [g / hops for g in per_rank("boundary_gather_bytes")]
    if strategy == "sr_ag":
        want = (act_bytes, act_bytes)
        want_g = [RS.sr_ag_cost(act_bytes, t_dst, t_src).intra_bytes if s == 0 else
                  RS.sr_ag_cost(act_bytes, t_src, t_dst).intra_bytes for s in stage_of]
        closed = RS.sr_ag_cost(act_bytes, t_src, t_dst)
    else:
        want, want_g = (t_dst * act_bytes, t_src * act_bytes), [0] * len(stage_of)
        closed = RS.naive_cost(act_bytes, t_src, t_dst)
    src, dst = (chips.CHIPS[chip] for chip, _, _, _ in stages)
    priced = RS.boundary_time(act_bytes, t_src, t_dst, nic_bw=src.nic_bw,
                              intra_bw=dst.intra_node_bw, strategy=strategy)
    ms = lambda key, r: steady(res[key + "_per_step_per_rank"][r]) * 1e3
    log(f"  {label}: boundary a step ({hops} exchanges each way of a "
        f"{act_bytes / 2**20:.2f} MiB activation): {fwd / 2**20:.2f} MiB forward and "
        f"{bwd / 2**20:.2f} MiB back per exchange (expected {want[0] / 2**20:.2f} / "
        f"{want[1] / 2**20:.2f}); all-gather per exchange by rank "
        + ", ".join(f"{g / 2**20:.2f}" for g in gathered) + " MiB; closed forms "
        f"cross_bytes {closed.cross_bytes / 2**20:.2f} MiB, intra_bytes "
        f"{closed.intra_bytes / 2**20:.2f} MiB, boundary_time priced for chips "
        f"{src.name} -> {dst.name} {priced * 1e3:.3f} ms a hop; wall ms a step by rank: "
        + "; ".join(f"rank {r}: hops {ms('boundary_s', r):.1f} (copies "
                    f"{ms('boundary_copy_s', r):.1f}), all-gather "
                    f"{ms('boundary_gather_s', r):.1f}"
                    for r in range(len(stage_of))))
    if (fwd, bwd) != want or gathered != want_g:
        raise AssertionError(f"{label}: the boundary moved {fwd} / {bwd} bytes and "
                             f"gathered {gathered}, not {want} / {want_g}")


def phase_hetero(transport="host", runs=HETERO_RUNS):
    """Phase 18 (a), (b): qwen1.5-0.5b at full size from plans whose two
    stages disagree on tp (Σ tp_s ranks), through ``launch.train --plan
    --reshard``.  Each run's ``flash_attention`` launches a step must be
    Σ_s tp_s x stage s's launches at tp 1 (every member runs its stage's
    layers on its own heads).  Returns the runs' launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import dtype_of
    arch, b, mb, seq, args = HETERO_QWEN
    cfg = get_config(arch)
    act = mb * seq * cfg.d_model * torch.empty((), dtype=dtype_of(cfg)).element_size()
    launches = {}
    for label, stages, strategies in runs:
        tps = tuple(tp for _, tp, _, _ in stages)
        at_tp1 = [b * L * (2 if rec else 1) for _, _, L, rec in stages]
        per_step = sum(tp * n for tp, n in zip(tps, at_tp1))
        for strategy in strategies:
            run = f"hetero_{arch}_tp{tps[0]}{tps[1]}_{strategy}_{transport}"
            path = write_plan(run, pp_plan(stages, b))
            name = f"{label} tp {tps} {strategy}"
            # (a) under sr_ag traced, its exchange printed tick by tick
            traced = label == "(a)" and strategy == "sr_ag"
            layers = sum(L for _, _, L, _ in stages)
            with plan_cut(arch, layers, name):
                res = pipeline_and_check(run, ["--arch", arch, "--plan", path, "--reshard",
                                               strategy] + args, "flash_attention",
                                         per_step, layers, name, transport,
                                         trace=("1f1b", 2, (b,), True) if traced else None)
            log(f"  {name}: {per_step} flash_attention a step = "
                + " + ".join(f"{tp} x {n}" for tp, n in zip(tps, at_tp1))
                + " (tp_s x stage s's launches at tp 1)")
            boundary_report(res, name, stages, strategy, act)
            for k, v in res["launches"].items():
                launches[k] = launches.get(k, 0) + v
    return launches


def _hetero_parity_rank(rank, world, device, case, microbatches, phys, layouts, strategies):
    """Phase 18 (c) on one rank: on each grouped layout (every layout
    built first) under each strategy, in fp32, the pipeline's loss and
    the squared norms (fp64) of the synced gradient leaves this rank
    counts first (``heteropp.leaf_axes``: a stage's tp-sharded leaves on
    every member, its replicated ones on member 0, ``embed`` and
    ``final_norm`` on rank 0)."""
    import torch
    from repro_torch.comm.p2p import Grid
    from repro_torch.core import heteropp as HP
    from repro_torch.kernels import build
    from repro_torch.tree import flatten

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    build.load()
    grids = [Grid.grouped("host", dev, st) for st in layouts]
    arch, layers, mb, seq = case
    cfg, params, tokens = parity_inputs(arch, layers, "float32", mb, seq, microbatches, dev)
    out = {}
    for st, grid in zip(layouts, grids):
        for strategy in strategies:
            spec = HP.PipelineSpec(len(st), phys, microbatches, stage_tp=st,
                                   reshard=(strategy,))
            local = HP.local_stage_params(params, cfg, spec, grid.s, grid.k)
            for t in flatten(local).values():
                t.requires_grad_()
            loss, grads = HP.make_pipeline_loss(cfg, spec, grid)(local, tokens)
            dims = HP.zero1_dims(local, spec, "psum")
            grads = HP.make_grad_sync(spec, grid, "psum")(grads, dims)
            coord = {"pipe": grid.s, "tp": grid.k}
            out[f"{st} {strategy}"] = {"loss": float(loss), "sq": {
                k: float(torch.sum(torch.square(g.double())))
                for (k, g), axes in zip(flatten(grads).items(),
                                        HP.leaf_axes(local, spec, dims, grid.s))
                if all(c == 0 for a, c in coord.items() if a not in axes)}}
            del local, grads
            torch.cuda.empty_cache()
    return out


def phase_hetero_parity(device="cuda:0", microbatches=4):
    """Phase 18 (c): both grouped layouts under both strategies (three
    ranks on the card, one spawn) against the single-device ``loss_fn``
    and its gradient in fp32."""
    import torch

    arch, layers, mb, seq = HETERO_PARITY
    t0 = time.perf_counter()
    res = spawn_ranks(_hetero_parity_rank, 3, (device, HETERO_PARITY, microbatches,
                                               PP_PARITY_SPLIT, HETERO_LAYOUTS,
                                               HETERO_STRATEGIES),
                      workdir=os.path.join(ROOT, "build", "chip_smoke", "hetero_parity"),
                      transport="host", timeout=600)
    log(f"  (c) parity: the three ranks done in {time.perf_counter() - t0:.1f} s with "
        f"their start; {arch} width, {layers} layers split "
        f"{' / '.join(map(str, PP_PARITY_SPLIT))}, {microbatches} microbatches of "
        f"{mb} x {seq}, fp32")
    want, norms = single_device_grads(arch, layers, "float32", mb, seq, microbatches,
                                      torch.device(device))
    bad = []
    for st in HETERO_LAYOUTS:
        for strategy in HETERO_STRATEGIES:
            bad += hold_parity([r[f"{st} {strategy}"] for r in res], want, norms,
                               "float32", f"tp {st} {strategy}")
    if bad:
        raise AssertionError("phase 18 (c): " + "; ".join(bad))


def phase_domain():
    """Phase 19: mamba2-780m at full width (phase 17 (c)'s 8 layers) on
    a (dp 2, pipe 2) grid with the uneven batch domain (4, 3), through
    ``launch.train --plan``, one run in each dp sync mode: 7 x 8 x 2
    ``ssd_scan`` a step, and replica d's tick program its own allocation's
    (b + 1 ticks under 1f1b).  Returns the runs' launches."""
    arch, layers, full, mb, seq, args = DOMAIN_SSM
    per_step = sum(DOMAIN) * layers * 2
    launches = {}
    for name, sync, bucket in DOMAIN_SYNCS:
        run = f"domain_{arch}_{sync}_{bucket}"
        plan = pp_plan([("A", 1, layers // 2, True), ("B", 1, layers // 2, True)],
                           max(DOMAIN), dp=len(DOMAIN), batch_domain=list(DOMAIN),
                           dp_sync=sync, bucket_bytes=bucket)
        label = f"domain {DOMAIN}, {name}"
        argv = ["--plan", write_plan(run, plan)] + args + (
            ["--no-verify-plan"] if bucket == 0 else [])
        res = grid_and_check(run, arch, layers, argv, "ssd_scan", per_step, label,
                             full_layers=full,
                             trace=("1f1b", 2, DOMAIN, False) if sync == "reduce_scatter"
                             else None)
        ticks = {}
        for (d, _, _), t in zip(res["grid_per_rank"], res["ticks_per_rank"]):
            ticks.setdefault(d, set()).add(t)
        log(f"  {label}: ticks a step by replica " + ", ".join(
            f"{d}: {sorted(t)} ({DOMAIN[d]} microbatches)" for d, t in sorted(ticks.items())))
        if ticks != {d: {a + 1} for d, a in enumerate(DOMAIN)}:
            raise AssertionError(f"{label}: replicas ran {ticks} ticks, not their "
                                 f"allocations' 1f1b programs")
        if sync == "reduce_scatter":
            check_zero1_state(res, label)
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def _domain_parity_rank(rank, world, device, case, domain, phys):
    """Phase 19's parity on one rank of the (dp 2, pipe 2) grid, fp32: the
    loss and the squared norms of the gradient leaves this rank counts
    first, from the tight token layout (Σ domain microbatches); the loss
    and the largest gradient difference from it of the tight layout
    again, of the padded layout, and of the padded one with every pad
    slot overwritten."""
    import torch
    from repro_torch.comm.p2p import Grid
    from repro_torch.core import heteropp as HP
    from repro_torch.kernels import build
    from repro_torch.tree import flatten, tree_leaves

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    build.load()
    grid = Grid.build("host", dev, dp=len(domain), pipe=len(phys))
    arch, layers, mb, seq = case
    cfg, params, tokens = parity_inputs(arch, layers, "float32", mb, seq, sum(domain), dev)
    spec = HP.PipelineSpec(len(phys), phys, max(domain), data_parallel=len(domain),
                           batch_domain=domain)
    local = HP.local_stage_params(params, cfg, spec, grid.s, grid.k)
    del params
    for t in flatten(local).values():
        t.requires_grad_()
    loss_fn = HP.make_pipeline_loss(cfg, spec, grid)
    sync = HP.make_grad_sync(spec, grid, "psum")
    dims = HP.zero1_dims(local, spec, "psum")
    padded = HP.prepare_domain_tokens(spec, tokens)
    pad = torch.tensor([j >= a for a in domain for j in range(max(domain))], device=dev)
    clobbered = padded.clone()
    clobbered[pad] = (padded[pad] + 7) % cfg.vocab_size
    out = {"losses": {}, "diff": {}}
    first = None
    for name, toks in (("tight", tokens), ("tight again", tokens), ("padded", padded),
                       ("pads overwritten", clobbered)):
        loss, grads = loss_fn(local, toks)
        grads = sync(grads, dims)
        out["losses"][name] = float(loss)
        if first is None:
            first = grads
            out["loss"], out["ticks"] = float(loss), loss_fn.stats["ticks"]
            coord = {"pipe": grid.s, "dp": grid.d}
            out["sq"] = {k: float(torch.sum(torch.square(g.double())))
                         for (k, g), axes in zip(flatten(grads).items(),
                                                 HP.leaf_axes(local, spec, dims, grid.s))
                         if all(c == 0 for a, c in coord.items() if a not in axes)}
        else:
            out["diff"][name] = max(float((a - b).abs().max())
                                    for a, b in zip(tree_leaves(grads), tree_leaves(first)))
    return out


def phase_domain_parity(device="cuda:0"):
    """Phase 19's parity: the uneven domain at 4 layers in fp32 against the
    single device on the same 7 microbatches; the padded layout, and the
    padded one with its pad slots overwritten, give the tight layout's
    loss bit for bit and its gradient within what a second backward of
    the tight layout moves it (0 where the card's backward is
    deterministic)."""
    import torch

    arch, layers, mb, seq = DOMAIN_PARITY
    t0 = time.perf_counter()
    res = spawn_ranks(_domain_parity_rank, 4, (device, DOMAIN_PARITY, DOMAIN,
                                               PP_PARITY_SPLIT),
                      workdir=os.path.join(ROOT, "build", "chip_smoke", "domain_parity"),
                      transport="host", timeout=600)
    log(f"  parity: the four ranks done in {time.perf_counter() - t0:.1f} s with their "
        f"start; {arch} width, {layers} layers split {' / '.join(map(str, PP_PARITY_SPLIT))}"
        f", domain {DOMAIN} of 1 x {seq}, fp32; ticks by rank "
        f"{[r['ticks'] for r in res]}")
    want, norms = single_device_grads(arch, layers, "float32", mb, seq, sum(DOMAIN),
                                      torch.device(device))
    bad = hold_parity(res, want, norms, "float32", f"domain {DOMAIN}, psum")
    spread = max(r["diff"]["tight again"] for r in res)
    for name in ("padded", "pads overwritten"):
        diff = max(r["diff"][name] for r in res)
        same = all(r["losses"][name] == r["losses"]["tight"] for r in res)
        log(f"  {name} layout against the tight one: loss the same bit for bit: {same}; "
            f"largest gradient difference {diff:.3e} (a second tight backward: "
            f"{spread:.3e})")
        if not same or diff > spread:
            bad.append(f"the {name} layout changed the result")
    if bad:
        raise AssertionError("phase 19 parity: " + "; ".join(bad))


@contextlib.contextmanager
def stage_ranges():
    """While the context lasts, each stage of a moe block (``moe.route``,
    ``moe.dispatch``, ``moe.experts``, ``moe.combine``) and each attention
    sub-block (projections, norms, RoPE and the kernel: ``attention``)
    runs inside a ``torch.profiler.record_function`` range of that name."""
    from unittest import mock

    from torch.profiler import record_function
    from repro_torch.models import attention, moe

    def ranged(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    with contextlib.ExitStack() as stack:
        for mod, attr, name in ((moe, "route", "moe.route"),
                                (moe, "dispatch", "moe.dispatch"),
                                (moe, "expert_mlp", "moe.experts"),
                                (moe, "combine", "moe.combine"),
                                (attention, "self_attention", "attention"),
                                (attention, "decode_self_attention", "attention")):
            stack.enter_context(mock.patch.object(mod, attr, ranged(name, getattr(mod, attr))))
        yield


STAGE_RANGES = ("attention", "moe.route", "moe.dispatch", "moe.experts", "moe.combine")


# Phase 22 in bf16.  The routing is a discrete function of bf16
# activations: where the kernel path's attention output lands a bf16 step
# from the einsum path's, a token's 8th and 9th experts can swap, and at
# capacity factor 1.25 that moves which later tokens of both experts are
# dropped.  So in bf16 the kernel path is held, at phase 5's and phase 9's
# limits, with the einsum path's expert choices replayed (the gates stay
# its own probabilities at those experts, renormalised); the free-running
# kernel path is printed beside the einsum path's own spread when its
# attention takes its keys in reverse order (the same sums in another
# order).  fp32 is held free-running.
@contextlib.contextmanager
def moe_routing(routes, replay=False, rows=None):
    """While the context lasts, every ``moe.route`` call appends its expert
    ids to ``routes`` (in call order), or with ``replay`` takes the next
    recorded ids in place of its own top-k (of ``rows`` of them where
    given: a grid rank's rows of a single device's routing)."""
    from unittest import mock

    import torch
    from repro_torch.models import moe

    route = moe.route
    replayed = iter(routes)

    def recorded(params, cfg, x):
        logits, probs, gate_vals, ids = route(params, cfg, x)
        if not replay:
            routes.append(ids.clone())
            return logits, probs, gate_vals, ids
        ids = next(replayed)
        ids = (ids if rows is None else ids[rows]).to(probs.device)
        gate_vals = torch.gather(probs, -1, ids)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, gate_vals, ids

    with mock.patch.object(moe, "route", recorded):
        yield


@contextlib.contextmanager
def keys_reversed():
    """While the context lasts, the einsum attention (prefill and
    training) takes its keys, values and mask columns in reverse order."""
    from unittest import mock

    from repro_torch.models import attention

    einsum = attention._attend_einsum

    def reversed_keys(q, k, v, bias, scale, softcap=0.0):
        return einsum(q, k.flip(1), v.flip(1), bias.flip(-1), scale, softcap)

    with mock.patch.object(attention, "_attend_einsum", reversed_keys):
        yield


def range_device_ms(prof):
    """Device ms of the kernels launched inside each of ``STAGE_RANGES``
    (the CPU-side range's device time, children included), from a trace
    with CPU and CUDA activity."""
    import torch
    out = {}
    for e in prof.key_averages():
        if e.key in STAGE_RANGES and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.key] = out.get(e.key, 0.0) + (e.device_time_total or 0) / 1e3
    return {k: out.get(k, 0.0) for k in STAGE_RANGES}


def phase_moe_serve():
    """Phase 20: qwen3-moe-30b-a3b at full width and depth: one
    ``flash_attention`` a layer in the prefill, one ``flash_decode`` a
    layer in each decode call; then where the time goes (phase 6's
    method, by kernel and by stage of the blocks)."""
    import torch
    torch.cuda.empty_cache()
    log(f"  before: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    L = 48
    launches = serve_and_check(MOE_SERVE_ARGS, "serve_qwen3_moe_30b_a3b", L, lambda calls: {
        "flash_attention": L, "flash_decode": L * calls, "ssd_scan": 0, "rmsnorm": 0})
    log("  where the time goes: qwen3-moe-30b-a3b, 48 layers, traced")
    phase_profile(MOE_ARCH)
    return launches


def phase_moe_train():
    """Phase 21: qwen3-moe-30b-a3b at full width cut to 4 layers: 2 x 4
    ``flash_attention`` a step (forward and remat recompute), losses
    finite and falling; layer 0's ``moe_block`` metrics on one batch at
    the config's capacity factor; then a warm step traced."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.models import layers as L, transformer as tfm
    from repro_torch.models.moe import capacity

    n = MOE_TRAIN_LAYERS
    log(f"  {MOE_ARCH} cut to {n} of 48 layers (full width)")
    with cut_depth(n):
        launches, state = train_and_check(MOE_TRAIN_ARGS, "train_qwen3_moe_30b_a3b", n,
                                          {"flash_attention": 2 * n})
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=n)
    flag = lambda name: int(MOE_TRAIN_ARGS[MOE_TRAIN_ARGS.index(name) + 1])
    loader = make_loader(cfg, DataConfig(batch_size=flag("--batch"), seq_len=flag("--seq"),
                                         seed=7), device=torch.device("cuda"))
    with torch.no_grad():
        tokens = next(loader)["tokens"]
        x = L.embed_tokens(state.params["embed"], tokens)
        pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        _, m = tfm.block_forward(tfm.layer(state.params["blocks"], 0), cfg, x, "moe",
                                 positions=pos)
    log(f"  layer 0's moe_block on one {tuple(tokens.shape)} batch at capacity factor "
        f"{cfg.moe_capacity_factor} (C = {capacity(cfg, tokens.shape[1])} a group): "
        f"moe_drop_frac {float(m['moe_drop_frac']):.5f}, moe_aux_loss "
        f"{float(m['moe_aux_loss']):.6f}, moe_z_loss {float(m['moe_z_loss']):.6f}")
    if not all(math.isfinite(float(v)) for v in m.values()):
        raise AssertionError(f"layer 0's moe metrics are not finite: {m}")
    log("  where the time goes: a warm train step, traced")
    phase_train_profile(state, MOE_TRAIN_ARGS, "profile_train_qwen3_moe.txt", layers=n)
    del state
    torch.cuda.empty_cache()
    return launches


def phase_moe_pipeline():
    """Phase 24 (a): ``launch.train --plan`` of qwen3-moe-30b-a3b at full
    width cut to 2 layers, one a stage on chips A and B, 1f1b, two ranks
    on the card; ``flash_attention`` launches pinned, ``--trace``."""
    stages, b = MOE_PP_STAGES, 4
    log(f"  (a) {MOE_ARCH} cut to {MOE_PP_LAYERS} of 48 layers (full width), "
        f"{' / '.join(str(L) for _, L, _ in stages)}, 1f1b, {b} microbatches of 1 x 2048")
    with cut_depth(MOE_PP_LAYERS):
        res = plan_and_check(MOE_ARCH, stages, b, MOE_PP_ARGS, "1f1b", "flash_attention",
                             trace=True)
    return res["launches"]


def _moe_parity_rank(rank, world, device, case, microbatches, phys, schedules):
    """Phase 24 (b) on one rank, fp32: under each schedule the pipeline
    loss, the squared norm of each gradient leaf it counts, and its
    layers' router gradients by global layer index."""
    import numpy as np
    import torch
    from repro_torch.comm.p2p import Grid
    from repro_torch.core import heteropp as HP
    from repro_torch.core.schedules import get_schedule
    from repro_torch.kernels import build
    from repro_torch.tree import flatten

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build.load()
    grid = Grid.build("host", dev, pipe=world)
    arch, layers, mb, seq = case
    cfg, params, tokens = parity_inputs(arch, layers, "float32", mb, seq, microbatches, dev)
    out = {}
    for name in schedules:
        sched = get_schedule(name)
        spec = HP.PipelineSpec(world, HP.chunk_layer_counts(phys, sched), microbatches,
                               schedule=name, n_chunks=sched.n_chunks)
        local = HP.local_stage_params(params, cfg, spec, rank)
        for t in flatten(local).values():
            t.requires_grad_()
        loss, grads = HP.make_pipeline_loss(cfg, spec, grid)(local, tokens)
        grads = HP.make_grad_sync(spec, grid, "psum")(grads, HP.zero1_dims(local, spec, "psum"))
        router = grads["blocks"]["moe"]["router"]
        router = router[None] if spec.n_chunks == 1 else router
        bounds = np.cumsum([0] + list(spec.layers_per_stage))
        routers = {int(bounds[g]) + j: router[k, j].cpu()
                   for k, g in enumerate(HP.stage_slots(spec, rank))
                   for j in range(spec.layers_per_stage[g])}
        out[name] = {"loss": float(loss), "routers": routers,
                     "sq": {k: float(torch.sum(torch.square(g.double())))
                            for k, g in flatten(grads).items()
                            if k.startswith("blocks/") or rank == 0}}
        del local, grads
    return out


def moe_microbatch_mean(case, microbatches, dev):
    """The single device's oracle for phase 24 (b): the mean over the
    microbatches of ``loss_fn`` (its aux is not linear in the batch), its
    CE and aux parts, each leaf's gradient norm, and each layer's router
    gradient with and without its aux part."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import flatten

    arch, layers, mb, seq = case
    cfg, params, tokens = parity_inputs(arch, layers, "float32", mb, seq, microbatches, dev)
    flat = flatten(params)
    for t in flat.values():
        t.requires_grad_()
    router = params["blocks"]["moe"]["router"]
    ce = aux = 0.0
    aux_router = torch.zeros_like(router)
    for i in range(microbatches):
        total, m = M.loss_fn(params, cfg, {"tokens": tokens[i]})
        aux_router += torch.autograd.grad(m["aux_loss"] / microbatches, router,
                                          retain_graph=True)[0]
        (total / microbatches).backward()
        ce += float(m["ce_loss"].detach()) / microbatches
        aux += float(m["aux_loss"].detach()) / microbatches
    norms = {k: float(t.grad.double().norm()) for k, t in flat.items()}
    routers = router.grad.detach().cpu()
    del params, flat
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ce + aux, ce, aux, norms, routers, aux_router.cpu()


def phase_moe_pipeline_parity(device="cuda:0", microbatches=4):
    """Phase 24 (b): qwen3-moe's width at 2 layers (1 / 1), fp32, under
    1f1b and a chunked schedule, against the mean over the microbatches
    of the single-device ``loss_fn``: the loss and each leaf's gradient
    norm at phase 16 (c)'s limits, and each layer's router gradient
    within TRAIN_GNORM_RTOL of its largest entry; printed beside what the
    JAX package's SPMD pipeline, which divides the summed aux by the
    stage count, would give."""
    import torch

    case = MOE_PP_PARITY
    arch, layers, mb, seq = case
    S = len(MOE_PP_PARITY_SPLIT)
    t0 = time.perf_counter()
    res = spawn_ranks(_moe_parity_rank, S, (device, case, microbatches, MOE_PP_PARITY_SPLIT,
                                            MOE_PP_PARITY_SCHEDULES),
                      workdir=os.path.join(ROOT, "build", "chip_smoke", "moe_parity"),
                      transport="host", timeout=600)
    log(f"  (b) parity: both ranks done in {time.perf_counter() - t0:.1f} s with their "
        f"start; {arch} width, {layers} layers split "
        f"{' / '.join(map(str, MOE_PP_PARITY_SPLIT))}, {microbatches} microbatches of "
        f"{mb} x {seq}, fp32")
    want, ce, aux, norms, routers, aux_routers = moe_microbatch_mean(
        case, microbatches, torch.device(device))
    halved = ce + aux / S
    log(f"  single device, mean over the microbatches: loss {want:.7f} = CE {ce:.7f} + aux "
        f"{aux:.7f}; the JAX SPMD pipeline's aux / {S} would give {halved:.7f} "
        f"(rel {abs(halved - want) / want:.2e} from it)")
    bad = []
    for name in MOE_PP_PARITY_SCHEDULES:
        runs = [r[name] for r in res]
        bad += hold_parity(runs, want, norms, "float32", name)
        got = {i: g for r in runs for i, g in r["routers"].items()}
        for i in range(layers):
            scale = float(routers[i].abs().max())
            err = float((got[i] - routers[i]).abs().max()) / scale
            off = float((got[i] - (routers[i] - aux_routers[i] * (1 - 1 / S))).abs().max()) / scale
            log(f"  float32 {name}: layer {i}'s router gradient, max abs diff / largest "
                f"entry {err:.2e} (limit {TRAIN_GNORM_RTOL:.0e}); from the aux-halved "
                f"one {off:.2e}")
            if not err <= TRAIN_GNORM_RTOL:
                bad.append(f"{name}: layer {i}'s router gradient")
        if abs(runs[0]["loss"] - halved) <= abs(runs[0]["loss"] - want):
            bad.append(f"{name}: the loss is nearer the aux-halved value")
    if bad:
        raise AssertionError("phase 24 (b): " + "; ".join(bad))


def single_device_grads(arch, layers, dtype, mb, seq, microbatches, dev, n=None):
    """The single device's ``loss_fn`` on ``parity_inputs``' weights and
    first ``n`` (default all) microbatches: its loss and each leaf's
    gradient norm (fp64)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import flatten

    cfg, params, tokens = parity_inputs(arch, layers, dtype, mb, seq, microbatches, dev)
    flat = flatten(params)
    for t in flat.values():
        t.requires_grad_()
    loss, _ = M.loss_fn(params, cfg, {"tokens": tokens[:n].reshape(-1, seq)})
    norms = {k: float(g.double().norm())
             for k, g in zip(flat, torch.autograd.grad(loss, list(flat.values())))}
    want = float(loss.detach())
    del params, flat
    torch.cuda.empty_cache()
    return want, norms


def hold_parity(runs, want, norms, dtype, label):
    """One parity run's result a rank (its ``loss`` and the squared
    norms ``sq`` of the gradient leaves it counts) against the single
    device's loss and per-leaf gradient norms, at phase 16 (c)'s limits.
    Logs the comparison; returns what disagrees."""
    bad = []
    if len({r["loss"] for r in runs}) != 1:
        bad.append(f"{label}: losses differ between ranks")
    loss_rtol = TRAIN_LOSS_RTOL if dtype == "float32" else TRAIN_BF16_LOSS_RTOL
    rel = abs(runs[0]["loss"] - want) / abs(want)
    got = {k: math.sqrt(sum(r["sq"].get(k, 0.0) for r in runs)) for k in norms}
    worst, leaf = max((abs(got[k] - norms[k]) / max(norms[k], 1e-12), k) for k in norms)
    log(f"  {dtype} {label}: loss {runs[0]['loss']:.7f} against the single device's "
        f"{want:.7f}, rel diff {rel:.2e} (limit {loss_rtol}); worst per-leaf gradient "
        f"norm rel diff {worst:.2e} ({leaf})"
        + (f" (limit {TRAIN_GNORM_RTOL:.0e})" if dtype == "float32"
           else " (reported, not held in bf16)"))
    if not math.isfinite(rel) or rel > loss_rtol or (
            dtype == "float32" and worst > TRAIN_GNORM_RTOL):
        bad.append(f"{label}: the pipeline and the single device disagree")
    return bad


def phase_whisper_serve():
    """Phase 25: whisper-base at full width and depth, batch 8, prompt 416,
    32 tokens (the decoder's 448 positions).  The prefill launches 3 x 6
    ``flash_attention`` (6 encoder non-causal at 1500 frames, 6 decoder
    causal, 6 cross non-causal at 416 x 1500), each decode call 6
    ``flash_decode`` (self) and 6 ``flash_attention`` (cross at Sq = 1);
    then where the time goes (phase 6's method) and the measured profiler
    at full width, seq 448 (phase 12's method, launches pinned)."""
    L = WHISPER_LAYERS
    launches = serve_and_check(WHISPER_SERVE_ARGS, "serve_whisper_base", L, lambda calls: {
        "flash_attention": 3 * L + L * calls, "flash_decode": L * calls, "ssd_scan": 0,
        "rmsnorm": 0})
    log("  where the time goes: whisper-base, 6 + 6 layers, B8 x 416, traced")
    phase_profile(WHISPER_ARCH, B=8, S=416)
    log(f"  the measured auto-profiler: whisper-base at full width, seq {WHISPER_SEQ}")
    prof = phase_profiler(WHISPER_ARCH, seq=WHISPER_SEQ, iters=WHISPER_PROFILE_ITERS)
    return {k: launches[k] + prof[k] for k in launches}


def phase_whisper_train():
    """Phase 26: whisper-base at full width and depth, b 16 x 448, 6 steps,
    bf16, remat on: each step launches 2 x 18 ``flash_attention`` (the 6
    encoder, 6 self and 6 cross calls of the forward and of the remat
    recompute); losses finite and falling; then a warm step traced."""
    import torch
    L = WHISPER_LAYERS
    launches, state = train_and_check(WHISPER_TRAIN_ARGS, "train_whisper_base", L,
                                      {"flash_attention": 2 * 3 * L})
    log("  where the time goes: a warm whisper-base train step, traced")
    phase_train_profile(state, WHISPER_TRAIN_ARGS, "profile_train_whisper_base.txt")
    del state
    torch.cuda.empty_cache()
    return launches


def phase_whisper_kernel_vs_plain():
    """Phase 27: whisper-base at full depth (the model is small), the
    kernel path against the einsum path: training, 3 steps of b 16 x 448
    at phase 9's limits, and serving, prefill of b 8 x 416 + 4 decode
    steps at phase 5's limits or the einsum path's own spread with its
    keys reversed (E2E_SPREAD), each in fp32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        phase_train_kernel_vs_plain(dtype, WHISPER_ARCH, WHISPER_LAYERS, B=16, S=WHISPER_SEQ)
    for dtype in ("float32", "bfloat16"):
        phase_end_to_end(WHISPER_ARCH, WHISPER_LAYERS, dtype, B=8, S=416)


def phase_paligemma_serve():
    """Phase 28: paligemma-3b at full width and depth, batch 4 x (256 image
    + 512 prompt) + 32 tokens against an 800-slot cache.  The prefill
    launches 18 ``flash_attention`` (the image prefix bidirectional, head_dim
    256), each decode call 18 ``flash_decode`` (8 query heads on one kv head
    of 256); then where the time goes (phase 6's method: the device's idle
    share of a decode step) and the measured profiler at seq 768 (phase
    12's method, launches pinned; the reference passes it no prefix)."""
    L = PALIGEMMA_LAYERS
    launches = serve_and_check(PALIGEMMA_SERVE_ARGS, "serve_paligemma_3b", L,
                               lambda calls: {"flash_attention": L, "flash_decode": L * calls,
                                              "ssd_scan": 0, "rmsnorm": 0})
    log("  where the time goes: paligemma-3b, 18 layers, B4 x (256 + 512), traced")
    phase_profile(PALIGEMMA_ARCH, B=4, S=512)
    log(f"  the measured auto-profiler: paligemma-3b at full width, seq {PALIGEMMA_SEQ}")
    prof = phase_profiler(PALIGEMMA_ARCH, seq=PALIGEMMA_SEQ, iters=PALIGEMMA_PROFILE_ITERS)
    return {k: launches[k] + prof[k] for k in launches}


def phase_paligemma_train():
    """Phase 29: paligemma-3b at full width and depth, b 4 x 512 text
    behind 256 image tokens, bf16, remat on: each step launches 2 x 18
    ``flash_attention`` (the forward and the recompute, prefix included);
    losses finite and falling; then a warm step traced."""
    import torch
    L = PALIGEMMA_LAYERS
    launches, state = train_and_check(PALIGEMMA_TRAIN_ARGS, "train_paligemma_3b", L,
                                      {"flash_attention": 2 * L})
    log("  where the time goes: a warm paligemma-3b train step, traced")
    phase_train_profile(state, PALIGEMMA_TRAIN_ARGS, "profile_train_paligemma_3b.txt")
    del state
    torch.cuda.empty_cache()
    return launches


def phase_paligemma_kernel_vs_plain():
    """Phase 30: paligemma-3b at full width cut to 4 layers, the kernel
    path against the einsum path: training, 3 steps of b 2 x (256 image +
    256 text) at phase 9's limits, and serving, prefill of the same batch
    + 4 decode steps at phase 5's limits, each in fp32 and bf16 (bf16 held
    to the einsum path's own spread with its keys reversed where that is
    wider, as phase 27)."""
    B, S = PALIGEMMA_CUT_BATCH
    for dtype in ("float32", "bfloat16"):
        phase_train_kernel_vs_plain(dtype, PALIGEMMA_ARCH, PALIGEMMA_CUT_LAYERS, B=B, S=S)
    for dtype in ("float32", "bfloat16"):
        phase_end_to_end(PALIGEMMA_ARCH, PALIGEMMA_CUT_LAYERS, dtype, B=B, S=S)


def phase_precision_ops():
    """Phase 31: ``operator_sweep`` on the card, op x regime, held as
    ``tests/test_precision.py`` holds the reference's: every op and every
    regime present, every bf16 regime inside the tolerance, every error
    finite."""
    from repro_torch.precision import align, backends

    log(f"  matmul flags (the card's regime): {align.regime_flags()}")
    reports = align.operator_sweep(SWEEP_TOL)
    names = [n for n in backends.BACKENDS if n != "a100_ref"]
    log(f"  max_rel_err vs a100_ref (fp32), tolerance {SWEEP_TOL}: "
        + "  ".join(f"{n} ({backends.BACKENDS[n].compute_dtype}, "
                    f"{backends.BACKENDS[n].accum_chunks} chunk)" for n in names))
    got = {(r.op, r.backend): r for r in reports}
    for op in backends.OPS:
        log(f"    {op:14s} " + "  ".join(
            f"{got[op, n].max_rel_err:.3e}{'' if got[op, n].passed else ' OVER'}"
            for n in names if (op, n) in got))
    if set(got) != {(op, n) for op in backends.OPS for n in names}:
        raise AssertionError(f"operator sweep covered {sorted(got)}")
    bad = [k for k, r in got.items() if not math.isfinite(r.max_rel_err)
           or (r.backend in ("chip_a", "chip_b") and not r.passed)]
    if bad:
        raise AssertionError(f"operator sweep: {bad} not finite or over {SWEEP_TOL}")
    return reports


def phase_precision_model():
    """Phase 32: qwen1.5-0.5b at full width and depth under fp32, bf16 and
    fp16 (``align.train_loss_curve``, the card's own kernels in each
    dtype), ALIGN_ITERS iterations each from one seed on one stream:
    each regime's first and last loss, its MRE against fp32, step p50,
    peak memory and ``flash_attention`` launches a step (pinned: one a
    layer), and the share of the embedding's rows whose first gradient
    underflows to zero.  Every loss finite, and the MRE of each regime in
    ALIGN_HELD under the criterion.  Returns the launches over the three
    runs."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.precision import align

    cfg = get_config(ALIGN_ARCH)
    launches = {fn.__name__: 0 for fn in ops.KERNELS}
    curves = {}
    for dtype in ALIGN_DTYPES:
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        times = []
        curves[dtype] = align.train_loss_curve(cfg, dtype=dtype, iters=ALIGN_ITERS,
                                               batch=ALIGN_BATCH, seq=ALIGN_SEQ,
                                               times=times)
        peak = torch.cuda.max_memory_allocated()
        got = {fn.__name__: fn.launches for fn in ops.KERNELS}
        for name, n in got.items():
            launches[name] += n
        want = {"flash_attention": cfg.num_layers * ALIGN_ITERS}
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"{dtype}: launches {got} over {ALIGN_ITERS} steps, "
                                 f"expected {want}")
        c = curves[dtype]
        log(f"  {dtype:9s} losses {c[0]:.6f} -> {c[-1]:.6f} (min {c.min():.6f}); step p50 "
            f"{statistics.median(times[1:]) * 1e3:.1f} ms (first {times[0] * 1e3:.1f}); "
            f"peak {peak / 2**30:.2f} GiB; "
            f"{got['flash_attention'] // ALIGN_ITERS} flash_attention a step; "
            f"embedding rows with a zero first gradient {zero_grad_rows(cfg, dtype):.4f}")
        torch.cuda.empty_cache()
    mre = {dt: align.loss_mre(curves[dt], curves["float32"]) for dt in ALIGN_DTYPES[1:]}
    log(f"  MRE against fp32 over {ALIGN_ITERS} iterations (criterion "
        f"{align.MRE_CRITERION}): " + ", ".join(f"{dt} {v:.4e}" for dt, v in mre.items()))
    every = [float(x) for dt in ALIGN_DTYPES for x in curves[dt]]
    log("  curves (every 5th step): " + "; ".join(
        f"{dt} " + " ".join(f"{x:.4f}" for x in curves[dt][::5]) for dt in ALIGN_DTYPES))
    if not all(map(math.isfinite, every)):
        raise AssertionError("a loss of the alignment curves is not finite")
    over = {dt: v for dt, v in mre.items() if not v < align.MRE_CRITERION}
    log(f"  over the criterion: {over or 'none'} (held: {', '.join(ALIGN_HELD)}; "
        f"the others finite only)")
    if set(over) & set(ALIGN_HELD):
        raise AssertionError(f"loss-curve MRE over {align.MRE_CRITERION}: {over}")
    return launches


def zero_grad_rows(cfg, dtype):
    """The share of the tied embedding's rows whose gradient is exactly
    zero on the first batch of ``train_loss_curve``'s stream, from its
    seed-0 weights, on the card (kernel path; no step is taken)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    mcfg = dataclasses.replace(cfg, dtype=dtype)
    params = M.init_params(mcfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    leaf = params["embed"]["tok"].requires_grad_()
    batch = next(make_loader(mcfg, DataConfig(batch_size=ALIGN_BATCH, seq_len=ALIGN_SEQ,
                                              seed=1234), device=dev))
    loss, _ = M.loss_fn(params, mcfg, batch, remat=False)
    grad = torch.autograd.grad(loss, leaf)[0]
    share = float((grad.abs().amax(-1) == 0).float().mean())
    del params, leaf, grad, loss
    torch.cuda.empty_cache()
    return share


def single_run(run, arch, args, layers=None, accum=1, **fields):
    """The single-device port's run on ``args`` (the grid run's seed,
    batches and steps), ``arch`` cut to ``layers`` and ``fields`` (config
    fields: a dtype, say) replaced where given, each batch in ``accum``
    microbatches: its losses, gradient norms and step times.  A run made
    before in the process is not made again."""
    import torch
    from repro_torch.launch import train
    key = (arch, tuple(args), layers, accum, tuple(sorted(fields.items())))
    if key in _SINGLE:
        return _SINGLE[key]
    out_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    with cut_depth(layers, **fields):
        res = train.main(["--arch", arch] + args + GSPMD_ARGS[2:] + ["--run-dir", out_dir,
                                                                     "--accum", str(accum)])
    del res["state"]
    torch.cuda.empty_cache()
    _SINGLE[key] = {k: res[k] for k in ("losses", "grad_norms", "step_times_s")}
    return _SINGLE[key]


def steady(xs):
    import statistics
    return statistics.median(xs[1:] or xs)


def collectives_line(stats):
    """One rank's collectives a step by axis (median over steps 2-):
    bytes, calls and wall ms of its all-gathers, reduce-scatters,
    all-reduces."""
    part = lambda axis, kind: (f"{kind} {steady([s[f'{axis}_{kind}_bytes'] for s in stats]) / 2**20:.1f} MiB "
                               f"in {steady([s[f'{axis}_{kind}_calls'] for s in stats]):.0f} calls "
                               f"{steady([s[f'{axis}_{kind}_ms'] for s in stats]):.1f} ms")
    return "; ".join(f"{axis}: " + ", ".join(part(axis, k) for k in ("gather", "scatter", "reduce"))
                     for axis in ("data", "model", "world"))


def grid_diffs(got, want):
    """(the worst relative difference of ``got``'s losses from ``want``'s,
    that of its first step's gradient norm): two runs from the same seed
    and batches."""
    loss = max(abs(a - b) / b for a, b in zip(got["losses"], want["losses"]))
    return loss, abs(got["grad_norms"][0] - want["grad_norms"][0]) / want["grad_norms"][0]


def grid_limit(label, want, yard, fp32=None):
    """The grid's limits (on its losses, on its first gradient norm): each
    the larger of phase 9's bf16 limit and ``GRID_LOSS_SPREAD`` x the
    single device's spread of that reading between ``want`` and ``yard``
    (its run with the batch in two microbatches) and, for the gradient
    norm where given, between ``want`` and ``fp32`` (its first step in
    fp32: how far bf16's roundings move that reading)."""
    loss, gnorm = grid_diffs(yard, want)
    log(f"  {label}: single device losses {', '.join(f'{x:.4f}' for x in want['losses'])}, "
        f"first gradient norm {want['grad_norms'][0]:.6g}; with --accum 2 "
        f"{', '.join(f'{x:.4f}' for x in yard['losses'])}, {yard['grad_norms'][0]:.6g}: "
        f"spread {loss:.2e} (losses), {gnorm:.2e} (gradient norm)")
    if fp32 is not None:
        g32 = abs(want["grad_norms"][0] - fp32["grad_norms"][0]) / fp32["grad_norms"][0]
        log(f"  {label}: first gradient norm in fp32 {fp32['grad_norms'][0]:.6g}: bf16's "
            f"spread {g32:.2e}")
        gnorm = max(gnorm, g32)
    limits = tuple(max(TRAIN_BF16_LOSS_RTOL, GRID_LOSS_SPREAD * x) for x in (loss, gnorm))
    log(f"  {label}: limits max({TRAIN_BF16_LOSS_RTOL}, {GRID_LOSS_SPREAD} x spread): "
        f"losses {limits[0]:.2e}, first gradient norm {limits[1]:.2e}")
    return limits


def grid_checks(got, want, limits):
    """The grid checks that ``got`` (a grid run) fails against ``want``
    (the single device's on the same seed and batches): losses not finite
    and falling, a loss or the first gradient norm outside its limit of
    ``limits`` (``grid_limit``)."""
    loss, gnorm = grid_diffs(got, want)
    losses = got["losses"]
    failed = []
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        failed.append("losses finite and falling")
    if len(losses) != len(want["losses"]) or not loss <= limits[0]:
        failed.append("losses within the limit")
    if not gnorm <= limits[1]:
        failed.append("first gradient norm within the limit")
    return failed


def hold_grid(label, got, want, limits, ref="single device"):
    loss, gnorm = grid_diffs(got, want)
    log(f"  {label}: losses {', '.join(f'{x:.4f}' for x in got['losses'])}; {ref} "
        f"{', '.join(f'{x:.4f}' for x in want['losses'])}; worst rel diff {loss:.2e} "
        f"(limit {limits[0]:.2e}); first gradient norm {got['grad_norms'][0]:.6g} against "
        f"{want['grad_norms'][0]:.6g}, rel diff {gnorm:.2e} (limit {limits[1]:.2e})")
    failed = grid_checks(got, want, limits)
    if failed:
        raise AssertionError(f"{label}: against the {ref}, the grid fails: "
                             + "; ".join(failed))


def fp32_checks(got, want):
    """The fp32 model-axis readings of ``got`` (a grid run in fp32) against
    ``want`` (the fp32 single device's): the relative differences of the
    first loss, the first gradient norm and the second loss, and those
    outside ``FP32_LIMITS``."""
    rel = lambda a, b: abs(a - b) / abs(b)
    got_r = (rel(got["losses"][0], want["losses"][0]),
             rel(got["grad_norms"][0], want["grad_norms"][0]),
             rel(got["losses"][1], want["losses"][1]))
    names = ("fp32 first loss", "fp32 first gradient norm", "fp32 second loss")
    return got_r, [f"{n} within the limit" for n, x, lim in zip(names, got_r, FP32_LIMITS)
                   if not x <= lim]


def fp32_model_axis(label, arch, smi, fault=None):
    """Phase ``label``'s model axis in fp32 (``GSPMD_FP32``): the grid run
    (``fault`` planted where given) against the fp32 single device at the
    same cut.  Returns the failed checks."""
    fields, args = GSPMD_FP32[label]
    fields = dict(fields, dtype="float32")
    want = single_run(f"gspmd_fp32_single_{arch}", arch, args, **fields)
    got = run_grid(f"gspmd_fp32_{arch}_{fault or 'none'}", arch, None, GSPMD_FAMILY_GRID,
                   args, fault=fault, **fields)
    readings, failed = fp32_checks(got, want)
    log(f"  {label} fp32 ({', '.join(f'{k}={v}' for k, v in fields.items())}; "
        f"{' '.join(args)}) [{smi}]: losses {', '.join(f'{x:.6f}' for x in got['losses'])}, "
        f"single device {', '.join(f'{x:.6f}' for x in want['losses'])}; first gradient norm "
        f"{got['grad_norms'][0]:.7g} against {want['grad_norms'][0]:.7g}; rel diffs "
        + ", ".join(f"{x:.2e} (limit {lim:.0e})" for x, lim in zip(readings, FP32_LIMITS))
        + f"; {got['wall_s']:.1f} s")
    return failed


def run_grid(run, arch, layers, grid_args, args, fault=None, **fields):
    """A launcher run on the (data, model) grid in the phase's
    ``rank_pool`` (the launcher inside each rank, ``fault`` planted there
    when given; ``arch`` cut to ``layers`` and ``fields`` as
    ``cut_depth``), the ranks' results merged as the launcher merges its
    own, with its wall seconds."""
    from repro_torch.launch import train
    out_dir = os.path.join(ROOT, "build", "chip_smoke", run)
    argv = ["--arch", arch] + grid_args + args + GSPMD_ARGS + ["--run-dir", out_dir]
    t0 = time.perf_counter()
    with cut_depth(layers, **fields):
        outs = _POOL.call(_launcher_rank, (argv,), 1800.0) if fault is None else \
            _POOL.call(_faulty_launcher_rank, (argv, fault), 1800.0)
    res = train.merge_gspmd_results(outs)
    res["wall_s"] = time.perf_counter() - t0
    return res


def grid_and_hold(run, arch, layers, grid_args, args, per_rank, want, limits,
                  label, smi, full_layers=None):
    """A launcher run on the (data, model) grid (``run_grid``): losses
    finite, falling and with each loss and the first gradient norm within
    its limit of ``limits`` of ``want`` (the single device's run;
    ``grid_limit``), each kernel of
    ``per_rank`` launched that many times a step on each rank, each
    rank's persistent bytes equal to the rules' blocks' closed form.
    Prints the step beside the single device's, tokens/s, memory,
    collectives and the time outside them, each with the card's name and
    power limit.  Returns the merged result."""
    from repro_torch.launch import train
    cut = full_layers is not None and layers < full_layers
    if cut:
        log(f"  {label}: {arch} cut to {layers} of {full_layers} layers (full width)")
    res = run_grid(run, arch, layers if cut else None, grid_args, args)
    times, world = res["step_times_s"], len(res["grid_per_rank"])
    steps = len(res["losses"])
    if res["num_layers"] != layers:
        raise AssertionError(f"{label}: trained {res['num_layers']} layers, not {layers}")
    hold_grid(label, res, want, limits)
    for kernel, n in per_rank.items():
        if res["launches"][kernel] != n * world * steps:
            raise AssertionError(f"{label}: {kernel} launched {res['launches'][kernel]} "
                                 f"times in {steps} steps over {world} ranks, expected {n} "
                                 f"a rank a step")
    if res["state_bytes_per_rank"] != res["block_bytes_per_rank"]:
        raise AssertionError(f"{label}: state bytes by rank {res['state_bytes_per_rank']} "
                             f"are not the rules' blocks {res['block_bytes_per_rank']}")
    p50 = steady(times)
    log(f"  {label}: " + "; ".join(
        f"{kernel} {res['launches'][kernel]} launches in {steps} steps = {n} a rank a "
        f"step x {world} ranks" for kernel, n in per_rank.items())
        + "; persistent state by rank (params, master, m, v) "
        + ", ".join(f"{b / 2**20:.1f}" for b in res["state_bytes_per_rank"])
        + " MiB = the rules' blocks, exactly")
    log(f"  {label} [{smi}]: step p50 over steps 2-{steps} {p50 * 1e3:.1f} ms (all: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms); the single device's "
        f"{steady(want['step_times_s']) * 1e3:.1f} ms at the same batch; "
        f"{res['tokens_per_step'] / p50:.0f} tok/s; peak memory by rank "
        + ", ".join(f"{(b or 0) / 2**30:.2f}" for b in res["peak_mem_bytes_per_rank"])
        + f" GiB; {res['wall_s']:.1f} s of wall time")
    for r in range(world):
        rest = train.outside_collectives(res["step_times_s_per_rank"][r],
                                         res["stats_per_rank"][r])
        log(f"  {label} [{smi}]: rank {r} (d, m) {tuple(res['grid_per_rank'][r])} "
            f"collectives a step: {collectives_line(res['stats_per_rank'][r])}; outside "
            f"them {steady(rest) * 1e3:.1f} ms a step (p50)")
    _GRID_RUNS[label] = {"grid": res["grid_per_rank"], "state": res["state_bytes_per_rank"],
                         "opt": None, "stats": res["stats_per_rank"][0][-1],
                         "peaks": res["peak_mem_bytes_per_rank"]}
    return res


def phase_gspmd(smi):
    """Phases 33-35 on four ranks.  Returns the launches of each."""
    import torch
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    arch, layers, grid_args, args = GSPMD_DENSE
    log(f"== 33. the (data, model) grid, dense: {arch} at full size, {' '.join(grid_args)}, "
        f"{' '.join(args)}, 4 ranks sharing the card")
    want = single_run("gspmd_single_qwen", arch, args)
    limits33 = grid_limit("33", want, single_run("gspmd_single_qwen_accum2", arch, args,
                                                 accum=2))
    dense = grid_and_hold("gspmd_qwen", arch, layers, grid_args, args,
                          {"flash_attention": 2 * layers}, want, limits33, "33", smi)
    add(dense["launches"])

    arch, layers, full, grid_args, args = GSPMD_GQA
    log(f"== 34. the (data, model) grid, GQA: {arch} at full width, {layers} of {full} "
        f"layers, {' '.join(grid_args)}, {' '.join(args)}")
    want = single_run("gspmd_single_granite", arch, args, layers)
    limits = grid_limit("34", want, single_run("gspmd_single_granite_accum2", arch, args,
                                               layers, accum=2))
    res = grid_and_hold("gspmd_granite", arch, layers, grid_args, args,
                        {"flash_attention": 2 * layers}, want, limits, "34", smi,
                        full_layers=full)
    add(res["launches"])

    arch, model, data, B, S, steps = GSPMD_ZERO1
    log(f"== 35. ZeRO-1 (training/manual_dp.py): {arch} at full size, data {data} x "
        f"model {model}, b{B} x S{S}, {steps} steps")
    total = int(GSPMD_DENSE[3][GSPMD_DENSE[3].index("--steps") + 1])
    device = GSPMD_ARGS[GSPMD_ARGS.index("--device") + 1]
    outs = _POOL.call(_zero1_rank, (device, arch, model, data, B, S, steps, total), 1800.0)
    hold_grid("35", outs[0], {k: dense[k][:steps] for k in ("losses", "grad_norms")},
              limits33, "phase 33's grid")
    per_rank = 2 * GSPMD_DENSE[1]
    for r, o in enumerate(outs):
        if o["launches"]["flash_attention"] != per_rank * steps:
            raise AssertionError(f"35: rank {r} launched {o['launches']['flash_attention']} "
                                 f"flash_attention in {steps} steps, not {per_rank} a step")
        if o["opt_bytes"] != o["opt_closed"]:
            raise AssertionError(f"35: rank {r} holds {o['opt_bytes']} optimizer bytes, the "
                                 f"_scatter_dim closed form {o['opt_closed']}")
    add({k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]})
    p50 = steady(outs[0]["step_times_s"])
    log(f"  35: optimizer state (fp32 master, m, v) by rank " + ", ".join(
        f"{o['opt_bytes'] / 2**20:.1f}" for o in outs) + " MiB = the _scatter_dim closed "
        f"form, exactly ({outs[0]['opt_bytes'] / outs[0]['opt_full']:.4f} of the whole "
        f"state's {outs[0]['opt_full'] / 2**20:.1f} MiB); {per_rank} flash_attention a rank "
        f"a step")
    log(f"  35 [{smi}]: step p50 over steps 2-{steps} {p50 * 1e3:.1f} ms; "
        f"{B * S / p50:.0f} tok/s; peak memory by rank "
        + ", ".join(f"{o['peak'] / 2**30:.2f}" for o in outs) + " GiB")
    for r, o in enumerate(outs):
        log(f"  35 [{smi}]: rank {r} (d, m) {tuple(o['grid'])} collectives a step: "
            f"{collectives_line(o['stats'])}")
    _GRID_RUNS["35"] = {"grid": [o["grid"] for o in outs],
                        "state": [o["state_bytes"] for o in outs],
                        "opt": [o["opt_bytes"] for o in outs], "stats": outs[0]["stats"][-1],
                        "peaks": [o["peak"] for o in outs]}
    torch.cuda.empty_cache()
    return launches


def _zero1_rank(rank, world, device, arch, model, data, B, S, steps, total_steps):
    """Phase 35 on one rank: ``make_manual_dp_train_step`` on a grid of
    the pool's ranks, its blocks of the seeded state, its rows of the
    launcher's batches, the launcher's learning-rate schedule for
    ``total_steps``.  Returns the losses, gradient norms, step times,
    collectives a step, launches (from 0), peak memory and optimizer bytes
    with their closed form."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import get_config
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding import spmd
    from repro_torch.training import manual_dp
    from repro_torch.tree import tree_leaves

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build.load()
    cfg = get_config(arch)
    mesh, grid = make_local_mesh(model=model, data=data, transport="host", device=dev)
    layout = spmd.Layout(mesh, grid)
    opt = AdamWConfig(lr=3e-4, total_steps=total_steps,
                      warmup_steps=max(total_steps // 20, 5))
    step, specs = manual_dp.make_manual_dp_train_step(cfg, layout, opt)
    state = spmd.init_state(cfg, layout, specs, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    loader = make_loader(cfg, DataConfig(batch_size=B, seq_len=S, seed=1234), device=dev,
                         rows=spmd.local_rows(B, layout).numpy())
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    losses, norms, times, stats = [], [], [], []
    try:
        for _ in range(steps):
            batch = next(loader)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            if cuda:
                torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
            stats.append(dict(step.stats))
    finally:
        loader.close()
    return {"losses": losses, "grad_norms": norms, "step_times_s": times, "stats": stats,
            "launches": {fn.__name__: fn.launches for fn in ops.KERNELS},
            "peak": torch.cuda.max_memory_allocated(dev) if cuda else 0,
            "grid": [grid.d, grid.k],
            "opt_bytes": sum(t.numel() * t.element_size()
                             for t in tree_leaves(state.opt_state)),
            "state_bytes": spmd.state_bytes(state),
            "opt_closed": manual_dp.optimizer_bytes(cfg, layout),
            "opt_full": 12 * M.param_count(M.abstract_params(cfg))}


def phase_gspmd_ssm(smi):
    """Phase 36 on two ranks: model axis 1, an ssm model cut in depth,
    held to the single device at the cut.  Returns its launches."""
    arch, layers, full, grid_args, args = GSPMD_SSM
    want = single_run("gspmd_single_mamba2", arch, args, layers)
    limits = grid_limit("36", want, single_run("gspmd_single_mamba2_accum2", arch, args,
                                               layers, accum=2))
    res = grid_and_hold("gspmd_mamba2", arch, layers, grid_args, args,
                        {"ssd_scan": 2 * layers}, want, limits, "36", smi, full_layers=full)
    return res["launches"]


def family_reference(label, arch, cut, args, single):
    """(the single device's run phase ``label``'s grid is held to, the
    grid's limits): the first steps of the earlier phase's run ``single``
    where given, else a run made here at ``arch``'s cut (``cut`` layers,
    or its full depth); the limits from its runs with the batch in two
    microbatches and, for the gradient norm, its first step in fp32."""
    steps = int(args[args.index("--steps") + 1])
    if single is not None:
        want = {k: v[:steps] for k, v in _SINGLE[single].items()}
    else:
        want = single_run(f"gspmd_single_{arch}", arch, args, cut)
    yard = single_run(f"gspmd_single_{arch}_accum2", arch, args, cut, accum=2)
    one = list(args)
    one[one.index("--steps") + 1] = "1"
    fp32 = single_run(f"gspmd_single_{arch}_fp32", arch, one, cut, dtype="float32")
    return want, grid_limit(label, want, yard, fp32)


def phase_gspmd_families(smi):
    """Phases 37-40 on four ranks: the model axis of the moe, ssm, hybrid
    and audio families, each held to the single device by phase 33's
    checks.  Returns their launches."""
    import torch
    launches = {}
    for label, arch, layers, full, args, single, per_rank, shapes in GSPMD_FAMILIES:
        cut = layers if layers < full else None
        log(f"== {label}. the (data, model) grid, {arch}: full width, {layers} of {full} "
            f"layers, {' '.join(GSPMD_FAMILY_GRID)}, {' '.join(args)}, 4 ranks sharing the "
            f"card; a member's share: {shapes}")
        want, limits = family_reference(label, arch, cut, args, single)
        res = grid_and_hold(f"gspmd_{arch}", arch, layers, GSPMD_FAMILY_GRID, args, per_rank,
                            want, limits, label, smi, full_layers=full)
        if not all(s["model_reduce_bytes"] > 0 for r in res["stats_per_rank"] for s in r):
            raise AssertionError(f"{label}: a rank's step summed nothing over the model axis")
        if label in GSPMD_FP32:
            failed = fp32_model_axis(label, arch, smi)
            if failed:
                raise AssertionError(f"{label}: the model axis in fp32 fails: "
                                     + "; ".join(failed))
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    return launches


class _OwnSlice:
    """A data group whose reduce-scatter keeps this rank's slice of its own
    tensor and whose all-reduce leaves it as it is (the ``data-sum``
    fault)."""

    def __init__(self, comm):
        self.comm, self.world_size, self.rank = comm, comm.world_size, comm.rank

    def reduce_scatter_(self, t, dim):
        w = t.shape[dim] // self.world_size
        return t.narrow(dim, self.rank * w, w).contiguous()

    def all_reduce_(self, t):
        return t


@contextlib.contextmanager
def planted(fault):
    """``fault`` (a key of ``GRID_FAULTS``) planted in this process's
    ``repro_torch`` while the context lasts."""
    import torch
    from repro_torch.core import heteropp as HP
    from repro_torch.sharding import spmd
    if fault == "data-sum":
        reduce = spmd.Layout.reduce

        def unsummed(self, full, spec, **kw):
            real = self.grid.dp
            self.grid.dp = None if real is None else _OwnSlice(real)
            try:
                return reduce(self, full, spec, **kw)
            finally:
                self.grid.dp = real

        owner, name, new = spmd.Layout, "reduce", unsummed
    elif fault == "rows":
        owner, name = spmd, "local_rows"
        new = lambda batch_size, layout, accum_steps=1: torch.arange(
            batch_size // layout.data)
    elif fault == "megatron":
        owner, name = HP._TPReduce, "forward"
        new = staticmethod(lambda ctx, x, comm: x.contiguous().clone())
    elif fault == "experts":
        owner, name, new = spmd, "_experts_sum", lambda y, tp: y
    elif fault == "ssm-norm":
        owner, name = spmd, "_norm_mean_sq"
        new = lambda xf, tp: xf.square().mean(dim=-1, keepdim=True)
    elif fault == "combine":
        owner, name, new = spmd, "combine_partials", lambda out, lse, tp: out
    elif fault == "slot0":
        from repro_torch.models import attention
        real = attention.decode_on_block
        owner, name = attention, "decode_on_block"
        new = lambda *a, slot0, **kw: real(*a, slot0=0, **kw)
    elif fault == "ssm-out":
        owner, name, new = spmd.ServeGather, "ssm_out", lambda self, blocks, cache: None
    elif fault == "cross-lse":
        owner, name = spmd, "combine_partials"
        new = lambda out, lse, tp: spmd._all_gather(tp, out.float()[None], 0).sum(0).to(
            out.dtype)
    elif fault == "whole-sum":
        real = spmd.member_cut

        def summed(cfg, M, k):
            cut, whole = real(cfg, M, k), spmd.whole_parts(cfg, M)
            # the whole leaf as a member's "part": its gradient is summed
            return lambda path, shape: (-1, [(0, shape[-1])]) \
                if spmd.part_of(path) in whole else cut(path, shape)

        owner, name, new = spmd, "member_cut", summed
    else:
        raise ValueError(f"unknown fault {fault!r}")
    old = owner.__dict__[name]
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _faulty_launcher_rank(rank, world, argv, fault):
    """``_launcher_rank`` with ``fault`` planted in this rank."""
    with planted(fault):
        return _launcher_rank(rank, world, argv)


def grid_fault_controls(label, arch, grid_args, args, want, limits, smi, layers=None):
    """Phase ``label``'s grid run (``arch`` cut to ``layers`` where given)
    with no fault, then with each fault of ``GRID_FAULTS`` that lists the
    phase, each held to ``want`` (the single device's) by the phase's
    checks, its fp32 model-axis check among them where it has one.
    Returns the failures: the run without a fault refused, or a faulty
    run passing every check."""
    bad = []
    faults = [None] + [f for f, (_, phases) in GRID_FAULTS.items() if label in phases]
    for fault in faults:
        res = run_grid(f"faults_{label}_{fault or 'none'}", arch, layers, grid_args, args,
                       fault=fault)
        loss, gnorm = grid_diffs(res, want)
        failed = grid_checks(res, want, limits)
        what = "no fault" if fault is None else f"{fault} ({GRID_FAULTS[fault][0]})"
        log(f"  {label}, {what} [{smi}]: losses "
            f"{', '.join(f'{x:.4f}' for x in res['losses'])}; worst rel diff {loss:.2e} "
            f"(limit {limits[0]:.2e}); first gradient norm {res['grad_norms'][0]:.6g}, rel "
            f"diff {gnorm:.2e} (limit {limits[1]:.2e}); {res['wall_s']:.1f} s")
        if label in GSPMD_FP32:
            failed += fp32_model_axis(label, arch, smi, fault)
        log(f"  {label}, {fault or 'no fault'}: refused by: {'; '.join(failed) or 'nothing'}")
        if (fault is None) == bool(failed):
            bad.append(f"{label} {fault or 'without a fault'}: "
                       + ("refused" if failed else "passes every check"))
    return bad


def phase_grid_faults(smi):
    """``--grid-faults``: the controls of phases 33, 36, 37 and 38's checks."""
    bad = []
    arch, _, grid_args, args = GSPMD_DENSE
    log(f"== 33 (controls): {arch} at full size, {' '.join(grid_args)}, {' '.join(args)}, "
        f"4 ranks sharing the card, with each fault planted")
    want = single_run("gspmd_single_qwen", arch, args)
    limits = grid_limit("33", want, single_run("gspmd_single_qwen_accum2", arch, args,
                                               accum=2))
    with rank_pool(4):
        bad += grid_fault_controls("33", arch, grid_args, args, want, limits, smi)
    arch, layers, full, grid_args, args = GSPMD_SSM
    log(f"== 36 (controls): {arch} at full width, {layers} of {full} layers, "
        f"{' '.join(grid_args)}, {' '.join(args)}, 2 ranks sharing the card, with each "
        "fault planted")
    want = single_run("gspmd_single_mamba2", arch, args, layers)
    limits = grid_limit("36", want, single_run("gspmd_single_mamba2_accum2", arch, args,
                                               layers, accum=2))
    with rank_pool(2):
        bad += grid_fault_controls("36", arch, grid_args, args, want, limits, smi,
                                   layers=layers)
    with rank_pool(4):
        for label, arch, layers, full, args, *_ in GSPMD_FAMILIES:
            if not any(label in phases for _, phases in GRID_FAULTS.values()):
                continue
            cut = layers if layers < full else None
            log(f"== {label} (controls): {arch} at full width, {layers} of {full} layers, "
                f"{' '.join(GSPMD_FAMILY_GRID)}, {' '.join(args)}, 4 ranks sharing the "
                f"card, with each fault planted")
            want, limits = family_reference(label, arch, cut, args, None)
            bad += grid_fault_controls(label, arch, GSPMD_FAMILY_GRID, args, want, limits,
                                       smi, layers=cut)
    log("== 42 (controls): " + "; ".join(
        f"{c[0]} {c[1]} at full width, {c[2]} layers" for c in GRID_SERVE
        if c[0] in SERVE_FAULT_CASES) + ", data 2 x model 2, 4 ranks sharing the card, with "
        "each serve fault planted")
    with rank_pool(4):
        bad += phase_serve_faults(smi)
    log(f"== 44 (controls): {STARCODER_ARCH} at full width, 1 of {STARCODER_LAYERS} layers, "
        f"data 1 x model {UNDIVIDED_MODEL}, one train step, with each fault planted")
    with rank_pool(UNDIVIDED_MODEL):
        bad += phase_undivided_faults(smi)
    if bad:
        raise AssertionError("grid fault controls: " + "; ".join(bad))


def grid_estimate_cases():
    """Phase 41's runs to estimate: (label, arch, config fields, data,
    model, batch, seq, dp mode, remat policy) of each grid phase of 33-40
    at its cut, and of (b)'s single device under each policy."""
    arg = lambda args, flag: int(args[args.index(flag) + 1])
    grid = lambda args: (arg(args, "--data-parallel"), arg(args, "--model-parallel"))
    cut = lambda arch, layers, full: {"num_layers": layers} if layers < full else {}
    arch, layers, grid_args, args = GSPMD_DENSE
    cases = [("33", arch, {}, *grid(grid_args), arg(args, "--batch"), arg(args, "--seq"),
              "gspmd", None)]
    arch, layers, full, grid_args, args = GSPMD_GQA
    cases.append(("34", arch, cut(arch, layers, full), *grid(grid_args), arg(args, "--batch"),
                  arg(args, "--seq"), "gspmd", None))
    arch, model, data, B, S, _ = GSPMD_ZERO1
    cases.append(("35", arch, {}, data, model, B, S, "manual", None))
    arch, layers, full, grid_args, args = GSPMD_SSM
    cases.append(("36", arch, cut(arch, layers, full), *grid(grid_args), arg(args, "--batch"),
                  arg(args, "--seq"), "gspmd", None))
    for label, arch, layers, full, args, *_ in GSPMD_FAMILIES:
        cases.append((label, arch, cut(arch, layers, full), *grid(GSPMD_FAMILY_GRID),
                      arg(args, "--batch"), arg(args, "--seq"), "gspmd", None))
    args = DENSE_TRAIN_ARGS
    for policy in ("full", "dots"):
        cases.append((f"41 {policy}", args[args.index("--arch") + 1], {}, 1, 1,
                      arg(args, "--batch"), arg(args, "--seq"), "gspmd",
                      None if policy == "full" else policy))
    return cases


def _estimate_cases(path):
    """The estimates of ``grid_estimate_cases`` on the host's CPU (no
    card: the process sees none), each with every rank's persistent and
    optimizer bytes, written to ``path`` as JSON as each is made."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(2)
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import Mesh
    out = {}
    for label, arch, fields, data, model, B, S, mode, policy in grid_estimate_cases():
        t0 = time.perf_counter()
        try:
            cfg = dataclasses.replace(get_config(arch), **fields)
            mesh = Mesh.of((data, model), ("data", "model"))
            rec = dryrun.estimate(cfg, mesh, shapes.InputShape(label, "train", S, B),
                                  dp_mode=mode, remat_policy=policy)
            rec["ranks"] = {f"{d},{k}": dryrun.rank_state_bytes(cfg, mesh, (d, k), mode)
                            for d in range(data) for k in range(model)}
        except Exception:
            rec = {"error": traceback.format_exc()}
        rec["host_s"] = time.perf_counter() - t0
        out[label] = rec
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)
    for case, kind, seq, cache_len in serve_estimate_cases():
        label = case[0]
        t0 = time.perf_counter()
        try:
            cfg, _ = serve_case_cfg(case)
            rec = dryrun.estimate_serve(cfg, Mesh.of((2, 2), ("data", "model")),
                                        shapes.InputShape(label, kind, seq, GRID_SERVE_BATCH),
                                        cache_len=cache_len)
        except Exception:
            rec = {"error": traceback.format_exc()}
        rec["host_s"] = time.perf_counter() - t0
        out[f"42 {label} {kind}"] = rec
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)
    # phase 44 (b), (c) on data 1 x model 3: the train step, the prefill and
    # a decode step
    mesh = Mesh.of((1, UNDIVIDED_MODEL), ("data", "model"))
    jobs = [(f"44 {c[0]} train", c, "train", None) for c in UNDIVIDED_TRAIN
            if c[3] == "bfloat16"]
    jobs += [(f"44 {c[0]} {kind}", c, kind, (seq, cache_len))
             for c, kind, seq, cache_len in undivided_serve_estimate_cases()]
    for key, case, kind, serve in jobs:
        t0 = time.perf_counter()
        try:
            if serve is None:
                cfg = undivided_train_cfg(case)
                rec = dryrun.estimate(cfg, mesh, shapes.InputShape(key, "train", case[5],
                                                                   case[4]))
                rec["ranks"] = {f"0,{k}": dryrun.rank_state_bytes(cfg, mesh, (0, k))
                                for k in range(UNDIVIDED_MODEL)}
            else:
                cfg, _ = serve_case_cfg(case)
                rec = dryrun.estimate_serve(cfg, mesh, shapes.InputShape(
                    key, kind, serve[0], GRID_SERVE_BATCH), cache_len=serve[1])
        except Exception:
            rec = {"error": traceback.format_exc()}
        rec["host_s"] = time.perf_counter() - t0
        out[key] = rec
        with open(path + ".tmp", "w") as f:
            json.dump(out, f)
        os.replace(path + ".tmp", path)


class Estimator:
    """``_estimate_cases`` in a process of its own, started at once, so
    that its host seconds pass while the card runs other phases."""

    def __init__(self):
        import multiprocessing
        out_dir = os.path.join(ROOT, "build", "chip_smoke")
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "dryrun_estimates.json")
        if os.path.exists(self.path):
            os.remove(self.path)
        self.proc = multiprocessing.get_context("spawn").Process(
            target=_estimate_cases, args=(self.path,), daemon=True)
        self.proc.start()

    def result(self, timeout=600.0):
        self.proc.join(timeout)
        if self.proc.is_alive() or self.proc.exitcode != 0:
            raise AssertionError(f"41: the estimates' process "
                                 f"{'did not end' if self.proc.is_alive() else 'failed'} "
                                 f"(exit code {self.proc.exitcode})")
        with open(self.path) as f:
            return json.load(f)

    def close(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(10)


def hold_estimate(label, est, got, smi, part="41 (a)"):
    """Phase 41 (a) (or ``part``) for one grid phase: the estimate ``est``
    against what the phase measured (``got``).  Returns the checks it
    fails."""
    from repro_torch.launch import dryrun
    failed = []
    if "error" in est:
        return [f"{label}: the estimate failed: {est['error'].strip().splitlines()[-1]}"]
    for r, (d, k) in enumerate(got["grid"]):
        state, opt = est["ranks"][f"{d},{k}"]
        if got["state"][r] != state:
            failed.append(f"{label}: rank ({d}, {k}) holds {got['state'][r]} persistent bytes, "
                          f"the estimate {state}")
        if got["opt"] is not None and got["opt"][r] != opt:
            failed.append(f"{label}: rank ({d}, {k}) holds {got['opt'][r]} optimizer bytes, "
                          f"the estimate {opt}")
    measured = dryrun.collectives(got["stats"])
    for axis, kinds in est["collectives"].items():
        for kind, want in kinds.items():
            if measured[axis][kind] != want:
                failed.append(f"{label}: rank 0's {axis} {kind} a step {measured[axis][kind]}, "
                              f"the estimate {want}")
    ratios = [est["peak_bytes"] / p for p in got["peaks"]]
    if not all(PEAK_BAND[0] <= x <= PEAK_BAND[1] for x in ratios):
        failed.append(f"{label}: the estimated peak over the measured ones "
                      f"{', '.join(f'{x:.3f}' for x in ratios)}, outside {PEAK_BAND}")
    coll = "; ".join(f"{axis} " + ", ".join(
        f"{kind} {v['bytes'] / 2**20:.1f} MiB in {v['calls']}" for kind, v in kinds.items())
        for axis, kinds in est["collectives"].items())
    log(f"  {part} {label}: persistent bytes by rank "
        + ", ".join(f"{b / 2**20:.1f}" for b in got["state"]) + " MiB"
        + ("; ZeRO-1 optimizer bytes by rank " + ", ".join(
            f"{b / 2**20:.1f}" for b in got["opt"]) + " MiB" if got["opt"] else "")
        + f"; rank 0's collectives a step: {coll}: "
        + ("the estimate's, exactly" if not failed else "see below"))
    log(f"  {part} {label} [{smi}]: peak: estimate {est['peak_bytes'] / 2**30:.3f} GiB, "
        f"measured by rank " + ", ".join(f"{p / 2**30:.3f}" for p in got["peaks"])
        + " GiB; ratios " + ", ".join(f"{x:.3f}" for x in ratios)
        + f" (band {PEAK_BAND[0]}-{PEAK_BAND[1]}); estimated {est['flops'] / 1e12:.2f} TFLOP "
        f"and {est['bytes'] / 1e9:.1f} GB of operand traffic a step; {est['host_s']:.1f} s "
        "on the host")
    return failed


def phase_dryrun(smi):
    """Phase 41: (a) the estimate of every grid phase of 33-40 held to
    what the phase measured (``hold_estimate``); (b) phase 11's run under
    ``--remat-policy dots``: the same losses, more memory, the step p50s
    and the estimate's peaks beside them.  Returns (b)'s launches."""
    import torch
    est = _ESTIMATOR.result()
    failed = []
    for label in [c[0] for c in grid_estimate_cases() if not c[0].startswith("41")]:
        failed += hold_estimate(label, est[label], _GRID_RUNS[label], smi)
    launches, state = train_and_check(DENSE_TRAIN_ARGS + ["--remat-policy", "dots"],
                                      "dryrun_qwen_dots", 24, {"flash_attention": 2 * 24})
    del state
    torch.cuda.empty_cache()
    full, dots = _SINGLE["train_qwen1p5_0p5b"], _SINGLE["dryrun_qwen_dots"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(dots["losses"], full["losses"]))
    peaks = (_PEAKS["train_qwen1p5_0p5b"], _PEAKS["dryrun_qwen_dots"])
    guess = tuple(est[f"41 {p}"].get("peak_bytes", float("nan")) for p in ("full", "dots"))
    log(f"  41 (b) [{smi}]: qwen1.5-0.5b b2 x S1024, full (phase 11) and dots: losses "
        f"{', '.join(f'{x:.6f}' for x in full['losses'])} and "
        f"{', '.join(f'{x:.6f}' for x in dots['losses'])}, worst rel diff {rel:.2e} (limit "
        f"{DOTS_LOSS_RTOL:.0e}); step p50 {steady(full['step_times_s']) * 1e3:.1f} and "
        f"{steady(dots['step_times_s']) * 1e3:.1f} ms; peak {peaks[0] / 2**30:.3f} and "
        f"{peaks[1] / 2**30:.3f} GiB, the estimate {guess[0] / 2**30:.3f} and "
        f"{guess[1] / 2**30:.3f} GiB (ratios {guess[0] / peaks[0]:.3f}, "
        f"{guess[1] / peaks[1]:.3f})")
    if not rel <= DOTS_LOSS_RTOL:
        failed.append(f"41 (b): dots' losses {rel:.2e} from full's")
    if not peaks[1] > peaks[0]:
        failed.append("41 (b): dots holds no more memory than full")
    if failed:
        raise AssertionError("41: " + "; ".join(failed))
    return launches


def serve_case_cfg(case):
    """(config, steps) of a ``GRID_SERVE`` case: the arch at full width cut
    to its layers (a hybrid model's in one group, an audio model's
    encoder to as many), in its dtype."""
    from repro_torch.configs import get_config
    _, arch, layers, _, dtype, *_ = case
    steps = GRID_SERVE_FP32_STEPS if dtype == "float32" else GRID_SERVE_STEPS
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, hybrid_attn_every=layers)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, num_encoder_layers=layers)
    return cfg, steps


def serve_prompt(cfg):
    """Phase 42's prompt length: ``GRID_SERVE_PROMPT``, or where the model's
    positions end sooner (whisper's 448) what leaves room for the
    ``GRID_SERVE_GEN`` tokens."""
    return min(GRID_SERVE_PROMPT, cfg.max_seq_len - GRID_SERVE_GEN)


def serve_gen(case):
    """The decode slots a case's cache holds past its prompt:
    ``GRID_SERVE_GEN``, or the arch's own in ``SERVE_GEN``."""
    return SERVE_GEN.get(case[1], GRID_SERVE_GEN)


def serve_prompts(cfg, dev):
    """The seeded prompts of phase 42 (a vlm model's image embeddings and
    an audio model's frames from the same stream), on ``dev``."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    toks = SyntheticTokens(cfg, DataConfig(batch_size=GRID_SERVE_BATCH,
                                           seq_len=serve_prompt(cfg))).next_batch()
    return {k: torch.from_numpy(v).to(dev) for k, v in toks.items()}


def single_serve(case, feed=None, routes=None, **fields):
    """The single device's serve steps (``training/serve_step.py``) at a
    ``GRID_SERVE`` case's cut (config ``fields`` replaced where given): the
    prefill's and each decode step's logits (on the host, fp32), the
    tokens fed (``feed``, or else its own greedy tokens), its prefill ms
    and decode step times; ``routes``, where given, gets a moe model's
    routing of each call (``moe_routing``)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import serve_step as SS
    cfg, steps = serve_case_cfg(case)
    cfg = dataclasses.replace(cfg, **fields)
    dev = torch.device("cuda")
    record = moe_routing(routes) if routes is not None else contextlib.nullcontext()
    with torch.inference_mode(), record:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        batch = serve_prompts(cfg, dev)
        cache_len = serve_prompt(cfg) + serve_gen(case)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = SS.make_prefill_step(cfg, cache_len)(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        decode, _ = SS.make_decode_step(cfg, cache_len + cfg.num_prefix_tokens)
        pos = serve_prompt(cfg) + cfg.num_prefix_tokens
        out, times = [logits.float().cpu()], []
        own, feed = feed, []
        for i in range(steps):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None] if own is None \
                else own[i].to(dev)
            feed.append(tok.cpu())
            t0 = time.perf_counter()
            logits, _, cache = decode(params, cache, tok, pos + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            out.append(logits.float().cpu())
    del params, cache
    torch.cuda.empty_cache()
    return {"logits": out, "feed": feed, "prefill_s": prefill_s, "decode_s": times}


def _grid_serve_rank(rank, world, cases, feeds, routes, fault=None):
    """Phase 42 on one rank: each ``GRID_SERVE`` case's prefill and decode
    steps on the (data 2, model 2) grid of the ranks (``serve_on_rank``),
    a moe case with the single device's routing ``routes`` replayed,
    ``fault`` planted where given."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import spmd
    dev = torch.device("cuda")
    layout = spmd.Layout(*make_local_mesh(model=2, data=2, transport="host", device=dev))
    rows = spmd.local_rows(GRID_SERVE_BATCH, layout, serving=True)
    out = {}
    with planted(fault) if fault else contextlib.nullcontext():
        for case in cases:
            label = case[0]
            replay = moe_routing(list(routes[label]), replay=True, rows=rows) \
                if label in routes else contextlib.nullcontext()
            with replay:
                out[label] = serve_on_rank(case, layout, rows, feeds[label])
            torch.cuda.empty_cache()
    return out


def serve_on_rank(case, layout, rows, feed):
    """One ``GRID_SERVE`` case on this rank: its blocks of the seeded
    weights, its ``rows`` of the prompts, the prefill and the decode steps
    fed ``feed``.  Returns its grid coordinate, rows, logits (fp32, on the
    host), times, peak memory and launches of each call, its argument and
    cache bytes and the last call's collectives of the prefill and of a
    decode step."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sharding import spmd
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    launches = lambda: {fn.__name__: fn.launches for fn in ops.KERNELS}
    cfg, steps = serve_case_cfg(case)
    cache_len = serve_prompt(cfg) + serve_gen(case)
    params = spmd.init_params(cfg, layout, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    batch = {k: v[rows.to(dev)] for k, v in serve_prompts(cfg, dev).items()}
    prefill = spmd.make_prefill_step(cfg, layout, cache_len, batch=GRID_SERVE_BATCH)
    decode = spmd.make_decode_step(cfg, layout, cache_len + cfg.num_prefix_tokens,
                                   batch=GRID_SERVE_BATCH)
    res = {"coord": (layout.grid.d, layout.grid.k), "rows": rows.tolist(),
           "prefill_args": nbytes(tree_leaves(params)) + nbytes(batch.values())}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, _, cache = prefill(params, batch)
    torch.cuda.synchronize()
    res.update(prefill_s=time.perf_counter() - t0, prefill_stats=prefill.stats,
               prefill_peak=torch.cuda.max_memory_allocated(), prefill_launches=launches(),
               logits=[logits.float().cpu()], cache_bytes=spmd.cache_bytes(cache),
               cache_closed=spmd.cache_block_bytes(cfg, layout, GRID_SERVE_BATCH,
                                                   max(decode.plan["cache_len"], 1)))
    # the decode's arguments: the weights it reads (spmd.decode_params) and,
    # as the reference's, the int32 position where its step reads it (not an
    # ssm model's)
    res["decode_args"] = nbytes(tree_leaves(spmd.decode_params(cfg, params))) + \
        res["cache_bytes"] + nbytes([feed[0][rows]]) + (4 if cfg.family != "ssm" else 0)
    del logits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    pos, times = serve_prompt(cfg) + cfg.num_prefix_tokens, []
    for i in range(steps):
        tok = feed[i][rows].to(dev)
        t0 = time.perf_counter()
        logits, _, cache = decode(params, cache, tok, pos + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        res["logits"].append(logits.float().cpu())
    res.update(decode_s=times, decode_stats=decode.stats,
               decode_peak=torch.cuda.max_memory_allocated(), decode_launches=launches())
    return res


def grid_serve_checks(case, outs, want):
    """Phase 42's checks of one case (every rank's result in ``outs``)
    against the single device's (``want``): the failed ones, and the
    worst logits reading of each call (rel L2, max abs)."""
    label, _, _, _, dtype, per_prefill, per_decode, _ = case
    cfg, steps = serve_case_cfg(case)
    failed, worst = [], [(0.0, 0.0)] * (steps + 1)
    for o in outs:
        got = o[label]
        if got["cache_bytes"] != got["cache_closed"]:
            failed.append(f"rank {got['coord']}'s cache bytes the closed form")
        for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            b = b[got["rows"]]
            rel = float((a - b).norm() / b.norm())
            mx = float((a - b).abs().max())
            worst[i] = (max(worst[i][0], rel), max(worst[i][1], mx))
            limit = want["limits"][i]
            if not bool(a.isfinite().all()) or not rel <= limit:
                failed.append(f"rank {got['coord']}'s "
                              + ("prefill" if i == 0 else f"decode step {i - 1}")
                              + f" logits within rel L2 {limit:.0e}")
        for name, n in per_prefill.items():
            if got["prefill_launches"][name] != n:
                failed.append(f"{name} launched {got['prefill_launches'][name]} times in a "
                              f"prefill on rank {got['coord']}, not {n}")
        for name, n in per_decode.items():
            if got["decode_launches"][name] != n * steps:
                failed.append(f"{name} launched {got['decode_launches'][name]} times in "
                              f"{steps} decode steps on rank {got['coord']}, not {n} a step")
    return failed, worst


def serve_report(case, outs, want, worst, smi, phase="42"):
    """Phase 42's (or ``phase``'s) readings of one case, beside the card's
    name and limit."""
    label, arch, layers, full, dtype, per_prefill, per_decode, held = case
    log(f"  {phase} {label}: {arch} at full width, {layers} of {full} layers, {dtype}; a member "
        f"holds {held}; cache bytes by rank "
        + ", ".join(f"{o[label]['cache_bytes'] / 2**20:.2f}" for o in outs)
        + " MiB = the rules' blocks' closed form, exactly")
    log(f"  {phase} {label}: logits against the single device{want['how']}, worst over the "
        "ranks: " + "; ".join(
            ("prefill" if i == 0 else f"step {i - 1}") + f" rel L2 {r:.3e} (limit "
            f"{lim:.2e}; max abs {m:.3e})"
            for i, ((r, m), lim) in enumerate(zip(worst, want["limits"]))))
    log(f"  {phase} {label}: launches a rank: " + ", ".join(
        f"{k} {outs[0][label]['prefill_launches'][k]} a prefill" for k in per_prefill)
        + "".join(f", {k} {outs[0][label]['decode_launches'][k]} in "
                  f"{len(outs[0][label]['decode_s'])} decode steps" for k in per_decode))
    log(f"  {phase} {label} [{smi}]: prefill by rank "
        + ", ".join(f"{o[label]['prefill_s'] * 1e3:.1f}" for o in outs)
        + f" ms (the single device {want['prefill_s'] * 1e3:.1f} ms); decode p50 by rank "
        + ", ".join(f"{steady(o[label]['decode_s']) * 1e3:.1f}" for o in outs)
        + f" ms (the single device {steady(want['decode_s']) * 1e3:.1f} ms); peak memory by "
        "rank, prefill " + ", ".join(f"{o[label]['prefill_peak'] / 2**30:.3f}" for o in outs)
        + ", decode " + ", ".join(f"{o[label]['decode_peak'] / 2**30:.3f}" for o in outs)
        + " GiB")
    for what in ("prefill", "decode"):
        log(f"  {phase} {label} [{smi}]: rank 0's collectives a {what} call: "
            + collectives_line([outs[0][label][f"{what}_stats"]]))
        st = outs[0][label][f"{what}_stats"]
        if st["reblock_data_calls"] + st["reblock_model_calls"] or st["copy_bytes"]:
            log(f"  {phase} {label}: of them the ssm cache's moves, data "
                f"{st['reblock_data_bytes'] / 2**20:.2f} MiB in {st['reblock_data_calls']}, "
                f"model {st['reblock_model_bytes'] / 2**20:.2f} MiB in "
                f"{st['reblock_model_calls']}; the cross cache's blocks copied for "
                f"flash_decode {st['copy_bytes'] / 2**20:.2f} MiB")


def serve_reference(case):
    """The single device's run of a ``GRID_SERVE`` case and its limits on
    each call's logits (rel L2): fp32 ``GRID_SERVE_FP32_RTOL``; bf16 phase
    5's, or for an ssm model the larger of it and ``E2E_SPREAD`` x the
    single device's own spread fed the same tokens: at SSD chunk / 2 and /
    4 (phase 14's), and in fp32 (how far bf16's roundings move the logits,
    phases 37-40's); a moe model's routing recorded for the ranks to
    replay (phase 22's)."""
    cfg, steps = serve_case_cfg(case)
    routes = [] if cfg.family == "moe" else None
    want = single_serve(case, routes=routes)
    want["routes"] = [r.cpu() for r in routes] if routes else []
    base = GRID_SERVE_FP32_RTOL if case[4] == "float32" else E2E_REL_L2
    want["limits"], want["how"] = [base] * (steps + 1), ""
    if routes:
        want["how"] = " (its routing replayed)"
    if cfg.family in ("ssm", "hybrid") and case[4] == "bfloat16":
        others = {f"SSD chunk / {d}": dict(ssm_chunk=cfg.ssm_chunk // d)
                  for d in TRAIN_BF16_CHUNK_DIVISORS}
        others["fp32"] = dict(dtype="float32")
        spreads = {}
        for what, fields in others.items():
            other = single_serve(case, feed=want["feed"], **fields)
            spreads[what] = [float((a - b).norm() / b.norm())
                             for a, b in zip(other["logits"], want["logits"])]
        want["limits"] = [max([base] + [E2E_SPREAD * x[i] for x in spreads.values()])
                          for i in range(steps + 1)]
        want["how"] = " (its own spread by call, " + "; ".join(
            f"{what}: " + ", ".join(f"{x:.3e}" for x in xs)
            for what, xs in spreads.items()) + ")"
    return want


def grid_serve_run(cases, fault=None, name="grid_serve"):
    """The single device's serve runs of ``cases`` (made once in the
    process) and the grid's, in one call of four ranks (the phase's
    ``rank_pool``, or a spawn of its own)."""
    want = {}
    for case in cases:
        key = ("serve",) + tuple(case[:5])
        if key not in _SINGLE:
            _SINGLE[key] = serve_reference(case)
        want[case[0]] = _SINGLE[key]
    feeds = {label: w["feed"] for label, w in want.items()}
    routes = {label: w["routes"] for label, w in want.items() if w["routes"]}
    t0 = time.perf_counter()
    outs = spawn_ranks(_grid_serve_rank, 4, (cases, feeds, routes, fault),
                       workdir=os.path.join(ROOT, "build", "chip_smoke", name), timeout=900)
    return want, outs, time.perf_counter() - t0


def phase_grid_serve(smi):
    """Phase 42: every ``GRID_SERVE`` case held to the single device.
    Returns the launches of the bf16 cases (the main path)."""
    want, outs, wall = grid_serve_run(GRID_SERVE)
    failed, launches = [], {}
    for case in GRID_SERVE:
        bad, worst = grid_serve_checks(case, outs, want[case[0]])
        serve_report(case, outs, want[case[0]], worst, smi)
        failed += [f"42 {case[0]}: {b}" for b in bad]
        if case[4] == "bfloat16":
            for o in outs:
                for key in ("prefill_launches", "decode_launches"):
                    for k, v in o[case[0]][key].items():
                        launches[k] = launches.get(k, 0) + v
        _SERVE_RUNS[case[0]] = [o[case[0]] for o in outs]
    log(f"  42: four ranks, one call: {wall:.1f} s of wall time")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


def serve_estimate_cases():
    """Phase 41 (e)'s estimates: each bf16 case of 42, its prefill and a
    decode step, as ``dryrun.estimate_serve`` takes them."""
    out = []
    for case in GRID_SERVE:
        if case[4] != "bfloat16":
            continue
        cfg, _ = serve_case_cfg(case)
        cache_len = serve_prompt(cfg) + serve_gen(case)
        out.append((case, "prefill", serve_prompt(cfg), cache_len))
        out.append((case, "decode", cache_len + cfg.num_prefix_tokens, None))
    return out


def hold_serve_estimate(label, kind, est, got, smi, part="41 (e) 42"):
    """41 (e) for one call of a 42 case (``part`` names another): the
    estimate's argument bytes and collectives' bytes and calls against
    rank 0's, exactly, and its peak within ``PEAK_BAND`` of each rank's.
    Returns the failed checks."""
    from repro_torch.launch import dryrun
    if "error" in est:
        return [f"{part} {label} {kind}: the estimate failed: "
                f"{est['error'].strip().splitlines()[-1]}"]
    failed = []
    if est["argument_bytes"] != got[0][f"{kind}_args"]:
        failed.append(f"{part} {label} {kind}: rank 0's arguments {got[0][f'{kind}_args']} "
                      f"bytes, the estimate {est['argument_bytes']}")
    measured = dryrun.collectives(got[0][f"{kind}_stats"])
    if measured != est["collectives"]:
        failed.append(f"{part} {label} {kind}: rank 0's collectives {measured}, the "
                      f"estimate {est['collectives']}")
    ratios = [est["peak_bytes"] / g[f"{kind}_peak"] for g in got]
    if not all(PEAK_BAND[0] <= x <= PEAK_BAND[1] for x in ratios):
        failed.append(f"{part} {label} {kind}: the estimated peak over the measured ones "
                      f"{', '.join(f'{x:.3f}' for x in ratios)}, outside {PEAK_BAND}")
    coll = "; ".join(f"{axis} " + ", ".join(
        f"{kind_} {v['bytes'] / 2**20:.1f} MiB in {v['calls']}" for kind_, v in kinds.items())
        for axis, kinds in est["collectives"].items())
    log(f"  {part} {label} {kind} [{smi}]: arguments {est['argument_bytes'] / 2**20:.1f} "
        f"MiB, rank 0's collectives {coll}: "
        + ("the estimate's, exactly" if not failed else "see below")
        + f"; peak: estimate {est['peak_bytes'] / 2**30:.3f} GiB, measured by rank "
        + ", ".join(f"{g[f'{kind}_peak'] / 2**30:.3f}" for g in got) + " GiB (ratios "
        + ", ".join(f"{x:.3f}" for x in ratios) + f"); {est['flops'] / 1e9:.1f} GFLOP, "
        f"{est['bytes'] / 1e9:.2f} GB of operand traffic; {est['host_s']:.1f} s on the host")
    return failed


def phase_serve_estimates(smi):
    """41 (e): the serve estimates of 42's bf16 cases held to the ranks'."""
    est = _ESTIMATOR.result()
    failed = []
    for case, kind, _, _ in serve_estimate_cases():
        failed += hold_serve_estimate(case[0], kind, est[f"42 {case[0]} {kind}"],
                                      _SERVE_RUNS[case[0]], smi)
    if failed:
        raise AssertionError("; ".join(failed))


SERVE_FAULT_CASES = ("(a)", "(e)", "(f)")


def phase_serve_faults(smi, labels=SERVE_FAULT_CASES):
    """``--grid-faults``' controls of phase 42's checks: each case of
    ``labels`` ((a) the cache sharded over its sequence, (e) the hybrid
    ssm cache moved between placements, (f) whisper's cross cache over
    its sequence) without a fault and with each serve fault of
    ``GRID_FAULTS`` that names it planted in the ranks.  Returns the
    failures: the run without a fault refused, or a faulty run passing
    every check."""
    bad = []
    for case in [c for c in GRID_SERVE if c[0] in labels]:
        faults = [f for f, (_, phases) in GRID_FAULTS.items() if f"42 {case[0]}" in phases]
        for fault in [None] + faults:
            want, outs, wall = grid_serve_run([case], fault)
            failed, worst = grid_serve_checks(case, outs, want[case[0]])
            what = "no fault" if fault is None else f"{fault} ({GRID_FAULTS[fault][0]})"
            log(f"  42 {case[0]}, {what} [{smi}]: logits rel L2 (worst over the ranks) "
                + ", ".join(f"{r:.3e}" for r, _ in worst) + " (limits " + ", ".join(
                    f"{x:.2e}" for x in want[case[0]]["limits"]) + f"); {wall:.1f} s")
            log(f"  42 {case[0]}, {fault or 'no fault'}: refused by: "
                f"{'; '.join(failed) or 'nothing'}")
            if (fault is None) == bool(failed):
                bad.append(f"42 {case[0]} {fault or 'without a fault'}: "
                           + ("refused" if failed else "passes every check"))
    return bad


# ---------------------------------------------------------------------------
# phase 43: the examples and the card rules
# ---------------------------------------------------------------------------

def counted(fn):
    """``fn()`` with the kernels' launch counts from 0: (its result, the
    counts by kernel)."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = fn()
    return out, {f.__name__: f.launches for f in ops.KERNELS}


def hold_launches(label, got, want):
    """Each kernel launched exactly ``want[name]`` times (0 where absent)."""
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    log(f"  {label}: launches {got}")


def quiet(fn, *args):
    """``fn(*args)`` with its printed lines dropped (a yardstick's run)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


@contextlib.contextmanager
def example_config(module, **fields):
    """While the context lasts, the smoke configs of the example
    ``module`` have ``fields`` replaced."""
    from unittest import mock
    get = module.get_smoke_config
    with mock.patch.object(module, "get_smoke_config",
                           lambda name: dataclasses.replace(get(name), **fields)):
        yield


def einsum_spreads(module, run, cfg):
    """The example's einsum path at other summation orders, by label (phase
    5's yardsticks): an ssm or hybrid model's at chunk / 2 and / 4, any
    other's with its keys reversed.  ``run(backend)`` runs the example."""
    out = {}
    if cfg.family in ("ssm", "hybrid"):
        for d in TRAIN_BF16_CHUNK_DIVISORS:
            with example_config(module, ssm_chunk=cfg.ssm_chunk // d):
                out[f"einsum at chunk {cfg.ssm_chunk // d}"] = quiet(run, "einsum")
    else:
        with keys_reversed():
            out["einsum with its keys reversed"] = quiet(run, "einsum")
    return out


def hold_logits(label, key, got, want, spreads):
    """``got[key]`` against the einsum path's ``want[key]``: relative L2 and
    largest absolute error within phase 5's limits, or ``E2E_SPREAD`` x the
    einsum path's own distance in each of ``spreads`` where that is wider."""
    def diff(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm()), float((a - b).abs().max())
    rel, mx = diff(got[key], want[key])
    own = {c: diff(s[key], want[key]) for c, s in spreads.items()}
    lim_rel = max([E2E_REL_L2] + [E2E_SPREAD * r for r, _ in own.values()])
    lim_mx = max([E2E_MAX_ABS] + [E2E_SPREAD * m for _, m in own.values()])
    good = bool(got[key].float().isfinite().all()) and rel <= lim_rel and mx <= lim_mx
    log(f"  {label} {key}: kernel vs einsum rel L2 {rel:.3e} (limit {lim_rel:.3e}), max abs "
        f"{mx:.3e} (limit {lim_mx:.3e})"
        + "".join(f"; {c}: {r:.3e}, {m:.3e}" for c, (r, m) in own.items())
        + ("" if good else "  OVER"))
    if not good:
        raise AssertionError(f"{label}: the kernel path's {key} are off the einsum path's")


def tokens_agree(a, b):
    """On how many of the first ``EXAMPLE_AGREE_STEPS`` generated tokens
    every request of ``a`` and ``b`` agrees."""
    import torch
    return sum(int(torch.equal(a[:, i], b[:, i])) for i in range(EXAMPLE_AGREE_STEPS))


def example_quickstart():
    """43 (a): ``quickstart`` on the card for ``EXAMPLE_ARCHS``."""
    from repro_torch.examples import quickstart

    total = {}
    for arch in EXAMPLE_ARCHS:
        cfg = quickstart.get_smoke_config(arch)
        ssm = cfg.family == "ssm"

        def run(backend):
            return quickstart.run(quickstart.parse_args(["--arch", arch, "--backend", backend]))
        out, got = counted(lambda: run("auto"))
        L, label = out["num_layers"], f"(a) quickstart {arch}"
        # the forward, the step (its backward recomputes the plain version)
        # and the prefill a layer each; 7 decode calls
        hold_launches(label, got, {"ssd_scan": 3 * L} if ssm else
                      {"flash_attention": 3 * L, "flash_decode": 7 * L})
        ref = quiet(run, "einsum")
        hold_logits(label, "logits", out, ref, einsum_spreads(quickstart, run, cfg) if ssm else {})
        rel = abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
        toks = out["tokens"]
        log(f"  {label}: loss {out['loss']:.5f}, einsum {ref['loss']:.5f} (rel {rel:.2e}, limit "
            f"{TRAIN_BF16_LOSS_RTOL}); tokens {toks[0].tolist()}, einsum "
            f"{ref['tokens'][0].tolist()}")
        if not math.isfinite(out["loss"]) or rel > TRAIN_BF16_LOSS_RTOL \
                or toks.shape != (2, 8) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"{label}: loss or tokens off")
        for name, n in got.items():
            total[name] = total.get(name, 0) + n
    return total


def example_serve_batch(smi):
    """43 (b): ``serve_batch`` on the card at its defaults and on granite-8b."""
    from repro_torch.examples import serve_batch

    total = {}
    for arch in SERVE_BATCH_ARCHS:
        argv = [] if arch is None else ["--arch", arch]
        args = serve_batch.parse_args(argv)
        cfg = serve_batch.get_smoke_config(args.arch)
        ssm = cfg.family in ("ssm", "hybrid")

        def run(backend):
            return serve_batch.run(serve_batch.parse_args(argv + ["--backend", backend]))
        out, got = counted(lambda: run("auto"))
        L, label = out["num_layers"], f"(b) serve_batch {args.arch}"
        hold_launches(label, got, {"ssd_scan": L} if cfg.family == "ssm" else
                      {"flash_attention": L, "flash_decode": L * (args.gen - 1)})
        ref = quiet(run, "einsum")
        spreads = einsum_spreads(serve_batch, run, cfg)
        hold_logits(label, "prefill_logits", out, ref, spreads if ssm else {})
        toks, n = out["tokens"], tokens_agree(out["tokens"], ref["tokens"])
        own = {c: tokens_agree(s["tokens"], ref["tokens"]) for c, s in spreads.items()}
        # a token criterion the plain path fails against itself judges nothing
        gated = min([EXAMPLE_AGREE_STEPS] + list(own.values())) >= E2E_MIN_AGREE
        log(f"  {label}: greedy tokens of all {args.requests} requests agree on {n} of the "
            f"first {EXAMPLE_AGREE_STEPS} ("
            + (f"limit {E2E_MIN_AGREE}" if gated else "not held: the einsum path agrees "
               f"with itself on fewer than {E2E_MIN_AGREE}")
            + "".join(f"; {c}: {k}" for c, k in own.items()) + ")")
        if toks.shape != (args.requests, args.gen) or int(toks.min()) < 0 \
                or int(toks.max()) >= cfg.vocab_size or (gated and n < E2E_MIN_AGREE):
            raise AssertionError(f"{label}: tokens off the einsum path's")
        log(f"  {label}: {args.requests} x {args.prompt_len} + {args.gen}: prefill "
            f"{out['prefill_s'] * 1e3:.2f} ms, decode {out['decode_s'] * 1e3:.1f} ms "
            f"({out['decode_tok_per_s']:.1f} tok/s); {smi}")
        for name, k in got.items():
            total[name] = total.get(name, 0) + k
    return total


def example_train_e2e(smi):
    """43 (c): ``train_e2e --full-100m`` on the card, then the fp32
    ``flash_attention`` at its shape timed."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.examples import train_e2e
    from repro_torch.training.train_step import make_train_state, make_train_step

    args = train_e2e.parse_args(E2E_ARGV)
    out, got = counted(lambda: train_e2e.run(args))
    losses, L = out["losses"], out["num_layers"]
    label = f"(c) train_e2e {out['name']}"
    # each layer's forward and its recompute, every step and the resume
    # check's two (their backward recomputes the plain version)
    hold_launches(label, got, {"flash_attention": 2 * L * (len(losses) + 2)})
    (l1, l2), drop = out["resume"], out["drop"]
    if len(losses) != args.steps or not all(map(math.isfinite, losses)) \
            or not drop > train_e2e.MIN_DROP or not abs(l1 - l2) < train_e2e.RESUME_ATOL:
        raise AssertionError(f"{label}: losses {losses[:3]} ... {losses[-3:]}, drop {drop}, "
                             f"resume {l1} vs {l2}")
    # the einsum path's first step: the same seed, weights and batch
    dev = torch.device("cuda")
    cfg = train_e2e.model_config(args.full_100m)
    state = make_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = make_train_step(cfg, train_e2e.optimizer_config(args.steps), remat=True,
                           backend="einsum")
    loader = make_loader(cfg, DataConfig(batch_size=args.batch, seq_len=args.seq), device=dev)
    try:
        batch = next(loader)
    finally:
        loader.close()
    first = float(step(state, batch)[1]["loss"])
    del state, step, batch
    torch.cuda.empty_cache()
    rel = abs(losses[0] - first) / abs(first)
    log(f"  {label}: first loss {losses[0]:.6f}, einsum {first:.6f} (rel {rel:.2e}, limit "
        f"{TRAIN_LOSS_RTOL}); every loss finite; {losses[0]:.4f} -> {losses[-1]:.4f}, drop "
        f"{drop:.3f} (> {train_e2e.MIN_DROP}); resume check {l1:.6f} == {l2:.6f} "
        f"(|diff| {abs(l1 - l2):.1e} < {train_e2e.RESUME_ATOL})")
    if rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{label}: the first loss is off the einsum path's")
    p50 = steady(out["step_times_s"])
    log(f"  {label}: {len(losses)} steps of {args.batch} x {args.seq}: step p50 over steps "
        f"2-{len(losses)} {p50 * 1e3:.2f} ms, {args.batch * args.seq / p50:.0f} tok/s "
        f"({out['tokens_per_s']:.0f} over all steps), peak memory "
        f"{out['peak_mem_bytes'] / 2**30:.2f} GiB; {smi}")
    row, err = fa_timed(FA_E2E, torch.Generator(device="cuda").manual_seed(43), torch.float32)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    log(f"  flash_attention per call [{FA_E2E[0]}], CUDA events: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, SDPA fp32 {row['library_ms']:.4f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max_abs_err {err:.3e}")
    log(f"  flash_attention per call [{FA_E2E[0]}], device time (profiler): kernel "
        f"{fmt(row['device_ms'])}, whole wrapper {fmt(row['wrapper_device_ms'])}, plain "
        f"{fmt(row['plain_device_ms'])}, SDPA fp32 {fmt(row['library_device_ms'])}; "
        f"{2 * L} launches a step")
    return got


def undivided_train_cfg(case, **fields):
    """The config of a ``UNDIVIDED_TRAIN`` case: the arch at full width
    cut to its layers (an audio model's encoder to as many), in its dtype,
    ``fields`` replaced."""
    from repro_torch.configs import get_config
    _, arch, layers, dtype, _, _ = case
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype, **fields)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, num_encoder_layers=layers)
    return cfg


def undivided_batch(cfg, case, dev):
    """A case's seeded ``SyntheticTokens`` batch (an audio model's frames
    from the same stream), on ``dev``."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    _, _, _, _, B, S = case
    toks = SyntheticTokens(cfg, DataConfig(batch_size=B, seq_len=S, seed=1234)).next_batch()
    return {k: torch.from_numpy(v).to(dev) for k, v in toks.items()}


def single_train_step(case, accum=1):
    """The single device's first train step of a ``UNDIVIDED_TRAIN`` case
    from the seeded state (``make_train_state``, the grid's
    ``init_state`` cut of it): its loss and gradient norm as one-step
    lists (``grid_diffs``' form) and its seconds."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.training import train_step as TTS
    dev = torch.device("cuda")
    cfg = undivided_train_cfg(case)
    state = TTS.make_train_state(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = TTS.make_train_step(cfg, adamw.AdamWConfig(**UNDIVIDED_OPT), accum_steps=accum)
    batch = undivided_batch(cfg, case, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    out = {"losses": [float(m["loss"])], "grad_norms": [float(m["grad_norm"])],
           "step_s": time.perf_counter() - t0}
    del state
    torch.cuda.empty_cache()
    return out


def train_on_rank(case, layout):
    """One ``UNDIVIDED_TRAIN`` case's train step on this rank: its blocks
    of the seeded state, its rows of the batch.  Returns its coordinate,
    loss, gradient norm, seconds, collectives, the parts computed whole,
    persistent bytes beside their closed form, peak memory (from the
    state's allocation on) and launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.sharding import spmd
    dev = torch.device("cuda")
    cfg = undivided_train_cfg(case)
    step = spmd.make_train_step(cfg, layout, adamw.AdamWConfig(**UNDIVIDED_OPT))
    state = spmd.init_state(cfg, layout, step.specs,
                            torch.Generator(device=dev).manual_seed(0), device=dev)
    rows = spmd.local_rows(case[4], layout).to(dev)
    batch = {k: v[rows] for k, v in undivided_batch(cfg, case, dev).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    res = {"coord": (layout.grid.d, layout.grid.k), "loss": m["loss"],
           "grad_norm": m["grad_norm"], "step_s": time.perf_counter() - t0,
           "stats": dict(step.stats), "whole": step.whole,
           "state": spmd.state_bytes(state),
           "closed": sum(spmd.block_bytes(cfg, layout, step.specs).values()),
           "peak": torch.cuda.max_memory_allocated(),
           "launches": {fn.__name__: fn.launches for fn in ops.KERNELS}}
    del state, batch
    torch.cuda.empty_cache()
    return res


def _undivided_rank(rank, world, serves, feeds, trains, fault=None):
    """Phase 44 (b), (c) on one rank of the (data 1, model 3) grid: each
    serve case's prefill and decode steps (``serve_on_rank``), then each
    train case's step (``train_on_rank``), ``fault`` planted where
    given."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import spmd
    dev = torch.device("cuda")
    layout = spmd.Layout(*make_local_mesh(model=UNDIVIDED_MODEL, data=1, transport="host",
                                          device=dev))
    rows = spmd.local_rows(GRID_SERVE_BATCH, layout, serving=True)
    out = {}
    with planted(fault) if fault else contextlib.nullcontext():
        for case in serves:
            out[case[0]] = serve_on_rank(case, layout, rows, feeds[case[0]])
            torch.cuda.empty_cache()
        for case in trains:
            out["train " + case[0]] = train_on_rank(case, layout)
    return out


def undivided_train_reference(case):
    """The single device's step of a ``UNDIVIDED_TRAIN`` case and the
    limits on (loss, first gradient norm): bf16 ``grid_limit`` of its
    spread at ``--accum 2`` (phases 33-40's), fp32 ``FP32_LIMITS``' first
    two (phases 38-40's)."""
    key = ("undivided",) + tuple(case)
    if key not in _SINGLE:
        want = single_train_step(case)
        if case[3] == "float32":
            want["limits"] = FP32_LIMITS[:2]
        else:
            want["limits"] = grid_limit(f"44 {case[0]}", want, single_train_step(case, 2))
        _SINGLE[key] = want
    return _SINGLE[key]


def undivided_train_checks(case, outs, want):
    """44's train checks of one case: the failed ones.  Every rank's loss
    and first gradient norm within the limits of the single device's, the
    parts computed whole named as ``UNDIVIDED_WHOLE`` says, the
    persistent bytes the closed form, ``flash_attention`` launched."""
    label = case[0]
    failed = []
    for o in outs:
        got = o["train " + label]
        loss, gnorm = grid_diffs({"losses": [got["loss"]], "grad_norms": [got["grad_norm"]]},
                                 want)
        if not (math.isfinite(got["loss"]) and loss <= want["limits"][0]):
            failed.append(f"rank {got['coord']}'s loss within {want['limits'][0]:.0e}")
        if not gnorm <= want["limits"][1]:
            failed.append(f"rank {got['coord']}'s first gradient norm within "
                          f"{want['limits'][1]:.0e}")
        if got["whole"] != UNDIVIDED_WHOLE[case[1]]:
            failed.append(f"rank {got['coord']} computes {got['whole']} whole")
        if got["state"] != got["closed"]:
            failed.append(f"rank {got['coord']}'s persistent bytes the closed form")
        if not got["launches"]["flash_attention"] > 0:
            failed.append(f"no flash_attention launch on rank {got['coord']}")
    return failed


def undivided_train_report(case, outs, want, smi):
    label = case[0]
    rows = [o["train " + label] for o in outs]
    loss, gnorm = grid_diffs({"losses": [rows[0]["loss"]],
                              "grad_norms": [rows[0]["grad_norm"]]}, want)
    log(f"  44 {label} train ({case[1]}, {case[2]} layers, {case[3]}, b{case[4]} x "
        f"S{case[5]}): losses by rank " + ", ".join(f"{r['loss']:.6f}" for r in rows)
        + f", single device {want['losses'][0]:.6f}, rel diff {loss:.2e} (limit "
        f"{want['limits'][0]:.2e}); first gradient norm {rows[0]['grad_norm']:.7g} against "
        f"{want['grad_norms'][0]:.7g}, rel diff {gnorm:.2e} (limit {want['limits'][1]:.2e}); "
        f"whole: {rows[0]['whole']}")
    log(f"  44 {label} train [{smi}]: step by rank "
        + ", ".join(f"{r['step_s'] * 1e3:.1f}" for r in rows)
        + f" ms (the single device {want['step_s'] * 1e3:.1f} ms); persistent bytes by rank "
        + ", ".join(f"{r['state'] / 2**20:.1f}" for r in rows)
        + " MiB = the rules' blocks; peak by rank "
        + ", ".join(f"{r['peak'] / 2**30:.3f}" for r in rows) + " GiB; launches a rank "
        + ", ".join(f"{k} {v}" for k, v in rows[0]["launches"].items() if v)
        + f"; collectives: {collectives_line([rows[0]['stats']])}")


def undivided_run(serves, trains, fault=None, name="undivided"):
    """The single device's references of ``serves`` and ``trains`` (made
    once in the process) and the grid's runs of both, in one call of
    three ranks (the phase's ``rank_pool``)."""
    want = {}
    for case in serves:
        key = ("serve",) + tuple(case[:5])
        if key not in _SINGLE:
            _SINGLE[key] = serve_reference(case)
        want[case[0]] = _SINGLE[key]
    for case in trains:
        want["train " + case[0]] = undivided_train_reference(case)
    feeds = {label: w["feed"] for label, w in want.items() if "feed" in w}
    t0 = time.perf_counter()
    outs = spawn_ranks(_undivided_rank, UNDIVIDED_MODEL, (serves, feeds, trains, fault),
                       workdir=os.path.join(ROOT, "build", "chip_smoke", name), timeout=900)
    return want, outs, time.perf_counter() - t0


def phase_undivided(smi):
    """Phase 44: (a) starcoder2-7b served on the single device at full
    width and depth and held to its einsum path; (b), (c) the grid at
    model 3 held to the single device.  Returns the launches of (a) and
    of (b), (c) in bf16 (the main path)."""
    import torch
    L = STARCODER_LAYERS
    log(f"  44 (a): {STARCODER_ARCH} at full width and depth ({L} layers), "
        f"{' '.join(STARCODER_SERVE_ARGS[2:8])}")
    launches = serve_and_check(STARCODER_SERVE_ARGS, "serve_starcoder2_7b", L,
                               lambda calls: {"flash_attention": L, "flash_decode": L * calls})
    log(f"  44 (a): kernel path vs einsum path at full depth, bf16, b4 x 512 + 4 steps")
    phase_end_to_end(STARCODER_ARCH, L, "bfloat16")
    torch.cuda.empty_cache()
    log(f"  44 (b), (c): data 1 x model {UNDIVIDED_MODEL} on {UNDIVIDED_MODEL} ranks sharing "
        f"the card, --p2p host; b{GRID_SERVE_BATCH} x {GRID_SERVE_PROMPT} (whisper "
        f"{WHISPER_SEQ - GRID_SERVE_GEN}) prompts, then one train step")
    want, outs, wall = undivided_run(UNDIVIDED_SERVE, UNDIVIDED_TRAIN)
    failed = []
    for case in UNDIVIDED_SERVE:
        bad, worst = grid_serve_checks(case, outs, want[case[0]])
        serve_report(case, outs, want[case[0]], worst, smi, phase="44")
        whole = {o[case[0]]["prefill_stats"]["whole"] == UNDIVIDED_WHOLE[case[1]]
                 for o in outs}
        if whole != {True}:
            bad.append(f"the prefill names {outs[0][case[0]]['prefill_stats']['whole']} whole")
        failed += [f"44 {case[0]}: {b}" for b in bad]
        if case[4] == "bfloat16":
            for o in outs:
                for key in ("prefill_launches", "decode_launches"):
                    for k, v in o[case[0]][key].items():
                        launches[k] = launches.get(k, 0) + v
    for case in UNDIVIDED_TRAIN:
        w = want["train " + case[0]]
        undivided_train_report(case, outs, w, smi)
        failed += [f"44 {case[0]} train: {b}" for b in undivided_train_checks(case, outs, w)]
        if case[3] == "bfloat16":
            for o in outs:
                for k, v in o["train " + case[0]]["launches"].items():
                    launches[k] = launches.get(k, 0) + v
    _SERVE_RUNS.update({f"44 {c[0]}": [o[c[0]] for o in outs] for c in UNDIVIDED_SERVE})
    _UNDIVIDED_TRAINS.update({c[0]: [o["train " + c[0]] for o in outs]
                              for c in UNDIVIDED_TRAIN})
    log(f"  44 (b), (c): three ranks, one call: {wall:.1f} s of wall time")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


def phase_undivided_estimates(smi):
    """41 (f): the estimates of 44 (b) and (c) in bf16, made on the host,
    held to the ranks': each rank's persistent bytes and rank 0's
    collectives exactly, the peaks within ``PEAK_BAND`` (train:
    ``hold_estimate``; prefill and decode: ``hold_serve_estimate``)."""
    est = _ESTIMATOR.result()
    failed = []
    for case in UNDIVIDED_TRAIN:
        if case[3] != "bfloat16":
            continue
        rows = _UNDIVIDED_TRAINS[case[0]]
        got = {"grid": [r["coord"] for r in rows], "state": [r["state"] for r in rows],
               "opt": None, "stats": rows[0]["stats"], "peaks": [r["peak"] for r in rows]}
        failed += hold_estimate(f"{case[0]} train", est[f"44 {case[0]} train"], got, smi,
                                part="41 (f) 44")
    for case, kind, _, _ in undivided_serve_estimate_cases():
        failed += hold_serve_estimate(case[0], kind, est[f"44 {case[0]} {kind}"],
                                      _SERVE_RUNS[f"44 {case[0]}"], smi, part="41 (f) 44")
    if failed:
        raise AssertionError("; ".join(failed))


def undivided_serve_estimate_cases():
    """41 (f)'s serve estimates: each bf16 case of 44, its prefill and a
    decode step."""
    out = []
    for case in UNDIVIDED_SERVE:
        if case[4] != "bfloat16":
            continue
        cfg, _ = serve_case_cfg(case)
        cache_len = serve_prompt(cfg) + serve_gen(case)
        out.append((case, "prefill", serve_prompt(cfg), cache_len))
        out.append((case, "decode", cache_len + cfg.num_prefix_tokens, None))
    return out


def phase_undivided_faults(smi):
    """``--grid-faults``' control of 44 (b)'s train checks: the train step
    without a fault and with each fault of ``GRID_FAULTS`` that names 44
    (b) planted in the ranks.  Returns the failures: the run without a
    fault refused, or a faulty run passing every check."""
    bad = []
    cases = [c for c in UNDIVIDED_TRAIN if c[0] == "(b)"]
    for fault in [None] + [f for f, (_, ph) in GRID_FAULTS.items() if "44 (b)" in ph]:
        want, outs, wall = undivided_run([], cases, fault=fault,
                                         name=f"undivided_faults_{fault or 'none'}")
        failed = undivided_train_checks(cases[0], outs, want["train (b)"])
        what = "no fault" if fault is None else f"{fault} ({GRID_FAULTS[fault][0]})"
        undivided_train_report(cases[0], outs, want["train (b)"], smi)
        log(f"  44 (b), {what}: refused by: {'; '.join(failed) or 'nothing'}; {wall:.1f} s")
        if (fault is None) == bool(failed):
            bad.append(f"44 (b) {fault or 'without a fault'}: "
                       + ("refused" if failed else "passes every check"))
    return bad


def phase_examples(smi):
    """Phase 43 (a)-(c): the examples through the port on the card.
    Returns their launches by kernel."""
    total = {}
    for got in (example_quickstart(), example_serve_batch(smi), example_train_e2e(smi)):
        for name, n in got.items():
            total[name] = total.get(name, 0) + n
    return total


def planted_call(kernel, cfg, seq, gen):
    """A call of ``kernel``'s wrapper on card tensors of ``cfg``'s shapes
    at a tiny batch and sequence (phase 43 (d))."""
    import torch
    from repro_torch.kernels import ops
    dtype = getattr(torch, cfg.dtype)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if kernel == "flash_attention":
        q, k, v = fa_inputs(("planted", 1, 8, 8, H, KV, hd, True, 0, 0, 0), dtype, gen)
        return lambda: ops.flash_attention(q, k, v, causal=True)
    if kernel == "flash_decode":
        q, [(k, v)] = fd_inputs(("planted", 1, KV, H // KV, 64, hd, 63, 0, 0.0, False, 1.0),
                                dtype, gen)
        return lambda: ops.flash_decode(q, k, v, 63)
    case = ("planted", 1, seq, 2, cfg.ssm_headdim, 1, cfg.ssm_state, cfg.ssm_chunk)
    x, dt, A, Bm, Cm = ssd_inputs(case, dtype, gen)
    return lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)


def card_launches(cfg, members, gen):
    """One small launch of each kernel on ``cfg``'s path at a member's
    shapes, each held to its plain version; (kernel, max abs error) pairs."""
    import torch
    from repro_torch.analysis import card_lint
    from repro_torch.kernels import ops, ref
    dtype, out = getattr(torch, cfg.dtype), []
    if cfg.family != "ssm":
        H, KV = card_lint.member_heads(cfg, members)
        q, k, v = fa_inputs(("catalog", 1, CARD_SEQ, CARD_SEQ, H, KV, cfg.head_dim, True, 0, 0,
                             0), dtype, gen)
        out.append(("flash_attention", compare(
            ops.flash_attention(q, k, v, causal=True),
            ref.flash_attention_ref(q, k, v, causal=True), cfg.dtype,
            f"flash_attention [{cfg.name}, member of {members}]")))
        pos = CARD_SEQ - 1
        q, [(k, v)] = fd_inputs(("catalog", 1, KV, H // KV, CARD_SEQ, cfg.head_dim, pos, 0,
                                 0.0, False, 1.0), dtype, gen)
        out.append(("flash_decode", compare(
            ops.flash_decode(q, k, v, pos), ref.decode_attention_ref(q, k, v, pos), cfg.dtype,
            f"flash_decode [{cfg.name}, member of {members}]")))
    if cfg.family in ("ssm", "hybrid"):
        nh = cfg.ssm_nheads
        h = nh // members if nh % members == 0 else nh
        chunk = min(cfg.ssm_chunk, CARD_SSD_SEQ)
        x, dt, A, Bm, Cm = ssd_inputs(("catalog", 1, CARD_SSD_SEQ, h, cfg.ssm_headdim,
                                       cfg.ssm_ngroups, cfg.ssm_state, chunk), dtype, gen)
        y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
        yr, fr = ref.ssd_ref(x, dt, A, Bm, Cm)
        what = f"ssd_scan [{cfg.name}, member of {members}]"
        out.append(("ssd_scan", max(compare(y, yr, cfg.dtype, what, tol=SSD_TOL),
                                    compare(fin, fr, cfg.dtype, what, tol=SSD_TOL))))
    return out


def phase_card_rules():
    """Phase 43 (d): the card rules against the card.  Each shape of
    ``CARD_PLANTED``: the lint names it by its code, and the kernel's
    wrapper on the card raises the lint's message before any launch.
    Every catalog config, full and smoke, at ``CARD_MEMBERS``' shapes:
    the lint is clean and a small launch of each kernel on its path holds
    to its plain version."""
    import torch
    from repro_torch.analysis import card_lint
    from repro_torch.configs import get_config, get_smoke_config, list_configs
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(43)
    for label, arch, fields, seq, code in CARD_PLANTED:
        cfg = dataclasses.replace(get_smoke_config(arch), **fields)
        diags = card_lint.check_card_kernels(cfg, seq_len=seq)
        if {d.code for d in diags} != {code}:
            raise AssertionError(f"(d) {label}: lint {[d.format() for d in diags]}, "
                                 f"expected {code}")
        for d in diags:
            kernel = d.message.split(":", 1)[0]
            call = planted_call(kernel, cfg, seq, gen)
            before = {f.__name__: f.launches for f in ops.KERNELS}
            try:
                call()
                torch.cuda.synchronize()
            except ValueError as e:
                card = str(e)
            else:
                raise AssertionError(f"(d) {label}: {kernel} took a shape the lint refuses")
            if {f.__name__: f.launches for f in ops.KERNELS} != before or card != d.message:
                raise AssertionError(f"(d) {label}: the card said {card!r} (launches "
                                     f"counted or a message other than the lint's)")
            log(f"  (d) {label:32s} lint: {d.code} {d.message} | card: ValueError: {card}")
    n = 0
    for arch in list_configs():
        for kind, cfg in (("full", get_config(arch)), ("smoke", get_smoke_config(arch))):
            for m in CARD_MEMBERS:
                diags = card_lint.check_card_kernels(cfg, seq_len=CARD_SSD_SEQ,
                                                     heads_per_member=m)
                ran = card_launches(cfg, m, gen)
                n += len(ran)
                log(f"  (d) {arch} {kind} at {m} member(s): lint "
                    + ("clean" if not diags else "; ".join(d.format() for d in diags))
                    + " | card: " + ", ".join(f"{k} ok ({e:.1e})" for k, e in ran))
                if diags:
                    raise AssertionError(f"(d) {arch} {kind}: the lint refuses what the "
                                         f"card takes")
    log(f"  (d) the catalog: {len(list_configs())} configs x full and smoke x "
        f"{len(CARD_MEMBERS)} member counts, lint clean, {n} launches held to their plain "
        f"versions")


def phase_transports():
    """``--transports``: phase 16 (a)'s qwen1.5-0.5b plan under 1f1b with
    one card a rank, through NCCL (traced: the tracer's object gather on
    NCCL) and through gloo with host staging."""
    import torch
    arch, stages, b, args = PP_QWEN
    for transport in ("device", "host"):
        log(f"  --p2p {transport}:")
        plan_and_check(arch, stages, b, args, "1f1b", "flash_attention", transport,
                       trace=transport == "device")
    cards = torch.cuda.device_count()
    if cards < 3:
        log(f"  phase 18 (a) through --p2p device needs three cards; this machine has "
            f"{cards}: skipped")
    else:
        log("  phase 18 (a): qwen1.5-0.5b 5 / 3 at tp (2, 1), one card a rank, "
            "--p2p device, sr_ag against naive:")
        phase_hetero(transport="device", runs=HETERO_RUNS[:1])
    if cards < 4:
        log(f"  granite-8b pipe 2 x tp 2 and qwen1.5-0.5b dp 2 x pipe 2 through --p2p "
            f"device need four cards; this machine has {cards}: skipped")
        return
    log("  phase 17 (d)'s (pipe 2, tp 2) cases, one card a rank, --p2p device:")
    phase_grid_parity(transport="device", cases=GRID_PARITY_NCCL)
    arch, layers, args = TRANSPORT_TP
    log(f"  {arch} at full size, pipe 2 x tp 2, one card a rank, --p2p device:")
    grid_and_check("grid_transport_tp", arch, layers, args, "flash_attention",
                   GRID_TP * 4 * layers * 2, "tp 2 x pipe 2", transport="device")
    arch, layers, args = GRID_DENSE_DP
    log(f"  phase 17 (b): {arch} dp 2 x pipe 2, ZeRO-1, one card a rank, --p2p device:")
    res = grid_and_check("grid_transport_dp", arch, layers, args, "flash_attention",
                         GRID_DP * 4 * layers * 2, "dp 2 x pipe 2", transport="device")
    check_zero1_state(res, "dp 2 x pipe 2")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    transports = sys.argv[1:] == ["--transports"]
    faults = sys.argv[1:] == ["--grid-faults"]
    if sys.argv[1:] and not (transports or faults):
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    if transports and torch.cuda.device_count() < 2:
        print("chip_smoke --transports needs two cards", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    log("== 1. environment")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    log(f"  nvidia-smi: {smi}")

    log("== 2. build")
    t0 = time.perf_counter()
    build.load()
    log(f"  built/loaded {list(build.ENTRY_POINTS)} in {time.perf_counter() - t0:.1f} s")
    for name, out in build.build_log.items():
        for line in ptxas_summary(out):
            log(f"  [{name}] {line}")

    if transports or faults:
        if transports:
            log("== 16 (a) by transport: qwen1.5-0.5b 3 / 5, 1f1b, one card a rank")
            phase_transports()
        else:
            try:
                phase_grid_faults(smi)
            finally:
                close_pools()
        print(smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    global _ESTIMATOR
    _ESTIMATOR = Estimator()
    try:
        return main_phases(smi)
    finally:
        close_pools()
        _ESTIMATOR.close()


def main_phases(smi) -> int:
    """Phases 3-44, the kernels line and the last lines."""
    import torch
    log("== 3. kernels vs plain versions, fp32, bf16 and fp16")
    rows, rows16 = phase_kernels()
    rows["ssd_scan"], rows16["ssd_scan"] = phase_ssd_kernel()
    rows["rmsnorm"], rows16["rmsnorm"] = phase_rmsnorm_kernel()
    phase_grads()

    log("== 4. serving path: serve granite-8b, 36 layers, bf16")
    launches = phase_main_path()

    log("== 5. kernel path vs einsum path, granite-8b width, 4 layers, bf16 and fp16")
    phase_end_to_end()
    phase_end_to_end(dtype="float16")

    log("== 6. where the time goes: granite-8b, 36 layers, traced")
    phase_profile()

    log("== 7. training path: train mamba2-780m, 48 layers, bf16, b4 x S2048")
    train_launches, state = phase_train()
    launches["ssd_scan"] = train_launches["ssd_scan"]

    log("== 8. where the time goes: a warm mamba2-780m train step, traced")
    phase_train_profile(state, TRAIN_ARGS, "profile_train.txt")
    del state

    log("== 9. training, kernel path vs einsum path: mamba2-780m width, 4 layers, "
        "fp32, bf16 and fp16")
    phase_train_kernel_vs_plain("float32")
    phase_train_kernel_vs_plain("bfloat16")
    phase_train_kernel_vs_plain("float16")

    log("== 10. SSM serving: mamba2-780m, 48 layers, bf16")
    phase_ssm_serve()

    log("== 11. dense training through flash_attention: qwen1.5-0.5b, b2 x S1024")
    phase_dense_train()

    log("== 12. the measured auto-profiler: granite-8b at full width, seq 4096")
    launches["rmsnorm"] = phase_profiler()["rmsnorm"]

    log("== 13. hybrid training path: train zamba2-2.7b, 54 layers, bf16, b4 x S2048")
    hybrid_launches, state = phase_hybrid_train()
    log("  where the time goes: a warm zamba2-2.7b train step, traced")
    phase_train_profile(state, HYBRID_TRAIN_ARGS, "profile_train_hybrid.txt")
    del state

    log(f"== 14. kernel path vs einsum path, hybrid: zamba2 width, "
        f"{HYBRID_CUT_LAYERS} layers; training and serving in fp32 and bf16")
    phase_train_kernel_vs_plain("float32", "zamba2_2p7b", HYBRID_CUT_LAYERS)
    phase_train_kernel_vs_plain("bfloat16", "zamba2_2p7b", HYBRID_CUT_LAYERS)
    for dtype in ("float32", "bfloat16"):
        phase_end_to_end("zamba2_2p7b", HYBRID_CUT_LAYERS, dtype)

    log("== 15. hybrid serving: serve zamba2-2.7b, 54 layers, bf16")
    serve_launches = phase_hybrid_serve()
    for name in ("flash_attention", "flash_decode", "ssd_scan"):
        launches[name] += hybrid_launches[name] + serve_launches[name]

    log("== 16. HeteroPP on one card: 2 ranks, --p2p host; qwen1.5-0.5b 3 / 5 "
        "(1f1b, zb_v), mamba2-780m 6 / 10, parity at 4 layers")
    with rank_pool(2):
        pipeline_launches, qwen_1f1b_per_step = phase_pipeline()
    for name in ("flash_attention", "ssd_scan"):
        launches[name] += pipeline_launches[name]

    log(f"== 17. HeteroPP tp and dp on one card: 4 ranks, --p2p host; qwen1.5-0.5b 3 / 5 "
        f"x tp {GRID_TP}, qwen1.5-0.5b 8 layers dp {GRID_DP} ZeRO-1, mamba2-780m 8 layers dp "
        f"{GRID_DP} bucketed psum, parity at 4 layers")
    with rank_pool(4):
        grid_launches = phase_grid(qwen_1f1b_per_step)
    for name in ("flash_attention", "ssd_scan"):
        launches[name] += grid_launches[name]

    log("== 18. HeteroPP grouped tp on one card: 3 ranks, --p2p host; qwen1.5-0.5b "
        "5 / 3 at tp (2, 1) (sr_ag, naive) and (1, 2), parity at 4 layers")
    with rank_pool(3):
        hetero_launches = phase_hetero()
        phase_hetero_parity()
    log(f"== 19. HeteroPP uneven batch domain {DOMAIN} on one card: 4 ranks, --p2p host; "
        f"mamba2-780m 8 layers dp 2 x pipe 2 in each dp sync mode, parity at 4 layers")
    with rank_pool(4):
        domain_launches = phase_domain()
        phase_domain_parity()
    for name in ("flash_attention", "ssd_scan"):
        launches[name] += hetero_launches[name] + domain_launches[name]

    log("== 20. MoE serving: serve qwen3-moe-30b-a3b, 48 layers, bf16")
    moe_serve_launches = phase_moe_serve()

    log(f"== 21. MoE training: train qwen3-moe-30b-a3b at full width, "
        f"{MOE_TRAIN_LAYERS} layers, bf16, b2 x S2048")
    moe_train_launches = phase_moe_train()

    log(f"== 22. kernel path vs einsum path, MoE: qwen3-moe width, {MOE_CUT_LAYERS} "
        f"layers; training and serving in fp32 and bf16")
    for dtype in ("float32", "bfloat16"):
        phase_train_kernel_vs_plain(dtype, MOE_ARCH, MOE_CUT_LAYERS)
    for dtype in ("float32", "bfloat16"):
        phase_end_to_end(MOE_ARCH, MOE_CUT_LAYERS, dtype)

    log(f"== 23. the measured auto-profiler on MoE: qwen3-moe-30b-a3b at full width, "
        f"{MOE_TRAIN_LAYERS} layers, seq {PROFILE_SEQ}")
    moe_profile_launches = phase_profiler(MOE_ARCH, MOE_TRAIN_LAYERS)

    log("== 24. HeteroPP with moe stages on one card: 2 ranks, --p2p host; qwen3-moe "
        f"{MOE_PP_LAYERS} layers 1 / 1 (1f1b, traced), parity at 2 layers")
    with rank_pool(2):
        moe_pipeline_launches = phase_moe_pipeline()
        phase_moe_pipeline_parity()
    for name in ("flash_attention", "flash_decode", "rmsnorm"):
        launches[name] += sum(got.get(name, 0) for got in (
            moe_serve_launches, moe_train_launches, moe_profile_launches,
            moe_pipeline_launches))

    log("== 25. audio serving: serve whisper-base, 6 + 6 layers, bf16, B8 x 416 + 32")
    whisper_serve_launches = phase_whisper_serve()

    log("== 26. audio training: train whisper-base, 6 + 6 layers, bf16, b16 x S448")
    whisper_train_launches = phase_whisper_train()

    log("== 27. kernel path vs einsum path, audio: whisper-base at full depth; training "
        "and serving in fp32 and bf16")
    phase_whisper_kernel_vs_plain()
    for name in ("flash_attention", "flash_decode", "rmsnorm"):
        launches[name] += sum(got.get(name, 0) for got in (
            whisper_serve_launches, whisper_train_launches))

    log("== 28. VLM serving: serve paligemma-3b, 18 layers, bf16, B4 x (256 image + 512) "
        "+ 32")
    paligemma_serve_launches = phase_paligemma_serve()

    log("== 29. VLM training: train paligemma-3b, 18 layers, bf16, b4 x (256 image + 512)")
    paligemma_train_launches = phase_paligemma_train()

    log(f"== 30. kernel path vs einsum path, VLM: paligemma-3b width, "
        f"{PALIGEMMA_CUT_LAYERS} layers; training and serving in fp32 and bf16")
    phase_paligemma_kernel_vs_plain()
    for name in ("flash_attention", "flash_decode", "rmsnorm"):
        launches[name] += sum(got.get(name, 0) for got in (
            paligemma_serve_launches, paligemma_train_launches))

    log(f"== 31. precision harness, operator level: {SWEEP_TOL} tolerance, 6 ops x 4 "
        "regimes on the card")
    phase_precision_ops()

    log(f"== 32. precision harness, model level: {ALIGN_ARCH}, 24 layers, "
        f"b{ALIGN_BATCH} x S{ALIGN_SEQ}, {ALIGN_ITERS} iterations in fp32, bf16 and fp16")
    for name, n in phase_precision_model().items():
        launches[name] += n

    with rank_pool(4):
        for name, n in phase_gspmd(smi).items():
            launches[name] += n
    arch, layers, full, grid_args, args = GSPMD_SSM
    log(f"== 36. the (data, model) grid, model axis 1: {arch} at full width, {layers} of "
        f"{full} layers, {' '.join(grid_args)}, {' '.join(args)}, 2 ranks sharing the card")
    with rank_pool(2):
        for name, n in phase_gspmd_ssm(smi).items():
            launches[name] += n
    with rank_pool(4):
        for name, n in phase_gspmd_families(smi).items():
            launches[name] += n

        log("== 41. the dry-run against the card: the estimates of phases 33-40 (made on "
            "the host beside them) and remat_policy dots on qwen1.5-0.5b, b2 x S1024")
        for name, n in phase_dryrun(smi).items():
            launches[name] += n

        log(f"== 42. the grid's serve steps: data 2 x model 2 on 4 ranks sharing the card, "
            f"--p2p host; b{GRID_SERVE_BATCH} x {GRID_SERVE_PROMPT} + {GRID_SERVE_GEN}: "
            + "; ".join(f"{c[0]} {c[1]} {c[2]} layers" for c in GRID_SERVE))
        for name, n in phase_grid_serve(smi).items():
            launches[name] += n
    log("== 41 (e). the serve estimates of 42 (a)-(f), made on the host, against the ranks")
    phase_serve_estimates(smi)

    log("== 43. the examples and the card rules: quickstart, serve_batch, train_e2e "
        "(e2e-100m, fp32, 120 steps); planted shapes and the catalog against the card")
    t43 = time.perf_counter()
    for name, n in phase_examples(smi).items():
        launches[name] += n
    phase_card_rules()
    log(f"  phase 43: {time.perf_counter() - t43:.1f} s")

    log(f"== 44. a model axis that does not divide a block's count: (a) {STARCODER_ARCH} "
        f"served at full width and depth; (b) {STARCODER_ARCH} 1 of {STARCODER_LAYERS} layers "
        f"and (c) {WHISPER_ARCH} 6 + 6 on data 1 x model {UNDIVIDED_MODEL}, served and trained")
    t44 = time.perf_counter()
    with rank_pool(UNDIVIDED_MODEL):
        for name, n in phase_undivided(smi).items():
            launches[name] += n
    log("== 41 (f). the estimates of 44 (b), (c), made on the host, against the ranks")
    phase_undivided_estimates(smi)
    print(f"phase 44: {time.perf_counter() - t44:.1f} s", flush=True)

    log("== done")
    kernels = []
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms")
    for name in ("flash_attention", "flash_decode", "ssd_scan", "rmsnorm"):
        r = dict(rows[name])
        r["launches"] = launches[name]
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", *keys)})
        kernels[-1]["float16"] = {k: rows16[name][k] for k in keys}
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
