#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero with no result line:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles every kernel in ``ray_tpu_torch/ops/csrc`` (one
   ``nvcc`` per source, started together) and prints the build seconds;
3. kernel vs plain: the split-K paged decode-attention kernel (split
   and combine kernels, one call) against ``paged_attention_reference``
   at Llama-3-8B decode shapes (Hq=32, KVH=8, D=128, bs=64, B=8, 32 table
   entries) with ragged positions straddling block edges, dead tail
   entries repeating the last live block and one freed slot on the
   garbage block; bf16, fp32 and int8 arenas, and long-table bf16 and
   fp32 cases (128 entries, positions up to 8191); tolerances stated in
   CASES;
4. timing: kernel, plain version and ``scaled_dot_product_attention``
   over the pre-gathered dense K/V (a yardstick only; the port never
   calls it), CUDA events around each launch with L2 flushed before it;
   the bound is the live K/V + q + out + table bytes over 3.35 TB/s;
   beside each time the layout the host chose (splits, chunk tokens),
   the live blocks (those whose chunk holds a token, counted from the
   positions) and host microseconds a call over 32 back-to-back calls
   (``host_us``). No phase before the served runs of phases 5 and 13
   starts torch.profiler: after a profiling session the host's launches
   run slower, which would bias the tick times measured after it;
5. end to end: ``ContinuousBatcher`` serving Llama-3-8B at full width and
   depth with random weights (8 slots, max_len 2048, block 64): 12
   requests, 32 new tokens each; every request must return 32 in-vocab
   tokens and the kernel must have launched num_layers times per decode
   tick; then 4 requests on an int8 arena; then a profile of 5 ticks
   (device time a tick, top kernels, each attention kernel's device
   microseconds a launch);
6. kernel vs plain inside the engine: the same widths at 2 layers in
   fp32, greedy tokens with the kernel and with ``use_decode_kernel=False``
   must be identical (a divergence passes only if the top-2 logit margin
   there is below 1e-4);
7. flash kernels vs plain: the forward, dq and dk/dv kernels against
   ``flash_fwd_reference``/``flash_bwd_reference`` at the Llama-3-8B
   training attention shape (B=2, S=2048, Hq=32, KVH=8, D=128), causal in
   bf16 and fp32, non-causal, and cross-length causal (Sq=1024, Sk=2048);
   out, lse, dq, dk and dv each within the tolerances in FLASH_CASES.
   bf16 runs all three on the tensor cores (``flash_attention_sm90.cu``:
   forward, dq and dk/dv); fp32 runs all three CUDA-core kernels
   (``flash_attention.cu``);
8. flash timing: each kernel, its plain version (one plain backward
   computes dq, dk and dv) and ``scaled_dot_product_attention`` forward
   and backward (a yardstick only; the port never calls it), CUDA events
   with L2 flushed, for bf16 and fp32 (so both routes); the bound is the
   larger of the live (q, key) pairs' flops over the dtype's peak and the
   bytes moved over 3.35 TB/s; bf16 times the tensor-core dq;
9. kernel vs plain inside the model: Llama-3-8B widths at 2 layers in
   fp32, one sequence of 512 tokens: loss_fn and every param leaf's grad
   with the kernels and with ``attention_kernel=False``;
10. end to end, training: ``ShardedTrainer`` on Llama-3-8B widths at 8 of
   its 32 layers (cut from 16, "Time" below; bf16, remat "full"), a 2 x 2048-token batch from
   ``synthetic_batch`` seed 0, ``default_optimizer(warmup_steps=5,
   total_steps=1000)``, 12 steps on that batch: every loss finite, the
   last below the first and below TRAIN["last_loss_below"], and per step
   2 L forward launches (remat replays the forward), L dq and L dk/dv
   launches, in bf16, so the three tensor-core kernels; then step time,
   tokens/s, MFU, peak memory and one profiled step's device time by
   kernel, which fails if a flash group reads 0 ms;
11. dense kernel vs plain: the split-K dense decode-attention kernel
   (split and combine kernels, one call) against
   ``decode_attention_reference`` at the Llama-3-8B decode shape (B=8,
   Hq=32, KVH=8, D=128, S_max=2048, the phase-3 positions): bf16 and fp32
   caches, a per-layer view of a [2, B, S, KVH, D] cache, S_max=1000 (a
   ragged last tile), long bf16 and fp32 caches (S_max=8192, the
   phase-3 long positions), and the external drafter's step of phase 19
   (Llama-3.2-1B's Hq=32, KVH=8, D=64, a layer of a [16, 8, 2048, 8, 64]
   cache, bf16); tolerances in DENSE_CASES;
12. dense timing: kernel, plain version and ``scaled_dot_product_attention``
   over the transposed contiguous cache with the ``pos >= col`` mask (a
   yardstick only; the port never calls it), CUDA events with L2 flushed;
   the bound is the live K/V + q + out + positions bytes over 3.35 TB/s;
   beside each time the layout the host chose (``dense_layout``: splits,
   chunk tokens) and host microseconds a call (``host_us``);
13. dense end to end: ``ContinuousBatcher(paged=False)`` serving
   Llama-3-8B at full width and depth (the phase-5 weights, 8 slots,
   max_len 2048): the phase-5 prompts, 32 new tokens each, every request
   32 in-vocab tokens, the dense kernel launched num_layers times per
   tick and the paged kernel never; tick, tokens/s, TTFT p50, peak
   memory, a profile of 5 ticks, and how many requests agree token for
   token with the paged run. Not a gate (bf16 dense and paged prefill
   reduce over different key lengths): at each request that parts, the
   first parting token and the top-2 logit margin there from a bf16 full
   forward (``partings``: request, token, margin, top logit); the same
   for a bf16 dense run through the plain attention
   (``use_decode_kernel=False``, another summation order: a yardstick of
   where bf16 runs part);
14. dense parity inside the engine: in phase 6's 2-layer fp32 model the
   dense engine with the kernel and with ``use_decode_kernel=False``, the
   paged engine with its kernel, and ``LlamaGenerator.generate`` for one
   prompt give the same greedy tokens (a divergence passes only if the
   top-2 logit margin there is below 1e-4);
15. prefix serving: phase 5's model and weights, the paged engine with
   the prefix cache on and off (``PREFIX``): one warm request of a shared
   1,024-token prefix (numpy seed 1) plus a tail runs first, then 12
   requests of that prefix plus tails of 17-300 tokens, 32 new tokens
   each, greedy. Each must return 32 in-vocab tokens, the paged kernel
   must launch num_layers times a tick, ``prefix_hit_tokens`` must be
   12 x 1,024 and the cache-off run must prefill 12 x 1,024 tokens more.
   Reported for both: prefill tokens and seconds, TTFT p50, tick ms, peak
   memory; and on/off agreement token for token with ``partings`` (not a
   gate in bf16: a suffix-only prefill's GEMMs may tile otherwise);
16. engine parity of the new paths: in phase 6's 2-layer fp32 model, the
   prefix cache on against off (model-dtype and int8 arenas, four
   requests of a 512-token prefix after a warm request of it), and
   ``sync_every=4`` against 1 (paged and dense engines, phase 6's
   requests): the same greedy tokens (a divergence passes only if the
   top-2 logit margin there is below 1e-4);
17. buffered at full width: the phase-5 requests with ``sync_every=4``
   (ticks run ahead, their tokens fetched in one pinned non-blocking copy
   a 4 ticks): 32 in-vocab tokens each and num_layers paged launches a
   tick; agreement with phase 5, tick ms, tokens/s and TTFT p50 reported;
18. scoring: ``score_logprobs`` of two phase-5 requests' served tokens
   with the bf16 flash forward kernel (num_layers launches a call) and
   with ``attention_kernel=False``, within ``SCORE_TOL``; every layer's
   flash forward in the scoring (B=1, the padded sequence of 512 or 1,024)
   within ``SCORE_TOL`` of the plain forward on the same q/k/v, where
   three wrong attentions (no causal mask, each row's own 64-key block
   skipped, zeros) must each fail; how many served greedy tokens are the
   argmax of the scored distribution is reported;
19. speculative serving: phase 5's model, weights and requests through
   ``ContinuousBatcher(spec_k=4, spec_adaptive=False)``: self-draft with
   the default 8 of 32 layers on a bf16 arena, on an int8 arena (4
   requests), with ``sync_every=4`` (4 requests, cut from 12); an external
   drafter at Llama-3.2-1B's published widths (``DRAFTER``, random
   weights from seed 1; its steps run the dense kernel); and JAX's
   default, adaptive k (4 requests, cut from 12). Each request
   must return 32 in-vocab tokens, spec ticks must run, and the kernels
   must launch as ``want_launches`` says (per spec tick at rung k: (k + 1)
   x 32 paged in verify, k x 8 paged in the self-draft or k x 16 dense in
   the external drafter). First, one spec tick's layer-0 paged launches
   (4 draft steps, 5 verify positions) are each held against
   ``paged_attention_reference`` on their own inputs at SPEC_CHECK_TOL.
   Reported: tick ms, tokens/s, TTFT p50, accept rate, tokens committed
   a tick, the rungs run, peak memory, the table width and paged layout,
   agreement with phase 5 and ``partings``; then a profile of 5 spec
   ticks;
20. spec parity inside the engine: in phase 6's 2-layer fp32 model,
   greedy spec decode (self-draft of 1 layer, k = 2 and 4) against the
   spec-off runs of phases 6 and 16 with the kernel and the plain
   attention, model-dtype and int8 arenas, ``sync_every`` 1 and 4, the
   prefix cache on and off, and an external 1-layer fp32 drafter: the
   same greedy tokens (a divergence passes only if the top-2 logit margin
   there is below 1e-4) at the launch counts of ``want_launches``; and
   sampled spec decode (SPEC_SAMPLING) twice at ``sync_every`` 1 and twice
   at 4: the same tokens every time;
21. disaggregated serving: phase 5's model, weights and requests (32 new
   tokens, greedy) split between a ``role="prefill"`` and a
   ``role="decode"`` engine (8 slots, max_len 2048, block 64, one copy of
   the params), driven as a router drives them (``split_drive``: a
   ``reserve_import`` before each submit, then rounds of a prefill step,
   ``kv_transfer.transfer_inproc`` of each parked request the decode
   engine has a slot for, and a decode step, so imports land while other
   slots decode); a bf16 arena, then an int8 one with 4 requests. Each
   request must return 32 in-vocab tokens from the decode engine, the
   prefill engine must never tick, the paged kernel must launch decode
   ticks x num_layers times, each request must be exported and imported
   once, the first two imports' blocks must equal their payloads' staging
   bytes, and no reservation may be left. Reported: the prefill engine's
   prefill seconds; per request the payload's MiB, ``export_s``,
   ``import_s``, the import call, and the crc's share of the export and
   of the import call (one ``zlib.crc32`` of the same buffer); MB/s; the
   decode engine's tick ms and tokens/s, TTFT p50 from the prefill
   engine's request records, each beside phase 5's; peak memory;
   agreement with phase 5 and ``partings``;
22. split parity inside the engine: in phase 6's 2-layer fp32 model with
   the kernel, split greedy tokens against the colocated runs of phases 6
   and 16: model-dtype and int8 arenas x ``sync_every`` 1 and 4 x the
   prefix cache on and off, a decode engine with ``spec_k=2`` self-draft,
   and one with an external 1-layer fp32 drafter (the dense kernel after
   its prefill of each imported prompt); the same tokens (a divergence
   passes only if the top-2 logit margin there is below 1e-4) at the
   decode engine's ``want_launches`` counts, the prefill engine never
   ticking;
23. Mixtral parity inside the model: ``MixtralConfig.mixtral_8x7b``'s
   widths (E=4096, M=14336 an expert, X=8, k=2, Hq=32, KVH=8, D=128,
   V=32000) at 2 layers in fp32, one sequence of 512 tokens:
   ``mixtral.loss_fn`` (aux_coeff 0.02) and every param leaf's grad with
   the flash kernels and with ``attention_kernel=False``, held to phase
   9's limits; the kernel run must launch fwd, dq and dk/dv; prints
   ``aux_loss`` and each layer's ``dropped_fraction`` (``moe.moe_layer``
   on that layer's input);
24. end to end, Mixtral training: Mixtral-8x7B widths at 2 of its 32
   layers (cut from 4; bf16, remat "full"), a 2 x 2048-token batch
   from ``synthetic_batch`` seed 0, ``default_optimizer(warmup_steps=5,
   total_steps=1000)`` applied with ``AdamW.apply_``, ``mixtral.loss_fn``
   (aux_coeff 0.02) under ``llama.fp32_reduction``, 12 steps on that
   batch: every loss finite, the last cross-entropy below the first,
   per step 2 L forward, L dq and L dk/dv launches, peak memory under
   MIXTRAL_TRAIN["peak_gib"]; then step time, tokens/s, MFU over the
   active params, the capacity padding's share of the expert rows,
   ``aux_loss`` a step, and one profiled step's device time by group
   (flash, GEMM, MoE routing, other), its idle share and top kernels;
25. the sharded trainer on a one-rank mesh: a one-rank NCCL process
   group (``file://`` under a temp dir, ``device_id`` cuda:0, destroyed
   at the end of the phase; a failed init fails the phase). First a tiny
   fp32 model at head dim 128 (``SHARDED_PARITY``, so the fp32 flash
   kernels run inside ``local_map``) takes 2 steps on
   ``make_mesh(MeshConfig())`` with ``DEFAULT_RULES`` and on the
   one-device trainer: each step's loss and every grad leaf within
   ``SHARDED["tol"]`` (relative; a leaf against its max). Then phase 10's
   run on that mesh: ``ShardedTrainer(cfg, mesh, rules=DEFAULT_RULES)``
   at Llama-3-8B widths and 16 layers, ``init_state(0)``, phase 10's
   batch, 12 steps: step 1's loss within ``SHARDED["tol"]`` of phase 10's
   (the same params and batch), every loss finite, the last below the
   first, 2 L / L / L flash launches a step, peak memory under
   ``SHARDED["peak_gib"]``; ``[sharded-train]`` prints step ms, tokens/s,
   MFU and peak beside phase 10's and the largest relative loss gap over
   the 12 steps, then one profiled step (``[sharded-profile]``);
26. the seq path, inside phase 25's NCCL group on
   ``make_mesh(MeshConfig(seq=1))`` (a ring of one): (a) phase 25's tiny
   fp32 model with ``attention="ring"`` against the one-device trainer
   with the fp32 flash kernels, 2 steps: loss within ``SHARDED["tol"]``
   relative, every grad leaf within ``MODEL_GRAD_TOL``, and no flash
   launch on the ring's steps (``[ring-parity]``); (b) ``ulysses_attention``
   inside ``local_map`` at FLASH_CASES[0]'s shape (B=2, S=2048, Hq=32,
   KVH=8, D=128, bf16, causal), forward and backward: out, dq, dk and dv
   against ``mha_reference`` at that case's tolerances, and exactly one
   launch of each flash kernel (``[ulysses]``); (c) phase 10's run with
   ``attention="ring"``: step 1's loss within ``SEQ["loss_rtol"]`` of
   phase 10's, every loss finite, the last below the first, no flash
   launch, peak under ``SEQ["peak_gib"]``; ``[seq-train]`` prints step
   ms, tokens/s, MFU, peak, idle share (``[seq-profile]``, one profiled
   step) and the attention's share of device time (one layer's ring
   forward and forward-and-backward timed alone, times the layers, over
   the profiled step's device time) beside phase 25's;
27. Mixtral on the mesh, inside phase 25's NCCL group: phase 24's run
   (Mixtral-8x7B widths, 2 of 32 layers, bf16, remat "full", phase 10's
   batch, 12 steps) with the params placed on ``make_mesh(MeshConfig())``
   by ``mixtral.logical_axes``, its loss and grads through the
   expert-parallel layer (``moe.moe_layer`` on a DeviceMesh), each grad
   redistributed to its param's placements before ``AdamW.apply_``: step
   1's loss within ``SHARDED["tol"]`` of phase 24's (the same params and
   batch), every loss finite, the last below the first, 2 L / L / L
   flash launches a step, peak under ``MIXTRAL_TRAIN["peak_gib"]``;
   ``[mixtral-mesh-train]`` prints step ms, tokens/s, MFU over the active
   params and peak beside phase 24's, and one profiled step's idle share
   and MoE routing ms (``[mixtral-mesh-profile]``);
28. the checkpoint plane, inside the same group: ``ShardedTrainer`` at
   Llama-3-8B widths cut to 1 layer (``CKPT``; bf16 params and both
   bf16 moments, 7.6 GB a saved step) on the one-rank mesh takes phase
   10's batch; step 1 is saved asynchronously while step 2 runs, then
   step 2 is saved, under a temp dir (its file system's free bytes
   checked first against two steps and a margin; removed at the end).
   Each restore, onto the mesh and onto a one-device trainer, must equal
   the saved state bit for bit, and a third step from each must give the
   uninterrupted run's step-3 loss bit for bit; a flipped byte in step
   2's shard must make ``restore()`` fall back to step 1. ``[ckpt]``
   prints the bytes, the blocked ms of each snapshot, the save seconds,
   the restore seconds, GB/s each way and the crc32's share of each.
29. the LLM deployments in process: ``ContinuousLlamaDeployment`` at
   Llama-3-8B (phase 5's random weights, drawn by the engine from seed 0;
   8 slots, max_len 2048) takes phase 5's 12 prompts as 12 concurrent
   ``generate`` streams from threads, 32 tokens each: every stream gives
   32 in-vocab tokens and the paged kernel launches num_layers times a
   tick; TTFT p50 at the caller, decode tokens/s, tick ms and agreement
   with phase 5 (``partings``) reported (``[deploy]``). Then
   ``score_logprobs`` of two served requests, num_layers flash forward
   launches a call, and ``LlamaDeployment`` at 2 layers of Llama-3-8B's
   widths: 6 concurrent calls through ``@serve.batch``, the batch sizes
   it formed printed (``[deploy-batch]``);
30. the serve runtime on the card: ``serve.run`` of
   ``build_continuous_llama_app``'s app (its card request, ``num_gpus:
   1``, and its bind arguments) with the class swapped for
   ``CountingLlm``, the port's class with a method that reads the
   replica process's launch counts, in one replica process on its own
   card, ``start_http(port=0)``, phase 5's 12 prompts
   as 12 concurrent NDJSON streams over HTTP, 32 tokens each: 32
   in-vocab tokens each and num_layers paged launches a tick inside the
   replica; the replica's cold start, TTFT p50 and tokens/s at the
   client beside phase 29's (``[runtime]``). Then ``serve.drain`` during
   a burst of 8 streams (every stream complete) and a SIGKILL of the
   replica after a greedy stream delivered 8 tokens: the stream finishes
   through the recovery journal on the respawned replica; its agreement
   with the uninterrupted run (``partings``) and the time from the kill
   to the next token reported (``[runtime-drain]``, ``[runtime-kill]``);
31. runtime parity: phase 6's 2-layer fp32 model in a replica on the
   card: the greedy tokens of phase 6's requests over HTTP equal phase
   6's in-process paged engine's (a divergence passes only below
   TOP2_MARGIN), and a kill mid-decode resumes to the same tokens
   (``[runtime-parity]``);
32. the prefill/decode split over the runtime: ``deploy_disagg_llama``
   at Llama-3-8B (phase 5's weights, 8 slots, max_len 2048, block 64;
   the class swapped for ``CountingLlm``), one prefill and one decode
   replica at half a card each on the one card, behind ``start_http``,
   ``RAY_TPU_DISAGG_PREFILL_THRESHOLD=0``: phase 5's 12 prompts as 12
   concurrent NDJSON streams, 32 tokens each: 32 in-vocab tokens each,
   num_layers paged launches a tick in the decode replica and none in
   the prefill replica, one handoff a request; agreement with phase 5
   (``partings``), TTFT p50 and tokens/s at the client beside phase
   30's, the decode replica's tick ms, per request the handoff's MiB,
   ``export_s``, ``channel_s`` and ``import_s``, cold start and each
   replica's peak memory (``[disagg]``). Then a clean run of phase 5's
   request 0 cut to DISAGG["chaos_tokens"], and the same request under
   ``kill_transfer:stage=export`` (one resubmit, one handoff, attempt
   1) and ``stage=import`` (one resume, handoffs of attempts 0 and 1),
   each through the ingress's router with its journal, its tokens equal
   to the clean run's, and the seconds from the firing to the next
   token (``[disagg-chaos]``); then phase 6's 2-layer fp32 model as a
   pair over HTTP: phase 6's greedy tokens, after a ``kill_transfer``
   too (``[disagg-parity]``). No ``/dev/shm/rtch-*`` segment may be
   left that was not there at the start. The ingress's ``GET /metrics``
   around the 12 streams must show the pair's
   ``ray_tpu_serve_kv_transfer_bytes_total`` (export in the prefill
   replica, import in the decode replica) grow by exactly the bytes
   handed off, and each ``kill_transfer`` firing's ``event_id`` must
   root a ``causal_chain`` of the serving process's flight ring that
   reaches the ``serve.resume`` it caused;
33. observability over the runtime (``[observe]``): phase 30's app (one
   replica of Llama-3-8B on its own card, ``CountingLlm``) under
   ``RAY_TPU_TRACING=1``, phase 5's 12 prompts as 12 HTTP streams of 32
   tokens with an ``x-request-id`` each: the tokens equal phase 5's (a
   divergence passes only at a top-2 margin below TOP2_MARGIN, the
   replica's weights); each request one connected trace in the serving
   process rooted at ``serve.ingress``, with ``serve.route``,
   ``engine.queue``, ``engine.prefill`` and >= 1 ``engine.decode_window``
   (the engine's spans from the replica process), its queue, arena-wait
   and prefill spans summing to its time to first token within 10% or 5
   ms (JAX's tolerance); ``GET /metrics`` around the 12 streams shows,
   under the replica's label, 12 more ``SERVE_REQ_TTFT`` observations,
   ``CB_DECODE_TOKENS`` grown by the tokens streamed less the 12 first
   tokens (the prefill's), ``CB_PREFILL_TOKENS`` by the prompts' tokens;
   num_layers B4 launches a tick. Then two bursts of the same 12
   prompts (prefix-cached now) with tracing off, then on (off, on, on,
   off before the cut), toggled in
   both processes: the tick ms and TTFT p50 of each mode (metrics stay
   on; ``[observe-cost]``), and the spans and samples the serving
   process pulled per request. Every replica process has exited and its memory is back
   before phase 10 (``[mem]`` lines at each start and end);
34. the trainer controller (``[train-controller]``): phase 28's model
   and phase 10's batch through ``TorchTrainer.fit(ScalingConfig(
   num_workers=1, use_gpu=True))``, one worker process that owns the
   card (``CUDA_VISIBLE_DEVICES``) and runs ``controller_loop``: the
   batch through ``DevicePrefetcher`` (pinned memory, a side stream),
   ``AsyncStepLoop(sync_every=4)``, a checkpoint-plane save at step 4
   of its 12 (``train.get_checkpoint_plane()``; 8 of 20 before the cut), a
   report a step; a chaos ``kill_worker`` at step 8's report ends the
   process; the controller classifies it ``worker_lost``, tears the
   group down and spawns a new worker, which restores the newest
   committed manifest (step 4) and trains to the end. Gates: every loss from the restored
   step on equals, bit for bit, the same loop run in this process
   without the controller; every loss finite and the run's falling; the
   restored step the newest committed before the kill;
   ``TRAIN_RESTARTS{cause="worker_lost"}`` up by 1; the recovery
   trace's children tiling ``TRAIN_RECOVERY_SECONDS``' value; the
   goodput fractions summing to 1; 2 L / L / L flash launches a step,
   counted in the worker. Prints the step ms (the median of the
   windows after each attempt's first that hold no save: one in the
   worker, two in this process) beside the in-process loop's, the
   recovery seconds and their phases (teardown, backoff,
   reacquire, restore, first step), the blocked ms of each save and the
   goodput fractions. ``--train-controller`` runs this phase alone
   (after the build).
35. the RL loop (``[rl]``): Llama-3-8B widths at RL["layers"] of 32
   layers (bf16, random weights from seed 0 in every
   process: the same cold start), ``build_continuous_llama_app``'s app
   with two ``CountingLlm`` replicas at half a card each (8 slots,
   max_len 1024) behind ``start_http``, a ``WeightPublisher`` for two
   subscribers (its channel sized to the tree; ``/dev/shm``'s free bytes
   printed and checked first) with a ``CheckpointPlane`` under a temp
   dir, each replica's ``enable_weight_sync``, and a ``LearnerGroup``
   of one ``TokenPPOLearner`` on the card (``CountingLearner``: its
   update metrics carry the learner process's launches, peak memory and
   programs). The replica capture's trace goes under the phase's
   scratch dir (``RAY_TPU_SESSION_DIR``) and is removed with it. Two
   rounds: phase 5's first 8 prompts cut to 512 tokens as 8 HTTP
   streams of 32 tokens; behavior logprobs from a replica's
   ``score_logprobs`` with the version that scored them; one PPO update
   through ``RolloutScheduler.learner_phase``; the learner's weights
   published; every replica brought to the version by its weight sync
   or, respawned or shed, by ``restore_weights`` (the slow path). Round
   1 arms ``kill_replica:phase=decode,token=2``. Gates: versions reach
   [2, 2], every loss finite, round 0 all by the fast path with no
   shed and each replica's params equal, bit for bit, to version 1's
   checkpoint (``equals_checkpoint``), the kill fired and a resume was
   counted, an ``rl.weight_swap`` chains to its publish through
   ``causal_chain``, B4 launched in the replicas, B1 in their scoring
   and B1-B3 in the learner, and after the last round a greedy request
   of two fresh prompts to each replica equals an in-process
   ``ContinuousBatcher`` holding the learner's weights. Prints per round
   (``[rl-round]``) rollout s, score s, learner step ms, get-weights s,
   publish s (host copy, save, channel write) and each replica's read,
   crc and swap s (or restore s), converge s and staleness; the kill to
   the version current; then ``[monitor]``: every program's compiles and
   retraces in this process, the replicas and the learner, the PPO
   step's counted FLOPs beside ``rl_grad_flops``, the learner's and the
   replicas' gauges beside the host clock's MFU, memory (the sampler
   beside ``max_memory_allocated``, each process's peak) and a
   ``request_capture`` of one replica while it decodes, which must name
   RL["b4_kernels"]. ``--rl`` runs this phase alone (after the build).
36. the RL library (``[rllib]``): no kernel; the learners' matmuls,
   losses and Adam steps run on the card, the env runners in CPU
   processes of the runtime (no card, one torch thread). Each learner's
   step on the card against the same step on the CPU from the same
   params and batch at the main path's batch shapes (PPO's 256-row
   minibatch, IMPALA's and APPO's 64 x 4 trajectory, DQN's and SAC's
   128 transitions, SAC with fixed noise, DQN through a target copy):
   loss, grads, and params after the CPU's grads applied on both, within
   ``RLLIB["parity"]`` (``[rllib-parity]``). Then with JAX's test
   settings and bars (``RLLIB``) on this script's numpy ``CartPole``,
   ``Pendulum`` and ``MatchGame`` (the port does not depend on gymnasium):
   PPO (4 runners x 4 envs x 64, in-process learner on the card) to a
   mean return of 120 within 25 iterations, a runner SIGKILLed before
   iteration 2 and replaced; IMPALA and APPO (one card learner) to 120
   within 30, IMPALA's runner 0 killed before iteration 2 and
   respawned; DQN to 60 within 40 (the first of ``RLLIB["dqn"]["seeds"]``
   to reach it; every attempt printed); SAC 250 above its first mean
   within 30; multi-agent PPO (a card learner a policy) to 13 within 25
   with both policies' metrics. Gates: every learner's params on the
   card with TF32 off, every runner process with an empty
   ``CUDA_VISIBLE_DEVICES``, no ``/dev/shm/rtch-*`` segment left. Per
   algorithm: iterations, wall s, env steps/s, the median learner update
   ms (a ``LearnerGroup.update`` / ``update_many`` call through the pipe,
   or the in-process ``update_from_batch``), get-weights and broadcast
   ms, the learner's peak device memory, beside the card line.
   ``--rllib`` runs this phase alone (after the build).
37. the core API on the card (``[core]``, ``[core-actor]``, ``[core-dag]``,
   ``[core-hop]``, ``[core-teardown]``): ``ray_tpu_torch.init()`` with no
   arguments (its ``"GPU"`` must equal the cards torch sees); phase 29's
   ``ContinuousLlamaDeployment`` (Llama-3-8B, seed 0 on the card, built
   inside the actor) as a ``num_gpus=1, max_concurrency=16`` actor
   (``CoreLlm``), phase 5's 12 prompts sent at once through
   ``generate.options(num_returns="streaming")`` and each
   ``ObjectRefGenerator`` consumed: ``served_stats``' gates (32 in-vocab
   tokens a stream, 32 paged launches a tick, no dense launch), the
   tokens against phase 29's (``partings``), TTFT p50, tick ms and
   tokens/s at the client beside phase 29's, and the TTFT's medians
   split into the runtime's dispatch, the wait for the engine lock, the
   engine and the store hop back (``actor_ttft_parts``). Then a compiled DAG
   ``InputNode -> CoreRequests.make`` (a CPU actor) ``-> CoreLlm.score``
   in channel mode scores each request's phase-29 tokens: equal bit for
   bit to the same actor's ``.remote`` score, 32 flash forward launches
   each, ms a score both ways. Then two trivial CPU stages compiled
   against the same chain through ``.remote`` and ``get``: the median µs
   of ``CORE["hop_iters"]`` executions each (printed, not gated). Then
   teardown: both DAGs torn down with none of their ``/dev/shm/rtch-*``
   segments left, ``close`` through the actor and ``kill`` (a later call
   raises ``ActorDiedError``), ``shutdown()``; no thread of the runtime
   (or any new thread) left and the card's allocated memory within
   ``CORE["mem_slack_gib"]`` of the phase's start. ``--core`` runs this
   phase alone after the build, first building phase 29's burst in
   process for its yardstick (``[core-yardstick]``), and ends with the
   device line.
38. the data plane on the card. (a) ``[data-train]``: phase 34's model
   (Llama-3-8B widths, CKPT["layers"] layers, bf16) fed from a Dataset:
   ``from_numpy`` of DATA["steps"] batches of token rows (seed
   DATA["seed"]) in DATA["blocks"] blocks, a ``map_batches`` that makes
   the tokens and the loss mask, through ``TorchTrainer(datasets=...,
   ScalingConfig(num_workers=1, use_gpu=True)).fit()``; the worker's
   loop reads ``get_dataset_shard("train").iter_device_batches``. Gates:
   every loss equals, bit for bit, the same batches through the same
   steps in this process; losses finite; 2 L / L / L flash launches a
   step; the shard's bytes shipped with the run call. Prints the bytes,
   ms a step in the worker beside this process's and phase 34's. (b)
   ``[data-llm]``: ``llm.batch_generate`` over a Dataset of phase 5's 12
   prompts in DATA["llm_blocks"] blocks, phase 29's engine (Llama-3-8B,
   32 layers, bf16, seed 0, 8 slots, max_len 2048) built in one pool
   actor on the card, 32 greedy tokens each. Gates: the tokens equal,
   12 of 12, the same engine's ``run_to_completion`` on the same blocks
   in this process, with the same B4 launches; the pool's engine freed
   once its blocks are made (card memory back within
   DATA["mem_slack_gib"]). Prints B4 launches, tokens/s and the memory.
   (c) ``[data-llm-pool]``, where the machine has two cards or more:
   the same with ``concurrency=2`` at DATA["pool_layers"] layers, the
   pool pinning an actor to each of cards 0 and 1. Gates: 12 of 12
   equal the engine's own run on card 0, the same B4 launches, and
   each card's peak memory holds an engine (DATA["pool_engine_gib"]).
   On one card it prints that it did not run.
   ``--data`` runs this phase alone after the build, ``--data-pool``
   part (c) alone;
39. Tune on the card (``[tune]``): a ``Tuner`` with ASHA (grace
   DATA["tune_grace"], reduction 2) over DATA["lrs"], a trial each of
   [data-train]'s trainer for DATA["tune_steps"] steps on its batches,
   as many trials at once as DATA["tune_mem_share"] of the free card
   memory holds (a trial's measured peak, its state bytes included).
   Gates: each trial's losses equal its config run directly in this
   process; ASHA's stops equal the schedule the direct losses give in
   the order the trials reported; flash launches 2 L / L / L a step
   computed. Prints the trials stopped and the launches a trial.
   ``--tune`` runs this phase alone after the build.
40. a composed application on the card (``[serve-graph]``,
   ``[serve-graph-preempt]``, ``[serve-graph-workflow]``,
   ``[serve-graph-state]``). (a) A config document in
   ``serve.build_config``'s shape, its import path this module's
   ``GRAPH_APP``, goes through ``PUT /-/deploy`` on the HTTP ingress:
   the CPU front ``GraphFront`` (COMPACT placement, from the document's
   override) with phase 30's ``CountingLlm`` bound to it (Llama-3-8B, 32
   layers, bf16, seed 0 on the card inside its replica, one card as
   ``build_continuous_llama_app`` asks, the prefix cache off so a prompt
   served again prefills alike). The front forwards each call through
   the handle it was given, from inside its replica process. Phase 5's
   12 prompts go as one burst over HTTP NDJSON and one over gRPC
   ``PredictStream`` (the port's wire codec) through the front. Gates:
   ``served_stats`` on the HTTP burst (32 B4 launches a tick in the
   Llama replica, read through its handle); at least GRAPH["min_equal"]
   prompts equal on HTTP, gRPC and phase 29's engine, and any other
   parting at a bf16 near-tie (``partings`` under the replica's
   weights). (b) A prompt runs alone through the graph, then again, and
   ``publish_preempt(node="*")`` goes once it has delivered
   GRAPH["preempt_after"] tokens. Gates: the stream finishes equal to
   the run before; ``SERVE_REPLICA_DRAINS {cause="preemption"}`` rises
   by 2 (both replicas); a new Llama replica is routed and the prompt
   alone gives the same tokens again. Prints the seconds from the notice
   to the replacement routed and to its first token. (c) A two-step
   workflow (``graph_generate``, then ``graph_score``, whose
   ``score_logprobs`` launches B1 in the Llama replica) runs, then runs
   again with its ``workflow_id``. Gates: the same output, the prompt's
   tokens, finite logprobs <= 0; B4 launched and 32 B1 launches in the
   first run and none in the second; a step that waits for an event runs
   only after ``send_event``. (d) Prints
   ``util.state.summarize_cluster()``, ``list_actors()`` (the two
   replica processes) and ``usage_summary()`` (serve and workflow among
   them). Every replica process has exited and the card's memory is back
   at the end. ``--graph`` runs this phase alone after phase 37's
   yardstick (phase 29's burst in process).
41. The serve autoscaler and the card-pool arbiter (ROADMAP item 19a;
   ``ray_tpu_torch/autoscaler/arbiter.py``). (a) ``[autoscale]``:
   ``CountingLlm`` at Llama-3-8B widths, all 32 layers, half a card a
   replica, phase 29's engine (paged, 8 slots, max_len 2048, block 64,
   greedy, the prefix cache off) with AUTOSCALE["config"] (1 to 2
   replicas on the engines' queue depth). 24 closed-loop HTTP streams
   over phase 5's prompts run until the second replica, on the same
   card, has served AUTOSCALE["second_served"] streams; with the load
   off the fleet drains back to one (one ``scale_down`` drain, its cause
   the ``serve.autoscale`` decision); then ``pool_set_replicas(cap=1)``
   holds one replica for AUTOSCALE["cap_hold_s"] under the same load.
   Gates: no stream dropped; every stream equal to phase 29's tokens for
   its prompt, or to the prompt's tokens prefilled in a batch of 1, 2, 4
   or 8 rows (``held_to_phase29``: decode runs every slot at one shape,
   so only the prefill batch, which the closed loop does not choose,
   moves a stream's bf16 rounding), or parted at a bf16 near-tie; B4 32
   a tick in each replica. Prints the seconds
   from the first decision to the second replica routed, the decisions
   by signal, each replica's B4 launches and peak memory, and the
   drain's outcome. (b) ``[pool]``: the JAX e2e's story
   (``tests/test_pool_arbiter.py::test_diurnal_chip_handoff_e2e``) at
   Llama-3-8B widths with POOL["layers"] of 32 layers: three replicas at
   a quarter card (3 units), a ``TorchTrainer(use_gpu=False)`` of gloo
   CPU workers at world 1 running ``pool_triangle_loop`` (1 unit: one
   card holds no two NCCL ranks, so the train side's units are CPU
   worker slots); a night trickle of one stream at a time, whose p95
   times POOL["slo_factor"] is the SLO guard's latency threshold; the
   diurnal policy leases 2 units (serve drains to one replica, the
   trainer re-forms at world 3) with ``preempt_node:stage=FREEING`` and
   ``kill_arbiter:tick=5`` (a fresh arbiter resumes from the journal);
   a morning burst of POOL["morning"] streams trips the guard and the
   lease returns (3 replicas, world 1). Gates: no violation on any tick;
   no stream dropped; the trainer's loss bit for bit the uninterrupted
   run's; B4 launched. Prints the seconds of each stage and B4 summed
   over the replicas (each replica's last reading, ``CountMonitor``).
   ``--pool`` runs this phase alone after phase 37's yardstick.
42. the cluster runtime (``[cluster]``, ROADMAP item 20a): a
   ``cluster_utils.Cluster`` in this process (a GCS persisting under a
   scratch dir, a 4-CPU head node, a node owning card 0) and
   ``init(address=cluster.address)``; phase 37's ``CoreLlm`` (Llama-3-8B
   at full width, 8 slots, max_len 2048) as ``ClusterLlm``, an actor with
   ``num_gpus=1, max_concurrency=16, max_restarts=1, name="llm"``, which
   the GCS places on the card node and its node manager on a worker it
   forks with ``CUDA_VISIBLE_DEVICES=0`` (its pid and visible devices
   printed; the prefix cache off, as in every phase that serves the
   prompts more than once); phase 5's 12 prompts as 32-token streams through
   ``ObjectRefGenerator``s held to phase 29's tokens by phase 41a's gate,
   B4 counted in the worker at 32 launches a tick; the 12 scored through
   ``actor.score`` (B1 at 32 a call), compared bit for bit with phase
   37's ``.remote`` scores (with the yardstick's in-process scores under
   ``--cluster``) and any mismatch printed as a finding; the GCS
   restarted between two bursts (``rt.get_actor("llm")`` finds the actor
   and the second burst passes the gate); the actor's worker killed
   (SIGKILL), the actor restarted on the card node and one prompt passing
   the gate again, with the seconds from the kill to its first token and
   the card's free memory before and after; teardown leaving no child
   process, no runtime thread, no new segment and the card's free memory
   back within ``CLUSTER["mem_slack_gib"]``. Prints ``init_s``, TTFT p50
   and tick ms beside phase 37's (the yardstick's under ``--cluster``),
   the restart seconds and the launches. ``--cluster`` runs this phase
   and phases 43-44 alone after phase 37's yardstick.
43. the rest of the cluster runtime (ROADMAP item 20a-ii), on phase 42's
   cluster before its teardown. ``[cluster-store]``: the free bytes of
   ``/dev/shm``; the driver ``put``s a host tensor of ``[128256, 4096]``
   bf16 (the embedding's shape, 1.05 GB, drawn on the card from seed 43);
   a method of phase 42's actor ``get``s it, checks that it arrived
   without a copy (its first byte inside the worker's mapping of the
   store segment, ``/proc/self/maps``), uploads it to the card and sums
   it, equal bit for bit to the driver's sum of the same bits; put and
   get GB/s, each node store's used bytes and count, and after ``free``
   the segment gone from ``/dev/shm`` (a ``/dev/shm`` too small fails,
   naming the size). ``[cluster-dag]``: a compiled DAG over the cluster
   (a CPU actor pinned to the head node feeding phase 42's
   ``ClusterLlm.score``, in ``_channel_mode``): its 12 scores equal
   phase 42's ``.remote`` scores bit for bit, B1 counted in the worker at
   32 a score; the hop (the minimum over 3 trials of 60 calls of a
   compiled CPU ``f`` against ``.remote`` on a second actor) beside
   phase 37's; no ``rtch-*`` segment after teardown.
   ``[cluster-serve]``: phase 42's actor closed and killed without
   restart; ``serve.run`` of phase 30's ``CountingLlm`` at Llama-3-8B
   widths (8 slots, max_len 2048, the prefix cache off) with
   ``num_replicas=2`` and ``ray_actor_options={"num_gpus": 0.5}``: the
   GCS places both replicas, as cluster actors, on the card node (each
   one's pid, node id and visible devices printed); the 12 prompts as
   32-token streams through the handle, held to phase 29's tokens by
   phase 41a's gate, B4 counted in each replica's worker at 32 a tick,
   the node stores holding no more objects after the streams than before
   (each streamed token is a store object its stream frees); one
   ``score_logprobs`` (B1 at 32 a call, its logprobs equal to phase 42's
   first score bit for bit); one replica's worker
   SIGKILLed and the next stream through the handle passing the gate
   after its refresh-and-retry (seconds from the kill to its first
   token); TTFT p50 and tick ms beside phase 42's. With the reference
   counts, no explicit free anywhere keeps the stores' count down.
44. the trainer and the object plane on phase 42's cluster (ROADMAP fault
   C9 and item 20b), after ``serve.shutdown()``. ``[cluster-train]``:
   ``TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True))`` runs
   phase 34's model (Llama-3-8B widths at CKPT["layers"] layers, bf16,
   phase 10's optimizer and batch) for CLUSTER_OBJ["train_steps"] steps
   from init in a cluster actor the GCS places on the card node (its
   node id, pid and ``CUDA_VISIBLE_DEVICES`` printed). Gates: the losses
   equal phase 34's in-process first steps bit for bit (under
   ``--cluster`` the same loop runs here first); B1/B2/B3 counted in the
   worker at 2 L / L / L a step; ``CARDS.use()`` the same before, during
   and after; the card node's available GPU 0 in the GCS during the run
   and 1 after. Prints the step ms beside phase 34's and the seconds from
   ``fit()`` to the first report. ``[cluster-refcount]``: the node stores'
   object count back at its count before phase 42's streams without any
   ``free`` (within CLUSTER_OBJ["refcount_s"]); a 1.05 GB ``put`` of
   phase 43's tensor dropped with ``del`` and its segment gone from
   ``/dev/shm`` within CLUSTER_OBJ["del_gone_s"] (the seconds printed).
   ``[cluster-lineage]``: a CPU node (``resources={"pin": 1}``) added; a
   task with a soft affinity to it returns 64 MB of fp32 drawn from seed
   44 on the CPU; the node removed ungracefully; ``get`` rebuilds the
   value from its lineage on another node, equal bit for bit to the same
   draw here (the seconds from the ``get`` to the value printed).
   ``[cluster-spill]``: a node whose store budget
   (``RAY_TPU_OBJECT_STORE_BYTES`` set while it is built) holds one
   ``[128256, 4096]`` bf16 tensor but not two, its spill directory under
   a scratch dir checked for three tensors' disk space; an actor pinned
   there puts three such tensors, their bytes drawn from seeds 45-47; at
   least two spill during the puts, and the driver gets all three back
   bit for bit (spill and restore GB/s printed). ``[cluster-locality]``,
   between the puts and the gets: a CPU task given the first tensor runs
   on the spill node, which holds it, not on the head.
   ``[cluster-teardown]`` (phase 42's, after phase 44): also nothing left
   in the spill directory.

Time: a run may take 1,200 s, and hosts differ ~1.4x in every
host-bound phase. Phase 44 came with cuts of depth inside paths to
pay for it: phases 10, 25 and 26c train 8 of Llama-3-8B's 32 layers (16
before), phases 24 and 27 2 of Mixtral's (4 before), phase 34 takes 12
steps with its save at 4 and its kill at 8 (20, 8 and 12 before), phase
19's buffered and adaptive runs serve 4 requests (12 before), phase 33
times two bursts (four before), phase 41a's second replica serves 6
streams before the load goes off (12 before) and phase 35's capture
lasts 1 s (2 before). Earlier phases were paid for by cutting the
checkpoint model of phases 28, 34, 38 and 39 to one layer and phase 35
to two rounds.

Phases 23-24 run before phases 25-28 (27 compares with 24), phases
11-12 after phases 3-4; 13, 15, 17, 18, 19 and 21 inside
phase 5 and 16, 20 and 22 inside phase 6, where their models already live
(15, 17, 19 and 21 before phase 5's profiles, which would slow their
host-clock times).

The line before the last is the kernels' JSON record (the paged and dense
entries also carry ``spec_launches``, their launches in phase 19's
self-draft and external-drafter runs, the paged entry
``split_launches``, the decode engine's launches in phase 21's bf16 run,
the paged entry ``deployment_launches``, ``replica_launches`` and
``disagg_launches`` and ``observe_launches``, its launches in phases 29,
30, 32's (the decode replica's) and 33's traced 12 streams, the flash
forward entry
``deployment_scoring_launches``, its launches in phase 29's two scoring
calls, and the flash entries ``mixtral_launches``, their launches in
phase 24's run, ``mixtral_mesh_launches``, their launches in phase 27's run,
``sharded_launches``, their launches in phase 25's 12 steps,
``ulysses_launches``, their launches in phase 26b,
``controller_launches``, their launches in phase 34's worker, reported
steps, ``rl_launches``, their launches in phase 35's learner,
``data_launches``, their launches in phase 38a's worker, and
``tune_launches``, theirs over phase 39's trials; the paged entry's
``batch_launches`` are phase 38b's pool actor's; the
paged entry's ``rl_launches`` are phase 35's replicas' over the rounds'
rollouts and the flash forward's ``rl_scoring_launches`` their
``score_logprobs`` calls; the paged entry's ``core_launches`` are phase
37's actor's over its 12 streams and the flash forward's
``core_scoring_launches`` its 12 scores through the compiled DAG; the
paged entry's ``cluster_launches`` are phase 42's cluster actor's over
its first burst, counted in its worker, and the flash forward's
``cluster_scoring_launches`` its 12 scores; the paged entry's
``cluster_serve_launches`` are phase 43's two serve replicas' (cluster
actors) over the 12 streams, counted in their workers, and the flash
forward's ``cluster_dag_launches`` phase 43's 12 scores through the
compiled DAG over the cluster; the flash entries' ``cluster_train_launches``
are phase 44's cluster worker's over its steps; the
paged entry's ``graph_launches`` are phase 40's Llama replica's over the
HTTP burst through the graph and its ``workflow_launches`` over the
workflow's first run, whose scoring step gives the flash forward's
``workflow_scoring_launches``; its ``autoscale_launches`` are phase
41a's two replicas' and its ``pool_launches`` phase 41b's replicas');
the last line is ``{"ok": true, "device": {...}}``. Before the record,
the script stops every process the port's runtime started (the replica
and worker processes, their fork server and resource tracker:
``runtime.replica.stop_all``) and fails if a child of its own is still
running (:func:`stop_processes`).

``python3 chip_smoke.py --mesh-check`` instead needs four cards: it
spawns four ranks of one NCCL group (``tcp://localhost``, a free port)
and runs on four-rank meshes (``MESH_CHECK``): ``ShardedTrainer`` with
phase 25's tiny fp32 model at fsdp=4, fsdp=2 x tensor=2, tensor=4 (its 2
kv heads stay whole), data=2 x fsdp=2 with 2 microbatches, and with ring
attention at tensor=2 x seq=2, fsdp=2 x seq=2 and seq=4, 3 steps each,
every loss within ``SHARDED["tol"]`` and every grad norm within 1e-4 of
the one-device trainer on rank 0, each rank holding its share of
``w_gate`` and launching the flash kernels (none on a seq axis)
(``[mesh-check]``); ``ulysses_attention`` at seq=4 on phase 26b's shape
against ``mha_reference``, one launch of each flash kernel a rank
(``[mesh-ulysses]``); ``pipelined`` at stage=4 and stage=2 x fsdp=2,
output and grads against the sequential stages on every rank
(``[mesh-pipeline]``); then phase 10's model at fsdp=4 (a 4 x 2048
batch, one row a rank) and at seq=4 (one 8,192-token row) for
``MESH_CHECK["steps"]`` steps: step ms, tokens/s a card, MFU, peak and
launches (``[mesh-train]``). Then expert parallelism (``MESH_MOE``): a
tiny fp32 Mixtral at head dim 128, capacity 0.5, at expert=4, expert=2
x fsdp=2 and expert=2 x tensor=2, 3 steps each, loss and grad norm
within 1e-5 of one device on rank 0, each rank holding X / expert of
the experts (``[mesh-moe]``); Mixtral-8x7B widths at 16 of 32 layers on
expert=2 x fsdp=2, phase 10's 2 x 2048 batch, 5 steps: step ms, tokens/s
a card, MFU over the active params and peak (``[mesh-mixtral]``); phase
28's model after one step saved at fsdp=4 (a shard a rank, a TCPStore
KV), restored at fsdp=2 x tensor=2 and on rank 0 alone, bit for bit
(``[mesh-ckpt]``); then ``TorchTrainer`` with four NCCL workers (a card
each) on phase 25's fp32 model at fsdp=4, a chaos ``kill_worker`` whose
node is lost (``resize=2``) restarting them on fsdp=2 from the newest
committed manifest, ``request_resize(4)`` growing them back, every loss
within ``MESH_CONTROLLER["tol"]`` of the uninterrupted fsdp=4 run
(``[mesh-train-controller]``); then the host collective
(``mesh_collective``): named NCCL and gloo groups beside the default
group, every op against numpy, and an allreduce of each size of
``COLLECTIVE["sizes_mib"]`` timed
(``[mesh-collective]``); then ``mesh_rllib``: ``ImpalaLearner`` on two
card learners over NCCL (a card each), bit for bit the same over
``MESH_RLLIB["updates"]`` updates, and two ``SGDImpalaLearner``s' step
equal to one card learner's on the whole batch within rtol 1e-5 / atol
1e-6 (``[mesh-rllib]``); then ``mesh_pool``: phase 41b's story over
the four whole cards, three replicas at a card each and a ``use_gpu``
trainer at world 1 whose steps also all-reduce a card tensor over NCCL;
the world-3 ranks take the cards the drained replicas and the trainer
held, disjoint from the serve side's, and the replicas come back on the
cards the world-3 group gave back (``[mesh-pool]``). ``--mesh-check
SECTION ...`` runs only the named sections of ``MESH_SECTIONS``
(trainer, moe, mixtral, ckpt, train-controller, collective, rllib,
pool). It prints no result line.

``python3 chip_smoke.py --paged-host-us ROOT`` instead measures only the
host microseconds a paged call takes (``host_us``, the phase-3 cases at
32 table entries) with the ``ray_tpu_torch`` package under ROOT, so two
checkouts' wrappers can be compared on one card; it prints one
``[host]`` JSON line. ``python3 chip_smoke.py --dense-ms ROOT`` likewise
times only the dense kernel of ROOT's package at the timed phase-12
cases (kernel ms, L2 flushed, and host microseconds a call) and prints
one ``[dense-ms]`` JSON line. ``python3 chip_smoke.py --serve-ticks``
splits the deployment's tick (:func:`serve_ticks`): phase 29's engine
stepped by phase 5's loop, by the tick thread under 12 stream threads and
under one reader, in process and in a replica process; per burst the
decode steps' wall and CPU ms, the gaps between steps and, under the
profiler, device busy ms (``[ticks]`` lines, no result line).
``python3 chip_smoke.py --channel-mbs`` times only the split's shm
channel (:func:`channel_mbs`; one ``[channel]`` line, no result line).
``python3 chip_smoke.py --runtime-ttft`` serves phase 30's burst alone
with the ``ray_tpu_torch`` beside the script, three times, the prefix
cache off so every burst prefills alike (:func:`runtime_ttft`; one
``[ttft]`` line, no result line): copy this script into another
checkout to time that checkout's package on the same card.
"""

import dataclasses
import gc
import http.client
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

import ray_tpu_torch.serve as tserve
from ray_tpu_torch.llm import ContinuousLlamaDeployment
from ray_tpu_torch.rl import TokenPPOLearner
from ray_tpu_torch.rllib.core import DQNLearner, ImpalaLearner, SACLearner

PEAK_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
FLASH_SHAPE = dict(B=2, HQ=32, KVH=8, D=128)
# (name, dtype, causal, sq, sk, atol, rtol) for out, dq, dk, dv: fp32 is
# the same math in another summation order; bf16 outputs round once to
# bf16 (~2^-8 relative). lse is fp32 in every case: FLASH_LSE_ATOL.
FLASH_CASES = [("bf16", "bf16", True, 2048, 2048, 2e-2, 2e-2),
               ("fp32", "fp32", True, 2048, 2048, 1e-4, 1e-4),
               ("noncausal-bf16", "bf16", False, 2048, 2048, 2e-2, 2e-2),
               ("cross-bf16", "bf16", True, 1024, 2048, 2e-2, 2e-2)]
FLASH_LSE_ATOL = 1e-4
FLASH_TIMED = ("bf16", "fp32")
FLASH_REPLACES = {"fwd": "ray_tpu/ops/attention.py:74",
                  "dq": "ray_tpu/ops/attention.py:170",
                  "dkv": "ray_tpu/ops/attention.py:207"}
# Model parity (phase 9): loss within this relative error, each grad leaf
# within this share of its largest entry (fp32 attention in another
# summation order, carried through two layers).
MODEL_LOSS_RTOL = 1e-5
MODEL_GRAD_TOL = 1e-4
TRAIN = dict(layers=8, batch=2, seq=2048, steps=12, warmup=5, total=1000,
             last_loss_below=0.5)
# Phases 23-24: Mixtral-8x7B's published widths (MixtralConfig.mixtral_8x7b)
# cut in depth: 2 layers in fp32 for parity (3.16 B params, 12.7 GB, and
# as much again of grads a run); 2 of 32 layers in bf16 for training too
# since phase 44 came (4 before, 6.07 B params: params, grads and both bf16
# moments took 48.5 GB; 6 layers would take 71.8 GB before activations).
# Phase 25: the sharded trainer on a one-rank mesh; its tiny fp32 parity
# model takes the flash path (head dim 128).
SHARDED = dict(tol=1e-5, peak_gib=70.0, parity_steps=2)
SHARDED_PARITY = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2,
                      head_dim=128, max_seq_len=256, batch=2, seq=256)
# Phase 26: the seq path on phase 25's one-rank mesh. 26a: phase 25's
# parity model with ring attention against the one-device fp32 flash
# kernels (loss within SHARDED["tol"], grads within MODEL_GRAD_TOL); 26b:
# Ulysses at FLASH_CASES[0] (the training attention shape, bf16, causal)
# against mha_reference at that case's tolerances; 26c: phase 10's run
# with ring attention, step 1's loss within loss_rtol of phase 10's (fp32
# block math against the bf16 flash kernels: rounding only).
SEQ = dict(loss_rtol=1e-3, peak_gib=70.0, ulysses_seed=40, timed_iters=5)
# --mesh-check: four ranks, phase 25's parity model on seven layouts
# (name, mesh sizes, microbatches; ring attention on the seq layouts),
# Ulysses at seq=4 on phase 26b's shape, the two pipelines of
# tests/test_moe_pipeline.py (name, mesh sizes, stages, width,
# microbatches, rows), then phase 10's model at fsdp=4 (a 2048-token row
# a rank) and at seq=4 (one row of Llama-3-8B's published 8,192-token
# context).
MESH_CHECK = dict(world=4, parity_steps=3, batch=8, layouts=[
    ("fsdp4", dict(fsdp=4), 1), ("fsdp2_tp2", dict(fsdp=2, tensor=2), 1),
    ("tp4_kv2", dict(fsdp=1, tensor=4), 1),
    ("dp2_fsdp2_micro2", dict(data=2, fsdp=2), 2),
    ("tp2_sp2", dict(fsdp=1, tensor=2, seq=2), 1),
    ("fsdp2_sp2", dict(fsdp=2, seq=2), 1), ("sp4", dict(fsdp=1, seq=4), 1)],
    ulysses_mesh=dict(fsdp=1, seq=4),
    pipelines=[("stage4", dict(stage=4, fsdp=1), 4, 16, 8, 32),
               ("stage2_fsdp2", dict(stage=2, fsdp=2), 2, 8, 4, 8)],
    train=[("fsdp4", dict(fsdp=4), 4, 2048), ("sp4", dict(fsdp=1, seq=4), 1,
                                              8192)],
    steps=8)
MIXTRAL_PARITY = dict(layers=2, seq=512)
MIXTRAL_TRAIN = dict(layers=2, batch=2, seq=2048, steps=12, warmup=5,
                     total=1000, peak_gib=70.0)
# Phase 28: ShardedTrainer at Llama-3-8B widths cut to 1 layer (1.27 B
# params; bf16 params and both bf16 moments, 7.6 GB a saved step), phase
# 10's batch and optimizer; two steps saved, so the temp dir's file
# system must hold disk_margin x two steps. Phases 34, 38 and 39 train
# the same model. One layer, not two, keeps the whole script under its
# time limit with phase 43: the state is mostly the embedding and the
# head, which stay at full width.
CKPT = dict(layers=1, disk_margin=1.2)
# --mesh-check's expert-parallel sections. moe: a tiny fp32 Mixtral at
# head dim 128 (the fp32 flash kernels run), pairs dropping at capacity
# 0.5, on each layout against one device on rank 0; mixtral: Mixtral-8x7B
# widths at 16 of 32 layers on expert=2 x fsdp=2 (~6.1 B params a card),
# phase 10's batch, a row for each fsdp group; ckpt: phase 28's model
# saved at fsdp=4, restored at fsdp=2 x tensor=2 and on one rank.
MESH_MOE = dict(
    config=dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
                max_seq_len=256, num_experts=4, top_k=2,
                capacity_factor=0.5),
    batch=4, seq=256, steps=3, tol=1e-5,
    layouts=[("expert4", dict(expert=4, fsdp=1)),
             ("expert2_fsdp2", dict(expert=2, fsdp=2)),
             ("expert2_tp2", dict(expert=2, tensor=2, fsdp=1))],
    train=dict(layers=16, sizes=dict(expert=2, fsdp=2), steps=5,
               peak_gib=75.0),
    ckpt=dict(save=dict(fsdp=4), restore=dict(fsdp=2, tensor=2)))
MESH_SECTIONS = ("trainer", "moe", "mixtral", "ckpt", "train-controller",
                 "collective", "rllib", "pool")
# Device kernels of the MoE routing by name (after flash and GEMMs): the
# stable sort of top-k, the cumsum of the slots, the index copies and
# gathers and the one-hot scatters. The embedding lookup and its
# backward and the loss's target gather match too (a few of a step's).
ROUTING_KERNELS = re.compile(r"sort|scan|index|gather|scatter", re.I)
# (name, q dtype, arena kind, table entries, positions, atol, rtol): fp32
# is exact math in another summation order; bf16/int8 outputs round to
# bf16 (~2^-8 relative).
SHAPE = dict(B=8, HQ=32, KVH=8, D=128, BS=64, NB=32)
POSITIONS = [0, 63, 64, 700, 1023, 1500, 2047, 0]   # last slot: freed
LONG_POSITIONS = [0, 63, 2047, 4095, 4096, 6000, 8191, 0]
FREED_SLOT = 7
CASES = [("bf16", "bf16", "bf16", 32, POSITIONS, 2e-2, 2e-2),
         ("fp32", "fp32", "fp32", 32, POSITIONS, 1e-5, 0.0),
         ("int8", "bf16", "int8", 32, POSITIONS, 2e-2, 2e-2),
         ("long-bf16", "bf16", "bf16", 128, LONG_POSITIONS, 2e-2, 2e-2),
         ("long-fp32", "fp32", "fp32", 128, LONG_POSITIONS, 1e-5, 0.0)]
# Dense kernel cases (name, cache dtype, S_max, layers of the cache the
# case views one of (0: a contiguous cache), positions, atol, rtol): fp32
# is exact math in another summation order; bf16 outputs round once to
# bf16 (~2^-8 relative). The long caches (S_max 8192, 268 MB of bf16 K/V)
# are where one block's walk of a slot was longest. The drafter case is
# the external drafter's step of phase 19 (Llama-3.2-1B's heads, D=64, a
# layer of its [16, 8, 2048, 8, 64] cache; DENSE_SHAPES).
DENSE_CASES = [("bf16", "bf16", 2048, 0, POSITIONS, 2e-2, 2e-2),
               ("fp32", "fp32", 2048, 0, POSITIONS, 1e-5, 0.0),
               ("layer-view-bf16", "bf16", 2048, 2, POSITIONS, 2e-2, 2e-2),
               ("ragged-1000-bf16", "bf16", 1000, 0, POSITIONS, 2e-2,
                2e-2),
               ("long-bf16", "bf16", 8192, 0, LONG_POSITIONS, 2e-2, 2e-2),
               ("long-fp32", "fp32", 8192, 0, LONG_POSITIONS, 1e-5, 0.0),
               ("drafter-d64-bf16", "bf16", 2048, 16, POSITIONS, 2e-2,
                2e-2)]
DENSE_TIMED = ("bf16", "fp32", "long-bf16", "long-fp32", "drafter-d64-bf16")
# Llama-3.2-1B's published widths: phase 19's external drafter and the
# drafter dense case (random weights from seed 1).
DRAFTER = dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
               num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
               rope_theta=500000.0)
DENSE_SHAPES = {"drafter-d64-bf16": dict(B=8, HQ=DRAFTER["num_heads"],
                                         KVH=DRAFTER["num_kv_heads"],
                                         D=DRAFTER["head_dim"])}
TOP2_MARGIN = 1e-4
# Phase 15: 12 requests sharing a 1,024-token prefix (numpy seed 1), tails
# of 17-300 tokens, 32 new tokens each, after one warm request of the
# prefix.
PREFIX = dict(tokens=1024, seed=1, requests=12, tail=(17, 301), max_new=32)
# Phase 18: the phase-5 requests scored, and the tolerance of the flash
# kernel's logprobs against attention_kernel=False: the bf16 flash cases'.
# Random weights put every served token's logprob near -log(vocab), so
# that comparison alone cannot tell a wrong attention from a right one:
# each layer's flash forward is also held, at SCORE_TOL, against its plain
# version on the q/k/v scoring gave it, and three wrong attentions
# (no causal mask, each row's own SCORE_CONTROL_BLOCK-key block skipped,
# zeros) must each fall outside SCORE_TOL there.
SCORE_REQUESTS = (0, 1)
SCORE_TOL = (2e-2, 2e-2)
SCORE_CONTROL_BLOCK = 64
# Phase 19: speculative decode at k = 4 with the ladder held (runs that
# say otherwise aside); one tick's layer-0 paged launches are held to the
# plain version at the phase-3 bf16 tolerance.
SPEC_RUN = dict(spec_k=4, spec_adaptive=False)
SPEC_CHECK_TOL = (2e-2, 2e-2)
# Phase 20: sampled spec decode's settings.
SPEC_SAMPLING = dict(temperature=0.8, top_p=0.9, seed=11)


def fail(msg):
    """Print ``msg`` and end the process with code 1 at once: the exit
    handlers (the runtime's ``stop_all`` among them) get 60 s, and no
    thread still waiting on a replica (an HTTP stream's worker) holds
    the interpreter's shutdown."""
    import atexit

    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    handlers = threading.Thread(target=atexit._run_exitfuncs, daemon=True)
    handlers.start()
    handlers.join(60)
    sys.stdout.flush()
    os._exit(1)


def stop_processes():
    """Stop what the port's runtime started and fail if a child of this
    process still runs: nothing the script starts outlives it."""
    from ray_tpu_torch.runtime import replica

    replica.stop_all()
    me, left = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()[:160]
        except OSError:
            continue               # it ended while we read it
        if ppid == me and state != "Z":
            left.append(f"{pid} {cmd}")
    if left:
        fail(f"processes still running: {left}")
    print("[processes] every child stopped")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"


def make_case(torch, kind, q_kind, seed, nb=SHAPE["NB"],
              positions=POSITIONS):
    from ray_tpu_torch.models.paged_kv import quantize_kv

    s = SHAPE
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nblocks = s["B"] * nb + 1
    perm = (torch.randperm(nblocks - 1, generator=gen, device="cuda")
            + 1).tolist()
    tables = torch.zeros((s["B"], nb), dtype=torch.int32)
    for b, p in enumerate(positions):
        if b == FREED_SLOT:
            continue                       # whole row on the garbage block
        live = min(p // s["BS"] + 1, nb)
        ids = perm[b * nb:b * nb + live]
        tables[b, :live] = torch.tensor(ids)
        tables[b, live:] = ids[-1]
    shape = (nblocks, s["BS"], s["KVH"], s["D"])
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    q = torch.randn((s["B"], s["HQ"], s["D"]), generator=gen,
                    device="cuda").to(dt[q_kind])
    ks = vs = None
    if kind == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(dt[kind]), v.to(dt[kind])
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, tables=tables.to("cuda"),
                pos=torch.tensor(positions, dtype=torch.int32,
                                 device="cuda"), positions=positions, nb=nb)


def bound(kind, c):
    """Least time for the work these inputs need: live K/V rows (and
    their int8 scales), the live table entries, positions, q and out, each
    moved once; and 4*Hq*D operations per live token."""
    s = SHAPE
    live = [min(p + 1, c["nb"] * s["BS"]) for p in c["positions"]]
    item = c["k"].element_size()
    nbytes = sum(live) * s["KVH"] * s["D"] * item * 2
    if kind == "int8":
        nbytes += sum(live) * s["KVH"] * 4 * 2
    nbytes += sum(-(-n // s["BS"]) for n in live) * 4 + s["B"] * 4
    nbytes += 2 * c["q"].numel() * c["q"].element_size()
    ops = sum(live) * 4 * s["HQ"] * s["D"]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def split_layout(torch, c):
    """The layout the wrapper hands the kernel for this case's shapes
    (``paged_layout``: split count and chunk tokens), and the split blocks
    whose chunk holds one of the slot's tokens, counted here from the
    positions (the kernel does not report them). Printed, not recorded."""
    from ray_tpu_torch.ops import paged_decode_attention as pda

    s = SHAPE
    gt, splits, chunk = pda.paged_layout(
        s["B"], s["HQ"], s["KVH"], c["nb"], s["BS"],
        torch.cuda.get_device_properties(0).multi_processor_count)
    live = sum(-(-min(p + 1, c["nb"] * s["BS"]) // chunk)
               for p in c["positions"])
    return splits, chunk, live * s["HQ"] // gt


def host_us(torch, fn, calls=32, bursts=20):
    """Host microseconds a call takes to return (its checks, allocations
    and launches; the device's work queues up behind): the median over
    ``bursts`` of ``calls`` back-to-back calls with no sync between them,
    over ``calls``. 32 calls are one paged tick's attention."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(bursts):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def time_ms(torch, fn, flush, iters=50):
    """Median of per-launch CUDA-event times, L2 flushed before each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def kernel_phases(torch):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.paged_decode_attention import (
        gather_kv, paged_attention_reference, paged_decode_attention)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for name, q_kind, kind, nb, positions, atol, rtol in CASES:
        c = make_case(torch, kind, q_kind, seed=len(results), nb=nb,
                      positions=positions)
        args = (c["q"], c["k"], c["v"], c["tables"], c["pos"])
        kw = dict(k_scale=c["ks"], v_scale=c["vs"])
        out = paged_decode_attention(*args, use_kernel=True, **kw)
        ref = paged_attention_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        bad = err > atol + rtol * ref.float().abs()
        max_err = float(err.max())
        print(f"[kernel] {name} ({nb} table entries): max_abs_err="
              f"{max_err:.3e} (atol {atol}, rtol {rtol})")
        if not torch.isfinite(out.float()).all() or bool(bad.any()):
            fail(f"kernel disagrees with plain version ({name}): "
                 f"max_abs_err={max_err}, {int(bad.sum())} elements out")
        kernel_ms = time_ms(torch, lambda: paged_decode_attention(
            *args, use_kernel=True, **kw), flush)
        plain_ms = time_ms(torch, lambda: paged_attention_reference(
            *args, **kw), flush)
        library_ms = None
        if kind != "int8":
            q4 = c["q"][:, :, None, :]
            kd = gather_kv(c["k"], c["tables"]).transpose(1, 2).contiguous()
            vd = gather_kv(c["v"], c["tables"]).transpose(1, 2).contiguous()
            cols = torch.arange(kd.shape[2], device="cuda")
            mask = (c["pos"][:, None] >= cols[None, :])[:, None, None, :]
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask, enable_gqa=True), flush)
        bound_ms, bound_by = bound(kind, c)
        splits, chunk, blocks = split_layout(torch, c)
        call_host_us = host_us(torch, lambda: paged_decode_attention(
            *args, use_kernel=True, **kw))
        results[name] = dict(max_abs_err=max_err, ms=kernel_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             host_us=call_host_us)
        print(f"[timing] {name}: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); {splits} splits of "
              f"{chunk} tokens, {blocks} live blocks; host us a call "
              f"{call_host_us:.2f}")
    del flush
    return results


def dense_bound(c):
    """Least time for the work these inputs need: live K/V rows,
    positions, q and out, each moved once; and 4*Hq*D operations per live
    token."""
    s = c["shape"]
    s_max = c["k"].shape[1]
    live = sum(min(p + 1, s_max) for p in c["positions"])
    nbytes = (live * s["KVH"] * s["D"] * c["k"].element_size() * 2
              + s["B"] * 4 + 2 * c["q"].numel() * c["q"].element_size())
    ops = live * 4 * s["HQ"] * s["D"]
    kind = "bf16" if c["k"].element_size() == 2 else "fp32"
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", live, nbytes)


def dense_case(torch, name, kind, s_max, layers, positions, seed):
    s = DENSE_SHAPES.get(name, SHAPE)
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[kind]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = (layers,) if layers else ()
    shape = lead + (s["B"], s_max, s["KVH"], s["D"])
    k = torch.randn(shape, generator=gen, device="cuda").to(dt)
    v = torch.randn(shape, generator=gen, device="cuda").to(dt)
    if layers:
        k, v = k[1], v[1]       # what the engine hands in: cache.k[li]
    q = torch.randn((s["B"], s["HQ"], s["D"]), generator=gen,
                    device="cuda").to(dt)
    return dict(q=q, k=k, v=v, positions=positions, shape=s,
                pos=torch.tensor(positions, dtype=torch.int32,
                                 device="cuda"))


def dense_split_layout(torch, c):
    """The layout the wrapper hands the dense kernel for this case's
    shapes (``dense_layout``: split count and chunk tokens), and the split
    blocks whose chunk holds one of the slot's tokens, counted here from
    the positions. Printed, not recorded."""
    from ray_tpu_torch.ops import decode_attention as da

    s = c["shape"]
    s_max = c["k"].shape[1]
    gt, splits, chunk = da.dense_layout(
        s["B"], s["HQ"], s["KVH"], s_max,
        torch.cuda.get_device_properties(0).multi_processor_count)
    live = sum(-(-min(p + 1, s_max) // chunk) for p in c["positions"])
    return splits, chunk, live * s["HQ"] // gt


def dense_kernel_phases(torch):
    """Phases 11-12: the dense kernel against its plain version, and its
    time beside the plain version's, SDPA's and the bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for i, (name, kind, s_max, layers, positions, atol, rtol) in \
            enumerate(DENSE_CASES):
        c = dense_case(torch, name, kind, s_max, layers, positions,
                       seed=20 + i)
        args = (c["q"], c["k"], c["v"], c["pos"])
        out = decode_attention(*args, use_kernel=True)
        ref = decode_attention_reference(*args)
        torch.cuda.synchronize()
        err, ok, n_bad = close(torch, out, ref, atol, rtol)
        print(f"[dense-kernel] {name} (S_max={s_max}, strides "
              f"{tuple(c['k'].stride())}): max_abs_err={err:.3e} "
              f"(atol {atol}, rtol {rtol})")
        if not ok or out.dtype != ref.dtype:
            fail(f"dense kernel disagrees with plain version ({name}): "
                 f"max_abs_err={err}, {n_bad} elements out")
        res = dict(max_abs_err=err)
        if name in DENSE_TIMED:
            res["ms"] = time_ms(torch, lambda: decode_attention(
                *args, use_kernel=True), flush)
            res["plain_ms"] = time_ms(torch, lambda: decode_attention_reference(
                *args), flush)
            q4 = c["q"][:, :, None, :]
            kd = c["k"].transpose(1, 2).contiguous()
            vd = c["v"].transpose(1, 2).contiguous()
            cols = torch.arange(s_max, device="cuda")
            mask = (c["pos"][:, None] >= cols[None, :])[:, None, None, :]
            res["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, kd, vd, attn_mask=mask, enable_gqa=True), flush)
            (res["bound_ms"], res["bound_by"], res["live_tokens"],
             res["bytes"]) = dense_bound(c)
            res["host_us"] = host_us(torch, lambda: decode_attention(
                *args, use_kernel=True))
            splits, chunk, blocks = dense_split_layout(torch, c)
            print(f"[dense-timing] {name}: kernel {res['ms']:.4f} ms, "
                  f"plain {res['plain_ms']:.4f} ms, library "
                  f"{res['library_ms']:.4f} ms, bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']}; "
                  f"{res['live_tokens']} live tokens, {res['bytes']} "
                  f"bytes); {splits} splits of {chunk} tokens, {blocks} "
                  f"live blocks; host us a call {res['host_us']:.2f}")
        results[name] = res
    del flush
    torch.cuda.empty_cache()
    return results


def serve(torch, cfg, params, prompts, max_new, warm=None, **kw):
    """Drive the engine over ``prompts`` after a warm-up (``warm``: prompts
    run to completion first, 2 tokens each; by default a 16-token slice of
    the first prompt; ``[]`` for none); returns (outputs by request,
    stats). Every launch count is set to 0 just before the measured run
    and read just after it."""
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import (
        paged_decode_attention, paged_layout)

    first = {}
    eng = ContinuousBatcher(cfg, params=params, num_slots=8, max_len=2048,
                            block_size=64, token_callback=lambda r, t:
                            first.setdefault(r, time.perf_counter()), **kw)
    for p in [prompts[0][:16]] if warm is None else warm:
        eng.submit(p, max_new_tokens=2)
    eng.run_to_completion()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks0, spec0, pre0 = (eng.base_tick_count, eng.spec_tick_count,
                           eng.prefill_seconds)
    dec0, ptok0, hit0, pb0 = (eng.decoded_tokens, eng.prefill_tokens,
                              eng.prefix_hit_tokens, eng.prefill_batches)
    rungs0 = dict(eng._spec_ticks)
    drafted0, accepted0 = eng.spec_draft_tokens, eng.spec_accepted_tokens
    reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged": paged_decode_attention.launches,
                "dense": decode_attention.launches}
    base_ticks = eng.base_tick_count - ticks0
    spec_ticks = eng.spec_tick_count - spec0
    ticks = base_ticks + spec_ticks
    decode_s = wall - (eng.prefill_seconds - pre0)
    drafted = eng.spec_draft_tokens - drafted0
    accepted = eng.spec_accepted_tokens - accepted0
    external = bool(eng.spec_k and eng.drafter.external)
    stats = dict(
        requests=len(prompts), ticks=ticks, base_ticks=base_ticks,
        spec_ticks=spec_ticks, launches=launches,
        wall_s=wall, ttft_p50_ms=float(np.median(
            [first[r] - t0 for r in rids])) * 1e3,
        tick_ms=decode_s / max(ticks, 1) * 1e3,
        decode_tok_s=(eng.decoded_tokens - dec0) / decode_s,
        prefill_s=eng.prefill_seconds - pre0,
        prefill_batches=eng.prefill_batches - pb0,
        prefill_tokens=eng.prefill_tokens - ptok0,
        prefix_hit_tokens=eng.prefix_hit_tokens - hit0,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        kernel=eng.use_decode_kernel, paged=eng.paged,
        prefix_cache=eng.prefix_cache, sync_every=eng.sync_every,
        kv_dtype=eng.kv_dtype)
    if eng.paged:
        # (group tile, splits, chunk tokens) the paged wrapper picks from
        # the shapes: a spec engine's table is wider (max_len + spec_k).
        stats["table_entries"] = eng.max_blocks
        stats["paged_layout"] = paged_layout(
            eng.num_slots, cfg.num_heads, cfg.num_kv_heads, eng.max_blocks,
            eng.block_size,
            torch.cuda.get_device_properties(0).multi_processor_count)
    if eng.spec_k:
        # Ticks at each rung k in this run, and the draft depth: the
        # launch counts follow from them (want_launches).
        stats.update(
            spec_k=eng.spec_k, spec_adaptive=eng.spec_adaptive,
            spec_rungs={k: n - rungs0.get(k, 0)
                        for k, n in sorted(eng._spec_ticks.items())
                        if n > rungs0.get(k, 0)},
            draft_layers=0 if external else eng.spec_draft_layers,
            drafter_layers=eng.spec_draft_layers if external else 0,
            drafted=drafted, accepted=accepted,
            accept_rate=accepted / drafted if drafted else 0.0,
            committed_per_tick=(eng.decoded_tokens - dec0) / max(ticks, 1),
            # Tokens a slot commits a spec tick (k fixed: drafted / k
            # slot rows ran).
            committed_per_slot_tick=(
                (eng.decoded_tokens - dec0) / (drafted / eng.spec_k)
                if drafted and not eng.spec_adaptive else None),
            final_k=eng._spec_cur_k)
    return [out[r] for r in rids], stats


def want_launches(st, num_layers):
    """Decode-kernel launches the run must count: num_layers a plain tick
    on the engine's own plane; a spec tick at rung k launches the paged
    kernel (k + 1) num_layers times in verify and, per draft step,
    draft_layers times (self-draft, paged) or drafter_layers times (an
    external drafter, dense). The plain versions launch nothing."""
    want = {"paged": 0, "dense": 0}
    if not st["kernel"]:
        return want
    want["paged" if st["paged"] else "dense"] += num_layers * st["base_ticks"]
    for k, n in st.get("spec_rungs", {}).items():
        want["paged"] += n * (k + 1) * num_layers
        if st["drafter_layers"]:
            want["dense"] += n * k * st["drafter_layers"]
        else:
            want["paged"] += n * k * st["draft_layers"]
    return want


def check_launches(st, num_layers, what):
    """The run launched the decode kernels ``want_launches`` says: on a
    plain engine, its own kernel num_layers times a tick and the other
    never."""
    want = want_launches(st, num_layers)
    if st["launches"] != want:
        fail(f"{what}: launches {st['launches']} for {st['base_ticks']} "
             f"plain and {st['spec_ticks']} spec ticks x {num_layers} "
             f"layers (want {want})")


def profile_ticks(torch, cfg, params, prompts, n_ticks=5, **kw):
    """Device time of decode ticks with 8 active slots, by kernel, from
    torch.profiler (CUPTI): busy ms per tick and the top kernels. Only
    device-side rows (kernels, copies) count: an operator's row carries
    the time of the kernels it launched, which have rows of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    eng = ContinuousBatcher(cfg, params=params, num_slots=8, max_len=2048,
                            block_size=64, **kw)
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=n_ticks + 3)
    eng.step()                                   # admission + one tick
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_ticks):
            eng.step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(r[1] for r in rows)
    attn = {}                    # attention kernel -> [device us, launches]
    for name, us, n in rows:
        kernel = re.search(r"(paged_split|dense_split|split_combine)_kernel",
                           name)
        if kernel:
            acc = attn.setdefault(kernel.group(0), [0.0, 0])
            acc[0] += us
            acc[1] += n
    top = sorted(rows, key=lambda r: -r[1])[:6]
    return dict(
        ticks=n_ticks, device_busy_ms_per_tick=busy_us / n_ticks / 1e3,
        attention_ms_per_tick=sum(us for us, _ in attn.values())
        / n_ticks / 1e3,
        attention_us_per_launch={k: us / n for k, (us, n) in attn.items()},
        kernels_per_tick=sum(r[2] for r in rows) / n_ticks,
        top=[(name[:60], us / n_ticks / 1e3) for name, us, _ in top])


def check_outputs(outs, n, vocab, what):
    for i, toks in enumerate(outs):
        if len(toks) != n or not all(0 <= t < vocab for t in toks):
            fail(f"{what}: request {i} returned {len(toks)} tokens "
                 f"(want {n} in [0, {vocab}))")


def phase5_prompts(cfg):
    """Phase 5's 12 prompts: lengths 17-700 and ids from seed 0."""
    rng = np.random.default_rng(0)
    lens = rng.integers(17, 701, size=12)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
            for n in lens]


def end_to_end(torch, card):
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"[e2e] Llama-3-8B params: {llama.num_params(cfg) / 1e9:.3f} B "
          f"({sum(t.numel() * t.element_size() for t in _leaves(params)) / 2**30:.2f} GiB), "
          f"random init {time.perf_counter() - t0:.1f} s")
    prompts = phase5_prompts(cfg)
    print(f"[e2e] prompt lengths {sorted(len(p) for p in prompts)}")
    runs, outputs = {}, {}
    for name, ps, kw in [("bf16", prompts, {}),
                         ("int8", prompts[:4], {"kv_dtype": "int8"}),
                         ("dense", prompts, {"paged": False}),
                         ("dense-plain", prompts,
                          {"paged": False, "use_decode_kernel": False})]:
        outs, st = serve(torch, cfg, params, ps, 32, **kw)
        check_outputs(outs, 32, cfg.vocab_size, f"e2e {name}")
        check_launches(st, cfg.num_layers, f"e2e {name}")
        st["card"] = card
        if name.startswith("dense"):
            st["agree_with_paged"] = sum(
                a == b for a, b in zip(outs, outputs["bf16"]))
            st["partings"] = partings(torch, params, cfg, ps, outs,
                                      outputs["bf16"], name)
        print(f"[e2e] {name} "
              f"{'cache' if name.startswith('dense') else 'arena'}: "
              f"{json.dumps(st)}")
        runs[name], outputs[name] = st, outs
    runs["prefix"] = timed("phase 15", prefix_serving, torch, cfg, params,
                           card)
    runs["buffered"] = timed("phase 17", buffered_serving, torch, cfg,
                             params, prompts, outputs["bf16"], card)
    runs["spec"] = timed("phase 19", spec_serving, torch, cfg, params,
                         prompts, outputs, card)
    runs["split"] = timed("phase 21", split_serving, torch, cfg, params,
                          prompts, outputs, runs, card)
    for name, run, kw in [("bf16", runs["bf16"], {}),
                          ("dense", runs["dense"], {"paged": False}),
                          ("spec", runs["spec"]["self-bf16"], SPEC_RUN)]:
        prof = profile_ticks(torch, cfg, params, prompts, **kw)
        prof["idle_share"] = 1.0 - prof["device_busy_ms_per_tick"] / run[
            "tick_ms"]
        print(f"[profile] {name} decode tick, 8 slots: {json.dumps(prof)}")
        run["profile"] = prof
    runs["scoring"] = timed("phase 18", scoring, torch, cfg, params,
                            prompts, outputs["bf16"], card)
    del params
    torch.cuda.empty_cache()
    return runs, (prompts, outputs["bf16"])


def spec_tick_check(torch, cfg, params, prompts, card):
    """One self-draft spec tick at Llama-3-8B (k = SPEC_RUN's, 8 slots):
    every paged launch on layer 0 of the arena (k draft steps and k + 1
    verify positions) against ``paged_attention_reference`` on its own
    inputs, computed right after the launch (later launches write the
    arena in place), within the phase-3 bf16 tolerance."""
    from ray_tpu_torch.models import continuous_batching as cb
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_attention_reference

    atol, rtol = SPEC_CHECK_TOL
    eng = cb.ContinuousBatcher(cfg, params=params, num_slots=8,
                               max_len=2048, block_size=64, **SPEC_RUN)
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=8)
    eng.step()                       # admission and a first spec tick
    layer0 = eng.cache.k[0].data_ptr()
    inner = cb.paged_decode_attention
    calls = []

    def checked(q, ck, cv, tables, pos, scale=None, **kw):
        out = inner(q, ck, cv, tables, pos, scale, **kw)
        if ck.data_ptr() == layer0:
            kw.pop("use_kernel", None)
            ref = paged_attention_reference(q, ck, cv, tables, pos, scale,
                                            **kw)
            err, ok, n_bad = close(torch, out, ref, atol, rtol)
            calls.append(dict(positions=pos.tolist(), max_abs_err=err,
                              max_abs_ref=float(ref.float().abs().max()),
                              ok=ok, elements_out=n_bad))
        return out

    ticks0 = eng.spec_tick_count
    cb.paged_decode_attention = checked
    try:
        eng.step()
    finally:
        cb.paged_decode_attention = inner
    k = SPEC_RUN["spec_k"]
    if eng.spec_tick_count != ticks0 + 1 or len(calls) != 2 * k + 1:
        fail(f"spec check: {eng.spec_tick_count - ticks0} spec ticks, "
             f"{len(calls)} layer-0 paged calls (want 1 and {2 * k + 1})")
    bad = [c for c in calls if not c["ok"]]
    st = dict(calls=len(calls), tol=SPEC_CHECK_TOL,
              max_abs_err=max(c["max_abs_err"] for c in calls),
              max_abs_ref=max(c["max_abs_ref"] for c in calls), card=card)
    print(f"[spec-check] layer-0 paged launches of one spec tick: "
          f"{json.dumps(st)}")
    if bad:
        fail(f"spec check: paged kernel disagrees with the plain version "
             f"in {len(bad)} of {len(calls)} layer-0 calls: {bad[:2]}")
    del eng
    torch.cuda.empty_cache()
    return st


def spec_serving(torch, cfg, params, prompts, outputs, card):
    """Phase 19: the phase-5 requests (4 on an int8 arena) through
    speculative decode, k = 4, adaptive off unless a run says otherwise:
    self-draft (the default 8 of 32 layers) on bf16 and int8 arenas and
    with sync_every=4, an external drafter at Llama-3.2-1B's widths, and
    JAX's default (adaptive on). Gated: 32 in-vocab tokens each, the
    launch counts of want_launches, spec ticks run, one tick's layer-0
    launches against the plain version (spec_tick_check). Reported:
    agreement with phase 5 and partings."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.inference import ExternalLlamaDrafter

    runs = {"check": spec_tick_check(torch, cfg, params, prompts, card)}
    fixed = dict(SPEC_RUN)
    for name, ps, kw, against in [
            ("self-bf16", prompts, fixed, "bf16"),
            ("self-int8", prompts[:4], dict(fixed, kv_dtype="int8"), "int8"),
            ("self-buffered", prompts[:4], dict(fixed, sync_every=4),
             "bf16"),
            ("external", prompts, dict(fixed, drafter=None), "bf16"),
            ("adaptive", prompts[:4], dict(spec_k=fixed["spec_k"]),
             "bf16")]:
        if "drafter" in kw:
            # Made for its run alone, so the other runs' peak memory
            # leaves its 2.9 GB of weights out.
            kw["drafter"] = ExternalLlamaDrafter(
                llama.LlamaConfig(**DRAFTER), seed=1, device="cuda")
        outs, st = serve(torch, cfg, params, ps, 32, **kw)
        kw.pop("drafter", None)
        check_outputs(outs, 32, cfg.vocab_size, f"spec {name}")
        check_launches(st, cfg.num_layers, f"spec {name}")
        if not st["spec_ticks"]:
            fail(f"spec {name}: no spec tick ran")
        st["agree_with_phase5"] = sum(
            a == b for a, b in zip(outs, outputs[against]))
        st["partings"] = partings(torch, params, cfg, ps, outs,
                                  outputs[against], f"spec-{name}",
                                  against=f"phase-5 {against}")
        st["card"] = card
        print(f"[spec] {name}: {json.dumps(st)}")
        runs[name] = st
    torch.cuda.empty_cache()
    return runs


def split_drive(pre, dec, prompts, max_new):
    """What the router does: for each request, ``reserve_import`` on the
    decode engine, then the submit to the prefill engine; then rounds of
    one prefill step, ``transfer_inproc`` (with its reservation) of every
    parked request the decode engine has a free slot for, and one decode
    step, until both engines are idle. Returns (the decode engine's
    outputs in submit order, seconds inside the decode engine's steps)."""
    from ray_tpu_torch.serve import kv_transfer

    tickets, local, out = {}, {}, {}
    for p in prompts:
        ticket = dec.reserve_import(len(p), max_new)
        if ticket is None:
            fail(f"split: the decode arena refused a reservation of "
                 f"{len(p)} + {max_new} tokens")
        tickets[pre.submit(p, max_new_tokens=max_new)] = ticket
    dec_s = 0.0
    while pre.has_work() or dec.has_work() or pre.handoff_ready():
        pre.step()
        for rid in pre.handoff_ready():
            if dec.active_count >= dec.num_slots:
                break                   # parked until a decode slot frees
            local[rid] = kv_transfer.transfer_inproc(
                pre, dec, rid, reservation=tickets.pop(rid))
        t = time.perf_counter()
        out.update(dec.step())
        dec_s += time.perf_counter() - t
    return [out[local[r]] for r in sorted(local)], dec_s


def split_engines(torch, cfg, params, **kw):
    """A prefill-role and a decode-role engine on one copy of ``params``
    (8 slots, max_len 2048, block 64), after one short request has run
    through both."""
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    engines = [ContinuousBatcher(cfg, params=params, num_slots=8,
                                 max_len=2048, block_size=64, role=role,
                                 **kw)
               for role in ("prefill", "decode")]
    split_drive(*engines, [list(range(1, 17))], 2)
    torch.cuda.synchronize()
    return engines


def split_run(torch, cfg, params, prompts, max_new, **kw):
    """Phase 21's measured run: the split drive over ``prompts``, every
    import timed and the first two held byte for byte against the decode
    engine's blocks right after they land. Returns (outputs, stats)."""
    import zlib

    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention
    from ray_tpu_torch.serve import kv_transfer

    pre, dec = split_engines(torch, cfg, params, **kw)
    imports = []
    real = kv_transfer.import_kv

    def import_kv(engine, payload, **ikw):
        t = time.perf_counter()
        rid = real(engine, payload, **ikw)
        call_s = time.perf_counter() - t
        staging = payload["staging"]
        t = time.perf_counter()
        zlib.crc32(staging)
        rec = dict(rid=rid, mib=payload["nbytes"] / 2**20,
                   blocks=payload["num_blocks"],
                   crc_s=time.perf_counter() - t, import_call_s=call_s)
        if len(imports) < 2:
            slot = next(s for s, st in engine._slots.items()
                        if st["rid"] == rid)
            got, layout = engine.cache.gather_blocks(
                engine._slot_blocks[slot][:payload["num_blocks"]])
            rec["bytes_equal"] = (layout == payload["layout"]
                                  and got.tobytes() == staging.tobytes())
        imports.append(rec)
        return rid

    counts0 = (pre.base_tick_count, pre.spec_tick_count,
               dec.base_tick_count, pre.handoff_exports,
               dec.handoff_imports, dec.decoded_tokens, pre.prefill_seconds)
    done0 = (len(pre.request_breakdowns), len(dec.request_breakdowns))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    kv_transfer.import_kv = import_kv
    try:
        outs, dec_s = split_drive(pre, dec, prompts, max_new)
    finally:
        kv_transfer.import_kv = real
    torch.cuda.synchronize()
    launches = {"paged": paged_decode_attention.launches,
                "dense": decode_attention.launches}
    prefilled = list(pre.request_breakdowns)[done0[0]:]
    decoded = {r["rid"]: r for r in list(dec.request_breakdowns)[done0[1]:]}
    for rec in imports:
        # export_s holds the exporter's crc; import_s, as JAX stamps it,
        # starts after the importer's checks, so that crc is in the call.
        hand = decoded[rec["rid"]]["handoff"]
        rec.update(export_s=hand["export_s"], import_s=hand["import_s"],
                   crc_share_export=rec["crc_s"] / hand["export_s"],
                   crc_share_import_call=rec["crc_s"] / rec["import_call_s"])
    ticks = dec.base_tick_count - counts0[2]
    moved = sum(r["mib"] for r in imports)
    stats = dict(
        requests=len(prompts), kv_dtype=dec.kv_dtype,
        prefill_engine_ticks=(pre.base_tick_count - counts0[0]
                              + pre.spec_tick_count - counts0[1]),
        decode_ticks=ticks, launches=launches,
        exports=pre.handoff_exports - counts0[3],
        imports=dec.handoff_imports - counts0[4],
        import_reservations_left=dec.pressure_snapshot()[
            "import_reservations"],
        prefill_s=pre.prefill_seconds - counts0[6],
        handoff_mib=moved,
        handoff_mb_s=moved * 2**20 / 1e6 / sum(
            r["export_s"] + r["import_call_s"] for r in imports),
        tick_ms=dec_s / max(ticks, 1) * 1e3,
        decode_tok_s=(dec.decoded_tokens - counts0[5]) / dec_s,
        # Submit to first token on the prefill engine, and the import's
        # own time to a live slot on the decode engine.
        ttft_p50_ms=float(np.median([r["ttft_s"] for r in prefilled])) * 1e3,
        import_ttft_p50_ms=float(np.median(
            [r["ttft_s"] for r in decoded.values()])) * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        per_request=[{k: v for k, v in r.items() if k != "rid"}
                     for r in imports])
    del pre, dec
    torch.cuda.empty_cache()
    return outs, stats


def split_serving(torch, cfg, params, prompts, outputs, runs, card):
    """Phase 21: phase 5's requests split between a prefill-role and a
    decode-role engine (bf16 arena, then int8 with 4 requests). Gated: 32
    in-vocab tokens each from the decode engine, no tick on the prefill
    engine, paged launches = decode ticks x num_layers, one export and one
    import a request, the first two imports' blocks equal to their
    payloads' bytes, every reservation spent. Reported: the handoff's
    MiB, ``export_s``, ``import_s`` (from after the importer's checks, as
    JAX stamps it) and the whole import call, the crc's share of the
    export and of the import call, MB/s over both;
    decode tick ms, tokens/s and TTFT p50 beside phase 5's; peak memory;
    agreement with phase 5 and partings."""
    result = {}
    for name, ps, kw in [("bf16", prompts, {}),
                         ("int8", prompts[:4], {"kv_dtype": "int8"})]:
        outs, st = split_run(torch, cfg, params, ps, 32, **kw)
        what = f"split {name}"
        check_outputs(outs, 32, cfg.vocab_size, what)
        want = {"paged": st["decode_ticks"] * cfg.num_layers, "dense": 0}
        if st["launches"] != want or st["prefill_engine_ticks"]:
            fail(f"{what}: launches {st['launches']} (want {want}), "
                 f"{st['prefill_engine_ticks']} prefill-engine ticks")
        n = len(ps)
        if (st["exports"], st["imports"]) != (n, n):
            fail(f"{what}: {st['exports']} exports and {st['imports']} "
                 f"imports of {n} requests")
        if not all(r["bytes_equal"] for r in st["per_request"][:2]):
            fail(f"{what}: an imported request's blocks differ from its "
                 f"payload's staging bytes")
        if st["import_reservations_left"]:
            fail(f"{what}: {st['import_reservations_left']} reservations "
                 f"left unspent")
        st["agree_with_phase5"] = sum(
            a == b for a, b in zip(outs, outputs[name]))
        st["partings"] = partings(torch, params, cfg, ps, outs,
                                  outputs[name], f"split-{name}",
                                  against=f"phase-5 {name}")
        st["phase5"] = {k: runs[name][k] for k in (
            "tick_ms", "decode_tok_s", "ttft_p50_ms", "peak_gib")}
        st["card"] = card
        print(f"[split] {name}: {json.dumps(st)}")
        result[name] = st
    return result


def split_parity(torch, cfg, params, prompts, got, pprompts, warm,
                 prefix_runs):
    """Phase 22: in phase 6's 2-layer fp32 model with the kernel, split
    greedy tokens against the colocated runs of phases 6 and 16: the
    model-dtype and int8 arenas x sync_every 1 and 4 x the prefix cache on
    and off (phase 16's shared-prefix requests after its warm request), a
    decode engine with spec_k=2 self-draft, and one with an external
    1-layer fp32 drafter (phase 11's dense kernel after the drafter's
    prefill of each imported prompt); each at the decode engine's launch
    counts (want_launches), the prefill engine ticking never."""
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
    from ray_tpu_torch.models.inference import ExternalLlamaDrafter
    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention

    drafter = ExternalLlamaDrafter(dataclasses.replace(cfg, num_layers=1),
                                   seed=3, device="cuda")
    spec = dict(spec_k=2, spec_draft_layers=1, spec_adaptive=False)
    cases = [(f"{kv} sync_every={k} prefix={'on' if on else 'off'}", pprompts,
              dict(kv_dtype=kv, sync_every=k, prefix_cache=on), {}, warm,
              prefix_runs[kv][True])
             for kv in ("bf16", "int8") for k in (1, 4)
             for on in (True, False)]
    cases += [("spec self-draft", prompts, {}, spec, [], got["paged"]),
              ("spec external", prompts, {}, dict(spec, drafter=drafter),
               [], got["paged"])]
    summary = {}
    for name, ps, kw, dkw, pre_warm, want in cases:
        pre, dec = (ContinuousBatcher(cfg, params=params, num_slots=8,
                                      max_len=2048, block_size=64, role=role,
                                      **kw, **extra)
                    for role, extra in (("prefill", {}), ("decode", dkw)))
        if pre_warm:
            split_drive(pre, dec, pre_warm, 2)
        ticks0, spec0 = dec.base_tick_count, dec.spec_tick_count
        rungs0 = dict(dec._spec_ticks)
        reset_launch_counts()
        outs, _ = split_drive(pre, dec, ps, 16)
        st = dict(kernel=True, paged=True,
                  base_ticks=dec.base_tick_count - ticks0,
                  spec_ticks=dec.spec_tick_count - spec0,
                  launches={"paged": paged_decode_attention.launches,
                            "dense": decode_attention.launches},
                  spec_rungs={k: n - rungs0.get(k, 0)
                              for k, n in dec._spec_ticks.items()},
                  draft_layers=(0 if "drafter" in dkw
                                else dkw.get("spec_draft_layers", 0)),
                  drafter_layers=1 if "drafter" in dkw else 0)
        what = f"split {name}"
        check_launches(st, cfg.num_layers, what)
        if pre.base_tick_count or pre.spec_tick_count:
            fail(f"{what}: the prefill engine ticked")
        if dkw and not st["spec_ticks"]:
            fail(f"{what}: no spec tick ran")
        check_agree(torch, params, cfg, ps, outs, want,
                    f"{what} and colocated")
        summary[name] = (st["base_ticks"], st["spec_ticks"],
                         st["launches"])
        del pre, dec
    print(f"[split-parity] ticks (plain, spec) and launches: "
          f"{json.dumps(summary)}")
    del drafter


def prefix_serving(torch, cfg, params, card):
    """Phase 15: the paged engine with the prefix cache on and off over
    12 requests that share a PREFIX["tokens"]-token prefix, after a warm
    request of that prefix has indexed it."""
    p = PREFIX
    rng = np.random.default_rng(p["seed"])
    shared = rng.integers(0, cfg.vocab_size, size=p["tokens"]).tolist()
    warm = shared + rng.integers(0, cfg.vocab_size, size=40).tolist()
    tails = rng.integers(*p["tail"], size=p["requests"])
    prompts = [shared + rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in tails]
    print(f"[prefix] {p['requests']} requests of a {p['tokens']}-token "
          f"prefix plus tails {sorted(int(n) for n in tails)}")
    runs, outs = {}, {}
    for name, on in (("on", True), ("off", False)):
        outs[name], st = serve(torch, cfg, params, prompts, p["max_new"],
                               warm=[warm], prefix_cache=on)
        check_outputs(outs[name], p["max_new"], cfg.vocab_size,
                      f"prefix {name}")
        check_launches(st, cfg.num_layers, f"prefix {name}")
        st["card"] = card
        runs[name] = st
    hits = p["requests"] * p["tokens"]
    saved = runs["off"]["prefill_tokens"] - runs["on"]["prefill_tokens"]
    if runs["on"]["prefix_hit_tokens"] != hits or saved != hits:
        fail(f"prefix: {runs['on']['prefix_hit_tokens']} hit tokens and "
             f"{saved} fewer prefilled (want {hits} each)")
    runs["on"]["agree_with_off"] = sum(a == b for a, b in zip(outs["on"],
                                                              outs["off"]))
    runs["on"]["partings"] = partings(torch, params, cfg, prompts,
                                      outs["on"], outs["off"], "prefix-on",
                                      against="prefix-off")
    for name, st in runs.items():
        print(f"[prefix] cache {name}: {json.dumps(st)}")
    return runs


def buffered_serving(torch, cfg, params, prompts, want, card):
    """Phase 17: the phase-5 requests with ``sync_every=4``; agreement
    with the phase-5 run is reported, not gated."""
    outs, st = serve(torch, cfg, params, prompts, 32, sync_every=4)
    check_outputs(outs, 32, cfg.vocab_size, "buffered")
    check_launches(st, cfg.num_layers, "buffered")
    st["agree_with_sync_every_1"] = sum(a == b for a, b in zip(outs, want))
    st["card"] = card
    print(f"[buffered] sync_every=4: {json.dumps(st)}")
    return st


def scoring(torch, cfg, params, prompts, outs, card):
    """Phase 18: ``score_logprobs`` of two phase-5 requests' served
    tokens, with the flash forward kernel (num_layers launches a call)
    and with ``attention_kernel=False``, within SCORE_TOL; each kernel
    launch of the scoring held against the plain forward on its own
    inputs, with controls that must fail (SCORE_CONTROL_BLOCK); and how
    many served tokens are the argmax of the scored distribution."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.continuous_batching import (ContinuousBatcher,
                                                          _bucket)
    from ray_tpu_torch.ops.attention import flash_attention

    atol, rtol = SCORE_TOL
    got, attn = {}, {"max_abs_err": 0.0, "calls": 0, "shapes": [],
                     "controls": {}}
    for kernel in (None, False):
        eng = ContinuousBatcher(
            dataclasses.replace(cfg, attention_kernel=kernel), params=params,
            num_slots=8, max_len=2048, block_size=64)
        got[kernel] = []
        for i in SCORE_REQUESTS:
            before = flash_attention.launches["fwd"]
            calls = []
            if kernel is None:
                llama.flash_attention = _recording(flash_attention, calls)
            try:
                got[kernel].append(eng.score_logprobs(prompts[i], outs[i]))
            finally:
                llama.flash_attention = flash_attention
            launched = flash_attention.launches["fwd"] - before
            if launched != (cfg.num_layers if kernel is None else 0):
                fail(f"scoring: attention_kernel={kernel} launched the "
                     f"flash forward {launched} times")
            if calls:
                scored_attention(torch, calls, attn, f"request {i}")
            del calls
        del eng
    err, argmax = 0.0, 0
    for i, a, b in zip(SCORE_REQUESTS, got[None], got[False]):
        err = max(err, float(np.abs(a - b).max()))
        if not (np.all(np.isfinite(a))
                and np.all(np.abs(a - b) <= atol + rtol * np.abs(b))):
            fail(f"scoring: kernel and plain logprobs of request {i} "
                 f"disagree (max_abs_err {err})")
        seq = prompts[i] + outs[i]
        tokens = torch.zeros((1, min(_bucket(len(seq)), 2048)),
                             dtype=torch.long, device="cuda")
        tokens[0, :len(seq)] = torch.tensor(seq, device="cuda")
        with torch.no_grad(), llama.fp32_reduction(torch.device("cuda"),
                                                   cfg.dtype):
            logits = llama.forward(params, tokens, cfg)[0]
        start = len(prompts[i]) - 1
        best = logits[start:start + len(outs[i])].argmax(-1).tolist()
        argmax += sum(x == y for x, y in zip(best, outs[i]))
        del logits
    st = dict(requests=list(SCORE_REQUESTS),
              tokens=[len(outs[i]) for i in SCORE_REQUESTS],
              seq_lens=[len(prompts[i]) + len(outs[i])
                        for i in SCORE_REQUESTS],
              max_abs_err=err, tol=SCORE_TOL, served_tokens_argmax=argmax,
              attention=attn, card=card)
    print(f"[scoring] {json.dumps(st)}")
    return st


def _recording(inner, calls):
    """``inner`` (the model's flash attention) that also keeps each call's
    (q, k, v, keywords, output) in ``calls``."""
    def record(q, k, v, **kw):
        out = inner(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out
    return record


def masked_attention(torch, q, k, v, keep):
    """Plain GQA attention of q [B, S, Hq, D] over k, v [B, S, KVH, D] in
    fp32, where ``keep`` [S, S] says which keys each query sees."""
    g = q.shape[2] // k.shape[2]
    kf, vf = (t.float().repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * q.shape[3] ** -0.5
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def scored_attention(torch, calls, attn, what):
    """Hold each recorded flash forward against the plain forward on its
    own inputs at SCORE_TOL, and the first layer's against three wrong
    attentions that must each fail SCORE_TOL."""
    from ray_tpu_torch.ops.attention import flash_fwd_reference

    atol, rtol = SCORE_TOL
    for layer, (q, k, v, kw, out) in enumerate(calls):
        if not kw.get("causal", False):
            fail(f"scoring: {what} layer {layer} attention is not causal")
        want, _ = flash_fwd_reference(q, k, v, scale=q.shape[3] ** -0.5,
                                      causal=True)
        e, ok, n_bad = close(torch, out, want, atol, rtol)
        attn["max_abs_err"] = max(attn["max_abs_err"], e)
        attn["calls"] += 1
        if list(q.shape) not in attn["shapes"]:
            attn["shapes"].append(list(q.shape))
        if not ok:
            fail(f"scoring: {what} layer {layer}: flash forward disagrees "
                 f"with the plain version at {list(q.shape)} "
                 f"(max_abs_err {e}, {n_bad} elements outside {SCORE_TOL})")
        if layer:
            continue
        n, blk = q.shape[1], SCORE_CONTROL_BLOCK
        rows = torch.arange(n, device=q.device)[:, None]
        cols = torch.arange(n, device=q.device)[None, :]
        causal = cols <= rows
        controls = {
            "no_causal_mask": masked_attention(
                torch, q, k, v, torch.ones_like(causal)),
            "own_block_skipped": masked_attention(
                torch, q, k, v, (cols < rows // blk * blk)
                | (causal & (rows < blk))),
            "zeros": torch.zeros_like(want)}
        for name, wrong in controls.items():
            e, ok, n_bad = close(torch, wrong, want, atol, rtol)
            attn["controls"].setdefault(name, []).append(
                dict(max_abs_err=e, elements_out=n_bad))
            if ok:
                fail(f"scoring: the {name} control passes SCORE_TOL at "
                     f"{list(q.shape)}: the check cannot see that fault")


def _leaves(params):
    for v in params.values():
        if isinstance(v, dict):
            yield from v.values()
        else:
            yield v


def top2_margin(torch, params, cfg, seq):
    """(top-2 logit gap, top logit) of the next token after ``seq``: a
    full forward in the params' dtype, with fp32 logits, under the
    engine's GEMM precision."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.continuous_batching import \
        _prefill_forward_paged

    with torch.no_grad(), llama.fp32_reduction(torch.device("cuda"),
                                               cfg.dtype):
        logits, _ = _prefill_forward_paged(
            params, torch.tensor([seq], device="cuda"),
            torch.arange(len(seq), device="cuda"), None, None, cfg,
            False, last_idx=torch.tensor([len(seq) - 1], device="cuda"))
    top = logits[0, 0].float().topk(2).values
    return float(top[0] - top[1]), float(top[0])


def partings(torch, params, cfg, prompts, got, want, what, against="paged",
             margin=None):
    """Where the bf16 run ``what`` (``got``) parts from the run
    ``against`` (``want``): for each such request, (request, first parting
    token, top-2 margin, top logit) of the next token after the prompt and
    the tokens both runs share, from a bf16 full forward. A margin near
    bf16's rounding of a logit of that size (2^-8 relative) is a near-tie
    that another summation order flips. ``margin(seq)`` stands for
    ``top2_margin`` where the weights live elsewhere (a replica)."""
    top2 = margin or (lambda seq: top2_margin(torch, params, cfg, seq))
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        margin, top = top2(prompts[i] + b[:j])
        print(f"[parity] bf16 {what} and {against} runs part at request {i}, "
              f"token {j}: top-2 margin {margin:.4e}, top logit {top:.4f} "
              f"(bf16 rounding there {abs(top) * 2**-8:.4e})")
        out.append((i, j, margin, top))
    return out


def check_agree(torch, params, cfg, prompts, got, want, what, margin=None):
    """Greedy tokens ``got`` against ``want`` request by request; a
    divergence passes only at a top-2 margin below TOP2_MARGIN
    (``margin(seq)`` as in ``partings``)."""
    top2 = margin or (lambda seq: top2_margin(torch, params, cfg, seq))
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        margin, _ = top2(prompts[i] + b[:j])
        print(f"[parity] {what}: request {i} diverges at token {j}: "
              f"top-2 margin {margin:.3e}")
        if margin >= TOP2_MARGIN:
            fail(f"{what} disagree (request {i}, token {j}, margin "
                 f"{margin})")
    print(f"[parity] fp32 2-layer engine, {what}: greedy tokens "
          f"{'identical' if got == want else 'differ only at ties'} over "
          f"{len(want)} requests x {len(want[0])} tokens")


def engine_parity(torch):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.inference import LlamaGenerator

    cfg = dataclasses.replace(
        llama.LlamaConfig.llama3_8b(dtype=torch.float32), num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (30, 200, 450, 700)]
    got = {}
    for name, kw in [("paged", {}), ("paged-plain",
                                     {"use_decode_kernel": False}),
                     ("dense", {"paged": False}),
                     ("dense-plain", {"paged": False,
                                      "use_decode_kernel": False})]:
        got[name], st = serve(torch, cfg, params, prompts, 16, **kw)
        check_launches(st, cfg.num_layers, f"parity {name}")
    check_agree(torch, params, cfg, prompts, got["paged-plain"],
                got["paged"], "paged kernel and plain engines")
    for name in ("dense", "dense-plain"):
        check_agree(torch, params, cfg, prompts, got[name], got["paged"],
                    f"{name} and paged-kernel engines")
    gen = LlamaGenerator(cfg, params=params, max_len=2048, device="cuda")
    one = gen.generate([prompts[0]], max_new_tokens=16)[0].tolist()
    check_agree(torch, params, cfg, prompts[:1], [one], got["paged"][:1],
                "LlamaGenerator and paged-kernel engine")
    del gen
    pprompts, warm, prefix_runs = timed("phase 16", engine_parity_16, torch,
                                        cfg, params, prompts, got, rng)
    timed("phase 20", spec_parity, torch, cfg, params, prompts, got,
          pprompts, warm, prefix_runs)
    timed("phase 22", split_parity, torch, cfg, params, prompts, got,
          pprompts, warm, prefix_runs)
    del params
    torch.cuda.empty_cache()
    return cfg, prompts, got["paged"]


def engine_parity_16(torch, cfg, params, prompts, got, rng):
    """Phase 16: in phase 6's model, the prefix cache on against off on
    model-dtype and int8 arenas (four requests of a 512-token prefix after
    a warm request of it), and sync_every=4 against 1 on paged and dense
    engines (phase 6's requests)."""
    shared = rng.integers(0, cfg.vocab_size, size=512).tolist()
    pprompts = [shared + rng.integers(0, cfg.vocab_size, size=n).tolist()
                for n in (5, 70, 200, 1)]
    warm = [shared + [1, 2, 3]]
    prefix_runs = {}
    for kv in ("bf16", "int8"):
        runs = prefix_runs[kv] = {}
        for on in (True, False):
            runs[on], st = serve(torch, cfg, params, pprompts, 16,
                                 warm=warm, prefix_cache=on, kv_dtype=kv)
            check_launches(st, cfg.num_layers, f"prefix {on} {kv}")
            if st["prefix_hit_tokens"] != (len(pprompts) * 512 if on else 0):
                fail(f"parity prefix {on} {kv}: "
                     f"{st['prefix_hit_tokens']} hit tokens")
        check_agree(torch, params, cfg, pprompts, runs[True], runs[False],
                    f"prefix cache on and off, {kv} arena")
    for name, kw in (("paged", {}), ("dense", {"paged": False})):
        buf, st = serve(torch, cfg, params, prompts, 16, sync_every=4, **kw)
        check_launches(st, cfg.num_layers, f"buffered {name}")
        check_agree(torch, params, cfg, prompts, buf, got[name],
                    f"sync_every=4 and 1, {name}")
    return pprompts, warm, prefix_runs


def spec_parity(torch, cfg, params, prompts, got, pprompts, warm,
                prefix_runs):
    """Phase 20: in phase 6's 2-layer fp32 model, greedy spec decode
    (self-draft of 1 layer, k = 2 and 4, the ladder held) against the
    spec-off runs of phases 6 and 16, with the kernel and the plain
    attention, on model-dtype and int8 arenas, at sync_every 1 and 4,
    with the prefix cache on and off, and with an external 1-layer fp32
    drafter of the same vocabulary: the same tokens (a divergence passes
    only at a top-2 margin below TOP2_MARGIN), at want_launches' counts.
    Then sampled spec decode twice a sync_every (1 and 4) with one seed
    and no warm-up (a warm-up's buffered rows would move the step count
    the measured run starts from): the same tokens each time, and the same
    at 1 and 4."""
    from ray_tpu_torch.models.inference import ExternalLlamaDrafter

    drafter = ExternalLlamaDrafter(dataclasses.replace(cfg, num_layers=1),
                                   seed=3, device="cuda")
    base_int8, st = serve(torch, cfg, params, prompts, 16, kv_dtype="int8")
    check_launches(st, cfg.num_layers, "spec-off int8")
    cases = [("kernel", prompts, {}, got["paged"]),
             ("plain", prompts, {"use_decode_kernel": False},
              got["paged-plain"]),
             ("int8", prompts, {"kv_dtype": "int8"}, base_int8),
             ("sync_every=4", prompts, {"sync_every": 4}, got["paged"]),
             ("prefix-on", pprompts, {"warm": warm, "prefix_cache": True},
              prefix_runs["bf16"][True]),
             ("prefix-off", pprompts, {"warm": warm, "prefix_cache": False},
              prefix_runs["bf16"][False]),
             ("external", prompts, {"drafter": drafter}, got["paged"])]
    counts = {}
    for k in (2, 4):
        for name, ps, kw, want in cases:
            outs, st = serve(torch, cfg, params, ps, 16, spec_k=k,
                             spec_draft_layers=1, spec_adaptive=False, **kw)
            what = f"spec k={k} {name}"
            check_launches(st, cfg.num_layers, what)
            if not st["spec_ticks"]:
                fail(f"{what}: no spec tick ran")
            check_agree(torch, params, cfg, ps, outs, want,
                        f"{what} and spec-off")
            counts[f"k={k} {name}"] = (st["spec_ticks"], st["accept_rate"])
    print(f"[spec-parity] spec ticks and accept rates: {json.dumps(counts)}")
    sampled = {}
    for sync_every in (1, 4):
        for rep in range(2):
            sampled[sync_every, rep], st = serve(
                torch, cfg, params, prompts, 16, warm=[], spec_k=2,
                spec_draft_layers=1, spec_adaptive=False,
                sync_every=sync_every, sampling=SPEC_SAMPLING)
            check_launches(st, cfg.num_layers, f"sampled spec {sync_every}")
        if sampled[sync_every, 0] != sampled[sync_every, 1]:
            fail(f"sampled spec, sync_every={sync_every}: two runs with one "
                 f"seed differ")
    if sampled[1, 0] != sampled[4, 0]:
        fail("sampled spec: sync_every=4 differs from sync_every=1")
    print(f"[spec-parity] sampled spec ({SPEC_SAMPLING}): the same tokens "
          f"in two runs at sync_every 1 and 4, and across them")
    del drafter


def reset_launch_counts():
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention

    paged_decode_attention.launches = 0
    decode_attention.launches = 0
    for name in flash_attention.launches:
        flash_attention.launches[name] = 0


def flash_inputs(torch, kind, sq, sk, seed):
    s = FLASH_SHAPE
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[kind]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(n, heads):
        return torch.randn((s["B"], n, heads, s["D"]), generator=gen,
                           device="cuda").to(dtype)
    return rnd(sq, s["HQ"]), rnd(sk, s["KVH"]), rnd(sk, s["KVH"]), \
        rnd(sq, s["HQ"])


def flash_bounds(kind, causal, sq, sk):
    """Least time of each kernel for these inputs: the live (query, key)
    pairs' flops (4 D a pair forward, 6 D for dq, 8 D for dk/dv) over the
    dtype's peak, or each input read once and each output written once
    over 3.35 TB/s, whichever is larger."""
    s = FLASH_SHAPE
    offs = sk - sq
    per_head = (sum(min(sk, max(0, r + offs + 1)) for r in range(sq))
                if causal else sq * sk)
    pairs = s["B"] * s["HQ"] * per_head
    item = 2 if kind == "bf16" else 4
    q = s["B"] * sq * s["HQ"] * s["D"] * item
    kv = s["B"] * sk * s["KVH"] * s["D"] * item
    row = s["B"] * s["HQ"] * sq * 4                # lse or delta, fp32
    work = {"fwd": (4 * s["D"] * pairs, q + 2 * kv + q + row),
            "dq": (6 * s["D"] * pairs, 2 * q + 2 * kv + 2 * row + q),
            "dkv": (8 * s["D"] * pairs, 2 * q + 2 * kv + 2 * row + 2 * kv)}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_OPS_PER_S[kind]
        t_bytes = nbytes / PEAK_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def close(torch, got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and not bool(bad.any())
    return float(err.max()), ok, int(bad.sum())


def flash_phases(torch):
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as fa

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for i, (name, kind, causal, sq, sk, atol, rtol) in enumerate(
            FLASH_CASES):
        q, k, v, do = flash_inputs(torch, kind, sq, sk, seed=10 + i)
        scale = FLASH_SHAPE["D"] ** -0.5
        kw = dict(scale=scale, causal=causal)
        out, lse = fa.flash_fwd_cuda(q, k, v, **kw)
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
        grads = fa.flash_bwd_cuda(q, k, v, ref_out, ref_lse, do, **kw)
        ref_grads = fa.flash_bwd_reference(q, k, v, ref_out, ref_lse, do,
                                           **kw)
        torch.cuda.synchronize()
        errs = {}
        for label, got, want, a, r in (
                [("out", out, ref_out, atol, rtol),
                 ("lse", lse, ref_lse, FLASH_LSE_ATOL, 0.0)]
                + [(n, g, w, atol, rtol) for n, g, w in
                   zip(("dq", "dk", "dv"), grads, ref_grads)]):
            err, ok, n_bad = close(torch, got, want, a, r)
            errs[label] = err
            if not ok:
                fail(f"flash kernel disagrees with plain version ({name}, "
                     f"{label}): max_abs_err={err}, {n_bad} elements out "
                     f"(atol {a}, rtol {r})")
        print(f"[flash] {name} (Sq={sq}, Sk={sk}, causal={causal}): "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (atol {atol}, rtol {rtol}; lse atol {FLASH_LSE_ATOL})")
        res = dict(max_abs_err={"fwd": max(errs["out"], errs["lse"]),
                                "dq": errs["dq"],
                                "dkv": max(errs["dk"], errs["dv"])})
        del out, lse, grads, ref_grads
        if name in FLASH_TIMED:
            delta = fa._delta(ref_out, do)
            bwd = (q, k, v, do, ref_lse, delta)
            res["ms"] = {
                "fwd": time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v,
                                                                **kw),
                               flush, iters=20),
                "dq": time_ms(torch, lambda: fa.flash_dq_cuda(*bwd, **kw),
                              flush, iters=20),
                "dkv": time_ms(torch, lambda: fa.flash_dkv_cuda(*bwd, **kw),
                               flush, iters=20)}
            plain_fwd = time_ms(torch, lambda: fa.flash_fwd_reference(
                q, k, v, **kw), flush, iters=10)
            plain_bwd = time_ms(torch, lambda: fa.flash_bwd_reference(
                q, k, v, ref_out, ref_lse, do, **kw), flush, iters=10)
            res["plain_ms"] = {"fwd": plain_fwd, "dq": plain_bwd,
                               "dkv": plain_bwd}
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), flush,
                iters=20)
            qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
            sdpa_fb = time_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                               enable_gqa=True),
                (qg, kg, vg), dot), flush, iters=20)
            res["library_ms"] = {"fwd": sdpa_fwd, "dq": sdpa_fb - sdpa_fwd,
                                 "dkv": sdpa_fb - sdpa_fwd,
                                 "fwd_bwd": sdpa_fb}
            res["bound"] = flash_bounds(kind, causal, sq, sk)
            print(f"[flash-timing] {name}: " + "; ".join(
                f"{n} kernel {res['ms'][n]:.4f} ms, plain "
                f"{res['plain_ms'][n]:.4f}, library "
                f"{res['library_ms'][n]:.4f}, bound "
                f"{res['bound'][n][0]:.4f} ({res['bound'][n][1]})"
                for n in ("fwd", "dq", "dkv")))
        results[name] = res
        del q, k, v, do, ref_out, ref_lse
    del flush
    torch.cuda.empty_cache()
    return results


def _param_leaves(params):
    return [t for v in params.values()
            for t in (v.values() if isinstance(v, dict) else [v])]


def model_parity(torch):
    """Phase 9: loss_fn and every grad leaf, kernels against plain."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.attention import flash_attention

    cfg = dataclasses.replace(
        llama.LlamaConfig.llama3_8b(dtype=torch.float32), num_layers=2)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(2), device="cuda")
    leaves = [p.requires_grad_(True) for p in _param_leaves(params)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device="cuda", dtype=torch.int32)
    got = {}
    for kernel in (None, False):
        before = dict(flash_attention.launches)
        loss, _ = llama.loss_fn(params, {"tokens": tokens},
                                dataclasses.replace(cfg,
                                                    attention_kernel=kernel))
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launched = {n: flash_attention.launches[n] - before[n]
                    for n in before}
        if (kernel is None) != (launched["fwd"] > 0 and launched["dq"] > 0
                                and launched["dkv"] > 0):
            fail(f"model parity: kernel={kernel} launched {launched}")
        got[kernel] = (float(loss.detach()), grads)
    (l1, g1), (l0, g0) = got[None], got[False]
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for a, b in zip(g1, g0))
    print(f"[model-parity] fp32 Llama-3-8B widths, 2 layers, 512 tokens: "
          f"loss kernel {l1:.8f} plain {l0:.8f}; worst grad leaf "
          f"max|diff|/max|grad| {worst:.3e} (limits: loss rtol "
          f"{MODEL_LOSS_RTOL}, grads {MODEL_GRAD_TOL})")
    if not (abs(l1 - l0) <= MODEL_LOSS_RTOL * abs(l0)
            and worst <= MODEL_GRAD_TOL):
        fail("model parity: kernel and plain loss_fn disagree")
    del params, leaves, got, g1, g0, grads
    torch.cuda.empty_cache()


def train_flops(cfg, n_params, batch, seq):
    """bench.py's ``_train_flops``: 6 P per token plus causal attention,
    12 L H D S^2 / 2 per sequence."""
    return (6 * n_params * batch * seq + 12 * cfg.num_layers * cfg.num_heads
            * cfg.head_dim * seq * seq * batch // 2)


def profile_step(torch, run, step_ms, routing=False, flash=True):
    """Device time of one train step, ``run()`` (which ends in a sync),
    by kernel (torch.profiler, device rows only), grouped: the three
    flash kernels (each must have run, unless ``flash`` is False), GEMMs,
    with ``routing`` the MoE routing kernels (ROUTING_KERNELS), the rest;
    the idle share is against ``step_ms``, the unprofiled step (the
    profiler slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    groups = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0,
              "gemm": 0.0, "other": 0.0}
    if routing:
        groups["moe_routing"] = 0.0
    flash_names = {}
    for key, ms, _ in rows:
        low = key.lower()
        flash = re.search(r"flash_(fwd|dq|dkv)_kernel\w*", key)
        if flash:
            groups[f"flash_{flash.group(1)}"] += ms
            flash_names.setdefault(f"flash_{flash.group(1)}",
                                   set()).add(flash.group(0))
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass")):
            groups["gemm"] += ms
        elif routing and ROUTING_KERNELS.search(key):
            groups["moe_routing"] += ms
        else:
            groups["other"] += ms
    empty = [g for g in ("flash_fwd", "flash_dq", "flash_dkv")
             if groups[g] <= 0.0]
    if flash and empty:
        fail(f"train profile: no device time in {empty} (a renamed flash "
             f"kernel would land in 'other'); kernels: "
             f"{sorted(r[0][:80] for r in rows if 'flash' in r[0])}")
    busy = sum(groups.values())
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return dict(wall_ms_profiled=wall_ms, device_busy_ms=busy,
                idle_share=1.0 - busy / step_ms,
                groups_ms=groups,
                shares={g: ms / busy for g, ms in groups.items()},
                flash_kernels={g: sorted(n)
                               for g, n in flash_names.items()},
                top=[(k[:60], ms, n) for k, ms, n in top])


def train_end_to_end(torch, card):
    """Phase 10: the training main path at Llama-3-8B widths."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention

    t = TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=t["layers"])
    trainer = ShardedTrainer(cfg, optimizer=default_optimizer(
        warmup_steps=t["warmup"], total_steps=t["total"]))
    t0 = time.perf_counter()
    state = trainer.init_state(0)
    batch = synthetic_batch(t["batch"], t["seq"], cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    n_params = llama.num_params(cfg)
    print(f"[train] Llama-3-8B widths, {cfg.num_layers} of 32 layers: "
          f"{n_params / 1e9:.3f} B params, bf16, remat "
          f"{cfg.remat_policy!r}; init {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    reset_launch_counts()
    for _ in range(t["steps"]):
        before = dict(flash_attention.launches)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))      # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: flash_attention.launches[n] - before[n]
                         for n in before})
    launches = dict(flash_attention.launches)
    L = cfg.num_layers
    want = {"fwd": 2 * L, "dq": L, "dkv": L}
    if (not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or not losses[-1] < t["last_loss_below"]):
        fail(f"train: losses {losses} (want finite, last below first and "
             f"below {t['last_loss_below']})")
    if any(d != want for d in per_step):
        fail(f"train: launches per step {per_step}, want {want}")
    step_s = float(np.median(step_ms[2:])) / 1e3
    tokens = t["batch"] * t["seq"]
    stats = dict(
        layers=L, params=n_params, losses=losses, step_ms=step_ms,
        step_ms_median_3_12=step_s * 1e3, tokens_per_s=tokens / step_s,
        mfu=train_flops(cfg, n_params, t["batch"], t["seq"]) / step_s
        / PEAK_OPS_PER_S["bf16"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        grad_norm_last=float(metrics["grad_norm"]),
        launches_per_step=want, launches=launches, card=card)
    print(f"[train] {json.dumps(stats)}")
    def one_step():
        float(trainer.train_step(state, batch)[1]["loss"])
    prof = profile_step(torch, one_step, step_s * 1e3)
    print(f"[train-profile] one step: {json.dumps(prof)}")
    del state, trainer, batch
    torch.cuda.empty_cache()
    return stats


def mesh_parity(torch, mesh, attention):
    """SHARDED_PARITY's fp32 model with ``attention`` on ``mesh`` against
    the one-device trainer (the fp32 flash kernels), SHARDED["parity_steps"]
    steps: (worst relative loss gap, worst grad leaf's max|diff| over its
    max|grad|, the mesh step's flash launches at each step)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import DEFAULT_RULES

    p = dict(SHARDED_PARITY)
    batch_size, seq = p.pop("batch"), p.pop("seq")
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **p)

    def opt():
        return default_optimizer(warmup_steps=2, total_steps=50,
                                 learning_rate=1e-2)

    one = ShardedTrainer(dataclasses.replace(cfg, attention="flash"),
                         optimizer=opt())
    sharded = ShardedTrainer(dataclasses.replace(cfg, attention=attention),
                             mesh, optimizer=opt(), rules=DEFAULT_RULES)
    s1, s2 = one.init_state(0), sharded.init_state(0)
    batch = synthetic_batch(batch_size, seq, cfg.vocab_size, seed=1)
    worst_loss = worst_grad = 0.0
    launches = []
    for _ in range(SHARDED["parity_steps"]):
        l1, _, g1 = one.grads(s1.params, batch)
        before = dict(flash_attention.launches)
        l2, _, g2 = sharded.grads(s2.params, sharded.shard_batch(batch))
        torch.cuda.synchronize()
        launches.append({n: flash_attention.launches[n] - before[n]
                         for n in before})
        worst_loss = max(worst_loss, abs(float(l2) - float(l1))
                         / abs(float(l1)))
        worst_grad = max(worst_grad, max(
            float((b.full_tensor() - a).abs().max())
            / max(float(a.abs().max()), 1e-30) for a, b in zip(g1, g2)))
        s1, _ = one.train_step(s1, batch)
        s2, _ = sharded.train_step(s2, batch)
    print(f"[{'ring' if attention == 'ring' else 'sharded'}-parity] fp32 "
          f"tiny (D=128, {cfg.num_layers} layers, {batch_size} x {seq}), "
          f"one-rank mesh ({attention}) vs one device (flash) over "
          f"{SHARDED['parity_steps']} steps: worst loss rel "
          f"{worst_loss:.3e}, worst grad leaf max|diff|/max|grad| "
          f"{worst_grad:.3e}; mesh launches a step {launches}")
    return worst_loss, worst_grad, launches, cfg.num_layers


def sharded_parity(torch, mesh):
    """Phase 25's tiny fp32 model: the one-rank mesh against one device,
    loss and every grad leaf within SHARDED["tol"] at each step, the
    flash kernels launched once a layer."""
    worst_loss, worst_grad, launches, L = mesh_parity(torch, mesh, "auto")
    if any(d != dict.fromkeys(d, L) for d in launches):
        fail(f"sharded parity: the mesh step launched {launches}, want "
             f"{L} of each")
    if worst_loss > SHARDED["tol"] or worst_grad > SHARDED["tol"]:
        fail("sharded parity: the one-rank mesh step disagrees with the "
             "one-device step")


def ring_parity(torch, mesh):
    """Phase 26a: the same model with ring attention on the one-rank mesh
    against the one-device fp32 flash kernels: loss within
    SHARDED["tol"], grads within MODEL_GRAD_TOL, and the ring's steps
    launch no flash kernel (the ring path ran)."""
    worst_loss, worst_grad, launches, _ = mesh_parity(torch, mesh, "ring")
    if any(any(d.values()) for d in launches):
        fail(f"ring parity: the ring step launched flash kernels "
             f"{launches}")
    if worst_loss > SHARDED["tol"] or worst_grad > MODEL_GRAD_TOL:
        fail(f"ring parity: loss gap {worst_loss:.3e} (limit "
             f"{SHARDED['tol']}), grad gap {worst_grad:.3e} (limit "
             f"{MODEL_GRAD_TOL})")
    return dict(worst_loss_rel=worst_loss, worst_grad_rel=worst_grad,
                launches=launches)


def ulysses_check(torch, mesh, rank=0):
    """Phase 26b (and --mesh-check's Ulysses): ``ulysses_attention``
    inside ``local_map`` on ``mesh``'s seq axis at FLASH_CASES[0], forward
    and backward, against ``mha_reference`` on the whole tensors at that
    case's tolerances on rank 0; each rank launches each flash kernel
    once."""
    import functools

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.ops import ulysses_attention
    from ray_tpu_torch.ops.attention import flash_attention, mha_reference
    from ray_tpu_torch.parallel.sharding import spec_placements

    name, kind, causal, sq, sk, atol, rtol = FLASH_CASES[0]
    q, k, v, do = flash_inputs(torch, kind, sq, sk, SEQ["ulysses_seed"])
    pl = spec_placements(("fsdp", "seq"), mesh)
    args = [distribute_tensor(t, mesh, pl).requires_grad_()
            for t in (q, k, v)]
    op = local_map(functools.partial(ulysses_attention, mesh=mesh,
                                     axis_name="seq", causal=causal),
                   out_placements=list(pl), in_placements=(pl,) * 3,
                   device_mesh=mesh)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = op(*args)
    grads = torch.autograd.grad(out, args, distribute_tensor(do, mesh, pl))
    torch.cuda.synchronize()
    launches = dict(flash_attention.launches)
    if launches != {"fwd": 1, "dq": 1, "dkv": 1}:
        fail(f"ulysses: rank {rank} launched {launches}, want 1/1/1")
    got = [t.full_tensor() for t in (out,) + tuple(grads)]
    errs = {}
    if rank == 0:
        ref_in = [t.detach().requires_grad_() for t in (q, k, v)]
        ref = mha_reference(*ref_in, causal=causal)
        want = (ref,) + torch.autograd.grad(ref, ref_in, do)
        for label, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            err, ok, n_bad = close(torch, g, w, atol, rtol)
            errs[label] = err
            if not ok:
                fail(f"ulysses ({name}) disagrees with mha_reference "
                     f"({label}): max_abs_err={err}, {n_bad} elements "
                     f"out (atol {atol}, rtol {rtol})")
        print(f"[ulysses] {name} (B={FLASH_SHAPE['B']}, S={sq}, Hq="
              f"{FLASH_SHAPE['HQ']}, KVH={FLASH_SHAPE['KVH']}, D="
              f"{FLASH_SHAPE['D']}) on mesh {list(mesh.mesh_dim_names)} "
              f"{list(mesh.shape)}: "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f" (atol {atol}, rtol {rtol}); launches {launches}")
    del q, k, v, do, args, out, grads, got
    torch.cuda.empty_cache()
    return dict(max_abs_err=errs, launches=launches)


def sharded_train(torch, card, train, mix):
    """Phase 25, the sharded trainer on a one-rank mesh, then phase 26,
    the seq path, phase 27, Mixtral on the mesh, and phase 28, the
    checkpoint plane, on the same NCCL group: (phase 25's stats, phase
    26's, 27's, 28's)."""
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = make_mesh(MeshConfig())
            sharded_parity(torch, mesh)
            sharded = _sharded_run(torch, card, train, mesh)
            seq = timed("phase 26", seq_phases, torch, card, train,
                        make_mesh(MeshConfig(seq=1)))
            mix_mesh = timed("phase 27", mixtral_mesh_train, torch, card,
                             mix, mesh)
            ckpt = timed("phase 28", checkpoint_phase, torch, card, mesh)
            return sharded, seq, mix_mesh, ckpt
        finally:
            dist.destroy_process_group()


def seq_phases(torch, card, train, mesh):
    """Phase 26 on a one-rank mesh: 26a ring parity, 26b Ulysses with the
    flash kernels, 26c phase 10's run with ring attention."""
    out = {"ring_parity": ring_parity(torch, mesh),
           "ulysses": ulysses_check(torch, mesh)}
    out["train"] = _sharded_run(torch, card, train, mesh, attention="ring")
    return out


def ring_attention_ms(torch, cfg, batch, seq):
    """CUDA-event ms of one layer's ring attention at the run's shape on
    a one-rank mesh (one block over the whole sequence): the forward and
    the forward with its backward."""
    import functools

    from ray_tpu_torch.ops import ring_attention
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(seq=1))
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(heads):
        return torch.randn((batch, seq, heads, cfg.head_dim), generator=gen,
                           device="cuda").to(cfg.dtype).requires_grad_()
    q, k, v = rnd(cfg.num_heads), rnd(cfg.num_kv_heads), \
        rnd(cfg.num_kv_heads)
    do = torch.randn_like(q)
    ring = functools.partial(ring_attention, mesh=mesh, axis_name="seq",
                             causal=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fwd = time_ms(torch, lambda: ring(q, k, v), flush, SEQ["timed_iters"])
    fwd_bwd = time_ms(torch, lambda: torch.autograd.grad(
        ring(q, k, v), (q, k, v), do), flush, SEQ["timed_iters"])
    del q, k, v, do, flush
    torch.cuda.empty_cache()
    return fwd, fwd_bwd


def _sharded_run(torch, card, train, mesh, attention="auto"):
    """Phase 10's run through ``ShardedTrainer`` on the one-rank ``mesh``
    (phase 25), or with ring attention (phase 26c)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import DEFAULT_RULES

    t = TRAIN
    ring = attention == "ring"
    tag = "seq-train" if ring else "sharded-train"
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=t["layers"], attention=attention)
    trainer = ShardedTrainer(cfg, mesh, optimizer=default_optimizer(
        warmup_steps=t["warmup"], total_steps=t["total"]),
        rules=DEFAULT_RULES)
    state = trainer.init_state(0)
    batch = trainer.shard_batch(synthetic_batch(t["batch"], t["seq"],
                                                cfg.vocab_size, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    reset_launch_counts()
    for _ in range(t["steps"]):
        before = dict(flash_attention.launches)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))      # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: flash_attention.launches[n] - before[n]
                         for n in before})
    launches = dict(flash_attention.launches)
    L = cfg.num_layers
    want = ({"fwd": 0, "dq": 0, "dkv": 0} if ring
            else {"fwd": 2 * L, "dq": L, "dkv": L})
    ref = train["losses"]
    first_gap = abs(losses[0] - ref[0]) / abs(ref[0])
    loss_tol = SEQ["loss_rtol"] if ring else SHARDED["tol"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{tag}: losses {losses} (want finite, last below first)")
    if first_gap > loss_tol:
        fail(f"{tag}: step 1 loss {losses[0]} against phase 10's "
             f"{ref[0]} (relative gap {first_gap:.3e}, limit {loss_tol})")
    if any(d != want for d in per_step):
        fail(f"{tag}: launches per step {per_step}, want {want}")
    step_s = float(np.median(step_ms[2:])) / 1e3
    tokens = t["batch"] * t["seq"]
    stats = dict(
        mesh=llama.mesh_shape(mesh), attention=attention, layers=L,
        losses=losses, step_ms=step_ms, step_ms_median_3_12=step_s * 1e3,
        tokens_per_s=tokens / step_s,
        mfu=train_flops(cfg, llama.num_params(cfg), t["batch"], t["seq"])
        / step_s / PEAK_OPS_PER_S["bf16"],
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        step1_loss_gap=first_gap,
        max_loss_gap=max(abs(a - b) / abs(b) for a, b in zip(losses, ref)),
        launches_per_step=want, launches=launches, card=card)
    stats["phase10"] = {k: train[k] for k in (
        "step_ms_median_3_12", "tokens_per_s", "mfu", "peak_gib")}
    peak_limit = SEQ["peak_gib"] if ring else SHARDED["peak_gib"]
    if stats["peak_gib"] > peak_limit:
        fail(f"{tag}: peak {stats['peak_gib']:.2f} GiB over {peak_limit}")

    def one_step():
        float(trainer.train_step(state, batch)[1]["loss"])
    prof = profile_step(torch, one_step, step_s * 1e3, flash=not ring)
    stats["idle_share"] = prof["idle_share"]
    del state, trainer, batch
    torch.cuda.empty_cache()
    if ring:
        fwd, fwd_bwd = ring_attention_ms(torch, cfg, t["batch"], t["seq"])
        # Under remat "full" a step runs each layer's ring forward twice
        # and its backward once: L x (forward + forward-and-backward).
        stats["ring_layer_ms"] = dict(fwd=fwd, fwd_bwd=fwd_bwd)
        stats["attention_share"] = L * (fwd + fwd_bwd) / prof[
            "device_busy_ms"]
    else:
        stats["attention_share"] = sum(
            prof["groups_ms"][g] for g in ("flash_fwd", "flash_dq",
                                           "flash_dkv")) / prof[
            "device_busy_ms"]
    print(f"[{tag}] {json.dumps(stats)}")
    print(f"[{tag.split('-')[0]}-profile] one step: {json.dumps(prof)}")
    return stats


def mesh_check(torch, sections=MESH_SECTIONS):
    """``--mesh-check``: the sharded trainer on four cards (``sections``
    of MESH_SECTIONS, all by default)."""
    import socket

    import torch.multiprocessing as mp

    from ray_tpu_torch.ops import _build

    world = MESH_CHECK["world"]
    if torch.cuda.device_count() < world:
        fail(f"--mesh-check needs {world} cards, found "
             f"{torch.cuda.device_count()}")
    _build.build_all()
    ranked = tuple(s for s in sections
                   if s not in ("train-controller", "rllib", "pool"))
    if ranked:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.start_processes(mesh_rank, args=(world,
                                            f"tcp://localhost:{port}",
                                            "nccl", ranked),
                           nprocs=world, start_method="spawn", join=True)
    if "train-controller" in sections:
        # TorchTrainer spawns and places its own four workers.
        mesh_train_controller(torch, card_line())
    if "rllib" in sections:
        # LearnerGroup places its own learners, a card each.
        mesh_rllib(torch, card_line())
    if "pool" in sections:
        # The serving process places its replicas and the trainer's
        # workers from one card book.
        mesh_pool(torch, card_line())
        stop_processes()


def mesh_rank(rank, world, init_method, backend, sections=MESH_SECTIONS):
    """One rank of ``--mesh-check`` (``backend`` "gloo" runs it on the
    CPU)."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        extra = dict(device_id=device)
    else:
        device, extra = torch.device("cpu"), {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **extra)
    card = card_line() if backend == "nccl" else "cpu"
    try:
        if "trainer" in sections:
            mesh_trainer(torch, rank, device, card)
        if "moe" in sections:
            for name, sizes in MESH_MOE["layouts"]:
                res = mesh_moe_case(torch, rank, device, sizes)
                if rank == 0:
                    print(f"[mesh-moe] {name}: {json.dumps(res)}",
                          flush=True)
        if "mixtral" in sections:
            res = mesh_mixtral(torch, device)
            if rank == 0:
                res["card"] = card
                print(f"[mesh-mixtral] {json.dumps(res)}", flush=True)
        if "ckpt" in sections:
            res = mesh_ckpt(torch, rank, device)
            if rank == 0:
                res["card"] = card
                print(f"[mesh-ckpt] {json.dumps(res)}", flush=True)
        if "collective" in sections:
            # A collective that hangs ends the rank (and the check) in
            # 300 s instead of holding the cards to the call's limit.
            import faulthandler

            faulthandler.dump_traceback_later(300, exit=True)
            res = mesh_collective(torch, rank, world, backend)
            faulthandler.cancel_dump_traceback_later()
            if rank == 0:
                res["card"] = card
                print(f"[mesh-collective] {json.dumps(res)}", flush=True)
    finally:
        dist.destroy_process_group()


COLLECTIVE = dict(shape=(6, 5), sizes_mib=(1, 64), timed_iters=5)


def mesh_collective(torch, rank, world, backend):
    """``[mesh-collective]``: the host collective
    (``ray_tpu_torch.util.collective``) through named groups beside the
    default group, on NCCL (arrays staged through each rank's card) and
    on gloo; every op against numpy on every rank's inputs (drawn from
    each rank's seed, so every rank knows them all): exactly on
    integer-valued inputs and for min and max, within 1e-6 of the terms'
    magnitude on fp32 sums and products; then an fp32 allreduce of
    COLLECTIVE["sizes_mib"] MiB timed a backend (median of
    ``timed_iters``)."""
    import torch.distributed as dist

    from ray_tpu_torch.util import collective

    port = [None]
    if rank == 0:
        store = dist.TCPStore("localhost", 0, world, True,
                              wait_for_workers=False)
        port = [store.port]
    dist.broadcast_object_list(port, src=0)
    if rank:
        store = dist.TCPStore("localhost", port[0], world, False)
    backends = ("nccl", "gloo") if backend == "nccl" else ("gloo",)

    def inputs(r, kind):
        rng = np.random.default_rng(100 + r)
        if kind == "int":
            return rng.integers(-8, 9, size=COLLECTIVE["shape"]).astype(
                np.float32)
        return rng.standard_normal(COLLECTIVE["shape"]).astype(np.float32)

    out = {}
    for be in backends:
        name = f"mesh-{be}"
        g = collective.init_collective_group(world, rank, name,
                                             backend=be, store=store)
        errs = {}
        for kind in ("int", "fp32"):
            xs = [inputs(r, kind) for r in range(world)]
            for op, ref in (("sum", np.sum), ("max", np.max),
                            ("min", np.min), ("product", np.prod)):
                got = g.allreduce(xs[rank], op)
                want = ref(np.stack(xs), axis=0)
                err = float(np.abs(got - want).max())
                # fp32: rtol 1e-6 of the terms' magnitude (a sum of terms
                # of both signs may cancel to near zero).
                scale = (np.sum(np.abs(np.stack(xs)), axis=0)
                         if op == "sum" else np.abs(want))
                ok = (err == 0 if kind == "int" or op in ("min", "max")
                      else bool((np.abs(got - want) <= 1e-6 * scale).all()))
                if not ok:
                    fail(f"[mesh-collective] {be} allreduce {op} {kind}: "
                         f"max err {err}")
                errs[f"allreduce-{op}-{kind}"] = err
        xs = [inputs(r, "int") for r in range(world)]
        parts = g.allgather(xs[rank])
        if not all(np.array_equal(a, b) for a, b in zip(parts, xs)):
            fail(f"[mesh-collective] {be} allgather")
        red = g.reduce(xs[rank], dst_rank=1)
        want = np.sum(np.stack(xs), axis=0)
        if rank == 1 and not np.array_equal(red, want):
            fail(f"[mesh-collective] {be} reduce")
        bc = g.broadcast(xs[rank] if rank == 2 else None, src_rank=2)
        if not np.array_equal(bc, xs[2]):
            fail(f"[mesh-collective] {be} broadcast")
        rs = g.reducescatter(np.arange(30, dtype=np.float32) * (rank + 1))
        want = np.array_split(np.arange(30, dtype=np.float32)
                              * sum(range(1, world + 1)), world)[rank]
        if not np.array_equal(rs, want):
            fail(f"[mesh-collective] {be} reducescatter")
        g.barrier()
        timing = {}
        for mib in COLLECTIVE["sizes_mib"]:
            big = np.ones(mib << 18, np.float32)
            g.allreduce(big)
            times = []
            for _ in range(COLLECTIVE["timed_iters"]):
                g.barrier()
                t0 = time.perf_counter()
                g.allreduce(big)
                times.append(time.perf_counter() - t0)
            med = float(np.median(times))
            timing[f"{mib}MiB"] = dict(ms=med * 1e3,
                                       gb_s=big.nbytes / med / 1e9)
        if rank == 0:
            print(f"[mesh-collective] {be}: {json.dumps(timing)}",
                  flush=True)
        # A ring of point-to-point hops. NCCL completes a send only when
        # its peer receives (and forms each pair's communicator at their
        # first exchange), so even ranks send first and odd ranks receive
        # first; gloo takes either order.
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        if rank % 2 == 0:
            g.send(xs[rank], nxt, tag="ring")
            got = g.recv(prv, tag="ring")
        else:
            got = g.recv(prv, tag="ring")
            g.send(xs[rank], nxt, tag="ring")
        if not np.array_equal(got, xs[prv]):
            fail(f"[mesh-collective] {be} send/recv")
        collective.destroy_collective_group(name)
        out[be] = dict(max_err=errs, allreduce=timing)
    # The default group still answers beside the named ones.
    t = torch.ones(1, device="cuda" if backend == "nccl" else "cpu")
    dist.all_reduce(t)
    if int(t.item()) != world:
        fail("[mesh-collective] the default group broke")
    return out


def mesh_trainer(torch, rank, device, card):
    """``--mesh-check``'s trainer section: the parity layouts, Ulysses,
    the pipelines and phase 10's model on four ranks."""
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    for name, sizes, micro in MESH_CHECK["layouts"]:
        res = mesh_parity_case(torch, rank, device, sizes, micro)
        if rank == 0:
            print(f"[mesh-check] {name}: {json.dumps(res)}",
                  flush=True)
    res = ulysses_check(torch, make_mesh(
        MeshConfig(**MESH_CHECK["ulysses_mesh"]),
        device_type=device.type), rank)
    if rank == 0:
        print(f"[mesh-ulysses] {json.dumps(res)}", flush=True)
    for case in MESH_CHECK["pipelines"]:
        res = mesh_pipeline(torch, rank, device, *case)
        if rank == 0:
            print(f"[mesh-pipeline] {case[0]}: {json.dumps(res)}",
                  flush=True)
    for name, sizes, rows, seq in MESH_CHECK["train"]:
        res = mesh_train(torch, device, sizes, rows, seq)
        if rank == 0:
            res["card"] = card
            print(f"[mesh-train] {name}: {json.dumps(res)}",
                  flush=True)


def mesh_pipeline(torch, rank, device, name, sizes, stages, width, micro,
                  rows):
    """``pipelined`` on a four-rank mesh (tanh(x @ w + b) a stage, fp32)
    against the sequential stages on each rank: the output within 1e-5
    and the grads within 1e-4."""
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.pipeline import pipelined

    gen = torch.Generator(device=device).manual_seed(5)
    w = torch.randn((stages, width, width), generator=gen, device=device)
    b = torch.randn((stages, width), generator=gen, device=device) * 0.1
    x = torch.randn((rows, width), generator=gen, device=device)
    params = {"w": (w * 0.5).requires_grad_(), "b": b.requires_grad_()}

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    run = pipelined(stage_fn, make_mesh(MeshConfig(**sizes),
                                        device_type=device.type),
                    num_microbatches=micro)
    out = run(params, x)
    got = torch.autograd.grad((out ** 2).sum(), list(params.values()))
    h = x
    for s in range(stages):
        h = stage_fn({k: v[s] for k, v in params.items()}, h)
    want = torch.autograd.grad((h ** 2).sum(), list(params.values()))
    out_err = float((out - h).abs().max())
    grad_err = max(float((a - c).abs().max()) for a, c in zip(got, want))
    if out_err > 1e-5 or grad_err > 1e-4:
        fail(f"mesh pipeline {name}: rank {rank} out err {out_err:.3e}, "
             f"grad err {grad_err:.3e} against the sequential stages")
    return dict(mesh=sizes, stages=stages, microbatches=micro,
                out_max_abs_err=out_err, grad_max_abs_err=grad_err)


def mesh_parity_case(torch, rank, device, sizes, micro):
    """Phase 25's fp32 parity model on a four-rank mesh against the
    one-device trainer on rank 0: loss and grad norm each step."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import DEFAULT_RULES, MeshConfig, make_mesh

    p = dict(SHARDED_PARITY)
    p.pop("batch")
    seq = p.pop("seq")
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **p)

    def opt():
        return default_optimizer(warmup_steps=2, total_steps=50,
                                 learning_rate=1e-2)

    mesh = make_mesh(MeshConfig(**sizes), device_type=device.type)
    sharded = ShardedTrainer(cfg, mesh, optimizer=opt(),
                             rules=DEFAULT_RULES, microbatches=micro)
    state = sharded.init_state(0)
    batch = synthetic_batch(MESH_CHECK["batch"], seq, cfg.vocab_size,
                            seed=1, device=device)
    one = one_state = None
    if rank == 0:
        one = ShardedTrainer(cfg, optimizer=opt(), microbatches=micro,
                             device=device)
        one_state = one.init_state(0)
    worst_loss = worst_norm = 0.0
    # On a seq axis "auto" picks ring attention: no flash kernel.
    want = 0 if sizes.get("seq", 1) > 1 else cfg.num_layers * micro
    for _ in range(MESH_CHECK["parity_steps"]):
        before = dict(flash_attention.launches)
        state, m = sharded.train_step(state, batch)
        launched = {n: flash_attention.launches[n] - before[n]
                    for n in before}
        if device.type == "cuda" and launched != dict.fromkeys(before,
                                                               want):
            fail(f"mesh check {sizes}: launched {launched} a step")
        if rank == 0:
            one_state, m1 = one.train_step(one_state, batch)
            worst_loss = max(worst_loss, abs(float(m["loss"])
                                             - float(m1["loss"]))
                             / abs(float(m1["loss"])))
            worst_norm = max(worst_norm, abs(float(m["grad_norm"])
                                             - float(m1["grad_norm"]))
                             / abs(float(m1["grad_norm"])))
    w = state.params["layers"]["w_gate"]
    share = w.numel() // (sizes.get("fsdp", 1) * sizes.get("tensor", 1))
    if w.to_local().numel() != share:
        fail(f"mesh check {sizes}: rank {rank} holds "
             f"{w.to_local().numel()} of w_gate's {w.numel()}, want "
             f"{share}")
    if rank == 0 and (worst_loss > SHARDED["tol"] or worst_norm > 1e-4):
        fail(f"mesh check {sizes}: loss gap {worst_loss:.3e}, grad norm "
             f"gap {worst_norm:.3e} against one device")
    return dict(mesh=llama.mesh_shape(mesh), microbatches=micro,
                worst_loss_rel=worst_loss, worst_grad_norm_rel=worst_norm,
                w_gate_local=w.to_local().numel(), w_gate=w.numel())


def mesh_train(torch, device, sizes, rows, seq):
    """Phase 10's model on a four-rank mesh of ``sizes`` (ring attention
    on a seq axis), a ``rows`` x ``seq`` batch, MESH_CHECK["steps"]
    steps."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import DEFAULT_RULES, MeshConfig, make_mesh

    t = TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=t["layers"])
    mesh = make_mesh(MeshConfig(**sizes), device_type=device.type)
    trainer = ShardedTrainer(cfg, mesh, optimizer=default_optimizer(
        warmup_steps=t["warmup"], total_steps=t["total"]),
        rules=DEFAULT_RULES)
    state = trainer.init_state(0)
    batch = trainer.shard_batch(synthetic_batch(
        rows, seq, cfg.vocab_size, seed=0, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for _ in range(MESH_CHECK["steps"]):
        before = dict(flash_attention.launches)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))      # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: flash_attention.launches[n] - before[n]
                         for n in before})
    L = cfg.num_layers
    want = ({"fwd": 0, "dq": 0, "dkv": 0} if sizes.get("seq", 1) > 1
            else {"fwd": 2 * L, "dq": L, "dkv": L})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"mesh train {sizes}: losses {losses}")
    if device.type == "cuda" and any(d != want for d in per_step):
        fail(f"mesh train {sizes}: launches per step {per_step}, want "
             f"{want}")
    step_s = float(np.median(step_ms[2:])) / 1e3
    world = mesh.size()
    tokens = rows * seq
    return dict(
        mesh=llama.mesh_shape(mesh), layers=L, batch=[rows, seq],
        losses=losses, step_ms=step_ms, step_ms_median_3_on=step_s * 1e3,
        tokens_per_s=tokens / step_s, tokens_per_s_per_card=tokens / step_s
        / world,
        mfu_per_card=train_flops(cfg, llama.num_params(cfg), rows, seq)
        / step_s / world / PEAK_OPS_PER_S["bf16"],
        peak_gib_rank0=(torch.cuda.max_memory_allocated() / 2**30
                        if device.type == "cuda" else None),
        w_gate_local=state.params["layers"]["w_gate"].to_local().numel(),
        launches_per_step=want)


def mixtral_dropped(torch, params, tokens, cfg):
    """Each layer's ``dropped_fraction``: ``moe.moe_layer`` on that
    layer's input, in a no-grad forward (flash launches included, so
    outside a counted window)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import moe

    dropped = []

    def mlp(h, layer):
        out, aux = moe.moe_layer(
            h, {"w_router": layer["w_router"], "w_gate": layer["moe_gate"],
                "w_up": layer["moe_up"], "w_down": layer["moe_down"]},
            num_experts=cfg.num_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor)
        dropped.append(aux["dropped_fraction"])
        return out, aux["aux_loss"]

    backbone = dataclasses.replace(cfg.backbone(), remat=False)
    with torch.no_grad(), llama.fp32_reduction(tokens.device, cfg.dtype):
        llama.hidden_states(params, tokens, backbone, mlp_fn=mlp)
    return [float(d) for d in dropped]


def mixtral_parity(torch):
    """Phase 23: Mixtral loss_fn and every grad leaf, kernels against
    plain, at Mixtral-8x7B widths (2 layers, fp32)."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.ops.attention import flash_attention

    m = MIXTRAL_PARITY
    cfg = mixtral.MixtralConfig.mixtral_8x7b(dtype=torch.float32,
                                             num_layers=m["layers"])
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(4), device="cuda")
    leaves = [p.requires_grad_(True) for p in _param_leaves(params)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, m["seq"]), generator=gen,
                           device="cuda", dtype=torch.int32)
    got = {}
    for kernel in (None, False):
        before = dict(flash_attention.launches)
        loss, metrics = mixtral.loss_fn(
            params, {"tokens": tokens},
            dataclasses.replace(cfg, attention_kernel=kernel))
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launched = {n: flash_attention.launches[n] - before[n]
                    for n in before}
        if (kernel is None) != (launched["fwd"] > 0 and launched["dq"] > 0
                                and launched["dkv"] > 0):
            fail(f"mixtral parity: kernel={kernel} launched {launched}")
        got[kernel] = (float(loss.detach()),
                       float(metrics["aux_loss"].detach()), grads)
    (l1, a1, g1), (l0, a0, g0) = got[None], got[False]
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for a, b in zip(g1, g0))
    dropped = mixtral_dropped(torch, params, tokens, cfg)
    print(f"[mixtral-parity] fp32 Mixtral-8x7B widths, {cfg.num_layers} "
          f"layers, {m['seq']} tokens ({mixtral.num_params(cfg) / 1e9:.3f} "
          f"B params): total loss kernel {l1:.8f} plain {l0:.8f}; aux_loss "
          f"kernel {a1:.8f} plain {a0:.8f}; worst grad leaf "
          f"max|diff|/max|grad| {worst:.3e} (limits: loss rtol "
          f"{MODEL_LOSS_RTOL}, grads {MODEL_GRAD_TOL}); dropped_fraction "
          f"by layer {dropped}")
    if not (abs(l1 - l0) <= MODEL_LOSS_RTOL * abs(l0)
            and worst <= MODEL_GRAD_TOL):
        fail("mixtral parity: kernel and plain loss_fn disagree")
    del params, leaves, got, g1, g0, grads
    torch.cuda.empty_cache()


def mixtral_train(torch, card):
    """Phase 24: Mixtral training at Mixtral-8x7B widths, 4 layers."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.models.training import (default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention

    t = MIXTRAL_TRAIN
    cfg = mixtral.MixtralConfig.mixtral_8x7b(num_layers=t["layers"])
    t0 = time.perf_counter()
    params = mixtral.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    leaves = [p.requires_grad_(True) for p in _param_leaves(params)]
    opt = default_optimizer(warmup_steps=t["warmup"], total_steps=t["total"])
    state = opt.init(params)
    batch = synthetic_batch(t["batch"], t["seq"], cfg.vocab_size, seed=0)
    torch.cuda.synchronize()
    n_params, active = mixtral.num_params(cfg), mixtral.active_params(cfg)
    if sum(p.numel() for p in leaves) != n_params:
        fail("mixtral train: the param leaves do not add up to num_params")
    print(f"[mixtral-train] Mixtral-8x7B widths, {cfg.num_layers} of 32 "
          f"layers: {n_params / 1e9:.3f} B params ({active / 1e9:.3f} B "
          f"active a token), bf16, remat {cfg.remat_policy!r}; init "
          f"{time.perf_counter() - t0:.1f} s")
    dropped_first = mixtral_dropped(torch, params, batch["tokens"], cfg)

    def step():
        return mixtral_one_step(torch, cfg, params, opt, state, batch)[0]

    torch.cuda.reset_peak_memory_stats()
    ce, aux, total, step_ms, per_step = [], [], [], [], []
    reset_launch_counts()
    for _ in range(t["steps"]):
        before = dict(flash_attention.launches)
        t0 = time.perf_counter()
        metrics = step()
        ce.append(float(metrics["loss"]))          # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        aux.append(float(metrics["aux_loss"]))
        total.append(float(metrics["total_loss"]))
        per_step.append({n: flash_attention.launches[n] - before[n]
                         for n in before})
    launches = dict(flash_attention.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.num_layers
    want = {"fwd": 2 * L, "dq": L, "dkv": L}
    if not (all(np.isfinite(ce + aux + total)) and ce[-1] < ce[0]):
        fail(f"mixtral train: cross-entropy {ce}, aux {aux}, total {total} "
             f"(want finite, the last cross-entropy below the first)")
    if any(d != want for d in per_step):
        fail(f"mixtral train: launches per step {per_step}, want {want}")
    if not peak_gib < t["peak_gib"]:
        fail(f"mixtral train: peak {peak_gib:.2f} GiB, limit "
             f"{t['peak_gib']}")
    dropped_last = mixtral_dropped(torch, params, batch["tokens"], cfg)
    tokens = t["batch"] * t["seq"]
    # Each layer's expert products run over X * C rows; the kept (token,
    # choice) pairs fill (1 - dropped) * T * k of them, the rest is
    # capacity padding (zero rows).
    rows = cfg.num_experts * max(int(cfg.capacity_factor * tokens
                                     * cfg.top_k / cfg.num_experts),
                                 cfg.top_k)
    padding = [1.0 - (1.0 - d) * tokens * cfg.top_k / rows
               for d in dropped_last]
    step_s = float(np.median(step_ms[2:])) / 1e3
    stats = dict(
        layers=L, params=n_params, active_params=active,
        cross_entropy=ce, aux_loss=aux, total_loss=total, step_ms=step_ms,
        step_ms_median_3_12=step_s * 1e3, tokens_per_s=tokens / step_s,
        mfu_active=train_flops(cfg.backbone(), active, t["batch"], t["seq"])
        / step_s / PEAK_OPS_PER_S["bf16"],
        peak_gib=peak_gib, expert_rows_per_layer=rows,
        dropped_fraction_first=dropped_first,
        dropped_fraction_last=dropped_last,
        capacity_padding_share=padding,
        launches_per_step=want, launches=launches, card=card)
    print(f"[mixtral-train] {json.dumps(stats)}")
    prof = profile_step(torch, lambda: float(step()["loss"]), step_s * 1e3,
                        routing=True)
    print(f"[mixtral-profile] one step: {json.dumps(prof)}")
    stats["profile"] = prof
    del params, leaves, state, batch
    torch.cuda.empty_cache()
    return stats


def mixtral_mesh_step(torch, cfg, params, opt, opt_state, batch, mesh):
    """One Mixtral optimizer step on ``mesh`` (phase 24's step through
    the 7d path): loss and grads on DTensors, each grad redistributed to
    its param's placements, ``AdamW.apply_`` in place. Returns the
    metrics (full values) and the grad norm."""
    from ray_tpu_torch.models import llama, mixtral
    from ray_tpu_torch.models.training import AdamW, _placed_like

    leaves = _param_leaves(params)
    dev = leaves[0].device
    with llama.fp32_reduction(dev, cfg.dtype):
        loss, metrics = mixtral.loss_fn(params, batch, cfg, mesh)
        grads = torch.autograd.grad(loss, leaves)
        grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
        norm = AdamW.global_norm(grads)
        opt.apply_(grads, opt_state, params, g_norm=norm)
    return {k: v.detach().full_tensor() for k, v in metrics.items()}, norm


def mixtral_on_mesh(torch, cfg, mesh, seed, device):
    """``mixtral.init_params`` from ``seed`` (the full params on every
    rank, each keeping its shards) placed by ``mixtral.logical_axes``:
    the leaves require grad."""
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel import tree_shardings
    from ray_tpu_torch.parallel.sharding import tree_map

    params = mixtral.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    placed = tree_map(lambda t, pl: distribute_tensor(
        t, mesh, pl, src_data_rank=None), params,
        tree_shardings(mesh, mixtral.logical_axes(cfg)))
    del params
    for p in _param_leaves(placed):
        p.requires_grad_(True)
    return placed


def mesh_batch(torch, batch, mesh):
    """Each tensor of ``batch`` split by the rules' (batch, seq)."""
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.parallel.sharding import placements_for

    return {k: distribute_tensor(v, mesh, placements_for(
        mesh, v.shape, "batch", "seq")) for k, v in batch.items()}


def mixtral_mesh_train(torch, card, mix, mesh):
    """Phase 27: phase 24's run on the one-rank ``mesh`` through the
    expert-parallel layer."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.models.training import (default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention

    t = MIXTRAL_TRAIN
    cfg = mixtral.MixtralConfig.mixtral_8x7b(num_layers=t["layers"])
    params = mixtral_on_mesh(torch, cfg, mesh, 0, "cuda")
    opt = default_optimizer(warmup_steps=t["warmup"], total_steps=t["total"])
    state = opt.init(params)
    batch = mesh_batch(torch, synthetic_batch(t["batch"], t["seq"],
                                              cfg.vocab_size, seed=0), mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce, aux, step_ms, per_step = [], [], [], []
    reset_launch_counts()
    for _ in range(t["steps"]):
        before = dict(flash_attention.launches)
        t0 = time.perf_counter()
        metrics, _ = mixtral_mesh_step(torch, cfg, params, opt, state,
                                       batch, mesh)
        ce.append(float(metrics["loss"]))          # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        aux.append(float(metrics["aux_loss"]))
        per_step.append({n: flash_attention.launches[n] - before[n]
                         for n in before})
    launches = dict(flash_attention.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.num_layers
    want = {"fwd": 2 * L, "dq": L, "dkv": L}
    gap = abs(ce[0] - mix["cross_entropy"][0]) / abs(mix["cross_entropy"][0])
    if not (all(np.isfinite(ce + aux)) and ce[-1] < ce[0]):
        fail(f"mixtral mesh train: cross-entropy {ce}, aux {aux} (want "
             f"finite, the last cross-entropy below the first)")
    if gap > SHARDED["tol"]:
        fail(f"mixtral mesh train: step 1 loss {ce[0]} against phase 24's "
             f"{mix['cross_entropy'][0]} (relative gap {gap:.3e}, limit "
             f"{SHARDED['tol']})")
    if any(d != want for d in per_step):
        fail(f"mixtral mesh train: launches per step {per_step}, want "
             f"{want}")
    if not peak_gib < t["peak_gib"]:
        fail(f"mixtral mesh train: peak {peak_gib:.2f} GiB, limit "
             f"{t['peak_gib']}")
    step_s = float(np.median(step_ms[2:])) / 1e3
    tokens = t["batch"] * t["seq"]
    active = mixtral.active_params(cfg)
    stats = dict(
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), layers=L,
        cross_entropy=ce, aux_loss=aux, step_ms=step_ms,
        step_ms_median_3_12=step_s * 1e3, tokens_per_s=tokens / step_s,
        mfu_active=train_flops(cfg.backbone(), active, t["batch"], t["seq"])
        / step_s / PEAK_OPS_PER_S["bf16"],
        peak_gib=peak_gib, step1_loss_gap=gap,
        max_loss_gap=max(abs(a - b) / abs(b) for a, b in zip(
            ce, mix["cross_entropy"])),
        launches_per_step=want, launches=launches, card=card)
    stats["phase24"] = {k: mix[k] for k in (
        "step_ms_median_3_12", "tokens_per_s", "mfu_active", "peak_gib")}

    def one_step():
        float(mixtral_mesh_step(torch, cfg, params, opt, state, batch,
                                mesh)[0]["loss"])
    prof = profile_step(torch, one_step, step_s * 1e3, routing=True)
    stats["idle_share"] = prof["idle_share"]
    stats["moe_routing_ms"] = prof["groups_ms"]["moe_routing"]
    print(f"[mixtral-mesh-train] {json.dumps(stats)}")
    print(f"[mixtral-mesh-profile] one step: {json.dumps(prof)}")
    del params, state, batch
    torch.cuda.empty_cache()
    return stats


def _state_leaves(state):
    """A TrainState's params and both moments, in the params' order."""
    from ray_tpu_torch.models.training import _leaves

    return _leaves(state.params) + state.opt_state.mu + state.opt_state.nu


def _state_bytes(state):
    return sum(t.numel() * t.element_size() for t in _state_leaves(state))


def _same_state(torch, got, want, what):
    """``got`` equals ``want`` bit for bit: step, count, and each leaf in
    full (both may be DTensors)."""
    if (got.step, got.opt_state.count) != (want.step, want.opt_state.count):
        fail(f"{what}: restored step/count {got.step}/"
             f"{got.opt_state.count}, saved {want.step}/"
             f"{want.opt_state.count}")
    for a, b in zip(_state_leaves(got), _state_leaves(want)):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        if a.dtype != b.dtype or not torch.equal(a.detach(), b.detach()):
            fail(f"{what}: a restored leaf differs from the saved one")


def _flip_byte(path, offset=4096):
    """Flip one byte of a file in place (silent media corruption)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def _ckpt_trainer(mesh=None, device=None, learning_rate=None):
    """Phase 28's trainer: Llama-3-8B widths at CKPT["layers"] layers,
    phase 10's optimizer (at ``learning_rate`` when given: phase 39's
    trials), on ``mesh`` or on one device."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer)
    from ray_tpu_torch.parallel import DEFAULT_RULES

    t = TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=CKPT["layers"])
    lr = {} if learning_rate is None else {"learning_rate": learning_rate}
    opt = default_optimizer(warmup_steps=t["warmup"], total_steps=t["total"],
                            **lr)
    if mesh is None:
        return ShardedTrainer(cfg, optimizer=opt, device=device)
    return ShardedTrainer(cfg, mesh, optimizer=opt, rules=DEFAULT_RULES)


def _scratch_dir(need_bytes, what):
    """A fresh temp dir, after checking that its file system has
    ``need_bytes`` free."""
    import shutil
    import tempfile

    root = tempfile.gettempdir()
    free = shutil.disk_usage(root).free
    if free < need_bytes:
        fail(f"{what}: {root} has {free} bytes free, the run needs "
             f"{need_bytes}")
    return tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=root), free


def checkpoint_phase(torch, card, mesh):
    """Phase 28: ShardedTrainer's state through the checkpoint plane on
    the card: two async saves, restores onto the one-rank ``mesh`` and
    onto one device, a third step from each, and the fallback past a
    corrupt shard."""
    import shutil

    from ray_tpu_torch.checkpoint import CheckpointPlane
    from ray_tpu_torch.models.training import synthetic_batch

    t = TRAIN
    trainer = _ckpt_trainer(mesh)
    state = trainer.init_state(0)
    batch = synthetic_batch(t["batch"], t["seq"],
                            trainer.config.vocab_size, seed=0)
    nbytes = _state_bytes(state)
    tmp, free = _scratch_dir(int(CKPT["disk_margin"] * 2 * nbytes),
                             "ckpt")
    plane = CheckpointPlane(tmp, run="phase28")
    try:
        state, m1 = trainer.train_step(state, trainer.shard_batch(batch))
        float(m1["loss"])
        h1 = trainer.save_state(plane, state)
        # Step 2 runs while step 1's persist streams out.
        t0 = time.perf_counter()
        state, m2 = trainer.train_step(state, trainer.shard_batch(batch))
        float(m2["loss"])
        step2_ms = (time.perf_counter() - t0) * 1e3
        overlapped = not h1.done()
        h2 = trainer.save_state(plane, state)
        r1, r2 = h1.result(), h2.result()
        if not (r1["committed"] and r2["committed"]) or plane.steps() != [
                1, 2]:
            fail(f"ckpt: saves {r1}, {r2}; committed steps {plane.steps()}")
        restored = {}
        for name, target in (("mesh", trainer), ("one", _ckpt_trainer())):
            t0 = time.perf_counter()
            got = target.restore_state(plane)
            torch.cuda.synchronize()
            restored[name] = (target, got, time.perf_counter() - t0,
                              dict(plane.last_restore))
            _same_state(torch, got, state, f"ckpt restore onto {name}")
        # A third step: the uninterrupted run, then each restored state.
        state, m3 = trainer.train_step(state, trainer.shard_batch(batch))
        want = float(m3["loss"])
        third = {}
        for name, (target, got, _, _) in restored.items():
            _, m = target.train_step(got, target.shard_batch(batch))
            third[name] = float(m["loss"])
        if any(v != want for v in third.values()):
            fail(f"ckpt: step 3 loss {third} from the restored states, "
                 f"{want} uninterrupted")
        restore_s = {n: v[2] for n, v in restored.items()}
        reads = {n: v[3] for n, v in restored.items()}
        restored.clear()
        torch.cuda.empty_cache()
        # Corrupt the newest step's shard: restore falls back to step 1.
        _flip_byte(f"{plane.step_dir(2)}/shard-00000-of-00001.npz")
        fallback = plane.restore()
        if plane.last_restore["step"] != 1 or fallback.step != 1:
            fail(f"ckpt: restore after corrupting step 2 read step "
                 f"{plane.last_restore['step']}, want 1")
        del fallback
        stats = dict(
            layers=trainer.config.num_layers, bytes=r2["bytes"],
            state_bytes=nbytes, free_bytes=free,
            blocked_ms=[h1.blocked_ms, h2.blocked_ms],
            save_s=[r1["save_s"], r2["save_s"]],
            save_gb_s=r2["bytes"] / r2["save_s"] / 1e9,
            save_crc_share=r2["crc_s"] / r2["save_s"],
            step2_ms_during_persist=step2_ms, persist_overlapped=overlapped,
            restore_s=restore_s,
            restore_gb_s={n: r["bytes"] / s / 1e9 for (n, s), r in zip(
                restore_s.items(), reads.values())},
            restore_crc_share={n: r["crc_s"] / restore_s[n]
                               for n, r in reads.items()},
            step3_loss=want, step3_loss_restored=third,
            fallback_step=1, card=card)
        print(f"[ckpt] {json.dumps(stats)}")
        return stats
    finally:
        plane.close()
        shutil.rmtree(tmp, ignore_errors=True)


def mixtral_one_step(torch, cfg, params, opt, opt_state, batch):
    """Phase 24's step on one device: (metrics, grad norm)."""
    from ray_tpu_torch.models import llama, mixtral
    from ray_tpu_torch.models.training import AdamW

    leaves = _param_leaves(params)
    with llama.fp32_reduction(leaves[0].device, cfg.dtype):
        loss, metrics = mixtral.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        norm = AdamW.global_norm(grads)
        opt.apply_(grads, opt_state, params, g_norm=norm)
    return {k: v.detach() for k, v in metrics.items()}, norm


def mesh_moe_case(torch, rank, device, sizes):
    """``[mesh-moe]``: MESH_MOE's tiny fp32 Mixtral on a four-rank mesh
    of ``sizes``, MESH_MOE["steps"] optimizer steps, against one device
    on rank 0: the loss and the grad norm each step within
    MESH_MOE["tol"]; each rank holds X / expert of the experts and
    launches each flash kernel once a layer and step."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.models.training import (default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    m = MESH_MOE
    cfg = mixtral.MixtralConfig.tiny(dtype=torch.float32, **m["config"])

    def opt():
        return default_optimizer(warmup_steps=2, total_steps=50,
                                 learning_rate=1e-2)

    mesh = make_mesh(MeshConfig(**sizes), device_type=device.type)
    params = mixtral_on_mesh(torch, cfg, mesh, 0, device)
    mesh_opt = opt()
    state = mesh_opt.init(params)
    batch = synthetic_batch(m["batch"], m["seq"], cfg.vocab_size, seed=1,
                            device=device)
    placed = mesh_batch(torch, batch, mesh)
    if rank == 0:
        one = mixtral.init_params(cfg, torch.Generator(
            device=device).manual_seed(0), device=device)
        for p in _param_leaves(one):
            p.requires_grad_(True)
        one_opt = opt()
        one_state = one_opt.init(one)
    worst_loss = worst_norm = 0.0
    losses = []
    L = cfg.num_layers
    for _ in range(m["steps"]):
        before = dict(flash_attention.launches)
        metrics, norm = mixtral_mesh_step(torch, cfg, params, mesh_opt,
                                          state, placed, mesh)
        launched = {n: flash_attention.launches[n] - before[n]
                    for n in before}
        if device.type == "cuda" and launched != dict.fromkeys(before, L):
            fail(f"mesh moe {sizes}: launched {launched} a step")
        losses.append(float(metrics["total_loss"]))
        if rank == 0:
            m1, n1 = mixtral_one_step(torch, cfg, one, one_opt, one_state,
                                      batch)
            worst_loss = max(worst_loss, abs(losses[-1] - float(
                m1["total_loss"])) / abs(float(m1["total_loss"])))
            worst_norm = max(worst_norm, abs(float(norm) - float(n1))
                             / abs(float(n1)))
    local = params["layers"]["moe_gate"].to_local().shape[1]
    if local != cfg.num_experts // sizes["expert"]:
        fail(f"mesh moe {sizes}: rank {rank} holds {local} experts of "
             f"{cfg.num_experts}")
    if rank == 0 and (worst_loss > m["tol"] or worst_norm > m["tol"]):
        fail(f"mesh moe {sizes}: loss gap {worst_loss:.3e}, grad norm gap "
             f"{worst_norm:.3e} against one device")
    return dict(mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                total_loss=losses, worst_loss_rel=worst_loss,
                worst_grad_norm_rel=worst_norm, local_experts=local)


def mesh_mixtral(torch, device):
    """``[mesh-mixtral]``: Mixtral-8x7B widths at MESH_MOE["train"]'s
    depth on its four-rank mesh, phase 10's batch, its steps."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.models.training import (default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    t, tm = TRAIN, MESH_MOE["train"]
    cfg = mixtral.MixtralConfig.mixtral_8x7b(num_layers=tm["layers"])
    mesh = make_mesh(MeshConfig(**tm["sizes"]), device_type=device.type)
    params = mixtral_on_mesh(torch, cfg, mesh, 0, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    opt = default_optimizer(warmup_steps=t["warmup"], total_steps=t["total"])
    state = opt.init(params)
    batch = mesh_batch(torch, synthetic_batch(
        t["batch"], t["seq"], cfg.vocab_size, seed=0, device=device), mesh)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ce, step_ms, per_step = [], [], []
    for _ in range(tm["steps"]):
        before = dict(flash_attention.launches)
        t0 = time.perf_counter()
        metrics, _ = mixtral_mesh_step(torch, cfg, params, opt, state,
                                       batch, mesh)
        ce.append(float(metrics["loss"]))          # syncs the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: flash_attention.launches[n] - before[n]
                         for n in before})
    L = cfg.num_layers
    want = {"fwd": 2 * L, "dq": L, "dkv": L}
    if not all(np.isfinite(ce)):
        fail(f"mesh mixtral: cross-entropy {ce}")
    if device.type == "cuda" and any(d != want for d in per_step):
        fail(f"mesh mixtral: launches per step {per_step}, want {want}")
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else None)
    if peak is not None and not peak < tm["peak_gib"]:
        fail(f"mesh mixtral: peak {peak:.2f} GiB, limit {tm['peak_gib']}")
    step_s = float(np.median(step_ms[2:])) / 1e3
    world, tokens = mesh.size(), t["batch"] * t["seq"]
    held = sum(p.to_local().numel() for p in _param_leaves(params))
    stats = dict(
        mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), layers=L,
        batch=[t["batch"], t["seq"]], cross_entropy=ce, step_ms=step_ms,
        step_ms_median_3_on=step_s * 1e3,
        tokens_per_s_per_card=tokens / step_s / world,
        mfu_active_per_card=train_flops(cfg.backbone(), mixtral.active_params(
            cfg), t["batch"], t["seq"]) / step_s / world
        / PEAK_OPS_PER_S["bf16"],
        params_per_card=held, peak_gib_rank0=peak, launches_per_step=want)
    del params, state, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return stats


def _tcp_kv(rank, world):
    """A TCPStore across the ranks (rank 0 hosts it on a free port) as
    the checkpoint plane's KV."""
    import torch.distributed as dist

    from ray_tpu_torch.checkpoint import StoreKV

    port = [None]
    if rank == 0:
        store = dist.TCPStore("localhost", 0, world, True,
                              wait_for_workers=False)
        port = [store.port]
    dist.broadcast_object_list(port, src=0)
    if rank:
        store = dist.TCPStore("localhost", port[0], world, False)
    return StoreKV(store)


def mesh_ckpt(torch, rank, device):
    """``[mesh-ckpt]``: phase 28's model after one step saved at the
    MESH_MOE["ckpt"] save layout (a shard a rank, a TCPStore KV), then
    restored at its restore layout and on one rank (rank 0), every leaf
    equal bit for bit."""
    import shutil

    import torch.distributed as dist

    from ray_tpu_torch.checkpoint import CheckpointPlane
    from ray_tpu_torch.models.training import synthetic_batch
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    c, t = MESH_MOE["ckpt"], TRAIN
    kv = _tcp_kv(rank, dist.get_world_size())
    trainer = _ckpt_trainer(make_mesh(MeshConfig(**c["save"]),
                                      device_type=device.type))
    state = trainer.init_state(0)
    state, _ = trainer.train_step(state, trainer.shard_batch(
        synthetic_batch(t["batch"], t["seq"], trainer.config.vocab_size,
                        seed=0, device=device)))
    nbytes = _state_bytes(state)
    root = [None]
    if rank == 0:
        root = [_scratch_dir(int(CKPT["disk_margin"] * nbytes),
                             "mesh ckpt")[0]]
    dist.broadcast_object_list(root, src=0)
    plane = CheckpointPlane(root[0], run="mesh", kv=kv)
    try:
        h = trainer.save_state(plane, state)
        saved = h.result()
        dist.barrier()
        t0 = time.perf_counter()
        other = _ckpt_trainer(make_mesh(MeshConfig(**c["restore"]),
                                        device_type=device.type))
        got = other.restore_state(plane)
        restore_s = time.perf_counter() - t0
        _same_state(torch, got, state, f"mesh ckpt restore at "
                    f"{c['restore']}")
        local_wq = tuple(got.params["layers"]["wq"].to_local().shape)
        del got
        # The saved state in full on every rank (collectives), then rank 0
        # restores it onto one device.
        full = [t.full_tensor() for t in _state_leaves(state)]
        one_s = None
        if rank == 0:
            t0 = time.perf_counter()
            one = _ckpt_trainer(device=device).restore_state(plane)
            one_s = time.perf_counter() - t0
            mine = _state_leaves(one)
            if not all(a.dtype == b.dtype and torch.equal(a.detach(), b)
                       for a, b in zip(mine, full)):
                fail("mesh ckpt: the one-rank restore differs from the "
                     "saved state")
            del one, mine
        del full
        dist.barrier()
        manifest = plane.manifest(int(state.step))
        return dict(save=c["save"], restore=c["restore"], bytes=nbytes,
                    blocked_ms=h.blocked_ms, save_s=saved["save_s"],
                    shards=len(manifest["shards"]),
                    committed_by=manifest["committed_by"],
                    restore_s=restore_s, restore_one_rank_s=one_s,
                    restored_wq_local=local_wq)
    finally:
        plane.close()
        dist.barrier()
        if rank == 0:
            shutil.rmtree(root[0], ignore_errors=True)


# ------------------------------------- phase 34: the trainer controller
# TorchTrainer.fit over one worker process that owns the card: phase 28's
# model (Llama-3-8B widths at CKPT["layers"] layers, bf16, phase 10's
# optimizer) on phase 10's batch (2 x 2048), fed by DevicePrefetcher and
# driven by AsyncStepLoop(sync_every); one checkpoint-plane save, at
# save_step, joined before the next window's reports; a chaos kill at
# kill_step's report, in the window after the save's, so the save's
# window is reported whole. The steps after the restore give the
# worker's step time three windows without a save.
CONTROLLER = dict(steps=12, sync_every=4, save_step=4, kill_step=8)


def controller_steps(torch, trainer, state, start, plane=None,
                     on_window=None, steps=None):
    """Phase 34's loop, in the worker and (with no ``plane``) in this
    process: steps ``start`` to ``steps`` (CONTROLLER["steps"] by
    default; phase 44 runs 4) on phase 10's batch
    through DevicePrefetcher and AsyncStepLoop. ``on_window(records)``
    gets each synced window's records, one a step: loss, grad norm, the
    window's ms a step, its flash launches a step, and whether a save
    blocked in it. A save's persist is joined before the next window's
    records go out (its wait is the goodput ledger's ckpt_block), so a
    report cites a committed step."""
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.train import (AsyncStepLoop, DevicePrefetcher,
                                     goodput)
    from ray_tpu_torch.train.ingest import synthetic_host_batches

    c, t = CONTROLLER, TRAIN
    host = next(synthetic_host_batches(t["batch"], t["seq"],
                                       trainer.config.vocab_size, steps=1))

    def batches():
        for _ in range(start, steps or c["steps"]):
            yield {k: v.copy() for k, v in host.items()}

    loop = AsyncStepLoop(trainer, state, sync_every=c["sync_every"],
                         name="phase34")
    win = dict(start=start, counts=dict(flash_attention.launches),
               wall=0.0, saves=[], first=True)
    pending = None

    def window():
        nonlocal pending
        n = len(loop.history) - (win["start"] - start)
        if n <= 0:
            return
        if pending is not None:
            t0 = time.perf_counter()
            pending.result()
            goodput.note_ambient("ckpt_block", time.perf_counter() - t0)
            pending = None
        now = dict(flash_attention.launches)
        per = {k: (now[k] - win["counts"][k]) / n for k in now}
        wall = loop.stats()["window_wall_s"]
        ms = (wall - win["wall"]) / n * 1e3
        # The window's saves ride its first record.
        recs = [dict(step=win["start"] + i, loss=h["loss"],
                     grad_norm=h["grad_norm"], step_ms=ms, launches=per,
                     first_window=win["first"], saved=bool(win["saves"]),
                     blocked_ms=win["saves"] if i == 0 else [])
                for i, h in enumerate(loop.history[win["start"] - start:])]
        win.update(start=win["start"] + n, counts=now, wall=wall, saves=[],
                   first=False)
        if on_window is not None:
            on_window(recs)

    with DevicePrefetcher(batches(), trainer, depth=2, name="phase34") as pf:
        step = start
        for batch in pf:
            synced = len(loop.history)
            loop.step(batch)
            step += 1
            if len(loop.history) > synced:
                window()
            if plane is not None and step == c["save_step"]:
                pending = trainer.save_state(plane, loop.state)
                win["saves"].append(pending.blocked_ms)
    loop.finish()
    window()
    return loop.state


def controller_loop(config):
    """Phase 34's train loop, in the worker process TorchTrainer spawned
    (it sees its card as cuda:0): restore the newest committed manifest
    or start from phase 28's init, then report every step; the first
    report of an attempt that restored carries the restore."""
    import torch

    from ray_tpu_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = _ckpt_trainer()
    plane = train.get_checkpoint_plane()
    restored = None
    if plane.latest_step() is not None:
        state = trainer.restore_state(plane)
        torch.cuda.synchronize()
        restored = dict(step=state.step,
                        restore_s=plane.last_restore["seconds"],
                        bytes=plane.last_restore["bytes"])
    else:
        state = trainer.init_state(0)

    def report(recs):
        nonlocal restored
        for r in recs:
            train.report(dict(r, restored=restored))
            restored = None

    controller_steps(torch, trainer, state, state.step, plane, report)


def _restarts(mdefs, cause):
    return sum(v for _n, k, v in mdefs.TRAIN_RESTARTS.samples()
               if ("cause", cause) in k and ("trainer", "TorchTrainer") in k)


def _recovery_sum(mdefs):
    return sum(v for n, k, v in mdefs.TRAIN_RECOVERY_SECONDS.samples()
               if n.endswith("_sum") and ("trainer", "TorchTrainer") in k)


def _median_ms(recs):
    """Median ms a step over the windows after each attempt's first,
    leaving out windows a save blocked in."""
    ok = [r["step_ms"] for r in recs
          if not r["first_window"] and not r["saved"]]
    return float(np.median(ok)) if ok else None


def controller_phase(torch, card):
    """Phase 34: TorchTrainer.fit(ScalingConfig(num_workers=1,
    use_gpu=True)) with one worker on the card, a chaos kill_worker at
    CONTROLLER["kill_step"] and the recovery; held against the same
    loop run in this process."""
    import shutil

    from ray_tpu_torch import train
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch._private import metrics_defs as mdefs
    from ray_tpu_torch.checkpoint import CheckpointPlane
    from ray_tpu_torch.util import tracing

    c = CONTROLLER
    # The uninterrupted loop in this process, no controller.
    trainer = _ckpt_trainer()
    state = trainer.init_state(0)
    nbytes = _state_bytes(state)
    want = []
    controller_steps(torch, trainer, state, 0, None, want.extend)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    L = CKPT["layers"]
    per_step = {"fwd": 2 * L, "dq": L, "dkv": L}
    tmp, free = _scratch_dir(int(CKPT["disk_margin"] * 2 * nbytes),
                             "train-controller")
    restarts0, rec0 = _restarts(mdefs, "worker_lost"), _recovery_sum(mdefs)
    os.environ["RAY_TPU_TRACING"] = "1"
    chaos.configure(f"kill_worker:rank=0,step={c['kill_step']}")
    try:
        ctl = train.TorchTrainer(
            controller_loop, train_loop_config={},
            scaling_config=train.ScalingConfig(num_workers=1,
                                               use_gpu=True),
            run_config=train.RunConfig(name="phase34", storage_path=tmp))
        t0 = time.perf_counter()
        result = ctl.fit()
        fit_s = time.perf_counter() - t0
        fired = [e["action"] for e in chaos.injection_log()]
        committed = CheckpointPlane(os.path.join(result.path, "ckpt_plane"),
                                    run="train").steps()
    finally:
        chaos.reset()
        os.environ.pop("RAY_TPU_TRACING", None)
        shutil.rmtree(tmp, ignore_errors=True)
    if result.error is not None:
        fail(f"train-controller: fit failed: {result.error!r}")
    causes = [r["cause"] for r in ctl.recovery_log]
    if causes != ["worker_lost"] or fired != ["kill_worker"]:
        fail(f"train-controller: recoveries {causes}, chaos {fired}; want "
             f"one worker_lost from the kill")
    recs = [h["metrics"] for h in result.metrics_history]
    marks = [i for i, r in enumerate(recs) if r.get("restored")]
    if len(marks) != 1:
        fail(f"train-controller: {len(marks)} restores reported, want 1")
    restored = recs[marks[0]]["restored"]
    after = recs[marks[0]:]
    newest = max((s for s in committed if s <= c["kill_step"]), default=None)
    if restored["step"] != newest or newest != c["save_step"]:
        fail(f"train-controller: restored step {restored['step']}, newest "
             f"committed before the kill {newest} (committed {committed})")
    got = [r["loss"] for r in after]
    ref = [w["loss"] for w in want[restored["step"]:]]
    if got != ref or [r["step"] for r in after] != list(
            range(restored["step"], c["steps"])):
        fail(f"train-controller: losses from the restored step {got} != "
             f"the uninterrupted loop's {ref}")
    losses = [r["loss"] for r in recs]
    if not all(np.isfinite(losses)) or not ref[-1] < want[0]["loss"] or \
            not losses[-1] < losses[0]:
        fail(f"train-controller: losses {losses} (want finite, falling)")
    if any(r["launches"] != per_step for r in recs + want):
        fail(f"train-controller: flash launches a step "
             f"{[r['launches'] for r in recs]}, want {per_step}")
    if _restarts(mdefs, "worker_lost") != restarts0 + 1:
        fail("train-controller: TRAIN_RESTARTS{cause=worker_lost} did not "
             "rise by 1")
    recovery_s = ctl.recovery_log[0]["recovery_s"]
    spans = tracing.local_spans(trace_id=ctl._trace_id)
    (rec,) = [s for s in spans if s["name"] == "train.recovery"]
    kids = {s["name"].rsplit(".", 1)[1]: s["dur"] for s in spans
            if s.get("parent_span_id") == rec["span_id"]}
    if rec["dur"] != recovery_s or abs(sum(kids.values()) - recovery_s) > \
            1e-6 or abs(_recovery_sum(mdefs) - rec0 - recovery_s) > 1e-6 \
            or not tracing.connected(
                [s for s in spans if s["name"].startswith("train.")],
                root="train.run"):
        fail(f"train-controller: recovery trace {kids} (span "
             f"{rec['dur']}) does not tile TRAIN_RECOVERY_SECONDS' "
             f"{recovery_s}")
    summary = ctl.goodput_summary()
    if abs(sum(summary["fractions"].values()) - 1.0) > 1e-6 or any(
            abs(sum(e["components"].values()) - e["wall_s"]) >
            0.01 * e["wall_s"] for e in ctl.goodput_log):
        fail(f"train-controller: goodput fractions {summary['fractions']} "
             f"do not sum to 1")
    blocked = [ms for r in recs for ms in r["blocked_ms"]]
    launches = {k: sum(r["launches"][k] for r in recs) for k in per_step}
    stats = dict(
        layers=L, steps=c["steps"], state_bytes=nbytes, free_bytes=free,
        step_ms=_median_ms(recs), inprocess_step_ms=_median_ms(want),
        fit_s=fit_s, recovery_s=recovery_s,
        recovery_phases=dict(
            kids, restore=restored["restore_s"],
            first_step=kids["restore_first_step"] - restored["restore_s"]),
        restored_step=restored["step"], restore_bytes=restored["bytes"],
        committed=committed, blocked_ms_per_save=blocked,
        goodput_fractions=summary["fractions"],
        goodput_attempts=[dict(world=e["world"], wall_s=e["wall_s"],
                               components=e["components"])
                          for e in ctl.goodput_log],
        losses=losses, inprocess_losses=[w["loss"] for w in want],
        launches_per_step=per_step, launches=launches, card=card)
    print(f"[train-controller] {json.dumps(stats)}", flush=True)
    return stats


# --mesh-check's train-controller section: TorchTrainer with four NCCL
# workers (a card each) training phase 25's fp32 parity model on fsdp=4,
# a chaos kill_worker whose node is lost (world_target 2) at kill_step,
# the restart on fsdp=2, request_resize(4) at grow_step to grow back;
# against the uninterrupted fsdp=4 run, losses within tol relative (fp32
# sums reduced over 2 and 4 ranks in other orders, carried through the
# optimizer's steps: 1.4e-5 at step 9 in a gloo rehearsal on the CPU).
MESH_CONTROLLER = dict(steps=10, kill_step=3, grow_step=6, stall_s=2.0,
                       tol=1e-4)


def mesh_controller_loop(config):
    """The train-controller section's loop, in each worker: restore the
    newest committed manifest onto fsdp=<world> (or init), then a step,
    a save, a barrier and a report each step; rank 0 asks the grow-back
    resize at grow_step (world 2) and holds that step unsaved."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer,
                                               synthetic_batch)
    from ray_tpu_torch.parallel import DEFAULT_RULES, MeshConfig, make_mesh

    m = MESH_CONTROLLER
    ctx = train.get_context()
    world, rank = ctx.get_world_size(), ctx.get_world_rank()
    device = torch.device(config["device"])
    p = dict(SHARDED_PARITY)
    p.pop("batch")
    seq = p.pop("seq")
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **p)
    mesh = make_mesh(MeshConfig(fsdp=world), device_type=device.type)
    trainer = ShardedTrainer(cfg, mesh, rules=DEFAULT_RULES,
                             optimizer=default_optimizer(
                                 warmup_steps=2, total_steps=50,
                                 learning_rate=1e-2))
    plane = train.get_checkpoint_plane()
    restored = None
    if plane.latest_step() is not None:
        state = trainer.restore_state(plane)
        restored = [world, state.step]
    else:
        state = trainer.init_state(0)
    batch = synthetic_batch(MESH_CHECK["batch"], seq, cfg.vocab_size,
                            seed=1, device=device)
    for step in range(state.step, m["steps"]):
        if rank == 0 and config.get("chaos") and world == 2 and \
                step == m["grow_step"]:
            train.request_resize(4)
            time.sleep(m["stall_s"])
        state, met = trainer.train_step(state, batch)
        trainer.save_state(plane, state).result()
        dist.barrier()
        train.report({"step": step, "loss": float(met["loss"]),
                      "world": world, "restored": restored})
        restored = None


def mesh_train_controller(torch, card, device="cuda"):
    """The train-controller section (``device`` "cpu": gloo workers)."""
    import tempfile

    from ray_tpu_torch import train
    from ray_tpu_torch._private import chaos

    m = MESH_CONTROLLER
    world = MESH_CHECK["world"]
    os.environ.setdefault("RAY_TPU_RESTART_BACKOFF_S", "0.5")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="mesh_controller_") as tmp:
        for name in ("uninterrupted", "chaos"):
            if name == "chaos":
                chaos.configure(f"kill_worker:rank=1,step={m['kill_step']},"
                                f"resize=2")
            try:
                ctl = train.TorchTrainer(
                    mesh_controller_loop,
                    train_loop_config={"device": device,
                                       "chaos": name == "chaos"},
                    scaling_config=train.ScalingConfig(
                        num_workers=world, min_workers=1,
                        use_gpu=device == "cuda"),
                    run_config=train.RunConfig(name=name,
                                               storage_path=tmp))
                result = ctl.fit()
            finally:
                chaos.reset()
            if result.error is not None:
                fail(f"mesh train-controller {name}: {result.error!r}")
            runs[name] = (ctl, [h["metrics"] for h in
                                result.metrics_history])
    ctl, recs = runs["chaos"]
    causes = [r["cause"] for r in ctl.recovery_log]
    restores = [r["restored"] for r in recs if r.get("restored")]
    if causes != ["worker_lost", "resize"] or restores != [
            [2, m["kill_step"] + 1], [4, m["grow_step"]]]:
        fail(f"mesh train-controller: recoveries {causes}, restores "
             f"{restores}; want worker_lost then resize, restored at "
             f"(2, {m['kill_step'] + 1}) and (4, {m['grow_step']})")
    want = {r["step"]: r["loss"] for r in runs["uninterrupted"][1]}
    worst = max(abs(r["loss"] - want[r["step"]]) / abs(want[r["step"]])
                for r in recs)
    if worst > m["tol"] or recs[-1]["world"] != world or \
            recs[-1]["step"] != m["steps"] - 1:
        fail(f"mesh train-controller: loss gap {worst:.3e} against the "
             f"uninterrupted run (tol {m['tol']}), last {recs[-1]}")
    res = dict(recoveries=ctl.recovery_log, restores=restores,
               worlds=sorted({(r["step"], r["world"]) for r in recs}),
               worst_loss_rel=worst,
               recovery_s=[r.get("recovery_s") for r in ctl.recovery_log],
               goodput=ctl.goodput_summary()["fractions"], card=card)
    print(f"[mesh-train-controller] {json.dumps(res, default=str)}",
          flush=True)
    return res



# --mesh-check rllib: updates of IMPALA's learner on two card learners
# (NCCL, a card each) over trajectories of traj = (T, N) from numpy seed
# 37; the two-against-one comparison steps ``SGDImpalaLearner``.
MESH_RLLIB = dict(updates=4, traj=(64, 4), lr=3e-3, rtol=1e-5, atol=1e-6)


class SGDImpalaLearner(ImpalaLearner):
    """``ImpalaLearner`` with a plain gradient step, ``p - lr g``: Adam's
    first step turns a grad near its eps into a visible difference, so
    two learners against one are held on the grads' own step."""

    def apply_gradients(self, grads):
        import torch

        from ray_tpu_torch.rl.weight_sync import _flat

        lr = self.optimizer.learning_rate
        with torch.no_grad():
            for p, (_, g) in zip(self._leaves(), _flat(grads)):
                p.sub_(lr * g)


def mesh_rllib(torch, card, use_gpu=True):
    """The rllib section: two learners of ``ImpalaLearner`` (Adam) stay
    bit for bit the same over ``MESH_RLLIB["updates"]`` updates, and two
    ``SGDImpalaLearner``s' updates equal one's on the whole batch within
    the CPU tests' tolerance (``use_gpu`` False: gloo CPU learners)."""
    from ray_tpu_torch.rl.weight_sync import _flat
    from ray_tpu_torch.rllib import LearnerGroup, PPOModule

    m = MESH_RLLIB
    T, N = m["traj"]
    rng = np.random.default_rng(37)
    batches = [dict(
        obs=rng.normal(size=(T, N, 4)).astype(np.float32),
        actions=rng.integers(0, 2, size=(T, N)),
        behavior_logp=np.log(rng.uniform(0.2, 0.8, (T, N))).astype(
            np.float32),
        rewards=np.ones((T, N), np.float32),
        dones=(rng.random((T, N)) < 0.05).astype(np.float32),
        bootstrap_obs=rng.normal(size=(N, 4)).astype(np.float32))
        for _ in range(m["updates"])]

    def group(cls, n):
        return LearnerGroup(cls, n, use_gpu=use_gpu,
                            builder_args=(PPOModule(4, 2),),
                            builder_kwargs=dict(
                                lr=m["lr"], seed=0,
                                device="cuda" if use_gpu else "cpu"))

    def same(a, b):
        return all(x.tobytes() == y.tobytes() and x.shape == y.shape
                   for (_, x), (_, y) in zip(_flat(a), _flat(b)))

    two = group(ImpalaLearner, 2)
    update_ms = []
    try:
        cards = [w.info.get("cuda_visible_devices") for w in two.learners]
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            two.update(b)
            update_ms.append((time.perf_counter() - t0) * 1e3)
            if not same(*two.get_all_weights()):
                fail(f"mesh rllib: the two learners differ after update "
                     f"{i}")
    finally:
        two.shutdown()
    two, one = group(SGDImpalaLearner, 2), group(SGDImpalaLearner, 1)
    try:
        worst = 0.0
        for b in batches:
            two.update(b)
            one.update(b)
            for (_, x), (_, y) in zip(_flat(two.get_weights()),
                                      _flat(one.get_weights())):
                worst = max(worst, float(np.abs(x - y).max()))
                if not np.allclose(x, y, rtol=m["rtol"], atol=m["atol"]):
                    fail(f"mesh rllib: two learners' step differs from "
                         f"one's by {np.abs(x - y).max():.3e}")
    finally:
        two.shutdown()
        one.shutdown()
    res = dict(cards=cards, updates=m["updates"], bit_identical=True,
               two_vs_one_max_abs=worst, update_ms=update_ms, card=card)
    print(f"[mesh-rllib] {json.dumps(res)}", flush=True)
    return res

# ------------------------------------------------ phase 35: the RL loop
# Llama-3-8B's widths at RL["layers"] of its 32 layers (bf16, random
# weights from seed 0 on the card, the replicas' and the learner's one
# cold start); prompts are phase 5's first RL["prompts"], cut to
# RL["prompt_cap"] tokens.
RL = dict(layers=2, replicas=2, num_slots=8, max_len=1024, rounds=2,
          prompts=8, prompt_cap=512, max_new=32, lr=1e-5, rho_clip=2.0,
          publish_timeout_s=5.0, converge_s=60.0, kill_round=1,
          kill="kill_replica:phase=decode,token=2", greedy_prompts=(8, 9),
          capture_s=1.0, b4_kernels=("paged_split_kernel",
                                     "split_combine_kernel"))
RL_NAME = "rl-llm"
RL_RUN = "chip-rl"


def rl_config():
    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                               num_layers=RL["layers"])


class CountingLearner(TokenPPOLearner):
    """Phase 35's learner: the port's ``TokenPPOLearner`` on the card, its
    params drawn from seed 0 as the replicas' engines draw theirs, whose
    update metrics carry this learner process's counts under ``"smoke"``:
    the flash kernels' launches since it was built, its peak device
    memory since then (every earlier update's optimizer step included),
    its instrumented programs and its profiling-plane gauges. User code:
    the learner process finds it here by name."""

    def __init__(self):
        import torch

        from ray_tpu_torch.ops.attention import flash_attention

        super().__init__(rl_config(), lr=RL["lr"], rho_clip=RL["rho_clip"])
        for k in flash_attention.launches:
            flash_attention.launches[k] = 0
        torch.cuda.reset_peak_memory_stats()

    def compute_gradients(self, batch):
        import torch

        from ray_tpu_torch._private import cuda_monitor
        from ray_tpu_torch.ops.attention import flash_attention
        from ray_tpu_torch.util.metrics import collect_samples

        grads, metrics = super().compute_gradients(batch)
        metrics["smoke"] = dict(
            flash_launches=dict(flash_attention.launches),
            peak_bytes=torch.cuda.max_memory_allocated(),
            programs=cuda_monitor.all_program_stats(),
            gauges=[s for s in collect_samples()
                    if s[0].startswith("ray_tpu_xla_")])
        return grads, metrics


def rl_reward(prompt, tokens):
    """A learnable scalar: the share of tokens in the vocabulary's lower
    half."""
    return float(sum(t < 64128 for t in tokens)) / max(len(tokens), 1)


def rl_grad_flops(cfg, n, s, t):
    """What one PPO gradient step runs, by hand: the layers' matmuls
    forward and backward (2 + 4 FLOPs a param a token; remat "full"
    keeps the products), causal attention's (query, key) pairs at 4 D
    forward, 4 D again in the backward's replay, 6 D for dq and 8 D for
    dk/dv, and the LM head on the T scored rows (2 + 4 FLOPs a weight a
    row)."""
    E, M, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, \
        cfg.vocab_size
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_token = E * H * D + 2 * E * KV * D + H * D * E + 3 * E * M
    pairs = n * H * (s * (s + 1) // 2)
    return (6 * per_token * n * s * L + 22 * D * pairs * L
            + 6 * n * t * E * V)


def rl_routed(n, timeout_s=600):
    """The ``n`` routed replicas of RL_NAME once each answers a health
    probe."""
    from ray_tpu_torch.serve import api as serve_api

    controller = serve_api._get_controller()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        reps = controller.get_replicas(RL_NAME)
        if len(reps) == n and not controller.draining_count(RL_NAME):
            try:
                if all(r.control("health").result(timeout=30)
                       for r in reps):
                    return reps
            except Exception:  # noqa: BLE001 - starting: keep waiting
                pass
        time.sleep(0.1)
    fail(f"phase 35: {n} replicas of {RL_NAME} never came up")


def rl_call(r, method, *args, timeout=600, **kwargs):
    return r.call(method, args, kwargs).result(timeout=timeout)


def rl_phase(torch, card):
    """Phase 35: the RL loop on the card (module docstring)."""
    import atexit
    import shutil

    from ray_tpu_torch import serve
    from ray_tpu_torch._private import chaos, cuda_monitor
    from ray_tpu_torch._private import events as flight
    from ray_tpu_torch._private import metrics_defs as mdefs
    from ray_tpu_torch.checkpoint import CheckpointPlane
    from ray_tpu_torch.llm import HALF_CARD, build_continuous_llama_app
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
    from ray_tpu_torch.rl import RolloutScheduler, WeightPublisher
    from ray_tpu_torch.rllib import LearnerGroup

    gc.collect()
    torch.cuda.empty_cache()
    mem(torch, "phase 35 start")
    cfg = rl_config()
    param_bytes = llama.num_params(cfg) * 2
    capacity = param_bytes + (64 << 20)     # one pickled tree and room
    shm_free = shutil.disk_usage("/dev/shm").free
    print(f"[rl] /dev/shm: {shm_free} bytes free; the weight channel's "
          f"segment needs {capacity}")
    if shm_free < capacity:
        fail(f"phase 35: /dev/shm has {shm_free} bytes free, the weight "
             f"channel needs {capacity}")
    root, disk_free = _scratch_dir(int(RL["rounds"] * param_bytes * 1.2),
                                   "phase 35")
    # Removed at exit too: fail() runs the exit handlers.
    atexit.register(shutil.rmtree, root, True)
    # The replica capture's trace goes under the phase's scratch root and
    # is removed with it.
    session_before = os.environ.get("RAY_TPU_SESSION_DIR")
    os.environ["RAY_TPU_SESSION_DIR"] = root
    all_prompts = [p[:RL["prompt_cap"]] for p in phase5_prompts(cfg)]
    prompts = all_prompts[:RL["prompts"]]
    n = len(prompts)
    built = build_continuous_llama_app(
        cfg, num_replicas=RL["replicas"], num_slots=RL["num_slots"],
        max_len=RL["max_len"])
    # The builder's app, served by the counting subclass, half a card a
    # replica so the two pack onto the one card (C3).
    app = serve.deployment(
        CountingLlm, name=RL_NAME, num_replicas=RL["replicas"],
        ray_actor_options=HALF_CARD).bind(*built.args, **built.kwargs)
    t0 = time.perf_counter()
    handle = serve.run(app)
    reps = rl_routed(RL["replicas"])
    cold_s = time.perf_counter() - t0
    port = serve.start_http(port=0)
    plane = CheckpointPlane(root, run=RL_RUN, process_index=0,
                            process_count=1)
    pub = WeightPublisher(run=RL_RUN, n_subscribers=RL["replicas"],
                          capacity=capacity,
                          publish_timeout_s=RL["publish_timeout_s"],
                          ckpt_plane=plane)
    atexit.register(pub.destroy)           # its /dev/shm segment
    t0 = time.perf_counter()
    learner = LearnerGroup(CountingLearner, num_learners=1)  # on the card
    learner_init_s = time.perf_counter() - t0
    synced = {}
    for i, r in enumerate(reps):
        rl_call(r, "enable_weight_sync", pub.subscriber_spec(i), run=RL_RUN,
                poll_s=0.02)
        synced[r.replica_id] = i
    mem(torch, "phase 35 up")

    def rollout():
        outs, _, wall = stream_all(lambda i: http_tokens(
            port, {"prompt_token_ids": prompts[i],
                   "max_tokens": RL["max_new"]}, name=RL_NAME), n)
        check_outputs(outs, RL["max_new"], cfg.vocab_size, "phase 35")
        return outs, wall

    generated, score_s = {}, []

    def generate(prompt, max_new):
        tokens = generated[tuple(prompt)]
        lp, version, s = handle.score_versioned.remote(
            prompt, tokens).result(timeout_s=600)
        score_s.append(s)
        return tokens, np.asarray(lp, np.float32), version

    def converge(manifest):
        """Every replica at the manifest's version: by the fast path
        (its weight sync read the publish), or by the slow path
        (``restore_weights``: the publish's checkpoint) for a replica
        that has no sync (respawned) or when the publish was shed or
        the fast path missed RL["converge_s"]."""
        version = int(manifest["version"])
        shed = "shed" in manifest
        t0 = time.perf_counter()
        pending = {r.replica_id: r for r in rl_routed(RL["replicas"])}
        paths, timing = {}, {}
        while pending:
            for rid, r in list(pending.items()):
                if rl_call(r, "weight_version") >= version:
                    paths[rid] = "fast"
                    timing[rid] = rl_call(r, "sync_timing")
                    del pending[rid]
            late = time.perf_counter() - t0 > RL["converge_s"]
            for rid, r in list(pending.items()):
                if shed or rid not in synced or late:
                    t1 = time.perf_counter()
                    rl_call(r, "restore_weights", manifest)
                    paths[rid] = "fallback"
                    timing[rid] = dict(rl_call(r, "sync_timing"),
                                       restore_s=time.perf_counter() - t1)
                    del pending[rid]
            if pending:
                time.sleep(0.05)
        return paths, timing, time.perf_counter() - t0

    sched = RolloutScheduler(generate, lambda: pub.version, run=RL_RUN)
    resumes0 = sum(v for _, k, v in mdefs.SERVE_REPLICA_RESUMES.samples()
                   if dict(k).get("deployment") == RL_NAME)
    for r in reps:
        rl_call(r, "counters", True)
    rounds, losses, b4, b1_scoring, kills, recovery = [], [], 0, 0, [], {}
    for rnd in range(RL["rounds"]):
        if rnd == RL["kill_round"]:
            chaos.configure(RL["kill"], seed=11)
        t0 = time.perf_counter()
        outs, wall = rollout()
        rollout_s = time.perf_counter() - t0
        fired = [e for e in chaos.injection_log()
                 if e["action"] == "kill_replica"]
        chaos.configure(None)
        kills += fired
        generated.clear()
        generated.update({tuple(p): o for p, o in zip(prompts, outs)})
        score_s.clear()
        t0 = time.perf_counter()
        admitted = sched.collect(prompts, RL["max_new"], rl_reward,
                                 cause=f"round-{rnd}")
        collect_s = time.perf_counter() - t0
        if admitted != n:
            fail(f"phase 35 round {rnd}: {admitted} of {n} sequences "
                 f"admitted")
        staleness = list(sched.buffer.staleness())
        for r in rl_routed(RL["replicas"]):
            c = rl_call(r, "counters", True)
            b4 += c["paged"]
            b1_scoring += c["flash_fwd"]
        batch = sched.drain_batch()
        t0 = time.perf_counter()
        metrics = sched.learner_phase(lambda b=batch: learner.update(b),
                                      cause=f"round-{rnd}")
        step_s = time.perf_counter() - t0
        if not np.isfinite(metrics["total_loss"]):
            fail(f"phase 35 round {rnd}: loss {metrics['total_loss']}")
        losses.append(metrics["total_loss"])
        t0 = time.perf_counter()
        weights = learner.get_weights()
        get_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        manifest = pub.publish(weights, step=rnd, cause=f"round-{rnd}")
        publish_s = time.perf_counter() - t0
        paths, sync, converge_s = converge(manifest)
        if rnd == 0:
            if "shed" in manifest or set(paths.values()) != {"fast"}:
                fail(f"phase 35 round 0: paths {paths}, shed "
                     f"{manifest.get('shed')}: the fast path must carry "
                     f"version 1 to every replica")
            for r in rl_routed(RL["replicas"]):
                if not rl_call(r, "equals_checkpoint", root, RL_RUN, 1):
                    fail(f"phase 35: {r.replica_id}'s fast-path params "
                         f"differ from version 1's checkpoint")
        if fired and not recovery:
            kill_ts = fired[-1]["ts"]
            recovery = dict(kill_to_version_current_s=time.time() - kill_ts,
                            respawned=[rid for rid in paths
                                       if rid not in synced])
        rec = dict(round=rnd, rollout_s=rollout_s, streams_wall_s=wall,
                   score_s=float(np.sum(score_s)),
                   score_ms_median=float(np.median(score_s)) * 1e3,
                   collect_s=collect_s, learner_step_ms=step_s * 1e3,
                   get_weights_s=get_s, publish_s=publish_s,
                   publish_host_s=pub.last_timing["host_s"],
                   publish_save_s=pub.last_timing["save_s"],
                   publish_write_s=pub.last_timing["write_s"],
                   shed=manifest.get("shed"), paths=paths, sync=sync,
                   converge_s=converge_s, staleness=staleness,
                   loss=metrics["total_loss"],
                   mean_ratio=metrics["mean_ratio"], kills=len(fired))
        rounds.append(rec)
        print(f"[rl-round] {json.dumps(rec)}")

    final = rl_routed(RL["replicas"])
    versions = [rl_call(r, "weight_version") for r in final]
    if versions != [RL["rounds"]] * RL["replicas"]:
        fail(f"phase 35: replica versions {versions}")
    if not kills:
        fail("phase 35: the chaos kill never fired")
    resumes = sum(v for _, k, v in mdefs.SERVE_REPLICA_RESUMES.samples()
                  if dict(k).get("deployment") == RL_NAME) - resumes0
    if resumes < 1:
        fail("phase 35: the kill's streams were not resumed")
    swaps = [e for e in flight.local_events(types=["rl.weight_swap"])
             if e["subject"].get("run") == RL_RUN]
    pub_ids = {e["event_id"] for e in flight.local_events(
        types=["rl.manifest_publish"]) if e["subject"].get("run") == RL_RUN}
    chained = [e for e in swaps if e["cause"] in pub_ids]
    if not chained:
        fail("phase 35: no rl.weight_swap chained to its publish")
    chain = {r["event_id"] for r in flight.causal_chain(
        flight.local_events(limit=100000), [chained[0]["cause"]])}
    if chained[0]["event_id"] not in chain:
        fail("phase 35: causal_chain of a publish misses its swap")
    fallbacks = sum(p == "fallback" for r in rounds
                    for p in r["paths"].values())
    replica_swaps = {}
    for r in final:
        for name, key, value in r.control("samples").result(timeout=60):
            if name == "ray_tpu_rl_weight_swaps_total" and \
                    dict(key).get("run") == RL_RUN:
                cause = dict(key)["cause"]
                replica_swaps[cause] = replica_swaps.get(cause, 0) + value
    stats = metrics["smoke"]      # the learner process's, last round
    learner_launches = stats["flash_launches"]
    if b4 == 0 or b1_scoring == 0 or not all(
            learner_launches[k] > 0 for k in ("fwd", "dq", "dkv")):
        fail(f"phase 35: launches B4 {b4}, B1 scoring {b1_scoring}, "
             f"learner {learner_launches}")

    # After the last round: a greedy request to each replica equals an
    # in-process engine holding the learner's weights.
    greedy = [all_prompts[i] for i in RL["greedy_prompts"]]
    local = ContinuousBatcher(
        cfg, params={k: ({kk: vv.to("cuda") for kk, vv in v.items()}
                         if isinstance(v, dict) else v.to("cuda"))
                     for k, v in weights.items()},
        num_slots=RL["num_slots"], max_len=RL["max_len"])
    want = []
    for p in greedy:
        rid = local.submit(p, max_new_tokens=RL["max_new"])
        want.append(local.run_to_completion()[rid])
    for r in final:
        got = [rl_call(r, "__call__", {"prompt_token_ids": p,
                                        "max_tokens": RL["max_new"]})[
                   "token_ids"] for p in greedy]
        if got != want:
            fail(f"phase 35: {r.replica_id}'s greedy tokens differ from "
                 f"the learner's weights in process")
    serving_peak = torch.cuda.max_memory_allocated()
    sampled = cuda_monitor.sample_device_memory()
    del local
    gc.collect()
    torch.cuda.empty_cache()

    # [monitor]: the programs, the learner's counted FLOPs against the
    # hand count, the gauges against host-clock rates, memory, and a
    # profiler capture of one replica while it decodes.
    programs = cuda_monitor.list_programs()
    for prog in stats["programs"]:
        programs.append(dict(prog, replica="learner"))
    print(f"[monitor] programs {json.dumps([{k: p.get(k) for k in ('name', 'replica', 'compiles', 'retraces', 'signatures', 'compile_seconds', 'flops', 'bytes_accessed')} for p in programs])}")
    grad = next(p for p in stats["programs"] if p["name"] == "rl_ppo_grad")
    s_len = int(batch["tokens_full"].shape[0])
    t_len = int(batch["actions"].shape[0])
    analytic = rl_grad_flops(cfg, n, s_len, t_len)
    gauges = {}
    for name, key, value in stats["gauges"]:
        gauges.setdefault(dict(key).get("program"), {})[name] = value
    step_ms = float(np.median([r["learner_step_ms"] for r in rounds[1:]]))
    replica_gauges = {}
    for r in final:
        for name, key, value in r.control("samples").result(timeout=60):
            if name.startswith("ray_tpu_xla_") and \
                    dict(key).get("program") == "cb_tick":
                replica_gauges.setdefault(r.replica_id, {})[name] = value
    tick_stats = [rl_call(r, "counters") for r in final]
    mon = dict(
        grad_flops_counted=grad.get("flops"), grad_flops_analytic=analytic,
        counted_over_analytic=(grad.get("flops") or 0) / analytic,
        grad_bytes_counted=grad.get("bytes_accessed"),
        batch=dict(n=n, s=s_len, t=t_len),
        learner_gauges=gauges.get("rl_ppo_grad", {}),
        learner_step_ms_host=step_ms,
        host_mfu=analytic / (step_ms / 1e3) / PEAK_OPS_PER_S["bf16"],
        replica_tick_gauges=replica_gauges, card=card)
    print(f"[monitor] {json.dumps(mon)}")
    mems = dict(serving_max_allocated=serving_peak, sampled=sampled,
                learner_peak=stats["peak_bytes"],
                replica_peak_gib=[c["peak_gib"] for c in tick_stats])
    print(f"[monitor] memory {json.dumps(mems)}")
    def decoding(before, timeout_s=120):
        """The first replica whose tick count moves past ``before``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            for r in final:
                if rl_call(r, "counters")["ticks"] >= \
                        before[r.replica_id] + 2:
                    return r.replica_id
            time.sleep(0.05)
        fail("phase 35: no replica decoded the capture's burst")

    # A capture of a replica while it decodes a burst; once more if the
    # trace holds no B4 kernel (the reason printed either way).
    for attempt in range(2):
        before = {r.replica_id: rl_call(r, "counters")["ticks"]
                  for r in final}
        box = {}
        burst = threading.Thread(target=lambda: box.update(res=stream_all(
            lambda i: http_tokens(port, {"prompt_token_ids": prompts[i],
                                         "max_tokens": 4 * RL["max_new"]},
                                  name=RL_NAME), n)))
        burst.start()
        target = decoding(before)
        cap_id = cuda_monitor.request_capture(target,
                                              duration_s=RL["capture_s"])
        deadline = time.monotonic() + 300
        capture = None
        while time.monotonic() < deadline and capture is None:
            done = [e for e in cuda_monitor.list_captures()
                    if e.get("capture_id") == cap_id
                    and e.get("status") in ("done", "failed", "busy")]
            capture = done[0] if done else None
            time.sleep(0.2)
        burst.join(timeout=900)
        if "res" not in box:
            fail("phase 35: a stream of the capture's burst failed")
        if capture is None or capture["status"] != "done":
            fail(f"phase 35: the replica capture came back as {capture}")
        b4_named = {k: v for k, v in capture.get("kernels", {}).items()
                    if any(name in k for name in RL["b4_kernels"])}
        named = all(any(name in k for k in b4_named)
                    for name in RL["b4_kernels"])
        print(f"[monitor] capture {json.dumps(dict(attempt=attempt, replica=target, status=capture['status'], files=capture['files'], trace_dir=capture['trace_dir'], b4=b4_named, kernels=len(capture['kernels']), events=capture.get('events')))}")
        if named:
            break
    else:
        fail(f"phase 35: the captures of {target} name no B4 kernel "
             f"({sorted(capture.get('kernels', {}))[:20]})")

    for r in final:
        rl_call(r, "disable_weight_sync")
    learner.shutdown()
    serve.shutdown()
    pub.destroy()
    plane.close()
    shutil.rmtree(root, ignore_errors=True)
    if session_before is None:
        os.environ.pop("RAY_TPU_SESSION_DIR", None)
    else:
        os.environ["RAY_TPU_SESSION_DIR"] = session_before
    out = dict(
        cold_start_s=cold_s, learner_init_s=learner_init_s,
        versions=versions, losses=losses, kills=len(kills),
        resumes=resumes, recovery=recovery, fallback_swaps=fallbacks,
        replica_swaps=replica_swaps, shed_rounds=[
            r["round"] for r in rounds if r["shed"]],
        payload_bytes=param_bytes, disk_free=disk_free,
        shm_free=shm_free, b4_launches=b4,
        b1_scoring_launches=b1_scoring,
        learner_launches=learner_launches, card=card)
    print(f"[rl] {json.dumps(out)}")
    mem(torch, "phase 35 end")
    return dict(out, rounds=rounds, monitor=mon)



# --------------------------------------------- phase 36: the RL library
# The port does not depend on gymnasium: numpy copies of CartPole-v1 and
# Pendulum-v1 (gymnasium 1.x's dynamics, rewards, ``default_rng`` seeding
# and time limits) and of the JAX tests' two-agent match game. The runner
# processes import this script as their ``__main__`` and find them there
# by name.
class Discrete:
    """A space of ``n`` actions."""

    def __init__(self, n):
        self.n, self.shape, self.dtype = n, (), np.dtype(np.int64)


class Box:
    """A float32 box ``[low, high]``."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)
        self.shape, self.dtype = self.low.shape, np.dtype(np.float32)


class _TimeLimited:
    """Seeding as gymnasium's ``Env.reset`` (a new ``default_rng(seed)``
    when a seed is given) and its ``TimeLimit`` (truncated at the
    ``max_episode_steps``-th step of an episode)."""

    max_episode_steps = 0
    _rng = None

    def _seed(self, seed):
        if seed is not None or self._rng is None:
            self._rng = np.random.default_rng(seed)
        self._steps = 0

    def _tick(self):
        self._steps += 1
        return self._steps >= self.max_episode_steps

    def close(self):
        pass


class CartPole(_TimeLimited):
    """gymnasium's ``CartPole-v1``: Euler steps of cart and pole, reward
    1 a step, terminated past 2.4 m or 12 degrees, truncated at 500."""

    max_episode_steps = 500
    gravity, masscart, masspole, length = 9.8, 1.0, 0.1, 0.5
    force_mag, tau, x_threshold = 10.0, 0.02, 2.4
    theta_threshold_radians = 12 * 2 * np.pi / 360

    def __init__(self):
        self.total_mass = self.masspole + self.masscart
        self.polemass_length = self.masspole * self.length
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Discrete(2)

    def reset(self, *, seed=None, options=None):
        self._seed(seed)
        self.state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold_radians
                          or theta > self.theta_threshold_radians)
        return (np.array(self.state, dtype=np.float32), 1.0, terminated,
                self._tick(), {})


class Pendulum(_TimeLimited):
    """gymnasium's ``Pendulum-v1``: torque clipped to 2, speed to 8,
    reward minus the angle, speed and torque costs, truncated at 200."""

    max_episode_steps = 200
    max_speed, max_torque, dt, g, m, l = 8, 2.0, 0.05, 10.0, 1.0, 1.0

    def __init__(self):
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Box([-self.max_torque], [self.max_torque])

    def reset(self, *, seed=None, options=None):
        self._seed(seed)
        high = np.array([np.pi, 1.0])
        self.state = self._rng.uniform(low=-high, high=high)
        return self._obs(), {}

    def _obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot],
                        dtype=np.float32)

    def step(self, u):
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = (((th + np.pi) % (2 * np.pi)) - np.pi) ** 2 \
            + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th)
                            + 3.0 / (m * l ** 2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        return self._obs(), -costs, False, self._tick(), {}


class MatchGame:
    """The JAX tests' two-agent context-matching game: each agent sees a
    one-hot context and earns 1.0 for picking its index (perfect play 16
    an episode, random play ~1/3 of it)."""

    N_CTX = 3
    EP_LEN = 8
    possible_agents = ["a0", "a1"]

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self._t = 0

    def _obs(self):
        out = {}
        self._ctx = {}
        for aid in self.possible_agents:
            c = int(self._rng.integers(self.N_CTX))
            self._ctx[aid] = c
            vec = np.zeros(self.N_CTX, dtype=np.float32)
            vec[c] = 1.0
            out[aid] = vec
        return out

    def reset(self, *, seed=None):
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        self._t += 1
        rewards = {aid: 1.0 if action_dict[aid] == self._ctx[aid] else 0.0
                   for aid in action_dict}
        done = self._t >= self.EP_LEN
        terms = {aid: done for aid in action_dict}
        terms["__all__"] = done
        return self._obs(), rewards, terms, {"__all__": False}, {}

    def close(self):
        pass


def match_policy(agent_id):
    """MatchGame's policy mapping: agent ``aN`` to policy ``pN``."""
    return "p" + agent_id[-1]


class _OnCard:
    """Mixed into phase 36's learners, which the learner processes find
    here by name: each update's metrics carry whether every param leaf
    lives on the card, whether TF32 matmuls are on, and the learner
    process's peak device memory."""

    def compute_gradients(self, batch):
        import torch

        grads, metrics = super().compute_gradients(batch)
        metrics["params_on_cuda"] = float(all(
            t.is_cuda for t in self._leaves()))
        metrics["tf32"] = float(torch.backends.cuda.matmul.allow_tf32)
        metrics["peak_bytes"] = float(torch.cuda.max_memory_allocated())
        return grads, metrics


class CardImpalaLearner(_OnCard, ImpalaLearner):
    pass


class CardDQNLearner(_OnCard, DQNLearner):
    pass


class CardSACLearner(_OnCard, SACLearner):
    pass


# Phase 36: JAX's test settings and bars (tests/test_rllib.py,
# tests/test_pbt_dqn.py). DQN's bar sits at the edge of what its 40
# iterations give in either package (the JAX package reaches 60.29 at its
# 38th iteration at seed 0 and 52.39 at seed 1): the first of
# ``dqn_seeds`` to reach it passes, and every attempt is printed. The
# parity cases run each learner's step on the card and on the CPU from
# the same params and batch at the main path's batch shapes.
RLLIB = dict(
    ppo=dict(iters=25, bar=120.0, kill_iter=2, runners=4, envs=4, frag=64,
             training=dict(lr=3e-3, num_epochs=6, minibatch_size=256,
                           entropy_coeff=0.01)),
    impala=dict(iters=30, bar=120.0, kill_iter=2, runners=2, envs=4,
                frag=64, training=dict(lr=3e-3, entropy_coeff=0.01,
                                       updates_per_iteration=8)),
    appo=dict(iters=30, bar=120.0, runners=2, envs=4, frag=64,
              training=dict(lr=3e-3, entropy_coeff=0.01,
                            updates_per_iteration=8, clip_param=0.3)),
    dqn=dict(iters=40, bar=60.0, seeds=(0, 1, 2), runners=2, envs=2,
             frag=64, training=dict(lr=1e-3, train_batch_size=128,
                                    num_updates_per_iteration=32,
                                    learning_starts=256,
                                    epsilon_decay_iterations=10,
                                    target_update_freq=50)),
    sac=dict(iters=30, gain=250.0, runners=1, envs=4, frag=64,
             training=dict(lr=1e-3, train_batch_size=128,
                           num_updates_per_iteration=256,
                           learning_starts=256)),
    ma=dict(iters=25, bar=13.0, runners=2, frag=128, hidden=(32,),
            training=dict(rollout_fragment_length=128, lr=5e-3,
                          minibatch_size=64, num_epochs=4)),
    parity=dict(rtol=1e-5, atol=1e-6, seed=36, ppo_rows=256, traj=(64, 4),
                dqn_rows=128, sac_rows=128))


def _timing(obj, name, sink, only=None):
    """Replace ``obj.name`` with a wrapper appending each call's seconds
    to ``sink`` (only of calls whose first argument is ``only``, when
    given)."""
    inner = getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        if only is None or args[0] == only:
            sink.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, timed)


def _median_call_ms(seconds):
    """The median of calls' seconds, in ms."""
    return float(np.median(seconds)) * 1e3 if seconds else None


def rllib_parity(torch):
    """Each learner's step on the card against the same step on the CPU:
    the same params (both drawn from one CPU generator), the same batch;
    loss and every grad leaf within ``RLLIB["parity"]``'s tolerance, then
    the CPU's grads applied on both (Adam's step, SAC's Polyak targets,
    DQN's target copy) and the params held to the same tolerance."""
    from ray_tpu_torch.rllib import core as rc
    from ray_tpu_torch.rl.weight_sync import _flat, _nest

    p = RLLIB["parity"]
    rng = np.random.default_rng(p["seed"])
    f32 = np.float32
    T, N = p["traj"]
    n, m = p["ppo_rows"], p["dqn_rows"]
    traj = dict(obs=rng.normal(size=(T, N, 4)).astype(f32),
                actions=rng.integers(0, 2, size=(T, N)),
                behavior_logp=np.log(rng.uniform(0.2, 0.8, (T, N))).astype(
                    f32),
                rewards=np.ones((T, N), f32),
                dones=(rng.random((T, N)) < 0.05).astype(f32),
                bootstrap_obs=rng.normal(size=(N, 4)).astype(f32))

    def transitions(rows, obs_dim, actions):
        return rc.Transition(
            rng.normal(size=(rows, obs_dim)).astype(f32), actions,
            rng.normal(size=rows).astype(f32),
            rng.normal(size=(rows, obs_dim)).astype(f32),
            (rng.random(rows) < 0.1).astype(f32))

    ppo_mb = dict(obs=rng.normal(size=(n, 4)).astype(f32),
                  actions=rng.integers(0, 2, n),
                  logprobs=np.log(rng.uniform(0.2, 0.8, n)).astype(f32),
                  advantages=rng.normal(size=n).astype(f32),
                  returns=rng.normal(size=n).astype(f32))
    dqn_t = transitions(m, 4, rng.integers(0, 2, m))
    sac_t = transitions(p["sac_rows"], 3, rng.uniform(
        -1, 1, (p["sac_rows"], 1)).astype(f32))
    sac_noise = [rng.normal(size=(p["sac_rows"], 1)).astype(f32)
                 for _ in range(2)]
    pmod, dmod = rc.PPOModule(4, 2), rc.DQNModule(4, 2)
    smod = rc.SACModule(3, 1)
    cases = {
        "ppo": (lambda d: rc.PPOLearner(pmod, lr=3e-3, device=d), ppo_mb),
        "impala": (lambda d: rc.ImpalaLearner(pmod, lr=3e-3, device=d),
                   traj),
        "appo": (lambda d: rc.ImpalaLearner(pmod, lr=3e-3, clip_param=0.3,
                                            device=d), traj),
        "dqn": (lambda d: rc.DQNLearner(dmod, lr=1e-3, target_update_freq=1,
                                        device=d), dqn_t),
        "sac": (lambda d: rc.SACLearner(smod, lr=1e-3, device=d), sac_t),
    }

    def step(learner, batch):
        if isinstance(learner, rc.PPOLearner):
            loss, _, grads = learner._value_and_grad(
                learner._loss, learner._tensors(batch))
            return float(loss), grads
        if isinstance(learner, rc.SACLearner):
            learner._noise = lambda rows, d=learner.device: tuple(
                torch.from_numpy(e).to(d) for e in sac_noise)
        grads, metrics = learner.compute_gradients(batch)
        return metrics.get("total_loss", metrics.get("loss")), grads

    def state(learner):
        trees = [learner.params] + [getattr(learner, "target_params", {})]
        return [t.detach().cpu() for tree in trees for _, t in _flat(tree)]

    out = {}
    for name, (make, batch) in cases.items():
        got, want = make("cuda"), make("cpu")
        loss_g, grads_g = step(got, batch)
        loss_w, grads_w = step(want, batch)
        gerr = max(float((a.cpu() - b).abs().max()) for (_, a), (_, b) in
                   zip(_flat(grads_g), _flat(grads_w)))
        ok = all(torch.allclose(a.cpu(), b, rtol=p["rtol"], atol=p["atol"])
                 for (_, a), (_, b) in zip(_flat(grads_g), _flat(grads_w)))
        if not ok or abs(loss_g - loss_w) > p["atol"] + p["rtol"] * abs(
                loss_w):
            fail(f"phase 36 parity {name}: loss {loss_g} on the card, "
                 f"{loss_w} on the CPU; grads' max abs error {gerr:.3e}")
        got.apply_gradients(_nest([(path, g.to("cuda")) for path, g in
                                   _flat(grads_w)]))
        want.apply_gradients(grads_w)
        perr = max(float((a - b).abs().max()) for a, b in
                   zip(state(got), state(want)))
        if not all(torch.allclose(a, b, rtol=p["rtol"], atol=p["atol"])
                   for a, b in zip(state(got), state(want))):
            fail(f"phase 36 parity {name}: params after the step differ "
                 f"by {perr:.3e} between the card and the CPU")
        if not all(t.is_cuda for t in got._leaves()):
            fail(f"phase 36 parity {name}: a param leaf is off the card")
        out[name] = dict(loss_err=abs(loss_g - loss_w), grad_err=gerr,
                         param_err=perr)
    print(f"[rllib-parity] {json.dumps(out)}")
    return out


def rllib_learn(torch, card, name, build, iters, reached, kill_iter=None,
                steps_per_iter=None, must_reach=True, updates_per_call=1):
    """Build ``build()``'s algorithm, train until ``reached(first, best,
    result)`` or ``iters`` iterations, and return its record: iterations
    to the bar, wall s, env steps/s, the median learner update ms and
    get-weights / broadcast ms, the learner's peak device memory and
    where learners and runners live. ``kill_iter``: SIGKILL runner 0
    before that iteration, which must be replaced. Missing the bar fails
    the phase unless ``must_reach`` is off (the record says)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    algo = build()
    build_s = time.perf_counter() - t0
    timers = {"update": [], "get_weights": [], "broadcast": []}
    group = getattr(algo, "learner_group", None)
    learners = ([algo.learner] if hasattr(algo, "learner") else
                list(getattr(algo, "learners", {}).values())
                if isinstance(getattr(algo, "learners", None), dict) else [])
    sampled = []
    if group is not None:
        _timing(group, "get_weights", timers["get_weights"])
        _timing(group, "update_many" if name in ("dqn", "sac") else
                "update", timers["update"])
        if steps_per_iter is None:
            # IMPALA's: one update a trajectory of T x N env steps.
            update = group.update
            group.update = lambda traj: (sampled.append(
                traj["actions"].size), update(traj))[1]
    for ln in learners:
        _timing(ln, "get_weights", timers["get_weights"])
        _timing(ln, "update_from_batch", timers["update"])
    if hasattr(algo, "runner_group"):
        _timing(algo.runner_group, "sync_weights", timers["broadcast"])
        runners = lambda: algo.runner_group.runners  # noqa: E731
    elif hasattr(algo.runners, "actors"):
        _timing(algo.runners, "foreach", timers["broadcast"],
                only="set_weights")
        runners = lambda: algo.runners.actors  # noqa: E731
    else:
        runners = lambda: algo.runners  # noqa: E731
    first, best, result, steps, killed = None, -np.inf, {}, 0, None
    got = False
    t1 = time.perf_counter()
    try:
        for i in range(iters):
            if kill_iter is not None and i == kill_iter:
                killed = runners()[0].pid
                runners()[0].kill()
            result = algo.train()
            steps += (result.get("num_env_steps_sampled")
                      or steps_per_iter or 0)
            r = result["episode_return_mean"]
            if np.isfinite(r):
                first = r if first is None else first
                best = max(best, r)
            if reached(first, best, result):
                got = True
                break
        if must_reach and not got:
            fail(f"phase 36 {name}: no bar within {iters} iterations "
                 f"(first {first}, best {best})")
        wall = time.perf_counter() - t1
        steps += sum(sampled)
        procs = runners()
        if any(r.info.get("cuda_visible_devices") != "" for r in procs):
            fail(f"phase 36 {name}: a runner sees a card: "
                 f"{[r.info for r in procs]}")
        if killed is not None and (killed in [r.pid for r in procs]
                                   or len(procs) != len(set(
                                       r.pid for r in procs))):
            fail(f"phase 36 {name}: runner {killed} was not replaced")
        if group is not None:
            on_card = (result.get("params_on_cuda") == 1.0
                       and result.get("tf32") == 0.0
                       and all(w.info.get("cuda_visible_devices")
                               for w in group.learners))
            peak = result.get("peak_bytes")
        else:
            on_card = all(ln.device.type == "cuda" and all(
                t.is_cuda for t in ln._leaves()) for ln in learners)
            peak = float(torch.cuda.max_memory_allocated())
        if not on_card:
            fail(f"phase 36 {name}: the learners' params are not all on "
                 f"the card with TF32 off ({result})")
    finally:
        algo.stop()
    rec = dict(reached=got, iterations=i + 1, first=first, best=best,
               build_s=build_s,
               wall_s=wall, env_steps=steps, env_steps_per_s=steps / wall,
               update_ms=_median_call_ms(timers["update"]),
               updates=len(timers["update"]),
               updates_per_call=updates_per_call,
               get_weights_ms=_median_call_ms(timers["get_weights"]),
               get_weights_calls=len(timers["get_weights"]),
               broadcast_ms=_median_call_ms(timers["broadcast"]),
               learner_peak_mib=(peak or 0.0) / 2**20,
               replacements=result.get("num_runner_replacements"),
               killed_runner=killed, card=card)
    print(f"[rllib] {name}: {json.dumps(rec)}", flush=True)
    return rec


def rllib_phase(torch, card):
    """Phase 36: the RL library on the card (learners) and CPU processes
    (runners): each learner's card step against its CPU step, then PPO,
    IMPALA, APPO, DQN, SAC and multi-agent PPO to JAX's bars."""
    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import dqn, impala, sac

    segments = set(shm_segments())
    parity = rllib_parity(torch)
    c = RLLIB
    saved = (impala.ImpalaLearner, dqn.DQNLearner, sac.SACLearner)
    impala.ImpalaLearner, dqn.DQNLearner, sac.SACLearner = (
        CardImpalaLearner, CardDQNLearner, CardSACLearner)
    out = dict(parity=parity)
    try:
        def bar(v):
            return lambda first, best, r: best >= v

        def discrete(cfg, k):
            return (cfg.environment(env_creator=CartPole)
                    .env_runners(num_env_runners=c[k]["runners"],
                                 num_envs_per_env_runner=c[k]["envs"],
                                 rollout_fragment_length=c[k]["frag"])
                    .training(**c[k]["training"]))

        out["ppo"] = rllib_learn(
            torch, card, "ppo",
            lambda: discrete(rllib.PPOConfig(), "ppo").build(),
            c["ppo"]["iters"], bar(c["ppo"]["bar"]), c["ppo"]["kill_iter"])
        for k, cfg in (("impala", rllib.IMPALAConfig),
                       ("appo", rllib.APPOConfig)):
            out[k] = rllib_learn(
                torch, card, k, lambda cfg=cfg, k=k: discrete(
                    cfg(), k).build(),
                c[k]["iters"], bar(c[k]["bar"]), c[k].get("kill_iter"))
        d, attempts = c["dqn"], []
        for seed in d["seeds"]:
            rec = rllib_learn(
                torch, card, "dqn", lambda seed=seed: discrete(
                    rllib.DQNConfig(), "dqn").training(seed=seed).build(),
                d["iters"], bar(d["bar"]),
                steps_per_iter=d["runners"] * d["envs"] * d["frag"],
                must_reach=False, updates_per_call=d["training"][
                    "num_updates_per_iteration"])
            attempts.append(dict(seed=seed, **rec))
            if rec["reached"]:
                break
        else:
            fail(f"phase 36 dqn: no seed of {d['seeds']} reached "
                 f"{d['bar']} within {d['iters']} iterations")
        out["dqn"] = attempts
        s = c["sac"]
        out["sac"] = rllib_learn(
            torch, card, "sac",
            lambda: rllib.SACConfig().environment(env_creator=Pendulum)
            .env_runners(num_env_runners=s["runners"],
                         num_envs_per_env_runner=s["envs"],
                         rollout_fragment_length=s["frag"])
            .training(**s["training"]).build(),
            s["iters"], lambda first, best, r: first is not None
            and best >= first + s["gain"],
            steps_per_iter=s["runners"] * s["envs"] * s["frag"],
            updates_per_call=s["training"]["num_updates_per_iteration"])
        ma = c["ma"]
        spec = {"obs_dim": MatchGame.N_CTX, "num_actions": MatchGame.N_CTX,
                "hidden": ma["hidden"]}
        out["ma"] = rllib_learn(
            torch, card, "ma",
            lambda: rllib.MultiAgentPPOConfig()
            .environment(env_creator=MatchGame)
            .multi_agent(policies={"p0": spec, "p1": spec},
                         policy_mapping_fn=match_policy)
            .env_runners(ma["runners"]).training(**ma["training"]).build(),
            ma["iters"], lambda first, best, r: (
                r["episode_return_mean"] >= ma["bar"]
                and any(k.startswith("learner/p0/") for k in r)
                and any(k.startswith("learner/p1/") for k in r)))
    finally:
        impala.ImpalaLearner, dqn.DQNLearner, sac.SACLearner = saved
    left = sorted(set(shm_segments()) - segments)
    if left:
        fail(f"phase 36: shm segments left behind: {left}")
    print(f"[rllib-done] no shm segment left; {card}")
    return out


def build_report(log):
    """``nvcc -Xptxas -v`` output by kernel family (the kernel's name
    without its template arguments): (registers, spill store bytes) of
    each instantiation."""
    out, family = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            # The mangled name's identifier that ends in "kernel" (or
            # "kernel_sm90"): the one its decimal length prefix fits.
            name, family = m.group(1), m.group(1)
            for k in re.finditer(r"kernel(?:_sm90)?(?=[IE])", name):
                end = k.end()
                family = next((name[end - n:end] for n in range(1, end)
                               if name[:end - n].endswith(str(n))), family)
            out.setdefault(family, ([], []))
        elif family and "spill stores" in line:
            out[family][1].append(int(re.search(
                r"(\d+) bytes spill stores", line).group(1)))
        elif family and "Used" in line and "registers" in line:
            out[family][0].append(int(re.search(
                r"Used (\d+) registers", line).group(1)))
    return out


# ------------------------------------------------- phases 29-31: serving
SERVE_NAME = "llm"
# Phase 29's LlamaDeployment: its layers at Llama-3-8B's widths, the
# concurrent calls and their new tokens.
DEPLOY_BATCH = dict(layers=2, calls=6, max_tokens=8)
# Phase 30: the streams of the drain's burst, and the tokens a stream has
# delivered when its replica is killed (phase 31 kills at half its 16).
RUNTIME = dict(burst=8, kill_after=8)


class CountingLlm(ContinuousLlamaDeployment._cls_or_fn):
    """Phases 30-31's deployment: the port's ``ContinuousLlamaDeployment``
    with its random weights drawn from ``seed`` (0: the engine's own draw,
    phase 5's weights; 1: phase 6's) and two methods this process calls in
    the replica process: the decode kernels' launch counts with the
    engine's counters, and ``top2_margin`` under the replica's weights.
    User code: the replica process finds it here by name."""

    def __init__(self, config, seed=0, **engine):
        import torch

        from ray_tpu_torch.models import llama

        params = None
        if seed:
            params = llama.init_params(
                config, torch.Generator(device="cuda").manual_seed(seed),
                device="cuda")
        super().__init__(config=config, params=params, **engine)
        self.marks = []
        self.handoffs = []        # phase 32: each import's size
        self.tick_s = 0.0         # seconds inside steps that ticked
        inner = self.batcher.step

        def step():
            t, n = time.perf_counter(), self.batcher.base_tick_count
            out = inner()
            if self.batcher.base_tick_count > n:
                self.tick_s += time.perf_counter() - t
            return out

        self.batcher.step = step

    def decode_from(self, request):
        """The port's ``decode_from``, recording the handoff's size."""
        m = request["manifest"]
        self.handoffs.append(dict(prompt_tokens=len(m["prompt"]),
                                  mib=m["nbytes"] / 2**20,
                                  blocks=m["num_blocks"]))
        yield from super().decode_from(request)

    def generate(self, prompt_token_ids, max_tokens=16):
        """The port's ``generate``, timing each request from its entry
        into user code in the replica to its first token."""
        entry = time.perf_counter()
        for i, token in enumerate(super().generate(prompt_token_ids,
                                                   max_tokens)):
            if i == 0:
                self.marks.append((entry, time.perf_counter()))
            yield token

    def counters(self, reset=False):
        """Launch counts and engine counters; since the last reset, the
        requests' (entry, first token) marks and engine records, the
        imports' sizes and this process's peak device memory."""
        import torch

        from ray_tpu_torch.ops.attention import flash_attention
        from ray_tpu_torch.ops.decode_attention import decode_attention
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        with self._lock:
            out = dict(paged=paged_decode_attention.launches,
                       dense=decode_attention.launches,
                       flash_fwd=flash_attention.launches["fwd"],
                       ticks=self.batcher.base_tick_count,
                       tick_s=self.tick_s,
                       prefill_s=self.batcher.prefill_seconds,
                       decoded=self.batcher.decoded_tokens,
                       marks=list(self.marks),
                       records=list(self.batcher.request_breakdowns),
                       handoffs=list(self.handoffs),
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            if reset:
                paged_decode_attention.launches = 0
                decode_attention.launches = 0
                flash_attention.launches["fwd"] = 0
                self.marks = []
                self.handoffs = []
                torch.cuda.reset_peak_memory_stats()
                self.batcher.request_breakdowns.clear()
        return out

    def margin(self, seq):
        import torch

        with self._lock:
            return top2_margin(torch, self.batcher.params, self.config,
                               list(seq))

    def set_tracing(self, on):
        """Request tracing on or off in this replica process (phase 33
        times both in one replica)."""
        os.environ["RAY_TPU_TRACING"] = "1" if on else "0"
        return bool(on)

    def score_versioned(self, prompt, tokens):
        """Phase 35's behavior logprobs and the version that scored them,
        under one hold of the engine lock (a swap cannot land between
        them), and the seconds the scoring took."""
        with self._lock:
            t0 = time.perf_counter()
            lp = self.batcher.score_logprobs(list(prompt), list(tokens))
            return ([float(x) for x in lp], self.batcher.weight_version,
                    time.perf_counter() - t0)

    def equals_checkpoint(self, root, run, version):
        """Whether the live params equal, bit for bit, ``version``'s
        checkpoint under ``root``/``run`` (restored here, compared on the
        card as raw bytes)."""
        import torch

        from ray_tpu_torch.checkpoint import load_latest
        from ray_tpu_torch.rl.weight_sync import _flat

        cold = dict(_flat(load_latest(root, run=run, step=int(version))))
        with self._lock:
            live = dict(_flat(self.batcher.params))
            if live.keys() != cold.keys():
                return False
            for path, t in live.items():
                c = cold[path].to(t.device)
                if c.dtype != t.dtype or c.shape != t.shape or not bool(
                        torch.equal(c.view(torch.uint8),
                                    t.view(torch.uint8))):
                    return False
        return True


def breakdown(records, n):
    """Medians over the engine's last ``n`` request records: its time to
    first token from the submit and the queue share of it."""
    recs = [r for r in list(records)[-n:] if r.get("ttft_s") is not None]
    return dict(engine_ttft_p50_ms=float(np.median(
        [r["ttft_s"] for r in recs])) * 1e3,
        engine_queue_p50_ms=float(np.median(
            [r["queue_s"] for r in recs])) * 1e3)


def mem(torch, tag):
    free, total = torch.cuda.mem_get_info()
    print(f"[mem] {tag}: {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
          f"free")
    return free


def stream_all(start, n):
    """``start(i)`` (an iterable of tokens) for each i < n on a thread of
    its own, all released together: (tokens by request, seconds from the
    release to each first token, wall seconds)."""
    outs, first, errors = [None] * n, [None] * n, []
    barrier = threading.Barrier(n + 1)

    def run(i):
        barrier.wait()
        try:
            toks = []
            for t in start(i):
                if first[i] is None:
                    first[i] = time.perf_counter()
                toks.append(t)
            outs[i] = toks
        except Exception as e:  # noqa: BLE001 — failed below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"streams failed: {errors or 'a stream hung'}")
    return outs, [None if f is None else f - t0 for f in first], wall


def http_tokens(port, payload, timeout=600, name=SERVE_NAME, headers=None):
    """The token ids of one NDJSON stream from the HTTP ingress, as they
    arrive."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", f"/{name}/stream/generate",
                     body=json.dumps(payload),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {resp.read()[:300]}")
        while True:
            line = resp.readline()
            if not line:
                return
            item = json.loads(line)
            if not isinstance(item, int):
                raise RuntimeError(f"a greedy stream sent {item!r}")
            yield item
    finally:
        conn.close()


def wait_routed(timeout_s=600, name=SERVE_NAME):
    """The routed replica of ``name`` once one is up and no drain is in
    flight."""
    from ray_tpu_torch.serve import api as serve_api

    controller = serve_api._get_controller()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        reps = controller.get_replicas(name)
        if reps and not controller.draining_count(name):
            return reps[0]
        time.sleep(0.1)
    fail(f"no replica of {name} came up within {timeout_s} s")


def served_stats(outs, ttft, wall, ticks, launches, prefill_s, decoded,
                 num_layers, vocab, what):
    """The gates of a served burst (every stream 32 in-vocab tokens,
    num_layers paged launches a tick and no dense one) and its numbers."""
    check_outputs(outs, 32, vocab, what)
    if launches != {"paged": num_layers * ticks, "dense": 0}:
        fail(f"{what}: launches {launches} for {ticks} ticks x "
             f"{num_layers} layers")
    decode_s = wall - prefill_s
    return dict(requests=len(outs), ticks=ticks, launches=launches,
                wall_s=wall, ttft_p50_ms=float(np.median(ttft)) * 1e3,
                client_tok_s=sum(map(len, outs)) / wall,
                tick_ms=decode_s / max(ticks, 1) * 1e3,
                decode_tok_s=decoded / decode_s, prefill_s=prefill_s)


def served_burst(cfg, prompts, generate, counters, what):
    """Phase 29's burst: a warm-up request (as ``serve()`` does), then
    ``prompts`` as concurrent 32-token streams of ``generate(prompt, n)``
    (an iterable of tokens), the launch counts set to 0 just before.
    ``counters()`` reads the engine's (ticks, prefill seconds, decoded
    tokens). Returns the tokens and :func:`served_stats`."""
    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention

    list(generate(prompts[0][:16], 2))
    ticks0, pre0, dec0 = counters()
    reset_launch_counts()
    outs, ttft, wall = stream_all(lambda i: generate(prompts[i], 32),
                                  len(prompts))
    launches = {"paged": paged_decode_attention.launches,
                "dense": decode_attention.launches}
    ticks1, pre1, dec1 = counters()
    return outs, served_stats(outs, ttft, wall, ticks1 - ticks0, launches,
                              pre1 - pre0, dec1 - dec0, cfg.num_layers,
                              cfg.vocab_size, what)


def deploy_phase(torch, card, served):
    """Phase 29: the deployments in process (module docstring)."""
    from ray_tpu_torch.llm import LlamaDeployment
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.attention import flash_attention

    mem(torch, "phase 29 start")
    prompts, phase5 = served
    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    dep = ContinuousLlamaDeployment._cls_or_fn(config=cfg, num_slots=8,
                                               max_len=2048)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = dep.batcher
    outs, st = served_burst(
        cfg, prompts, dep.generate,
        lambda: (eng.base_tick_count, eng.prefill_seconds,
                 eng.decoded_tokens), "phase 29")
    st.update(init_s=init_s, agree_with_phase5=sum(
        a == b for a, b in zip(outs, phase5)), partings=partings(
        torch, eng.params, cfg, prompts, outs, phase5, "phase 29",
        against="phase-5"), card=card)
    launched = []
    for i in SCORE_REQUESTS:
        before = flash_attention.launches["fwd"]
        lp = np.asarray(dep.score_logprobs(prompts[i], outs[i]))
        launched.append(flash_attention.launches["fwd"] - before)
        if launched[-1] != cfg.num_layers or lp.shape != (32,) or not (
                np.all(np.isfinite(lp)) and np.all(lp <= 0)):
            fail(f"phase 29 scoring of request {i}: {launched[-1]} flash "
                 f"forward launches, logprobs {lp[:4]}...")
    st["scoring_launches"] = sum(launched)
    st.update(breakdown(eng.request_breakdowns, len(prompts)))
    print(f"[deploy] {json.dumps(st)}")
    st["outputs"] = outs
    dep.close()
    del dep, eng
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=DEPLOY_BATCH["layers"])
    ld = LlamaDeployment._cls_or_fn(config=small, max_len=2048)
    sizes = []
    inner = ld.generator.generate

    def recording(batch, **kw):
        sizes.append(len(batch))
        return inner(batch, **kw)

    ld.generator.generate = recording
    n, new = DEPLOY_BATCH["calls"], DEPLOY_BATCH["max_tokens"]
    outs2, _, wall2 = stream_all(lambda i: ld(
        {"prompt_token_ids": prompts[i], "max_tokens": new})["token_ids"], n)
    check_outputs(outs2, new, cfg.vocab_size, "phase 29 LlamaDeployment")
    if sum(sizes) != n or max(sizes) > 8:
        fail(f"phase 29 LlamaDeployment: batches {sizes} for {n} calls")
    print(f"[deploy-batch] {json.dumps(dict(calls=n, batch_sizes=sizes, wall_s=wall2, layers=small.num_layers, card=card))}")
    del ld, inner, recording
    gc.collect()                  # the recording wrapper closes a cycle
    torch.cuda.empty_cache()
    mem(torch, "phase 29 end")
    return st


def runtime_phase(torch, card, served, deploy):
    """Phase 30: the serve runtime on the card (module docstring)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_continuous_llama_app
    from ray_tpu_torch.models import llama

    mem(torch, "phase 30 start")
    prompts, phase5 = served
    cfg = llama.LlamaConfig.llama3_8b()
    # The builder's app (its card request and engine knobs), served by the
    # counting subclass so the replica's launches can be read.
    built = build_continuous_llama_app(cfg, num_slots=8, max_len=2048)
    app = serve.deployment(
        CountingLlm, name=SERVE_NAME,
        ray_actor_options=built.deployment.ray_actor_options).bind(
        *built.args, **built.kwargs)
    t0 = time.perf_counter()
    handle = serve.run(app)
    cold_s = time.perf_counter() - t0
    replica = wait_routed()
    mem(torch, "phase 30 replica up")
    port = serve.start_http(port=0)
    list(http_tokens(port, {"prompt_token_ids": prompts[0][:16],
                            "max_tokens": 2}))           # warm-up
    c0 = handle.counters.remote(True).result(timeout_s=120)
    outs, ttft, wall = stream_all(lambda i: http_tokens(
        port, {"prompt_token_ids": prompts[i], "max_tokens": 32}),
        len(prompts))
    c1 = handle.counters.remote().result(timeout_s=120)

    def margin(seq):
        return handle.margin.remote(seq).result(timeout_s=300)

    st = served_stats(outs, ttft, wall, c1["ticks"] - c0["ticks"],
                      {"paged": c1["paged"], "dense": c1["dense"]},
                      c1["prefill_s"] - c0["prefill_s"],
                      c1["decoded"] - c0["decoded"], cfg.num_layers,
                      cfg.vocab_size, "phase 30")
    marks = np.array(c1["marks"])
    st.update(breakdown(c1["records"], len(prompts)),
              replica_entry_spread_ms=float(np.ptp(marks[:, 0])) * 1e3,
              replica_ttft_p50_ms=float(np.median(
                  marks[:, 1] - marks[:, 0])) * 1e3)
    st.update(cold_start_s=cold_s, replica_init_s=replica.info["init_s"],
              agree_with_phase5=sum(a == b for a, b in zip(outs, phase5)),
              agree_with_phase29=sum(
                  a == b for a, b in zip(outs, deploy["outputs"])),
              partings=partings(torch, None, cfg, prompts, outs, phase5,
                                "phase 30", against="phase-5",
                                margin=margin),
              phase29={k: deploy[k] for k in (
                  "ttft_p50_ms", "client_tok_s", "tick_ms",
                  "decode_tok_s")}, card=card)
    print(f"[runtime] {json.dumps(st)}")

    # serve.drain during a burst: every stream admitted, then the drain.
    burst = RUNTIME["burst"]
    admitted = [threading.Event() for _ in range(burst)]

    def start(i):
        for t in http_tokens(port, {"prompt_token_ids": prompts[i],
                                    "max_tokens": 32}):
            admitted[i].set()
            yield t

    box = {}
    th = threading.Thread(target=lambda: box.update(
        res=stream_all(start, burst)))
    th.start()
    if not all(e.wait(timeout=300) for e in admitted):
        fail("phase 30: the drain's burst never started streaming")
    t_drain = time.perf_counter()
    if serve.drain(SERVE_NAME, 1) != 1:
        fail("phase 30: serve.drain started no drain")
    th.join(timeout=900)
    if "res" not in box:
        fail("phase 30: a stream of the drain's burst failed")
    check_outputs(box["res"][0], 32, cfg.vocab_size, "phase 30 drain")
    replica = wait_routed()
    drain = dict(streams=burst, dropped=0,
                 replacement_up_s=time.perf_counter() - t_drain,
                 replacement_init_s=replica.info["init_s"], card=card)
    print(f"[runtime-drain] {json.dumps(drain)}")

    # SIGKILL the replica after a greedy stream delivered kill_after tokens.
    k = RUNTIME["kill_after"]
    toks, times, t_kill = [], [], None
    for t in http_tokens(port, {"prompt_token_ids": prompts[1],
                                "max_tokens": 32}):
        toks.append(t)
        times.append(time.perf_counter())
        if len(toks) == k:
            os.kill(replica.pid, signal.SIGKILL)
            t_kill = time.perf_counter()
    check_outputs([toks], 32, cfg.vocab_size, "phase 30 kill")
    wait_routed()
    gaps = np.diff(times[k - 1:])
    kill = dict(killed_after=k, next_token_after_kill_s=times[k] - t_kill,
                longest_gap_after_kill_s=float(gaps.max()),
                agree_with_uninterrupted=toks == outs[1],
                partings=partings(torch, None, cfg, prompts[1:2], [toks],
                                  outs[1:2], "phase 30 killed",
                                  against="uninterrupted", margin=margin),
                card=card)
    print(f"[runtime-kill] {json.dumps(kill)}")
    serve.shutdown()
    mem(torch, "phase 30 end")
    st.update(drain=drain, kill=kill)
    return st


def runtime_parity(torch, card, parity):
    """Phase 31: phase 6's 2-layer fp32 model in a replica on the card,
    over HTTP, against phase 6's in-process paged engine (module
    docstring)."""
    from ray_tpu_torch import serve

    mem(torch, "phase 31 start")
    cfg, prompts, want = parity
    new = len(want[0])
    handle = serve.run(serve.deployment(
        CountingLlm, name=SERVE_NAME, ray_actor_options={"num_gpus": 1})
        .bind(config=cfg, seed=1, num_slots=8, max_len=2048))
    replica = wait_routed()
    port = serve.start_http(port=0)

    def margin(seq):
        return handle.margin.remote(seq).result(timeout_s=300)

    got = [list(http_tokens(port, {"prompt_token_ids": p,
                                   "max_tokens": new})) for p in prompts]
    check_agree(torch, None, cfg, prompts, got, want,
                "a replica over HTTP and phase 6's in-process engine",
                margin=margin)
    toks = []
    for t in http_tokens(port, {"prompt_token_ids": prompts[-1],
                                "max_tokens": new}):
        toks.append(t)
        if len(toks) == new // 2:
            os.kill(replica.pid, signal.SIGKILL)
    check_agree(torch, None, cfg, prompts[-1:], [toks], want[-1:],
                "a replica killed mid-decode and phase 6's engine",
                margin=margin)
    st = dict(requests=len(prompts), tokens=new, identical=got == want,
              killed_identical=toks == want[-1], card=card)
    print(f"[runtime-parity] {json.dumps(st)}")
    serve.shutdown()
    mem(torch, "phase 31 end")
    return st


# ------------------------------------------ phase 32: the split, served
# The role group's name; the chaos requests' prompt: phase 5's request 0
# cut to chaos_tokens (under one 64-token block, so no prefix cache holds
# any of it and every run of it prefills alike); the fp32 pair's kill.
DISAGG = dict(name="dllm", chaos_tokens=48, parity_kill="import")


def shm_segments():
    """The port's shm segments on this host: the channels'
    (``/dev/shm/rtch-*``) and the object stores' (``rtst-*``)."""
    return sorted(n for n in os.listdir("/dev/shm")
                  if n.startswith(("rtch-", "rtst-")))


def deploy_group(cfg, **engine):
    """``deploy_disagg_llama`` (its builders' half-card requests, its two
    ``serve.run`` calls and its role group) with the deployment class
    swapped for ``CountingLlm``. Returns (group, seconds to deploy)."""
    from ray_tpu_torch import llm as tllm
    from ray_tpu_torch import serve

    real = tllm.ContinuousLlamaDeployment
    tllm.ContinuousLlamaDeployment = serve.deployment(
        CountingLlm, name="ContinuousLlamaDeployment")
    try:
        t0 = time.perf_counter()
        group = tllm.deploy_disagg_llama(DISAGG["name"], config=cfg,
                                         **engine)
        cold = time.perf_counter() - t0
    finally:
        tllm.ContinuousLlamaDeployment = real
    for role in ("prefill", "decode"):
        wait_routed(name=group[role])
    return group, cold


def role_counters(group, reset=False):
    from ray_tpu_torch import serve

    return {role: serve.get_deployment_handle(group[role]).counters
            .remote(reset).result(timeout_s=120)
            for role in ("prefill", "decode")}


def chaos_stream(payload, spec, seed):
    """One stream to the role group through the ingress's router under a
    chaos plan: (tokens, journal, seconds from the firing to the first
    token after it, the event types of the causal chain the firing's
    ``event_id`` roots). Fails unless that chain reaches the
    ``serve.resume`` the firing caused."""
    from ray_tpu_torch._private import chaos, events
    from ray_tpu_torch.serve import api as serve_api

    chaos.configure(spec, seed=seed)
    try:
        s = serve_api._router().stream(DISAGG["name"], "generate", payload)
        s._timeout = 600.0
        toks, times = [], []
        for t in s:
            toks.append(t)
            times.append(time.time())
        fired = [e for e in chaos.injection_log()
                 if e["action"] == "kill_transfer"]
    finally:
        chaos.configure(None)
    if len(fired) != 1:
        fail(f"phase 32 {spec}: {len(fired)} firings (want 1)")
    eid = fired[0]["event_id"]
    chain = events.causal_chain(events.local_events(limit=1 << 20), [eid])
    if not any(r["type"] == "serve.resume" and r["cause"] == eid
               for r in chain):
        fail(f"phase 32 {spec}: the firing's event {eid!r} roots no chain "
             f"to a serve.resume ({[r['type'] for r in chain]})")
    after = [t for t in times if t > fired[0]["ts"]]
    return (toks, s.journal, (after[0] - fired[0]["ts"]) if after else None,
            [r["type"] for r in chain])


def check_journal(j, what, resumes, midstream, attempts, outcomes):
    got = (j.resumes, j.resumed_midstream,
           [e["attempt"] for e in j.handoffs], j.handoff_outcomes)
    want = (resumes, midstream, attempts, outcomes)
    if got != want:
        fail(f"phase 32 {what}: journal (resumes, resumed mid-stream, "
             f"handoff attempts, outcomes) {got}, want {want}")


def disagg_phase(torch, card, served, parity, runtime):
    """Phase 32: the prefill/decode split over the runtime (module
    docstring)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama

    mem(torch, "phase 32 start")
    segments0 = shm_segments()
    os.environ["RAY_TPU_DISAGG_PREFILL_THRESHOLD"] = "0"
    prompts, phase5 = served
    cfg = llama.LlamaConfig.llama3_8b()
    group, cold_s = deploy_group(cfg, num_slots=8, max_len=2048,
                                 block_size=64)
    controller = serve.start()
    reps = {role: controller.get_replicas(group[role])[0]
            for role in ("prefill", "decode")}
    cards = {role: r.info["cuda_visible_devices"] for role, r in reps.items()}
    if len(set(cards.values())) != 1:
        fail(f"phase 32: the pair is on cards {cards}, not one card")
    mem(torch, "phase 32 pair up")
    port = serve.start_http(port=0)
    name = DISAGG["name"]
    list(http_tokens(port, {"prompt_token_ids": prompts[0][:16],
                            "max_tokens": 2}, name=name))     # warm-up
    m0 = metrics_scrape(port)
    c0 = role_counters(group, reset=True)
    outs, ttft, wall = stream_all(lambda i: http_tokens(
        port, {"prompt_token_ids": prompts[i], "max_tokens": 32},
        name=name), len(prompts))
    c1 = role_counters(group)
    m1 = metrics_scrape(port)
    check_outputs(outs, 32, cfg.vocab_size, "phase 32")
    dec0, dec1, pre1 = c0["decode"], c1["decode"], c1["prefill"]
    ticks = dec1["ticks"] - dec0["ticks"]
    launches = {"paged": dec1["paged"], "dense": dec1["dense"]}
    if launches != {"paged": cfg.num_layers * ticks, "dense": 0} or \
            pre1["ticks"] - c0["prefill"]["ticks"] or pre1["paged"]:
        fail(f"phase 32: decode replica launches {launches} for {ticks} "
             f"ticks x {cfg.num_layers} layers; prefill replica "
             f"{pre1['ticks'] - c0['prefill']['ticks']} ticks, "
             f"{pre1['paged']} paged launches")
    records = list(dec1["records"])
    per_request = []
    for h in dec1["handoffs"]:
        rec = next(r for r in records
                   if r["prompt_tokens"] == h["prompt_tokens"])
        records.remove(rec)
        per_request.append(dict(h, **{k: rec["handoff"][k] for k in (
            "export_s", "channel_s", "import_s")}))
    if len(per_request) != len(prompts):
        fail(f"phase 32: {len(per_request)} handoffs for {len(prompts)} "
             f"requests")

    def margin(seq):
        return serve.get_deployment_handle(group["decode"]).margin.remote(
            seq).result(timeout_s=300)

    moved = sum(r["mib"] for r in per_request)
    # The transfer series, as the ingress's /metrics shows them: each
    # side's bytes grew by exactly the bytes handed off.
    xfer = {}
    for role, direction in (("prefill", "export"), ("decode", "import")):
        lab = dict(replica=reps[role].replica_id, direction=direction)
        xfer[direction] = (
            series_sum(m1, "ray_tpu_serve_kv_transfer_bytes_total", **lab)
            - series_sum(m0, "ray_tpu_serve_kv_transfer_bytes_total", **lab))
    if any(abs(v - moved * 2**20) > 0.5 for v in xfer.values()):
        fail(f"phase 32: /metrics transfer bytes {xfer}, handed off "
             f"{moved * 2**20:.0f}")
    st = dict(
        requests=len(prompts), ticks=ticks, launches=launches,
        launches_per_tick=launches["paged"] / max(ticks, 1),
        wall_s=wall, ttft_p50_ms=float(np.median(ttft)) * 1e3,
        client_tok_s=sum(map(len, outs)) / wall,
        tick_ms=(dec1["tick_s"] - dec0["tick_s"]) / max(ticks, 1) * 1e3,
        decode_tok_s=(dec1["decoded"] - dec0["decoded"]) / max(
            dec1["tick_s"] - dec0["tick_s"], 1e-9),
        handoff_mib=moved, metrics_transfer_mib={
            k: v / 2**20 for k, v in xfer.items()},
        handoff_mb_s=moved * 2**20 / 1e6 / sum(
            r["export_s"] + r["channel_s"] + r["import_s"]
            for r in per_request),
        per_request=per_request, cold_start_s=cold_s,
        replica_init_s={role: r.info["init_s"] for role, r in reps.items()},
        peak_gib={role: c1[role]["peak_gib"] for role in c1},
        agree_with_phase5=sum(a == b for a, b in zip(outs, phase5)),
        partings=partings(torch, None, cfg, prompts, outs, phase5,
                          "phase 32", against="phase-5", margin=margin),
        phase30={k: runtime[k] for k in ("ttft_p50_ms", "client_tok_s",
                                         "tick_ms")}, card=card)
    print(f"[disagg] {json.dumps(st)}")

    # Chaos: a clean run of the chaos prompt, then a kill on each side of
    # the handoff; each recovers exactly once to the clean run's tokens.
    payload = {"prompt_token_ids": prompts[0][:DISAGG["chaos_tokens"]],
               "max_tokens": 32}
    clean = list(http_tokens(port, payload, name=name))
    chaos_st = {}
    for stage, seed, want_j in (
            ("export", 7, (1, False, [1], {"prefill_died": 1, "ok": 1})),
            ("import", 11, (1, True, [0, 1],
                            {"ok": 2, "decode_died": 1}))):
        toks, j, after_s, chain = chaos_stream(
            payload, f"kill_transfer:stage={stage}", seed)
        check_journal(j, f"kill at {stage}", *want_j)
        if toks != clean:
            fail(f"phase 32 kill at {stage}: tokens differ from the clean "
                 f"run's")
        chaos_st[stage] = dict(first_token_after_kill_s=after_s,
                               resumes=j.resumes, handoffs=len(j.handoffs),
                               chain=chain)
        for role in ("prefill", "decode"):
            wait_routed(name=group[role])
    print(f"[disagg-chaos] {json.dumps(dict(chaos_st, tokens_equal=True, prompt_tokens=len(payload['prompt_token_ids']), card=card))}")
    serve.stop_http()
    for role in ("prefill", "decode"):
        serve.delete(group[role])
    serve.unregister_role_group(name)

    # fp32 parity: phase 6's 2-layer model split over HTTP.
    pcfg, pprompts, want = parity
    new = len(want[0])
    group, _ = deploy_group(pcfg, seed=1, num_slots=8, max_len=2048)
    port = serve.start_http(port=0)

    def pmargin(seq):
        return serve.get_deployment_handle(group["decode"]).margin.remote(
            seq).result(timeout_s=300)

    got = [list(http_tokens(port, {"prompt_token_ids": p,
                                   "max_tokens": new}, name=name))
           for p in pprompts]
    check_agree(torch, None, pcfg, pprompts, got, want,
                "a split pair over HTTP and phase 6's in-process engine",
                margin=pmargin)
    killed, j, _, _ = chaos_stream(
        {"prompt_token_ids": pprompts[-1], "max_tokens": new},
        f"kill_transfer:stage={DISAGG['parity_kill']}", 13)
    if j.resumes != 1:
        fail(f"phase 32 fp32 kill: {j.resumes} resumes")
    check_agree(torch, None, pcfg, pprompts[-1:], [killed], want[-1:],
                "a split pair after a kill_transfer and phase 6's engine",
                margin=pmargin)
    print(f"[disagg-parity] {json.dumps(dict(requests=len(pprompts), tokens=new, identical=got == want, killed_identical=killed == want[-1], card=card))}")
    serve.shutdown()
    os.environ.pop("RAY_TPU_DISAGG_PREFILL_THRESHOLD", None)
    left = sorted(set(shm_segments()) - set(segments0))
    if left:
        fail(f"phase 32 left shm segments behind: {left}")
    mem(torch, "phase 32 end")
    st.update(chaos=chaos_st)
    return st


def metrics_scrape(port):
    """The ingress's ``GET /metrics`` text."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        body = resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200:
        fail(f"GET /metrics answered {resp.status}: {body[:300]}")
    return body


def series_sum(text, name, **labels):
    """Sum of ``name``'s sample values in a Prometheus text whose labels
    include ``labels``."""
    total = 0.0
    for line in text.splitlines():
        m = re.match(r"^(\w+)\{(.*)\} (\S+)$", line)
        if not m or m.group(1) != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2)))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(m.group(3))
    return total


# -------------------------------------- phase 33: observability, served
# The warm bursts' tracing modes, alternated so the host clock's drift
# falls on both; the TTFT split's tolerance (JAX's,
# tests/test_serve_request_tracing.py:47-60).
OBSERVE = dict(modes=(False, True), ttft_rel=0.10,
               ttft_abs_s=5e-3)
OBSERVE_SPANS = ("serve.ingress", "serve.route", "engine.queue",
                 "engine.prefill", "engine.decode_window")


def set_tracing(handle, on):
    """Request tracing on or off in this process and the replica's."""
    os.environ["RAY_TPU_TRACING"] = "1" if on else "0"
    handle.set_tracing.remote(on).result(timeout_s=120)


def request_trace(tracing, request_id, what, timeout_s=30.0):
    """The serving process's spans of one request once its trace holds
    ``OBSERVE_SPANS`` (the replica's arrive over its pipe); fails unless
    it is one connected trace rooted at ``serve.ingress``, its engine
    spans parented to its route span."""
    deadline = time.monotonic() + timeout_s
    while True:
        spans = tracing.local_spans(request_id=request_id)
        if set(OBSERVE_SPANS) <= {s["name"] for s in spans} or \
                time.monotonic() > deadline:
            break
        time.sleep(0.05)
    names = sorted({s["name"] for s in spans})
    if not set(OBSERVE_SPANS) <= set(names) or not tracing.connected(spans):
        fail(f"{what}: request {request_id}: not one connected trace "
             f"holding {OBSERVE_SPANS}: {names}")
    by_id = {s["span_id"]: s for s in spans}
    bad = [s["name"] for s in spans if s["name"].startswith("engine.")
           and by_id[s["parent_span_id"]]["name"] != "serve.route"]
    if bad:
        fail(f"{what}: request {request_id}: engine spans {bad} are not "
             f"under serve.route")
    return spans


def ttft_split(spans, what):
    """(TTFT, queue + arena wait + prefill) of one request from its
    engine spans; fails outside JAX's tolerance."""
    def one(name):
        return next(s for s in spans if s["name"] == name)

    q, p = one("engine.queue"), one("engine.prefill")
    wait = sum(s["dur"] for s in spans if s["name"] == "engine.arena_wait")
    ttft = p["ts"] + p["dur"] - q["ts"]
    comp = q["dur"] + wait + p["dur"]
    if abs(comp - ttft) > max(OBSERVE["ttft_rel"] * ttft,
                              OBSERVE["ttft_abs_s"]):
        fail(f"{what}: queue + arena wait + prefill {comp:.4f} s against "
             f"TTFT {ttft:.4f} s")
    return ttft, comp


def observe_phase(torch, card, served, runtime):
    """Phase 33: observability over the runtime (module docstring)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_continuous_llama_app
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.util import tracing

    mem(torch, "phase 33 start")
    prompts, phase5 = served
    cfg = llama.LlamaConfig.llama3_8b()
    n = len(prompts)
    os.environ["RAY_TPU_TRACING"] = "1"       # the replica inherits it
    built = build_continuous_llama_app(cfg, num_slots=8, max_len=2048)
    handle = serve.run(serve.deployment(
        CountingLlm, name=SERVE_NAME,
        ray_actor_options=built.deployment.ray_actor_options).bind(
        *built.args, **built.kwargs))
    replica = wait_routed()
    label = dict(replica=replica.replica_id)
    port = serve.start_http(port=0)
    list(http_tokens(port, {"prompt_token_ids": prompts[0][:16],
                            "max_tokens": 2}))           # warm-up
    tracing.clear_spans()
    m0 = metrics_scrape(port)
    c0 = handle.counters.remote(True).result(timeout_s=120)
    ids = [f"observe-{i:02d}" for i in range(n)]
    outs, ttft, wall = stream_all(lambda i: http_tokens(
        port, {"prompt_token_ids": prompts[i], "max_tokens": 32},
        headers={"x-request-id": ids[i]}), n)
    c1 = handle.counters.remote().result(timeout_s=120)
    t0 = time.perf_counter()
    m1 = metrics_scrape(port)
    scrape_ms = (time.perf_counter() - t0) * 1e3
    st = served_stats(outs, ttft, wall, c1["ticks"] - c0["ticks"],
                      {"paged": c1["paged"], "dense": c1["dense"]},
                      c1["prefill_s"] - c0["prefill_s"],
                      c1["decoded"] - c0["decoded"], cfg.num_layers,
                      cfg.vocab_size, "phase 33")

    def margin(seq):
        return handle.margin.remote(seq).result(timeout_s=300)

    for i, (a, b) in enumerate(zip(outs, phase5)):
        if a != b:
            j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            top2, _ = margin(prompts[i] + b[:j])
            print(f"[parity] phase 33 request {i} parts from phase 5 at "
                  f"token {j}: top-2 margin {top2:.4e}")
            if top2 >= TOP2_MARGIN:
                fail(f"phase 33: request {i}'s tokens differ from phase "
                     f"5's at token {j} (top-2 margin {top2})")
    traces = [request_trace(tracing, r, "phase 33") for r in ids]
    split = [ttft_split(spans, f"phase 33 request {i}")
             for i, spans in enumerate(traces)]
    streamed = sum(map(len, outs))
    deltas = {key: series_sum(m1, name, **label)
              - series_sum(m0, name, **label) for key, name in (
                  ("ttft_count", "ray_tpu_serve_request_ttft_seconds_count"),
                  ("decode_tokens", "ray_tpu_cb_decode_tokens_total"),
                  ("prefill_tokens", "ray_tpu_cb_prefill_tokens_total"))}
    want = dict(ttft_count=n, decode_tokens=streamed - n,
                prefill_tokens=sum(map(len, prompts)))
    if deltas != want:
        fail(f"phase 33: /metrics grew by {deltas} under the replica's "
             f"label, want {want}")
    replica_lines = sum(f'replica="{replica.replica_id}"' in line
                        for line in m1.splitlines())
    st.update(
        agree_with_phase5=sum(a == b for a, b in zip(outs, phase5)),
        traces_connected=len(traces), metrics_deltas=deltas,
        launches_per_tick=st["launches"]["paged"] / max(st["ticks"], 1),
        ttft_split_max_gap_ms=max(t - c for t, c in split) * 1e3,
        engine_ttft_p50_ms=float(np.median([t for t, _ in split])) * 1e3,
        spans_per_request=float(np.mean([len(t) for t in traces])),
        replica_spans_per_request=float(np.mean([sum(
            s["worker_id"] == replica.replica_id for s in t)
            for t in traces])),
        replica_samples_per_scrape=replica_lines,
        scrape_ms=scrape_ms, metrics_bytes=len(m1),
        phase30={k: runtime[k] for k in ("ttft_p50_ms", "tick_ms",
                                         "client_tok_s")}, card=card)
    print(f"[observe] {json.dumps(st)}")

    # Tracing off and on in one replica, on the now prefix-cached prompts.
    modes = []
    for on in OBSERVE["modes"]:
        set_tracing(handle, on)
        b0 = handle.counters.remote(True).result(timeout_s=120)
        bo, bt, bw = stream_all(lambda i: http_tokens(
            port, {"prompt_token_ids": prompts[i], "max_tokens": 32}), n)
        b1 = handle.counters.remote().result(timeout_s=120)
        check_outputs(bo, 32, cfg.vocab_size, f"phase 33 tracing={on}")
        ticks = b1["ticks"] - b0["ticks"]
        if b1["paged"] != cfg.num_layers * ticks:
            fail(f"phase 33 tracing={on}: {b1['paged']} paged launches "
                 f"for {ticks} ticks")
        modes.append(dict(
            tracing=on, ticks=ticks,
            tick_ms=(b1["tick_s"] - b0["tick_s"]) / max(ticks, 1) * 1e3,
            ttft_p50_ms=float(np.median(bt)) * 1e3,
            client_tok_s=sum(map(len, bo)) / bw))
    summary = {mode: {k: float(np.median([m[k] for m in modes
                                          if m["tracing"] == on]))
                      for k in ("tick_ms", "ttft_p50_ms", "client_tok_s")}
               for mode, on in (("off", False), ("on", True))}
    print(f"[observe-cost] {json.dumps(dict(summary, bursts=modes, card=card))}")
    serve.shutdown()
    os.environ.pop("RAY_TPU_TRACING", None)
    tracing.clear_spans()
    mem(torch, "phase 33 end")
    st.update(cost=summary)
    return st


def serve_phases(torch, card, served, parity):
    """Phases 29-33; every replica process has exited and its device
    memory is back at the end."""
    free0 = mem(torch, "phases 29-33 start")
    out = {"deploy": timed("phase 29", deploy_phase, torch, card, served)}
    out["runtime"] = timed("phase 30", runtime_phase, torch, card, served,
                           out["deploy"])
    out["parity"] = timed("phase 31", runtime_parity, torch, card, parity)
    out["disagg"] = timed("phase 32", disagg_phase, torch, card, served,
                          parity, out["runtime"])
    out["observe"] = timed("phase 33", observe_phase, torch, card, served,
                           out["runtime"])
    deadline = time.monotonic() + 30
    while torch.cuda.mem_get_info()[0] < free0 - 2**30 and \
            time.monotonic() < deadline:
        time.sleep(0.5)
    if mem(torch, "phases 29-33 end") < free0 - 2**30:
        fail("phases 29-33: the replicas' device memory did not come back")
    return out


# ------------------------------------ phase 37: the core API on the card
# The card actor's engine (phase 29's), its threads, and the hop study's
# executions a mode.
CORE = dict(num_slots=8, max_len=2048, max_concurrency=16, new=32,
            hop_iters=1000, mem_slack_gib=1.0)


class CoreLlm(ContinuousLlamaDeployment._cls_or_fn):
    """Phase 37's actor: the port's deployment at Llama-3-8B's widths,
    its weights drawn from seed 0 on the card inside the actor (phase
    29's), with a one-argument ``score`` for a DAG stage and the engine's
    counters."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stamps, self._opening = {}, threading.local()

    def _open(self, submit, ready=None):
        t0 = time.perf_counter()
        out = super()._open(submit, ready)
        self._opening.span = (t0, time.perf_counter())
        return out

    def generate(self, prompt_token_ids, max_tokens=16):
        """The deployment's stream, stamped by prompt: when the actor's
        thread starts it, when the engine lock was asked for and when it
        took the submit (``_open`` runs on the same thread), and when the
        first token left the engine's queue."""
        start = time.perf_counter()
        for k, token in enumerate(super().generate(prompt_token_ids,
                                                   max_tokens)):
            if k == 0:
                self.stamps[tuple(prompt_token_ids)] = (
                    start, *self._opening.span, time.perf_counter())
            yield token

    def score(self, request):
        prompt, tokens = request
        return self.score_logprobs(prompt, tokens)

    def counters(self):
        with self._lock:
            eng = self.batcher
            return (eng.base_tick_count, eng.prefill_seconds,
                    eng.decoded_tokens)

    def params(self):
        """The engine's params: the in-process store hands back the same
        tensors on the card, not a copy."""
        return self.batcher.params

    def records(self):
        """The engine's request records (``breakdown`` reads them)."""
        with self._lock:
            return list(self.batcher.request_breakdowns)

    def first_token_stamps(self):
        return dict(self.stamps)


class CoreRequests:
    """Phase 37's first DAG stage (a CPU actor): request ``i``'s prompt
    and its phase-29 tokens."""

    def __init__(self, requests):
        self.requests = requests

    def make(self, i):
        return self.requests[i]


class CoreHop:
    """The hop study's trivial stage."""

    def f(self, x):
        return x


def core_yardstick(torch, card, prompts):
    """``--core`` alone: phase 29's in-process burst (the same engine,
    weights and prompts), whose tokens and numbers phase 37 is held to."""
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    dep = ContinuousLlamaDeployment._cls_or_fn(
        config=cfg, num_slots=CORE["num_slots"], max_len=CORE["max_len"])
    eng = dep.batcher
    outs, st = served_burst(
        cfg, prompts, dep.generate,
        lambda: (eng.base_tick_count, eng.prefill_seconds,
                 eng.decoded_tokens), "phase 37's yardstick")
    st.update(breakdown(eng.request_breakdowns, len(prompts)))
    print(f"[core-yardstick] {json.dumps(st)}; {card}")
    st["outputs"] = outs
    # In-process scores of the yardstick's own tokens: phase 42's
    # reference when it runs alone (``--cluster``).
    st["scores"] = [dep.score_logprobs(p, o) for p, o in zip(prompts, outs)]
    dep.close()
    del dep, eng
    gc.collect()
    torch.cuda.empty_cache()
    return st


def call_seconds(fn, n):
    """Seconds of each of ``fn(0)`` .. ``fn(n - 1)``."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        times.append(time.perf_counter() - t0)
    return times


def actor_ttft_parts(client, stamps, prompts):
    """Medians, in ms, of the four parts of each stream's time to first
    token through the actor: the runtime's dispatch (``.remote`` until
    the actor's thread starts the generator), the wait for the engine
    lock to take the submit, the engine (submit to the first token out of
    its queue), and the hop back (that token through the store to the
    client)."""
    parts = {"dispatch": [], "lock": [], "engine": [], "hop": []}
    for p in map(tuple, prompts):
        (call, first), (start, ask, took, out) = client[p], stamps[p]
        for key, dt in (("dispatch", start - call), ("lock", took - ask),
                        ("engine", out - took), ("hop", first - out)):
            parts[key].append(dt)
    return {k: _median_call_ms(v) for k, v in parts.items()}


def core_phase(torch, card, prompts, phase29):
    """Phase 37: the core API on the card (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.attention import flash_attention

    gc.collect()
    torch.cuda.empty_cache()
    threads0 = set(threading.enumerate())
    mem0 = torch.cuda.memory_allocated()
    segs0 = set(shm_segments())
    rt.init()
    res = rt.cluster_resources()
    print(f"[core] resources {json.dumps(res)}; {card}")
    if res.get("GPU") != torch.cuda.device_count():
        fail(f"phase 37: init() counted {res.get('GPU')} cards, torch "
             f"sees {torch.cuda.device_count()}")
    cfg = llama.LlamaConfig.llama3_8b()

    # 2. the deployment as a num_gpus=1 actor, 12 streams through it.
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1, max_concurrency=CORE["max_concurrency"])(
        CoreLlm).remote(config=cfg, num_slots=CORE["num_slots"],
                        max_len=CORE["max_len"])
    rt.get(actor.counters.remote(), timeout=900)
    init_s = time.perf_counter() - t0

    client = {}     # prompt -> (the .remote call, its first token)

    def generate(prompt, n):
        called = time.perf_counter()
        stream = actor.generate.options(num_returns="streaming").remote(
            prompt, n)

        def tokens():
            for k, ref in enumerate(stream):
                token = rt.get(ref, timeout=600)
                if k == 0:
                    client[tuple(prompt)] = (called, time.perf_counter())
                yield token
        return tokens()

    outs, st = served_burst(
        cfg, prompts, generate,
        lambda: rt.get(actor.counters.remote(), timeout=600), "phase 37")
    want = phase29["outputs"]
    params = rt.get(actor.params.remote(), timeout=600)
    st.update(init_s=init_s, agree_with_phase29=sum(
        a == b for a, b in zip(outs, want)), partings=partings(
        torch, params, cfg, prompts, outs, want, "phase 37",
        against="phase-29"), phase29={k: phase29[k] for k in (
            "ttft_p50_ms", "tick_ms", "client_tok_s", "engine_ttft_p50_ms",
            "engine_queue_p50_ms")}, card=card)
    st.update(breakdown(rt.get(actor.records.remote(), timeout=600),
                        len(prompts)))
    st["ttft_parts_p50_ms"] = actor_ttft_parts(
        client, rt.get(actor.first_token_stamps.remote(), timeout=600),
        prompts)
    del params
    print(f"[core-actor] {json.dumps(st)}")

    # 3. InputNode -> CoreRequests.make (CPU) -> the card actor's score.
    source = rt.remote(num_gpus=0)(CoreRequests).remote(
        [(p, w) for p, w in zip(prompts, want)])
    with InputNode() as i:
        dag = actor.score.bind(source.make.bind(i))
    compiled = dag.experimental_compile()
    if not compiled._channel_mode:
        fail("phase 37: the scoring DAG did not compile to channels")
    segs = {c.name.lstrip("/") for c in compiled._channels}
    dag_s, remote_s, b1, remote_scores = [], [], [], []
    for i, req in enumerate(zip(prompts, want)):
        before = flash_attention.launches["fwd"]
        t0 = time.perf_counter()
        via_dag = rt.get(compiled.execute(i), timeout=600)
        dag_s.append(time.perf_counter() - t0)
        b1.append(flash_attention.launches["fwd"] - before)
        t0 = time.perf_counter()
        via_remote = rt.get(actor.score.remote(req), timeout=600)
        remote_s.append(time.perf_counter() - t0)
        remote_scores.append(via_remote)
        lp = np.asarray(via_dag)
        if via_dag != via_remote or b1[-1] != cfg.num_layers or \
                lp.shape != (CORE["new"],) or not (
                    np.all(np.isfinite(lp)) and np.all(lp <= 0)):
            fail(f"phase 37 score {i}: {b1[-1]} flash forward launches, "
                 f"DAG == .remote: {via_dag == via_remote}, logprobs "
                 f"{lp[:4]}...")
    dag_st = dict(requests=len(b1), b1_launches=sum(b1),
                  dag_ms_p50=_median_call_ms(dag_s),
                  remote_ms_p50=_median_call_ms(remote_s),
                  bitwise_equal=True, card=card)
    print(f"[core-dag] {json.dumps(dag_st)}")

    # 4. the hop's own cost: two trivial CPU stages.
    hop_cls = rt.remote(num_gpus=0, max_concurrency=2)(CoreHop)
    a, b = hop_cls.remote(), hop_cls.remote()
    with InputNode() as i:
        hop = b.f.bind(a.f.bind(i))
    hops = hop.experimental_compile()
    segs |= {c.name.lstrip("/") for c in hops._channels}
    n = CORE["hop_iters"]
    hop_st = dict(
        iters=n,
        dag_us_p50=_median_call_ms(call_seconds(
            lambda k: rt.get(hops.execute(k), timeout=60), n)) * 1e3,
        remote_us_p50=_median_call_ms(call_seconds(
            lambda k: rt.get(b.f.remote(a.f.remote(k)), timeout=60),
            n)) * 1e3,
        card=card)
    print(f"[core-hop] {json.dumps(hop_st)}")

    # 5. teardown: no segment, no runtime thread, the card's memory back.
    compiled.teardown()
    hops.teardown()
    left = segs & set(shm_segments())
    rt.get(actor.close.remote(), timeout=600)
    rt.kill(actor)
    try:
        rt.get(actor.counters.remote(), timeout=60)
        fail("phase 37: a call to the killed actor returned")
    except rt.exceptions.ActorDiedError:
        pass
    core = rt._private.worker.global_worker().core
    del actor, source, hop_cls, a, b, dag, hop, compiled, hops
    rt.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = torch.cuda.memory_allocated()
    runtime_left = [t.name for t in core.runtime_threads()]
    threads_left = sorted(t.name for t in set(threading.enumerate())
                          - threads0 if t.is_alive())
    down = dict(segments_left=sorted(left), new_segments=sorted(
        set(shm_segments()) - segs0), runtime_threads=runtime_left,
        threads=threads_left, mem_start_gib=mem0 / 2**30,
        mem_end_gib=mem1 / 2**30, card=card)
    print(f"[core-teardown] {json.dumps(down)}")
    if left or runtime_left or threads_left or \
            mem1 - mem0 > CORE["mem_slack_gib"] * 2**30:
        fail(f"phase 37 teardown left {down}")
    stop_processes()
    return dict(b4_launches=st["launches"]["paged"],
                b1_scoring_launches=dag_st["b1_launches"],
                actor=st, dag=dag_st, hop=hop_st, teardown=down,
                remote_scores=remote_scores)


# --------------------------------------- phases 38-39: the data plane, Tune
# Phase 38's [data-train]: phase 34's model (CKPT["layers"] layers at
# Llama-3-8B widths, TRAIN's batch and seq) fed from a Dataset: `steps`
# batches of token rows drawn from `seed`, in `blocks` blocks; [data-llm]:
# phase 5's 12 prompts in `llm_blocks` blocks through batch_generate with
# phase 29's engine (8 slots, max_len 2048), 32 tokens each. Phase 39:
# ASHA (grace `tune_grace`, reduction 2, max_t `tune_steps`) over `lrs`, a
# trial each, `tune_steps` steps of [data-train]'s batches (the warmup's
# first update has lr 0, so the first two losses are alike in every
# trial and the rung sits at the third); at most as many trials at
# once as `tune_mem_share` of the card's free bytes holds trials of the
# measured per-trial peak (the state bytes phase 34 prints, and the
# activations on top).
DATA = dict(steps=8, seed=38, blocks=4, llm_blocks=2, llm_new=32,
            tune_steps=4, tune_grace=3, lrs=(1e-5, 1e-4, 1e-3, 1e-2),
            tune_mem_share=0.8,
            mem_slack_gib=1.0, pool_layers=2, pool_engine_gib=2.0)


def data_rows(vocab):
    """[data-train]'s token rows: DATA["steps"] batches of TRAIN's rows."""
    rng = np.random.default_rng(DATA["seed"])
    return rng.integers(0, vocab, (DATA["steps"] * TRAIN["batch"],
                                   TRAIN["seq"]), dtype=np.int32)


def lm_batch(batch):
    """The Dataset's map_batches stage: a block of token rows becomes the
    train step's batch (the tokens, whose shifted copy is the targets,
    and the loss mask)."""
    tokens = np.ascontiguousarray(batch["data"])
    return {"tokens": tokens, "mask": np.ones_like(tokens)}


def data_train_steps(torch, trainer, state, batches, report):
    """[data-train]'s loop in the worker and in this process: one
    synchronous step a batch; ``report`` gets each step's loss, grad
    norm, ms and flash launches."""
    from ray_tpu_torch.ops.attention import flash_attention

    for i, batch in enumerate(batches):
        before = dict(flash_attention.launches)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        loss = float(metrics["loss"])             # syncs the step
        report(dict(step=i, loss=loss,
                    grad_norm=float(metrics["grad_norm"]),
                    step_ms=(time.perf_counter() - t0) * 1e3,
                    launches={n: flash_attention.launches[n] - before[n]
                              for n in before}))
    return state


def data_train_loop(config):
    """Phase 38's train loop, in the worker process TorchTrainer spawned
    (its card is cuda:0): phase 28's trainer from init_state(0), the
    batches from ``get_dataset_shard("train").iter_device_batches``."""
    import torch

    from ray_tpu_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = _ckpt_trainer()
    state = trainer.init_state(0)
    it = train.get_dataset_shard("train")
    with it.iter_device_batches(trainer, batch_size=TRAIN["batch"]) as pf:
        data_train_steps(torch, trainer, state, pf, train.report)


def data_train(torch, card, controller=None):
    """Phase 38a (``[data-train]``): TorchTrainer.fit with datasets= on
    the card, against the same batches through the same steps here."""
    from ray_tpu_torch import data, train
    from ray_tpu_torch.models import llama

    rows = data_rows(llama.LlamaConfig.llama3_8b().vocab_size)
    B = TRAIN["batch"]
    trainer = _ckpt_trainer()
    state = trainer.init_state(0)
    want = []
    data_train_steps(torch, trainer, state, (
        {"tokens": torch.from_numpy(rows[i:i + B]).cuda(),
         "mask": torch.ones(B, rows.shape[1], dtype=torch.int32,
                            device="cuda")}
        for i in range(0, len(rows), B)), want.append)
    nbytes = _state_bytes(state)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    ds = data.from_numpy(rows, parallelism=DATA["blocks"]).map_batches(
        lm_batch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        ctl = train.TorchTrainer(
            data_train_loop, train_loop_config={},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(name="phase38", storage_path=tmp),
            datasets={"train": ds})
        t0 = time.perf_counter()
        result = ctl.fit()
        fit_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if result.error is not None:
        fail(f"data-train: fit failed: {result.error!r}")
    recs = [h["metrics"] for h in result.metrics_history]
    L = CKPT["layers"]
    per_step = {"fwd": 2 * L, "dq": L, "dkv": L}
    got, ref = [r["loss"] for r in recs], [w["loss"] for w in want]
    if got != ref or [r["step"] for r in recs] != list(range(len(want))):
        fail(f"data-train: the worker's losses {got} != this process's "
             f"{ref} on the same batches")
    if not all(np.isfinite(got)):
        fail(f"data-train: losses {got} (want finite)")
    if any(r["launches"] != per_step for r in recs + want):
        fail(f"data-train: flash launches a step "
             f"{[r['launches'] for r in recs]}, want {per_step}")
    want_bytes = rows.nbytes * 2          # the tokens and the mask
    if ctl.dataset_bytes != [want_bytes]:
        fail(f"data-train: {ctl.dataset_bytes} bytes shipped, want "
             f"[{want_bytes}]")
    med = (lambda rs: float(np.median([r["step_ms"] for r in rs[1:]])))
    stats = dict(
        layers=L, steps=len(recs), batch=B, seq=TRAIN["seq"],
        blocks=DATA["blocks"], state_bytes=nbytes,
        shipped_bytes=ctl.dataset_bytes, step_ms=med(recs),
        inprocess_step_ms=med(want),
        phase34_step_ms=controller["step_ms"] if controller else None,
        fit_s=fit_s, losses=got, launches_per_step=per_step,
        launches={k: sum(r["launches"][k] for r in recs) for k in per_step},
        card=card)
    print(f"[data-train] {json.dumps(stats)}", flush=True)
    return stats


def data_llm(torch, card):
    """Phase 38b (``[data-llm]``): batch_generate over a Dataset of phase
    5's prompts, one engine actor on the card, against the same engine's
    run_to_completion on the same blocks in this process."""
    from ray_tpu_torch import data
    from ray_tpu_torch.llm import LLMBatchWorker, batch_generate
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention

    cfg = llama.LlamaConfig.llama3_8b()
    prompts = phase5_prompts(cfg)
    engine = dict(max_new_tokens=DATA["llm_new"], num_slots=8,
                  max_len=2048)
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    ds = data.from_items([{"prompt_ids": p, "i": i}
                          for i, p in enumerate(prompts)],
                         parallelism=DATA["llm_blocks"])
    if ds.num_blocks() != DATA["llm_blocks"]:
        fail(f"data-llm: {ds.num_blocks()} blocks")
    per = len(prompts) // DATA["llm_blocks"]
    ref_worker = LLMBatchWorker(cfg, device="cuda", **engine)
    reset_launch_counts()
    want = []
    for j in range(0, len(prompts), per):
        want += [list(map(int, g)) for g in ref_worker(
            {"prompt_ids": prompts[j:j + per]})["generated_ids"]]
    ref_launches = paged_decode_attention.launches
    del ref_worker
    gc.collect()
    torch.cuda.empty_cache()
    out = batch_generate(ds, cfg, device="cuda", **engine)
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = out.take_all()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    got = [list(map(int, r["generated_ids"])) for r in rows]
    if [r["i"] for r in rows] != list(range(len(prompts))):
        fail(f"data-llm: rows came back as {[r['i'] for r in rows]}")
    check_outputs(got, DATA["llm_new"], cfg.vocab_size, "data-llm")
    agree = sum(a == b for a, b in zip(got, want))
    if agree != len(prompts) or launches != ref_launches or not launches:
        fail(f"data-llm: {agree} of {len(prompts)} requests equal the "
             f"engine's own run; B4 launches {launches} (the engine's "
             f"own run: {ref_launches})")
    # The pool's actor is killed once its blocks are made; its engine
    # goes with its instance.
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        gc.collect()
        torch.cuda.empty_cache()
        if torch.cuda.memory_allocated() - mem0 <= \
                DATA["mem_slack_gib"] * 2**30:
            break
        time.sleep(0.2)
    mem1 = torch.cuda.memory_allocated()
    stats = dict(requests=len(prompts), blocks=DATA["llm_blocks"],
                 agree=agree, launches=launches,
                 tokens_per_s=len(prompts) * DATA["llm_new"] / wall,
                 wall_s=wall, mem_start_gib=mem0 / 2**30,
                 mem_after_teardown_gib=mem1 / 2**30, card=card)
    print(f"[data-llm] {json.dumps(stats)}", flush=True)
    if mem1 - mem0 > DATA["mem_slack_gib"] * 2**30:
        fail(f"data-llm: the pool's engine was not freed: {stats}")
    return stats


def data_llm_pool(torch, card):
    """Phase 38c (``[data-llm-pool]``, two cards or more):
    batch_generate with ``concurrency=2`` on ``cuda``, a pool actor
    pinned to each of cards 0 and 1, at Llama-3-8B widths and
    DATA["pool_layers"] layers, against the same engine's
    run_to_completion on card 0 in this process."""
    from ray_tpu_torch import data
    from ray_tpu_torch.llm import LLMBatchWorker, batch_generate
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention

    if torch.cuda.device_count() < 2:
        print("[data-llm-pool] not run: the pool of two needs two cards, "
              f"this machine has {torch.cuda.device_count()}", flush=True)
        return None
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=DATA["pool_layers"])
    prompts = phase5_prompts(cfg)
    engine = dict(max_new_tokens=DATA["llm_new"], num_slots=8,
                  max_len=2048)
    per = len(prompts) // DATA["llm_blocks"]
    ref_worker = LLMBatchWorker(cfg, device="cuda:0", **engine)
    reset_launch_counts()
    want = []
    for j in range(0, len(prompts), per):
        want += [list(map(int, g)) for g in ref_worker(
            {"prompt_ids": prompts[j:j + per]})["generated_ids"]]
    ref_launches = paged_decode_attention.launches
    del ref_worker
    gc.collect()
    torch.cuda.empty_cache()
    base = [torch.cuda.memory_allocated(i) for i in range(2)]
    for i in range(2):
        torch.cuda.reset_peak_memory_stats(i)
    ds = data.from_items([{"prompt_ids": p, "i": i}
                          for i, p in enumerate(prompts)],
                         parallelism=DATA["llm_blocks"])
    out = batch_generate(ds, cfg, concurrency=2, device="cuda", **engine)
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = out.take_all()
    wall = time.perf_counter() - t0
    launches = paged_decode_attention.launches
    peaks = [torch.cuda.max_memory_allocated(i) - base[i]
             for i in range(2)]
    got = [list(map(int, r["generated_ids"])) for r in rows]
    if [r["i"] for r in rows] != list(range(len(prompts))):
        fail(f"data-llm-pool: rows came back as {[r['i'] for r in rows]}")
    check_outputs(got, DATA["llm_new"], cfg.vocab_size, "data-llm-pool")
    agree = sum(a == b for a, b in zip(got, want))
    stats = dict(requests=len(prompts), layers=cfg.num_layers,
                 agree=agree, launches=launches,
                 peak_gib_by_card=[x / 2**30 for x in peaks],
                 tokens_per_s=len(prompts) * DATA["llm_new"] / wall,
                 wall_s=wall, card=card)
    print(f"[data-llm-pool] {json.dumps(stats)}", flush=True)
    if agree != len(prompts) or launches != ref_launches:
        fail(f"data-llm-pool: {agree} of {len(prompts)} requests equal "
             f"the engine's own run; B4 launches {launches} (the "
             f"engine's own run: {ref_launches})")
    if min(peaks) < DATA["pool_engine_gib"] * 2**30:
        fail(f"data-llm-pool: an engine did not land on each card: "
             f"peaks {stats['peak_gib_by_card']} GiB")
    return stats


def data_phase(torch, card, controller=None):
    """Phase 38: the data plane on the card (module docstring)."""
    import ray_tpu_torch as rt

    if not rt.is_initialized():
        rt.init()
    try:
        train_st = timed("phase 38a", data_train, torch, card, controller)
        llm_st = timed("phase 38b", data_llm, torch, card)
        pool_st = timed("phase 38c", data_llm_pool, torch, card)
    finally:
        rt.shutdown()
    stop_processes()
    return dict(train=train_st, llm=llm_st, pool=pool_st,
                data_launches=train_st["launches"],
                batch_launches=llm_st["launches"])


def tune_phase(torch, card):
    """Phase 39 (``[tune]``): a Tuner with ASHA over DATA["lrs"] of
    [data-train]'s trainer on the card, each trial held to its config
    run directly in this process, and ASHA's stops to the schedule those
    direct losses give in the order the trials reported."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.attention import flash_attention

    rows = data_rows(llama.LlamaConfig.llama3_8b().vocab_size)
    B, n = TRAIN["batch"], DATA["tune_steps"]
    L = CKPT["layers"]
    per_step = {"fwd": 2 * L, "dq": L, "dkv": L}
    computed = {}

    def run(lr, report):
        trainer = _ckpt_trainer(learning_rate=lr)
        state = trainer.init_state(0)
        for i in range(n):
            batch = {"tokens": torch.from_numpy(rows[i * B:(i + 1) * B]
                                                ).cuda(),
                     "mask": torch.ones(B, rows.shape[1], dtype=torch.int32,
                                        device="cuda")}
            state, metrics = trainer.train_step(state, batch)
            loss = float(metrics["loss"])
            computed[lr] = computed.get(lr, 0) + 1
            report(loss)
        return trainer, state

    direct, peak, nbytes = {}, 0, 0
    for lr in DATA["lrs"]:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        trainer, state = run(lr, losses.append)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        nbytes = _state_bytes(state)
        direct[lr] = losses
        del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    concurrent = max(1, min(len(DATA["lrs"]), int(
        DATA["tune_mem_share"] * free // max(peak, nbytes))))

    def trainable(config):
        run(config["lr"], lambda loss: tune.report({"loss": loss}))

    asha = dict(metric="loss", mode="min", max_t=n,
                grace_period=DATA["tune_grace"], reduction_factor=2)
    calls = []

    class Recording(tune.AsyncHyperBandScheduler):
        def on_result(self, trial_id, step, value):
            verdict = super().on_result(trial_id, step, value)
            calls.append((trial_id, step, value, verdict))
            return verdict

    computed.clear()
    rt.init()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        grid = tune.Tuner(
            trainable,
            param_space={"lr": tune.grid_search(list(DATA["lrs"]))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", scheduler=Recording(**asha),
                max_concurrent_trials=concurrent),
            run_config=train.RunConfig(name="phase39",
                                       storage_path=tmp)).fit()
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    fit_s = time.perf_counter() - t0
    launches = dict(flash_attention.launches)
    if len(grid) != len(DATA["lrs"]) or grid.errors:
        fail(f"tune: {len(grid)} trials, errors "
             f"{[r.error for r in grid.errors]}")
    trials = {}
    for r in grid:
        lr = r.config["lr"]
        got = [m["loss"] for m in r.metrics_history]
        if got != direct[lr][:len(got)] or (
                not r.stopped_early and len(got) != n):
            fail(f"tune: trial lr={lr} reported {got}, the same config "
                 f"run here gave {direct[lr]}")
        trials[r.trial_id] = dict(lr=lr, reported=len(got),
                                  computed=computed[lr],
                                  stopped=r.stopped_early)
    # ASHA again, fed the direct runs' losses in the trials' order.
    replay = tune.AsyncHyperBandScheduler(**asha)
    for trial_id, step, value, verdict in calls:
        lr = trials[trial_id]["lr"]
        if value != direct[lr][step - 1] or replay.on_result(
                trial_id, step, direct[lr][step - 1]) != verdict:
            fail(f"tune: ASHA's verdict {verdict} on {trial_id} at step "
                 f"{step} is not the schedule the direct losses give")
    stopped = {t for t, s in trials.items() if s["stopped"]}
    if stopped != {t for t, _, _, v in calls if v == "STOP"}:
        fail(f"tune: stopped trials {stopped} differ from ASHA's stops")
    steps_run = sum(s["computed"] for s in trials.values())
    want_launches = {k: v * steps_run for k, v in per_step.items()}
    if launches != want_launches:
        fail(f"tune: flash launches {launches}, want {want_launches} for "
             f"{steps_run} steps")
    stats = dict(
        trials=len(grid), stopped=len(stopped), max_concurrent=concurrent,
        state_bytes=nbytes, trial_peak_bytes=peak, free_bytes=free,
        steps_run=steps_run, fit_s=fit_s, launches=launches,
        launches_per_trial={s["lr"]: {k: v * s["computed"]
                                      for k, v in per_step.items()}
                            for s in trials.values()},
        losses={str(lr): v for lr, v in direct.items()},
        schedule=[(trials[t]["lr"], step, v) for t, step, _, v in calls],
        card=card)
    print(f"[tune] {json.dumps(stats)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(stats, tune_launches=launches)


# ------------------------------------------ --serve-ticks: the tick study
def step_records(eng):
    """Record every later ``eng.step()``: (start, wall s, the stepping
    thread's CPU s, base ticks it ran, whether it prefilled)."""
    recs, inner = [], eng.step

    def step(*args, **kw):
        t0, c0 = time.perf_counter(), time.thread_time()
        ticks0, batches0 = eng.base_tick_count, eng.prefill_batches
        out = inner(*args, **kw)
        recs.append((t0, time.perf_counter() - t0, time.thread_time() - c0,
                     eng.base_tick_count - ticks0,
                     eng.prefill_batches != batches0))
        return out

    eng.step = step
    return recs


def step_summary(recs):
    """A burst's steps: over its decode-only steps (one tick, no
    prefill), the median wall ms and the mean wall and stepping-thread
    CPU ms (the thread CPU clock may tick in 10 ms, so its mean over many
    steps is read, not its median), and the gaps between steps on the
    stepping thread (the engine lock, the loop, the wait for work)."""
    recs = list(recs)
    dec = [r for r in recs if r[3] == 1 and not r[4]]
    gaps = [b[0] - a[0] - a[1] for a, b in zip(recs, recs[1:])]

    def p50(xs):
        return float(np.median(xs)) * 1e3 if xs else None

    def mean(xs):
        return float(np.mean(xs)) * 1e3 if xs else None

    return dict(steps=len(recs), decode_steps=len(dec),
                prefill_steps=sum(bool(r[4]) for r in recs),
                ticks=sum(r[3] for r in recs),
                decode_step_ms=p50([r[1] for r in dec]),
                decode_step_mean_ms=mean([r[1] for r in dec]),
                decode_step_cpu_mean_ms=mean([r[2] for r in dec]),
                steps_ms=sum(r[1] for r in recs) * 1e3,
                steps_cpu_ms=sum(r[2] for r in recs) * 1e3,
                gap_p50_ms=p50(gaps), gaps_ms=sum(gaps) * 1e3,
                span_ms=(recs[-1][0] + recs[-1][1] - recs[0][0]) * 1e3
                if recs else None)


class DeviceBusy:
    """torch.profiler over a stretch of work: the device-side rows'
    (kernels, copies) busy ms. The profiler keeps its state on the thread
    that starts it, so ``own_thread`` starts and stops it on a thread of
    its own: a replica serves the study's two calls on any pool thread."""

    def __init__(self, own_thread=False):
        self._done, self._out, self._thread = threading.Event(), None, None
        if not own_thread:
            self._prof = self._start()
            return
        started = threading.Event()

        def run():
            prof = self._start()
            started.set()
            self._done.wait()
            self._out = self._read(prof)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        started.wait(120)

    @staticmethod
    def _start():
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        return prof

    @staticmethod
    def _read(prof):
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        prof.stop()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        return dict(device_busy_ms=sum(e.self_device_time_total
                                       for e in rows) / 1e3,
                    device_ops=sum(e.count for e in rows))

    def stop(self):
        if self._thread is None:
            return self._read(self._prof)
        self._done.set()
        self._thread.join(timeout=300)
        return self._out


class TickStudyLlm(CountingLlm):
    """``--serve-ticks``' deployment: ``CountingLlm`` whose engine records
    its steps (:func:`step_records`), with the study's controls as a
    method. User code: the replica process finds it here by name."""

    def __init__(self, config, **engine):
        super().__init__(config, **engine)
        self.recs = step_records(self.batcher)
        self.busy = None

    def study(self, op, prompts=None):
        import torch

        if op == "reset":
            self.recs.clear()
            return None
        if op == "profile":
            self.busy = DeviceBusy(own_thread=True)
            return None
        if op == "stop":
            busy, self.busy = self.busy.stop(), None
            return busy
        if op == "one-reader":
            return one_reader(torch, self, prompts)
        return step_summary(self.recs)


def one_reader(torch, dep, prompts, new=32):
    """Every prompt opened on ``dep`` from this thread, then their queues
    read after the last token: the tick thread steps with no consumer
    thread to wake but this one (request 0's reader)."""
    dep.recs.clear()
    t0 = time.perf_counter()
    opened = [dep._open(lambda p=p: dep.batcher.submit(
        list(p), max_new_tokens=new)) for p in prompts]
    outs = [list(dep._tokens(rid, q)) for rid, q in opened]
    wall = time.perf_counter() - t0
    check_outputs(outs, new, dep.config.vocab_size, "one-reader")
    return dict(wall_ms=wall * 1e3, **step_summary(dep.recs))


def loop_burst(torch, dep, prompts, new=32):
    """Phase 5's loop on ``dep``'s own engine from this thread, under the
    engine lock, so the tick thread stays out: every prompt submitted,
    then ``run_to_completion``."""
    eng = dep.batcher
    dep.recs.clear()
    with dep._lock:
        t0 = time.perf_counter()
        rids = [eng.submit(list(p), max_new_tokens=new) for p in prompts]
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_outputs([done[r] for r in rids], new, dep.config.vocab_size,
                  "loop")
    return dict(wall_ms=wall * 1e3, **step_summary(dep.recs))


def thread_burst(torch, dep, prompts, new=32):
    """Phase 29's burst: one ``generate`` stream a thread."""
    dep.recs.clear()
    outs, _, wall = stream_all(lambda i: dep.generate(prompts[i], new),
                               len(prompts))
    check_outputs(outs, new, dep.config.vocab_size, "threads")
    return dict(wall_ms=wall * 1e3, **step_summary(dep.recs))


def serve_ticks(torch, card, cfg=None, engine=None, rounds=2):
    """``--serve-ticks``: where the deployment's tick goes. Llama-3-8B
    (phase 5's weights and prompts, 8 slots, max_len 2048) in process:
    phase 5's loop on the deployment's engine, phase 29's 12 threads, and
    one reader; then in a replica process: phase 30's 12 HTTP streams and
    one reader inside the replica. The timed bursts run first, in turns
    (``rounds`` of each), and the profiled ones (device busy ms) after
    them all: a profiler leaves later launches costlier on the host.
    Prints ``[ticks]`` lines."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama

    cfg = cfg or llama.LlamaConfig.llama3_8b()
    engine = dict(num_slots=8, max_len=2048, **(engine or {}))
    prompts = phase5_prompts(cfg)
    warm = prompts[0][:16]

    def study(where, bursts):
        runs = {name: [] for name in bursts}
        for _ in range(rounds):
            for name, burst in bursts.items():
                runs[name].append(burst())
        for name, burst in bursts.items():
            print("[ticks] " + json.dumps(dict(
                where=where, burst=name, timed=runs[name],
                profiled=burst(profile=True), card=card)), flush=True)

    dep = TickStudyLlm(cfg, **engine)
    list(dep.generate(warm, 2))

    def in_process(fn):
        def burst(profile=False):
            busy = DeviceBusy() if profile else None
            res = fn(torch, dep, prompts)
            return dict(res, **busy.stop()) if busy else res
        return burst

    study("in process", {"loop": in_process(loop_burst),
                         "threads": in_process(thread_burst),
                         "one-reader": in_process(one_reader)})
    dep.close()
    del dep
    gc.collect()
    torch.cuda.empty_cache()

    handle = serve.run(serve.deployment(
        TickStudyLlm, name=SERVE_NAME,
        ray_actor_options={"num_gpus": 1}).bind(cfg, **engine))
    control = handle.options("study")
    port = serve.start_http(port=0)

    def in_replica(fn):
        def burst(profile=False):
            control.remote("reset").result(timeout_s=60)
            if profile:
                control.remote("profile").result(timeout_s=60)
            res = fn()
            if profile:
                res.update(control.remote("stop").result(timeout_s=300))
            return res
        return burst

    def http():
        outs, _, wall = stream_all(lambda i: http_tokens(
            port, {"prompt_token_ids": prompts[i], "max_tokens": 32}),
            len(prompts))
        check_outputs(outs, 32, cfg.vocab_size, "replica http")
        return dict(wall_ms=wall * 1e3,
                    **control.remote("summary").result(timeout_s=60))

    try:
        list(http_tokens(port, {"prompt_token_ids": warm, "max_tokens": 2}))
        study("replica", {
            "http": in_replica(http),
            "one-reader": in_replica(lambda: control.remote(
                "one-reader", prompts).result(timeout_s=600))})
    finally:
        serve.shutdown()


def runtime_ttft(torch, card, rounds=3):
    """``--runtime-ttft``: phase 30's app (Llama-3-8B, one replica
    process on its own card, ``CountingLlm``) with the prefix cache off,
    ``rounds`` bursts of phase 5's 12 prompts as 12 HTTP streams of 32
    tokens: per burst the TTFT p50 at the client, inside the replica
    (entry into user code to the first token) and in the engine (submit
    to first token), and the tick ms."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_continuous_llama_app
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    prompts = phase5_prompts(cfg)
    built = build_continuous_llama_app(cfg, num_slots=8, max_len=2048,
                                       prefix_cache=False)
    handle = serve.run(serve.deployment(
        CountingLlm, name=SERVE_NAME,
        ray_actor_options=built.deployment.ray_actor_options).bind(
        *built.args, **built.kwargs))
    wait_routed()
    port = serve.start_http(port=0)
    list(http_tokens(port, {"prompt_token_ids": prompts[0][:16],
                            "max_tokens": 2}))           # warm-up
    bursts = []
    try:
        for _ in range(rounds):
            c0 = handle.counters.remote(True).result(timeout_s=120)
            outs, ttft, wall = stream_all(lambda i: http_tokens(
                port, {"prompt_token_ids": prompts[i], "max_tokens": 32}),
                len(prompts))
            c1 = handle.counters.remote().result(timeout_s=120)
            check_outputs(outs, 32, cfg.vocab_size, "--runtime-ttft")
            marks = np.array(c1["marks"])
            bursts.append(dict(
                ttft_p50_ms=float(np.median(ttft)) * 1e3,
                replica_ttft_p50_ms=float(np.median(
                    marks[:, 1] - marks[:, 0])) * 1e3,
                engine_ttft_p50_ms=float(np.median(
                    [r["ttft_s"] for r in c1["records"]])) * 1e3,
                tick_ms=(c1["tick_s"] - c0["tick_s"]) / max(
                    c1["ticks"] - c0["ticks"], 1) * 1e3, wall_s=wall))
    finally:
        serve.shutdown()
    print("[ttft] " + json.dumps(dict(bursts=bursts, card=card)),
          flush=True)


# --channel-mbs: staging-sized arrays through the shm channel, phase 32's
# smallest and largest handoffs.
CHANNEL_MIB = (8, 88)


def channel_mbs(rounds=5):
    """``--channel-mbs``: MB/s of the port's shm channel for a numpy
    uint8 array of each CHANNEL_MIB size (a handoff's staging buffer):
    the write, the attach and the read (a reader mapping the segment
    afresh, as the decode replica does), each the median of ``rounds``,
    with the segment mapped populated (as the channel maps it) and
    faulted in page by page; and a pickle round trip of the same array
    in memory. One ``[channel]`` JSON line."""
    import mmap
    import pickle

    from ray_tpu_torch.experimental import channel as chmod

    out = {}
    populated = chmod._MAP_FLAGS
    try:
        for name, flags in (("populated", populated),
                            ("faulted", mmap.MAP_SHARED)):
            chmod._MAP_FLAGS = flags
            for mib in CHANNEL_MIB:
                a = np.random.default_rng(mib).integers(
                    0, 255, size=mib << 20, dtype=np.uint8)
                times = []
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    ch = chmod.Channel(capacity=a.nbytes + (64 << 10))
                    ch.write(a)
                    t1 = time.perf_counter()
                    r = ch.reader(0)
                    t2 = time.perf_counter()
                    b = r.read(timeout=60)
                    t3 = time.perf_counter()
                    r.destroy()
                    ch.destroy()
                    if not np.array_equal(a, b):
                        fail(f"--channel-mbs: {mib} MiB read back wrong")
                    times.append((t1 - t0, t2 - t1, t3 - t2))
                w, at, rd = (float(np.median(x)) for x in zip(*times))
                out[f"{name}-{mib}MiB"] = dict(
                    write_s=w, attach_s=at, read_s=rd,
                    write_mb_s=a.nbytes / 1e6 / w,
                    read_mb_s=a.nbytes / 1e6 / (at + rd))
        for mib in CHANNEL_MIB:
            a = np.zeros(mib << 20, np.uint8)
            t0 = time.perf_counter()
            pickle.loads(pickle.dumps(a, protocol=5))
            out[f"pickle-roundtrip-{mib}MiB_s"] = time.perf_counter() - t0
    finally:
        chmod._MAP_FLAGS = populated
    print("[channel] " + json.dumps(out))



# ------------------------------ phase 40: a composed application on the card
# The graph's two deployments; the prompts (of phase 29's 12) that must
# be equal through HTTP, gRPC and phase 29's engine; the prompt that runs
# alone (before the notice, across it, after the replacement, and in the
# workflows) and the tokens it has delivered when the notice goes; the
# workflow ids and the event's key.
GRAPH = dict(front="graph-front", llm="graph-llm", new=32, min_equal=4,
             solo_prompt=2, preempt_after=4, workflow="chip-graph",
             event_workflow="chip-graph-event", event="chip-graph-go",
             up_s=600)
# The application the config document names by import path
# (``<this module>:GRAPH_APP``); graph_phase binds it.
GRAPH_APP = None


@tserve.deployment
class GraphFront:
    """Phase 40's front, a CPU deployment: the Llama deployment is bound
    to it, and from inside its replica process it forwards each call
    through the handle it was given (which the serving process routes)."""

    def __init__(self, llm):
        self.llm = llm

    def generate(self, payload):
        yield from self.llm.options("generate", stream=True).remote(payload)

    def score(self, request):
        prompt, tokens = request
        return self.llm.score_logprobs.remote(prompt, tokens).result(
            timeout_s=600)


def graph_generate(prompt, max_tokens):
    """Phase 40's first workflow step: a greedy stream through the
    graph's front."""
    h = tserve.get_deployment_handle(GRAPH["front"])
    return list(h.options("generate", stream=True).remote(
        {"prompt_token_ids": list(prompt), "max_tokens": max_tokens}))


def graph_score(prompt, tokens):
    """Phase 40's second workflow step: the tokens' logprobs (the flash
    forward in the Llama replica), through the front."""
    lp = tserve.get_deployment_handle(GRAPH["front"]).score.remote(
        (list(prompt), list(tokens))).result(timeout_s=600)
    return {"tokens": list(tokens), "logprobs": lp}


def grpc_tokens(port, payload, name):
    """The token ids of one ``PredictStream`` of the gRPC ingress, read
    with the port's wire codec (no generated classes)."""
    import grpc

    from ray_tpu_torch.serve import grpc_codec as codec

    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        call = channel.unary_stream(
            f"/{codec.SERVICE}/PredictStream",
            request_serializer=codec.encode,
            response_deserializer=codec.decode_reply)
        for reply in call(codec.ServeRequest(
                deployment=name, method="generate",
                payload=json.dumps(payload).encode()), timeout=600):
            item = json.loads(reply.payload)
            if not reply.ok or not isinstance(item, int):
                raise RuntimeError(f"a greedy gRPC stream sent {reply}")
            yield item


def _counter_total(metric, **tags):
    return sum(v for _, key, v in metric.samples()
               if all(dict(key).get(k) == v2 for k, v2 in tags.items()))


def graph_phase(torch, card, prompts, phase29):
    """Phase 40: a composed application deployed from a config document,
    drained by a preemption notice and driven by a durable workflow
    (module docstring)."""
    global GRAPH_APP
    import ray_tpu_torch as rt
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private import metrics_defs as mdefs
    from ray_tpu_torch._private.usage import usage_summary
    from ray_tpu_torch.checkpoint.preempt import publish_preempt
    from ray_tpu_torch.llm import build_continuous_llama_app
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import api as serve_api
    from ray_tpu_torch.util import state

    free0 = mem(torch, "phase 40 start")
    was_up = rt.is_initialized()
    cfg = llama.LlamaConfig.llama3_8b()
    want = phase29["outputs"]
    new, front, llm = GRAPH["new"], GRAPH["front"], GRAPH["llm"]

    def payload(i):
        return {"prompt_token_ids": prompts[i], "max_tokens": new}

    # 40a. The config document, deployed through PUT /-/deploy. The
    # prefix cache is off, so a prompt served again prefills as it did
    # the first time (a cached prefix's K/V, made in another batch, can
    # flip a bf16 near-tie).
    built = build_continuous_llama_app(cfg, num_slots=8, max_len=2048,
                                       prefix_cache=False)
    GRAPH_APP = GraphFront.options(name=front).bind(tserve.deployment(
        CountingLlm, name=llm,
        ray_actor_options=built.deployment.ray_actor_options).bind(
        *built.args, **built.kwargs))
    doc = tserve.build_config(GRAPH_APP)
    doc["applications"][0]["import_path"] = f"{__name__}:GRAPH_APP"
    doc["applications"][0]["deployments"][0]["placement_strategy"] = \
        "COMPACT"
    port = tserve.start_http(port=0)
    gport = tserve.start_grpc(port=0)
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=GRAPH["up_s"])
    t0 = time.perf_counter()
    conn.request("PUT", "/-/deploy", body=json.dumps(doc))
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    deploy_s = time.perf_counter() - t0
    if resp.status != 200 or json.loads(body) != {"deployed": [front]}:
        fail(f"phase 40: PUT /-/deploy answered {resp.status} {body[:300]}")
    controller = serve_api._get_controller()
    if set(controller.list_deployments()) != {front, llm} or \
            front not in controller._groups:
        fail(f"phase 40: deployed {controller.list_deployments()}, groups "
             f"{list(controller._groups)}")
    llm_h = tserve.get_deployment_handle(llm)
    list(http_tokens(port, {"prompt_token_ids": prompts[0][:16],
                            "max_tokens": 2}, name=front))   # warm-up
    c0 = llm_h.counters.remote(True).result(timeout_s=120)
    outs, ttft, wall = stream_all(
        lambda i: http_tokens(port, payload(i), name=front), len(prompts))
    c1 = llm_h.counters.remote().result(timeout_s=120)
    st = served_stats(outs, ttft, wall, c1["ticks"] - c0["ticks"],
                      {"paged": c1["paged"], "dense": c1["dense"]},
                      c1["prefill_s"] - c0["prefill_s"],
                      c1["decoded"] - c0["decoded"], cfg.num_layers,
                      cfg.vocab_size, "phase 40 over HTTP")
    # The same burst over gRPC (the same prefill batches as phase 29's
    # 12 arrivals). Requests may part from phase 29's only at a bf16
    # near-tie, which a prefill batched otherwise can flip; at least
    # GRAPH["min_equal"] must be equal on all three paths.
    got, _, _ = stream_all(
        lambda i: grpc_tokens(gport, payload(i), front), len(prompts))
    check_outputs(got, new, cfg.vocab_size, "phase 40 over gRPC")

    def margin(seq):
        return llm_h.margin.remote(seq).result(timeout_s=300)

    equal = [i for i in range(len(prompts)) if outs[i] == got[i] == want[i]]
    split = {"http": partings(torch, None, cfg, prompts, outs, want,
                              "phase 40 HTTP", against="phase-29",
                              margin=margin),
             "grpc": partings(torch, None, cfg, prompts, got, want,
                              "phase 40 gRPC", against="phase-29",
                              margin=margin)}
    if len(equal) < GRAPH["min_equal"] or any(
            m >= abs(top) * 2**-8 for p in split.values()
            for _, _, m, top in p):
        fail(f"phase 40: {len(equal)} of {len(prompts)} prompts equal over "
             f"HTTP, gRPC and phase 29's engine; partings {split}")
    st.update(deploy_s=deploy_s, equal_all_three=len(equal),
              http_equal=sum(a == b for a, b in zip(outs, want)),
              grpc_equal=sum(a == b for a, b in zip(got, want)),
              partings=split, graph_launches=c1["paged"],
              phase29={k: phase29[k] for k in (
                  "ttft_p50_ms", "tick_ms", "client_tok_s")}, card=card)
    print(f"[serve-graph] {json.dumps(st)}")

    # 40b. A preemption notice while a stream is in flight. The prompt
    # runs alone before the notice, across it and after the replacement:
    # the three runs prefill alike and must be equal.
    k = GRAPH["solo_prompt"]
    solo = list(http_tokens(port, payload(k), name=front))
    old = {r.pid for r in controller.get_replicas(llm)}
    drains0 = _counter_total(mdefs.SERVE_REPLICA_DRAINS, cause="preemption")
    toks, notice = [], None
    for t in http_tokens(port, payload(k), name=front):
        toks.append(t)
        if len(toks) == GRAPH["preempt_after"]:
            t_notice = time.perf_counter()
            notice = publish_preempt(reason="chip-smoke", node="*")
    drained = _counter_total(mdefs.SERVE_REPLICA_DRAINS,
                             cause="preemption") - drains0
    if toks != solo or drained != 2:
        fail(f"phase 40: the stream across the notice "
             f"{'equals' if toks == solo else 'differs from'} its run "
             f"before; {drained} preemption drains for 2 replicas")
    deadline = time.monotonic() + GRAPH["up_s"]
    while time.monotonic() < deadline:
        reps = controller.get_replicas(llm)
        if reps and not {r.pid for r in reps} & old and \
                not controller.draining_count(llm):
            break
        time.sleep(0.1)
    else:
        fail("phase 40: no replacement Llama replica after the notice")
    up_s = time.perf_counter() - t_notice
    after = []
    for t in http_tokens(port, payload(k), name=front):
        if not after:
            serving_s = time.perf_counter() - t_notice
        after.append(t)
    if after != solo:
        fail("phase 40: after the replacement the prompt's tokens differ "
             "from its run before the notice")
    pre = dict(notice_id=notice["notice_id"], drains=drained,
               in_flight_equal=True, after_equal=True,
               solo_equals_phase29=solo == want[k], replacement_up_s=up_s,
               notice_to_serving_s=serving_s, card=card)
    print(f"[serve-graph-preempt] {json.dumps(pre)}")

    # 40c. A workflow of two steps through the graph, run twice; a step
    # that waits for an event.
    store = tempfile.mkdtemp(prefix="chip-graph-wf-")
    workflow.init(store)
    gen, score = rt.remote(graph_generate), rt.remote(graph_score)
    dag = score.bind(prompts[k], gen.bind(prompts[k], new))
    llm_h.counters.remote(True).result(timeout_s=120)    # counts to 0
    first = workflow.run(dag, workflow_id=GRAPH["workflow"])
    c1 = llm_h.counters.remote().result(timeout_s=120)
    again = workflow.run(dag, workflow_id=GRAPH["workflow"])
    c2 = llm_h.counters.remote().result(timeout_s=120)
    lp = np.asarray(first["logprobs"])
    if first != again or first["tokens"] != solo or lp.shape != (new,) \
            or not (np.all(np.isfinite(lp)) and np.all(lp <= 0)):
        fail("phase 40: the workflow's output differs between its runs or "
             "from the prompt's run alone, or its logprobs are not "
             "finite <= 0")
    b4, b1 = c1["paged"], c1["flash_fwd"]
    if b4 <= 0 or b1 != cfg.num_layers or c2["paged"] != c1["paged"] or \
            c2["flash_fwd"] != c1["flash_fwd"]:
        fail(f"phase 40: workflow launches B4 {b4}, B1 {b1}; the resumed "
             f"run added B4 {c2['paged'] - c1['paged']}, B1 "
             f"{c2['flash_fwd'] - c1['flash_fwd']}")
    edag = gen.bind(workflow.wait_for_event(GRAPH["event"], timeout=600),
                    new)
    box = {}
    th = threading.Thread(target=lambda: box.update(out=workflow.run(
        edag, workflow_id=GRAPH["event_workflow"])))
    th.start()
    time.sleep(0.5)
    waited = th.is_alive()
    workflow.send_event(GRAPH["event"], prompts[k])
    th.join(timeout=600)
    if not waited or box.get("out") != solo:
        fail(f"phase 40: the event's workflow waited {waited}, gave "
             f"{'no output' if 'out' not in box else 'other tokens'}")
    wf = dict(workflow_launches=b4, workflow_scoring_launches=b1,
              resumed_new_launches=0, event_released=True,
              workflows=sorted(workflow.list_all()), card=card)
    print(f"[serve-graph-workflow] {json.dumps(wf)}")
    shutil.rmtree(store, ignore_errors=True)

    # 40d. The state and usage APIs.
    summary = state.summarize_cluster()
    actors = state.list_actors()
    usage = usage_summary()
    print("[serve-graph-state] " + json.dumps(
        dict(cluster=summary, actors=actors, usage=usage)))
    if not {"serve", "workflow"} <= set(usage["libraries"]) or \
            {a["class_name"] for a in actors if a["namespace"] == "serve"} \
            != {"GraphFront", "CountingLlm"}:
        fail(f"phase 40: usage {usage['libraries']}, actors {actors}")
    tserve.shutdown()
    if not was_up:
        rt.shutdown()
    wait_memory_back(torch, free0, "phase 40")
    st.update(preempt=pre, workflow=wf)
    return st


# Phase 41: the serve autoscaler (41a) and the card-pool arbiter (41b) on
# one card; --mesh-check pool: the arbiter over four whole cards.
AUTOSCALE = dict(name="as-llm", streams=24, new=32, second_served=6,
                 cap_hold_s=3.0, up_s=600,
                 config=dict(min_replicas=1, max_replicas=2,
                             target_queue_depth=4.0,
                             # Never decides: the engines' queue does.
                             target_ongoing_requests=1000.0,
                             upscale_delay_s=0.3, downscale_delay_s=2.0))
POOL = dict(name="pool-llm", run="chip-pool", layers=2, replicas=3,
            num_gpus=0.25, total=400, hold_at=40, width=4, lease_units=2,
            night_sample=8, slo_factor=2.0, min_samples=4, morning=48,
            new=32, tick_s=0.25, committed_tick_s=1.0, stage_s=600)


def pool_triangle_loop(config):
    """Phase 41b's and ``[mesh-pool]``'s train loop, in the workers
    TorchTrainer spawned: the JAX suite's pool loop
    (``tests/test_pool_arbiter.py::_e2e_loop``): restore the newest
    committed manifest (checked against the closed form), add ``step+1``
    to every element each step, save and report each step with the world
    size; past ``hold_at`` each attempt reports 5 steps, then holds while
    the file ``hold`` exists. With ``card`` each step also all-reduces a
    card tensor over the group (NCCL; a world of one forms no group) and
    checks the sum, and each rank writes its ``CUDA_VISIBLE_DEVICES``
    under ``cards_dir``."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train

    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    plane = train.get_checkpoint_plane()
    w = np.zeros(config["width"], np.float64)
    start = 0
    if plane.latest_step() is not None:
        st = plane.restore()
        w, start = st["w"].numpy(), int(st["step"]) + 1
        if not np.array_equal(w, np.full(config["width"],
                                         start * (start + 1) / 2.0)):
            raise AssertionError(f"restored {w} at start {start}")
    if config.get("cards_dir"):
        with open(os.path.join(config["cards_dir"],
                               f"{world}-{rank}-{os.getpid()}"), "w") as f:
            f.write(os.environ.get("CUDA_VISIBLE_DEVICES", ""))
    hold = config.get("hold", "")
    done = 0
    for step in range(start, config["total"]):
        while done >= 5 and step >= config["hold_at"] and hold and \
                os.path.exists(hold):
            time.sleep(0.02)
        w = w + (step + 1)
        if config.get("card"):
            t = torch.full((1,), float(step + 1), device="cuda")
            if dist.is_initialized():       # a group of one forms none
                dist.all_reduce(t)
            if t.item() != world * (step + 1):
                raise AssertionError(f"all-reduce gave {t.item()}")
        plane.save(step, {"w": w, "step": np.asarray(step)})
        train.report({"step": step, "loss": float(w.sum()),
                      "world": world})
        done += 1
    return float(w.sum())


def _pool_trainer(root, name, hold, use_gpu=False, cards_dir=""):
    from ray_tpu_torch import train as tt

    return tt.TorchTrainer(
        pool_triangle_loop,
        train_loop_config=dict(total=POOL["total"], hold_at=POOL["hold_at"],
                               width=POOL["width"], hold=hold,
                               card=use_gpu, cards_dir=cards_dir),
        scaling_config=tt.ScalingConfig(num_workers=1, min_workers=1,
                                        use_gpu=use_gpu),
        run_config=tt.RunConfig(name=name, storage_path=root,
                                failure_config=tt.FailureConfig()))


class LoadLoop:
    """``n`` closed-loop streams over HTTP: each thread streams prompt
    ``k % len(prompts)`` of a shared count ``k`` until :meth:`stop`;
    every stream is kept as (prompt index, tokens, seconds) or counted as
    dropped. A stream the ingress sheds (HTTP 429) is sent again after
    the second its answer asks for, as a client would, and counted in
    ``shed``."""

    def __init__(self, port, name, prompts, n, new):
        self.done, self.dropped, self.lock = [], [], threading.Lock()
        self.shed = 0
        self._stop = threading.Event()
        self._k = iter(range(1 << 30))
        self._threads = [threading.Thread(target=self._run, args=(
            port, name, prompts, new), daemon=True) for _ in range(n)]
        for t in self._threads:
            t.start()

    def _run(self, port, name, prompts, new):
        while not self._stop.is_set():
            with self.lock:
                k = next(self._k)
            i = k % len(prompts)
            t0 = time.perf_counter()
            try:
                toks = list(http_tokens(port, {"prompt_token_ids":
                                               prompts[i],
                                               "max_tokens": new},
                                        name=name))
            except RuntimeError as e:
                if not str(e).startswith("HTTP 429"):
                    with self.lock:
                        self.dropped.append((i, repr(e)[:200]))
                    continue
                with self.lock:
                    self.shed += 1
                m = re.search(r"retry_after_s\W+([0-9.]+)", str(e))
                self._stop.wait(float(m.group(1)) if m else 1.0)
                continue
            except Exception as e:  # noqa: BLE001 — counted, failed later
                with self.lock:
                    self.dropped.append((i, repr(e)[:200]))
                continue
            with self.lock:
                self.done.append((i, toks, time.perf_counter() - t0))

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=900)
        if any(t.is_alive() for t in self._threads):
            fail("a load stream hung")
        return self


def prefill_variants(torch, eng, prompt, new):
    """The greedy tokens ``eng`` gives ``prompt`` when its prefill batch
    holds 1, 2, 4 or 8 rows (copies of the prompt, admitted together):
    the batch shapes an engine prefills in, each its own GEMM shape and
    bf16 rounding. The rows of one batch must agree."""
    out = []
    for n in (1, 2, 4, 8):
        rids = [eng.submit(prompt, max_new_tokens=new) for _ in range(n)]
        done = eng.run_to_completion()
        rows = [done[r] for r in rids]
        if any(r != rows[0] for r in rows):
            fail(f"the {n} rows of one prefill batch of one prompt differ")
        if rows[0] not in out:
            out.append(rows[0])
    torch.cuda.synchronize()
    return out


def held_to_phase29(torch, cfg, prompts, want, runs, what):
    """Each stream's tokens against phase 29's for its prompt. Decode ticks
    run every slot at one shape, so a stream's tokens depend only on its
    prompt and on the rows its prefill batch held (1, 2, 4 or 8: another
    GEMM shape, another bf16 rounding), which a closed loop does not
    choose. A stream passes if it equals phase 29's tokens, or the
    prompt's tokens in an engine of the same weights prefilled in a batch
    of 1, 2, 4 or 8 rows (:func:`prefill_variants`; the engine is built in
    this process only when a stream parts from phase 29, after the
    replicas are gone), or parts from phase 29's at a bf16 near-tie (a
    top-2 margin under the top logit's 2^-8). Returns (equal to phase 29,
    equal to a prefill variant, near-tie partings)."""
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    equal, varied, ties = 0, 0, []
    eng, variants, seen = None, {}, {}
    for i, toks, _ in runs:
        if len(toks) != len(want[i]) or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{what}: prompt {i} returned {len(toks)} tokens")
        if toks == want[i]:
            equal += 1
            continue
        if eng is None:
            eng = ContinuousBatcher(cfg, num_slots=8, max_len=2048,
                                    block_size=64, prefix_cache=False)
        if i not in variants:
            variants[i] = prefill_variants(torch, eng, prompts[i],
                                           len(want[i]))
        if toks in variants[i]:
            varied += 1
            continue
        j = next(n for n, (x, y) in enumerate(zip(toks, want[i]))
                 if x != y)
        key = (i, j, toks[j])
        if key not in seen:
            seen[key] = top2_margin(torch, eng.params, cfg,
                                    prompts[i] + want[i][:j])
        m, top = seen[key]
        print(f"[parity] bf16 {what} and phase-29 runs part at prompt {i}, "
              f"token {j}: top-2 margin {m:.4e}, top logit {top:.4f} "
              f"(bf16 rounding there {abs(top) * 2**-8:.4e})")
        if m >= abs(top) * 2**-8:
            fail(f"{what}: prompt {i} parts from phase 29 at token {j} with "
                 f"top-2 margin {m:.4e} (top logit {top:.4f}), and from its "
                 f"{len(variants[i])} prefill variants: not a bf16 "
                 f"near-tie")
        ties.append((i, j, m, top))
    if eng is not None:
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return equal, varied, ties


def replica_counters(r, reset=False):
    return r.call("counters", (reset,), {}).result(timeout=120)


def autoscale_phase(torch, card, prompts, phase29):
    """Phase 41a: ``ContinuousLlamaDeployment`` at Llama-3-8B widths with
    an ``autoscaling_config`` (half a card a replica): 24 closed-loop
    streams scale it from one replica to two on the one card; with the
    load off it drains back to one; ``pool_set_replicas(cap=1)`` holds it
    at one under load."""
    from ray_tpu_torch._private import metrics_defs as mdefs
    from ray_tpu_torch.llm import build_continuous_llama_app
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve import api as serve_api

    free0 = mem(torch, "phase 41a start")
    cfg = llama.LlamaConfig.llama3_8b()
    name, new = AUTOSCALE["name"], AUTOSCALE["new"]
    want = phase29["outputs"]
    built = build_continuous_llama_app(cfg, num_slots=8, max_len=2048,
                                       prefix_cache=False)
    port = tserve.start_http(port=0)
    t0 = time.perf_counter()
    tserve.run(tserve.deployment(
        CountingLlm, name=name, ray_actor_options={"num_gpus": 0.5},
        autoscaling_config=AUTOSCALE["config"]).bind(
        *built.args, **built.kwargs))
    deploy_s = time.perf_counter() - t0
    controller = serve_api._get_controller()
    (first,) = controller.get_replicas(name)
    list(http_tokens(port, {"prompt_token_ids": prompts[0][:16],
                            "max_tokens": 2}, name=name))     # warm-up
    ticks0 = {"first": replica_counters(first, reset=True)["ticks"],
              "second": 0}
    t_load = time.time()
    load = LoadLoop(port, name, prompts, AUTOSCALE["streams"], new)
    second = None
    deadline = time.monotonic() + AUTOSCALE["up_s"]
    while time.monotonic() < deadline:
        reps = controller.get_replicas(name)
        if second is None and len(reps) == 2:
            second = next(r for r in reps if r is not first)
            t_routed = time.time()
        if second is not None:
            # Read under load: with the load off the autoscaler drains
            # one of the two within its down delay.
            counts = {"first": replica_counters(first),
                      "second": replica_counters(second)}
            if len(counts["second"]["marks"]) >= \
                    AUTOSCALE["second_served"]:
                break
        time.sleep(0.05)
    else:
        load.stop()
        fail(f"phase 41a: the second replica {'never came up' if second is None else 'served too few streams'}")
    load.stop()
    for k, c in counts.items():
        c["ticks"] -= ticks0[k]
    ups = [e for e in flight_events("serve.autoscale", name)
           if e["ts"] >= t_load and e["attrs"]["direction"] == "up"]
    if not ups:
        fail("phase 41a: no scale-up decision")
    cards = [r.env.get("CUDA_VISIBLE_DEVICES") for r in (first, second)]
    if cards[0] != cards[1]:
        fail(f"phase 41a: the replicas are on cards {cards}, not one")
    # With the load off the fleet drains back to one replica.
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if len(controller.get_replicas(name)) == 1 and \
                not controller.draining_count(name):
            break
        time.sleep(0.1)
    else:
        fail("phase 41a: the fleet never drained back to one replica")
    downs = [e for e in flight_events("serve.autoscale", name)
             if e["ts"] >= t_load and e["attrs"]["direction"] == "down"]
    down_ids = {e["event_id"] for e in downs}
    drain_ends = [e for e in flight_events("serve.drain_end", name)
                  if e["attrs"]["drain_cause"] == "scale_down"
                  and e["ts"] >= t_load]
    drain_begins = [e for e in flight_events("serve.drain_begin", name)
                    if e["cause"] in down_ids]
    if len(drain_begins) != 1 or len(drain_ends) != 1:
        fail(f"phase 41a: {len(drain_begins)} scale-down drains began from "
             f"the decision, {len(drain_ends)} ended")
    # The cap under load: pool_set_replicas(cap=1) holds one replica.
    controller.pool_set_replicas(name, 1, cap=1, cause="chip-smoke")
    hold_load = LoadLoop(port, name, prompts, AUTOSCALE["streams"], new)
    t_end = time.monotonic() + AUTOSCALE["cap_hold_s"]
    peak_replicas = 0
    while time.monotonic() < t_end:
        peak_replicas = max(peak_replicas, len(controller.get_replicas(
            name)) + len(controller._starting.get(name, [])))
        time.sleep(0.05)
    queued = controller.get_replica_pressure(name)
    hold_load.stop()
    if peak_replicas != 1:
        fail(f"phase 41a: the cap let {peak_replicas} replicas run")
    tserve.shutdown()
    wait_memory_back(torch, free0, "phase 41a")
    runs = load.done + hold_load.done
    dropped = load.dropped + hold_load.dropped
    if dropped:
        fail(f"phase 41a: {len(dropped)} streams dropped: {dropped[:3]}")
    equal, varied, ties = held_to_phase29(torch, cfg, prompts, want, runs,
                                          "phase 41a")
    for k, c in counts.items():
        if c["ticks"] <= 0 or c["paged"] != cfg.num_layers * c["ticks"]:
            fail(f"phase 41a: the {k} replica launched B4 {c['paged']} "
                 f"times over {c['ticks']} ticks")
    decisions = {}
    for _n, key, v in mdefs.SERVE_AUTOSCALE_DECISIONS.samples():
        tags = dict(key)
        if tags.get("deployment") == name:
            decisions[f"{tags['direction']}:{tags['signal']}"] = v
    st = dict(
        deploy_s=deploy_s, decision_to_routed_s=t_routed - ups[0]["ts"],
        decisions=decisions, streams=len(runs), dropped=len(dropped),
        second_served=len(counts["second"]["marks"]),
        b4_launches={k: c["paged"] for k, c in counts.items()},
        ticks={k: c["ticks"] for k, c in counts.items()},
        peak_gib={k: c["peak_gib"] for k, c in counts.items()},
        cards=cards, drain_outcome=drain_ends[0]["attrs"]["outcome"],
        drain_s=drain_ends[0]["attrs"]["waited_s"],
        shed=load.shed + hold_load.shed,
        equal_to_phase29=equal, equal_to_a_prefill_variant=varied,
        near_ties=ties, capped_replicas=peak_replicas,
        capped_queue=sum(float(s.get("queue_depth") or 0) for s in queued),
        card=card)
    print(f"[autoscale] {json.dumps(st)}")
    st["autoscale_launches"] = sum(st["b4_launches"].values())
    return st


def flight_events(etype, deployment):
    from ray_tpu_torch._private import events as flight

    return [e for e in flight.local_events(types=[etype], limit=100000)
            if e["subject"].get("deployment") == deployment]


def wait_memory_back(torch, free0, what):
    """Fail unless the card's free memory comes back to within 1 GiB of
    ``free0`` in 30 s (the replica processes have exited)."""
    deadline = time.monotonic() + 30
    while torch.cuda.mem_get_info()[0] < free0 - 2**30 and \
            time.monotonic() < deadline:
        time.sleep(0.5)
    if mem(torch, f"{what} end") < free0 - 2**30:
        fail(f"{what}: the replicas' device memory did not come back")


class CountMonitor:
    """Reads every replica's counters of deployment ``name`` each
    ``period_s`` and keeps each replica's last reading, so a replica
    retired in between still counts (up to its last reading)."""

    def __init__(self, name, period_s=0.5):
        from ray_tpu_torch.serve import api as serve_api

        self.last, self._stop = {}, threading.Event()
        self._controller = serve_api._get_controller()
        self._name = name
        self._thread = threading.Thread(target=self._run, args=(period_s,),
                                        daemon=True)
        self._thread.start()

    def _read(self):
        c = self._controller
        with c._lock:
            reps = c._replicas_of(self._name)
        for r in reps:
            if r.alive and r.ready:
                try:
                    self.last[r.replica_id] = r.call(
                        "counters", (), {}).result(timeout=10)
                except Exception:  # noqa: BLE001 — it went meanwhile
                    pass

    def _run(self, period_s):
        while not self._stop.wait(period_s):
            self._read()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)
        self._read()
        return self.last


def pool_story(torch, card, cfg, whole_cards, cards_dir=""):
    """Phase 41b's and ``[mesh-pool]``'s story (JAX
    ``tests/test_pool_arbiter.py::test_diurnal_chip_handoff_e2e``):
    POOL["replicas"] replicas and a world-1 trainer; a night trickle; the
    diurnal policy leases POOL["lease_units"] units, so serve drains to
    one replica and training grows to world 3, with ``preempt_node`` at
    FREEING and the arbiter killed at tick 5 (a fresh one resumes from
    the journal); a morning burst trips the SLO guard and the lease
    returns. Returns the numbers; fails on a violation, a drop, or a
    loss other than the uninterrupted run's."""
    from ray_tpu_torch._private import chaos
    from ray_tpu_torch._private import metrics_defs as mdefs
    from ray_tpu_torch.autoscaler import arbiter as arb
    from ray_tpu_torch.experimental import internal_kv as kv
    from ray_tpu_torch.serve import api as serve_api

    for key in kv.internal_kv_list("", namespace=arb.POOL_KV_NS):
        kv.internal_kv_del(key, namespace=arb.POOL_KV_NS)
    root = tempfile.mkdtemp(prefix="chip-pool-")
    hold = os.path.join(root, "hold")
    name, new = POOL["name"], POOL["new"]
    prompts = [p[:256] for p in phase5_prompts(cfg)]
    t0 = time.perf_counter()
    baseline = _pool_trainer(root, f"{POOL['run']}-base", "",
                             whole_cards).fit()
    if baseline.error is not None:
        fail(f"pool: the uninterrupted run failed: {baseline.error}")
    base_s = time.perf_counter() - t0
    open(hold, "w").close()
    port = tserve.start_http(port=0)
    from ray_tpu_torch.llm import build_continuous_llama_app

    built = build_continuous_llama_app(cfg, num_slots=8, max_len=2048,
                                       prefix_cache=False)
    gpus = 1 if whole_cards else POOL["num_gpus"]
    t0 = time.perf_counter()
    tserve.run(tserve.deployment(
        CountingLlm, name=name, num_replicas=POOL["replicas"],
        ray_actor_options={"num_gpus": gpus}).bind(
        *built.args, **built.kwargs))
    deploy_s = time.perf_counter() - t0
    controller = serve_api._get_controller()
    first_cards = sorted(r.env.get("CUDA_VISIBLE_DEVICES")
                         for r in controller.get_replicas(name))
    for r in controller.get_replicas(name):
        # Each engine's first request is slow (its first prefill): the
        # night's latency must not count it.
        warm = r.stream("generate", (prompts[0][:16], 2), {})
        while True:
            try:
                warm.next(timeout=300)
            except StopIteration:
                break
    monitor = CountMonitor(name)
    run = f"{POOL['run']}-chaos"
    trainer = _pool_trainer(root, run, hold, whole_cards, cards_dir)
    box = {}
    fit_thread = threading.Thread(
        target=lambda: box.update(result=trainer.fit()), daemon=True)
    fit_thread.start()
    serve_w = arb.ServeWorkload(name, chips_per_replica=1, min_chips=1)
    train_w = arb.TrainWorkload(run, chips_per_worker=1)
    deadline = time.monotonic() + POOL["stage_s"]
    while train_w.world() != 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    if train_w.world() != 1:
        fail("pool: the trainer never published world 1")
    train_cards0 = trainer_cards(cards_dir, 1)

    # The night: one stream at a time; its latency sets the SLO.
    night = LoadLoop(port, name, prompts, 1, new)
    while len(night.done) < POOL["night_sample"]:
        if night.dropped:
            fail(f"pool: night streams dropped {night.dropped}")
        time.sleep(0.05)
    night_p95 = float(np.percentile(
        [s for _, _, s in night.done[:POOL["night_sample"]]], 95))
    threshold = POOL["slo_factor"] * night_p95
    guard = arb.SloGuard(name, shed_rate=0, ttft_p95_s=0,
                         latency_p95_s=threshold,
                         min_samples=POOL["min_samples"])
    env = {"RAY_TPU_POOL_IDLE_TICKS": "2",
           "RAY_TPU_POOL_STEP_CHIPS": str(POOL["lease_units"]),
           "RAY_TPU_POOL_LEASE_S": "600",
           "RAY_TPU_POOL_IDLE_PER_CHIP": "1.0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    arbiter = arb.ChipPoolArbiter(serve_w, train_w, slo=guard)
    if arbiter.ledger.config()["base"] != {"serve": POOL["replicas"],
                                           "train": 1}:
        fail(f"pool: base {arbiter.ledger.config()['base']}")
    chaos.configure("preempt_node:stage=FREEING,target=*;"
                    "kill_arbiter:tick=5", seed=7)
    killed, ticks = False, 0

    def tick():
        nonlocal arbiter, killed, ticks
        try:
            st = arbiter.tick()
        except chaos.SimulatedProcessDeath:
            killed = True
            arbiter = arb.ChipPoolArbiter(serve_w, train_w, slo=guard)
            return None
        ticks += 1
        if st["violations"]:
            fail(f"pool: violations {st['violations']}")
        return st

    def stage():
        leases = arbiter.ledger.leases()
        return leases[0] if leases else None

    deadline = time.monotonic() + POOL["stage_s"]
    while time.monotonic() < deadline:
        tick()
        lease = stage()
        if lease and lease["stage"] == arb.COMMITTED:
            break
        time.sleep(POOL["tick_s"])
    else:
        fail(f"pool: the lease never committed: {arbiter.ledger.leases()}")
    chaos.reset()
    lease_id = lease["lease_id"]
    # The preemption reaches the controller through the trainer's store,
    # so FREEING may have settled just before it drained the replica the
    # lease left serve: that replica's replacement may still be starting
    # at COMMITTED (the pool counts routed replicas only).
    deadline = time.monotonic() + POOL["stage_s"]
    while time.monotonic() < deadline and (
            serve_w.chips() != 1 or controller.draining_count(name)):
        time.sleep(0.05)
    committed = dict(world=train_w.world(), serve_units=serve_w.chips(),
                     allocation=arbiter.ledger.allocation())
    serve_cards = sorted(r.env.get("CUDA_VISIBLE_DEVICES")
                         for r in controller.get_replicas(name))
    grown_cards = trainer_cards(cards_dir, 3)
    if committed["world"] != 3 or committed["serve_units"] != 1 or \
            committed["allocation"] != {"serve": 1, "train": 3,
                                        "in_flight": 0,
                                        "total": POOL["replicas"] + 1} \
            or not killed:
        fail(f"pool: at COMMITTED {committed}, arbiter killed {killed}")
    if whole_cards and (set(grown_cards) & set(serve_cards) or len(set(
            grown_cards) | set(serve_cards)) != 4 or not set(grown_cards)
            <= set(first_cards) | set(train_cards0)):
        fail(f"pool: world 3 on cards {grown_cards}, serve on "
             f"{serve_cards}; before: serve {first_cards}, train "
             f"{train_cards0}")

    # The morning: a burst until the guard reverses the lease.
    night_done = len(night.done)
    morning = LoadLoop(port, name, prompts, POOL["morning"], new)
    deadline = time.monotonic() + POOL["stage_s"]
    while time.monotonic() < deadline:
        tick()
        lease = arbiter.ledger.get_lease(lease_id)
        if lease["stage"] == arb.RETURNED:
            break
        time.sleep(POOL["committed_tick_s"] if lease["stage"] ==
                   arb.COMMITTED else POOL["tick_s"])
    else:
        fail(f"pool: the lease never returned: {lease}")
    morning.stop()
    night.stop()
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    reversal = arbiter.ledger.last_reversal()
    deadline = time.monotonic() + POOL["stage_s"]
    while time.monotonic() < deadline and not (
            train_w.world() == 1 and serve_w.chips() == POOL["replicas"]
            and not controller.draining_count(name)):
        time.sleep(0.1)
    back_cards = sorted(r.env.get("CUDA_VISIBLE_DEVICES")
                        for r in controller.get_replicas(name))
    final_train = trainer_cards(cards_dir, 1)
    alloc = arbiter.ledger.allocation()
    if reversal is None or reversal["action"] != "reversed" or \
            reversal["signal"] != "latency_p95" or \
            train_w.world() != 1 or serve_w.chips() != POOL["replicas"] or \
            alloc != {"serve": POOL["replicas"], "train": 1,
                      "in_flight": 0, "total": POOL["replicas"] + 1}:
        fail(f"pool: after the return: reversal {reversal}, world "
             f"{train_w.world()}, serve {serve_w.chips()}, {alloc}")
    if whole_cards and (set(back_cards) & set(final_train) or len(set(
            back_cards) | set(final_train)) != 4 or not set(back_cards) -
            set(serve_cards) <= set(grown_cards)):
        fail(f"pool: after the return serve on {back_cards}, train on "
             f"{final_train}; world 3 was on {grown_cards}")
    os.unlink(hold)
    fit_thread.join(timeout=600)
    result = box.get("result")
    counts = monitor.stop()
    runs = night.done + morning.done
    dropped = night.dropped + morning.dropped
    if result is None or result.error is not None:
        fail(f"pool: the trainer ended with "
             f"{'no result' if result is None else result.error}")
    if result.metrics["loss"] != baseline.metrics["loss"] or \
            result.metrics["loss"] != POOL["width"] * POOL["total"] * (
                POOL["total"] + 1) / 2.0:
        fail(f"pool: loss {result.metrics['loss']} against the "
             f"uninterrupted {baseline.metrics['loss']}")
    if dropped:
        fail(f"pool: {len(dropped)} streams dropped: {dropped[:3]}")
    for i, toks, _ in runs:
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            fail(f"pool: prompt {i} gave {len(toks)} tokens")
    # The night streams ran alone: each prompt's runs are equal.
    alone = {}
    for i, toks, _ in night.done[:night_done]:
        if alone.setdefault(i, toks) != toks:
            fail(f"pool: prompt {i}'s night runs differ")
    hist = arbiter.ledger.get_lease(lease_id)["history"]
    stage_s = {h[0]: round(n[1] - h[1], 3) for h, n in zip(hist, hist[1:])}
    b4 = sum(c["paged"] for c in counts.values())
    if b4 <= 0:
        fail("pool: no replica launched B4")
    worlds = sorted({m["metrics"]["world"] for m in result.metrics_history})
    st = dict(
        baseline_s=base_s, deploy_s=deploy_s, ticks=ticks,
        arbiter_killed=killed, violations=0,
        invariant_violations=_counter_total(
            mdefs.POOL_INVARIANT_VIOLATIONS),
        night_p95_s=night_p95, slo_threshold_s=threshold,
        reversal=reversal, stage_s=stage_s,
        handoff_s=hist[4][1] - hist[0][1], streams=len(runs),
        night_streams=night_done, dropped=len(dropped),
        shed=night.shed + morning.shed, loss_equal=True,
        worlds=worlds, b4_launches=b4, replicas_counted=len(counts),
        cards=dict(serve_first=first_cards, train_first=train_cards0,
                   serve_committed=serve_cards, train_committed=grown_cards,
                   serve_returned=back_cards, train_returned=final_train),
        card=card)
    tserve.shutdown()
    shutil.rmtree(root, ignore_errors=True)
    return st


def trainer_cards(cards_dir, world):
    """The cards the newest group of ``world`` ranks wrote, by rank."""
    if not cards_dir:
        return []
    found = {}
    for n in sorted(os.listdir(cards_dir),
                    key=lambda n: os.path.getmtime(
                        os.path.join(cards_dir, n))):
        w, rank, _ = n.split("-")
        if int(w) == world:
            with open(os.path.join(cards_dir, n)) as f:
                found[int(rank)] = f.read()
    return [found[r] for r in sorted(found)]


def pool_phase(torch, card):
    """Phase 41b: the pool story on one card, at Llama-3-8B widths with
    POOL["layers"] of 32 layers; the train side's units are CPU worker
    slots (one card holds no two NCCL ranks)."""
    from ray_tpu_torch.models import llama

    free0 = mem(torch, "phase 41b start")
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=POOL["layers"])
    st = pool_story(torch, card, cfg, whole_cards=False)
    print(f"[pool] {json.dumps(st)}")
    wait_memory_back(torch, free0, "phase 41b")
    return st


def mesh_pool(torch, card):
    """``--mesh-check pool``: the pool story over four whole cards: three
    replicas at a card each, a ``use_gpu`` trainer at world 1 over NCCL
    whose world-3 ranks land on the cards the drained replicas freed."""
    from ray_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=POOL["layers"])
    cards_dir = tempfile.mkdtemp(prefix="chip-pool-cards-")
    try:
        st = pool_story(torch, card, cfg, whole_cards=True,
                        cards_dir=cards_dir)
    finally:
        shutil.rmtree(cards_dir, ignore_errors=True)
    print(f"[mesh-pool] {json.dumps(st)}")
    return st


def phase41(torch, card, prompts, phase29):
    return dict(autoscale=timed("phase 41a", autoscale_phase, torch, card,
                                prompts, phase29),
                pool=timed("phase 41b", pool_phase, torch, card))

# ------------------------------------------- phase 42: the cluster runtime
# Phase 42's cluster: a CPU head of `head_cpus`, a card node of
# `card_cpus` owning card 0; the actor's concurrency; the card's free
# memory may end `mem_slack_gib` below where it started.
CLUSTER = dict(head_cpus=4, card_cpus=2, max_concurrency=16,
               mem_slack_gib=1.0)


class ClusterLlm(CoreLlm):
    """Phase 42's actor: phase 37's, with the launch counts and the card
    of the worker process it runs in."""

    def launch_counts(self, reset=False):
        from ray_tpu_torch.ops.attention import flash_attention
        from ray_tpu_torch.ops.decode_attention import decode_attention
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        out = {"paged": paged_decode_attention.launches,
               "dense": decode_attention.launches,
               "fwd": flash_attention.launches["fwd"]}
        if reset:
            reset_launch_counts()
        return out

    def where(self):
        import ray_tpu_torch as rt
        import torch

        return dict(pid=os.getpid(),
                    node_id=rt.get_runtime_context().get_node_id(),
                    cuda_visible_devices=os.environ.get(
                        "CUDA_VISIBLE_DEVICES"),
                    device_count=torch.cuda.device_count(),
                    device=torch.cuda.get_device_name(0))

    def take(self, refs):
        """Phase 43's get in the worker: the object of ``refs[0]`` (a
        host tensor the driver put), whether it arrived without a copy
        (its first byte inside this process's mapping of a store
        segment, and that mapping's permissions), its upload to the card
        and its fp32 sum there; the worker's cached copy is dropped."""
        import ray_tpu_torch as rt
        import torch

        core = rt._private.worker.global_worker().core
        t0 = time.perf_counter()
        x = rt.get(refs[0], timeout=600)
        get_s = time.perf_counter() - t0
        mapping = segment_mapping(x.data_ptr())
        t0 = time.perf_counter()
        y = x.to("cuda")
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        total = float(y.sum(dtype=torch.float32))
        out = dict(get_s=get_s, upload_s=upload_s, sum=total,
                   dtype=str(x.dtype), shape=list(x.shape),
                   zero_copy=mapping is not None, mapping=mapping)
        core.memory.delete([refs[0].id()])
        del x, y
        torch.cuda.empty_cache()
        return out


def segment_mapping(addr):
    """The mapping of a store segment (``/dev/shm/rtst-*``) of this
    process holding ``addr`` (``/proc/self/maps``): its permissions and
    segment name, or None when no such mapping holds it."""
    with open("/proc/self/maps") as f:
        for line in f:
            fields = line.split()
            if len(fields) >= 6 and "/dev/shm/rtst-" in fields[5]:
                lo, hi = (int(v, 16) for v in fields[0].split("-"))
                if lo <= addr < hi:
                    return dict(perms=fields[1],
                                segment=os.path.basename(fields[5]),
                                mib=(hi - lo) / 2**20)
    return None


def cluster_stream(rt, actor, prompt, n, client=None):
    """``actor.generate`` as tokens, through an ``ObjectRefGenerator``."""
    stream = actor.generate.options(num_returns="streaming").remote(prompt,
                                                                    n)
    for ref in stream:
        yield int(rt.get(ref, timeout=600))


def cluster_burst(rt, torch, cfg, actor, prompts, want, what):
    """The 12 prompts as concurrent 32-token streams through the actor,
    the worker's launch counts set to 0 just before: the tokens held to
    phase 29's by phase 41a's gate, B4 at num_layers a tick."""
    rt.get(actor.launch_counts.remote(True), timeout=600)
    ticks0, pre0, dec0 = rt.get(actor.counters.remote(), timeout=600)
    outs, ttft, wall = stream_all(
        lambda i: cluster_stream(rt, actor, prompts[i], 32), len(prompts))
    counts = rt.get(actor.launch_counts.remote(), timeout=600)
    ticks1, pre1, dec1 = rt.get(actor.counters.remote(), timeout=600)
    st = served_stats(outs, ttft, wall, ticks1 - ticks0,
                      {"paged": counts["paged"], "dense": counts["dense"]},
                      pre1 - pre0, dec1 - dec0, cfg.num_layers,
                      cfg.vocab_size, what)
    equal, varied, ties = held_to_phase29(
        torch, cfg, prompts, want, [(i, o, None) for i, o in
                                    enumerate(outs)], what)
    st.update(equal_phase29=equal, prefill_variants=varied,
              near_ties=len(ties))
    return outs, st


def cluster_phase(torch, card, prompts, phase29, core=None, controller=None):
    """Phase 42: the cluster runtime on the card (module docstring);
    phases 43 and 44 run on its cluster before its teardown."""
    import signal

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    threads0 = set(threading.enumerate())
    segs0 = set(shm_segments())
    free0 = mem(torch, "phase 42 start")
    cfg = llama.LlamaConfig.llama3_8b()
    want = phase29["outputs"]
    scratch, _ = _scratch_dir(1 << 30, "phase 42")

    # 1. the cluster in this process, the driver connected to it.
    t0 = time.perf_counter()
    cluster = Cluster(head_node_args={"num_cpus": CLUSTER["head_cpus"]},
                      gcs_persist_path=os.path.join(scratch, "gcs_state"))
    card_node = cluster.add_node(num_cpus=CLUSTER["card_cpus"], num_gpus=1,
                                 card_ids=[0])
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)
    start_s = time.perf_counter() - t0
    # The first task waits for the fork server (started here when no
    # earlier phase left one) and a worker forked from it.
    t0 = time.perf_counter()
    rt.get(rt.remote(num_cpus=1)(os.getpid).remote(), timeout=300)
    first_task_s = time.perf_counter() - t0
    res = rt.cluster_resources()
    print(f"[cluster] nodes {len(rt.nodes())}, resources {json.dumps(res)},"
          f" start {start_s:.3f} s, first task {first_task_s:.3f} s; "
          f"{card}")
    if res.get("GPU") != 1.0:
        fail(f"phase 42: the cluster counts {res.get('GPU')} cards")

    # 2. the engine as a card actor the GCS places on the card node.
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1, max_concurrency=CLUSTER["max_concurrency"],
                      max_restarts=1, name="llm")(ClusterLlm).remote(
        config=cfg, num_slots=CORE["num_slots"], max_len=CORE["max_len"],
        prefix_cache=False)
    rt.get(actor.counters.remote(), timeout=900)
    init_s = time.perf_counter() - t0
    where = rt.get(actor.where.remote(), timeout=600)
    print(f"[cluster] actor on node {where['node_id'][:12]} (the card "
          f"node: {where['node_id'] == card_node.node_id}), worker pid "
          f"{where['pid']}, CUDA_VISIBLE_DEVICES="
          f"{where['cuda_visible_devices']}, {where['device_count']} "
          f"visible card(s): {where['device']}; init {init_s:.2f} s; "
          f"{card}")
    if where["node_id"] != card_node.node_id or \
            where["cuda_visible_devices"] != "0" or \
            where["device_count"] != 1 or where["pid"] == os.getpid() or \
            where["pid"] not in card_node.worker_pids():
        fail(f"phase 42: the actor runs at {where}, not in a worker the "
             f"card node forked for card 0")

    # 3. 12 streams through ObjectRefGenerators, held to phase 29 (phase
    # 44 holds the stores to their count from before them).
    objects_before_streams = _store_objects(cluster)
    list(cluster_stream(rt, actor, prompts[0][:16], 2))     # warm-up
    outs, st = cluster_burst(rt, torch, cfg, actor, prompts, want,
                             "phase 42")
    st.update(breakdown(rt.get(actor.records.remote(), timeout=600),
                        len(prompts)))
    ref37 = core["actor"] if core else phase29
    st.update(init_s=init_s, start_s=start_s, first_task_s=first_task_s,
              card=card, beside={
        "what": "phase 37's actor in process" if core
        else "phase 37's yardstick in process",
        **{k: ref37.get(k) for k in ("init_s", "ttft_p50_ms", "tick_ms",
                                     "client_tok_s")}})
    print(f"[cluster-actor] {json.dumps(st)}")

    # 4. the 12 scores through actor.score: B1 32 a call, bit for bit.
    ref_scores = core["remote_scores"] if core else phase29["scores"]
    b1, equal_bits, max_diff, scores42 = [], 0, 0.0, []
    for i, (p, w) in enumerate(zip(prompts, want)):
        before = rt.get(actor.launch_counts.remote(), timeout=600)["fwd"]
        lp = rt.get(actor.score.remote((p, w)), timeout=600)
        scores42.append(lp)
        b1.append(rt.get(actor.launch_counts.remote(), timeout=600)["fwd"]
                  - before)
        arr = np.asarray(lp)
        if b1[-1] != cfg.num_layers or arr.shape != (CORE["new"],) or not (
                np.all(np.isfinite(arr)) and np.all(arr <= 0)):
            fail(f"phase 42 score {i}: {b1[-1]} flash forward launches, "
                 f"logprobs {arr[:4]}...")
        equal_bits += list(lp) == list(ref_scores[i])
        max_diff = max(max_diff, float(np.max(np.abs(
            arr - np.asarray(ref_scores[i])))))
    score_st = dict(requests=len(b1), b1_launches=sum(b1),
                    bitwise_equal=equal_bits, max_abs_diff=max_diff,
                    against="phase 37's .remote scores" if core
                    else "the yardstick's in-process scores", card=card)
    print(f"[cluster-score] {json.dumps(score_st)}")
    if equal_bits != len(b1):
        print(f"[cluster-finding] {len(b1) - equal_bits} of {len(b1)} "
              f"scores through the cluster actor differ from "
              f"{score_st['against']} (max abs diff {max_diff:.3e})")

    # 5. the GCS restarted between two bursts.
    t0 = time.perf_counter()
    cluster.restart_gcs()
    cluster.wait_for_nodes(timeout_s=60)
    gcs_restart_s = time.perf_counter() - t0
    found = rt.get_actor("llm")
    outs2, st2 = cluster_burst(rt, torch, cfg, found, prompts, want,
                               "phase 42 after the GCS restart")
    print(f"[cluster-gcs-restart] {json.dumps(dict(restart_s=gcs_restart_s, streams=len(outs2), equal_phase29=st2['equal_phase29'], ttft_p50_ms=st2['ttft_p50_ms'], card=card))}")

    # 6. the actor's worker killed: the actor restarts on the card node.
    free_before_kill = mem(torch, "phase 42 before the kill")
    t_kill = time.perf_counter()
    os.kill(where["pid"], signal.SIGKILL)
    deadline = time.monotonic() + 300
    while True:
        # A push the node had not yet seen die fails: ask again until the
        # restarted actor answers.
        try:
            gen = cluster_stream(rt, actor, prompts[1], 32)
            first = next(gen)
            break
        except Exception:  # noqa: BLE001 — the actor is restarting
            if time.monotonic() > deadline:
                fail("phase 42: the actor never came back after the kill")
            time.sleep(0.2)
    restart_s = time.perf_counter() - t_kill
    toks = [first] + list(gen)
    again = rt.get(actor.where.remote(), timeout=600)
    if again["node_id"] != card_node.node_id or \
            again["pid"] == where["pid"] or \
            again["cuda_visible_devices"] != "0":
        fail(f"phase 42: after the kill the actor runs at {again}")
    equal, varied, ties = held_to_phase29(
        torch, cfg, prompts, want, [(1, toks, None)],
        "phase 42 after the worker kill")
    free_after_kill = mem(torch, "phase 42 after the restart")
    kill_st = dict(kill_to_first_token_s=restart_s, new_pid=again["pid"],
                   equal_phase29=equal, prefill_variants=varied,
                   near_ties=len(ties),
                   free_gib_before=free_before_kill / 2**30,
                   free_gib_after=free_after_kill / 2**30, card=card)
    print(f"[cluster-kill] {json.dumps(kill_st)}")

    # Phase 43 on this cluster; it closes and kills the actor.
    p43 = timed("phase 43", cluster_rest_phase, torch, card, dict(
        rt=rt, cluster=cluster, card_node=card_node, actor=actor, cfg=cfg,
        prompts=prompts, want=want, scores42=scores42, st42=st))

    tserve.shutdown()
    # Phase 44 on this cluster.
    p44 = timed("phase 44", cluster_object_phase, torch, card, dict(
        rt=rt, cluster=cluster, card_node=card_node, controller=controller,
        controller_losses=(controller or {}).get("inprocess_losses"),
        objects_before_streams=objects_before_streams))

    # 7. teardown: no child, no runtime thread, no segment, the card back.
    core_rt = rt._private.worker.global_worker().core
    del actor, found
    rt.shutdown()
    cluster_threads = (cluster.gcs.threads()
                       + [t for n in cluster.nodes for t in n.threads()])
    cluster.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    runtime_left = [t.name for t in core_rt.runtime_threads()
                    + cluster_threads if t.is_alive()]
    threads_left = sorted(t.name for t in set(threading.enumerate())
                          - threads0 if t.is_alive())
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and \
            torch.cuda.mem_get_info()[0] < free0 - \
            CLUSTER["mem_slack_gib"] * 2**30:
        time.sleep(0.2)
    free1 = mem(torch, "phase 42 end")
    spill_root = p44["spill_root"]
    spill_left = sorted(os.listdir(spill_root))
    shutil.rmtree(spill_root, ignore_errors=True)
    down = dict(new_segments=sorted(set(shm_segments()) - segs0),
                runtime_threads=runtime_left, threads=threads_left,
                free_gib_start=free0 / 2**30, free_gib_end=free1 / 2**30,
                open_connections=len(rpc._conns), spill_dir_left=spill_left,
                card=card)
    print(f"[cluster-teardown] {json.dumps(down)}")
    if down["new_segments"] or runtime_left or threads_left or \
            spill_left or free1 < free0 - CLUSTER["mem_slack_gib"] * 2**30:
        fail(f"phase 42 teardown left {down}")
    stop_processes()
    print(f"[cluster] launches B4 {st['launches']['paged']} over "
          f"{st['ticks']} ticks, B1 {score_st['b1_launches']} over "
          f"{len(b1)} scores; restart {restart_s:.2f} s, GCS restart "
          f"{gcs_restart_s:.2f} s; {card}")
    return dict(b4_launches=st["launches"]["paged"],
                b1_scoring_launches=score_st["b1_launches"], actor=st,
                score=score_st, gcs_restart=st2, kill=kill_st,
                teardown=down, phase43=p43, phase44=p44)


# ------------------------------ phase 43: the rest of the cluster runtime
# Phase 43's store value (the embedding's shape, bf16) and its seed, the
# deployment's name, and the hop's trials and calls a trial.
CLUSTER_REST = dict(store_shape=(128256, 4096), store_seed=43,
                    serve_name="cluster-llm", hop_trials=3, hop_calls=60)


def cluster_store(torch, card, ctx):
    """Phase 43's ``[cluster-store]`` (module docstring)."""
    rt, cluster, actor = ctx["rt"], ctx["cluster"], ctx["actor"]
    core = rt._private.worker.global_worker().core
    du = shutil.disk_usage("/dev/shm")
    shape = CLUSTER_REST["store_shape"]
    nbytes = shape[0] * shape[1] * 2
    print(f"[cluster-store] /dev/shm total {du.total} free {du.free} "
          f"bytes; the value takes {nbytes}")
    if du.free < nbytes:
        fail(f"phase 43: /dev/shm has {du.free} bytes free, the store "
             f"value needs a segment of {nbytes}")
    gen = torch.Generator(device="cuda").manual_seed(
        CLUSTER_REST["store_seed"])
    on_card = torch.randn(*shape, dtype=torch.bfloat16, device="cuda",
                          generator=gen)
    want_sum = float(on_card.sum(dtype=torch.float32))
    host = on_card.cpu()
    del on_card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = rt.put(host)
    put_s = time.perf_counter() - t0
    del host
    seg = f"rtst-{ref.id().hex()}"
    stats = {n.node_id[:12]: dict(zip(("used_bytes", "objects"),
                                      n.store_stats()))
             for n in cluster.nodes}
    got = rt.get(actor.take.remote([ref]), timeout=900)
    core.free([ref])
    gone = seg not in os.listdir("/dev/shm")
    st = dict(bytes=nbytes, put_s=put_s, put_gb_s=nbytes / put_s / 1e9,
              get_s=got["get_s"], get_gb_s=nbytes / got["get_s"] / 1e9,
              upload_s=got["upload_s"], zero_copy=got["zero_copy"],
              mapping=got["mapping"], sum=got["sum"], driver_sum=want_sum,
              sum_equal=got["sum"] == want_sum, node_stores=stats,
              segment_gone_after_free=gone, card=card)
    print(f"[cluster-store] {json.dumps(st)}")
    if not got["zero_copy"] or got["sum"] != want_sum or \
            got["dtype"] != "torch.bfloat16" or got["shape"] != list(shape) \
            or not gone or not any(v["used_bytes"] >= nbytes
                                   for v in stats.values()):
        fail(f"phase 43 store: {st}")
    return st


def cluster_dag(torch, card, ctx):
    """Phase 43's ``[cluster-dag]`` (module docstring)."""
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    rt, cluster, actor, cfg = (ctx["rt"], ctx["cluster"], ctx["actor"],
                               ctx["cfg"])
    prompts, want = ctx["prompts"], ctx["want"]
    segs0 = {n for n in shm_segments() if n.startswith("rtch-")}
    head = NodeAffinitySchedulingStrategy(cluster.head_node.node_id,
                                          soft=False)
    source = rt.remote(num_cpus=1, scheduling_strategy=head)(
        CoreRequests).remote([(p, w) for p, w in zip(prompts, want)])
    with InputNode() as i:
        dag = actor.score.bind(source.make.bind(i))
    compiled = dag.experimental_compile()
    if not compiled._channel_mode:
        fail("phase 43: the scoring DAG over the cluster did not compile "
             "to channels")
    b1, equal = [], 0
    for i in range(len(prompts)):
        before = rt.get(actor.launch_counts.remote(), timeout=600)["fwd"]
        lp = rt.get(compiled.execute(i), timeout=600)
        b1.append(rt.get(actor.launch_counts.remote(), timeout=600)["fwd"]
                  - before)
        equal += list(lp) == list(ctx["scores42"][i])
    compiled.teardown()
    hop_cls = rt.remote(num_cpus=0, scheduling_strategy=head)(CoreHop)
    a, b = hop_cls.remote(), hop_cls.remote()
    with InputNode() as i:
        hop = b.f.bind(i)
    hops = hop.experimental_compile()
    rt.get(hops.execute(0), timeout=60)
    rt.get(a.f.remote(0), timeout=60)
    dag_s = remote_s = float("inf")
    n = CLUSTER_REST["hop_calls"]
    for _ in range(CLUSTER_REST["hop_trials"]):
        dag_s = min(dag_s, sum(call_seconds(
            lambda k: rt.get(hops.execute(k), timeout=60), n)) / n)
        remote_s = min(remote_s, sum(call_seconds(
            lambda k: rt.get(a.f.remote(k), timeout=60), n)) / n)
    hops.teardown()
    for h in (source, a, b):
        rt.kill(h)
    left = sorted({n for n in shm_segments() if n.startswith("rtch-")}
                  - segs0)
    st = dict(scores=len(b1), bitwise_equal=equal, b1_launches=sum(b1),
              channel_mode=True, hop_us=dag_s * 1e6,
              remote_us=remote_s * 1e6, ratio=remote_s / dag_s,
              beside="phase 37's compiled hop 209-351 us in local mode",
              rtch_left=left, card=card)
    print(f"[cluster-dag] {json.dumps(st)}")
    if equal != len(b1) or any(x != cfg.num_layers for x in b1) or left:
        fail(f"phase 43 DAG: {st}")
    return st


def cluster_serve(torch, card, ctx):
    """Phase 43's ``[cluster-serve]`` (module docstring)."""
    from ray_tpu_torch.runtime.cluster_replica import ClusterReplica
    from ray_tpu_torch.serve import api as serve_api

    rt, card_node, actor, cfg = (ctx["rt"], ctx["card_node"], ctx["actor"],
                                 ctx["cfg"])
    prompts, want, name = ctx["prompts"], ctx["want"], \
        CLUSTER_REST["serve_name"]
    rt.get(actor.close.remote(), timeout=600)
    rt.kill(actor, no_restart=True)
    t0 = time.perf_counter()
    h = tserve.run(tserve.deployment(
        CountingLlm, name=name, num_replicas=2, max_ongoing_requests=16,
        ray_actor_options={"num_gpus": 0.5}).bind(
        config=cfg, num_slots=CORE["num_slots"], max_len=CORE["max_len"],
        prefix_cache=False))
    deploy_s = time.perf_counter() - t0
    reps = serve_api._get_controller().get_replicas(name)
    where = [dict(replica=r.replica_id, pid=r.pid,
                  node_id=r.info.get("node_id"),
                  cuda_visible_devices=r.info.get("cuda_visible_devices"))
             for r in reps]
    print(f"[cluster-serve] deployed in {deploy_s:.2f} s: "
          f"{json.dumps(where)}; card node {card_node.node_id}; {card}")
    if len(reps) != 2 or not all(isinstance(r, ClusterReplica)
                                 for r in reps) or \
            {w["node_id"] for w in where} != {card_node.node_id} or \
            {w["cuda_visible_devices"] for w in where} != {"0"} or \
            len({w["pid"] for w in where}) != 2 or \
            not {w["pid"] for w in where} <= set(card_node.worker_pids()):
        fail(f"phase 43: the replicas run at {where}, not as two cluster "
             f"actors on the card node")

    def stream(prompt, n):
        return h.options("generate", stream=True).remote(prompt, n)

    for r in reps:                              # one warm-up each
        st = r.stream("generate", (prompts[0][:16], 2), {})
        while True:
            try:
                st.next(600)
            except StopIteration:
                break
    def store_objects():
        return sum(n.store_stats()[1] for n in ctx["cluster"].nodes)

    c0 = {r.replica_id: replica_counters(r, reset=True) for r in reps}
    objects0 = store_objects()
    outs, ttft, wall = stream_all(lambda i: stream(prompts[i], 32),
                                  len(prompts))
    c1 = {r.replica_id: replica_counters(r) for r in reps}
    # Each streamed token is a node-store object the handle's stream
    # reads once and frees: the streams leave the stores' counts as
    # they were (the frees run off the reader's thread).
    deadline = time.monotonic() + 20
    while store_objects() > objects0 and time.monotonic() < deadline:
        time.sleep(0.1)
    objects1 = store_objects()
    if objects1 > objects0:
        fail(f"phase 43: the node stores held {objects0} objects before "
             f"the 12 streams and {objects1} after")
    per = {}
    for rid in c1:
        ticks = c1[rid]["ticks"] - c0[rid]["ticks"]
        per[rid] = dict(ticks=ticks, b4=c1[rid]["paged"],
                        dense=c1[rid]["dense"],
                        tick_s=c1[rid]["tick_s"] - c0[rid]["tick_s"])
        if per[rid]["b4"] != cfg.num_layers * ticks or not ticks or \
                per[rid]["dense"]:
            fail(f"phase 43: replica {rid} launched B4 {per[rid]['b4']} "
                 f"(dense {per[rid]['dense']}) over {ticks} ticks")
    check_outputs(outs, 32, cfg.vocab_size, "phase 43")
    equal, varied, ties = held_to_phase29(
        torch, cfg, prompts, want, [(i, o, None) for i, o in
                                    enumerate(outs)], "phase 43")
    ticks = sum(v["ticks"] for v in per.values())
    burst = dict(streams=len(outs), equal_phase29=equal,
                 prefill_variants=varied, near_ties=len(ties),
                 store_objects=[objects0, objects1],
                 ttft_p50_ms=float(np.median(ttft)) * 1e3, wall_s=wall,
                 tick_ms=sum(v["tick_s"] for v in per.values())
                 / max(ticks, 1) * 1e3, replicas=per,
                 b4_launches=sum(v["b4"] for v in per.values()),
                 beside={"what": "phase 42's cluster actor",
                         **{k: ctx["st42"].get(k) for k in (
                             "ttft_p50_ms", "tick_ms")}}, card=card)
    # One score through the handle: B1 at num_layers, in one replica.
    f0 = {r.replica_id: replica_counters(r, reset=True)["flash_fwd"]
          for r in reps}
    lp = h.score_logprobs.remote(prompts[0], want[0]).result(timeout_s=600)
    b1 = sum(replica_counters(r)["flash_fwd"] for r in reps)
    arr = np.asarray(lp)
    # The same weights, inputs and kernels as phase 42's first score.
    equal = list(lp) == list(ctx["scores42"][0])
    if b1 != cfg.num_layers or arr.shape != (CORE["new"],) or not (
            np.all(np.isfinite(arr)) and np.all(arr <= 0)) or not equal:
        fail(f"phase 43: score_logprobs launched B1 {b1} times, logprobs "
             f"{arr[:4]}..., equal to phase 42's bit for bit: {equal}")
    burst.update(score_b1_launches=b1, score_equal_phase42=equal)
    print(f"[cluster-serve] {json.dumps(burst)}")
    del f0
    # One replica's worker killed: the next stream through the handle
    # passes after its refresh-and-retry. The handle's table is left
    # holding only the replica about to die (a handle that has not heard
    # of the death yet; the router would otherwise steer clear of a
    # replica whose load probe goes unanswered), so the first attempt
    # lands on the dead one.
    victim = reps[0]
    router = h._router
    with router.lock:
        router.replicas, router.dirty, router.inflight = [victim], False, {}
    t_kill = time.perf_counter()
    os.kill(victim.pid, signal.SIGKILL)
    attempts, errors, deadline = 0, [], time.monotonic() + 300
    while True:
        attempts += 1
        gen = stream(prompts[1], 32)
        try:
            first = next(gen)
            break
        except rt.exceptions.ActorDiedError as e:
            errors.append(f"{type(e).__name__} from "
                          f"{gen._replica.replica_id}")
            if time.monotonic() > deadline:
                fail("phase 43: no stream got through after the kill")
    kill_s = time.perf_counter() - t_kill
    toks = [first] + [int(t) for t in gen]
    equal_k, varied_k, ties_k = held_to_phase29(
        torch, cfg, prompts, want, [(1, toks, None)],
        "phase 43 after the replica kill")
    kill_st = dict(kill_to_first_token_s=kill_s, attempts=attempts,
                   first_attempts=errors,
                   table_after=[r.replica_id for r in h._replicas],
                   served_by=gen._replica.replica_id,
                   killed=victim.replica_id, equal_phase29=equal_k,
                   prefill_variants=varied_k, near_ties=len(ties_k),
                   card=card)
    print(f"[cluster-serve-kill] {json.dumps(kill_st)}")
    if gen._replica is victim or attempts < 2:
        fail(f"phase 43: after the kill the handle did not retry off the "
             f"dead replica: {kill_st}")
    return dict(burst=burst, kill=kill_st, deploy_s=deploy_s, where=where)


def cluster_rest_phase(torch, card, ctx):
    """Phase 43: the store, the compiled DAG and serve on phase 42's
    cluster (module docstring); phase 42's teardown follows."""
    store = cluster_store(torch, card, ctx)
    dag = cluster_dag(torch, card, ctx)
    served = cluster_serve(torch, card, ctx)
    print(f"[cluster-rest] launches B4 {served['burst']['b4_launches']} "
          f"over the two replicas, B1 {dag['b1_launches']} over "
          f"{dag['scores']} DAG scores; put {store['put_gb_s']:.2f} GB/s, "
          f"get {store['get_gb_s']:.2f} GB/s; hop {dag['hop_us']:.0f} us; "
          f"{card}")
    return dict(store=store, dag=dag, serve=served,
                b4_launches=served["burst"]["b4_launches"],
                b1_dag_launches=dag["b1_launches"])


# ------------------------- phase 44: the trainer and the object plane on
# phase 42's cluster (ROADMAP fault C9 and item 20b).
# [cluster-train]'s steps; [cluster-refcount]'s wait for the stores to
# empty and for the dropped put's segment; [cluster-lineage]'s tensor (64 MB
# of fp32) and seed; [cluster-spill]'s seeds, each one tensor of phase 43's
# embedding shape, and the spill node's store budget: one tensor (1.05 GB)
# fits, two do not, and one stays under the high-water mark.
CLUSTER_OBJ = dict(train_steps=4, refcount_s=30.0, del_gone_s=5.0,
                   lineage_elems=16 << 20, lineage_seed=44,
                   spill_seeds=(45, 46, 47), spill_budget=int(1.25e9))


def cluster_train_loop(config):
    """Phase 44's train loop, in a cluster actor the GCS placed on the
    card node: phase 34's model, batch and loop from init for
    ``config["steps"]`` steps, each record with the worker's node, pid and
    ``CUDA_VISIBLE_DEVICES`` and the wall time it went out."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch._private import worker as worker_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = worker_mod.global_worker_or_none()
    where = dict(pid=os.getpid(), cuda_visible_devices=os.environ.get(
                     "CUDA_VISIBLE_DEVICES"),
                 node_id=w.core.node_id.hex() if w is not None else "",
                 device=torch.cuda.get_device_name(0))
    trainer = _ckpt_trainer()
    state = trainer.init_state(0)

    def report(recs):
        for r in recs:
            train.report(dict(r, ts=time.time(), **where))

    controller_steps(torch, trainer, state, 0, None, report,
                     steps=config["steps"])


def lineage_tensor(seed, n):
    """``[cluster-lineage]``'s task: the node it ran on and n fp32 values
    drawn from ``seed`` on the CPU."""
    import torch

    import ray_tpu_torch as rt

    g = torch.Generator().manual_seed(seed)
    return dict(node_id=rt.get_runtime_context().get_node_id(),
                tensor=torch.randn(n, generator=g))


def spill_tensor(seed, shape):
    """A bf16 tensor of ``shape`` whose bytes ``seed`` draws (numpy's
    generator: the same bits in any process, at GB/s)."""
    import torch

    n = shape[0] * shape[1] * 2
    raw = np.random.default_rng(seed).bytes(n)
    return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(
        shape)


class SpillPutter:
    """``[cluster-spill]``'s actor on the small-store node: puts its
    tensors and keeps their refs for its life."""

    def __init__(self):
        self.refs = []

    def put_all(self, seeds, shape):
        import ray_tpu_torch as rt

        t0 = time.perf_counter()
        for s in seeds:
            self.refs.append(rt.put(spill_tensor(s, shape)))
        return list(self.refs), time.perf_counter() - t0


def arg_node(x):
    """``[cluster-locality]``'s task: the node it ran on and its
    argument's shape."""
    import ray_tpu_torch as rt

    return rt.get_runtime_context().get_node_id(), list(x.shape)


def core_actors(rt):
    """The GCS's actor table (every namespace)."""
    from ray_tpu_torch._private import messages as pb

    core = rt._private.worker.global_worker().core
    return list(core.gcs.ListActors(pb.ListActorsRequest(
        all_namespaces=True)).actors)


def _store_objects(cluster):
    return sum(n.store_stats()[1] for n in cluster.nodes)


def cluster_train(torch, card, ctx):
    """Phase 44's ``[cluster-train]`` (module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.runtime.controller import CARDS

    steps, L = CLUSTER_OBJ["train_steps"], CKPT["layers"]
    per_step = {"fwd": 2 * L, "dq": L, "dkv": L}
    want = ctx["controller_losses"]
    if want is None:
        # No phase 34 in this run (--cluster): its loop here, as it runs
        # there.
        trainer = _ckpt_trainer()
        recs = []
        controller_steps(torch, trainer, trainer.init_state(0), 0, None,
                         recs.extend, steps=steps)
        want = [r["loss"] for r in recs]
        del trainer, recs
        gc.collect()
        torch.cuda.empty_cache()
    want = want[:steps]
    card_node = ctx["card_node"]

    def card_gpu():
        return [n["Available"].get("GPU") for n in rt.nodes()
                if n["NodeID"] == card_node.node_id]

    # Serve's replicas and phase 42's actor are gone: the card is free.
    deadline = time.monotonic() + 60
    while card_gpu() != [1.0] and time.monotonic() < deadline:
        time.sleep(0.1)
    if card_gpu() != [1.0]:
        fail(f"phase 44 train: the card node's available GPU reads "
             f"{card_gpu()} before the run (actors: "
             f"{[(a.name, a.state, a.node_id[:8]) for a in core_actors(rt)]})")
    book0 = CARDS.use()
    seen, stop = [], threading.Event()

    def watch():
        while not stop.is_set():
            gpu = [n["Available"].get("GPU") for n in rt.nodes()
                   if n["NodeID"] == card_node.node_id]
            seen.append((gpu[0] if gpu else None, CARDS.use()))
            time.sleep(0.1)

    watcher = threading.Thread(target=watch, name="phase44-watch")
    gpu_before = card_gpu()
    tmp, _ = _scratch_dir(1 << 30, "phase 44 train")
    watcher.start()
    try:
        t0 = time.time()
        result = train.TorchTrainer(
            cluster_train_loop, train_loop_config={"steps": steps},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(name="phase44",
                                       storage_path=tmp)).fit()
        fit_s = time.time() - t0
    finally:
        stop.set()
        watcher.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if result.error is not None:
        fail(f"phase 44 train: fit failed: {result.error!r}")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and card_gpu() != [1.0]:
        time.sleep(0.1)
    gpu_after = card_gpu()
    recs = [h["metrics"] for h in result.metrics_history]
    got = [r["loss"] for r in recs]
    where = {(r["node_id"], r["pid"], r["cuda_visible_devices"])
             for r in recs}
    launches = {k: sum(r["launches"][k] for r in recs) for k in per_step}
    ref34 = ctx["controller"] or {}
    st = dict(steps=len(recs), losses=got, inprocess_losses=want,
              bitwise_equal=got == want,
              worker=[dict(node_id=n, pid=p, cuda_visible_devices=c)
                      for n, p, c in where],
              card_node=card_node.node_id,
              step_ms=float(np.median([r["step_ms"] for r in recs])),
              beside=dict(what="phase 34's worker (median after its "
                               "first window) and in-process loop",
                          step_ms=ref34.get("step_ms"),
                          inprocess_step_ms=ref34.get("inprocess_step_ms")),
              fit_to_first_report_s=min(r["ts"] for r in recs) - t0,
              fit_s=fit_s,
              card_gpu_available_before=gpu_before,
              card_gpu_available_during=min(g for g, _ in seen
                                            if g is not None),
              card_gpu_available_after=gpu_after,
              cards_book=[book0, sorted({json.dumps(b, sort_keys=True)
                                         for _, b in seen}), CARDS.use()],
              launches=launches, launches_per_step=per_step, card=card)
    print(f"[cluster-train] {json.dumps(st)}")
    if got != want:
        print(f"[cluster-finding] the cluster worker's losses {got} differ "
              f"from the in-process loop's {want}")
    if len(recs) != steps or got != want or len(where) != 1 or \
            next(iter(where))[0] != card_node.node_id or \
            next(iter(where))[2] != "0" or \
            next(iter(where))[1] == os.getpid() or \
            any(r["launches"] != per_step for r in recs) or \
            st["card_gpu_available_during"] != 0.0 or gpu_after != [1.0] or \
            any(b != book0 for _, b in seen) or CARDS.use() != book0:
        fail(f"phase 44 train: {st}")
    return st


def cluster_refcount(torch, card, ctx):
    """Phase 44's ``[cluster-refcount]`` (module docstring)."""
    rt, cluster = ctx["rt"], ctx["cluster"]
    before = ctx["objects_before_streams"]
    t0 = time.perf_counter()
    deadline = time.monotonic() + CLUSTER_OBJ["refcount_s"]
    while _store_objects(cluster) > before and time.monotonic() < deadline:
        time.sleep(0.1)
    empty_s = time.perf_counter() - t0
    after = _store_objects(cluster)
    shape = CLUSTER_REST["store_shape"]
    gen = torch.Generator(device="cuda").manual_seed(
        CLUSTER_REST["store_seed"])
    host = torch.randn(*shape, dtype=torch.bfloat16, device="cuda",
                       generator=gen).cpu()
    torch.cuda.empty_cache()
    ref = rt.put(host)
    seg = f"rtst-{ref.id().hex()}"
    there = seg in os.listdir("/dev/shm")
    del host, ref
    gc.collect()
    t0 = time.perf_counter()
    while seg in os.listdir("/dev/shm") and \
            time.perf_counter() - t0 < CLUSTER_OBJ["del_gone_s"]:
        time.sleep(0.01)
    gone_s = time.perf_counter() - t0
    gone = seg not in os.listdir("/dev/shm")
    st = dict(objects_before_phase42_streams=before, objects_now=after,
              wait_s=empty_s, put_segment_made=there,
              del_to_segment_gone_s=gone_s, segment_gone=gone,
              bytes=shape[0] * shape[1] * 2, card=card)
    print(f"[cluster-refcount] {json.dumps(st)}")
    if after > before or not there or not gone:
        fail(f"phase 44 refcount: {st}")
    return st


def cluster_lineage(torch, card, ctx):
    """Phase 44's ``[cluster-lineage]`` (module docstring)."""
    from ray_tpu_torch._private import messages as pb
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    rt, cluster = ctx["rt"], ctx["cluster"]
    core = rt._private.worker.global_worker().core
    node = cluster.add_node(num_cpus=2, resources={"pin": 1.0})
    cluster.wait_for_nodes()
    n, seed = CLUSTER_OBJ["lineage_elems"], CLUSTER_OBJ["lineage_seed"]
    task = rt.remote(num_cpus=1, scheduling_strategy=(
        NodeAffinitySchedulingStrategy(node.node_id, soft=True)))(
        lineage_tensor)
    ref = task.remote(seed, n)
    rt.wait([ref], num_returns=1, timeout=300, fetch_local=False)
    locs = list(core.gcs.GetObjectLocations(pb.GetObjectLocationsRequest(
        object_id=ref.binary())).node_ids)
    want = torch.randn(n, generator=torch.Generator().manual_seed(seed))
    cluster.remove_node(node, allow_graceful=False)
    t0 = time.perf_counter()
    got = rt.get(ref, timeout=300)
    rebuild_s = time.perf_counter() - t0
    st = dict(bytes=n * 4, first_locations=locs, removed=node.node_id,
              rebuilt_on=got["node_id"], get_to_value_s=rebuild_s,
              bitwise_equal=bool(torch.equal(got["tensor"], want)),
              card=card)
    print(f"[cluster-lineage] {json.dumps(st)}")
    if locs != [node.node_id] or got["node_id"] == node.node_id or \
            not st["bitwise_equal"]:
        fail(f"phase 44 lineage: {st}")
    del got, ref
    return st


def cluster_spill(torch, card, ctx):
    """Phase 44's ``[cluster-spill]`` and ``[cluster-locality]`` (module
    docstring)."""
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    rt, cluster = ctx["rt"], ctx["cluster"]
    core = rt._private.worker.global_worker().core
    shape = CLUSTER_REST["store_shape"]
    nbytes = shape[0] * shape[1] * 2
    seeds = CLUSTER_OBJ["spill_seeds"]
    spill_root, free = _scratch_dir(int(1.2 * len(seeds) * nbytes),
                                    "phase 44 spill")
    spill_dir = os.path.join(spill_root, "spill")
    old = os.environ.get("RAY_TPU_OBJECT_STORE_BYTES")
    os.environ["RAY_TPU_OBJECT_STORE_BYTES"] = str(CLUSTER_OBJ["spill_budget"])
    try:
        node = cluster.add_node(num_cpus=2, spill_dir=spill_dir)
    finally:
        if old is None:
            os.environ.pop("RAY_TPU_OBJECT_STORE_BYTES")
        else:
            os.environ["RAY_TPU_OBJECT_STORE_BYTES"] = old
    cluster.wait_for_nodes()
    putter = rt.remote(num_cpus=1, scheduling_strategy=(
        NodeAffinitySchedulingStrategy(node.node_id, soft=False)))(
        SpillPutter).remote()
    refs, put_s = rt.get(putter.put_all.remote(list(seeds), list(shape)),
                         timeout=600)
    spilled_after_puts = dict(node.spill_stats)
    # [cluster-locality]: a CPU task on one of them, which no process
    # but its node holds, leases where it lives.
    where = rt.remote(num_cpus=1)(arg_node)
    ran_on, arg_shape = rt.get(where.remote(refs[0]), timeout=600)
    loc = dict(ran_on=ran_on, holder=node.node_id,
               head=cluster.head_node.node_id, arg_shape=arg_shape,
               arg_bytes=nbytes, card=card)
    print(f"[cluster-locality] {json.dumps(loc)}")
    if ran_on != node.node_id or arg_shape != list(shape):
        fail(f"phase 44 locality: {loc}")
    equal = []
    for s, ref in zip(seeds, refs):
        got = rt.get(ref, timeout=600)
        want = spill_tensor(s, shape)
        equal.append(bool(torch.equal(got.view(torch.int16),
                                      want.view(torch.int16))))
        core.memory.delete([ref.id()])
        del got, want
    stats = dict(node.spill_stats)
    st = dict(budget=CLUSTER_OBJ["spill_budget"], tensor_bytes=nbytes,
              tensors=len(seeds), put_s=put_s,
              spilled_during_puts=spilled_after_puts["spilled"],
              bitwise_equal=equal, spill_dir=spill_dir, disk_free=free,
              spill_gb_s=stats["spilled_bytes"] / max(stats["spill_s"],
                                                      1e-9) / 1e9,
              restore_gb_s=stats["restored_bytes"] / max(
                  stats["restore_s"], 1e-9) / 1e9, **stats, card=card)
    print(f"[cluster-spill] {json.dumps(st)}")
    if not all(equal) or spilled_after_puts["spilled"] < 2:
        fail(f"phase 44 spill: {st}")
    rt.kill(putter)
    del refs
    return st, spill_root


def cluster_object_phase(torch, card, ctx):
    """Phase 44: the trainer's workers as cluster actors and the object
    plane, on phase 42's cluster (module docstring)."""
    train_st = cluster_train(torch, card, ctx)
    refcount = cluster_refcount(torch, card, ctx)
    lineage = cluster_lineage(torch, card, ctx)
    spill, spill_root = cluster_spill(torch, card, ctx)
    print(f"[cluster-objects] launches B1 {train_st['launches']['fwd']} "
          f"B2 {train_st['launches']['dq']} B3 {train_st['launches']['dkv']}"
          f" in the cluster worker; del to segment gone "
          f"{refcount['del_to_segment_gone_s']:.3f} s; rebuild "
          f"{lineage['get_to_value_s']:.2f} s; spill "
          f"{spill['spill_gb_s']:.2f} GB/s, restore "
          f"{spill['restore_gb_s']:.2f} GB/s; {card}")
    return dict(train=train_st, refcount=refcount, lineage=lineage,
                spill=spill, spill_root=spill_root,
                launches=train_st["launches"])


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def paged_host_us(torch, root):
    """``--paged-host-us ROOT``: host microseconds a paged call takes with
    ROOT's ``ray_tpu_torch``, for each phase-3 case at 32 table entries."""
    sys.path.insert(0, os.path.abspath(root))
    from ray_tpu_torch.ops.paged_decode_attention import (
        paged_decode_attention)

    out = {}
    for name, q_kind, kind, nb, positions, _, _ in CASES:
        if nb != SHAPE["NB"]:
            continue
        c = make_case(torch, kind, q_kind, seed=0, nb=nb,
                      positions=positions)
        args = (c["q"], c["k"], c["v"], c["tables"], c["pos"])
        kw = dict(k_scale=c["ks"], v_scale=c["vs"])
        out[name] = host_us(torch, lambda: paged_decode_attention(
            *args, use_kernel=True, **kw))
    print("[host] " + json.dumps(dict(root=root, us_per_call=out)))


def dense_ms(torch, root):
    """``--dense-ms ROOT``: the dense kernel of ROOT's ``ray_tpu_torch``
    at the timed phase-12 cases: kernel ms (L2 flushed) and host
    microseconds a call."""
    sys.path.insert(0, os.path.abspath(root))
    from ray_tpu_torch.ops.decode_attention import decode_attention

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for i, (name, kind, s_max, layers, positions, _, _) in enumerate(
            DENSE_CASES):
        if name not in DENSE_TIMED:
            continue
        c = dense_case(torch, name, kind, s_max, layers, positions,
                       seed=20 + i)
        args = (c["q"], c["k"], c["v"], c["pos"])
        out[name] = dict(
            ms=time_ms(torch, lambda: decode_attention(*args,
                                                       use_kernel=True),
                       flush),
            host_us=host_us(torch, lambda: decode_attention(
                *args, use_kernel=True)))
        del c, args
    print("[dense-ms] " + json.dumps(dict(root=root, cases=out)))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "one CUDA GPU")
    if sys.argv[1:2] == ["--paged-host-us"]:
        print(card_line())
        paged_host_us(torch, sys.argv[2])
        return
    if sys.argv[1:2] == ["--mesh-check"]:
        print(card_line())
        sections = tuple(sys.argv[2:]) or MESH_SECTIONS
        if not set(sections) <= set(MESH_SECTIONS):
            fail(f"--mesh-check sections {sections}: each one of "
                 f"{MESH_SECTIONS}")
        mesh_check(torch, sections)
        return
    if sys.argv[1:2] == ["--train-controller"]:
        from ray_tpu_torch.ops import _build

        card = card_line()
        print(card)
        _build.build_all()
        timed("phase 34", controller_phase, torch, card)
        return
    if sys.argv[1:2] == ["--rl"]:
        from ray_tpu_torch.ops import _build

        card = card_line()
        print(card)
        _build.build_all()
        timed("phase 35", rl_phase, torch, card)
        stop_processes()
        return
    if sys.argv[1:2] == ["--rllib"]:
        from ray_tpu_torch.ops import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(card)
        _build.build_all()
        timed("phase 36", rllib_phase, torch, card)
        stop_processes()
        return
    if sys.argv[1:2] == ["--core"]:
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops import _build

        card = card_line()
        print(card)
        _build.build_all()
        prompts = phase5_prompts(llama.LlamaConfig.llama3_8b())
        phase29 = timed("phase 37's yardstick", core_yardstick, torch, card,
                        prompts)
        timed("phase 37", core_phase, torch, card, prompts, phase29)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:2] == ["--pool"]:
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops import _build

        card = card_line()
        print(card)
        _build.build_all()
        prompts = phase5_prompts(llama.LlamaConfig.llama3_8b())
        phase29 = timed("phase 41's yardstick", core_yardstick, torch, card,
                        prompts)
        timed("phase 41", phase41, torch, card, prompts, phase29)
        stop_processes()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:2] == ["--cluster"]:
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops import _build

        card = card_line()
        print(card)
        _build.build_all()
        prompts = phase5_prompts(llama.LlamaConfig.llama3_8b())
        phase29 = timed("phase 42's yardstick", core_yardstick, torch, card,
                        prompts)
        timed("phases 42-44", cluster_phase, torch, card, prompts,
              phase29)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:2] == ["--graph"]:
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops import _build

        card = card_line()
        print(card)
        _build.build_all()
        prompts = phase5_prompts(llama.LlamaConfig.llama3_8b())
        phase29 = timed("phase 40's yardstick", core_yardstick, torch, card,
                        prompts)
        timed("phase 40", graph_phase, torch, card, prompts, phase29)
        stop_processes()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:2] in (["--data"], ["--tune"], ["--data-pool"]):
        from ray_tpu_torch.ops import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(card)
        _build.build_all()
        if sys.argv[1] == "--data":
            timed("phase 38", data_phase, torch, card)
        elif sys.argv[1] == "--data-pool":
            import ray_tpu_torch as rt

            rt.init()
            try:
                timed("phase 38c", data_llm_pool, torch, card)
            finally:
                rt.shutdown()
        else:
            timed("phase 39", tune_phase, torch, card)
        stop_processes()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if sys.argv[1:2] == ["--dense-ms"]:
        print(card_line())
        dense_ms(torch, sys.argv[2])
        return
    if sys.argv[1:2] == ["--channel-mbs"]:
        print(card_line())
        channel_mbs()
        return
    if sys.argv[1:2] == ["--runtime-ttft"]:
        from ray_tpu_torch.ops import _build

        card = card_line()
        print(card)
        _build.build_all()
        runtime_ttft(torch, card)
        return
    if sys.argv[1:2] == ["--serve-ticks"]:
        from ray_tpu_torch.ops import _build

        card = card_line()
        print(card)
        _build.build_all()
        serve_ticks(torch, card)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    from ray_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {built or 'cached'} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in _build.sources():
        with open(_build.lib_path(name)[:-3] + ".log") as f:
            log = f.read()
        for family, (regs, spills) in build_report(log).items():
            print(f"[build] {name}: {family}: {len(regs)} kernels, "
                  f"registers {min(regs)}-{max(regs)}, spill stores up to "
                  f"{max(spills)} bytes")

    from ray_tpu_torch.ops import attention as fa

    timing = timed("phases 3-4", kernel_phases, torch)
    dense = timed("phases 11-12", dense_kernel_phases, torch)
    runs, served = timed("phases 5, 13, 15, 17, 18, 19, 21", end_to_end,
                         torch, card)
    parity = timed("phases 6, 14, 16, 20, 22", engine_parity, torch)
    serving = timed("phases 29-33", serve_phases, torch, card, served,
                    parity)
    flash = timed("phases 7-8", flash_phases, torch)
    timed("phase 9", model_parity, torch)
    train = timed("phase 10", train_end_to_end, torch, card)
    timed("phase 23", mixtral_parity, torch)
    mix = timed("phase 24", mixtral_train, torch, card)
    sharded, seq, mix_mesh, _ = timed("phases 25-28", sharded_train, torch,
                                      card, train, mix)
    controller = timed("phase 34", controller_phase, torch, card)
    rl = timed("phase 35", rl_phase, torch, card)
    timed("phase 36", rllib_phase, torch, card)
    core = timed("phase 37", core_phase, torch, card, served[0],
                 serving["deploy"])
    data = timed("phase 38", data_phase, torch, card, controller)
    tuned = timed("phase 39", tune_phase, torch, card)
    graph = timed("phase 40", graph_phase, torch, card, served[0],
                  serving["deploy"])
    pooled = timed("phase 41", phase41, torch, card, served[0],
                   serving["deploy"])
    clustered = timed("phases 42-44", cluster_phase, torch, card,
                      served[0], serving["deploy"], core, controller)

    main_case = timing["bf16"]
    record = {"kernels": [dict(
        name="paged_decode_attention", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode_attention.cu",
        replaces="ray_tpu/ops/paged_decode_attention.py:90",
        launches=runs["bf16"]["launches"]["paged"],
        spec_launches=runs["spec"]["self-bf16"]["launches"]["paged"],
        split_launches=runs["split"]["bf16"]["launches"]["paged"],
        deployment_launches=serving["deploy"]["launches"]["paged"],
        replica_launches=serving["runtime"]["launches"]["paged"],
        disagg_launches=serving["disagg"]["launches"]["paged"],
        observe_launches=serving["observe"]["launches"]["paged"],
        rl_launches=rl["b4_launches"],
        core_launches=core["b4_launches"],
        batch_launches=data["batch_launches"],
        graph_launches=graph["graph_launches"],
        workflow_launches=graph["workflow"]["workflow_launches"],
        autoscale_launches=pooled["autoscale"]["autoscale_launches"],
        pool_launches=pooled["pool"]["b4_launches"],
        cluster_launches=clustered["b4_launches"],
        cluster_serve_launches=clustered["phase43"]["b4_launches"],
        max_abs_err=main_case["max_abs_err"],
        ms=main_case["ms"], kernel_ms=main_case["ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"], library_ms=main_case["library_ms"],
        card=card, variants=timing)]}
    main_flash = flash["bf16"]
    for n in ("fwd", "dq", "dkv"):
        record["kernels"].append(dict(
            name=f"flash_{n}", route="cuda",
            source="ray_tpu_torch/ops/csrc/"
                   f"{fa.kernel_route(n, torch.bfloat16)[0]}.cu",
            replaces=FLASH_REPLACES[n], launches=train["launches"][n],
            mixtral_launches=mix["launches"][n],
            mixtral_mesh_launches=mix_mesh["launches"][n],
            sharded_launches=sharded["launches"][n],
            controller_launches=controller["launches"][n],
            cluster_train_launches=int(
                clustered["phase44"]["launches"][n]),
            ulysses_launches=seq["ulysses"]["launches"][n],
            rl_launches=rl["learner_launches"][n],
            data_launches=data["data_launches"][n],
            tune_launches=tuned["tune_launches"][n],
            **({"deployment_scoring_launches":
                serving["deploy"]["scoring_launches"],
                "rl_scoring_launches": rl["b1_scoring_launches"],
                "core_scoring_launches": core["b1_scoring_launches"],
                "cluster_scoring_launches":
                    clustered["b1_scoring_launches"],
                "cluster_dag_launches":
                    clustered["phase43"]["b1_dag_launches"],
                "workflow_scoring_launches":
                    graph["workflow"]["workflow_scoring_launches"]}
               if n == "fwd" else {}),
            max_abs_err=main_flash["max_abs_err"][n],
            ms=main_flash["ms"][n], plain_ms=main_flash["plain_ms"][n],
            bound_ms=main_flash["bound"][n][0],
            bound_by=main_flash["bound"][n][1],
            library_ms=main_flash["library_ms"][n], card=card,
            variants={name: {key: (val[n] if isinstance(val, dict)
                                   else val) for key, val in res.items()}
                      for name, res in flash.items()}))
    main_dense = dense["bf16"]
    record["kernels"].insert(1, dict(
        name="decode_attention", route="cuda",
        source="ray_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="ray_tpu/ops/decode_attention.py:98",
        launches=runs["dense"]["launches"]["dense"],
        spec_launches=runs["spec"]["external"]["launches"]["dense"],
        max_abs_err=main_dense["max_abs_err"], ms=main_dense["ms"],
        plain_ms=main_dense["plain_ms"], bound_ms=main_dense["bound_ms"],
        bound_by=main_dense["bound_by"],
        library_ms=main_dense["library_ms"], card=card, variants=dense))
    stop_processes()
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
