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
10. end to end, training: ``ShardedTrainer`` on Llama-3-8B widths at 16 of
   its 32 layers (bf16, remat "full"), a 2 x 2048-token batch from
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
   requests), with ``sync_every=4``; an external drafter at Llama-3.2-1B's
   published widths (``DRAFTER``, random weights from seed 1; its steps
   run the dense kernel); and JAX's default, adaptive k. Each request
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
24. end to end, Mixtral training: Mixtral-8x7B widths at 4 of its 32
   layers (6.07 B params, bf16, remat "full"), a 2 x 2048-token batch
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
   (Mixtral-8x7B widths, 4 of 32 layers, bf16, remat "full", phase 10's
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
   Llama-3-8B widths cut to 2 layers (``CKPT``; bf16 params and both
   bf16 moments, 8.9 GB a saved step) on the one-rank mesh takes phase
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
   num_layers B4 launches a tick. Then four bursts of the same 12
   prompts (prefix-cached now) with tracing off, on, on, off, toggled in
   both processes: the tick ms and TTFT p50 of each mode (metrics stay
   on; ``[observe-cost]``), and the spans and samples the serving
   process pulled per request. Every replica process has exited and its memory is back
   before phase 10 (``[mem]`` lines at each start and end).

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
``sharded_launches``, their launches in phase 25's 12 steps, and
``ulysses_launches``, their launches in phase 26b);
the last line is ``{"ok": true, "device": {...}}``.

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
(``[mesh-ckpt]``). ``--mesh-check SECTION ...`` runs only the named
sections of ``MESH_SECTIONS`` (trainer, moe, mixtral, ckpt). It prints
no result line.

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
import signal
import subprocess
import sys
import threading
import time

import numpy as np

from ray_tpu_torch.llm import ContinuousLlamaDeployment

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
TRAIN = dict(layers=16, batch=2, seq=2048, steps=12, warmup=5, total=1000,
             last_loss_below=0.5)
# Phases 23-24: Mixtral-8x7B's published widths (MixtralConfig.mixtral_8x7b)
# cut in depth: 2 layers in fp32 for parity (3.16 B params, 12.7 GB, and
# as much again of grads a run); 4 of 32 layers in bf16 for training (6.07
# B params: params, grads and both bf16 moments take 48.5 GB; 6 layers
# would take 71.8 GB before activations).
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
MIXTRAL_TRAIN = dict(layers=4, batch=2, seq=2048, steps=12, warmup=5,
                     total=1000, peak_gib=70.0)
# Phase 28: ShardedTrainer at Llama-3-8B widths cut to 2 layers (1.49 B
# params; bf16 params and both bf16 moments, 8.9 GB a saved step), phase
# 10's batch and optimizer; two steps saved, so the temp dir's file
# system must hold disk_margin x two steps.
CKPT = dict(layers=2, disk_margin=1.2)
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
MESH_SECTIONS = ("trainer", "moe", "mixtral", "ckpt")
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
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


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
            ("self-buffered", prompts, dict(fixed, sync_every=4), "bf16"),
            ("external", prompts, dict(fixed, drafter=None), "bf16"),
            ("adaptive", prompts, dict(spec_k=fixed["spec_k"]), "bf16")]:
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
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(mesh_rank, args=(world, f"tcp://localhost:{port}",
                                        "nccl", sections),
                       nprocs=world, start_method="spawn", join=True)


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
    finally:
        dist.destroy_process_group()


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


def _ckpt_trainer(mesh=None, device=None):
    """Phase 28's trainer: Llama-3-8B widths at CKPT["layers"] layers,
    phase 10's optimizer, on ``mesh`` or on one device."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer)
    from ray_tpu_torch.parallel import DEFAULT_RULES

    t = TRAIN
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_layers=CKPT["layers"])
    opt = default_optimizer(warmup_steps=t["warmup"], total_steps=t["total"])
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

        from ray_tpu_torch.ops.decode_attention import decode_attention
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        with self._lock:
            out = dict(paged=paged_decode_attention.launches,
                       dense=decode_attention.launches,
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


def deploy_phase(torch, card, served):
    """Phase 29: the deployments in process (module docstring)."""
    from ray_tpu_torch.llm import LlamaDeployment
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.attention import flash_attention
    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention

    mem(torch, "phase 29 start")
    prompts, phase5 = served
    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    dep = ContinuousLlamaDeployment._cls_or_fn(config=cfg, num_slots=8,
                                               max_len=2048)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    list(dep.generate(prompts[0][:16], 2))       # warm-up, as serve() does
    eng = dep.batcher
    ticks0, pre0, dec0 = (eng.base_tick_count, eng.prefill_seconds,
                          eng.decoded_tokens)
    reset_launch_counts()
    outs, ttft, wall = stream_all(lambda i: dep.generate(prompts[i], 32),
                                  len(prompts))
    st = served_stats(
        outs, ttft, wall, eng.base_tick_count - ticks0,
        {"paged": paged_decode_attention.launches,
         "dense": decode_attention.launches},
        eng.prefill_seconds - pre0, eng.decoded_tokens - dec0,
        cfg.num_layers, cfg.vocab_size, "phase 29")
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
    """The shm channel segments on this host (``/dev/shm/rtch-*``)."""
    return sorted(n for n in os.listdir("/dev/shm") if n.startswith("rtch-"))


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
OBSERVE = dict(modes=(False, True, True, False), ttft_rel=0.10,
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
            ulysses_launches=seq["ulysses"]["launches"][n],
            **({"deployment_scoring_launches":
                serving["deploy"]["scoring_launches"]} if n == "fwd"
               else {}),
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
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
