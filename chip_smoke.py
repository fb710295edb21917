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
   ticking.

Phases 11-12 run after phases 3-4; 13, 15, 17, 18, 19 and 21 inside
phase 5 and 16, 20 and 22 inside phase 6, where their models already live
(15, 17, 19 and 21 before phase 5's profiles, which would slow their
host-clock times).

The line before the last is the kernels' JSON record (the paged and dense
entries also carry ``spec_launches``, their launches in phase 19's
self-draft and external-drafter runs, and the paged entry
``split_launches``, the decode engine's launches in phase 21's bf16 run);
the last line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --paged-host-us ROOT`` instead measures only the
host microseconds a paged call takes (``host_us``, the phase-3 cases at
32 table entries) with the ``ray_tpu_torch`` package under ROOT, so two
checkouts' wrappers can be compared on one card; it prints one
``[host]`` JSON line. ``python3 chip_smoke.py --dense-ms ROOT`` likewise
times only the dense kernel of ROOT's package at the timed phase-12
cases (kernel ms, L2 flushed, and host microseconds a call) and prints
one ``[dense-ms]`` JSON line.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

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
    rng = np.random.default_rng(0)
    lens = rng.integers(17, 701, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    print(f"[e2e] prompt lengths {sorted(int(x) for x in lens)}")
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
    return runs


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


def partings(torch, params, cfg, prompts, got, want, what, against="paged"):
    """Where the bf16 run ``what`` (``got``) parts from the run
    ``against`` (``want``): for each such request, (request, first parting
    token, top-2 margin, top logit) of the next token after the prompt and
    the tokens both runs share, from a bf16 full forward. A margin near
    bf16's rounding of a logit of that size (2^-8 relative) is a near-tie
    that another summation order flips."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        margin, top = top2_margin(torch, params, cfg, prompts[i] + b[:j])
        print(f"[parity] bf16 {what} and {against} runs part at request {i}, "
              f"token {j}: top-2 margin {margin:.4e}, top logit {top:.4f} "
              f"(bf16 rounding there {abs(top) * 2**-8:.4e})")
        out.append((i, j, margin, top))
    return out


def check_agree(torch, params, cfg, prompts, got, want, what):
    """Greedy tokens ``got`` against ``want`` request by request; a
    divergence passes only at a top-2 margin below TOP2_MARGIN."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        margin, _ = top2_margin(torch, params, cfg, prompts[i] + b[:j])
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


def profile_step(torch, trainer, state, batch, step_ms):
    """Device time of one train step by kernel (torch.profiler, device
    rows only), grouped: the three flash kernels, GEMMs, the rest; the
    idle share is against ``step_ms``, the unprofiled step (the profiler
    slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = trainer.train_step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    groups = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0,
              "gemm": 0.0, "other": 0.0}
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
        else:
            groups["other"] += ms
    empty = [g for g in ("flash_fwd", "flash_dq", "flash_dkv")
             if groups[g] <= 0.0]
    if empty:
        fail(f"train profile: no device time in {empty} (a renamed flash "
             f"kernel would land in 'other'); kernels: "
             f"{sorted(r[0][:80] for r in rows if 'flash' in r[0])}")
    busy = sum(groups.values())
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return state, dict(wall_ms_profiled=wall_ms, device_busy_ms=busy,
                       idle_share=1.0 - busy / step_ms,
                       groups_ms=groups,
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
    state, prof = profile_step(torch, trainer, state, batch, step_s * 1e3)
    print(f"[train-profile] one step: {json.dumps(prof)}")
    del state, trainer, batch
    torch.cuda.empty_cache()
    return stats


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
    if sys.argv[1:2] == ["--dense-ms"]:
        print(card_line())
        dense_ms(torch, sys.argv[2])
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
    runs = timed("phases 5, 13, 15, 17, 18, 19, 21", end_to_end, torch,
                 card)
    timed("phases 6, 14, 16, 20, 22", engine_parity, torch)
    flash = timed("phases 7-8", flash_phases, torch)
    timed("phase 9", model_parity, torch)
    train = timed("phase 10", train_end_to_end, torch, card)

    main_case = timing["bf16"]
    record = {"kernels": [dict(
        name="paged_decode_attention", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode_attention.cu",
        replaces="ray_tpu/ops/paged_decode_attention.py:90",
        launches=runs["bf16"]["launches"]["paged"],
        spec_launches=runs["spec"]["self-bf16"]["launches"]["paged"],
        split_launches=runs["split"]["bf16"]["launches"]["paged"],
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
