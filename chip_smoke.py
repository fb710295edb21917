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
11. dense kernel vs plain: the dense decode-attention kernel against
   ``decode_attention_reference`` at the Llama-3-8B decode shape (B=8,
   Hq=32, KVH=8, D=128, S_max=2048, the phase-3 positions): bf16 and fp32
   caches, a per-layer view of a [2, B, S, KVH, D] cache, and S_max=1000
   (a ragged last tile); tolerances in DENSE_CASES;
12. dense timing: kernel, plain version and ``scaled_dot_product_attention``
   over the transposed contiguous cache with the ``pos >= col`` mask (a
   yardstick only; the port never calls it), CUDA events with L2 flushed;
   the bound is the live K/V + q + out + positions bytes over 3.35 TB/s;
13. dense end to end: ``ContinuousBatcher(paged=False)`` serving
   Llama-3-8B at full width and depth (the phase-5 weights, 8 slots,
   max_len 2048): the phase-5 prompts, 32 new tokens each, every request
   32 in-vocab tokens, the dense kernel launched num_layers times per
   tick and the paged kernel never; tick, tokens/s, TTFT p50, peak
   memory, a profile of 5 ticks, and how many requests agree token for
   token with the paged run (printed, not a gate: bf16 dense and paged
   prefill reduce over different key lengths);
14. dense parity inside the engine: in phase 6's 2-layer fp32 model the
   dense engine with the kernel and with ``use_decode_kernel=False``, the
   paged engine with its kernel, and ``LlamaGenerator.generate`` for one
   prompt give the same greedy tokens (a divergence passes only if the
   top-2 logit margin there is below 1e-4).

Phases 11-12 run after phases 3-4, and 13-14 inside phases 5-6, where
their models already live.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --paged-host-us ROOT`` instead measures only the
host microseconds a paged call takes (``host_us``, the phase-3 cases at
32 table entries) with the ``ray_tpu_torch`` package under ROOT, so two
checkouts' wrappers can be compared on one card; it prints one
``[host]`` JSON line.
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
# Dense kernel cases (name, cache dtype, S_max, layer view, atol, rtol):
# fp32 is exact math in another summation order; bf16 outputs round once
# to bf16 (~2^-8 relative).
DENSE_CASES = [("bf16", "bf16", 2048, False, 2e-2, 2e-2),
               ("fp32", "fp32", 2048, False, 1e-5, 0.0),
               ("layer-view-bf16", "bf16", 2048, True, 2e-2, 2e-2),
               ("ragged-1000-bf16", "bf16", 1000, False, 2e-2, 2e-2)]
DENSE_TIMED = ("bf16", "fp32")
TOP2_MARGIN = 1e-4


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
    s = SHAPE
    s_max = c["k"].shape[1]
    live = sum(min(p + 1, s_max) for p in POSITIONS)
    nbytes = (live * s["KVH"] * s["D"] * c["k"].element_size() * 2
              + s["B"] * 4 + 2 * c["q"].numel() * c["q"].element_size())
    ops = live * 4 * s["HQ"] * s["D"]
    kind = "bf16" if c["k"].element_size() == 2 else "fp32"
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", live, nbytes)


def dense_case(torch, kind, s_max, layer_view, seed):
    s = SHAPE
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[kind]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = (2,) if layer_view else ()
    shape = lead + (s["B"], s_max, s["KVH"], s["D"])
    k = torch.randn(shape, generator=gen, device="cuda").to(dt)
    v = torch.randn(shape, generator=gen, device="cuda").to(dt)
    if layer_view:
        k, v = k[1], v[1]       # what the engine hands in: cache.k[li]
    q = torch.randn((s["B"], s["HQ"], s["D"]), generator=gen,
                    device="cuda").to(dt)
    return dict(q=q, k=k, v=v, pos=torch.tensor(POSITIONS,
                                                dtype=torch.int32,
                                                device="cuda"))


def dense_kernel_phases(torch):
    """Phases 11-12: the dense kernel against its plain version, and its
    time beside the plain version's, SDPA's and the bound."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for i, (name, kind, s_max, layer_view, atol, rtol) in enumerate(
            DENSE_CASES):
        c = dense_case(torch, kind, s_max, layer_view, seed=20 + i)
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
            print(f"[dense-timing] {name}: kernel {res['ms']:.4f} ms, "
                  f"plain {res['plain_ms']:.4f} ms, library "
                  f"{res['library_ms']:.4f} ms, bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']}; "
                  f"{res['live_tokens']} live tokens, {res['bytes']} "
                  f"bytes)")
        results[name] = res
    del flush
    torch.cuda.empty_cache()
    return results


def serve(torch, cfg, params, prompts, max_new, **kw):
    """Drive the engine over ``prompts`` after a one-request warm-up;
    returns (outputs by request, stats). Every launch count is set to 0
    just before the measured run and read just after it."""
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention

    first = {}
    eng = ContinuousBatcher(cfg, params=params, num_slots=8, max_len=2048,
                            block_size=64, token_callback=lambda r, t:
                            first.setdefault(r, time.perf_counter()), **kw)
    eng.submit(prompts[0][:16], max_new_tokens=2)            # warm-up
    eng.run_to_completion()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks0, pre0 = eng.base_tick_count, eng.prefill_seconds
    dec0 = eng.decoded_tokens
    reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    out = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged": paged_decode_attention.launches,
                "dense": decode_attention.launches}
    ticks = eng.base_tick_count - ticks0
    decode_s = wall - (eng.prefill_seconds - pre0)
    stats = dict(
        requests=len(prompts), ticks=ticks, launches=launches,
        wall_s=wall, ttft_p50_ms=float(np.median(
            [first[r] - t0 for r in rids])) * 1e3,
        tick_ms=decode_s / max(ticks, 1) * 1e3,
        decode_tok_s=(eng.decoded_tokens - dec0) / decode_s,
        prefill_s=eng.prefill_seconds - pre0,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        kernel=eng.use_decode_kernel, paged=eng.paged)
    return [out[r] for r in rids], stats


def check_launches(st, num_layers, what):
    """The engine's own decode kernel launched num_layers times a tick,
    the other decode kernel never."""
    own, other = ("paged", "dense") if st["paged"] else ("dense", "paged")
    if (not st["kernel"] or st["launches"][own] != num_layers * st["ticks"]
            or st["launches"][other]):
        fail(f"{what}: launches {st['launches']} for {st['ticks']} ticks "
             f"x {num_layers} layers (want {own} only)")


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
        kernel = re.search(r"(paged_split|paged_combine|dense_decode)_kernel",
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
                         ("dense", prompts, {"paged": False})]:
        outs, st = serve(torch, cfg, params, ps, 32, **kw)
        check_outputs(outs, 32, cfg.vocab_size, f"e2e {name}")
        check_launches(st, cfg.num_layers, f"e2e {name}")
        st["card"] = card
        if name == "dense":
            st["agree_with_paged"] = sum(
                a == b for a, b in zip(outs, outputs["bf16"]))
        print(f"[e2e] {name} {'cache' if name == 'dense' else 'arena'}: "
              f"{json.dumps(st)}")
        runs[name], outputs[name] = st, outs
    for name, kw in [("bf16", {}), ("dense", {"paged": False})]:
        prof = profile_ticks(torch, cfg, params, prompts, **kw)
        prof["idle_share"] = 1.0 - prof["device_busy_ms_per_tick"] / runs[
            name]["tick_ms"]
        print(f"[profile] {name} decode tick, 8 slots: {json.dumps(prof)}")
        runs[name]["profile"] = prof
    del params
    torch.cuda.empty_cache()
    return runs


def _leaves(params):
    for v in params.values():
        if isinstance(v, dict):
            yield from v.values()
        else:
            yield v


def top2_margin(torch, params, cfg, seq):
    """The top-2 logit gap of the next token after ``seq`` (fp32 full
    forward)."""
    from ray_tpu_torch.models.continuous_batching import \
        _prefill_forward_paged

    with torch.no_grad():
        logits, _ = _prefill_forward_paged(
            params, torch.tensor([seq], device="cuda"),
            torch.arange(len(seq), device="cuda"), None, None, cfg,
            False, last_idx=torch.tensor([len(seq) - 1], device="cuda"))
    top2 = logits[0, 0].topk(2).values
    return float(top2[0] - top2[1])


def check_agree(torch, params, cfg, prompts, got, want, what):
    """Greedy tokens ``got`` against ``want`` request by request; a
    divergence passes only at a top-2 margin below TOP2_MARGIN."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next(n for n, (x, y) in enumerate(zip(a, b)) if x != y)
        margin = top2_margin(torch, params, cfg, prompts[i] + b[:j])
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
        if kw.get("use_decode_kernel", True):
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
    del params, gen
    torch.cuda.empty_cache()


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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "one CUDA GPU")
    if sys.argv[1:2] == ["--paged-host-us"]:
        print(card_line())
        paged_host_us(torch, sys.argv[2])
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
    runs = timed("phases 5, 13", end_to_end, torch, card)
    timed("phases 6, 14", engine_parity, torch)
    flash = timed("phases 7-8", flash_phases, torch)
    timed("phase 9", model_parity, torch)
    train = timed("phase 10", train_end_to_end, torch, card)

    main_case = timing["bf16"]
    record = {"kernels": [dict(
        name="paged_decode_attention", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode_attention.cu",
        replaces="ray_tpu/ops/paged_decode_attention.py:90",
        launches=runs["bf16"]["launches"]["paged"],
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
