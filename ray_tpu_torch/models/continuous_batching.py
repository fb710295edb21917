"""Continuous batching over a KV cache (port of the paged and dense data
planes of ``ray_tpu/models/continuous_batching.py``).

The engine owns a fixed pool of slots; requests prefill into a free slot
and join the very next decode tick, and finished requests free their
slot (and arena blocks) at once. The decode tick runs every slot each
step (freed slots compute masked garbage); per-slot absolute positions
drive RoPE, the cache write and the attention mask; prompts prefill in
batches padded to power-of-two buckets.

Two data planes, chosen by ``paged``:

* paged (the default): a shared arena of fixed-size blocks with per-slot
  block tables; tick attention goes through
  :func:`~ray_tpu_torch.ops.paged_decode_attention.paged_decode_attention`;
* dense (``paged=False``): one ``[L, num_slots, max_len, KVH, D]``
  stripe per slot (:class:`~ray_tpu_torch.models.inference.KVCache`);
  tick attention goes through
  :func:`~ray_tpu_torch.ops.decode_attention.decode_attention`.

Either way the attention is the CUDA kernel on the card. PyTorch runs
eagerly and the cache is updated in place, where the JAX package
threads a donated functional cache through jitted programs.

Paged engines share prompt blocks across requests through a radix index
(``prefix_cache``, on by default as in JAX): a request whose leading
full prompt blocks are already in the arena splices them into its table
read-only and prefills only its suffix. ``sync_every > 1`` runs ticks
ahead of the host and fetches their tokens in batches, rewinding to the
host's state when a request finishes. ``swap_params`` and
``score_logprobs`` are the hooks a training loop drives.

Speculative decode (``spec_k > 0``, paged engines): a drafter (the
target's first layers over its own arena, or a small external model over
its own dense cache) proposes k tokens a slot, one verify pass scores the
k+1 window positions through the paged attention, and each slot commits
its accepted prefix plus one token of the target's
(:func:`~ray_tpu_torch.models.sampling.spec_commit`). Reservations carry
``spec_k`` look-ahead tokens, so rejected draft writes stay in the
slot's own blocks.

Disaggregated prefill/decode (``role``, paged engines): a "prefill"
engine admits and prefills, then parks each request at its first token
(the slot frees, the blocks stay) until :meth:`ContinuousBatcher.export_kv_payload`
ships its prompt blocks as one host staging buffer with a crc32 manifest
in the JAX package's wire format; a "decode" engine reserves blocks
ahead (:meth:`~ContinuousBatcher.reserve_import`), lands a payload in
them (:meth:`~ContinuousBatcher.import_kv_payload`) and decodes from the
prefill's first token. Both are called through
:mod:`ray_tpu_torch.serve.kv_transfer`. Each request leaves a host record
of its latency split (``request_breakdowns``); ``pressure_snapshot`` is
the router's and autoscaler's view of the engine.

Telemetry, as JAX's engine records it. Always on (host bookkeeping, a
few dictionary operations a tick): the ``SERVE_REQ_*`` latency split of
each request (TTFT = queue + arena wait + prefill, TPOT, outcomes,
tagged with the request's deployment and tenant, the engine and its
role), the ``CB_*`` counters (prefill, decode, prefix and spec tokens)
and gauges (slots, waiting requests, arena blocks, the spec rate and k,
set on the stepping thread at each step) and ``CB_TICK_MS``. Under
``RAY_TPU_TRACING=1``, a request submitted with a ``trace`` context gets
the spans ``engine.queue``, ``engine.arena_wait``, ``engine.prefill``,
``engine.decode_window`` (one a host sync window, at most 64, the rest
merged into ``engine.decode_tail``) and ``engine.<outcome>``, parented to
the context's span. Wall-clock stamps (``time.time()``), so spans line up
with the serving process's across the process hop.
"""

from __future__ import annotations

import itertools
import os
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.inference import (KVCache, SelfDrafter,
                                            _attend_cached,
                                            _forward_cached, _layer, _mlp,
                                            _proj, lm_head_logits)
from ray_tpu_torch.models.paged_kv import (GARBAGE_BLOCK, BlockAllocator,
                                           PagedKVCache, RadixBlockIndex,
                                           prompt_chunks, quantize_kv,
                                           resolve_kv_dtype)
from ray_tpu_torch.models.sampling import (SPEC_DRAFT_SALT, SamplingParams,
                                           filtered_probs, sample_tokens,
                                           spec_commit, step_key)
from ray_tpu_torch.ops.decode_attention import decode_attention, env_flag
from ray_tpu_torch.util import tracing
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_decode_attention import paged_decode_attention
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies


def _apply_rope_window(x, cos, sin):
    """RoPE with per-(slot, position) angles: x [B, S, H, D], cos/sin
    [B, S, D//2] (a tick is the window S = 1)."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


def _apply_rope_batched(x, cos, sin):
    """RoPE with per-batch angles: x [B, 1, H, D], cos/sin [B, D//2]."""
    return _apply_rope_window(x, cos[:, None], sin[:, None])


def _slot_rows(positions, s_max: int):
    """Each slot's write row in a dense ``[B, S_max, ...]`` cache viewed
    flat over tokens: ``b * S_max + position``, the position clamped
    into the cache as JAX's ``dynamic_update_slice`` clamps."""
    b = positions.shape[0]
    rows = torch.arange(b, device=positions.device) * s_max
    return rows + positions.long().clamp(0, s_max - 1)


def _scatter_slot(cache, new, rows):
    """Dense scatter, IN PLACE: cache [B, S_max, KVH, D]; new [B, KVH, D]
    written one row per slot at ``rows`` [B] (:func:`_slot_rows` of the
    slots' positions, computed once a tick for every layer). Returns
    ``cache``."""
    return _scatter_arena(cache, new, rows)


def _scatter_arena(arena, new, flat_pos):
    """Paged scatter, IN PLACE: arena [NB, bs, ...] viewed flat over
    tokens; one entry per row of ``new`` written at ``flat_pos`` (=
    block_id * bs + offset). Returns ``arena``. Freed slots all target
    the garbage block: ``index_copy_`` with duplicate indices keeps an
    arbitrary one of them, which is harmless because only freed slots
    ever attend block 0."""
    nb, bs = arena.shape[0], arena.shape[1]
    flat = arena.view(nb * bs, *arena.shape[2:])
    flat.index_copy_(0, flat_pos, new.to(arena.dtype))
    return arena


def _arena_rows(positions, tables, limits, bs: int):
    """Flat arena rows (block_id * bs + offset) of writes at
    ``positions`` [B, S], resolved through each slot's table row. A write
    at or past the slot's ``limits`` would alias its last live block
    through the table tail, so it goes to the garbage block instead (the
    table index is clamped first, as JAX's gather clamps)."""
    pos = positions.long()
    idx = (pos // bs).clamp(max=tables.shape[1] - 1)
    gathered = torch.gather(tables.long(), 1, idx)
    block_idx = torch.where(pos < limits.long()[:, None], gathered,
                            GARBAGE_BLOCK)
    return block_idx * bs + pos % bs


def _next_tokens(logits, step: int, sampling: SamplingParams,
                 salt: int = 0):
    """Token selection from tick/prefill logits [B, 1, V]: greedy argmax,
    or temperature/top-p sampling with the generator of
    (seed, salt, step). ``salt`` separates the prefill and decode
    streams, whose step counters both start at 0."""
    row = logits[:, 0]
    if sampling.greedy:
        return row.argmax(dim=-1).to(torch.int32)
    gen = step_key(sampling.seed, step, salt=salt, device=row.device)
    return sample_tokens(row, gen, sampling.temperature, sampling.top_p)


_PREFILL_SALT = 1  # prefill sampling stream, distinct from decode's


def _layer_qkv_window(x, layer, cos, sin, c):
    """Per-layer projections over a window of S tokens a slot: attn-norm,
    Q/K/V, RoPE on Q and K (V unrotated). x [B, S, E]; cos/sin
    [B, S, D//2]. The tick is S = 1; verify's k+1 tokens ride the rows of
    the same products."""
    h = rms_norm(x, layer["attn_norm"], c.rms_eps)
    q = _proj(h, layer["wq"].to(c.dtype))
    k = _proj(h, layer["wk"].to(c.dtype))
    v = _proj(h, layer["wv"].to(c.dtype))
    return (_apply_rope_window(q, cos, sin),
            _apply_rope_window(k, cos, sin), v)


def _layer_finish_window(x, o, layer, c):
    """Per-layer tail over a window: attention output projection + gated
    MLP. x [B, S, E]; o [B, S, H, D]."""
    x = x + _proj(o.reshape(*o.shape[:2], -1),
                  layer["wo"].to(c.dtype).reshape(-1, c.hidden_size))
    return _mlp(x, layer, c)


def _window_embed(params, tokens, positions, c):
    """Embeddings and RoPE angles of tokens [B, S] at ``positions``
    [B, S]: (x [B, S, E], cos, sin [B, S, D//2])."""
    b, s = tokens.shape
    cos, sin = rope_frequencies(c.head_dim, 0, c.rope_theta,
                                positions=positions.reshape(-1))
    x = params["embed"].to(c.dtype)[tokens.long()]
    return x, cos.reshape(b, s, -1), sin.reshape(b, s, -1)


def _dense_forward(params, tokens, positions, cache: KVCache,
                   config: llama.LlamaConfig, use_kernel: bool):
    """One token a slot through every layer over the dense cache: tokens
    [B] at per-slot absolute ``positions`` [B]. Writes each slot's new
    K/V into ``cache`` in place (rows clamped into the cache, as JAX's
    ``dynamic_update_slice`` clamps) and returns fp32 logits [B, 1, V].
    ``use_kernel`` routes attention through the dense CUDA kernel (True)
    or its plain version (False)."""
    c = config
    x, cos, sin = _window_embed(params, tokens[:, None], positions[:, None],
                                c)
    scale = c.head_dim ** -0.5
    rows = _slot_rows(positions, cache.k.shape[2])
    for li in range(c.num_layers):
        layer = _layer(params, li)
        q, k, v = _layer_qkv_window(x, layer, cos, sin, c)
        ck = _scatter_slot(cache.k[li], k[:, 0], rows)
        cv = _scatter_slot(cache.v[li], v[:, 0], rows)
        o = decode_attention(q[:, 0], ck, cv, positions, scale,
                             use_kernel=use_kernel)
        x = _layer_finish_window(x, o.to(x.dtype)[:, None], layer, c)
    x = rms_norm(x, params["final_norm"], c.rms_eps)
    return lm_head_logits(x, params, c)


def _decode_tick(params, tokens, positions, cache: KVCache, step: int,
                 config: llama.LlamaConfig, use_kernel: bool = False,
                 sampling: SamplingParams = SamplingParams()):
    """One decode step for every slot over the dense cache
    (:func:`_dense_forward`) and its token selection. Returns
    (next_tokens [B], positions + 1, cache, step + 1)."""
    logits = _dense_forward(params, tokens, positions, cache, config,
                            use_kernel)
    next_tokens = _next_tokens(logits, step, sampling)
    return next_tokens, positions + 1, cache, step + 1


def _paged_forward(params, num_layers: int, tokens, positions, tables,
                   limits, cache: PagedKVCache, config: llama.LlamaConfig,
                   use_kernel: bool):
    """A window of S tokens a slot through the first ``num_layers``
    layers over the paged arena: tokens [B, S] at per-slot absolute
    ``positions`` [B, S]; ``tables`` [B, max_blocks] int32 (dead tail
    entries repeat the last live block; freed slots point wholesale at
    the garbage block); ``limits`` [B] is each slot's table-covered token
    count. Returns fp32 logits [B, S, V] through the final norm and LM
    head.

    Each layer writes all S tokens' K/V into the arena IN PLACE before
    any query attends; query j then attends positions [0..p_j] through
    :func:`~ray_tpu_torch.ops.paged_decode_attention.paged_decode_attention`
    (the CUDA kernel with ``use_kernel``, one call a window position),
    so its later window neighbours stay masked. Writes past ``limits``
    go to the garbage block. The tick is S = 1 over every layer, the
    self-draft S = 1 over the first n, verify S = k+1 over every layer."""
    c = config
    quantized = cache.quantized
    bs = cache.block_size
    b, s = tokens.shape
    x, cos, sin = _window_embed(params, tokens, positions, c)
    scale = c.head_dim ** -0.5
    flat_pos = _arena_rows(positions, tables, limits, bs).reshape(-1)
    pos_cols = positions.t().contiguous()    # [S, B]: one row a position
    for li in range(num_layers):
        layer = _layer(params, li)
        q, k, v = _layer_qkv_window(x, layer, cos, sin, c)
        k_tok = k.reshape(b * s, *k.shape[2:])                # [B*S, KVH, D]
        v_tok = v.reshape(b * s, *v.shape[2:])
        ksl = vsl = None
        if quantized:
            # Scales reduce over D alone, so a window's quantization is
            # the tick's, token for token.
            kq, ksc = quantize_kv(k_tok)
            vq, vsc = quantize_kv(v_tok)
            ksl = _scatter_arena(cache.k_scale[li], ksc, flat_pos)
            vsl = _scatter_arena(cache.v_scale[li], vsc, flat_pos)
        else:
            kq, vq = k_tok, v_tok
        ck = _scatter_arena(cache.k[li], kq, flat_pos)
        cv = _scatter_arena(cache.v[li], vq, flat_pos)
        o = torch.stack([
            paged_decode_attention(q[:, j], ck, cv, tables, pos_cols[j],
                                   scale, k_scale=ksl, v_scale=vsl,
                                   use_kernel=use_kernel).to(x.dtype)
            for j in range(s)], dim=1)                        # [B, S, H, D]
        x = _layer_finish_window(x, o, layer, c)
    x = rms_norm(x, params["final_norm"], c.rms_eps)
    return lm_head_logits(x, params, c)


def _decode_tick_paged(params, tokens, positions, tables, limits,
                       cache: PagedKVCache, step: int,
                       config: llama.LlamaConfig, use_kernel: bool = False,
                       sampling: SamplingParams = SamplingParams()):
    """One decode step for every slot (:func:`_paged_forward` of one
    token a slot over every layer) and its token selection. Returns
    (next_tokens [B], positions + 1, cache, step + 1), the cache written
    in place."""
    logits = _paged_forward(params, config.num_layers, tokens[:, None],
                            positions[:, None], tables, limits, cache,
                            config, use_kernel)
    next_tokens = _next_tokens(logits, step, sampling)
    return next_tokens, positions + 1, cache, step + 1


def _draft_forward_paged(params, n_draft: int, tokens, positions, tables,
                         limits, cache: PagedKVCache,
                         config: llama.LlamaConfig, use_kernel: bool):
    """One self-draft step: tokens [B] at ``positions`` [B] through the
    target's first ``n_draft`` layers, reading and writing the target's
    own arena (layers [0:n)) in place, with the tick's tables, limits and
    garbage redirect; the target's final norm and LM head. Returns
    (draft logits [B, V] fp32, cache)."""
    logits = _paged_forward(params, n_draft, tokens[:, None],
                            positions[:, None], tables, limits, cache,
                            config, use_kernel)
    return logits[:, 0], cache


def _draft_forward_dense(dparams, tokens, positions, dcache: KVCache,
                         dconfig: llama.LlamaConfig, use_kernel: bool):
    """The external drafter's step over its own dense per-slot cache.
    JAX runs the reference attention here; the port runs the dense
    attention with ``use_kernel`` (the CUDA kernel on the card). Returns
    (logits [B, V] fp32, dcache), the cache written in place."""
    logits = _dense_forward(dparams, tokens, positions, dcache, dconfig,
                            use_kernel)
    return logits[:, 0], dcache


def _verify_forward_paged(params, tokens, positions, tables, limits,
                          cache: PagedKVCache, config: llama.LlamaConfig,
                          use_kernel: bool):
    """One batched verify pass over each slot's k+1-token window: tokens
    [B, S] at per-slot absolute ``positions`` [B, S] (= p .. p+k), over
    every layer. The projections and the MLP take the window's B * S
    rows in one product each (one pass over the weights for k+1
    positions); attention runs once a window position through the paged
    path (:func:`_paged_forward`). Returns (fp32 logits [B, S, V],
    cache), the cache written in place."""
    logits = _paged_forward(params, config.num_layers, tokens, positions,
                            tables, limits, cache, config, use_kernel)
    return logits, cache


def _spec_tick_paged(params, tokens, positions, tables, limits,
                     cache: PagedKVCache, step: int,
                     config: llama.LlamaConfig, k: int, n_draft: int,
                     use_kernel: bool, sampling: SamplingParams,
                     draft_params=None, draft_cache=None,
                     draft_config=None):
    """Speculative decode tick: draft ``k`` tokens a slot, score the k+1
    window positions in one verify pass, accept per slot on the device
    (:func:`~ray_tpu_torch.models.sampling.spec_commit`).

    The self-drafter (no ``draft_params``) runs the target's first
    ``n_draft`` layers over the target's arena; an external drafter runs
    its own model over ``draft_cache``. Drafts write K/V at p .. p+k-1
    and verify at p .. p+k, all inside the slot's reservation (it holds
    ``spec_k`` tokens of look-ahead); K/V past the committed length are
    overwritten before any later query attends them. Sampled drafts draw
    from the generator of (seed, SPEC_DRAFT_SALT, step, index = draft
    position).

    Returns ``(committed [B, k+1], counts [B], next_tokens [B],
    next_positions [B], cache, draft_cache, step + 1)``."""
    external = draft_params is not None
    d_tokens: List[torch.Tensor] = []
    d_probs: List[torch.Tensor] = []
    tok, pos = tokens, positions
    for i in range(k):
        if external:
            logits_d, draft_cache = _draft_forward_dense(
                draft_params, tok, pos, draft_cache, draft_config,
                use_kernel)
        else:
            logits_d, cache = _draft_forward_paged(
                params, n_draft, tok, pos, tables, limits, cache, config,
                use_kernel)
        if sampling.greedy:
            nxt = logits_d.argmax(dim=-1).to(torch.int32)
        else:
            # The drafter proposes from its own filtered distribution;
            # acceptance needs those q rows.
            probs = filtered_probs(logits_d, sampling.temperature,
                                   sampling.top_p)
            gen = step_key(sampling.seed, step, SPEC_DRAFT_SALT,
                           device=probs.device, index=i)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0].to(
                torch.int32)
            d_probs.append(probs)
        d_tokens.append(nxt)
        tok, pos = nxt, pos + 1
    window = torch.stack([tokens.to(torch.int32)] + d_tokens, dim=1)
    window_pos = positions[:, None] + torch.arange(
        k + 1, device=positions.device, dtype=positions.dtype)[None, :]
    logits, cache = _verify_forward_paged(params, window, window_pos, tables,
                                          limits, cache, config, use_kernel)
    probs = torch.stack(d_probs, dim=1) if d_probs else None
    committed, counts = spec_commit(torch.stack(d_tokens, dim=1), probs,
                                    logits, step, sampling)
    next_tokens = torch.gather(committed, 1, (counts.long() - 1)[:, None])[
        :, 0]
    return (committed, counts, next_tokens, positions + counts, cache,
            draft_cache, step + 1)


class _ArenaPrefix:
    """A matched prefix's K or V, gathered from the arena one layer at a
    time: ``[li]`` is ``[N, m * bs, KVH, D]`` in the model dtype, int8
    storage dequantized exactly as the JAX engine's prefill reads it
    (``(q.float() * scale[..., None]).to(dtype)``). It stands in for a
    stacked ``[L, N, P, KVH, D]`` tensor in
    :func:`_prefill_forward_paged`'s layer loop, so only one layer's
    prefix is live at a time (the JAX engine gathers every layer's before
    its scan)."""

    def __init__(self, arena, scale, flat_blocks, n, dtype):
        self.arena, self.scale, self.flat = arena, scale, flat_blocks
        self.n, self.dtype = n, dtype

    def __getitem__(self, li):
        blocks = self.arena[li].index_select(0, self.flat)  # [N*m, bs, ..]
        if self.scale is not None:
            scale = self.scale[li].index_select(0, self.flat)
            blocks = blocks.float() * scale[..., None]
        blocks = blocks.to(self.dtype)
        return blocks.reshape(self.n, -1, *blocks.shape[2:])


def _prefill_forward_paged(params, tokens, positions, pk, pv, config,
                           quantized, last_idx=None):
    """Prefill forward over ``[prefix ++ suffix]``.

    ``tokens`` [N, S] at absolute ``positions`` [S]; ``pk[li]``/``pv[li]``
    [N, P, KVH, D] hold layer ``li``'s prefix K/V as attention reads it
    (a stacked [L, N, P, KVH, D] tensor or an :class:`_ArenaPrefix`;
    None: no prefix). Returns
    ``(logits, stored)``: logits [N, S, V] fp32, or [N, 1, V] at each
    row's ``last_idx`` [N] when given (the engine needs only those, and
    the full [N, S, V] would cost N*S*V*4 bytes); ``stored`` is the
    suffix K/V in ARENA form, stacked over layers — (k, v) or, for int8
    arenas, (kq, vq, k_scale, v_scale), quantized in-loop so attention
    reads the dequantized values the arena will hold. The caller writes
    it back into the arena in place."""
    c = config
    cos, sin = rope_frequencies(c.head_dim, tokens.shape[1], c.rope_theta,
                                positions=positions)
    x = params["embed"].to(c.dtype)[tokens.long()]
    scale = c.head_dim ** -0.5
    stored = []
    for li in range(c.num_layers):
        layer = _layer(params, li)
        h = rms_norm(x, layer["attn_norm"], c.rms_eps)
        q = apply_rope(_proj(h, layer["wq"].to(c.dtype)), cos, sin)
        k = apply_rope(_proj(h, layer["wk"].to(c.dtype)), cos, sin)
        v = _proj(h, layer["wv"].to(c.dtype))
        if quantized:
            kq, ksc = quantize_kv(k)
            vq, vsc = quantize_kv(v)
            k_att = (kq.float() * ksc[..., None]).to(c.dtype)
            v_att = (vq.float() * vsc[..., None]).to(c.dtype)
            stored.append((kq, vq, ksc, vsc))
        else:
            k_att, v_att = k, v
            stored.append((k, v))
        if pk is not None:
            k_att = torch.cat([pk[li], k_att], dim=1)   # [N, P+S, KVH, D]
            v_att = torch.cat([pv[li], v_att], dim=1)
        o = _attend_cached(q, k_att, v_att, positions, scale)
        x = x + _proj(o.reshape(*o.shape[:2], -1),
                      layer["wo"].to(c.dtype).reshape(-1, c.hidden_size))
        x = _mlp(x, layer, c)
    x = rms_norm(x, params["final_norm"], c.rms_eps)
    if last_idx is not None:
        x = torch.gather(x, 1, last_idx.long()[:, None, None].expand(
            -1, 1, x.shape[-1]))
    logits = lm_head_logits(x, params, c)
    return logits, tuple(torch.stack(parts) for parts in zip(*stored))


def _bucket(n: int, floor: int = 16) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def _bucket_floor(n: int) -> int:
    """Largest power of two <= n (0 for 0)."""
    return 0 if n <= 0 else 1 << (n.bit_length() - 1)


def _resolve_paged(paged: Optional[bool]) -> bool:
    """Explicit arg > ``RAY_TPU_PAGED_KV`` env > on (the paged arena is
    the default data plane)."""
    if paged is None:
        paged = env_flag("RAY_TPU_PAGED_KV")
    if paged is None:
        return True
    return bool(paged)


def _resolve_prefix_cache(prefix_cache: Optional[bool]) -> bool:
    """Explicit arg > ``RAY_TPU_PREFIX_CACHE`` env > on. Only paged
    engines use it: the radix index shares arena blocks, which dense
    per-slot stripes cannot."""
    if prefix_cache is None:
        prefix_cache = env_flag("RAY_TPU_PREFIX_CACHE")
    if prefix_cache is None:
        return True
    return bool(prefix_cache)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def _resolve_spec_k(spec_k: Optional[int]) -> int:
    """Speculative depth: explicit arg > ``RAY_TPU_SPEC_K`` env > 0
    (off)."""
    if spec_k is None:
        spec_k = _env_int("RAY_TPU_SPEC_K", 0)
    spec_k = int(spec_k)
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    return spec_k


def _resolve_spec_draft_layers(arg: Optional[int], num_layers: int) -> int:
    """Self-draft depth: explicit arg > ``RAY_TPU_SPEC_DRAFT_LAYERS`` env
    > num_layers // 4 (at least 1)."""
    if arg is None:
        arg = _env_int("RAY_TPU_SPEC_DRAFT_LAYERS", max(1, num_layers // 4))
    arg = int(arg)
    if not 1 <= arg <= num_layers:
        raise ValueError(
            f"spec_draft_layers must be in [1, {num_layers}], got {arg}")
    return arg


def _spec_ladder(spec_k: int) -> List[int]:
    """Adaptive-k rungs: the powers of two below spec_k, and spec_k."""
    ks = set()
    v = 1
    while v < spec_k:
        ks.add(v)
        v *= 2
    ks.add(spec_k)
    return sorted(ks)


# Version of an exported KV handoff payload's wire format (the JAX
# package's): import refuses another version rather than scatter bytes it
# would misread.
HANDOFF_MANIFEST_VERSION = 1

_ROLES = ("prefill", "decode", "both")


def _resolve_role(role: Optional[str]) -> str:
    """Explicit arg > ``RAY_TPU_SERVE_ROLE`` env > "both" (colocated).
    "prefill" engines stop each request at its first token and park its
    blocks for export; "decode" engines also take imported payloads."""
    if role is None:
        role = os.environ.get("RAY_TPU_SERVE_ROLE", "").strip() or "both"
    role = str(role).lower()
    if role not in _ROLES:
        raise ValueError(f"role must be one of {_ROLES}, got {role!r}")
    return role


def _resolve_decode_kernel(use_decode_kernel: Optional[bool],
                           device: torch.device) -> bool:
    """Explicit arg > ``RAY_TPU_DECODE_KERNEL`` env > auto (the CUDA
    kernel on a CUDA device, the plain version on the CPU). Asking for
    the kernel on the CPU raises. The paged engine dispatches the paged
    kernel, the dense engine the dense one."""
    if use_decode_kernel is None:
        use_decode_kernel = env_flag("RAY_TPU_DECODE_KERNEL")
    if use_decode_kernel is None:
        return device.type == "cuda"
    if use_decode_kernel and device.type != "cuda":
        raise RuntimeError("use_decode_kernel=True needs a CUDA device; "
                           f"the engine runs on {device}")
    return bool(use_decode_kernel)


def _named_leaves(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested param dict, in key order."""
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _named_leaves(val, name + ".")
        else:
            yield name, val


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed pool of KV-cache slots."""

    # Names co-resident engines apart on their series and at the chaos
    # site (JAX's engine tag).
    _engine_ids = itertools.count()

    def __init__(self, config: llama.LlamaConfig, params=None,
                 num_slots: int = 8, max_len: int = 512, seed: int = 0,
                 eos_token: Optional[int] = None, token_callback=None,
                 sync_every: int = 1,
                 use_decode_kernel: Optional[bool] = None,
                 paged: Optional[bool] = None,
                 block_size: int = 64,
                 kv_dtype: Optional[str] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 sampling=None,
                 spec_k: Optional[int] = None,
                 spec_draft_layers: Optional[int] = None,
                 spec_adaptive: Optional[bool] = None,
                 drafter=None,
                 role: Optional[str] = None,
                 device=None):
        """``token_callback(rid, token)`` fires for every generated token
        as it is produced.

        ``device``: where the engine runs; None means ``cuda``, and with
        no GPU that raises (pass ``device="cpu"`` for the plain path).
        ``params`` must already live there (None draws random weights
        from ``seed`` on the device).

        ``use_decode_kernel`` routes tick attention through the CUDA
        kernel (default on CUDA) or the plain version (False).

        ``sync_every=K > 1`` is buffered decode for high-latency host
        links: K ticks run per host synchronization, their tokens fetched
        in one copy that overlaps the next K ticks (pinned memory and an
        event on CUDA). Ticks run ahead of the host's bookkeeping; when a
        request finishes, the engine rewinds to the host's state (the
        dispatched sampling step included) and redoes at most 2K ticks.
        Greedy outputs equal ``sync_every=1``'s; sampled ones too for
        requests submitted up front.

        ``paged`` (default on; ``RAY_TPU_PAGED_KV=0`` turns it off)
        selects the data plane. Paged: a shared arena of ``block_size``-
        token blocks with per-slot block tables; admission reserves each
        request's blocks all-or-nothing, so a request can wait on arena
        space. ``kv_dtype`` ('bf16' = the model dtype, or 'int8' with
        per-token per-head scales) selects arena storage; ``num_blocks``
        sizes the arena (default: every slot at ``max_len`` plus the
        garbage block). ``prefix_cache`` (default on;
        ``RAY_TPU_PREFIX_CACHE``) indexes full prompt blocks in a radix
        tree: a later request with the same leading blocks splices them
        into its table read-only and prefills only its suffix; released
        prompt blocks park in an LRU that arena pressure reclaims before
        admission waits. Greedy outputs are the same on or off. Dense
        (``paged=False``): one ``max_len`` stripe per slot in the model
        dtype; ``block_size``, ``kv_dtype``, ``num_blocks`` and
        ``prefix_cache`` are ignored, as in JAX. ``sampling`` is a
        :class:`~ray_tpu_torch.models.sampling.SamplingParams` or dict;
        the default is greedy.

        SPECULATIVE DECODE (``spec_k`` > 0, or ``RAY_TPU_SPEC_K``; paged
        engines only): each tick a drafter proposes up to ``spec_k``
        tokens a slot, one verify pass scores the k+1 positions through
        the paged attention, and each slot commits its accepted prefix
        plus one token of the target's. ``drafter`` is a
        :class:`~ray_tpu_torch.models.inference.SelfDrafter` (the
        default: the target's first ``spec_draft_layers`` /
        ``RAY_TPU_SPEC_DRAFT_LAYERS`` layers over its own arena) or an
        :class:`~ray_tpu_torch.models.inference.ExternalLlamaDrafter`
        (its own model and dense cache, the dense attention kernel on the
        card; its params on this engine's device). Reservations carry
        ``spec_k`` look-ahead tokens. ``spec_adaptive`` (default on;
        ``RAY_TPU_SPEC_ADAPTIVE``) moves k along the ladder of
        :func:`_spec_ladder` from the accept rate of the last
        ``RAY_TPU_SPEC_WINDOW`` spec rows, down to 0 (the plain tick),
        and probes the bottom rung again after
        ``RAY_TPU_SPEC_PROBE_TICKS`` boundaries there. Greedy tokens are
        the target's own (in fp32; bf16 verify products over B * (k+1)
        rows may tile otherwise than the tick's); sampled acceptance is
        rejection sampling, which keeps the target's distribution and
        replays across buffered rewinds.

        DISAGGREGATION (``role``, or ``RAY_TPU_SERVE_ROLE``; paged engines
        only): "both" is the colocated engine. "prefill" admits and
        prefills, then parks each request at its first token (the first
        token is returned by :meth:`step`; :meth:`handoff_ready` lists the
        parked ids) until :meth:`export_kv_payload` ships its prompt
        blocks. "decode" also lands payloads through
        :meth:`import_kv_payload`, into blocks :meth:`reserve_import` may
        hold ahead, and decodes them as its own requests. Greedy tokens of
        a split request equal the colocated engine's."""
        self.config = config
        self.device = llama.default_device(device)
        self.num_slots = num_slots
        # The engine's tag on its series, built once (JAX's _mtags).
        self._mtags = {"engine": f"slots{num_slots}-{next(self._engine_ids)}"}
        self.max_len = max_len
        self.eos_token = eos_token
        self.sync_every = max(1, int(sync_every))
        self.sampling = SamplingParams.coerce(sampling)
        self.paged = _resolve_paged(paged)
        self.role = _resolve_role(role)
        if self.role != "both" and not self.paged:
            raise ValueError(
                "disaggregated prefill/decode roles need the paged KV "
                "plane (block-granular export/import); use paged=True "
                "or role='both'")
        self.block_size = int(block_size)
        if self.paged and (self.block_size < 8
                           or self.block_size & (self.block_size - 1)):
            # Prompt buckets are powers of two; a non-pow2 block would
            # break the prefill block reshape.
            raise ValueError(
                f"block_size must be a power of two >= 8, "
                f"got {self.block_size}")
        self.kv_dtype = resolve_kv_dtype(kv_dtype) if self.paged else None
        self.prefix_cache = self.paged and _resolve_prefix_cache(
            prefix_cache)
        self.use_decode_kernel = _resolve_decode_kernel(use_decode_kernel,
                                                        self.device)
        # Speculative decode resolves before the arena is sized: a
        # reservation carries spec_k look-ahead tokens.
        self.spec_k = _resolve_spec_k(spec_k)
        self.drafter = drafter
        if self.spec_k:
            if not self.paged:
                raise ValueError(
                    "speculative decoding needs the paged KV plane (the "
                    "garbage-block rewind substrate); use paged=True or "
                    "spec_k=0")
            if self.drafter is None:
                self.drafter = SelfDrafter(spec_draft_layers)
            if self.drafter.external:
                if self.drafter.config.vocab_size != config.vocab_size:
                    raise ValueError(
                        "external drafter must share the target's "
                        "vocabulary")
                here = self.device
                if here.type == "cuda" and here.index is None:
                    here = torch.device("cuda", torch.cuda.current_device())
                there = self.drafter.params["embed"].device
                if there != here:
                    raise ValueError(f"external drafter params live on "
                                     f"{there}, the engine on {here}")
                self.spec_draft_layers = self.drafter.config.num_layers
            else:
                self.spec_draft_layers = _resolve_spec_draft_layers(
                    spec_draft_layers if spec_draft_layers is not None
                    else self.drafter.draft_layers, config.num_layers)
            if spec_adaptive is None:
                spec_adaptive = env_flag("RAY_TPU_SPEC_ADAPTIVE")
            self.spec_adaptive = (True if spec_adaptive is None
                                  else bool(spec_adaptive))
            self._spec_ladder_ks = _spec_ladder(self.spec_k)
        else:
            self.drafter = None
            self.spec_draft_layers = 0
            self.spec_adaptive = False
            self._spec_ladder_ks = []
        self._spec_cur_k = self.spec_k
        self._spec_ticks: Dict[int, int] = {}   # rung k -> spec ticks run
        self._last_tick_k = 0                   # k the last tick ran with
        # (drafted, accepted) per applied spec row: the adaptive-k
        # controller and spec_accept_rate read it.
        self._spec_window: deque = deque(
            maxlen=max(1, _env_int("RAY_TPU_SPEC_WINDOW", 128)))
        self._spec_probe_after = max(
            1, _env_int("RAY_TPU_SPEC_PROBE_TICKS", 256))
        self._spec_probe_countdown = self._spec_probe_after
        self.spec_draft_tokens = 0      # drafted, cumulative
        self.spec_accepted_tokens = 0   # accepted by verify, cumulative
        self.spec_tick_count = 0        # spec-tick dispatches
        self.base_tick_count = 0        # plain-tick dispatches
        self.decoded_tokens = 0         # committed decode tokens
        # With the prefix cache on, prefill_tokens counts only the
        # prefilled (suffix) tokens; the hit/miss counters split prompts.
        self.prefill_batches = 0
        self.prefill_requests = 0
        self.prefill_tokens = 0
        self.prefill_seconds = 0.0      # dispatch -> first-token sync
        self.prefix_hit_tokens = 0      # prompt tokens served from blocks
        self.prefix_miss_tokens = 0     # prompt tokens prefilled
        self.prefix_hit_requests = 0    # requests with >= 1 matched block
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(config, gen, device=self.device)
        self.params = params
        self._weight_version = 0        # bumped by swap_params
        self.token_callback = token_callback
        self._prefix: Optional[RadixBlockIndex] = None
        self._slot_nodes: Dict[int, List[Any]] = {}   # slot -> pinned nodes
        if self.paged:
            # The table covers max_len plus the look-ahead: a spec tick
            # writes K/V up to p + spec_k, inside the slot's reservation.
            self.max_blocks = -(-(max_len + self.spec_k) // self.block_size)
            self.num_blocks = int(num_blocks if num_blocks is not None
                                  else num_slots * self.max_blocks + 1)
            self.allocator = BlockAllocator(self.num_blocks)
            self._slot_blocks: Dict[int, List[int]] = {}
            if self.prefix_cache:
                self._prefix = RadixBlockIndex()
        self.cache = self._new_cache()
        self._draft_cache = self._new_draft_cache()
        self._free: List[int] = list(range(num_slots))
        self._slots: Dict[int, Dict[str, Any]] = {}   # slot -> request
        # Decode state on the device between ticks, uploaded only when
        # slot membership changes.
        self._d_tokens = None
        self._d_positions = None
        self._d_tables = None
        self._d_limits = None
        # Sampling step of the next dispatched tick. Buffered ticks run
        # ahead of _applied_steps (the host-applied count); a rewind
        # (_upload_state) sets it back, so replayed ticks sample with
        # the same step numbers.
        self._d_step = 0
        self._applied_steps = 0
        self._prefill_count = 0   # per-dispatch prefill sampling stream
        self._buf: List[torch.Tensor] = []   # buffered tick token rows
        self._pending: Optional[tuple] = None  # (fetch, membership, w0)
        self._dirty = True
        self._waiting: deque = deque()
        self._rid = itertools.count()
        self._finished: Dict[int, List[int]] = {}
        # Disaggregation: a prefill engine parks each request's blocks
        # here from its first token to its export; a decode engine holds
        # blocks reserved for imports (the router reserves before it
        # dispatches the prefill, so a payload never meets a full arena).
        self._handoff_ready: Dict[int, Dict[str, Any]] = {}
        self._import_reservations: Dict[int, Dict[str, Any]] = {}
        self._reservation_ids = itertools.count()
        self.handoff_exports = 0
        self.handoff_imports = 0
        # One record a live request (wall-clock stamps of submit, arena
        # wait, admission and first token, and the caller's trace); each
        # ends as an entry of request_breakdowns. Decode-window spans are
        # kept only for traced requests, so with tracing off the decode
        # loop pays one integer check a fetch.
        self._req_meta: Dict[int, Dict[str, Any]] = {}
        self._traced_live = 0            # live requests carrying a trace
        self._window_t0: Optional[float] = None  # buffered window start
        self.request_breakdowns: deque = deque(maxlen=4096)
        self._MAX_WINDOWS = 64           # a request's window spans (cap)

    def _new_cache(self):
        if self.paged:
            return PagedKVCache.create(self.config, self.num_blocks,
                                       self.block_size, self.kv_dtype,
                                       device=self.device)
        return KVCache.create(self.config, self.num_slots, self.max_len,
                              device=self.device)

    def _new_draft_cache(self) -> Optional[KVCache]:
        """The external drafter's dense per-slot cache (None without
        one)."""
        if not (self.spec_k and self.drafter.external):
            return None
        return KVCache.create(self.drafter.config, self.num_slots,
                              self.max_len, device=self.device)

    # ---------------------------------------------------------------- api
    @property
    def weight_version(self) -> int:
        """Monotone version of the live params (0 = the initial ones)."""
        return self._weight_version

    def swap_params(self, params, version: Optional[int] = None) -> int:
        """Replace the live params between steps: the only assignment of
        ``self.params`` after ``__init__``. The KV cache and every
        in-flight request are untouched, so running generations continue
        under the new weights. ``params`` must have the same leaves as
        the live ones, each of the same shape, dtype and device; a
        mismatch raises ``ValueError`` naming the leaf. Returns the new
        version (``version``, or the previous one + 1)."""
        old = dict(_named_leaves(self.params))
        new = dict(_named_leaves(params))
        if old.keys() != new.keys():
            raise ValueError(
                f"swap_params tree mismatch: engine has leaves "
                f"{sorted(old)}, swap brought {sorted(new)}")
        for name, a in old.items():
            b = new[name]
            if not isinstance(b, torch.Tensor) or (
                    (b.shape, b.dtype, b.device)
                    != (a.shape, a.dtype, a.device)):
                got = (f"{tuple(b.shape)}/{b.dtype}/{b.device}"
                       if isinstance(b, torch.Tensor) else type(b).__name__)
                raise ValueError(
                    f"swap_params leaf {name!r} mismatch: engine has "
                    f"{tuple(a.shape)}/{a.dtype}/{a.device}, swap brought "
                    f"{got}")
        self.params = params
        self._weight_version = (int(version) if version is not None
                                else self._weight_version + 1)
        return self._weight_version

    @torch.no_grad()
    def score_logprobs(self, prompt_tokens: List[int],
                       out_tokens: List[int]) -> np.ndarray:
        """Log-probabilities of ``out_tokens`` after ``prompt_tokens``
        under the live params: one teacher-forced
        :func:`ray_tpu_torch.models.llama.forward` (the flash forward
        kernel on the card) over the sequence padded to
        ``min(_bucket(n), max_len)``, fp32 ``log_softmax``. Returns
        ``[len(out_tokens)]`` float32."""
        if not out_tokens:
            return np.zeros((0,), np.float32)
        full = list(prompt_tokens) + list(out_tokens)
        if len(full) > self.max_len:
            raise ValueError(
                f"score_logprobs sequence ({len(full)} tokens) exceeds "
                f"max_len={self.max_len}")
        pad = min(_bucket(len(full)), self.max_len)
        tokens = torch.zeros((1, pad), dtype=torch.long, device=self.device)
        tokens[0, :len(full)] = torch.tensor(full, device=self.device)
        with llama.fp32_reduction(self.device, self.config.dtype):
            logits = llama.forward(self.params, tokens, self.config)
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        start = len(prompt_tokens)
        rows = torch.arange(start - 1, start - 1 + len(out_tokens),
                            device=self.device)
        picked = logp[rows, torch.tensor(out_tokens, device=self.device)]
        return picked.cpu().numpy().astype(np.float32)

    def submit(self, prompt_tokens: List[int],
               max_new_tokens: int = 32,
               trace: Optional[Dict[str, Any]] = None) -> int:
        """Queue a request; returns its id. It joins the next tick with a
        free slot (and, paged, enough free arena blocks). ``trace`` (the
        serve request's context) is kept in the request's record."""
        if len(prompt_tokens) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt_tokens)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.max_len}")
        if max_new_tokens <= 0:
            # Nothing to generate: finished at once, no slot, no blocks.
            rid = next(self._rid)
            self._finished[rid] = []
            return rid
        need = (self._blocks_needed(len(prompt_tokens), max_new_tokens)
                if self.paged else 0)
        if self.paged and need > self.num_blocks - 1:
            # A reservation larger than the whole arena would wedge the
            # FIFO head forever.
            raise ValueError(
                f"request needs more KV blocks than the arena holds "
                f"({need} > {self.num_blocks - 1}); raise num_blocks or "
                f"shorten the request")
        rid = next(self._rid)
        traced = trace is not None and tracing.enabled()
        self._req_meta[rid] = {
            "rid": rid, "submit": time.time(),
            "prompt_len": len(prompt_tokens),
            "weight_version": self._weight_version,
            "trace": trace, "traced": traced, "windows": []}
        if traced:
            self._traced_live += 1
        self._waiting.append({"rid": rid, "prompt": list(prompt_tokens),
                              "max_new": max_new_tokens})
        return rid

    def _release_slot(self, slot: int) -> None:
        self._free.append(slot)
        if self.paged:
            blocks = self._slot_blocks.pop(slot, None)
            nodes = self._slot_nodes.pop(slot, None)
            if nodes:
                # Indexed blocks deref: refcount 0 parks them in the LRU
                # (a later match revives them) instead of the free list.
                self._prefix.release(nodes)
                shared = {nd.block for nd in nodes}
                blocks = [b for b in (blocks or []) if b not in shared]
            if blocks:
                self.allocator.free(blocks)

    def cancel(self, rid: int) -> bool:
        """Drop a request: frees its slot and blocks, or its queue spot,
        or its parked handoff and unread result."""
        for i, req in enumerate(self._waiting):
            if req["rid"] == rid:
                del self._waiting[i]
                self._finish_request(rid, "evicted")
                return True
        for slot, st in list(self._slots.items()):
            if st["rid"] == rid:
                del self._slots[slot]
                self._release_slot(slot)
                self._dirty = True
                self._finish_request(rid, "evicted", tokens=len(st["out"]))
                return True
        # A parked handoff's blocks must not outlive the request (its
        # first token already sits in _finished).
        self.abandon_handoff(rid)
        return self._finished.pop(rid, None) is not None

    def reset(self) -> List[int]:
        """Abort everything (recovery after an engine error): rebuild the
        arena or the dense cache, reset the allocator, clear the prefix
        index (its blocks would alias the zeroed arena), parked handoffs
        and import reservations, and rewind the step counters. Returns
        the request ids dropped."""
        dropped = [st["rid"] for st in self._slots.values()]
        dropped += [r["rid"] for r in self._waiting]
        tokens = {st["rid"]: len(st["out"]) for st in self._slots.values()}
        for rid in dropped:
            self._finish_request(rid, "aborted", tokens=tokens.get(rid, 0))
        self._req_meta.clear()
        self._traced_live = 0
        self._window_t0 = None
        self._slots.clear()
        self._waiting.clear()
        self._free = list(range(self.num_slots))
        self._finished.clear()
        self._buf = []
        self._pending = None
        # Parked handoffs and import reservations go with the arena (the
        # allocator's reset below takes their blocks back).
        self._handoff_ready.clear()
        self._import_reservations.clear()
        self.cache = self._draft_cache = None   # free the old caches first
        self.cache = self._new_cache()
        self._draft_cache = self._new_draft_cache()
        # Speculative state restarts at the configured k.
        self._spec_cur_k = self.spec_k
        self._spec_window.clear()
        self._spec_probe_countdown = self._spec_probe_after
        if self.paged:
            self.allocator.reset()
            self._slot_blocks.clear()
            self._slot_nodes.clear()
            if self._prefix is not None:
                self._prefix.clear()
        self._applied_steps = 0
        self._d_step = 0
        self._dirty = True
        return dropped

    @property
    def active_count(self) -> int:
        return len(self._slots)

    @property
    def free_slots(self) -> int:
        """Slots free for an admission or an import."""
        return len(self._free)

    @property
    def prefix_hit_rate(self) -> float:
        """Share of admitted prompt tokens served from cached prefix
        blocks (0.0 with the prefix cache off or before any admission)."""
        total = self.prefix_hit_tokens + self.prefix_miss_tokens
        return self.prefix_hit_tokens / total if total else 0.0

    def has_work(self) -> bool:
        return bool(self._slots or self._waiting or self._finished
                    or self._buf or self._pending)

    def kv_block_stats(self) -> Dict[str, float]:
        """Arena occupancy: live blocks used/total, LRU-cached and
        refcount-shared prefix blocks, live tokens, and the fragmentation
        ratio (reserved-but-unwritten share of used blocks, clamped at 0:
        shared prefixes count once per slot). Cached blocks are on the
        allocator's books but are not live demand, so ``used`` leaves
        them out. Dense engines report zeros."""
        if not self.paged:
            return {"used": 0, "total": 0, "cached": 0, "shared": 0,
                    "live_tokens": 0, "frag_ratio": 0.0}
        index = self._prefix
        cached = index.cached_count if index is not None else 0
        shared = index.shared_count if index is not None else 0
        used = self.allocator.used_count - cached
        live = sum(st["pos"] for st in self._slots.values())
        cap = used * self.block_size
        return {"used": used, "total": self.num_blocks - 1,
                "cached": cached, "shared": shared, "live_tokens": live,
                "frag_ratio": max(1.0 - live / cap, 0.0) if cap else 0.0}

    def pressure_snapshot(self) -> Dict[str, Any]:
        """Live pressure, the router's and autoscaler's input (JAX's keys):
        queue depth, slot occupancy, free, LRU-cached and look-ahead
        arena blocks, the prompt backlog, and the role's fields."""
        free_blocks = self.allocator.free_count if self.paged else 0
        cached = (self._prefix.cached_count
                  if self.paged and self._prefix is not None else 0)
        queued = sum(len(r["prompt"]) for r in self._waiting)
        return {
            "queue_depth": len(self._waiting),
            "active_slots": len(self._slots),
            "num_slots": self.num_slots,
            "kv_blocks_free": free_blocks,
            # Reclaimable on demand: admission may use free + cached.
            "kv_blocks_cached": cached,
            "kv_blocks_total": self.num_blocks - 1 if self.paged else 0,
            # Reserved speculative head-room (already out of the free
            # count), not committed tokens.
            "kv_blocks_spec_lookahead": sum(
                st.get("la_blocks", 0) for st in self._slots.values()),
            "inflight_prefill_tokens": queued,
            "role": self.role,
            # A prefill fleet's backlog: queued prompts and parked exports.
            "prefill_queue_tokens": queued + sum(
                len(e["prompt"]) for e in self._handoff_ready.values()),
            # Where an import could land now: free blocks plus the cached
            # ones _alloc_blocks would evict.
            "kv_blocks_importable": free_blocks + cached,
            "handoff_ready": len(self._handoff_ready),
            "import_reservations": len(self._import_reservations),
        }

    # --------------------------------------------------- request records
    def _req_tags(self, rec: Dict[str, Any]) -> Dict[str, str]:
        t = rec.get("trace") or {}
        return {"deployment": str(t.get("deployment", "")),
                "tenant": str(t.get("tenant", "")),
                "engine": self._mtags["engine"],
                "role": self.role}

    def _span_common(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        t = rec.get("trace") or {}
        return {"trace_id": t.get("trace_id", ""),
                "parent_span_id": t.get("parent_span_id", ""),
                "kind": "engine",
                "request_id": t.get("request_id", ""),
                "rid": rec["rid"]}

    def _note_first_token(self, rec: Dict[str, Any], prefill_t0: float,
                          first_ts: float) -> None:
        """The request's first token landed: split its time to first
        token into queue, arena wait and prefill, and emit the component
        histograms (and, traced, their spans). The queue holds the wait
        for a slot and, after admission, the wait behind the admission
        round's earlier prefill groups, so the three components sum to
        the TTFT (JAX's split leaves that second wait out)."""
        blocked = rec.get("arena_blocked", rec.get("admit", rec["submit"]))
        admit = rec.get("admit", blocked)
        rec["first_token"] = first_ts
        rec["queue_s"] = (max(blocked - rec["submit"], 0.0)
                          + max(prefill_t0 - admit, 0.0))
        rec["arena_wait_s"] = max(admit - blocked, 0.0)
        rec["prefill_s"] = max(first_ts - prefill_t0, 0.0)
        rec["ttft_s"] = max(first_ts - rec["submit"], 0.0)
        tags = self._req_tags(rec)
        mdefs.SERVE_REQ_TTFT.observe(rec["ttft_s"], tags=tags)
        mdefs.SERVE_REQ_QUEUE.observe(rec["queue_s"], tags=tags)
        mdefs.SERVE_REQ_ARENA_WAIT.observe(rec["arena_wait_s"], tags=tags)
        mdefs.SERVE_REQ_PREFILL.observe(rec["prefill_s"], tags=tags)
        if rec["traced"]:
            common = self._span_common(rec)
            tracing.emit_span("engine.queue", ts=rec["submit"],
                              dur=rec["queue_s"], **common)
            if rec["arena_wait_s"] > 0:
                tracing.emit_span("engine.arena_wait", ts=blocked,
                                  dur=rec["arena_wait_s"],
                                  blocks=rec.get("blocks", 0), **common)
            tracing.emit_span("engine.prefill", ts=prefill_t0,
                              dur=rec["prefill_s"],
                              prompt_tokens=rec["prompt_len"], **common)

    def _finish_request(self, rid: int, outcome: str,
                        tokens: int = 0) -> None:
        """The request's last edge (finished, prefilled, evicted or
        aborted): TPOT (over committed tokens, so a spec tick's several
        count) and the outcome, the record into ``request_breakdowns``,
        and, traced, the request's decode-window spans."""
        rec = self._req_meta.pop(rid, None)
        if rec is None:
            return
        now = time.time()
        if rec["traced"]:
            self._traced_live -= 1
        tags = self._req_tags(rec)
        mdefs.SERVE_REQ_OUTCOMES.inc(tags={**tags, "outcome": outcome})
        first = rec.get("first_token")
        tpot = None
        if first is not None and tokens > 1:
            tpot = max(now - first, 0.0) / (tokens - 1)
            mdefs.SERVE_REQ_TPOT.observe(tpot, tags=tags)
        trace = rec.get("trace") or {}
        self.request_breakdowns.append({
            "rid": rid, "outcome": outcome, "tokens": tokens,
            "queue_s": rec.get("queue_s"),
            "arena_wait_s": rec.get("arena_wait_s"),
            "prefill_s": rec.get("prefill_s"),
            "ttft_s": rec.get("ttft_s"), "tpot_s": tpot,
            "prefix_tokens": rec.get("prefix_tokens", 0),
            "prompt_tokens": rec.get("prompt_len", 0),
            "weight_version": rec.get("weight_version"),
            "trace_id": trace.get("trace_id"),
            "request_id": trace.get("request_id"),
            # An import's handoff split: export_s, channel_s, import_s.
            "handoff": rec.get("handoff")})
        if not rec["traced"]:
            return
        common = self._span_common(rec)
        if first is None:
            # Ended before its first token: the queue span (closed at the
            # first token otherwise) shows where the request died.
            tracing.emit_span("engine.queue", ts=rec["submit"],
                              dur=max(now - rec["submit"], 0.0),
                              outcome=outcome, **common)
        for i, (w0, w1, n) in enumerate(rec.get("windows", ())):
            tracing.emit_span("engine.decode_window", ts=w0,
                              dur=max(w1 - w0, 0.0), tokens=n,
                              window=i, **common)
        tail = rec.get("window_tail")
        if tail is not None:
            tracing.emit_span("engine.decode_tail", ts=tail[0],
                              dur=max(tail[1] - tail[0], 0.0),
                              tokens=tail[2], windows=tail[3], **common)
        tracing.emit_span(f"engine.{outcome}", ts=now, dur=0.0,
                          tokens=tokens, **common)

    def _record_window_token(self, rid: int, entries: Dict[int, list],
                             w0: float, w1: float) -> None:
        """Book one applied token into the sync window [w0, w1] of a
        traced request (its spans go out at its finish). Past
        ``_MAX_WINDOWS`` windows the rest merge into one tail, so a long
        generation cannot flood the span ring."""
        ent = entries.get(rid)
        if ent is not None:
            ent[2] += 1
            return
        rec = self._req_meta.get(rid)
        if rec is None or not rec["traced"]:
            return
        wins = rec["windows"]
        if len(wins) < self._MAX_WINDOWS:
            ent = [w0, w1, 1]
            wins.append(ent)
        else:
            ent = rec.get("window_tail")
            if ent is None:
                ent = rec["window_tail"] = [w0, w1, 0, 0]
            ent[1] = w1
            ent[3] += 1
            ent[2] += 1
        entries[rid] = ent

    def _emit_gauges(self) -> None:
        """The engine's gauges, set on the stepping thread (they read its
        slots, queue and arena)."""
        active = len(self._slots)
        mdefs.CB_ACTIVE_SLOTS.set(active, tags=self._mtags)
        mdefs.CB_WAITING_REQUESTS.set(len(self._waiting), tags=self._mtags)
        mdefs.CB_SLOT_OCCUPANCY.set(active / max(self.num_slots, 1),
                                    tags=self._mtags)
        if self.paged:
            kv = self.kv_block_stats()
            mdefs.CB_KV_BLOCKS_USED.set(kv["used"], tags=self._mtags)
            mdefs.CB_KV_BLOCKS_TOTAL.set(kv["total"], tags=self._mtags)
            mdefs.CB_KV_FRAG_RATIO.set(kv["frag_ratio"], tags=self._mtags)
            if self._prefix is not None:
                mdefs.CB_KV_BLOCKS_CACHED.set(kv["cached"],
                                              tags=self._mtags)
                mdefs.CB_KV_BLOCKS_SHARED.set(kv["shared"],
                                              tags=self._mtags)
        if self.spec_k:
            mdefs.CB_SPEC_ACCEPT_RATE.set(self.spec_accept_rate,
                                          tags=self._mtags)
            mdefs.CB_SPEC_K.set(self._spec_cur_k, tags=self._mtags)

    # --------------------------------------------- disaggregated handoff
    def _park_for_handoff(self, slot: int, req: Dict[str, Any]) -> None:
        """A prefill engine's request produced its first token: free the
        slot for the next admission but keep its blocks (and prefix
        nodes) until :meth:`export_kv_payload` ships them. The first
        token goes out through :meth:`step`'s results."""
        st = self._slots.pop(slot, None)
        if st is None:
            return          # finished at its first token: nothing to ship
        rid = st["rid"]
        self._free.append(slot)
        self._handoff_ready[rid] = {
            "prompt": list(req["prompt"]), "first": st["out"][0],
            "max_new": st["max_new"],
            "blocks": self._slot_blocks.pop(slot, []),
            "nodes": self._slot_nodes.pop(slot, [])}
        self._finished[rid] = list(st["out"])
        self._finish_request(rid, "prefilled", tokens=len(st["out"]))
        self._dirty = True

    def _release_handoff_blocks(self, entry: Dict[str, Any]) -> None:
        """Give a parked handoff's blocks back: indexed ones deref into
        the LRU (a resubmitted twin matches them), the rest free."""
        blocks, nodes = entry["blocks"], entry["nodes"]
        if nodes:
            self._prefix.release(nodes)
            shared = {nd.block for nd in nodes}
            blocks = [b for b in blocks if b not in shared]
        if blocks:
            self.allocator.free(blocks)

    def handoff_ready(self) -> List[int]:
        """Ids of the requests parked with KV ready to export."""
        return list(self._handoff_ready)

    def abandon_handoff(self, rid: int) -> bool:
        """Drop a parked handoff unexported (the client left, or no decode
        side came for it): its blocks go back."""
        entry = self._handoff_ready.pop(rid, None)
        if entry is None:
            return False
        self._release_handoff_blocks(entry)
        return True

    @torch.no_grad()
    def export_kv_payload(self, rid: int) -> Dict[str, Any]:
        """A parked request's KV handoff in the JAX package's wire format:
        its ``ceil(prompt / block_size)`` prompt blocks (K/V and int8
        scale sidecars) in one host staging buffer
        (:meth:`PagedKVCache.gather_blocks`), a crc32 of those bytes, and
        the geometry an importer checks. The blocks go back on return
        (indexed ones to the LRU). Call it through
        :mod:`ray_tpu_torch.serve.kv_transfer`."""
        if self.role == "decode":
            raise ValueError("decode-role engines do not export KV")
        entry = self._handoff_ready.pop(rid, None)
        if entry is None:
            raise KeyError(
                f"request {rid} has no handoff-ready KV (not prefilled "
                f"by a prefill-role engine, or already exported)")
        prompt = entry["prompt"]
        nb = -(-len(prompt) // self.block_size)
        staging, layout = self.cache.gather_blocks(entry["blocks"][:nb])
        payload = {
            "version": HANDOFF_MANIFEST_VERSION,
            "rid": rid,
            "prompt": prompt,
            "chunks": prompt_chunks(prompt, self.block_size),
            "first_token": int(entry["first"]),
            "max_new": int(entry["max_new"]),
            "block_size": self.block_size,
            "kv_dtype": self.kv_dtype,
            "num_layers": self.config.num_layers,
            "num_kv_heads": self.config.num_kv_heads,
            "head_dim": self.config.head_dim,
            "num_blocks": nb,
            "layout": layout,
            "staging": staging,
            "nbytes": int(staging.nbytes),
            # gather_blocks' copy has landed: the crc reads whole bytes.
            "crc32": zlib.crc32(staging),
        }
        self._release_handoff_blocks(entry)
        self.handoff_exports += 1
        return payload

    def reserve_import(self, prompt_len: int,
                       max_new: int) -> Optional[int]:
        """Hold the blocks a coming import of this size needs (the router
        reserves before it dispatches the prefill). Returns a reservation
        id, or None when the arena cannot cover it."""
        if self.role == "prefill":
            raise ValueError("prefill-role engines do not import KV")
        self.sweep_reservations()
        got = self._alloc_blocks(self._blocks_needed(prompt_len, max_new))
        if got is None:
            return None
        res_id = next(self._reservation_ids)
        self._import_reservations[res_id] = {
            "blocks": got, "prompt_len": prompt_len, "max_new": max_new,
            "ts": time.monotonic()}
        return res_id

    def sweep_reservations(self, ttl_s: Optional[float] = None) -> int:
        """Free the reservations whose import never came within ``ttl_s``
        (default ``RAY_TPU_KV_RESERVE_TTL_S``, 30 s). Returns how many."""
        if not self._import_reservations:
            return 0
        if ttl_s is None:
            ttl_s = float(os.environ.get("RAY_TPU_KV_RESERVE_TTL_S", "30"))
        cutoff = time.monotonic() - ttl_s
        stale = [r for r, ent in self._import_reservations.items()
                 if ent["ts"] < cutoff]
        for res_id in stale:
            self.allocator.free(
                self._import_reservations.pop(res_id)["blocks"])
        return len(stale)

    def cancel_reservation(self, res_id: int) -> bool:
        """Free a reservation (its prefill died, or the client left)."""
        ent = self._import_reservations.pop(res_id, None)
        if ent is None:
            return False
        self.allocator.free(ent["blocks"])
        return True

    @torch.no_grad()
    def import_kv_payload(self, payload: Dict[str, Any],
                          reservation: Optional[int] = None,
                          trace: Optional[Dict[str, Any]] = None,
                          breakdown: Optional[Dict[str, float]] = None
                          ) -> int:
        """Land an exported payload (this package's or the JAX
        package's) and decode it here. Checks in JAX's order: version,
        crc32, geometry, ``max_len``. Then the reservation's blocks (or a
        fresh grab), the scatter, the prompt's full blocks indexed in the
        radix tree (shareable at once), and a live slot continuing from
        the prefill's first token; an external drafter prefills the
        prompt into its own cache. A buffered engine first applies its
        ticks in flight, so the import starts at a clean boundary.
        Returns the request's id on this engine. Call it through
        :mod:`ray_tpu_torch.serve.kv_transfer`."""
        if self.role == "prefill":
            raise ValueError("prefill-role engines do not import KV")
        if payload.get("version") != HANDOFF_MANIFEST_VERSION:
            raise ValueError(
                f"KV handoff version mismatch: payload "
                f"v{payload.get('version')}, engine expects "
                f"v{HANDOFF_MANIFEST_VERSION}")
        crc = zlib.crc32(payload["staging"])
        if crc != payload["crc32"]:
            raise ValueError(
                f"KV handoff crc mismatch (got {crc:#010x}, manifest "
                f"says {payload['crc32']:#010x}): payload corrupted in "
                f"transit")
        for field, mine in (("block_size", self.block_size),
                            ("kv_dtype", self.kv_dtype),
                            ("num_layers", self.config.num_layers),
                            ("num_kv_heads", self.config.num_kv_heads),
                            ("head_dim", self.config.head_dim)):
            if payload[field] != mine:
                raise ValueError(
                    f"KV handoff geometry mismatch on {field}: payload "
                    f"{payload[field]!r} vs engine {mine!r}")
        t0 = time.time()
        prompt = list(payload["prompt"])
        plen = len(prompt)
        max_new = int(payload["max_new"])
        if plen + max_new > self.max_len:
            raise ValueError(
                f"imported request ({plen}+{max_new} tokens) exceeds "
                f"this engine's max_len={self.max_len}")
        self._drain_in_flight()
        need = self._blocks_needed(plen, max_new)
        blocks: Optional[List[int]] = None
        ent = (self._import_reservations.pop(reservation, None)
               if reservation is not None else None)
        if ent is not None:
            if len(ent["blocks"]) >= need:
                blocks = ent["blocks"][:need]
                if ent["blocks"][need:]:
                    self.allocator.free(ent["blocks"][need:])
            else:
                # Sized for another request: give it back, grab afresh.
                self.allocator.free(ent["blocks"])
        if blocks is None:
            blocks = self._alloc_blocks(need)
        if blocks is None:
            raise RuntimeError(
                f"decode arena cannot cover the import ({need} blocks "
                f"needed, {self.allocator.free_count} free); reserve "
                f"ahead with reserve_import")
        if not self._free:
            self.allocator.free(blocks)
            raise RuntimeError("no free decode slot for the import")
        nb = int(payload["num_blocks"])
        self.cache.scatter_blocks(blocks[:nb], payload["staging"],
                                  payload["layout"])
        rid = next(self._rid)
        traced = trace is not None and tracing.enabled()
        meta = {"rid": rid, "submit": t0, "prompt_len": plen,
                "weight_version": self._weight_version, "trace": trace,
                "traced": traced, "windows": [],
                "admit": t0, "blocks": len(blocks),
                "prefix_tokens": plen}    # the whole prompt came prefilled
        if breakdown:
            meta["handoff"] = dict(breakdown)
        self._req_meta[rid] = meta
        if traced:
            self._traced_live += 1
        slot = self._free.pop()
        self._slot_blocks[slot] = blocks
        if self._prefix is not None and payload["chunks"]:
            created = self._prefix.insert(
                [tuple(c) for c in payload["chunks"]], blocks)
            if created:
                self._slot_nodes[slot] = created
        first = int(payload["first_token"])
        now = time.time()
        self._note_first_token(meta, t0, now)
        if "handoff" in meta:
            meta["handoff"]["import_s"] = now - t0
        if self.token_callback is not None:
            self.token_callback(rid, first)
        self._slots[slot] = {
            "rid": rid, "out": [first], "max_new": max_new, "pos": plen,
            "last": first,
            "la_blocks": self._lookahead_blocks(plen, max_new)}
        self._maybe_finish(slot)
        if self._draft_cache is not None and slot in self._slots:
            # The drafter's dense cache never travels: it prefills the
            # whole prompt here.
            with llama.fp32_reduction(self.device, self.config.dtype):
                self._run_draft_prefill([(slot, prompt)])
        self._dirty = True
        self.handoff_imports += 1
        return rid

    def _drain_in_flight(self) -> None:
        """Apply every buffered tick in flight, leaving a clean boundary
        (the host's state is the device's): an import may then add a
        slot, which the next step uploads. A no-op at sync_every=1."""
        if self._buf or self._pending is not None:
            self._flush_buffered(force_boundary=True)

    # ------------------------------------------------------------ internals
    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        # spec_k look-ahead tokens past the committed length: rejected
        # draft and verify writes land inside the slot's own reservation.
        return -(-(prompt_len + max_new + self.spec_k) // self.block_size)

    def _lookahead_blocks(self, prompt_len: int, max_new: int) -> int:
        """Blocks of a reservation that are speculative look-ahead."""
        return (self._blocks_needed(prompt_len, max_new)
                - -(-(prompt_len + max_new) // self.block_size))

    def _can_admit_head(self) -> bool:
        """True when the FIFO head could admit now: a free slot and, when
        paged, enough blocks, counting LRU-cached blocks that eviction
        would reclaim and the blocks a radix match would cover. A parked
        matched block counts once: the match revives it without freeing
        anything. The buffered engine forces a sync boundary only then,
        so an arena-blocked head does not collapse its pipelining."""
        if not (self._waiting and self._free):
            return False
        if not self.paged:
            return True
        req = self._waiting[0]
        avail = self.allocator.free_count
        nodes: List[Any] = []
        if self._prefix is not None:
            nodes = self._prefix.match_nodes(self._capped_chunks(req))
        m, need = self._admission_need(req, len(nodes))
        if self._prefix is not None:
            parked = sum(1 for nd in nodes[:m] if nd.refs == 0)
            avail += self._prefix.cached_count - parked
        return need <= avail

    def _admission_need(self, req: Dict[str, Any],
                        matched: int) -> Tuple[int, int]:
        """(prefix blocks used, new blocks to reserve) for a request whose
        capped chunks matched ``matched`` indexed blocks. The match
        buckets DOWN to a power of two, as JAX's does to bound its
        compiled programs. ``_can_admit_head`` and ``_admit`` both ask
        here, so the buffered engine's probe agrees with admission."""
        m = _bucket_floor(matched)
        return m, self._blocks_needed(len(req["prompt"]), req["max_new"]) - m

    def _capped_chunks(self, req: Dict[str, Any]) -> List[tuple]:
        """The chunk keys a match may cover (``_match_cap`` of them)."""
        return self._req_chunks(req)[:self._match_cap(req)]

    def _match_cap(self, req: Dict[str, Any]) -> int:
        """Blocks a match may cover: full prompt blocks, leaving at least
        one prompt token to prefill (the first generated token samples
        from the last prompt position's logits, which the cache does not
        hold)."""
        return (len(req["prompt"]) - 1) // self.block_size

    def _req_chunks(self, req: Dict[str, Any]) -> List[tuple]:
        """Block-aligned chunk keys of a queued request, memoized on it
        (the buffered engine probes a waiting head every step)."""
        chunks = req.get("chunks")
        if chunks is None:
            chunks = req["chunks"] = prompt_chunks(req["prompt"],
                                                   self.block_size)
        return chunks

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """All-or-nothing reservation; when the free list is short,
        refcount-0 cached prefix blocks are evicted first (leaf-first,
        oldest first), so cached state never blocks admission. Pinned
        shared blocks are never touched."""
        if self._prefix is not None and n > self.allocator.free_count:
            evicted = self._prefix.evict(n - self.allocator.free_count)
            if evicted:
                self.allocator.free(evicted)
        return self.allocator.alloc(n)

    def _table_row(self, blocks: List[int]) -> List[int]:
        # Dead tail entries REPEAT the last live block (masked anyway;
        # the kernel stops at the last live block).
        tail = blocks[-1] if blocks else GARBAGE_BLOCK
        return blocks + [tail] * (self.max_blocks - len(blocks))

    def _admit(self) -> None:
        if not (self._waiting and self._free):
            return
        # Drain every admissible request first, grouped by (pow-2 suffix
        # bucket, matched prefix blocks), so an admission burst costs one
        # prefill per group. Paged engines reserve each request's novel
        # blocks up front (FIFO: when the head does not fit the arena
        # even after LRU eviction, admission stops); matched prefix
        # blocks are pinned read-only instead of allocated.
        bs = self.block_size
        padded_cap = self.max_blocks * bs if self.paged else self.max_len
        groups: Dict[tuple, List] = {}
        draft_pending: List[tuple] = []   # (slot, prompt): external drafter
        while self._waiting and self._free:
            req = self._waiting[0]
            blocks: List[int] = []
            matched: List[Any] = []
            chunks: List[tuple] = []
            m = 0
            suffix = req["prompt"]
            if self.paged:
                if self._prefix is not None:
                    chunks = self._req_chunks(req)
                    matched = self._prefix.match(self._capped_chunks(req))
                m, need = self._admission_need(req, len(matched))
                if m < len(matched):
                    # The released tail parks young in the LRU and is
                    # prefilled again.
                    self._prefix.release(matched[m:])
                    matched = matched[:m]
                got = self._alloc_blocks(need)
                if got is None:
                    if matched:
                        self._prefix.release(matched)
                    # A slot is free and the head waits on arena space:
                    # from here its wait is arena wait, not queue wait.
                    meta = self._req_meta.get(req["rid"])
                    if meta is not None:
                        meta.setdefault("arena_blocked", time.time())
                    break
                blocks = [nd.block for nd in matched] + got
                suffix = req["prompt"][m * bs:]
                padded_len = max(min(_bucket(len(suffix)),
                                     padded_cap - m * bs), bs)
                if self._prefix is not None:
                    self.prefix_hit_tokens += m * bs
                    self.prefix_miss_tokens += len(suffix)
                    if m:
                        self.prefix_hit_requests += 1
                        mdefs.CB_PREFIX_HIT_TOKENS.inc(m * bs,
                                                       tags=self._mtags)
                    mdefs.CB_PREFIX_MISS_TOKENS.inc(len(suffix),
                                                    tags=self._mtags)
            else:
                padded_len = min(_bucket(len(suffix)), padded_cap)
            self._waiting.popleft()
            meta = self._req_meta.get(req["rid"])
            if meta is not None:
                meta.update(admit=time.time(), blocks=len(blocks),
                            prefix_tokens=m * bs)
            slot = self._free.pop()
            if self.paged:
                self._slot_blocks[slot] = blocks
            groups.setdefault((padded_len, m), []).append(
                (req, slot, blocks, matched, suffix, chunks))
        for (padded_len, m), group in groups.items():
            n = len(group)
            # The batch dim buckets to a power of two as well. Padding
            # rows REPEAT the last request: its duplicate cache writes
            # carry identical bytes, and its first token is dropped.
            n_pad = min(_bucket(n, floor=1), self.num_slots)
            tokens = np.zeros((n_pad, padded_len), np.int64)
            last_idx = np.zeros(n_pad, np.int64)
            slots = np.zeros(n_pad, np.int64)
            npb = padded_len // bs if self.paged else 0
            tables_w = np.full((n_pad, npb), GARBAGE_BLOCK, np.int64)
            ptables = np.full((n_pad, m), GARBAGE_BLOCK, np.int64)
            for i in range(n_pad):
                _, slot, blocks, _, suffix, _ = group[min(i, n - 1)]
                tokens[i, :len(suffix)] = suffix
                last_idx[i] = len(suffix) - 1
                slots[i] = slot
                # Suffix K/V land in the slot's new blocks (the matched
                # prefix is read-only); bucket padding past the
                # reservation writes masked garbage to block 0.
                k = min(len(blocks) - m, npb)
                tables_w[i, :k] = blocks[m:m + k]
                ptables[i] = blocks[:m]
            pt0 = time.time()    # the prefill span's wall-clock anchor
            t0 = time.perf_counter()
            if self.paged:
                first = self._prefill(tokens, ptables, tables_w, last_idx)
            else:
                first = self._prefill_dense(tokens, slots, last_idx)
            first = first.cpu().numpy()          # N ints: the device sync
            self.prefill_seconds += time.perf_counter() - t0
            first_ts = time.time()
            true_tokens = int(last_idx[:n].sum()) + n
            self.prefill_batches += 1
            self.prefill_requests += n
            self.prefill_tokens += true_tokens
            mdefs.CB_PREFILL_REQUESTS.inc(n, tags=self._mtags)
            mdefs.CB_PREFILL_TOKENS.inc(true_tokens, tags=self._mtags)
            for (req, slot, blocks, matched, _, chunks), tok in zip(group,
                                                                    first):
                tok = int(tok)
                meta = self._req_meta.get(req["rid"])
                if meta is not None:
                    self._note_first_token(meta, pt0, first_ts)
                if self._prefix is not None and chunks:
                    # Index this prompt's full blocks now that their
                    # writes are queued ahead of any later reader. A
                    # chunk already indexed under another block (a cold
                    # twin of this round) stops the walk and leaves the
                    # rest exclusive.
                    created = self._prefix.insert(chunks, blocks,
                                                  start=len(matched))
                    if matched or created:
                        self._slot_nodes[slot] = matched + created
                if self.token_callback is not None:
                    self.token_callback(req["rid"], tok)
                self._slots[slot] = {
                    "rid": req["rid"], "out": [tok],
                    "max_new": req["max_new"],
                    "pos": len(req["prompt"]),   # next decode writes here
                    "last": tok,
                    # Reserved look-ahead blocks (occupied, not free).
                    "la_blocks": (self._lookahead_blocks(
                        len(req["prompt"]), req["max_new"])
                        if self.paged else 0),
                }
                self._maybe_finish(slot)
                if self.role == "prefill":
                    # A prefill engine stops here: park the blocks for
                    # export (a request _maybe_finish completed has
                    # nothing to hand off and stays finished).
                    self._park_for_handoff(slot, req)
                if self._draft_cache is not None and slot in self._slots:
                    draft_pending.append((slot, req["prompt"]))
        if draft_pending:
            self._run_draft_prefill(draft_pending)
        self._dirty = True  # device tokens/positions need re-upload

    def _first_tokens(self, logits):
        first = _next_tokens(logits, self._prefill_count, self.sampling,
                             salt=_PREFILL_SALT)
        self._prefill_count += 1
        return first

    def _prefill(self, tokens, ptables, tables_w, last_idx):
        """Batched bucketed paged prefill of N suffixes ([N, S] padded)
        after an m-block matched prefix (``ptables`` [N, m]: read-only
        arena blocks, gathered a layer at a time and dequantized when
        int8), at positions ``m * bs + arange(S)``. Writes each row's
        suffix K/V into its blocks IN PLACE (rows of ``tables_w``
        [N, S // bs]; overflow entries name the garbage block, where
        duplicate writes keep an arbitrary winner) and returns the N
        first tokens on the device."""
        dev = self.device
        cache = self.cache
        bs = self.block_size
        n, s_pad = tokens.shape
        m = ptables.shape[1]
        pk = pv = None
        if m:
            flat_p = torch.from_numpy(ptables.reshape(-1)).to(dev)
            pk = _ArenaPrefix(cache.k, cache.k_scale, flat_p, n,
                              self.config.dtype)
            pv = _ArenaPrefix(cache.v, cache.v_scale, flat_p, n,
                              self.config.dtype)
        logits, stored = _prefill_forward_paged(
            self.params, torch.from_numpy(tokens).to(dev),
            m * bs + torch.arange(s_pad, device=dev), pk, pv, self.config,
            cache.quantized, last_idx=torch.from_numpy(last_idx).to(dev))
        flat_tables = torch.from_numpy(tables_w.reshape(-1)).to(dev)
        targets = ((cache.k, cache.v, cache.k_scale, cache.v_scale)
                   if cache.quantized else (cache.k, cache.v))
        for arena, part in zip(targets, stored):
            # [L, N, S, ...] -> [L, N * S/bs, bs, ...] block rows.
            blocks = part.reshape(part.shape[0], n * (s_pad // bs), bs,
                                  *part.shape[3:])
            arena.index_copy_(1, flat_tables, blocks.to(arena.dtype))
        return self._first_tokens(logits)

    def _prefill_dense(self, tokens, slots, last_idx):
        """Batched bucketed dense prefill of N prompts ([N, S] padded)
        into cache stripes ``slots`` [N]: gather those stripes, run
        :func:`_forward_cached` over them at positions ``arange(S)``,
        write them back IN PLACE (a padding row repeats its request's
        slot and writes the same values), and return the N first tokens
        on the device."""
        dev = self.device
        idx = torch.from_numpy(slots).to(dev)
        stripes = KVCache(k=self.cache.k[:, idx], v=self.cache.v[:, idx])
        logits, stripes = _forward_cached(
            self.params, torch.from_numpy(tokens).to(dev),
            torch.arange(tokens.shape[1], device=dev), stripes, self.config,
            last_idx=torch.from_numpy(last_idx).to(dev))
        self.cache.k[:, idx] = stripes.k
        self.cache.v[:, idx] = stripes.v
        return self._first_tokens(logits)

    def _run_draft_prefill(self, admitted) -> None:
        """Prefill the external drafter's dense cache for the slots just
        admitted: FULL prompts (the prefix cache shortens only the
        target's prefill), in the main prefill's pow-2 buckets, through
        :func:`_forward_cached` over the slots' stripes, written back in
        place (a padding row repeats its group's last slot). Padding K/V
        past a prompt is dead: the drafter's first write at position p
        lands before p is attended."""
        dev = self.device
        dcfg = self.drafter.config
        by_bucket: Dict[int, List] = {}
        for slot, prompt in admitted:
            blen = min(_bucket(len(prompt)), self.max_len)
            by_bucket.setdefault(blen, []).append((slot, prompt))
        for blen, grp in by_bucket.items():
            n = len(grp)
            n_pad = min(_bucket(n, floor=1), self.num_slots)
            toks = np.zeros((n_pad, blen), np.int64)
            slots = np.zeros(n_pad, np.int64)
            for i in range(n_pad):
                slot, prompt = grp[min(i, n - 1)]
                toks[i, :len(prompt)] = prompt
                slots[i] = slot
            idx = torch.from_numpy(slots).to(dev)
            dc = self._draft_cache
            stripes = KVCache(k=dc.k[:, idx], v=dc.v[:, idx])
            # Only the K/V are wanted: one logits row a prompt, not
            # [N, S, V].
            _forward_cached(self.drafter.params,
                            torch.from_numpy(toks).to(dev),
                            torch.arange(blen, device=dev), stripes, dcfg,
                            last_idx=torch.zeros(n_pad, dtype=torch.long,
                                                 device=dev))
            dc.k[:, idx] = stripes.k
            dc.v[:, idx] = stripes.v

    def _maybe_finish(self, slot: int) -> None:
        st = self._slots.get(slot)
        if st is None:
            return
        done = len(st["out"]) >= st["max_new"] or (
            self.eos_token is not None and st["out"][-1] == self.eos_token)
        if done:
            self._finished[st["rid"]] = st["out"]
            del self._slots[slot]
            self._release_slot(slot)
            self._finish_request(st["rid"], "finished",
                                 tokens=len(st["out"]))

    def _upload_state(self) -> None:
        tokens = np.zeros(self.num_slots, np.int32)
        positions = np.zeros(self.num_slots, np.int32)
        for slot, st in self._slots.items():
            tokens[slot] = st["last"]
            positions[slot] = st["pos"]
        dev = self.device
        self._d_tokens = torch.from_numpy(tokens).to(dev)
        self._d_positions = torch.from_numpy(positions).to(dev)
        # Rewind the dispatched sampling step to the host-applied count:
        # ticks a rewind discarded replay the same step numbers.
        self._d_step = self._applied_steps
        if self.paged:
            tables = np.zeros((self.num_slots, self.max_blocks), np.int32)
            limits = np.zeros(self.num_slots, np.int32)
            for slot, blocks in self._slot_blocks.items():
                tables[slot] = self._table_row(blocks)
                limits[slot] = len(blocks) * self.block_size
            self._d_tables = torch.from_numpy(tables).to(dev)
            self._d_limits = torch.from_numpy(limits).to(dev)
        self._dirty = False

    def _run_tick(self):
        """Dispatch one decode tick. Returns its device row: a fresh [B]
        token vector from the plain tick (buffered rows must not alias),
        or ``(committed [B, k+1], counts [B])`` from a spec tick. At
        k = 0 (spec off, or the adaptive ladder parked at the bottom)
        this is the plain tick."""
        kw = dict(use_kernel=self.use_decode_kernel, sampling=self.sampling)
        k = self._spec_cur_k if self.spec_k else 0
        if k > 0:
            external = self._draft_cache is not None
            (committed, counts, self._d_tokens, self._d_positions,
             self.cache, self._draft_cache, self._d_step) = _spec_tick_paged(
                self.params, self._d_tokens, self._d_positions,
                self._d_tables, self._d_limits, self.cache, self._d_step,
                self.config, k, self.spec_draft_layers,
                draft_params=self.drafter.params if external else None,
                draft_cache=self._draft_cache,
                draft_config=self.drafter.config if external else None,
                **kw)
            self.spec_tick_count += 1
            self._spec_ticks[k] = self._spec_ticks.get(k, 0) + 1
            self._last_tick_k = k
            return committed, counts
        if self.paged:
            (self._d_tokens, self._d_positions, self.cache,
             self._d_step) = _decode_tick_paged(
                self.params, self._d_tokens, self._d_positions,
                self._d_tables, self._d_limits, self.cache, self._d_step,
                self.config, **kw)
        else:
            (self._d_tokens, self._d_positions, self.cache,
             self._d_step) = _decode_tick(
                self.params, self._d_tokens, self._d_positions, self.cache,
                self._d_step, self.config, **kw)
        self.base_tick_count += 1
        self._last_tick_k = 0
        return self._d_tokens

    def _membership(self):
        return [(s, st["rid"]) for s, st in self._slots.items()]

    def _apply_tokens(self, nxt_rows, membership, window=None) -> bool:
        """Book fetched tick rows: [B] token vectors, or (committed
        [B, k+1], counts [B]) pairs of spec ticks, each slot taking its
        first ``counts[slot]`` tokens. True when a request finished.
        ``window`` is the (wall start, wall end) of the host sync window
        the rows cover, booked per traced request for its decode-window
        spans (before ``_maybe_finish`` pops the request's record)."""
        finished_any = False
        applied = drafted = accepted = 0
        track = window is not None and self._traced_live > 0
        if track:
            w1 = window[1]
            w0 = window[0] if window[0] is not None else w1
            entries: Dict[int, list] = {}
        # A tick is one sampling step whatever it committed, so the
        # rewind counter advances a row, not a token.
        self._applied_steps += len(nxt_rows)
        for row in nxt_rows:
            toks, counts = row if isinstance(row, tuple) else (row, None)
            for slot, rid in membership:
                st = self._slots.get(slot)
                if st is None or st["rid"] != rid:
                    continue     # finished earlier in this batch
                if counts is None:
                    window = [toks[slot]]
                else:
                    n = int(counts[slot])
                    window = toks[slot, :n]
                    drafted += toks.shape[1] - 1
                    accepted += n - 1
                for tok in window:
                    tok = int(tok)
                    if self.token_callback is not None:
                        self.token_callback(rid, tok)
                    st["out"].append(tok)
                    st["last"] = tok
                    st["pos"] += 1
                    applied += 1
                    if track:
                        self._record_window_token(rid, entries, w0, w1)
                    self._maybe_finish(slot)
                    if slot not in self._slots:
                        # EOS or max_new inside the window: the rest of
                        # the committed window is past the request's end.
                        finished_any = True
                        break
        self.decoded_tokens += applied
        if applied:
            mdefs.CB_DECODE_TOKENS.inc(applied, tags=self._mtags)
        if drafted:
            self.spec_draft_tokens += drafted
            self.spec_accepted_tokens += accepted
            self._spec_window.append((drafted, accepted))
            mdefs.CB_SPEC_DRAFT_TOKENS.inc(drafted, tags=self._mtags)
            mdefs.CB_SPEC_ACCEPTED_TOKENS.inc(accepted, tags=self._mtags)
        return finished_any

    # Accept-rate controller: shrink k below LOW, grow it above HIGH,
    # hold between; MIN_SAMPLE drafted tokens gate any move.
    _SPEC_RATE_LOW = 0.3
    _SPEC_RATE_HIGH = 0.6
    _SPEC_MIN_SAMPLE = 16

    @property
    def spec_accept_rate(self) -> float:
        """Windowed draft accept rate: accepted / drafted over the last
        ``RAY_TPU_SPEC_WINDOW`` spec rows (0.0 before any draft)."""
        drafted = sum(d for d, _ in self._spec_window)
        if not drafted:
            return 0.0
        return sum(a for _, a in self._spec_window) / drafted

    def _adapt_spec_k(self) -> None:
        """Move the live draft depth along the ladder from the windowed
        accept rate. Called only at clean boundaries (every step when
        ``sync_every == 1``; with no tick in flight when buffered), so a
        buffered fetch never mixes row widths. Parked at k = 0 the engine
        runs the plain tick and re-probes the bottom rung after
        ``RAY_TPU_SPEC_PROBE_TICKS`` boundaries."""
        if not (self.spec_k and self.spec_adaptive):
            return
        if self._spec_cur_k == 0:
            self._spec_probe_countdown -= 1
            if self._spec_probe_countdown <= 0:
                self._spec_cur_k = self._spec_ladder_ks[0]
                self._spec_window.clear()
                self._spec_probe_countdown = self._spec_probe_after
            return
        drafted = sum(d for d, _ in self._spec_window)
        if drafted < self._SPEC_MIN_SAMPLE:
            return
        rate = self.spec_accept_rate
        idx = self._spec_ladder_ks.index(self._spec_cur_k)
        if rate < self._SPEC_RATE_LOW:
            self._spec_cur_k = (self._spec_ladder_ks[idx - 1] if idx > 0
                                else 0)
            self._spec_window.clear()
            self._spec_probe_countdown = self._spec_probe_after
        elif rate > self._SPEC_RATE_HIGH and (
                idx + 1 < len(self._spec_ladder_ks)):
            self._spec_cur_k = self._spec_ladder_ks[idx + 1]
            self._spec_window.clear()

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """Admit waiting requests, run one decode tick over all active
        slots, and return the requests that finished (with
        ``sync_every > 1``, finish detection lags up to 2K ticks).
        Prefill and tick run under :func:`llama.fp32_reduction` (bf16
        GEMMs reduce in fp32). The chaos site ``serve_tick``
        (``delay_tick``) stutters the tick with every request alive.
        ``CB_TICK_MS`` is the tick's dispatch, compute and fetch at
        ``sync_every=1``, its dispatch alone when buffered."""
        if chaos.enabled():
            chaos.inject("serve_tick", engine=self._mtags["engine"])
        self._emit_gauges()
        with llama.fp32_reduction(self.device, self.config.dtype):
            if self.sync_every > 1:
                self._step_buffered()
            else:
                self._adapt_spec_k()
                self._admit()
                if self._slots:
                    if self._dirty:
                        self._upload_state()
                    w0 = time.time() if self._traced_live else None
                    t0 = time.perf_counter()
                    row = self._run_tick()      # .cpu() below: the sync
                    nxt = (tuple(t.cpu().numpy() for t in row)
                           if isinstance(row, tuple) else row.cpu().numpy())
                    mdefs.CB_TICK_MS.observe(
                        (time.perf_counter() - t0) * 1e3, tags=self._mtags)
                    if self._apply_tokens(
                            [nxt], self._membership(),
                            window=(w0, time.time())
                            if w0 is not None else None):
                        self._dirty = True
        out, self._finished = self._finished, {}
        return out

    def _step_buffered(self) -> None:
        # Admission, upload and a change of k only at a clean boundary
        # (no ticks in flight): an upload mid-buffer would rewind the
        # device sequence, and a new k would mix row widths in a fetch.
        clean = not self._buf and self._pending is None
        if clean:
            self._adapt_spec_k()
            self._admit()
        if self._slots:
            if self._dirty and clean:
                self._upload_state()
            if not self._buf and self._traced_live:
                # A fresh buffer starts: its ticks form one sync window
                # for the decode-window spans (the host sees their tokens
                # only at the fetch).
                self._window_t0 = time.time()
            t0 = time.perf_counter()
            self._buf.append(self._run_tick())
            mdefs.CB_TICK_MS.observe((time.perf_counter() - t0) * 1e3,
                                     tags=self._mtags)
        want_admit = self._can_admit_head()
        if len(self._buf) >= self.sync_every or want_admit or (
                not self._slots and (self._buf or self._pending is not None)):
            # The non-K arms drain early: a waiting request with a free
            # slot must not starve behind the pipeline, and a cancel of
            # the last request must not wedge admission.
            self._flush_buffered(force_boundary=want_admit)

    def _stack_buffer(self, buf):
        """Stack buffered tick rows and start their copy to the host:
        [B] rows into one [T, B] tensor, spec rows into ([T, B, k+1],
        [T, B]) (k is fixed across a buffer). On CUDA each copy is
        non-blocking into pinned memory (into pageable memory it would
        be synchronous) and one event marks their end; on the CPU the
        stack is the copy. Returns the fetch for
        :meth:`_rows_from_stacked`."""
        if isinstance(buf[0], tuple):
            parts = tuple(torch.stack([r[i] for r in buf]) for i in (0, 1))
        else:
            parts = (torch.stack(buf),)
        done = None
        if parts[0].device.type == "cuda":
            hosts = tuple(torch.empty(p.shape, dtype=p.dtype,
                                      pin_memory=True) for p in parts)
            for host, part in zip(hosts, parts):
                host.copy_(part, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            parts = hosts
        return (parts if len(parts) == 2 else parts[0]), done

    @staticmethod
    def _rows_from_stacked(fetch):
        """Wait for a fetch to land and split it into per-tick rows (spec
        rows as (committed, counts) pairs)."""
        host, done = fetch
        if done is not None:
            done.synchronize()
        if isinstance(host, tuple):
            toks, counts = (h.numpy() for h in host)
            return list(zip(toks, counts))
        return list(host.numpy())

    def _flush_buffered(self, force_boundary: bool = False) -> None:
        # 1. Apply the PRIOR pending fetch first: its copy overlapped the
        # ticks just buffered. If it finished requests, the buffer is
        # stale speculation over freed slots: discard it and rewind
        # (re-upload host state next step).
        if self._pending is not None:
            fetch, membership, win0 = self._pending
            self._pending = None
            if self._apply_tokens(self._rows_from_stacked(fetch),
                                  membership, window=(win0, time.time())):
                self._buf = []
                self._dirty = True
                return
        if force_boundary and self._buf:
            # A waiting request needs a clean boundary: apply the buffer
            # synchronously instead of pipelining it.
            rows = self._rows_from_stacked(self._stack_buffer(self._buf))
            membership = self._membership()
            self._buf = []
            win0, self._window_t0 = self._window_t0, None
            self._apply_tokens(rows, membership, window=(win0, time.time()))
            self._dirty = True
            return
        if not self._buf:
            return
        # 2. One copy for the whole buffer, landing while the next K
        # ticks run.
        self._pending = (self._stack_buffer(self._buf), self._membership(),
                         self._window_t0)
        self._window_t0 = None
        self._buf = []

    def run_to_completion(self) -> Dict[int, List[int]]:
        """Drive ticks until every submitted request finished."""
        results: Dict[int, List[int]] = {}
        while self.has_work():
            results.update(self.step())
        return results
