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

Not in this slice (each raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it): the prefix cache (off by default here,
on in the JAX package), buffered ``sync_every > 1`` decode, speculative
decode and disaggregated roles.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.inference import (KVCache, _attend_cached,
                                            _forward_cached, _layer, _mlp,
                                            _proj, lm_head_logits)
from ray_tpu_torch.models.paged_kv import (GARBAGE_BLOCK, BlockAllocator,
                                           PagedKVCache, quantize_kv,
                                           resolve_kv_dtype)
from ray_tpu_torch.models.sampling import (SamplingParams, sample_tokens,
                                           step_key)
from ray_tpu_torch.ops.decode_attention import decode_attention, env_flag
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.paged_decode_attention import paged_decode_attention
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies


def _apply_rope_batched(x, cos, sin):
    """RoPE with per-batch angles: x [B, 1, H, D], cos/sin [B, D//2]."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, None, None, :]
    s = sin[:, None, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


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
    tokens; one entry per slot written at ``flat_pos`` [B] (= block_id *
    bs + offset). Returns ``arena``. Freed slots all target the garbage
    block: ``index_copy_`` with duplicate indices keeps an arbitrary
    one of them, which is harmless because only freed slots ever attend
    block 0."""
    nb, bs = arena.shape[0], arena.shape[1]
    flat = arena.view(nb * bs, *arena.shape[2:])
    flat.index_copy_(0, flat_pos, new.to(arena.dtype))
    return arena


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


def _layer_qkv(x, layer, cos, sin, c):
    """Per-layer projections of the tick: attn-norm, Q/K/V, RoPE on Q and
    K (V unrotated). x [B, 1, E]; cos/sin [B, D//2]."""
    h = rms_norm(x, layer["attn_norm"], c.rms_eps)
    q = _proj(h, layer["wq"].to(c.dtype))
    k = _proj(h, layer["wk"].to(c.dtype))
    v = _proj(h, layer["wv"].to(c.dtype))
    return (_apply_rope_batched(q, cos, sin),
            _apply_rope_batched(k, cos, sin), v)


def _layer_finish(x, o, layer, c):
    """Per-layer tail of the tick: attention output projection + gated
    MLP. o [B, H, D]."""
    b = o.shape[0]
    x = x + (o.reshape(b, -1) @ layer["wo"].to(c.dtype).reshape(
        -1, c.hidden_size))[:, None, :]
    return _mlp(x, layer, c)


def _decode_tick(params, tokens, positions, cache: KVCache, step: int,
                 config: llama.LlamaConfig, use_kernel: bool = False,
                 sampling: SamplingParams = SamplingParams()):
    """One decode step for every slot over the dense cache: tokens [B] at
    per-slot absolute ``positions`` [B]. Writes each slot's new K/V into
    ``cache`` in place and returns (next_tokens [B], positions + 1,
    cache, step + 1). ``use_kernel`` routes attention through the dense
    CUDA kernel (True) or its plain version (False)."""
    c = config
    cos, sin = rope_frequencies(c.head_dim, 0, c.rope_theta,
                                positions=positions)
    x = params["embed"].to(c.dtype)[tokens.long()][:, None, :]
    scale = c.head_dim ** -0.5
    rows = _slot_rows(positions, cache.k.shape[2])
    for li in range(c.num_layers):
        layer = _layer(params, li)
        q, k, v = _layer_qkv(x, layer, cos, sin, c)
        ck = _scatter_slot(cache.k[li], k[:, 0], rows)
        cv = _scatter_slot(cache.v[li], v[:, 0], rows)
        o = decode_attention(q[:, 0], ck, cv, positions, scale,
                             use_kernel=use_kernel)
        x = _layer_finish(x, o.to(x.dtype), layer, c)
    x = rms_norm(x, params["final_norm"], c.rms_eps)
    logits = lm_head_logits(x, params, c)
    next_tokens = _next_tokens(logits, step, sampling)
    return next_tokens, positions + 1, cache, step + 1


def _decode_tick_paged(params, tokens, positions, tables, limits,
                       cache: PagedKVCache, step: int,
                       config: llama.LlamaConfig, use_kernel: bool = False,
                       sampling: SamplingParams = SamplingParams()):
    """One decode step for every slot: tokens [B] at per-slot absolute
    ``positions`` [B]; ``tables`` [B, max_blocks] int32 (dead tail
    entries repeat the last live block; freed slots point wholesale at
    the garbage block); ``limits`` [B] is each slot's table-covered token
    count. Writes each slot's new K/V into ``cache`` in place and returns
    (next_tokens [B], positions + 1, cache, step + 1)."""
    c = config
    quantized = cache.quantized
    bs = cache.block_size
    cos, sin = rope_frequencies(c.head_dim, 0, c.rope_theta,
                                positions=positions)
    x = params["embed"].to(c.dtype)[tokens.long()][:, None, :]
    scale = c.head_dim ** -0.5
    # The tick writes at `positions`: resolve each slot's target block
    # once (shared by every layer). A write past ``limits`` would alias
    # the slot's last live block through the table tail, so it goes to
    # the garbage block instead.
    pos = positions.long()
    gathered = torch.gather(tables.long(), 1, (pos // bs)[:, None])[:, 0]
    block_idx = torch.where(pos < limits.long(), gathered,
                            torch.full_like(gathered, GARBAGE_BLOCK))
    flat_pos = block_idx * bs + pos % bs                        # [B]

    for li in range(c.num_layers):
        layer = _layer(params, li)
        q, k, v = _layer_qkv(x, layer, cos, sin, c)
        k_tok, v_tok = k[:, 0], v[:, 0]                         # [B, KVH, D]
        ksl = vsl = None
        if quantized:
            kq, ksc = quantize_kv(k_tok)
            vq, vsc = quantize_kv(v_tok)
            ksl = _scatter_arena(cache.k_scale[li], ksc, flat_pos)
            vsl = _scatter_arena(cache.v_scale[li], vsc, flat_pos)
        else:
            kq, vq = k_tok, v_tok
        ck = _scatter_arena(cache.k[li], kq, flat_pos)
        cv = _scatter_arena(cache.v[li], vq, flat_pos)
        o = paged_decode_attention(q[:, 0], ck, cv, tables, positions,
                                   scale, k_scale=ksl, v_scale=vsl,
                                   use_kernel=use_kernel)
        x = _layer_finish(x, o.to(x.dtype), layer, c)
    x = rms_norm(x, params["final_norm"], c.rms_eps)
    logits = lm_head_logits(x, params, c)
    next_tokens = _next_tokens(logits, step, sampling)
    return next_tokens, positions + 1, cache, step + 1


def _prefill_forward_paged(params, tokens, positions, pk, pv, config,
                           quantized, last_idx=None):
    """Prefill forward over ``[prefix ++ suffix]``.

    ``tokens`` [N, S] at absolute ``positions`` [S]; ``pk``/``pv``
    [L, N, P, KVH, D] hold prefix K/V as attention reads it (None: no
    prefix, the only case this slice's engine uses). Returns
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
    """Explicit arg > ``RAY_TPU_PREFIX_CACHE`` env > OFF (the JAX
    package defaults it on; here it waits for its port)."""
    if prefix_cache is None:
        prefix_cache = env_flag("RAY_TPU_PREFIX_CACHE")
    if prefix_cache:
        raise llama.not_ported("prefix_cache=True",
                               "item 4 (engine features: the prefix cache)")
    return False


def _resolve_spec_k(spec_k: Optional[int]) -> int:
    """Explicit arg > ``RAY_TPU_SPEC_K`` env > 0."""
    if spec_k is None:
        raw = os.environ.get("RAY_TPU_SPEC_K", "").strip()
        spec_k = int(raw) if raw else 0
    spec_k = int(spec_k)
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if spec_k:
        raise llama.not_ported("speculative decoding (spec_k > 0)",
                               "item 4 (engine features: speculative decode)")
    return 0


def _resolve_role(role: Optional[str]) -> str:
    """Explicit arg > ``RAY_TPU_SERVE_ROLE`` env > "both"."""
    if role is None:
        role = os.environ.get("RAY_TPU_SERVE_ROLE", "").strip() or "both"
    role = str(role).lower()
    if role not in ("prefill", "decode", "both"):
        raise ValueError(
            f"role must be one of ('prefill', 'decode', 'both'), "
            f"got {role!r}")
    if role != "both":
        raise llama.not_ported(f"role={role!r}",
                               "item 4 (engine features: the prefill/decode "
                               "split)")
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


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed pool of KV-cache slots."""

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

        ``paged`` (default on; ``RAY_TPU_PAGED_KV=0`` turns it off)
        selects the data plane. Paged: a shared arena of ``block_size``-
        token blocks with per-slot block tables; admission reserves each
        request's blocks all-or-nothing, so a request can wait on arena
        space. ``kv_dtype`` ('bf16' = the model dtype, or 'int8' with
        per-token per-head scales) selects arena storage; ``num_blocks``
        sizes the arena (default: every slot at ``max_len`` plus the
        garbage block). Dense (``paged=False``): one ``max_len`` stripe
        per slot in the model dtype; ``block_size``, ``kv_dtype``,
        ``num_blocks`` and ``prefix_cache`` are ignored, as in JAX.
        ``sampling`` is a
        :class:`~ray_tpu_torch.models.sampling.SamplingParams` or dict;
        the default is greedy."""
        self.config = config
        self.device = llama.default_device(device)
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_token = eos_token
        if int(sync_every) > 1:
            raise llama.not_ported("buffered decode (sync_every > 1)",
                                   "item 4 (engine features: buffered "
                                   "decode)")
        self.sync_every = 1
        self.sampling = SamplingParams.coerce(sampling)
        self.paged = _resolve_paged(paged)
        self.role = _resolve_role(role)
        self.spec_k = _resolve_spec_k(spec_k)
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
        if self.device.type == "cuda" and config.dtype == torch.bfloat16:
            # bf16 products reduce in fp32: the JAX package's numerics.
            torch.backends.cuda.matmul.\
                allow_bf16_reduced_precision_reduction = False
        self.base_tick_count = 0        # decode-tick dispatches
        self.decoded_tokens = 0         # committed decode tokens
        self.prefill_batches = 0
        self.prefill_requests = 0
        self.prefill_tokens = 0
        self.prefill_seconds = 0.0      # dispatch -> first-token sync
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(config, gen, device=self.device)
        self.params = params
        self.token_callback = token_callback
        if self.paged:
            self.max_blocks = -(-max_len // self.block_size)
            self.num_blocks = int(num_blocks if num_blocks is not None
                                  else num_slots * self.max_blocks + 1)
            self.cache = PagedKVCache.create(config, self.num_blocks,
                                             self.block_size, self.kv_dtype,
                                             device=self.device)
            self.allocator = BlockAllocator(self.num_blocks)
            self._slot_blocks: Dict[int, List[int]] = {}
        else:
            self.cache = KVCache.create(config, num_slots, max_len,
                                        device=self.device)
        self._free: List[int] = list(range(num_slots))
        self._slots: Dict[int, Dict[str, Any]] = {}   # slot -> request
        # Decode state on the device between ticks, uploaded only when
        # slot membership changes.
        self._d_tokens = None
        self._d_positions = None
        self._d_tables = None
        self._d_limits = None
        self._applied_steps = 0   # sampling step of the next tick
        self._prefill_count = 0   # per-dispatch prefill sampling stream
        self._dirty = True
        self._waiting: deque = deque()
        self._rid = itertools.count()
        self._finished: Dict[int, List[int]] = {}

    # ---------------------------------------------------------------- api
    def submit(self, prompt_tokens: List[int],
               max_new_tokens: int = 32) -> int:
        """Queue a request; returns its id. It joins the next tick with a
        free slot (and, paged, enough free arena blocks)."""
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
        self._waiting.append({"rid": rid, "prompt": list(prompt_tokens),
                              "max_new": max_new_tokens})
        return rid

    def _release_slot(self, slot: int) -> None:
        self._free.append(slot)
        if self.paged:
            blocks = self._slot_blocks.pop(slot, None)
            if blocks:
                self.allocator.free(blocks)

    def cancel(self, rid: int) -> bool:
        """Drop a request: frees its slot and blocks, or its queue spot,
        or its unread result."""
        for i, req in enumerate(self._waiting):
            if req["rid"] == rid:
                del self._waiting[i]
                return True
        for slot, st in list(self._slots.items()):
            if st["rid"] == rid:
                del self._slots[slot]
                self._release_slot(slot)
                self._dirty = True
                return True
        return self._finished.pop(rid, None) is not None

    @property
    def active_count(self) -> int:
        return len(self._slots)

    def has_work(self) -> bool:
        return bool(self._slots or self._waiting or self._finished)

    def kv_block_stats(self) -> Dict[str, float]:
        """Arena occupancy: used/total blocks, live tokens, and the
        fragmentation ratio (reserved-but-unwritten share of used
        blocks). ``cached``/``shared`` stay 0 until the prefix cache is
        ported. Dense engines report zeros."""
        if not self.paged:
            return {"used": 0, "total": 0, "cached": 0, "shared": 0,
                    "live_tokens": 0, "frag_ratio": 0.0}
        used = self.allocator.used_count
        live = sum(st["pos"] for st in self._slots.values())
        cap = used * self.block_size
        return {"used": used, "total": self.num_blocks - 1,
                "cached": 0, "shared": 0, "live_tokens": live,
                "frag_ratio": max(1.0 - live / cap, 0.0) if cap else 0.0}

    # ------------------------------------------------------------ internals
    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.block_size)

    def _table_row(self, blocks: List[int]) -> List[int]:
        # Dead tail entries REPEAT the last live block (masked anyway;
        # the kernel stops at the last live block).
        tail = blocks[-1] if blocks else GARBAGE_BLOCK
        return blocks + [tail] * (self.max_blocks - len(blocks))

    def _admit(self) -> None:
        if not (self._waiting and self._free):
            return
        # Drain every admissible request first, grouped by pow-2 prompt
        # bucket, so an admission burst costs one prefill per bucket.
        # Paged engines reserve each request's blocks up front (FIFO:
        # when the head does not fit the arena, admission stops).
        bs = self.block_size
        padded_cap = self.max_blocks * bs if self.paged else self.max_len
        groups: Dict[int, List] = {}
        while self._waiting and self._free:
            req = self._waiting[0]
            blocks: List[int] = []
            padded_len = min(_bucket(len(req["prompt"])), padded_cap)
            if self.paged:
                got = self.allocator.alloc(
                    self._blocks_needed(len(req["prompt"]), req["max_new"]))
                if got is None:
                    break
                blocks = got
                padded_len = max(padded_len, bs)  # at least one block
            self._waiting.popleft()
            slot = self._free.pop()
            if self.paged:
                self._slot_blocks[slot] = blocks
            groups.setdefault(padded_len, []).append((req, slot, blocks))
        for padded_len, group in groups.items():
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
            for i in range(n_pad):
                req, slot, blocks = group[min(i, n - 1)]
                tokens[i, :len(req["prompt"])] = req["prompt"]
                last_idx[i] = len(req["prompt"]) - 1
                slots[i] = slot
                # Bucket padding past the reservation writes masked
                # garbage to block 0.
                k = min(len(blocks), npb)
                tables_w[i, :k] = blocks[:k]
            t0 = time.perf_counter()
            if self.paged:
                first = self._prefill(tokens, tables_w, last_idx)
            else:
                first = self._prefill_dense(tokens, slots, last_idx)
            first = first.cpu().numpy()          # N ints: the device sync
            self.prefill_seconds += time.perf_counter() - t0
            self.prefill_batches += 1
            self.prefill_requests += n
            self.prefill_tokens += int(last_idx[:n].sum()) + n
            for (req, slot, _blocks), tok in zip(group, first):
                tok = int(tok)
                if self.token_callback is not None:
                    self.token_callback(req["rid"], tok)
                self._slots[slot] = {
                    "rid": req["rid"], "out": [tok],
                    "max_new": req["max_new"],
                    "pos": len(req["prompt"]),   # next decode writes here
                    "last": tok,
                }
                self._maybe_finish(slot)
        self._dirty = True  # device tokens/positions need re-upload

    def _first_tokens(self, logits):
        first = _next_tokens(logits, self._prefill_count, self.sampling,
                             salt=_PREFILL_SALT)
        self._prefill_count += 1
        return first

    def _prefill(self, tokens, tables_w, last_idx):
        """Batched bucketed paged prefill of N prompts ([N, S] padded):
        run the forward, write each row's K/V into its blocks IN PLACE
        (rows of ``tables_w`` [N, S // bs]; overflow entries name the
        garbage block, where duplicate writes keep an arbitrary winner),
        and return the N first tokens on the device."""
        dev = self.device
        cache = self.cache
        bs = self.block_size
        n, s_pad = tokens.shape
        positions = torch.arange(s_pad, device=dev)
        logits, stored = _prefill_forward_paged(
            self.params, torch.from_numpy(tokens).to(dev), positions,
            None, None, self.config, cache.quantized,
            last_idx=torch.from_numpy(last_idx).to(dev))
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

    def _upload_state(self) -> None:
        tokens = np.zeros(self.num_slots, np.int32)
        positions = np.zeros(self.num_slots, np.int32)
        for slot, st in self._slots.items():
            tokens[slot] = st["last"]
            positions[slot] = st["pos"]
        dev = self.device
        self._d_tokens = torch.from_numpy(tokens).to(dev)
        self._d_positions = torch.from_numpy(positions).to(dev)
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
        """Dispatch one decode tick; returns the [B] token vector."""
        kw = dict(use_kernel=self.use_decode_kernel, sampling=self.sampling)
        if self.paged:
            (self._d_tokens, self._d_positions, self.cache,
             _) = _decode_tick_paged(
                self.params, self._d_tokens, self._d_positions,
                self._d_tables, self._d_limits, self.cache,
                self._applied_steps, self.config, **kw)
        else:
            (self._d_tokens, self._d_positions, self.cache,
             _) = _decode_tick(
                self.params, self._d_tokens, self._d_positions, self.cache,
                self._applied_steps, self.config, **kw)
        self.base_tick_count += 1
        return self._d_tokens

    def _apply_tokens(self, nxt_rows, membership) -> bool:
        """Book fetched tick rows; True when a request finished."""
        finished_any = False
        applied = 0
        self._applied_steps += len(nxt_rows)
        for row in nxt_rows:
            for slot, rid in membership:
                st = self._slots.get(slot)
                if st is None or st["rid"] != rid:
                    continue
                tok = int(row[slot])
                if self.token_callback is not None:
                    self.token_callback(rid, tok)
                st["out"].append(tok)
                st["last"] = tok
                st["pos"] += 1
                applied += 1
                self._maybe_finish(slot)
                if slot not in self._slots:
                    finished_any = True
        self.decoded_tokens += applied
        return finished_any

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """Admit waiting requests, run one decode tick over all active
        slots, and return the requests that finished."""
        self._admit()
        if self._slots:
            if self._dirty:
                self._upload_state()
            nxt = self._run_tick().cpu().numpy()   # 4 bytes/slot: the sync
            if self._apply_tokens(
                    [nxt], [(s, st["rid"]) for s, st in self._slots.items()]):
                self._dirty = True
        out, self._finished = self._finished, {}
        return out

    def run_to_completion(self) -> Dict[int, List[int]]:
        """Drive ticks until every submitted request finished."""
        results: Dict[int, List[int]] = {}
        while self.has_work():
            results.update(self.step())
        return results
