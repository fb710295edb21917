"""Llama inference over a dense KV cache: prefill + single-token decode
(port of ``ray_tpu/models/inference.py``).

The cache is a static-shape ``[L, B, S_max, KVH, D]`` pair per K and V;
position masking handles partial fill. The JAX package threads the cache
functionally through jitted programs; here PyTorch runs eagerly and
:func:`_forward_cached` writes each step's K/V into the cache IN PLACE
(the returned cache is the one passed in). Also here: the layer pieces
the serving engine shares (:func:`_proj`, :func:`_mlp`), the prefill
attention over a cache (:func:`_attend_cached`), the fp32-logit LM
head (:func:`lm_head_logits`) and the speculative-decode drafters
(:class:`SelfDrafter`, :class:`ExternalLlamaDrafter`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch._private import cuda_monitor
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S_max, KVH, D]
    v: torch.Tensor

    @classmethod
    def create(cls, config: llama.LlamaConfig, batch_size: int,
               max_len: int, device=None) -> "KVCache":
        device = llama.default_device(device)
        shape = (config.num_layers, batch_size, max_len,
                 config.num_kv_heads, config.head_dim)
        return cls(k=torch.zeros(shape, dtype=config.dtype, device=device),
                   v=torch.zeros(shape, dtype=config.dtype, device=device))


class SelfDrafter:
    """Speculative-decode drafter that is the target model, truncated:
    its first ``draft_layers`` decoder layers plus the target's own final
    norm and LM head. Those layers compute the K/V the target writes, so
    the drafter reads and writes the target's paged arena (layers
    [0:n)) in place: context K/V is already there, and verify rewrites
    the positions the drafts wrote before any query reads them.

    ``draft_layers=None`` defers to the engine
    (``RAY_TPU_SPEC_DRAFT_LAYERS``, else num_layers // 4)."""

    external = False

    def __init__(self, draft_layers: Optional[int] = None):
        self.draft_layers = draft_layers


class ExternalLlamaDrafter:
    """Speculative-decode drafter backed by a separate (small) Llama
    sharing the target's vocabulary. The engine keeps its dense per-slot
    :class:`KVCache`, fills it by a prefill of the full prompt at
    admission and advances it in the spec tick's draft steps; a rewind
    needs nothing from it, because entries past a slot's committed
    length are overwritten before they are attended.

    ``params`` must live on the engine's device; None draws random
    weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (None means ``cuda``, and with no GPU that raises)."""

    external = True

    def __init__(self, config: llama.LlamaConfig, params=None,
                 seed: int = 0, device=None):
        self.config = config
        if params is None:
            device = llama.default_device(device)
            gen = torch.Generator(device=device).manual_seed(seed)
            params = llama.init_params(config, gen, device=device)
        self.params = params


def _layer(params, li: int) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s weights: views into the stacked ``[L, ...]``
    tensors."""
    return {k: v[li] for k, v in params["layers"].items()}


def _proj(h, w):
    """``einsum("bse,e...->bs...")`` as one matrix product: h [B, S, E],
    w [E, ...] -> [B, S, ...]."""
    b, s, e = h.shape
    return (h.reshape(b * s, e) @ w.reshape(e, -1)).reshape(
        b, s, *w.shape[1:])


def _mlp(x, layer, c):
    """Residual gated MLP: x + w_down(silu(w_gate h) * w_up h) with h the
    mlp-normed x."""
    h = rms_norm(x, layer["mlp_norm"], c.rms_eps)
    gate = _proj(h, layer["w_gate"].to(c.dtype))
    up = _proj(h, layer["w_up"].to(c.dtype))
    return x + _proj(F.silu(gate) * up, layer["w_down"].to(c.dtype))


def _attend_cached(q, cache_k, cache_v, q_positions, scale):
    """q: [B, S, H, D] at absolute positions; cache: [B, S_max, KVH, D].

    Causal masking is positional: the query at position p sees cache
    slots [0..p]; unfilled slots are masked by the same rule. fp32
    throughout, masked at -1e30, output in q's dtype.
    """
    b, s, hq, d = q.shape
    s_max, hkv = cache_k.shape[1], cache_k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, d).float()
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, cache_k.float()) * scale
    slots = torch.arange(s_max, device=q.device)
    mask = q_positions.long()[:, None] >= slots[None, :]     # [S, S_max]
    logits = torch.where(mask[None, :, None, None, :], logits,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", probs, cache_v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def _block(x, layer, cache_k, cache_v, positions, cos, sin, c):
    """One decoder layer over tokens at ``positions`` [S] (consecutive,
    inside the cache). Writes their K/V into ``cache_k``/``cache_v``
    ([B, S_max, KVH, D]) IN PLACE, then attends over the cache. Returns
    (x, cache_k, cache_v)."""
    scale = c.head_dim ** -0.5
    h = rms_norm(x, layer["attn_norm"], c.rms_eps)
    q = apply_rope(_proj(h, layer["wq"].to(c.dtype)), cos, sin)
    k = apply_rope(_proj(h, layer["wk"].to(c.dtype)), cos, sin)
    v = _proj(h, layer["wv"].to(c.dtype))
    cache_k.index_copy_(1, positions.long(), k.to(cache_k.dtype))
    cache_v.index_copy_(1, positions.long(), v.to(cache_v.dtype))
    o = _attend_cached(q, cache_k, cache_v, positions, scale)
    x = x + _proj(o.reshape(*o.shape[:2], -1),
                  layer["wo"].to(c.dtype).reshape(-1, c.hidden_size))
    return _mlp(x, layer, c), cache_k, cache_v


def lm_head_logits(x, params, config: llama.LlamaConfig):
    """Final-norm hidden states [B, S, E] -> fp32 logits [B, S, V]
    (:func:`ray_tpu_torch.models.llama.head_logits`): the product runs
    in the params' storage dtype with fp32 accumulation AND fp32 output,
    as JAX's ``preferred_element_type`` does; a bf16 ``matmul`` would
    round the logits to bf16 and break greedy ties."""
    return llama.head_logits(x.to(config.dtype),
                             params["lm_head"].to(config.dtype))


def _forward_cached(params, tokens, positions, cache: KVCache,
                    config: llama.LlamaConfig, *, last_idx=None):
    """tokens [B, S] at absolute ``positions`` [S]; returns (logits,
    cache), the cache written in place. Logits are [B, S, V] fp32, or
    [B, 1, V] at each row's ``last_idx`` [B] when given (a caller that
    needs only those skips the rest of the LM head)."""
    c = config
    cos, sin = rope_frequencies(c.head_dim, tokens.shape[1], c.rope_theta,
                                positions=positions)
    x = params["embed"].to(c.dtype)[tokens.long()]
    for li in range(c.num_layers):
        x, _, _ = _block(x, _layer(params, li), cache.k[li], cache.v[li],
                         positions, cos, sin, c)
    x = rms_norm(x, params["final_norm"], c.rms_eps)
    if last_idx is not None:
        x = torch.gather(x, 1, last_idx.long()[:, None, None].expand(
            -1, 1, x.shape[-1]))
    return lm_head_logits(x, params, c), cache


class LlamaGenerator:
    """Prefill + decode loop over a dense :class:`KVCache` for one model
    instance (the JAX package compiles both; here they run eagerly).

    ``device``: None means ``cuda``, and with no GPU that raises (pass
    ``device="cpu"`` for the plain path). ``params`` must already live
    there; None draws random weights from ``seed`` on the device.
    Attention is the plain :func:`_attend_cached`, as in JAX's generator:
    the decode kernels serve the engine's ticks.
    """

    def __init__(self, config: llama.LlamaConfig, params=None,
                 max_len: int = 512, seed: int = 0, device=None):
        self.config = config
        self.max_len = max_len
        self.device = llama.default_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(config, gen, device=self.device)
        self.params = params
        cfg, dev = config, self.device

        # The whole-prompt prefill runs once per distinct prompt length
        # (the batch API pads nothing): compile-tracked, no retrace rule.
        # The engine is the bucketed serving path.
        def prefill(params, tokens, cache):
            return _forward_cached(params, tokens,
                                   torch.arange(tokens.shape[1], device=dev),
                                   cache, cfg)

        def decode(params, token, cache, pos):
            logits, cache = _forward_cached(
                params, token[:, None], torch.tensor([pos], device=dev),
                cache, cfg)
            return logits[:, -1], cache

        # Costs by formula (no count on the serving path): the layers and
        # the head on every row, every (query, cache key) pair of the
        # plain cached attention; bytes the params and the cache once.
        pbytes = sum(t.numel() * t.element_size() for t in (
            list(params["layers"].values())
            + [v for k, v in params.items() if k != "layers"]))

        def cost(params, tokens, cache, *_):
            b, s = tokens.shape[0], (tokens.shape[1] if tokens.dim() > 1
                                     else 1)
            keys = cache.k.shape[2]
            return {"flops": float(llama.forward_flops(
                        cfg, b * s, b * s * keys, b * s)),
                    "bytes_accessed": float(
                        pbytes + 2 * cache.k.numel() * cache.k.element_size())}

        self._prefill = cuda_monitor.instrument(prefill, name="llama_prefill",
                                                shape_policy="free", cost=cost)
        self._decode = cuda_monitor.instrument(decode, name="llama_decode",
                                               cost=cost)

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0):
        """prompt_tokens: [B, P] ints. Returns [B, max_new_tokens] int32
        on the generator's device. ``temperature > 0`` samples the
        softmax of ``logits / temperature`` with a ``torch.Generator``
        seeded from ``seed`` (deterministic per seed; not JAX's bits)."""
        tokens = torch.as_tensor(prompt_tokens, device=self.device).long()
        b, p = tokens.shape
        if p + max_new_tokens > self.max_len:
            raise ValueError(f"prompt ({p}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds "
                             f"max_len={self.max_len}")
        cache = KVCache.create(self.config, b, self.max_len, self.device)
        logits, cache = self._prefill(self.params, tokens, cache)
        last = logits[:, p - 1]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        for pos in range(p, p + max_new_tokens):
            if temperature > 0:
                probs = torch.softmax(last / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = last.argmax(dim=-1)
            out.append(nxt.to(torch.int32))
            if len(out) == max_new_tokens:
                break                  # the last token needs no logits
            last, cache = self._decode(self.params, nxt, cache, pos)
        return torch.stack(out, dim=1)
