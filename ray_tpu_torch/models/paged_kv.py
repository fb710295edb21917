"""Paged KV cache: a shared block arena + host-side block allocator
(port of ``ray_tpu/models/paged_kv.py``).

One arena of fixed-size blocks (``[L, num_blocks, block_size, KVH, D]``)
is shared by all slots; each slot's block table names the blocks it
filled, and a free-list allocator on the host hands blocks out. Block 0
is a reserved GARBAGE block: freed slots' masked lanes keep writing
somewhere harmless without branching in the tick. Optional int8 storage
keeps fp32 per-token/per-kv-head scales in block-shaped sidecars.

Unlike the JAX package, the arena is updated IN PLACE (``index_copy_``
on views of these tensors); the engine owns the one copy. The radix
prefix index and block staging come with the prefix-cache and
disaggregation slices.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import torch

from ray_tpu_torch.models import llama

GARBAGE_BLOCK = 0

KV_DTYPES = ("bf16", "int8")


def resolve_kv_dtype(kv_dtype: Optional[str]) -> str:
    """Explicit arg > ``RAY_TPU_KV_DTYPE`` env > bf16. "bf16" means the
    model's own dtype (the arena stores K/V as computed)."""
    if kv_dtype is None:
        kv_dtype = os.environ.get("RAY_TPU_KV_DTYPE", "").strip().lower() \
            or "bf16"
    kv_dtype = str(kv_dtype).lower()
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype {kv_dtype!r} not supported (one of {KV_DTYPES})")
    return kv_dtype


def quantize_kv(x):
    """Symmetric per-token/per-kv-head int8: x [..., H, D] -> (int8 same
    shape, fp32 scales [..., H]). Zero vectors quantize to zeros with a
    zero scale. ``torch.round`` rounds half to even, as ``jnp.round``
    does, so the result is bit-equal to the JAX package's."""
    x = x.float()
    amax = x.abs().amax(dim=-1)                          # [..., H]
    scale = amax / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(x / safe[..., None])
    q = q.clamp(-127, 127).to(torch.int8)
    return q, scale


class PagedKVCache(NamedTuple):
    """KV arena: k/v ``[L, NB, bs, KVH, D]``; scales ``[L, NB, bs, KVH]``
    fp32 when the arena is int8, else None."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(cls, config: llama.LlamaConfig, num_blocks: int,
               block_size: int, kv_dtype: str = "bf16",
               device=None) -> "PagedKVCache":
        kv_dtype = resolve_kv_dtype(kv_dtype)
        device = llama.default_device(device)
        shape = (config.num_layers, num_blocks, block_size,
                 config.num_kv_heads, config.head_dim)
        if kv_dtype == "int8":
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device))
        return cls(k=torch.zeros(shape, dtype=config.dtype, device=device),
                   v=torch.zeros(shape, dtype=config.dtype, device=device))

    def token_bytes(self) -> int:
        """Arena bytes one live token occupies across all layers."""
        layers, _, _, kvh, d = self.k.shape
        n = 2 * layers * kvh * d * self.k.element_size()
        if self.k_scale is not None:
            n += 2 * layers * kvh * 4
        return n


class BlockAllocator:
    """Host-side free-list over arena block ids. Block 0 (GARBAGE_BLOCK)
    is never handed out: freed slots keep scattering their masked-lane
    garbage there. LIFO reuse keeps hot blocks hot."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("paged arena needs >= 2 blocks "
                             "(block 0 is reserved)")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._allocated: set = set()   # O(1) double-free detection

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._allocated)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None (all-or-nothing) when the arena can't cover
        them — the caller leaves the request queued."""
        if n <= 0:
            return []      # [-0:] would slice (and drain) the whole list
        if n > len(self._free):
            return None
        taken = self._free[-n:][::-1]
        del self._free[-n:]
        self._allocated.update(taken)
        return taken

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b == GARBAGE_BLOCK:
                raise ValueError("cannot free the reserved garbage block")
            if b not in self._allocated:
                raise ValueError(f"double free / bad block id {b}")
        self._allocated.difference_update(blocks)
        self._free.extend(reversed(blocks))

    def reset(self) -> None:
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._allocated.clear()
