"""Paged KV cache: a shared block arena + host-side block allocator
(port of ``ray_tpu/models/paged_kv.py``).

One arena of fixed-size blocks (``[L, num_blocks, block_size, KVH, D]``)
is shared by all slots; each slot's block table names the blocks it
filled, and a free-list allocator on the host hands blocks out. Block 0
is a reserved GARBAGE block: freed slots' masked lanes keep writing
somewhere harmless without branching in the tick. Optional int8 storage
keeps fp32 per-token/per-kv-head scales in block-shaped sidecars.

Unlike the JAX package, the arena is updated IN PLACE (``index_copy_``
on views of these tensors); the engine owns the one copy.

Cross-request prefix reuse: :class:`RadixBlockIndex` maps block-aligned
token-id chunks to the arena blocks already holding their K/V, so a
shared system prompt prefills once and later requests splice its blocks
into their tables read-only. A block is then free (on the allocator's
free list), live (referenced by >= 1 slot; indexed blocks carry a
refcount and are never reclaimed while referenced) or cached (refcount
0, parked in the index's LRU: a later match revives it, arena pressure
reclaims it leaf-first, oldest-first). Block staging for the
prefill/decode split comes with that slice.
"""

from __future__ import annotations

import os
from collections import OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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


class _RadixNode:
    """One block-aligned chunk in the prefix tree. ``refs`` counts the
    slots currently reading this block through their tables; 0 parks the
    node in the index LRU (block content stays valid in the arena)."""

    __slots__ = ("chunk", "block", "parent", "children", "refs")

    def __init__(self, chunk: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_RadixNode"]):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.refs = 0


class RadixBlockIndex:
    """Radix index over block-aligned token-id chunks -> arena block ids.

    Keys are EXACT token tuples (dict equality, no hashing: a collision
    would serve another prompt's K/V), chained parent -> child so chunk
    ``i``'s node is reachable only through the full token prefix
    ``[0, (i+1) bs)`` that determines its K/V (causal attention).

    * :meth:`match` pins every matched node (``refs += 1``, revived out
      of the LRU): matched blocks are spliced into a slot's table
      READ-ONLY and never reclaimed or written while pinned;
    * :meth:`insert` indexes a slot's newly prefilled full-prompt blocks
      (pinned, refs=1); a chunk already indexed under a different block
      (two cold twins in one admission round) stops the walk and leaves
      the loser's remaining blocks exclusive;
    * :meth:`release` unpins; refs==0 parks the node at the LRU's young
      end instead of freeing its block;
    * :meth:`evict` reclaims parked blocks LEAF-FIRST in LRU order. Every
      slot pins a contiguous root chain, so a parked node never has a
      pinned descendant.
    """

    def __init__(self):
        self._root = _RadixNode(None, GARBAGE_BLOCK, None)
        self._lru: "OrderedDict[_RadixNode, None]" = OrderedDict()
        self._live = 0          # nodes with refs >= 1
        self._by_block: Dict[int, _RadixNode] = {}

    # ------------------------------------------------------------ stats
    @property
    def cached_count(self) -> int:
        """Parked refcount-0 blocks the arena can reclaim."""
        return len(self._lru)

    @property
    def shared_count(self) -> int:
        """Indexed blocks currently pinned by at least one slot."""
        return self._live

    @property
    def indexed_count(self) -> int:
        return len(self._by_block)

    # ------------------------------------------------------------- read
    def match_nodes(self,
                    chunks: Sequence[Tuple[int, ...]]) -> List[_RadixNode]:
        """Longest indexed prefix, read-only (NO pinning): the admission
        probe inspects the nodes' refcounts, since pinning a parked node
        revives it without freeing anything."""
        node, out = self._root, []
        for chunk in chunks:
            node = node.children.get(chunk)
            if node is None:
                break
            out.append(node)
        return out

    def match_len(self, chunks: Sequence[Tuple[int, ...]]) -> int:
        """Longest indexed prefix, in blocks (no pinning)."""
        return len(self.match_nodes(chunks))

    # ------------------------------------------------------------ write
    def match(self, chunks: Sequence[Tuple[int, ...]]) -> List[_RadixNode]:
        """Longest indexed prefix, PINNED (each matched node's refcount
        rises, reviving it from the LRU). Pair with :meth:`release`."""
        node, out = self._root, []
        for chunk in chunks:
            node = node.children.get(chunk)
            if node is None:
                break
            self._pin(node)
            out.append(node)
        return out

    def insert(self, chunks: Sequence[Tuple[int, ...]],
               blocks: Sequence[int], start: int = 0) -> List[_RadixNode]:
        """Index ``blocks[start:]`` under ``chunks[start:]`` (the chunks
        before ``start`` were matched: their nodes exist and are pinned
        by this caller). Returns the nodes CREATED (pinned, refs=1). A
        chunk already indexed under a different block stops the walk."""
        node = self._root
        for chunk in chunks[:start]:
            node = node.children[chunk]   # matched path must exist
        created: List[_RadixNode] = []
        for i in range(start, len(chunks)):
            child = node.children.get(chunks[i])
            if child is not None:
                if child.block != blocks[i]:
                    break                 # cold twin lost the race
                node = child
                continue
            child = _RadixNode(chunks[i], blocks[i], node)
            node.children[chunks[i]] = child
            self._by_block[blocks[i]] = child
            self._pin(child)
            created.append(child)
            node = child
        return created

    def release(self, nodes: Sequence[_RadixNode]) -> None:
        """Unpin; refcount 0 parks the node at the LRU young end (the
        block stays resident until reclaimed)."""
        for node in nodes:
            node.refs -= 1
            assert node.refs >= 0, "prefix node over-released"
            if node.refs == 0:
                self._live -= 1
                self._lru[node] = None

    def evict(self, want: int) -> List[int]:
        """Reclaim up to ``want`` parked blocks, leaf-first in LRU order;
        returns their ids for the allocator's free list. A parent joins
        the candidate queue the moment its last child drops, so a deep
        parked chain costs O(evicted)."""
        out: List[int] = []
        ready = deque(nd for nd in self._lru if not nd.children)
        while len(out) < want and ready:
            node = ready.popleft()
            if node.children or node not in self._lru:
                continue                  # defensive: invariant violated
            parent = node.parent
            self._drop(node)
            out.append(node.block)
            if (parent is not None and not parent.children
                    and parent in self._lru):
                ready.append(parent)
        return out

    def clear(self) -> None:
        self._root = _RadixNode(None, GARBAGE_BLOCK, None)
        self._lru.clear()
        self._by_block.clear()
        self._live = 0

    # ---------------------------------------------------------- helpers
    def _pin(self, node: _RadixNode) -> None:
        if node.refs == 0:
            self._live += 1
            self._lru.pop(node, None)
        node.refs += 1

    def _drop(self, node: _RadixNode) -> None:
        self._lru.pop(node, None)
        self._by_block.pop(node.block, None)
        if node.parent is not None:
            node.parent.children.pop(node.chunk, None)


def prompt_chunks(prompt_tokens: Sequence[int],
                  block_size: int) -> List[Tuple[int, ...]]:
    """Block-aligned chunk keys for the shareable region of a prompt:
    only blocks filled entirely by prompt tokens (the tail block mixes
    prompt and generated tokens). The engine further caps a match at
    ``(len(prompt) - 1) // block_size`` blocks, so one prompt token is
    left to prefill for the first token's logits."""
    n = len(prompt_tokens) // block_size
    return [tuple(prompt_tokens[i * block_size:(i + 1) * block_size])
            for i in range(n)]
