"""Paged decode attention: block-table gather over a shared KV arena
(port of ``ray_tpu/ops/paged_decode_attention.py``).

The pooled cache is an arena of fixed-size blocks
(``[num_blocks, block_size, KVH, D]``); each slot owns a block table
naming the blocks it filled, so a decode tick reads only live blocks.
Optional int8 arenas carry fp32 per-token/per-kv-head scales in
block-shaped sidecars (``[num_blocks, block_size, KVH]``).

Two versions of one function live here:

* :func:`paged_attention_reference`, the plain PyTorch version: gather
  the blocks into dense layout, dequantize, then masked fp32 softmax
  attention. The CPU path, and the yardstick the kernel is held to.
* the CUDA kernel ``csrc/paged_decode_attention.cu`` (the port of the
  TPU's ``_paged_kernel``), launched by :func:`paged_decode_attention`
  on CUDA tensors. It is split-K (flash-decoding): each slot's tokens are
  cut into chunks of whole 64-token tiles, one block a chunk writes an
  unnormalised partial into a workspace allocated here, and a combine
  kernel from the same C entry point merges them. The layout (group
  tile, split count, chunk) is decided here once, by :func:`paged_layout`
  from shapes alone (the arithmetic the dense kernel shares lives in
  :mod:`ray_tpu_torch.ops._split`), and passed to the kernel.
  ``paged_decode_attention.launches`` counts one per call (both CUDA
  launches together).

Dispatch: a CUDA tensor launches the kernel or raises (a failed build or
launch is an error, never a silent fall back to the plain version); a
CPU tensor takes the plain version; ``use_kernel=False`` asks for the
plain version on any device and ``use_kernel=True`` on the CPU raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from ray_tpu_torch._private import cuda_monitor
from ray_tpu_torch.ops import _build, _split
from ray_tpu_torch.ops._split import (  # noqa: F401 (this module's API)
    BLOCKS_PER_SM, MAX_SPLITS, SPLIT_TILE, group_tile)
from ray_tpu_torch.ops.decode_attention import decode_attention_reference

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_HEAD_DIM = 256
MAX_TABLE_ENTRIES = 4096     # table entries the kernel takes per slot


def dequantize_block(x, scale):
    """int8 block + per-token/per-head scale -> fp32. ``x`` [..., T, H, D],
    ``scale`` [..., T, H]."""
    return x.float() * scale[..., None]


def gather_kv(arena, tables):
    """Linearize each slot's blocks: arena [NB, bs, ...] gathered through
    tables [B, nb] -> [B, nb*bs, ...]."""
    b, nb = tables.shape
    g = arena[tables.long()]                      # [B, nb, bs, ...]
    return g.reshape(b, nb * arena.shape[1], *arena.shape[2:])


def paged_attention_reference(q, arena_k, arena_v, tables, positions,
                              scale: Optional[float] = None, *,
                              k_scale=None, v_scale=None):
    """Plain version: gather blocks into dense layout, dequantize when
    the arena is int8, then the positional-mask softmax attention.

    q [B, Hq, D]; arena [NB, bs, KVH, D]; tables [B, nb] (row j = the
    slot's j-th logical block; dead entries may repeat blocks, masked out
    by ``positions``); positions [B]. Returns [B, Hq, D] in q's dtype.
    """
    ck = gather_kv(arena_k, tables)
    cv = gather_kv(arena_v, tables)
    if k_scale is not None:
        ck = dequantize_block(ck, gather_kv(k_scale, tables))
        cv = dequantize_block(cv, gather_kv(v_scale, tables))
    return decode_attention_reference(q, ck, cv, positions,
                                      scale).to(q.dtype)


def paged_applicable(block_size: int, d: int, hq: int, hkv: int) -> bool:
    """True when the CUDA kernel takes these shapes: whole query groups,
    ``d % 8 == 0`` (8-element K/V loads) and ``d <= MAX_HEAD_DIM``."""
    return (block_size > 0 and hkv > 0 and hq % hkv == 0 and d % 8 == 0
            and 0 < d <= MAX_HEAD_DIM)


def split_chunk_tokens(nb: int, bs: int, splits: int) -> int:
    """Tokens each of ``splits`` chunks covers: whole 64-token tiles."""
    return _split.chunk_tokens(nb * bs, splits)


def paged_splits(batch: int, hq: int, hkv: int, nb: int, bs: int,
                 num_sms: int) -> int:
    """The split count of the kernel for these shapes: enough chunks that
    the (slot, group tile, chunk) blocks number about ``BLOCKS_PER_SM``
    per SM, each chunk at least one tile. Shapes only: reading
    ``positions`` would make every tick wait for the device."""
    return _split.choose_splits(nb * bs, batch * hq // group_tile(hq // hkv),
                                num_sms)


@functools.lru_cache(maxsize=None)
def paged_layout(batch: int, hq: int, hkv: int, nb: int, bs: int,
                 num_sms: int):
    """(group tile, split count, chunk tokens) of the kernel for these
    shapes: the one place they are decided; the C entry point checks and
    uses them."""
    splits = paged_splits(batch, hq, hkv, nb, bs, num_sms)
    return (group_tile(hq // hkv), splits,
            split_chunk_tokens(nb, bs, splits))


# The split kernels' fp32 workspace, one per (device, stream) and kept
# between calls (``_split.workspace``). The lock keeps two threads from
# interleaving their launches on one stream (ctypes drops the GIL).
_workspaces = {}
_workspace_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_fn():
    lib = _build.load("paged_decode_attention")
    fn = lib.ray_tpu_paged_decode_attention
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # q k v k_scale v_scale tables positions out ws_acc ws_ml;
        # batch hq hkv d bs nb gt splits chunk; 9 strides; scale, dtypes,
        # stream
        fn.argtypes = ([vp] * 10 + [i] * 9 + [ll] * 9
                       + [ctypes.c_float, i, i, vp])
        fn.restype = ctypes.c_int
    return lib, fn


def _paged_cuda(q, arena_k, arena_v, tables, positions, scale, k_scale,
                v_scale):
    b, hq, d = q.shape
    nblocks, bs, hkv, _ = arena_k.shape
    nb = tables.shape[1]
    dev = q.device
    quantized = k_scale is not None
    tensors = [arena_k, arena_v, tables, positions] + (
        [k_scale, v_scale] if quantized else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention: all inputs must be on "
                         f"{dev}")
    if not paged_applicable(bs, d, hq, hkv):
        raise ValueError(
            f"paged_decode_attention kernel does not take hq={hq}, "
            f"hkv={hkv}, d={d} (needs hq % hkv == 0, d % 8 == 0, "
            f"d <= {MAX_HEAD_DIM})")
    if not 0 < nb <= MAX_TABLE_ENTRIES:
        raise ValueError(f"paged_decode_attention kernel takes 1 to "
                         f"{MAX_TABLE_ENTRIES} table entries, got {nb}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported (fp32, bf16)")
    if arena_k.dtype not in _DTYPE_CODES or arena_v.dtype != arena_k.dtype:
        raise ValueError(f"arena dtype {arena_k.dtype} not supported")
    if (arena_k.dtype == torch.int8) != quantized:
        raise ValueError("int8 arenas need k_scale/v_scale and only they "
                         "take them")
    if arena_v.shape != arena_k.shape or arena_v.stride() != arena_k.stride():
        raise ValueError("arena_k and arena_v must share shape and strides")
    if arena_k.stride(3) != 1 or q.stride(2) != 1:
        raise ValueError("the last dim of q and the arena must be "
                         "contiguous")
    if any(s % 8 for s in arena_k.stride()[:3]) or any(
            t.data_ptr() % 16 for t in (arena_k, arena_v)):
        raise ValueError("arena rows must be 16-byte aligned (strides a "
                         "multiple of 8 elements)")
    if quantized:
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or k_scale.shape != arena_k.shape[:3]
                or v_scale.stride() != k_scale.stride()):
            raise ValueError("k_scale/v_scale must be fp32 [NB, bs, KVH] "
                             "with equal strides")
        sc_strides = k_scale.stride()
    else:
        sc_strides = (0, 0, 0)
    tables = tables.to(torch.int32)
    positions = positions.to(torch.int32).contiguous()
    if tables.stride(1) != 1:
        tables = tables.contiguous()
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    gt, splits, chunk = paged_layout(b, hq, hkv, nb, bs, _num_sms(dev.index))
    # The workspace: partial sums [B, Hq, splits, D], then (max, sum)
    # [B, Hq, splits, 2].
    need = b * hq * splits * (d + 2)
    lib, fn = _kernel_fn()
    with torch.cuda.device(dev), _workspace_lock:
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _split.workspace(_workspaces, dev, stream, need)
        err = fn(q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), ws.data_ptr() + 4 * b * hq * splits * d,
                 b, hq, hkv, d, bs, nb, gt, splits, chunk,
                 q.stride(0), q.stride(1),
                 *arena_k.stride()[:3], *sc_strides,
                 tables.stride(0), float(scale),
                 _DTYPE_CODES[q.dtype], _DTYPE_CODES[arena_k.dtype], stream)
    if err:
        raise RuntimeError("paged_decode_attention kernel launch failed: "
                           f"{_build.error_string(lib, err)} ({err})")
    paged_decode_attention.launches += 1
    if cuda_monitor.cost_active():
        live = [min(int(p) + 1, nb * bs) for p in positions.tolist()]
        cuda_monitor.add_kernel_cost(*cuda_monitor.decode_cost(
            sum(live), b, hq, hkv, d, arena_k.element_size(),
            q.element_size(), sum(-(-n // bs) for n in live), quantized))
    return out


def paged_decode_attention(q, arena_k, arena_v, tables, positions,
                           scale: Optional[float] = None, *,
                           k_scale=None, v_scale=None,
                           use_kernel: Optional[bool] = None):
    """Decode-step attention over a paged KV arena.

    q [B, Hq, D]; arena_k/v [NB, bs, KVH, D] (int8 when ``k_scale`` /
    ``v_scale`` [NB, bs, KVH] fp32 are given); tables [B, nb] int32
    (row j = the slot's j-th logical block; dead tail entries should
    repeat the last live block); positions [B].

    ``use_kernel``: None = the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; True = the kernel (raises on the CPU);
    False = the plain version on any device.
    """
    b, hq, d = q.shape
    hkv = arena_k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if use_kernel is None:
        use_kernel = q.is_cuda
    elif use_kernel and not q.is_cuda:
        # Forcing the kernel where it cannot run must fail loudly: a
        # silent plain-version fallback would make parity checks pass
        # vacuously.
        raise RuntimeError(
            "paged_decode_attention(use_kernel=True) needs CUDA tensors; "
            f"q is on {q.device}")
    if not use_kernel:
        return paged_attention_reference(q, arena_k, arena_v, tables,
                                         positions, scale,
                                         k_scale=k_scale, v_scale=v_scale)
    return _paged_cuda(q, arena_k, arena_v, tables, positions, scale,
                       k_scale, v_scale)


paged_decode_attention.launches = 0
