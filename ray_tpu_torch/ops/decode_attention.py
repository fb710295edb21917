"""Single-query decode attention over a dense per-slot cache (port of
``ray_tpu/ops/decode_attention.py``).

The ``paged=False`` decode tick attends ONE query token per slot against
that slot's cached prefix (``[B, S_max, KVH, D]``), GQA when the kv
heads divide the q heads. Two versions of one function live here:

* :func:`decode_attention_reference`, the plain PyTorch version: masked
  fp32 softmax attention over the whole cache. The CPU path, the
  yardstick the kernel is held to, and what the paged plain version
  reduces to after its gather.
* the CUDA kernel ``csrc/decode_attention.cu`` (the port of the TPU's
  ``_decode_kernel``), launched by :func:`decode_attention` on CUDA
  tensors. It is split-K (flash-decoding): each slot's tokens are cut
  into chunks of whole 64-token tiles, one block a chunk writes an
  unnormalised partial into a workspace allocated here, and the combine
  kernel it shares with the paged kernel (``csrc/split_combine.cuh``)
  merges them, both from one C call. The layout (group tile, split
  count, chunk) is decided here once, by :func:`dense_layout` from
  shapes alone, and passed to the kernel. ``decode_attention.launches``
  counts one per call (both CUDA launches together).

Dispatch: a CUDA tensor launches the kernel or raises (a failed build or
launch, or a shape or dtype the kernel does not take, is an error, never
a silent fall back to the plain version); a CPU tensor takes the plain
version; ``use_kernel=False`` asks for the plain version on any device
and ``use_kernel=True`` on the CPU raises. :func:`decode_applicable` is
the JAX package's shape gate, reported for diagnostics; the kernel
itself takes wider shapes (any ``S_max``, ``d % 8 == 0``, ``d <= 256``)
and tiles by 64 tokens whatever ``block_k`` says.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import threading
from typing import Optional

import torch

from ray_tpu_torch.ops import _build, _split

# Masked scores are -1e30, not -inf: fully masked garbage rows in freed
# slots must softmax to finite values, not NaN. The CUDA kernels use the
# same value so kernel-on/off greedy decode stays token-for-token equal.
MASK_VALUE = -1e30
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def env_flag(name: str) -> Optional[bool]:
    """Tri-state env knob: '1'/'true'/'on'/'yes' -> True,
    '0'/'false'/'off'/'no' -> False, unset/other -> None (auto)."""
    val = os.environ.get(name, "").strip().lower()
    if val in ("1", "true", "on", "yes"):
        return True
    if val in ("0", "false", "off", "no"):
        return False
    return None


def decode_attention_reference(q, cache_k, cache_v, positions,
                               scale: Optional[float] = None):
    """Single-token attention with per-slot positions, in fp32.

    q [B, H, D]; cache [B, S_max, KVH, D]; positions [B] (the absolute
    position each slot's query occupies: cache entries [0..pos] are
    live). Returns [B, H, D] in q's dtype.
    """
    b, hq, d = q.shape
    s_max, hkv = cache_k.shape[1], cache_k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d).float()
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, cache_k.float()) * scale
    slots = torch.arange(s_max, device=q.device)
    mask = positions.long()[:, None] >= slots[None, :]       # [B, S_max]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.tensor(MASK_VALUE, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, cache_v.float())
    return out.reshape(b, hq, d).to(q.dtype)


def decode_applicable(s_max: int, d: int, hq: int, hkv: int, *,
                      block_k: int = 512) -> bool:
    """The JAX package's gate for its fused kernel: whole query groups,
    ``d % 128 == 0`` and ``S_max`` a multiple of ``min(block_k, S_max)``.
    Reported for diagnostics, as ``flash_applicable`` is; the CUDA kernel
    takes wider shapes (see :func:`decode_attention`)."""
    return not (hq % hkv or d % 128 or s_max % min(block_k, s_max))


@functools.lru_cache(maxsize=None)
def dense_layout(batch: int, hq: int, hkv: int, s_max: int, num_sms: int):
    """(group tile, split count, chunk tokens) of the kernel for these
    shapes: enough chunks of whole 64-token tiles over ``S_max`` that the
    (slot, group tile, chunk) blocks number about
    ``_split.BLOCKS_PER_SM`` per SM. Shapes only, never ``positions``:
    reading them would make every tick wait for the device. The one place
    the layout is decided; the C entry point checks and uses it."""
    gt = _split.group_tile(hq // hkv)
    splits = _split.choose_splits(s_max, batch * hq // gt, num_sms)
    return gt, splits, _split.chunk_tokens(s_max, splits)


# The split kernel's fp32 workspace, one per (device, stream) and kept
# between calls (``_split.workspace``). The lock keeps two threads from
# interleaving their launches on one stream (ctypes drops the GIL).
_workspaces = {}
_workspace_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_fn():
    lib = _build.load("decode_attention")
    fn = lib.ray_tpu_decode_attention
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # q k v positions out ws_acc ws_ml; batch hq hkv d s_max gt splits
        # chunk; 5 strides; scale, dtypes, stream
        fn.argtypes = ([vp] * 7 + [i] * 8 + [ll] * 5
                       + [ctypes.c_float, i, i, vp])
        fn.restype = ctypes.c_int
    return lib, fn


def _decode_cuda(q, cache_k, cache_v, positions, scale):
    b, hq, d = q.shape
    _, s_max, hkv, _ = cache_k.shape
    dev = q.device
    if any(t.device != dev for t in (cache_k, cache_v, positions)):
        raise ValueError(f"decode_attention: all inputs must be on {dev}")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(
            f"decode_attention kernel does not take d={d} (needs d % 8 == "
            f"0, d <= {MAX_HEAD_DIM})")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (fp32, bf16)")
    if cache_k.dtype not in _DTYPE_CODES or cache_v.dtype != cache_k.dtype:
        raise ValueError(f"cache dtype {cache_k.dtype}/{cache_v.dtype} not "
                         "supported (fp32 or bf16, k and v alike)")
    if cache_v.shape != cache_k.shape or cache_v.stride() != cache_k.stride():
        raise ValueError("cache_k and cache_v must share shape and strides")
    if tuple(positions.shape) != (b,) or cache_k.shape[0] != b \
            or cache_k.shape[3] != d:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, cache "
                         f"{tuple(cache_k.shape)}, positions "
                         f"{tuple(positions.shape)}")
    if cache_k.stride(3) != 1 or q.stride(2) != 1:
        raise ValueError("the last dim of q and the cache must be "
                         "contiguous")
    align = 16 // cache_k.element_size()
    if any(s % align for s in cache_k.stride()[:3]) or any(
            t.data_ptr() % 16 for t in (cache_k, cache_v)):
        raise ValueError("cache rows must be 16-byte aligned (strides a "
                         f"multiple of {align} elements)")
    positions = positions.to(torch.int32).contiguous()
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    gt, splits, chunk = dense_layout(b, hq, hkv, s_max, _num_sms(dev.index))
    lib, fn = _kernel_fn()
    with torch.cuda.device(dev), _workspace_lock:
        stream = torch.cuda.current_stream(dev).cuda_stream
        # Partial sums [B, Hq, splits, D], then (max, sum) [B, Hq,
        # splits, 2].
        ws = _split.workspace(_workspaces, dev, stream,
                              b * hq * splits * (d + 2))
        err = fn(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                 positions.data_ptr(), out.data_ptr(), ws.data_ptr(),
                 ws.data_ptr() + 4 * b * hq * splits * d,
                 b, hq, hkv, d, s_max, gt, splits, chunk,
                 q.stride(0), q.stride(1), *cache_k.stride()[:3],
                 float(scale), _DTYPE_CODES[q.dtype],
                 _DTYPE_CODES[cache_k.dtype], stream)
    if err:
        raise RuntimeError("decode_attention kernel launch failed: "
                           f"{_build.error_string(lib, err)} ({err})")
    decode_attention.launches += 1
    return out


def decode_attention(q, cache_k, cache_v, positions,
                     scale: Optional[float] = None, *, block_k: int = 512,
                     use_kernel: Optional[bool] = None):
    """Decode-step attention. q [B, Hq, D]; cache [B, S_max, Hkv, D]
    (GQA ok; any strides with a contiguous last dim, such as a per-layer
    view of an ``[L, B, S_max, KVH, D]`` cache); positions [B] = each
    slot's current absolute position. Returns [B, Hq, D] in q's dtype.

    ``use_kernel``: None = the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; True = the kernel (raises on the CPU);
    False = the plain version on any device. ``block_k`` is the TPU
    kernel's block; the CUDA kernel splits by whole 64-token tiles
    (:func:`dense_layout`) whatever it says.
    """
    del block_k
    b, hq, d = q.shape
    hkv = cache_k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if use_kernel is None:
        use_kernel = q.is_cuda
    elif use_kernel and not q.is_cuda:
        # Forcing the kernel where it cannot run must fail loudly: a
        # silent plain-version fallback would make parity checks pass
        # vacuously.
        raise RuntimeError("decode_attention(use_kernel=True) needs CUDA "
                           f"tensors; q is on {q.device}")
    if not use_kernel:
        return decode_attention_reference(q, cache_k, cache_v, positions,
                                          scale)
    return _decode_cuda(q, cache_k, cache_v, positions, scale)


decode_attention.launches = 0
