"""Attention ops: plain MHA/GQA and flash attention (port of
``ray_tpu/ops/attention.py``).

Public layout ``[B, S, H, D]``, GQA when the kv heads divide the q heads
(kv head = q head // group). :func:`flash_attention` takes the flash path
on the shapes the JAX package's :func:`flash_applicable` accepts and
returns :func:`mha_reference` elsewhere, as JAX does. On the flash path
two versions of each of the TPU's three kernels live here:

* the plain PyTorch versions :func:`flash_fwd_reference` (``_fwd_kernel``:
  out and lse) and :func:`flash_bwd_reference` (``_dq_kernel`` and
  ``_dkv_kernel``: dq, dk, dv), the same formulas in fp32 on whole
  sequences. The CPU path, and the yardstick the kernels are held to;
* the CUDA kernels, launched on CUDA tensors: for bf16 all three run on
  the tensor cores (``csrc/flash_attention_sm90.cu``); for fp32 all three
  run on the CUDA cores (``csrc/flash_attention.cu``), since tensor cores
  would make them tf32. ``flash_attention.launches`` counts the
  launches of each (``"fwd"``, ``"dq"``, ``"dkv"``).

A ``torch.autograd.Function`` carries them, saving ``(q, k, v, out,
lse)`` like the JAX ``_flash`` custom_vjp; its backward computes
``delta = rowsum(dO * O)`` with a PyTorch reduction (JAX computes it
outside Pallas too), then dq, then dk/dv. ``lse`` is ``[B, Hq, Sq]``
fp32: the TPU's trailing 1 was a tiling artefact.

Dispatch: ``use_kernel=None`` launches the kernels for CUDA tensors and
takes the plain versions for CPU tensors; ``False`` takes the plain
versions on any device; ``True`` on the CPU raises. On CUDA a failed
build or launch raises; nothing falls back. ``block_q``/``block_k`` only
gate the flash path, as on the TPU; the kernels tile by 64 themselves.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ray_tpu_torch._private import cuda_monitor
from ray_tpu_torch.ops import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q, k, v, *, causal: bool = True,
                  scale: Optional[float] = None):
    """Plain attention. q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D] (GQA ok).
    fp32 softmax, output in q's dtype."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        logits = torch.where(_causal_mask(sq, sk, q.device), logits,
                             DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _causal_mask(sq, sk, device):
    """[Sq, Sk] bool, aligned bottom-right: row r sees keys
    ``c <= r + (sk - sq)`` (``tril(k=sk-sq)``)."""
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril(sk - sq)


def _scores(q, k, scale, causal):
    """Masked fp32 scores [B, KVH, G, Sq, Sk] of ``(q * scale) K^T``, q
    scaled before the product as the TPU kernels do."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        s = torch.where(_causal_mask(sq, sk, q.device), s,
                        DEFAULT_MASK_VALUE)
    return s


def flash_fwd_reference(q, k, v, *, scale: float, causal: bool):
    """Plain version of ``_fwd_kernel``: (out [B, Sq, Hq, D] in q's dtype,
    lse [B, Hq, Sq] fp32), softmax over whole rows in fp32. Rows whose
    sum is 0 give zeros, as the kernel's ``safe_l``."""
    b, sq, hq, d = q.shape
    s = _scores(q, k, scale, causal)                  # [B, KVH, G, Sq, Sk]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()) / \
        safe_l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(safe_l))[..., 0].reshape(b, hq, sq)
    return out.reshape(b, sq, hq, d).to(q.dtype), lse


def _delta(out, do):
    """``rowsum(dO * O)`` in fp32, [B, Hq, Sq]."""
    return (out.float() * do.float()).sum(dim=-1).transpose(1, 2)


def flash_bwd_reference(q, k, v, out, lse, do, *, scale: float,
                        causal: bool):
    """Plain version of ``_dq_kernel`` and ``_dkv_kernel``: (dq, dk, dv)
    in the dtypes of q, k, v. Recomputes ``p = exp(s - lse)``, then
    ``ds = p * (dO V^T - delta)``, ``dq = scale * ds K``,
    ``dk = ds^T (q * scale)`` and ``dv = p^T dO``, each summed over the
    query group in fp32."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    s = _scores(q, k, scale, causal)                  # [B, KVH, G, Sq, Sk]
    lse_g = lse.reshape(b, hkv, group, sq, 1)
    delta = _delta(out, do).reshape(b, hkv, group, sq, 1)
    p = torch.exp(s - lse_g)
    dog = do.float().reshape(b, sq, hkv, group, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    qs = q.float().reshape(b, sq, hkv, group, d) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/flash_attention.cu, csrc/flash_attention_sm90.cu)
# ---------------------------------------------------------------------------

# (kernel, dtype) -> (source, C function, pointer arguments). bf16 takes
# the tensor-core source, which has no dtype argument.
_ROUTES = {
    ("fwd", torch.float32): ("flash_attention", "ray_tpu_flash_fwd", 5),
    ("dq", torch.float32): ("flash_attention", "ray_tpu_flash_bwd_dq", 7),
    ("dkv", torch.float32): ("flash_attention", "ray_tpu_flash_bwd_dkv", 8),
    ("fwd", torch.bfloat16): ("flash_attention_sm90",
                              "ray_tpu_flash_fwd_sm90", 5),
    ("dq", torch.bfloat16): ("flash_attention_sm90",
                             "ray_tpu_flash_bwd_dq_sm90", 7),
    ("dkv", torch.bfloat16): ("flash_attention_sm90",
                              "ray_tpu_flash_bwd_dkv_sm90", 8),
}


def kernel_route(which: str, dtype: torch.dtype):
    """The (source, C function) that runs kernel ``which`` (``"fwd"``,
    ``"dq"``, ``"dkv"``) on ``dtype`` inputs."""
    source, fn, _ = _ROUTES[(which, dtype)]
    return source, fn


def _kernel_fn(which, dtype):
    """The loaded C function for ``which`` on ``dtype``, and whether it
    takes a dtype code."""
    source, name, n_ptr = _ROUTES[(which, dtype)]
    lib = _build.load(source)
    fn = getattr(lib, name)
    with_dtype = source == "flash_attention"
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # batch hq hkv sq sk d scale causal [dtype] stream
        fn.argtypes = ([vp] * n_ptr + [i] * 6 + [f, i]
                       + ([i] if with_dtype else []) + [vp])
        fn.restype = ctypes.c_int
    return lib, name, with_dtype


def _prepare(*tensors):
    """Contiguous, 16-byte aligned tensors on one CUDA device."""
    dev = tensors[0].device
    out = []
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"flash_attention: all inputs must be on {dev}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _check(q, k, v, *more):
    """The kernels take one dtype of fp32/bf16 for q, k, v (and dO),
    whole query groups and a head dim of 64 or 128."""
    hq, hkv = q.shape[2], k.shape[2]
    if (q.dtype not in _DTYPE_CODES or hkv == 0 or hq % hkv
            or q.shape[3] not in KERNEL_HEAD_DIMS or v.shape != k.shape
            or any(t.dtype != q.dtype for t in (k, v) + more)):
        raise ValueError(
            f"flash_attention kernels do not take q {tuple(q.shape)} "
            f"{q.dtype}, k/v {tuple(k.shape)} {k.dtype}/{v.dtype} (need "
            f"one dtype of fp32/bf16, hq % hkv == 0, d in "
            f"{KERNEL_HEAD_DIMS})")


def _launch(which, q, ptrs, sizes, scale, causal):
    """Launch kernel ``which`` for ``q``'s dtype on the current stream;
    a refused launch raises."""
    lib, name, with_dtype = _kernel_fn(which, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            *ptrs, *sizes, float(scale), int(causal),
            *([_DTYPE_CODES[q.dtype]] if with_dtype else []), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel {name} launch failed: "
                           f"{_build.error_string(lib, err)} ({err})")
    flash_attention.launches[which] += 1
    if cuda_monitor.cost_active():
        cuda_monitor.add_kernel_cost(*cuda_monitor.flash_cost(
            which, *sizes, bool(causal), q.element_size()))


def _sizes(q, k):
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    return b, hq, hkv, sq, sk, d


def flash_fwd_cuda(q, k, v, *, scale: float, causal: bool):
    """Launch the forward kernel: (out, lse) as :func:`flash_fwd_reference`."""
    _check(q, k, v)
    q, k, v = _prepare(q, k, v)
    b, hq, _, sq, _, _ = sizes = _sizes(q, k)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _launch("fwd", q, [t.data_ptr() for t in (q, k, v, out, lse)], sizes,
            scale, causal)
    return out, lse


def flash_dq_cuda(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """Launch the dq kernel (``delta`` = fp32 [B, Hq, Sq]); returns dq."""
    _check(q, k, v, do)
    q, k, v, do, lse, delta = _prepare(q, k, v, do, lse.float(),
                                       delta.float())
    dq = torch.empty_like(q)
    _launch("dq", q, [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)],
            _sizes(q, k), scale, causal)
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, *, scale: float, causal: bool):
    """Launch the dk/dv kernel; returns (dk, dv) in k's layout."""
    _check(q, k, v, do)
    q, k, v, do, lse, delta = _prepare(q, k, v, do, lse.float(),
                                       delta.float())
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", q, [t.data_ptr() for t in (q, k, v, do, lse, delta, dk,
                                                dv)], _sizes(q, k), scale,
            causal)
    return dk, dv


def flash_bwd_cuda(q, k, v, out, lse, do, *, scale: float, causal: bool):
    """``delta`` by a PyTorch reduction, then the dq and dk/dv kernels:
    (dq, dk, dv) as :func:`flash_bwd_reference`."""
    delta = _delta(out, do)
    dq = flash_dq_cuda(q, k, v, do, lse, delta, scale=scale, causal=causal)
    dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, scale=scale,
                            causal=causal)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp: saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, use_kernel):
        fwd = flash_fwd_cuda if use_kernel else flash_fwd_reference
        out, lse = fwd(q, k, v, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.use_kernel = scale, causal, use_kernel
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_bwd_cuda if ctx.use_kernel else flash_bwd_reference
        dq, dk, dv = bwd(q, k, v, out, lse, do.to(q.dtype), scale=ctx.scale,
                         causal=ctx.causal)
        return dq, dk, dv, None, None, None


def flash_applicable(sq: int, sk: int, d: int, *, causal: bool = True,
                     block_q: int = 1024, block_k: int = 1024) -> bool:
    """True when :func:`flash_attention` takes the flash path for these
    shapes (else :func:`mha_reference`): the JAX package's predicate,
    less its ``pltpu`` import check."""
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    return not (sq < 8 or sq % block_q or sk % block_k or d % 128
                or (causal and sq > sk))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None, block_q: int = 1024,
                    block_k: int = 1024, use_kernel: Optional[bool] = None):
    """Flash attention. Layout [B, S, H, D]; supports GQA (Hkv divides Hq).

    Returns :func:`mha_reference` where the sequence does not tile or
    the head dim is not a multiple of 128, as the JAX package does.
    """
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if use_kernel is None:
        use_kernel = q.is_cuda
    elif use_kernel and not q.is_cuda:
        # Forcing the kernel where it cannot run fails loudly: a plain
        # fallback would make kernel parity checks pass vacuously.
        raise RuntimeError("flash_attention(use_kernel=True) needs CUDA "
                           f"tensors; q is on {q.device}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if not flash_applicable(q.shape[1], k.shape[1], q.shape[3],
                            causal=causal, block_q=block_q, block_k=block_k):
        return mha_reference(q, k, v, causal=causal, scale=scale)
    return _Flash.apply(q, k, v, scale, causal, bool(use_kernel))


flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
