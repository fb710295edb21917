"""Inference building blocks shared by the serving engine (port of
``ray_tpu/models/inference.py``): the prefill attention over a cache and
the fp32-logit LM head. ``KVCache``/``LlamaGenerator`` (the dense cache)
come with the dense-engine slice."""

from __future__ import annotations

import torch

from ray_tpu_torch.models import llama


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


def lm_head_logits(x, params, config: llama.LlamaConfig):
    """Final-norm hidden states [B, S, E] -> fp32 logits [B, S, V].

    The product runs in the params' storage dtype with fp32
    accumulation AND fp32 output, as JAX's ``preferred_element_type``
    does: a bf16 ``matmul`` would round the logits to bf16 and break
    greedy ties. On CUDA that is ``torch.mm(..., out_dtype=float32)``;
    the CPU backend lacks that overload, so the CPU upcasts the operands
    (exact for bf16 inputs, same fp32 sums)."""
    c = config
    b, s, e = x.shape
    x2 = x.reshape(b * s, e).to(c.dtype)
    w = params["lm_head"].to(c.dtype)
    if c.dtype == torch.float32:
        out = x2 @ w
    elif x2.is_cuda:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float()
    return out.reshape(b, s, -1)
