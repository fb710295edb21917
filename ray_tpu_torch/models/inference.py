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
    """Final-norm hidden states [B, S, E] -> fp32 logits [B, S, V]
    (:func:`ray_tpu_torch.models.llama.head_logits`): the product runs
    in the params' storage dtype with fp32 accumulation AND fp32 output,
    as JAX's ``preferred_element_type`` does; a bf16 ``matmul`` would
    round the logits to bf16 and break greedy ties."""
    return llama.head_logits(x.to(config.dtype),
                             params["lm_head"].to(config.dtype))
