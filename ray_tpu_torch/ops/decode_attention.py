"""Single-query decode attention over a dense per-slot cache: the plain
version (port of ``ray_tpu/ops/decode_attention.py``).

The dense Pallas kernel ``_decode_kernel`` serves only ``paged=False``
engines and is not ported yet (ROADMAP.md, queue B); this module holds
what the paged path shares with it: the mask value, the tri-state env
knob and the reference attention the paged plain version reduces to.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

# Masked scores are -1e30, not -inf: fully masked garbage rows in freed
# slots must softmax to finite values, not NaN. The CUDA kernel uses the
# same value so kernel-on/off greedy decode stays token-for-token equal.
MASK_VALUE = -1e30


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
