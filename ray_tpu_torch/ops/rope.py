"""Rotary position embeddings, Llama convention (port of
``ray_tpu/ops/rope.py``): half-split rotation, angles in fp32."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(
    head_dim: int,
    max_len: int,
    theta: float = 10000.0,
    *,
    positions: Optional[torch.Tensor] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) of shape [max_len, head_dim//2] (fp32), or
    [len(positions), head_dim//2] at explicit ``positions`` (which also
    fix the device)."""
    if positions is not None:
        device = positions.device
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    if positions is None:
        positions = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(positions.float(), inv_freq)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to ``x`` of shape [..., seq, heads, head_dim];
    ``cos``/``sin`` are [seq, head_dim//2] (broadcast over batch and
    heads)."""
    dtype = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[:, None, :]
    sin = sin[:, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)
