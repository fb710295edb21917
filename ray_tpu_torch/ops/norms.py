"""Normalization ops (port of ``ray_tpu/ops/norms.py``).

Plain tensor code: the norms are a reduce plus a scale, bound by the
bytes they move, and the TPU package left them to XLA rather than to a
Pallas kernel.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (Llama-style): ``x / rms(x) * weight``, computed in fp32
    and cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)
