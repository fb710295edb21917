"""Tensor ops of the port: norms, RoPE, the mixture-of-experts layer,
sequence-parallel attention (ring and Ulysses), and the attention ops
whose CUDA kernels (``csrc/``, built by ``_build``) replace the TPU
kernels: dense and paged decode attention, flash attention."""

from ray_tpu_torch.ops.moe import init_moe_params, moe_layer, router_topk
from ray_tpu_torch.ops.ring_attention import ring_attention, ulysses_attention

__all__ = ["init_moe_params", "moe_layer", "ring_attention", "router_topk",
           "ulysses_attention"]
