"""Tensor ops of the port: norms, RoPE, and the attention ops whose CUDA
kernels (``csrc/``, built by ``_build``) replace the TPU kernels: dense
and paged decode attention, flash attention."""
