"""Tensor ops of the port: norms, RoPE, decode attention and the paged
decode-attention CUDA kernel (``csrc/``, built by ``_build``)."""
