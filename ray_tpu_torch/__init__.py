"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's model, serving and
training path.

The package mirrors ``ray_tpu``'s module paths (``ops/...``,
``models/...``) so each function has an obvious counterpart, and keeps
the JAX package's parameter layouts so weights carry across unchanged
(:mod:`ray_tpu_torch.interop`). It imports ``torch`` and never ``jax``
or anything of ``ray_tpu``: what it needs of a host-only module there
(the block allocator, the sampling params) is copied here.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The TPU's Pallas kernels become CUDA kernels written for Hopper
(``sm_90a``), built from ``ops/csrc`` at first use by
:mod:`ray_tpu_torch.ops._build`.
"""
