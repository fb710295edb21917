"""Carry weights between the JAX package and the port.

The JAX param tree (nested dicts of arrays in the einsum layouts; RLlib's
MLPs are dicts of lists of layers) comes across as the same nest of
numpy arrays (``jax.device_get``), and the port keeps the same layouts,
so conversion is per leaf. bf16 arrives as
an ``ml_dtypes`` numpy array, which ``torch.from_numpy`` rejects; it is
recognised by its dtype name and carried through a uint16 view, which
keeps the bits exact.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf_to_tensor(a, device, dtype):
    a = np.array(a, order="C")   # a writable copy: jax arrays are not
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def params_from_numpy(tree, device, dtype=None):
    """Nested dicts and lists of numpy arrays -> the same nesting of
    tensors on ``device``; floating leaves cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _leaf_to_tensor(tree, device, dtype)


def params_to_numpy(params, bf16_dtype=None):
    """The inverse: tensors -> numpy. bf16 leaves come back as their
    uint16 bits, viewed as ``bf16_dtype`` when the caller has one (for
    example ``jnp.bfloat16``'s numpy dtype)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v, bf16_dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v, bf16_dtype) for v in params]
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.uint16).numpy()
        return bits.view(bf16_dtype) if bf16_dtype is not None else bits
    return t.numpy()
