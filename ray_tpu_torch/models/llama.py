"""Llama-family decoder: configuration and parameters (port of
``ray_tpu/models/llama.py``).

Parameters are a plain dict of tensors in the JAX package's einsum
layouts, stacked over layers (``[L, ...]``), so a JAX param tree carries
across unchanged (:func:`ray_tpu_torch.interop.params_from_numpy`).
``forward``/``loss_fn`` come with the slice that ports the flash-attention
kernel; the serving path builds its layers in
:mod:`ray_tpu_torch.models.continuous_batching`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]


def default_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``. With no GPU and no device
    asked for this raises: the port never carries on silently on the
    CPU (tests pass ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_layers=40, num_heads=40, num_kv_heads=40, **kw)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, hidden_size=4096,
                           intermediate_size=14336, num_layers=32,
                           num_heads=32, num_kv_heads=8,
                           rope_theta=500000.0, max_seq_len=8192, **kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """CPU-runnable config for tests."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("head_dim", 16)
        kw.setdefault("max_seq_len", 128)
        return LlamaConfig(**kw)


def logical_axes(config: LlamaConfig) -> Params:
    """Dict of logical-axis tuples matching :func:`init_params`."""
    layer = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    return {
        "embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def init_params(config: LlamaConfig, generator: torch.Generator = None,
                device=None) -> Params:
    """Random init with the JAX package's distributions (normal scaled
    by fan_in^-0.5, embed unscaled, norms ones), drawn from
    ``generator`` on ``device``. Stacked weights are drawn one layer at a
    time so the fp32 draw never holds more than one layer's slice."""
    c = config
    device = default_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    L, E, M = c.num_layers, c.hidden_size, c.intermediate_size
    H, KV, D = c.num_heads, c.num_kv_heads, c.head_dim

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(c.dtype)

    def stacked(fan_in, *shape):
        out = torch.empty((L,) + shape, dtype=c.dtype, device=device)
        for i in range(L):
            out[i] = normal(shape, fan_in ** -0.5)
        return out

    layers = {
        "attn_norm": torch.ones((L, E), dtype=c.dtype, device=device),
        "wq": stacked(E, E, H, D),
        "wk": stacked(E, E, KV, D),
        "wv": stacked(E, E, KV, D),
        "wo": stacked(H * D, H, D, E),
        "mlp_norm": torch.ones((L, E), dtype=c.dtype, device=device),
        "w_gate": stacked(E, E, M),
        "w_up": stacked(E, E, M),
        "w_down": stacked(M, M, E),
    }
    return {
        "embed": normal((c.vocab_size, E), 1.0),
        "layers": layers,
        "final_norm": torch.ones((E,), dtype=c.dtype, device=device),
        "lm_head": normal((E, c.vocab_size), E ** -0.5),
    }


def truncated(config: LlamaConfig, params: Params,
              num_layers: int) -> Tuple[LlamaConfig, Params]:
    """First-``num_layers`` view of a model: the layer stack sliced to
    its leading ``num_layers`` (views, no copies); embed, final norm and
    lm_head shared."""
    if not 1 <= num_layers <= config.num_layers:
        raise ValueError(
            f"truncated depth must be in [1, {config.num_layers}], "
            f"got {num_layers}")
    cfg = dataclasses.replace(config, num_layers=num_layers)
    sliced = dict(params)
    sliced["layers"] = {k: v[:num_layers]
                        for k, v in params["layers"].items()}
    return cfg, sliced


def num_params(config: LlamaConfig) -> int:
    c = config
    per_layer = (
        2 * c.hidden_size
        + c.hidden_size * c.num_heads * c.head_dim * 2
        + c.hidden_size * c.num_kv_heads * c.head_dim * 2
        + 3 * c.hidden_size * c.intermediate_size
    )
    return (
        c.vocab_size * c.hidden_size * 2
        + c.hidden_size
        + c.num_layers * per_layer
    )
