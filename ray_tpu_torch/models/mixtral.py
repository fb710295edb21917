"""Mixtral-family sparse-MoE decoder (port of ``ray_tpu/models/mixtral.py``).

The attention backbone, remat policy and layer loop are the port's Llama
ones (:mod:`ray_tpu_torch.models.llama` through its ``mlp_fn`` hook);
this module swaps every dense SwiGLU block for a top-k routed expert
layer (:func:`ray_tpu_torch.ops.moe.moe_layer`). Params keep the JAX
package's tree, leaf for leaf: the backbone's leaves less ``w_gate``,
``w_up`` and ``w_down``, plus ``w_router`` ``[L, E, X]`` (fp32 whatever
the model dtype), ``moe_gate``/``moe_up`` ``[L, X, E, M]`` and
``moe_down`` ``[L, X, M, E]``. :func:`params_from_numpy` carries a JAX
tree across with each leaf's own dtype.

On a :class:`~torch.distributed.device_mesh.DeviceMesh` (any layout of
``parallel.make_mesh``: data, fsdp, expert, tensor and seq, ring or
Ulysses attention) the params are DTensors placed by
:func:`logical_axes` through the rules, ``shard_tree(params,
tree_shardings(mesh, logical_axes(cfg)), mesh)``, and the expert layer
is the expert-parallel one of :func:`ray_tpu_torch.ops.moe.moe_layer`.
A mapping of axis sizes is one device: an axis of it larger than 1
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch import interop
from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.moe import moe_layer

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336   # per-expert FFN width
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 32768
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"
    attention: str = "auto"
    # The flash path's kernels (llama.LlamaConfig.attention_kernel).
    attention_kernel: Optional[bool] = None
    # MoE
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_coeff: float = 0.02          # router load-balancing weight

    @staticmethod
    def mixtral_8x7b(**kw) -> "MixtralConfig":
        return MixtralConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "MixtralConfig":
        """CPU-runnable config for tests."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 96)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("num_kv_heads", 2)
        kw.setdefault("head_dim", 16)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_experts", 4)
        kw.setdefault("top_k", 2)
        kw.setdefault("remat", False)
        return MixtralConfig(**kw)

    def backbone(self) -> llama.LlamaConfig:
        """The Llama config driving the shared attention backbone."""
        return llama.LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta,
            rms_eps=self.rms_eps, dtype=self.dtype, remat=self.remat,
            remat_policy=self.remat_policy, attention=self.attention,
            attention_kernel=self.attention_kernel)


def logical_axes(config: MixtralConfig) -> Params:
    """Dict of logical-axis tuples matching :func:`init_params`."""
    axes = llama.logical_axes(config.backbone())
    layer = dict(axes["layers"])
    for k in ("w_gate", "w_up", "w_down"):
        del layer[k]
    layer.update({
        "w_router": ("layers", "embed", None),
        "moe_gate": ("layers", "experts", "embed", "mlp"),
        "moe_up": ("layers", "experts", "embed", "mlp"),
        "moe_down": ("layers", "experts", "mlp", "embed"),
    })
    axes["layers"] = layer
    return axes


def init_params(config: MixtralConfig, generator: torch.Generator = None,
                device=None) -> Params:
    """Random init with the JAX package's distributions, drawn from
    ``generator`` on ``device`` (default ``cuda``; raises without one)
    one layer at a time; ``w_router`` is fp32."""
    c = config
    E, M, X = c.hidden_size, c.intermediate_size, c.num_experts
    return llama.init_backbone(c.backbone(), lambda stacked: {
        "w_router": stacked(E, (E, X), torch.float32),
        "moe_gate": stacked(E, (X, E, M)),
        "moe_up": stacked(E, (X, E, M)),
        "moe_down": stacked(M, (X, M, E))}, generator, device)


def params_from_numpy(tree, device=None) -> Params:
    """A JAX Mixtral tree (nested dicts of numpy arrays,
    ``jax.device_get``) -> the port's params on ``device`` (default
    ``cuda``), each leaf in its own dtype: bf16 bit for bit, ``w_router``
    fp32. Casting the tree to the model dtype would round the router,
    which routes tokens elsewhere: another model."""
    router = tree["layers"]["w_router"]
    if router.dtype.name != "float32":
        raise ValueError(f"w_router must be float32 (JAX initialises it "
                         f"so), got {router.dtype.name}")
    return interop.params_from_numpy(tree, llama.default_device(device))


def _mesh(mesh):
    """``mesh`` as the MoE takes it: a DeviceMesh, or None for one
    device (a mapping of sizes, each 1)."""
    if llama.on_mesh(mesh):
        return mesh
    big = {k: v for k, v in llama.mesh_shape(mesh).items() if v > 1}
    if big:
        raise ValueError(
            f"Mixtral over mesh axes {big} runs on a DeviceMesh from "
            f"ray_tpu_torch.parallel.make_mesh, not a mapping of sizes")
    return None


def _moe_mlp(config: MixtralConfig, mesh=None):
    c = config

    def mlp_fn(h, layer):
        out, aux = moe_layer(
            h,
            {"w_router": layer["w_router"],
             "w_gate": layer["moe_gate"],
             "w_up": layer["moe_up"],
             "w_down": layer["moe_down"]},
            num_experts=c.num_experts, top_k=c.top_k,
            capacity_factor=c.capacity_factor, mesh=mesh)
        return out, aux["aux_loss"]

    return mlp_fn


def forward(params: Params, tokens, config: MixtralConfig, mesh=None):
    """Logits [B, S, V] (fp32) for integer tokens [B, S]."""
    return llama.forward(params, tokens, config.backbone(), mesh,
                         mlp_fn=_moe_mlp(config, _mesh(mesh)))


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: MixtralConfig, mesh=None, vocab_chunks: int = 8):
    """Next-token CE + router load-balancing aux loss: (total, metrics)
    with ``metrics["loss"]`` the CE, ``"aux_loss"`` the aux summed over
    layers and ``"total_loss"``. On CUDA with bf16 params, run it under
    :func:`llama.fp32_reduction` as the trainer's step does."""
    return llama.loss_fn(params, batch, config.backbone(), mesh,
                         vocab_chunks=vocab_chunks,
                         mlp_fn=_moe_mlp(config, _mesh(mesh)),
                         aux_coeff=config.aux_coeff)


def _attn_params(c: MixtralConfig) -> int:
    return (2 * c.hidden_size
            + c.hidden_size * c.num_heads * c.head_dim * 2
            + c.hidden_size * c.num_kv_heads * c.head_dim * 2)


def num_params(config: MixtralConfig) -> int:
    c = config
    moe = (c.hidden_size * c.num_experts
           + 3 * c.num_experts * c.hidden_size * c.intermediate_size)
    return (c.vocab_size * c.hidden_size * 2 + c.hidden_size
            + c.num_layers * (_attn_params(c) + moe))


def active_params(config: MixtralConfig) -> int:
    """Per-token active parameters (top_k experts of num_experts)."""
    c = config
    moe = (c.hidden_size * c.num_experts
           + 3 * c.top_k * c.hidden_size * c.intermediate_size)
    return (c.vocab_size * c.hidden_size * 2 + c.hidden_size
            + c.num_layers * (_attn_params(c) + moe))
