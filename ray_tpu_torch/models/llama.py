"""Llama-family decoder (port of ``ray_tpu/models/llama.py``):
configuration, parameters, the training forward pass and the loss.

Parameters are a plain dict of tensors in the JAX package's einsum
layouts, stacked over layers (``[L, ...]``), so a JAX param tree carries
across unchanged (:func:`ray_tpu_torch.interop.params_from_numpy`). The
layer stack is a Python loop over the unbound stack (JAX's
``lax.scan``), each layer under ``torch.utils.checkpoint`` with a
selective policy when ``remat`` is on; attention is the flash path of
:mod:`ray_tpu_torch.ops.attention`. The serving path builds its layers in
:mod:`ray_tpu_torch.models.continuous_batching`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

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
    remat: bool = True
    # remat_policy: "full" saves the projection products and recomputes
    # the rest of the layer (the attention forward included) in the
    # backward; "attn_out" saves the attention outputs only; "mlp_only"
    # saves q/k/v and the attention outputs. See forward().
    remat_policy: str = "full"
    # attention: "auto" | "flash" | "ring" | "reference"
    attention: str = "auto"
    # The flash path's kernels: None = the CUDA kernels on CUDA tensors
    # and the plain versions on the CPU; False = the plain versions on
    # any device (flash_attention's ``use_kernel``).
    attention_kernel: Optional[bool] = None

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
        kw.setdefault("remat", False)
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


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis sizes of ``mesh``: None (one device) or a mapping of axis
    name to size. The port runs on one device; meshes arrive with
    ROADMAP.md queue A, item 7."""
    return dict(mesh) if mesh is not None else {}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a not-yet-ported feature raises, naming its ROADMAP.md
    queue A item."""
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue A, {item}")


SHARDING_ITEM = "item 7 (ray_tpu_torch/parallel and sequence-parallel " \
    "attention)"


def _select_attention(config: LlamaConfig, mesh) -> str:
    mode = config.attention
    if mode == "auto":
        mode = "ring" if mesh_shape(mesh).get("seq", 1) > 1 else "flash"
    return mode


def _attend(q, k, v, config: LlamaConfig, mesh):
    mode = _select_attention(config, mesh)
    if mode == "reference":
        return mha_reference(q, k, v, causal=True)
    if mode == "ring":
        raise not_ported("ring attention over the mesh's seq axis",
                         SHARDING_ITEM)
    return flash_attention(q, k, v, causal=True,
                           use_kernel=config.attention_kernel)


# -- remat -------------------------------------------------------------------
# JAX's checkpoint_name becomes an identity op (a copy) that the selective
# checkpoint policy can see and mark must-save by its name argument.

@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity that tags ``x`` with ``name`` for the remat policy."""
    return x.clone()


checkpoint_name.register_fake(lambda x, name: torch.empty_like(x))
checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))

_SAVED_NAMES = {"attn_out": ("attn_out",),
                "mlp_only": ("q", "k", "v", "attn_out")}


def _remat_context(policy: str):
    """``context_fn`` of ``checkpoint`` for a remat policy:
    "full" is ``dots_with_no_batch_dims_saveable`` (every 2-D product,
    ``aten.mm``, is saved); the others are ``save_only_these_names``."""
    if policy == "full":
        def save(func, args):
            return func is torch.ops.aten.mm.default
    elif policy in _SAVED_NAMES:
        names = _SAVED_NAMES[policy]

        def save(func, args):
            return (func is torch.ops.ray_tpu_torch.checkpoint_name.default
                    and args[1] in names)
    else:
        raise ValueError(
            f"unknown remat_policy {policy!r}; "
            "expected 'full', 'attn_out', or 'mlp_only'")

    def policy_fn(ctx, func, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if save(func, args)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _named(x, name: str, config: LlamaConfig):
    if config.remat and name in _SAVED_NAMES.get(config.remat_policy, ()):
        return checkpoint_name(x, name)
    return x


# -- forward -----------------------------------------------------------------

class _HeadLogits(torch.autograd.Function):
    """x [N, E] @ head [E, V] -> fp32 logits [N, V], the operands in their
    storage dtype (JAX's ``preferred_element_type=float32``): upcasting
    bf16 operands buys no precision on the product. On CUDA that is
    ``torch.mm(..., out_dtype=float32)``; the CPU upcasts the operands
    (exact for bf16, the same fp32 sums). The backward is JAX's dot
    transpose: fp32 products of the fp32 cotangent, cast to each
    operand's dtype."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        if x.dtype == torch.float32 and head.dtype == torch.float32:
            return x @ head
        if x.is_cuda:
            return torch.mm(x, head, out_dtype=torch.float32)
        return x.float() @ head.float()

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        dx = dhead = None
        if ctx.needs_input_grad[0]:
            dx = (g @ head.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dhead = (x.float().t() @ g).to(head.dtype)
        return dx, dhead


def head_logits(x, head):
    """fp32 logits [..., V] of hidden states [..., E] through the LM head
    [E, V] (both in the model dtype)."""
    lead = x.shape[:-1]
    out = _HeadLogits.apply(x.reshape(-1, x.shape[-1]), head)
    return out.view(*lead, head.shape[1])


def _proj(h2, w, config: LlamaConfig):
    """[N, E] @ w [E, ...] flattened to 2-D: one ``aten.mm``, which the
    "full" remat policy saves."""
    return h2 @ w.to(config.dtype).reshape(h2.shape[1], -1)


def _dense_mlp(h, layer, config: LlamaConfig):
    c = config
    h2 = h.reshape(-1, h.shape[-1])
    gate = _proj(h2, layer["w_gate"], c)
    up = _proj(h2, layer["w_up"], c)
    down = _proj(F.silu(gate) * up, layer["w_down"], c)
    return (down.view(h.shape),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _layer(x, aux_sum, layer, cos, sin, config: LlamaConfig, mesh, mlp):
    c = config
    b, s, e = x.shape
    h2 = rms_norm(x, layer["attn_norm"], c.rms_eps).reshape(b * s, e)
    q = _proj(h2, layer["wq"], c).view(b, s, c.num_heads, c.head_dim)
    k = _proj(h2, layer["wk"], c).view(b, s, c.num_kv_heads, c.head_dim)
    v = _proj(h2, layer["wv"], c).view(b, s, c.num_kv_heads, c.head_dim)
    q = _named(apply_rope(q, cos, sin), "q", c)
    k = _named(apply_rope(k, cos, sin), "k", c)
    v = _named(v, "v", c)
    o = _named(_attend(q, k, v, c, mesh), "attn_out", c)
    x = x + _proj(o.reshape(b * s, -1), layer["wo"], c).view(b, s, e)
    down, aux = mlp(rms_norm(x, layer["mlp_norm"], c.rms_eps), layer)
    return x + down, aux_sum + aux


def forward(params: Params, tokens, config: LlamaConfig, mesh=None,
            return_hidden: bool = False, mlp_fn=None):
    """Compute logits [B, S, V] (fp32) for integer tokens [B, S].

    ``mlp_fn(h, layer) -> (out, aux_scalar)`` swaps the dense SwiGLU
    block for another token-mixing-free sublayer. With
    ``return_hidden=True`` the return value is ``(hidden [B, S, E],
    aux_total)``, the per-layer auxiliary scalars summed over layers;
    otherwise the logits.

    With ``remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant) with a selective policy: "full" saves the projection
    products and recomputes the rest, the attention forward included, so
    the flash forward runs twice per layer and step; "attn_out" and
    "mlp_only" save the tensors named so (``checkpoint_name``).
    Rematerialization changes no value.
    """
    c = config
    embed = params["embed"]
    cos, sin = rope_frequencies(c.head_dim, tokens.shape[1], c.rope_theta,
                                device=embed.device)
    x = F.embedding(tokens, embed.to(c.dtype))
    mlp = mlp_fn or functools.partial(_dense_mlp, config=c)
    stacked = {name: torch.unbind(w, 0)
               for name, w in params["layers"].items()}
    n_layers = len(next(iter(stacked.values())))
    context_fn = _remat_context(c.remat_policy) if c.remat else None
    aux = torch.zeros((), dtype=torch.float32, device=embed.device)
    for i in range(n_layers):
        layer = {name: ws[i] for name, ws in stacked.items()}
        args = (x, aux, layer, cos, sin, c, mesh, mlp)
        if c.remat:
            x, aux = checkpoint(_layer, *args, use_reentrant=False,
                                context_fn=context_fn)
        else:
            x, aux = _layer(*args)
    x = rms_norm(x, params["final_norm"], c.rms_eps)
    if return_hidden:
        return x, aux
    return head_logits(x, params["lm_head"].to(c.dtype))


def hidden_states(params: Params, tokens, config: LlamaConfig, mesh=None,
                  mlp_fn=None):
    """(final-norm hidden states [B, S, E], summed aux scalar)."""
    return forward(params, tokens, config, mesh, return_hidden=True,
                   mlp_fn=mlp_fn)


def _chunk_stats(xc, head, tc, mc):
    """Masked NLL sum and correct-prediction count of one sequence chunk."""
    logits = head_logits(xc, head)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tc[..., None])[..., 0]
    nll = (lse - picked) * mc
    correct = (logits.argmax(dim=-1) == tc) * mc
    return nll.sum(), correct.sum()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig, mesh=None, vocab_chunks: int = 8,
            mlp_fn=None, aux_coeff: float = 0.0):
    """Next-token cross-entropy. batch: {"tokens": [B, S] int,
    "mask": [B, S]} (mask optional).

    The LM head and softmax run over *sequence chunks* (the largest
    count <= ``vocab_chunks`` that divides S - 1), each under
    ``torch.utils.checkpoint`` so its fp32 [B, S/n, V] logits are
    recomputed in the backward rather than kept. ``aux_coeff`` adds the
    summed auxiliary scalar of ``mlp_fn`` to the loss.
    """
    tokens = batch["tokens"]
    mask = batch.get("mask")
    x, aux = hidden_states(params, tokens, config, mesh, mlp_fn=mlp_fn)
    targets = tokens[:, 1:].long()
    x = x[:, :-1]
    m = (mask[:, 1:] if mask is not None
         else torch.ones_like(targets)).float()
    head = params["lm_head"].to(config.dtype)

    s = x.shape[1]
    n_chunks = vocab_chunks
    while s % n_chunks:
        n_chunks -= 1
    step = s // n_chunks
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    correct_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * step, (i + 1) * step)
        nll, correct = checkpoint(_chunk_stats, x[:, sl], head,
                                  targets[:, sl], m[:, sl],
                                  use_reentrant=False)
        nll_sum = nll_sum + nll
        correct_sum = correct_sum + correct
    total = torch.clamp(m.sum(), min=1.0)
    loss = nll_sum / total
    metrics = {"loss": loss, "accuracy": correct_sum / total,
               "tokens": total}
    if aux_coeff:
        metrics["aux_loss"] = aux
        loss = loss + aux_coeff * aux
        metrics["total_loss"] = loss
    return loss, metrics
