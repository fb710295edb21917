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

On a :class:`~torch.distributed.device_mesh.DeviceMesh` the params and
tokens are DTensors placed by the logical-axis rules
(:mod:`ray_tpu_torch.parallel`); the activations are constrained at the
JAX model's points, and attention and the LM head run on each rank's
local tensors through ``local_map`` (JAX's ``shard_map``), so the flash
kernels see plain tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (local_map,
                                                   register_sharding)
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.exceptions import not_ported  # noqa: F401 — re-export
from ray_tpu_torch.ops.attention import flash_attention, mha_reference
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_tpu_torch.parallel import mesh as pmesh
from ray_tpu_torch.parallel.sharding import constrain, placements_for

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


# The cuBLAS flag is one for the process, and engines and trainers step
# in threads of one process (pool actors, Tune trials): the open scopes
# are counted, and the caller's setting comes back when the last closes.
_reduction_lock = threading.Lock()
_reduction_open = 0
_reduction_before = None


@contextlib.contextmanager
def fp32_reduction(device: torch.device, dtype: torch.dtype):
    """Inside the scope, bf16 GEMMs on a CUDA ``device`` reduce in fp32
    (cuBLAS's reduced-precision reduction off), as the JAX package's
    programs state their precision. The engine's step and the trainer's
    step run under it. Scopes may overlap across threads: the setting
    stays off until the last open scope exits (or raises), and then the
    value from before the first one comes back, so the caller's own
    GEMMs keep theirs. Other devices and dtypes leave the setting
    alone."""
    global _reduction_open, _reduction_before
    if device.type != "cuda" or dtype != torch.bfloat16:
        yield
        return
    matmul = torch.backends.cuda.matmul
    with _reduction_lock:
        if _reduction_open == 0:
            _reduction_before = matmul.allow_bf16_reduced_precision_reduction
        _reduction_open += 1
        matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        with _reduction_lock:
            _reduction_open -= 1
            if _reduction_open == 0:
                matmul.allow_bf16_reduced_precision_reduction = \
                    _reduction_before


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


def param_shapes(config: LlamaConfig) -> Params:
    """Dict of shapes matching :func:`init_params` (and
    :func:`logical_axes`)."""
    c = config
    L, E, M = c.num_layers, c.hidden_size, c.intermediate_size
    H, KV, D = c.num_heads, c.num_kv_heads, c.head_dim
    return {
        "embed": (c.vocab_size, E),
        "layers": {"attn_norm": (L, E), "wq": (L, E, H, D),
                   "wk": (L, E, KV, D), "wv": (L, E, KV, D),
                   "wo": (L, H, D, E), "mlp_norm": (L, E),
                   "w_gate": (L, E, M), "w_up": (L, E, M),
                   "w_down": (L, M, E)},
        "final_norm": (E,),
        "lm_head": (E, c.vocab_size),
    }


def init_params(config: LlamaConfig, generator: torch.Generator = None,
                device=None) -> Params:
    """Random init with the JAX package's distributions (normal scaled
    by fan_in^-0.5, embed unscaled, norms ones), drawn from
    ``generator`` on ``device``. Stacked weights are drawn one layer at a
    time so the fp32 draw never holds more than one layer's slice."""
    E, M = config.hidden_size, config.intermediate_size
    return init_backbone(config, lambda stacked: {
        "w_gate": stacked(E, (E, M)),
        "w_up": stacked(E, (E, M)),
        "w_down": stacked(M, (M, E))}, generator, device)


def init_backbone(config: LlamaConfig, mlp, generator: torch.Generator =
                  None, device=None) -> Params:
    """:func:`init_params` with the MLP's weights from ``mlp(stacked)``,
    a dict of a layer's other weights; ``stacked(fan_in, shape,
    dtype=config.dtype)`` draws an ``[L, *shape]`` weight (normal scaled
    by fan_in^-0.5) one layer at a time from the same generator. A model
    family swaps its MLP through it (``models/mixtral.py``)."""
    c = config
    device = default_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    L, E = c.num_layers, c.hidden_size
    H, KV, D = c.num_heads, c.num_kv_heads, c.head_dim

    def normal(shape, scale, dtype=c.dtype):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dtype)

    def stacked(fan_in, shape, dtype=c.dtype):
        out = torch.empty((L,) + shape, dtype=dtype, device=device)
        for i in range(L):
            out[i] = normal(shape, fan_in ** -0.5, dtype)
        return out

    layers = {
        "attn_norm": torch.ones((L, E), dtype=c.dtype, device=device),
        "wq": stacked(E, (E, H, D)),
        "wk": stacked(E, (E, KV, D)),
        "wv": stacked(E, (E, KV, D)),
        "wo": stacked(H * D, (H, D, E)),
        "mlp_norm": torch.ones((L, E), dtype=c.dtype, device=device),
    }
    layers.update(mlp(stacked))
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


def forward_flops(config: LlamaConfig, tokens: int, pairs: int,
                  head_rows: int, layers: Optional[int] = None) -> int:
    """FLOPs of a forward pass of ``tokens`` tokens through ``layers``
    (default all) layers: 2 a weight a token in the layers' matmuls, 4 D
    a query head for each (query, key) pair attention computes (``pairs``,
    summed over the sequences, for one head), and 2 a weight a row of the
    LM head on ``head_rows`` rows."""
    c = config
    n_layers = c.num_layers if layers is None else layers
    e, h, kv, d = c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim
    per_token = e * h * d + 2 * e * kv * d + h * d * e \
        + 3 * e * c.intermediate_size
    return (2 * tokens * per_token * n_layers + 4 * d * h * pairs * n_layers
            + 2 * head_rows * e * c.vocab_size)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis sizes of ``mesh``: a :class:`DeviceMesh` (all six axes), None
    (one device) or a mapping of axis name to size."""
    if isinstance(mesh, DeviceMesh):
        return pmesh.mesh_shape(mesh)
    return dict(mesh) if mesh is not None else {}


def on_mesh(mesh) -> bool:
    """True when ``mesh`` is a :class:`DeviceMesh`: params, tokens and
    activations are DTensors. None and a mapping of sizes are one
    device."""
    return isinstance(mesh, DeviceMesh)


def _select_attention(config: LlamaConfig, mesh) -> str:
    mode = config.attention
    if mode == "auto":
        mode = "ring" if mesh_shape(mesh).get("seq", 1) > 1 else "flash"
    return mode


def _attend(q, k, v, config: LlamaConfig, mesh):
    mode = _select_attention(config, mesh)
    if mode == "ring":
        if not on_mesh(mesh):
            raise ValueError(
                f"attention 'ring' runs over the seq axis of a DeviceMesh "
                f"from ray_tpu_torch.parallel.make_mesh, got mesh {mesh!r}")
        fn = functools.partial(ring_attention, mesh=mesh, axis_name="seq",
                               causal=True)
        return _local_attention(fn, q, k, v, mesh, seq="seq")
    if mode == "reference":
        fn = functools.partial(mha_reference, causal=True)
    else:
        fn = functools.partial(flash_attention, causal=True,
                               use_kernel=config.attention_kernel)
    if not on_mesh(mesh):
        return fn(q, k, v)
    return _local_attention(fn, q, k, v, mesh)


def _local_kv_heads(hq: int, hkv: int, tensor: int, rank: int):
    """The kv head of each of the q heads ``[rank * hq / tensor, (rank +
    1) * hq / tensor)`` that rank ``rank`` of the tensor axis holds, for
    kv heads that are not split over the axis."""
    local, group = hq // tensor, hq // hkv
    return [(rank * local + j) // group for j in range(local)]


def _local_attention(fn, q, k, v, mesh, seq=None):
    """``fn(q, k, v)`` on each rank's local tensors (JAX's ``shard_map``):
    the batch split over (data, fsdp) and the heads over tensor, as the
    constraints before it placed them. The sequence is whole on every
    rank, gathered over the seq axis, unless ``seq="seq"``: then each
    rank holds its chunk of it, as the ring needs (a length the seq axis
    does not divide raises). When the kv heads do not divide the tensor
    axis they stay whole on every rank: each rank takes the kv head of
    each of its q heads (one kv head a q head), and the kv grads are
    partial sums over the axis."""
    q_pl = placements_for(mesh, q.shape, "batch", seq, "act_heads", None)
    kv_pl = placements_for(mesh, k.shape, "batch", seq, "act_kv_heads",
                           None)
    names = mesh.mesh_dim_names
    if seq and "seq" in names and q_pl[names.index("seq")] != Shard(1):
        raise ValueError(
            f"ring attention: sequence length {q.shape[1]} is not split "
            f"over the seq axis of size {mesh.size(names.index('seq'))} "
            f"(it must divide the length, and the rules must map 'seq' to "
            f"it)")
    kv_grad_pl, select = kv_pl, None
    if "tensor" in names:
        t = names.index("tensor")
        if q_pl[t] != kv_pl[t]:
            select = torch.tensor(_local_kv_heads(
                q.shape[2], k.shape[2], mesh.size(t),
                mesh.get_local_rank("tensor")), device=q.device)
            kv_grad_pl = kv_pl[:t] + (Partial(),) + kv_pl[t + 1:]

    def local(q, k, v):
        if select is not None:
            k, v = k.index_select(2, select), v.index_select(2, select)
        return fn(q, k, v)

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad_pl, kv_grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


# -- remat -------------------------------------------------------------------
# JAX's checkpoint_name becomes an identity op (a copy) that the selective
# checkpoint policy can see and mark must-save by its name argument.

@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity that tags ``x`` with ``name`` for the remat policy."""
    return x.clone()


checkpoint_name.register_fake(lambda x, name: torch.empty_like(x))
checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))


@register_sharding(torch.ops.ray_tpu_torch.checkpoint_name.default)
def _checkpoint_name_sharding(x, name):
    """An identity keeps any placement of its input."""
    return [([p], [p, None]) for p in
            [Replicate(), Partial()] + [Shard(d) for d in range(x.ndim)]]


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


def head_logits(x, head, mesh=None):
    """fp32 logits [..., V] of hidden states [..., E] through the LM head
    [E, V] (both in the model dtype). On a mesh, x is [B, S, E] and the
    product runs on local tensors: x split by batch, the head gathered
    over fsdp and split by vocab over tensor, so the logits come out
    split by vocab; the x grads are partial over the vocab split and the
    head grads over the batch split."""
    if on_mesh(mesh):
        return _local_head_logits(x, head, mesh)
    lead = x.shape[:-1]
    out = _HeadLogits.apply(x.reshape(-1, x.shape[-1]), head)
    return out.view(*lead, head.shape[1])


def _local_head_logits(x, head, mesh):
    x_pl = placements_for(mesh, x.shape, "batch", "seq", "act_embed")
    head_pl = placements_for(mesh, head.shape, None, "act_vocab")
    out_pl = tuple(Shard(2) if h != Replicate() else p
                   for p, h in zip(x_pl, head_pl))
    x_grad = tuple(Partial() if h != Replicate() else p
                   for p, h in zip(x_pl, head_pl))
    head_grad = tuple(Partial() if p != Replicate() else h
                      for p, h in zip(x_pl, head_pl))
    return local_map(head_logits, out_placements=list(out_pl),
                     in_placements=(x_pl, head_pl),
                     in_grad_placements=(x_grad, head_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, head)


def _proj(h2, w, config: LlamaConfig):
    """[N, E] @ w [E, ...] flattened to 2-D: one ``aten.mm``, which the
    "full" remat policy saves."""
    return h2 @ w.to(config.dtype).reshape(h2.shape[1], -1)


def _seq_split(x, mesh) -> bool:
    """True when DTensor ``x`` [B, S, ...] has S split over the seq axis."""
    if not on_mesh(mesh) or "seq" not in mesh.mesh_dim_names:
        return False
    return x.placements[mesh.mesh_dim_names.index("seq")] == Shard(1)


def _rows(x, mesh=None):
    """``x`` [B, S, ...] as token rows [B * S, N]. DTensor cannot flatten
    B and S while S is split over the seq axis (torch 2.11 refuses; later
    versions make a strided placement), so there each rank flattens its
    own chunk: the rows come out split over each mesh dim that split B
    or S, in the ranks' order, which permutes the global token order. The
    ops on rows are row-wise, and :func:`_unrows` puts each row back."""
    if not _seq_split(x, mesh):
        return x.reshape(x.shape[0] * x.shape[1], -1)
    if any(isinstance(p, Shard) and p.dim > 2 for p in x.placements):
        raise ValueError(f"token rows of a tensor split past dim 2: "
                         f"{x.placements}")
    pl = [Shard(0 if p.dim < 2 else 1) if isinstance(p, Shard) else p
          for p in x.placements]
    local = x.to_local()
    return DTensor.from_local(
        local.reshape(local.shape[0] * local.shape[1], -1), mesh, pl,
        run_check=False)


def _unrows(y, like, mesh, *tail):
    """Token rows ``y`` [B * S, N] of :func:`_rows` back to [B, S,
    *tail] (default [B, S, N]), B and S placed as in ``like`` [B, S,
    ...], the tensor the rows came from."""
    b, s = like.shape[:2]
    tail = tail or (-1,)
    if not _seq_split(like, mesh):
        return y.view(b, s, *tail)
    rows = [isinstance(p, Shard) and p.dim < 2 for p in like.placements]
    # The rows split as _rows split them, a feature split or a partial
    # sum kept: then each rank's rows are its own chunk's tokens.
    y = y.redistribute(mesh, [
        Shard(0) if r else (Replicate() if p == Shard(0) else p)
        for r, p in zip(rows, y.placements)])
    pl = [q if r else (Shard(2) if isinstance(p, Shard) else p)
          for r, q, p in zip(rows, like.placements, y.placements)]
    local = like.to_local()
    out = DTensor.from_local(
        y.to_local().view(local.shape[0], local.shape[1], -1), mesh, pl,
        run_check=False)
    return out.view(b, s, *tail)


def _dense_mlp(h, layer, config: LlamaConfig, mesh=None):
    c = config
    h2 = _rows(h, mesh)
    gate = _proj(h2, layer["w_gate"], c)
    up = _proj(h2, layer["w_up"], c)
    act = _unrows(F.silu(gate) * up, h, mesh)
    act = constrain(act, mesh, "batch", "seq", "act_mlp")
    down = _proj(_rows(act, mesh), layer["w_down"], c)
    return (_unrows(down, act, mesh, h.shape[-1]),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _layer(x, aux_sum, layer, cos, sin, config: LlamaConfig, mesh, mlp):
    c = config
    b, s, e = x.shape
    h = rms_norm(x, layer["attn_norm"], c.rms_eps)
    h2 = _rows(h, mesh)
    q = _unrows(_proj(h2, layer["wq"], c), h, mesh, c.num_heads, c.head_dim)
    k = _unrows(_proj(h2, layer["wk"], c), h, mesh, c.num_kv_heads,
                c.head_dim)
    v = _unrows(_proj(h2, layer["wv"], c), h, mesh, c.num_kv_heads,
                c.head_dim)
    q = constrain(apply_rope(q, cos, sin), mesh, "batch", "seq",
                  "act_heads", None)
    k = constrain(apply_rope(k, cos, sin), mesh, "batch", "seq",
                  "act_kv_heads", None)
    v = constrain(v, mesh, "batch", "seq", "act_kv_heads", None)
    q, k, v = _named(q, "q", c), _named(k, "k", c), _named(v, "v", c)
    # The output split as q is (a no-op but for attention that gathered
    # the sequence, which keeps this rank's part): token rows of a split
    # sequence are flattened rank by rank (_rows).
    o = constrain(_attend(q, k, v, c, mesh), mesh, "batch", "seq",
                  "act_heads", None)
    o = _named(o, "attn_out", c)
    x = x + _unrows(_proj(_rows(o, mesh), layer["wo"], c), o, mesh, e)
    x = constrain(x, mesh, "batch", "seq", "act_embed")
    down, aux = mlp(rms_norm(x, layer["mlp_norm"], c.rms_eps), layer)
    x = constrain(x + down, mesh, "batch", "seq", "act_embed")
    return x, aux_sum + aux


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
    if on_mesh(mesh):
        _check_on_mesh(params, tokens)
        cos, sin = (DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False) for t in (cos, sin))
    x = embed_tokens(tokens, embed.to(c.dtype), mesh)
    x = constrain(x, mesh, "batch", "seq", "act_embed")
    mlp = mlp_fn or functools.partial(_dense_mlp, config=c, mesh=mesh)
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
    logits = head_logits(x, params["lm_head"].to(c.dtype), mesh)
    return constrain(logits, mesh, "batch", "seq", "act_vocab")


def embed_tokens(tokens, table, mesh=None):
    """Rows of ``table`` [V, E] for ``tokens`` [B, S]. On a mesh the
    lookup runs on local tensors, Megatron's vocab-parallel embedding:
    the table gathered over fsdp and split by vocab over tensor, each
    rank's rows for the ids in its vocab range and zeros elsewhere, so
    the output is a partial sum over the vocab split (one rank's term is
    the row, the rest are zeros: exact). DTensor's own embedding rule
    could not take the backward of that split."""
    if not on_mesh(mesh):
        return F.embedding(tokens, table)
    tok_pl = placements_for(mesh, tokens.shape, "batch", "seq")
    table_pl = placements_for(mesh, table.shape, "act_vocab", None)
    names = mesh.mesh_dim_names
    split = "tensor" in names and table_pl[names.index("tensor")] != \
        Replicate()
    lo = mesh.get_local_rank("tensor") * (table.shape[0] // mesh.size(
        names.index("tensor"))) if split else 0

    def local(ids, rows):
        if not split:
            return F.embedding(ids, rows)
        mine = (ids >= lo) & (ids < lo + rows.shape[0])
        out = F.embedding(torch.where(mine, ids - lo, 0), rows)
        return torch.where(mine[..., None], out, 0.0)

    out_pl = tuple(Partial() if t != Replicate() else p
                   for p, t in zip(tok_pl, table_pl))
    table_grad = tuple(Partial() if p != Replicate() else t
                       for p, t in zip(tok_pl, table_pl))
    return local_map(local, out_placements=list(out_pl),
                     in_placements=(tok_pl, table_pl),
                     in_grad_placements=(tok_pl, table_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
                         tokens, table)


def _check_on_mesh(params, tokens):
    """On a mesh every param leaf and the tokens are DTensors: a plain
    tensor there would be one rank's full tensor taken for the whole."""
    plain = [name for name, v in {**params, "tokens": tokens}.items()
             for t in (v.values() if isinstance(v, dict) else [v])
             if not isinstance(t, DTensor)]
    if plain:
        raise TypeError(
            f"on a DeviceMesh the params and tokens must be DTensors "
            f"(plain: {plain}); place them with ShardedTrainer or "
            f"parallel.shard_tree")


def hidden_states(params: Params, tokens, config: LlamaConfig, mesh=None,
                  mlp_fn=None):
    """(final-norm hidden states [B, S, E], summed aux scalar)."""
    return forward(params, tokens, config, mesh, return_hidden=True,
                   mlp_fn=mlp_fn)


def _logit_stats(logits, tc, mc):
    """Masked NLL sum and correct-prediction count of fp32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tc[..., None])[..., 0]
    nll = (lse - picked) * mc
    correct = (logits.argmax(dim=-1) == tc) * mc
    return nll.sum(), correct.sum()


def _chunk_stats(xc, head, tc, mc, mesh=None):
    """Masked NLL sum and correct-prediction count of one sequence chunk.
    On a mesh the chunk's vocab-split logits are gathered over the tensor
    axis before the softmax (each tensor rank holds the chunk's whole
    logits: memory, not values), and the sums come out partial over the
    batch split."""
    logits = head_logits(xc, head, mesh)
    if not on_mesh(mesh):
        return _logit_stats(logits, tc, mc)
    logits = constrain(logits, mesh, "batch", "seq", None)
    pl = tuple(logits.placements)
    tm_pl = placements_for(mesh, tc.shape, "batch", "seq")
    sums = tuple(Partial() if p != Replicate() else p for p in pl)
    return local_map(_logit_stats, out_placements=(list(sums), list(sums)),
                     in_placements=(pl, tm_pl, tm_pl),
                     in_grad_placements=(pl, tm_pl, tm_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
                         logits, tc, mc)


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
    nll_sum = correct_sum = 0.0
    for i in range(n_chunks):
        sl = slice(i * step, (i + 1) * step)
        nll, correct = checkpoint(_chunk_stats, x[:, sl], head,
                                  targets[:, sl], m[:, sl], mesh,
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
