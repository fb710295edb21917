"""Mixture-of-experts layer (port of ``ray_tpu/ops/moe.py``): top-k
softmax gating, capacity-bounded dispatch and combine, SwiGLU experts
stacked on a leading axis.

The JAX package reaches no Pallas kernel here: routing is a handful of
small XLA ops, and the expert products are plain batched matrix
products. The port keeps them plain PyTorch, with the same semantics:

* :func:`router_topk` picks experts by a stable descending sort, so ties
  go to the lower expert index as ``jax.lax.top_k`` sends them
  (``torch.topk`` promises no order among equal values);
* a (token, choice) pair's slot in its expert's buffer is the running
  count of pairs routed to that expert, token-major and choice-minor;
  pairs past the capacity drop (:func:`dispatch_mask` is JAX's ``[T, X,
  C]`` one-hot form of it, :func:`dispatch_index` the flat slot ids the
  layer uses);
* JAX dispatches and combines by dense one-hot einsums over ``[T, X,
  C]``. Each slot holds at most one token, so the port moves rows by
  index instead: ``index_copy`` into the ``[X, C, D]`` expert buffers
  and back into ``[T, k, D]`` rows, each destination written once (a
  dummy row takes the dropped pairs and empty slots and is cut off).
  The products by 0 and 1 are gone, the result is the einsums' in fp32,
  and both directions and their backwards (gathers) use no atomics, so
  the backward and remat's replay are deterministic.

On a :class:`~torch.distributed.device_mesh.DeviceMesh` (expert
parallelism) the layer runs on each rank's local tensors through
``local_map`` (:func:`_moe_on_mesh`). The rules split the tokens over
(data, fsdp, seq) and the stacked experts over ``expert`` (the FFN width
over ``tensor``), so each rank already holds every token of its group
and JAX's dispatch and combine einsums have nothing to move but the
routing: every rank gathers the int expert ids of its group's peers,
routes the global ``[T, k]`` as one device does (the same capacity,
slots and drops), runs the expert products on its own group's kept
pairs for its own experts only, packed, and the fp32 combine is summed
over the ranks that split the experts' work.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.parallel import axis


def router_topk(gate_logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gating. gate_logits [T, X] -> (weights [T, k] softmaxed over
    the k chosen logits, idx [T, k] int64). Among equal logits the lower
    expert index comes first, on every device."""
    vals, idx = torch.sort(gate_logits, dim=-1, descending=True,
                           stable=True)
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


def _slots(expert_idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[T, k] expert ids -> [T * k] slot of each (token, choice) pair in
    its expert's buffer: the running count over the flattened one-hot,
    token-major and choice-minor (JAX's ``cumsum(flat) - 1``)."""
    flat_idx = expert_idx.reshape(-1, 1).long()
    onehot = F.one_hot(flat_idx[:, 0], num_experts)          # [T*k, X]
    return onehot.cumsum(0).gather(1, flat_idx)[:, 0] - 1


def dispatch_mask(expert_idx: torch.Tensor, num_experts: int,
                  capacity: int) -> torch.Tensor:
    """[T, k] expert ids -> dispatch tensor [T, X, C] (fp32 0/1), as
    JAX's: tokens beyond ``capacity`` in an expert's buffer are dropped
    (their row is zero)."""
    t, k = expert_idx.shape
    slot = _slots(expert_idx, num_experts)
    keep = (slot < capacity).float()
    onehot = F.one_hot(expert_idx.reshape(-1).long(), num_experts).float()
    slot_onehot = (slot[:, None] == torch.arange(
        capacity, device=slot.device)).float()
    disp = onehot[:, :, None] * keep[:, None, None] * slot_onehot[:, None]
    return disp.reshape(t, k, num_experts, capacity).sum(dim=1)


def dispatch_index(expert_idx: torch.Tensor, num_experts: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, k] expert ids -> (dest [T * k], keep [T * k] bool): each
    (token, choice) pair's row ``expert * capacity + slot`` in the
    flattened ``[X * C]`` expert buffers, or ``X * C`` (one dummy row
    past them) where the pair is dropped. Row ``dest`` of the buffers is
    where :func:`dispatch_mask` puts the pair's 1."""
    slot = _slots(expert_idx, num_experts)
    keep = slot < capacity
    row = expert_idx.reshape(-1).long() * capacity + slot
    return torch.where(keep, row, num_experts * capacity), keep


def _capacity(t: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    """Slots an expert's buffer holds for ``t`` tokens (JAX's)."""
    return max(int(capacity_factor * t * top_k / num_experts), top_k)


def _experts(buf, w_gate, w_up, w_down, dtype):
    """SwiGLU over each expert's rows: buf [X, n, D] -> [X, n, D], the
    rows and weights in ``dtype``."""
    act = (F.silu(torch.bmm(buf, w_gate.to(dtype)))
           * torch.bmm(buf, w_up.to(dtype)))
    return torch.bmm(act, w_down.to(dtype))


def _combine(expert_out, dest, weights, t, top_k):
    """fp32 [t, D]: each buffer row of ``expert_out`` [X, n, D] back to
    the (token, choice) pair whose ``dest`` row it is (empty rows to a
    dummy pair that is cut off), weighted and summed over k."""
    rows, d = expert_out.shape[0] * expert_out.shape[1], expert_out.shape[2]
    pair = torch.full((rows + 1,), t * top_k, dtype=torch.long,
                      device=dest.device).index_copy(
        0, dest, torch.arange(t * top_k, device=dest.device))[:rows]
    picked = expert_out.new_zeros((t * top_k + 1, d), dtype=torch.float32)
    picked = picked.index_copy(0, pair, expert_out.reshape(rows, d).float())
    return (picked[:t * top_k].view(t, top_k, d) * weights[..., None]).sum(1)


def _pack(tokens, dest, rows):
    """Expert buffers [rows, D]: each pair's token on its ``dest`` row,
    the pairs on row ``rows`` (dropped, or not this buffer's) cut off."""
    t, d = tokens.shape
    k = dest.numel() // t
    pairs_in = tokens[:, None].expand(t, k, d).reshape(t * k, d)
    return tokens.new_zeros((rows + 1, d)).index_copy(0, dest,
                                                      pairs_in)[:rows]


def moe_layer(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
              num_experts: int, top_k: int = 2,
              capacity_factor: float = 1.25, mesh=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply a SwiGLU MoE block. x: [B, S, E_model].

    params: ``w_router`` [E_model, X], stacked expert weights ``w_gate``
    / ``w_up`` [X, E_model, M] and ``w_down`` [X, M, E_model]. Returns
    (output in x's dtype, aux) where aux carries the load-balancing
    loss and the share of (token, choice) pairs dropped. Router logits,
    the top-k softmax, the combine and the aux loss are fp32; the
    expert inputs and weights are cast to x's dtype for the products.

    ``mesh``: None (one device) or a DeviceMesh, where x and the params
    are DTensors placed by the rules (:func:`_moe_on_mesh`); the values
    are one device's.
    """
    if isinstance(mesh, DeviceMesh):
        return _moe_on_mesh(x, params, mesh, num_experts, top_k,
                            capacity_factor)
    if mesh is not None:
        raise TypeError(f"moe_layer: mesh must be None or a DeviceMesh, "
                        f"got {mesh!r}")
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    capacity = _capacity(t, num_experts, top_k, capacity_factor)
    rows = num_experts * capacity

    gate_logits = tokens.float() @ params["w_router"].float()
    weights, idx = router_topk(gate_logits, top_k)
    dest, keep = dispatch_index(idx, num_experts, capacity)

    # Expert buffers [X, C, D]: each kept pair's token in its slot, the
    # dropped pairs on the dummy row that is cut off.
    expert_in = _pack(tokens, dest, rows).view(num_experts, capacity, d)
    expert_out = _experts(expert_in, params["w_gate"], params["w_up"],
                          params["w_down"], x.dtype)
    out = _combine(expert_out, dest, weights, t, top_k)

    # Load-balancing aux loss (Switch Transformer eq. 4).
    probs = torch.softmax(gate_logits, dim=-1)
    frac_tokens = F.one_hot(idx[:, 0], num_experts).float().mean(0)
    aux_loss = num_experts * (frac_tokens * probs.mean(0)).sum()
    dropped = 1.0 - keep.sum().float() / (t * top_k)
    return out.reshape(b, s, d).to(x.dtype), {"aux_loss": aux_loss,
                                              "dropped_fraction": dropped}


# -- expert parallelism --------------------------------------------------------

def _kept(placements, dims: Sequence[int]):
    """``placements`` with every split of a tensor dim outside ``dims``
    made Replicate (gathered for compute, as FSDP gathers)."""
    out = []
    for p in placements:
        if p.is_partial():
            raise ValueError(f"moe_layer: a Partial expert weight "
                             f"({placements})")
        out.append(p if isinstance(p, Shard) and p.dim in dims
                   else Replicate())
    return tuple(out)


def _split_dims(placements, names, dim) -> List[str]:
    """Mesh dims (outer first) whose placement splits tensor dim ``dim``."""
    return [n for n, p in zip(names, placements)
            if isinstance(p, Shard) and p.dim == dim]


def _moe_on_mesh(x, params, mesh, num_experts, top_k, capacity_factor):
    """:func:`moe_layer` on DTensors through ``local_map``.

    The tokens x [B, S, D] stay where the rules put them: B split over
    the mesh dims in ``batch``, S over those in ``seq`` (the token dims),
    D whole. The router is gathered whole; the stacked experts keep their
    split over the expert dim (``expert``) and the FFN width (``tensor``)
    and are gathered over the rest (``fsdp``): the *work* dims, over
    which a rank's tokens are replicated but each rank computes a part.
    A mesh dim that split both raises. Grads: the tokens' and the
    router's are partial sums over the work dims (each rank's pairs
    reach only its part of the combine), the weights' over the token
    dims."""
    names = mesh.mesh_dim_names
    x_pl = tuple(x.placements)
    if any(p.is_partial() or (isinstance(p, Shard) and p.dim > 1)
           for p in x_pl):
        raise ValueError(f"moe_layer: tokens must be split over batch and "
                         f"sequence only, got {x_pl}")
    gate_pl = _kept(params["w_gate"].placements, (0, 2))
    up_pl = _kept(params["w_up"].placements, (0, 2))
    down_pl = _kept(params["w_down"].placements, (0, 1))
    experts = _split_dims(gate_pl, names, 0)
    width = _split_dims(gate_pl, names, 2)
    if (up_pl != gate_pl or _split_dims(down_pl, names, 0) != experts
            or _split_dims(down_pl, names, 1) != width):
        raise ValueError(f"moe_layer: w_gate {gate_pl}, w_up {up_pl} and "
                         f"w_down {down_pl} split the experts differently")
    batch, seq = _split_dims(x_pl, names, 0), _split_dims(x_pl, names, 1)
    work = experts + width
    both = set(batch + seq) & set(work)
    if both:
        raise ValueError(f"moe_layer: mesh dims {sorted(both)} split both "
                         f"the tokens and the experts' work")
    rep = (Replicate(),) * mesh.ndim
    x_grad = tuple(Partial() if n in work else p
                   for n, p in zip(names, x_pl))
    router_grad = tuple(Partial() if n in work or n in batch + seq
                        else Replicate() for n in names)

    def weight_grad(pl):
        return tuple(Partial() if n in batch + seq else p
                     for n, p in zip(names, pl))

    fn = functools.partial(
        _moe_local, mesh=mesh, batch=batch, seq=seq, experts=experts,
        work=work, num_experts=num_experts, top_k=top_k,
        capacity_factor=capacity_factor)
    out, aux_loss, dropped = local_map(
        fn, out_placements=(x_pl, rep, rep),
        in_placements=(x_pl, rep, gate_pl, up_pl, down_pl),
        in_grad_placements=(x_grad, router_grad, weight_grad(gate_pl),
                            weight_grad(up_pl), weight_grad(down_pl)),
        device_mesh=mesh, redistribute_inputs=True)(
            x, params["w_router"], params["w_gate"], params["w_up"],
            params["w_down"])
    return out, {"aux_loss": aux_loss, "dropped_fraction": dropped}


def _coordinate(mesh, dims: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, the count) over ``dims`` nested outer first,
    as DTensor nests the splits of one tensor dim."""
    index, count = 0, 1
    for name in dims:
        n = axis.axis_size(mesh, name)
        index, count = index * n + axis.axis_index(mesh, name), count * n
    return index, count


def _moe_local(x, w_router, w_gate, w_up, w_down, *, mesh, batch, seq,
               experts, work, num_experts, top_k, capacity_factor):
    """One rank's part of the layer: x [b, s, D] its tokens, w_* its
    experts (``w_gate.shape[0]`` of them, from ``experts``' coordinate
    on, ``torch.chunk``'s split) and its share of the FFN width. Returns
    (its tokens' output, psummed over the work dims; the aux loss; the
    dropped fraction), each one device's value."""
    b_l, s_l, d = x.shape
    X, k = num_experts, top_k
    b_idx, b_n = _coordinate(mesh, batch)
    s_idx, s_n = _coordinate(mesh, seq)
    B, S = b_l * b_n, s_l * s_n
    t_l, T = b_l * s_l, B * S
    capacity = _capacity(T, X, k, capacity_factor)
    tokens = x.reshape(t_l, d)
    gate_logits = tokens.float() @ w_router.float()
    weights, idx = router_topk(gate_logits, k)

    # The global [T, k] ids in the global (b, s) order, gathered inner
    # dim first, then routed as on one device: every rank knows every
    # pair's slot, and so which pairs drop.
    ids = idx.view(b_l, s_l, k)
    for name in reversed(batch):
        ids = axis.all_gather(ids, mesh, name, 0)
    for name in reversed(seq):
        ids = axis.all_gather(ids, mesh, name, 1)
    ids = ids.reshape(T, k)
    slot = _slots(ids, X)
    keep = slot < capacity
    dev = x.device
    gid = ((b_idx * b_l + torch.arange(b_l, device=dev))[:, None] * S
           + s_idx * s_l + torch.arange(s_l, device=dev)).reshape(-1)
    keep_l = keep.view(T, k)[gid]

    # This rank's kept pairs for its own experts, packed per expert in
    # slot order: a pair's slot decides whether it drops, never its
    # value, so no row but its own is computed and none twice.
    x_l = w_gate.shape[0]
    e_idx, e_n = _coordinate(mesh, experts)
    local = idx - e_idx * -(-X // e_n)
    own = keep_l & (local >= 0) & (local < x_l)
    local = torch.where(own, local, x_l)
    pos = _slots(local, x_l + 1)
    counts = F.one_hot(local.reshape(-1), x_l + 1)[:, :x_l].sum(0)
    n = max(int(counts.max()), 1) if x_l else 1
    dest = torch.where(own.reshape(-1), local.reshape(-1) * n + pos,
                       x_l * n)
    expert_in = _pack(tokens, dest, x_l * n).view(x_l, n, d)
    expert_out = _experts(expert_in, w_gate, w_up, w_down, x.dtype)
    out = _combine(expert_out, dest, weights, t_l, k)
    for name in work:
        out = axis.psum(out, mesh, name)

    # The aux loss over every token: the probs summed over the token
    # dims, counted once over the work dims (their rank 0's; the others'
    # add zero and get no grad).
    owner = float(all(axis.axis_index(mesh, n) == 0 for n in work))
    probs_sum = torch.softmax(gate_logits, dim=-1).sum(0) * owner
    for name in batch + seq + work:
        probs_sum = axis.psum(probs_sum, mesh, name)
    frac_tokens = F.one_hot(ids[:, 0], X).float().mean(0)
    aux_loss = X * (frac_tokens * (probs_sum / T)).sum()
    dropped = 1.0 - keep.sum().float() / (T * k)
    return out.view(b_l, s_l, d).to(x.dtype), aux_loss, dropped


def init_moe_params(d_model: int, d_ff: int, num_experts: int,
                    dtype=torch.bfloat16, generator: torch.Generator = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's init (normal scaled by fan_in^-0.5, ``w_router``
    fp32, the experts in ``dtype``), drawn from ``generator`` on
    ``device`` (default ``cuda``; raises without one)."""
    # llama imports the ops package, which imports this module.
    from ray_tpu_torch.models.llama import default_device

    device = default_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape, scale, dt):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dt)

    scale_in, scale_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "w_router": normal((d_model, num_experts), scale_in, torch.float32),
        "w_gate": normal((num_experts, d_model, d_ff), scale_in, dtype),
        "w_up": normal((num_experts, d_model, d_ff), scale_in, dtype),
        "w_down": normal((num_experts, d_ff, d_model), scale_out, dtype),
    }


MOE_LOGICAL_AXES = {
    "w_router": ("embed", None),
    "w_gate": ("experts", "embed", "mlp"),
    "w_up": ("experts", "embed", "mlp"),
    "w_down": ("experts", "mlp", "embed"),
}
