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

Expert parallelism (the ``expert`` mesh axis, whose dispatch and combine
become all-to-alls) waits for meshes: ROADMAP.md queue A, item 7.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


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


def moe_layer(x: torch.Tensor, params: Dict[str, torch.Tensor], *,
              num_experts: int, top_k: int = 2,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Apply a SwiGLU MoE block. x: [B, S, E_model].

    params: ``w_router`` [E_model, X], stacked expert weights ``w_gate``
    / ``w_up`` [X, E_model, M] and ``w_down`` [X, M, E_model]. Returns
    (output in x's dtype, aux) where aux carries the load-balancing
    loss and the share of (token, choice) pairs dropped. Router logits,
    the top-k softmax, the combine and the aux loss are fp32; the
    expert inputs and weights are cast to x's dtype for the products.
    """
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    t = tokens.shape[0]
    capacity = max(int(capacity_factor * t * top_k / num_experts), top_k)
    rows = num_experts * capacity

    gate_logits = tokens.float() @ params["w_router"].float()
    weights, idx = router_topk(gate_logits, top_k)
    dest, keep = dispatch_index(idx, num_experts, capacity)

    # Expert buffers [X, C, D]: each kept pair's token in its slot, the
    # dropped pairs on the dummy row that is cut off.
    pairs_in = tokens[:, None].expand(t, top_k, d).reshape(t * top_k, d)
    expert_in = tokens.new_zeros((rows + 1, d)).index_copy(
        0, dest, pairs_in)[:rows]
    expert_in = expert_in.view(num_experts, capacity, d)

    act = (F.silu(torch.bmm(expert_in, params["w_gate"].to(x.dtype)))
           * torch.bmm(expert_in, params["w_up"].to(x.dtype)))
    expert_out = torch.bmm(act, params["w_down"].to(x.dtype))

    # Combine: each slot's output row back to the pair that filled it
    # (empty slots to the dummy pair row), fp32, weighted, summed over k.
    pair = torch.full((rows + 1,), t * top_k, dtype=torch.long,
                      device=x.device).index_copy(
        0, dest, torch.arange(t * top_k, device=x.device))[:rows]
    picked = expert_out.new_zeros((t * top_k + 1, d), dtype=torch.float32)
    picked = picked.index_copy(0, pair, expert_out.reshape(rows, d).float())
    out = (picked[:t * top_k].view(t, top_k, d) * weights[..., None]).sum(1)

    # Load-balancing aux loss (Switch Transformer eq. 4).
    probs = torch.softmax(gate_logits, dim=-1)
    frac_tokens = F.one_hot(idx[:, 0], num_experts).float().mean(0)
    aux_loss = num_experts * (frac_tokens * probs.mean(0)).sum()
    dropped = 1.0 - keep.sum().float() / (t * top_k)
    return out.reshape(b, s, d).to(x.dtype), {"aux_loss": aux_loss,
                                              "dropped_fraction": dropped}


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
