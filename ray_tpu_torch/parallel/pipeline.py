"""Pipeline parallelism over the ``stage`` mesh axis (port of
``ray_tpu/parallel/pipeline.py``).

A pipeline is one SPMD program, as in the JAX package: the stages'
params are stacked on a leading axis split over ``stage``, every rank
runs the same GPipe fill/drain loop on its own stage's slab (through
``local_map``, JAX's ``shard_map``), and microbatch activations move one
hop a step with :func:`~ray_tpu_torch.parallel.axis.ppermute`. Autograd
runs the schedule backwards through the same collectives.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch.parallel.axis import axis_index, axis_size, ppermute, psum


def pipelined(stage_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor],
                                 torch.Tensor],
              mesh: DeviceMesh, *, num_microbatches: int,
              axis_name: str = "stage"):
    """Build a pipelined forward: y = stageN(...stage1(x)).

    ``stage_fn(stage_params, x_mb)`` applies ONE stage to one microbatch.
    The returned ``run(stage_params, batch)`` takes a dict of stacked
    ``[S, ...]`` tensors, one slab a stage, and a batch ``[B, ...]`` with
    B divisible by ``num_microbatches``. DTensors must be placed
    ``Shard(0)`` on the stage axis and replicated elsewhere (the batch:
    replicated); plain tensors, the same on every rank, are placed so,
    their grads come back whole on every rank, and the output is a plain
    tensor. The output, ``[B, ...]``, is replicated on every rank.

    Schedule: GPipe's loop of M + S - 1 steps. At step t the rank holding
    stage s runs microbatch t - s (stage 0 takes microbatch t, the others
    the activation that just arrived); its output counts only while t - s
    is in [0, M). Bubble fraction (S - 1) / (M + S - 1).
    """
    num_stages = axis_size(mesh, axis_name)
    M = num_microbatches
    names = mesh.mesh_dim_names
    stage_pl = tuple(Shard(0) if n == axis_name else Replicate()
                     for n in names)
    replicated = (Replicate(),) * len(names)
    batch_grad_pl = tuple(Partial() if n == axis_name else Replicate()
                          for n in names)

    def body(batch, *slabs, keys):
        # Every rank builds the same autograd graph: the backward's
        # collectives pair up only if each rank runs each of them, in
        # the same order. So the schedule selects by ``where`` on this
        # rank's stage, as JAX's does, and branches on nothing.
        stage = axis_index(mesh, axis_name)
        params = {k: t[0] for k, t in zip(keys, slabs)}
        mb = batch.reshape(M, -1, *batch.shape[1:])
        perm = [(i, (i + 1) % num_stages) for i in range(num_stages)]
        last = num_stages - 1

        def flag(b):
            return torch.tensor(b, device=batch.device)

        carry = torch.zeros_like(mb[0])
        out_buf = [torch.zeros_like(mb[0])] * M
        steps = M + num_stages - 1
        for t in range(steps):
            # Stage 0 ingests microbatch t; the others use the carried
            # activation that just arrived from the previous stage.
            x_in = torch.where(flag(stage == 0), mb[min(t, M - 1)], carry)
            y = stage_fn(params, x_in)
            # Valid only while this stage has a real microbatch in hand.
            my_mb = t - stage
            valid = 0 <= my_mb < M
            y = torch.where(flag(valid), y, 0.0)
            # The last stage banks its finished microbatch.
            slot = min(max(my_mb, 0), M - 1)
            out_buf[slot] = torch.where(flag(valid and stage == last), y,
                                        out_buf[slot])
            # Ship activations one hop down the pipeline (the last step's
            # carry is never read, so no rank sends it).
            if t < steps - 1:
                carry = ppermute(y, mesh, axis_name, perm)
        # Only the last stage's buffer is real: a psum of the masked
        # buffer replicates it over the stage axis.
        masked = torch.where(flag(stage == last), torch.stack(out_buf), 0.0)
        return psum(masked, mesh, axis_name)

    def run(stage_params: Dict[str, torch.Tensor], batch: torch.Tensor):
        keys = list(stage_params)
        plain = not isinstance(batch, DTensor)
        for k in keys:
            if stage_params[k].shape[0] != num_stages:
                raise ValueError(
                    f"stage param {k!r} has {stage_params[k].shape[0]} "
                    f"slabs for {num_stages} stages")
        if batch.shape[0] % M:
            raise ValueError(f"batch {batch.shape[0]} not divisible by "
                             f"num_microbatches={M}")
        slabs = [_placed(stage_params[k], mesh, stage_pl) for k in keys]
        batch = _placed(batch, mesh, replicated)

        def local(batch, *slabs):
            return body(batch, *slabs, keys=keys)

        out = local_map(
            local, out_placements=list(replicated),
            in_placements=(replicated,) + (stage_pl,) * len(keys),
            in_grad_placements=(batch_grad_pl,) + (stage_pl,) * len(keys),
            device_mesh=mesh, redistribute_inputs=False)(batch, *slabs)
        out = out.reshape(-1, *out.shape[2:])
        return out.to_local() if plain else out

    return run


def _placed(t: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """``t`` as a DTensor in ``placements``: a DTensor must already be
    there; a plain tensor, the same on every rank, is taken as replicated
    and split (differentiably: its grad comes back whole)."""
    if isinstance(t, DTensor):
        if tuple(t.placements) != tuple(placements):
            raise ValueError(f"pipelined: a DTensor in {t.placements} where "
                             f"{placements} is needed")
        return t
    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, placements)
