"""Named-axis collectives: the port's stand-ins for the ``jax.lax`` ops
that code inside ``shard_map`` calls on one mesh axis (``axis_index``,
``psum``, ``ppermute``, ``all_to_all``, ``all_gather``).

They run on each rank's local tensors inside ``local_map`` over a
:class:`~torch.distributed.device_mesh.DeviceMesh` and talk over the
process group of one named mesh dim. ``make_mesh`` keeps only the axes
of size > 1, so an axis the mesh dropped reads index 0 and size 1, and
there each op is what JAX's is on a size-1 axis, without a collective.
A rank's index on an axis is its coordinate there, which is its rank in
that dim's group (a mesh lays ranks out row-major, so the group's ranks
rise with the coordinate).

Each op but :func:`all_gather` (its callers gather integer routing ids)
is differentiable, and its backward is the transpose JAX's autodiff
gives it:

* :func:`ppermute`: the cotangent travels the pairs backwards, the
  inverse permutation; a rank that received nothing sends zeros back;
* :func:`all_to_all`: the inverse all-to-all, ``split_axis`` and
  ``concat_axis`` swapped;
* :func:`psum`: the output is the same on every rank of the axis, and so
  is its cotangent, which every rank already holds: the backward is the
  identity (JAX's transpose of a psum to an axis-invariant value). A
  backward that all-reduced the cotangent again would multiply the grads
  by the axis size.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis`` (JAX's ``psum(1, axis)``); 1 for an axis the
    mesh does not hold."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``); 0
    for an axis the mesh does not hold."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def _group(mesh: DeviceMesh, axis: str):
    group = mesh.get_group(axis)
    if dist.get_rank(group) != mesh.get_local_rank(axis):
        raise RuntimeError(
            f"mesh axis {axis!r}: group rank {dist.get_rank(group)} is not "
            f"the coordinate {mesh.get_local_rank(axis)}")
    return group


def _check_perm(perm: Sequence[Tuple[int, int]], n: int):
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= i < n for i in srcs + dsts)):
        raise ValueError(f"ppermute: {list(perm)} is not a partial "
                         f"permutation of {n} indices")


def _permute(x: torch.Tensor, group, me: int, n: int,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` to the index ``perm`` pairs this rank with, receive from
    the one it pairs to this rank (zeros if none): one all-to-all with
    a part for the pair's peer and empty parts for every other rank. It
    is a collective, so a rank in no pair takes part too."""
    x = x.contiguous()
    send = [0] * n
    recv = [0] * n
    for s, d in perm:
        if s == me:
            send[d] = x.numel()
        if d == me:
            recv[s] = x.numel()
    out = torch.zeros_like(x)
    dist.all_to_all_single(out.view(-1)[:sum(recv)], x.view(-1)[:sum(send)],
                           output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, n, perm):
        ctx.group, ctx.me, ctx.n = group, me, n
        ctx.inverse = [(d, s) for s, d in perm]
        return _permute(x, group, me, n, perm)

    @staticmethod
    def backward(ctx, g):
        return (_permute(g, ctx.group, ctx.me, ctx.n, ctx.inverse), None,
                None, None, None)


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: the rank at index ``s`` sends ``x`` to index
    ``d`` for each pair ``(s, d)`` of ``perm`` (axis indices, not global
    ranks); a rank no pair sends to gets zeros."""
    n = axis_size(mesh, axis)
    perm = [(int(s), int(d)) for s, d in perm]
    _check_perm(perm, n)
    if n == 1:
        return x if perm else torch.zeros_like(x)
    return _PPermute.apply(x, _group(mesh, axis), axis_index(mesh, axis),
                           n, perm)


def _all_to_all(x: torch.Tensor, group, n: int, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """Split dim ``split_axis`` into ``n`` parts, part j to index j, and
    concatenate the parts received along ``concat_axis`` in index order.
    The split dim moves to the front (``all_to_all_single`` splits dim 0)
    and back."""
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)}"
                         f" is not divisible by the axis size {n}")
    parts = x.movedim(split_axis, 0)
    parts = parts.reshape(n, parts.shape[0] // n, *parts.shape[1:])
    parts = parts.contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    # out[j] is index j's part, its split dim in front: restore each
    # part's layout, then put j just outside concat_axis and merge.
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(out.shape)
    shape[concat_axis:concat_axis + 2] = [shape[concat_axis]
                                          * shape[concat_axis + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, concat_axis, split_axis)
        return _all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: dim ``split_axis`` is cut
    into one part per index of ``axis``, part j goes to index j, and the
    parts this rank receives are concatenated along ``concat_axis`` in
    index order."""
    n = axis_size(mesh, axis)
    split_axis, concat_axis = split_axis % x.ndim, concat_axis % x.ndim
    if n == 1:
        return x
    return _AllToAll.apply(x, _group(mesh, axis), n, split_axis,
                           concat_axis)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over the ranks of ``axis``, the
    same on each of them (backward: the identity, see the module
    docstring)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _PSum.apply(x, _group(mesh, axis))


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)`` without a backward: every
    rank's ``x`` concatenated along ``dim`` in index order, the same on
    each rank of ``axis``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.detach().contiguous(), group=_group(mesh, axis))
    return torch.cat(parts, dim)
