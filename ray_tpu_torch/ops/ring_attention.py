"""Sequence parallelism: ring attention and Ulysses all-to-all (port of
``ray_tpu/ops/ring_attention.py``).

* :func:`ring_attention`: blockwise attention where the K/V shards move
  one hop a step around the ``seq`` mesh axis (:func:`ppermute`) while
  each step's partial softmax is merged online. JAX's block math is plain
  einsums, not a Pallas kernel, and so is this one: fp32 products over
  ``[B, Sq, Hkv, G, Sk]`` per step.
* :func:`ulysses_attention`: an all-to-all from sequence shards to head
  shards, ``[B, S/N, H, D] -> [B, S, H/N, D]``, dense attention over the
  whole sequence for H/N heads (the port's :func:`flash_attention`, so
  the flash kernels carry it on the card), and the all-to-all back.

Both run on each rank's local tensors inside ``local_map`` over a
:class:`~torch.distributed.device_mesh.DeviceMesh` (JAX's ``shard_map``)
and take the mesh with the axis name. :mod:`ray_tpu_torch.models.llama`
runs the ring when the mesh has seq > 1; Ulysses stays an op, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.parallel.axis import (all_to_all, axis_index, axis_size,
                                         ppermute)


def _block_attend(q, k, v, q_pos, k_pos, scale, causal):
    """One blockwise partial-attention step.

    q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; positions are global token
    ids. Returns unnormalized (acc [B, Sq, Hq, D], m, l [B, Sq, Hq, 1]),
    all fp32.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]            # [Sq, Sk]
        s = torch.where(mask[None, :, None, None, :], s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)                       # [b,sq,hkv,g,1]
    # Rows with no visible key in this block: exp(-inf - -inf) guards.
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return (acc.reshape(b, sq, hq, d), m_safe.reshape(b, sq, hq, 1),
            l.reshape(b, sq, hq, 1))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: DeviceMesh, axis_name: str = "seq",
                   causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over a sharded sequence axis (call inside
    ``local_map``).

    ``q/k/v``: local shards [B, S_local, H, D] ([B, S_local, Hkv, D] for
    k/v); the global sequence is the concatenation over ``axis_name`` in
    mesh order. On a mesh without that axis it is a ring of one: one
    block over the whole sequence.
    """
    n = axis_size(mesh, axis_name)
    my_idx = axis_index(mesh, axis_name)
    b, s_local, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    arange = torch.arange(s_local, device=q.device)
    q_pos = my_idx * s_local + arange
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = torch.zeros((b, s_local, hq, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, s_local, hq, 1), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    k_cur, v_cur = k, v
    # JAX's lax.scan over N steps as a Python loop: at step i this rank
    # holds the K/V chunk of index (my_idx - i) % N.
    for i in range(n):
        k_pos = ((my_idx - i) % n) * s_local + arange
        a, m_blk, l_blk = _block_attend(q, k_cur, v_cur, q_pos, k_pos,
                                        scale, causal)
        # Merge online-softmax partials. Blocks fully above the causal
        # diagonal give l_blk == 0 and add nothing.
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_blk - m_new)
        acc = acc * alpha + a * beta
        l = l * alpha + l_blk * beta
        m = m_new
        # Rotate K/V one hop (the last step's rotation, which JAX makes
        # and never reads, is left out on every rank).
        if i < n - 1:
            k_cur = ppermute(k_cur, mesh, axis_name, perm)
            v_cur = ppermute(v_cur, mesh, axis_name, perm)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: DeviceMesh, axis_name: str = "seq",
                      causal: bool = True, scale: Optional[float] = None,
                      attn_fn=None) -> torch.Tensor:
    """Ulysses sequence parallelism (call inside ``local_map``).

    All-to-all turns the sequence sharding into a head sharding, dense
    attention (``attn_fn``, default :func:`flash_attention`) runs over
    the whole sequence for H/N heads, and the result goes back. Hq and
    Hkv must both be divisible by the axis size.
    """
    n = axis_size(mesh, axis_name)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"ulysses_attention: {q.shape[2]} q heads and {k.shape[2]} kv "
            f"heads must both be divisible by the {axis_name!r} axis size "
            f"{n}")
    attn_fn = attn_fn or flash_attention
    # [B, S/N, H, D] -> [B, S, H/N, D]
    qg, kg, vg = (all_to_all(t, mesh, axis_name, split_axis=2,
                             concat_axis=1) for t in (q, k, v))
    out = attn_fn(qg, kg, vg, causal=causal, scale=scale)
    # [B, S, H/N, D] -> [B, S/N, H, D]
    return all_to_all(out, mesh, axis_name, split_axis=1, concat_axis=2)
