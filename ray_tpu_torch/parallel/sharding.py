"""Logical-axis sharding rules (port of ``ray_tpu/parallel/sharding.py``).

Every parameter and activation carries logical axis names, and a rule
table maps them to mesh axes, as in the JAX package: DP, FSDP, TP and
their hybrids are a change of table, not of wrappers. A *spec* is a
tuple with one entry per tensor dim (``None``, a mesh axis name, or a
tuple of names), JAX's ``PartitionSpec`` as a plain tuple. On a
:class:`~torch.distributed.device_mesh.DeviceMesh` a spec becomes DTensor
placements, one per mesh dim (:func:`spec_placements`), and DTensor
inserts the all-gathers and reductions that XLA inserts for GSPMD.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ray_tpu_torch.parallel.mesh import MESH_AXES, mesh_shape

# Logical activation/parameter axis names used by the models:
#   "batch"       – per-example dimension
#   "seq"         – sequence/token dimension (activations)
#   "embed"       – model/hidden dimension
#   "mlp"         – feed-forward intermediate dimension
#   "heads"       – attention heads
#   "kv_heads"    – key/value heads (GQA)
#   "head_dim"    – per-head dimension
#   "vocab"       – vocabulary dimension
#   "kv_seq"      – key/value sequence (ring-attention shifted axis)
#   "experts"     – MoE expert dimension
#   "layers"      – stacked layer dimension (never sharded)

LogicalRules = Tuple[Tuple[str, Union[str, Tuple[str, ...], None]], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# FSDP shards params on the embed dim, TP on heads/mlp/vocab, batch over
# (data, fsdp), sequence over seq: the JAX package's table, entry for
# entry.
DEFAULT_RULES: LogicalRules = (
    # parameter axes
    ("embed", "fsdp"),
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("head_dim", None),
    ("vocab", "tensor"),
    ("experts", "expert"),
    ("layers", None),
    # activation axes (distinct from param axes: an activation's feature
    # dim stays unsharded on the fsdp axis — fsdp gathers params for
    # compute)
    ("batch", ("data", "fsdp")),
    ("seq", "seq"),
    ("kv_seq", None),
    ("act_embed", None),
    ("act_mlp", "tensor"),
    ("act_heads", "tensor"),
    ("act_kv_heads", "tensor"),
    ("act_vocab", "tensor"),
)


def rules_dict(rules=None) -> Dict[str, Any]:
    """The rule table as a dict; ``rules`` is JAX's tuple of pairs or a
    dict (default :data:`DEFAULT_RULES`)."""
    return dict(rules if rules is not None else DEFAULT_RULES)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules=None) -> Spec:
    """Map a tuple of logical axis names to a spec via the rule table."""
    table = rules_dict(rules)
    return tuple(table.get(a) if a is not None else None
                 for a in logical_axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a dict tree (and of trees of its shape)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_specs(logical_tree: Any, rules=None) -> Any:
    """Map a dict tree of logical-axis tuples to a tree of specs."""
    return tree_map(lambda axes: logical_to_spec(axes, rules)
                     if _is_axes(axes) else axes, logical_tree)


def divisible_spec(spec: Spec, shape: Sequence[int],
                   sizes: Dict[str, int]) -> Spec:
    """``spec`` with the mesh axes dropped where they do not divide the
    dim (``sizes``: axis name -> size): that dim stays replicated, as
    GSPMD's divisibility requirement leaves it in the JAX trainer."""
    def axis_size(entry) -> int:
        names = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for name in names:
            n *= sizes.get(name, 1)
        return n

    padded = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(entry if entry is None or dim % axis_size(entry) == 0
                 else None for dim, entry in zip(shape, padded))


def spec_placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each mesh axis that tensor dim ``d`` names, else
    ``Replicate()``. Axes the mesh does not hold (size 1) drop out. A dim
    on several axes is split over them in :data:`MESH_AXES` order (the
    outer axis first), as a JAX spec names them; another order raises."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        held = [a for a in axes if a in names]
        if held != sorted(held, key=MESH_AXES.index):
            raise ValueError(
                f"spec entry {entry} splits a dim over mesh axes out of "
                f"MESH_AXES order {MESH_AXES}")
        for a in held:
            if out[names.index(a)] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def placements_for(mesh: DeviceMesh, shape: Sequence[int],
                   *logical_axes: Optional[str],
                   rules=None) -> Tuple[Placement, ...]:
    """Placements on ``mesh`` of a tensor of ``shape`` whose dims carry
    ``logical_axes``, through the rules and :func:`divisible_spec`."""
    spec = divisible_spec(logical_to_spec(logical_axes, rules), shape,
                          mesh_shape(mesh))
    return spec_placements(spec, mesh)


def tree_shardings(mesh: DeviceMesh, logical_tree: Any, rules=None) -> Any:
    """A tree of placement tuples for a tree of logical-axis tuples."""
    return tree_map(lambda spec: spec_placements(spec, mesh),
                     tree_specs(logical_tree, rules))


def constrain(x: Any, mesh, *logical_axes: Optional[str], rules=None):
    """Redistribute DTensor ``x`` to the placements of ``logical_axes``
    (JAX's ``with_sharding_constraint``); nothing happens off a mesh. A
    mesh axis that does not divide its dim leaves the dim replicated
    (:func:`divisible_spec`). On a mesh ``x`` must be a DTensor: a plain
    tensor there would be one rank's full tensor taken for the whole."""
    if not isinstance(mesh, DeviceMesh):
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain on a mesh needs a DTensor, got "
                        f"{type(x).__name__} of shape {tuple(x.shape)}")
    placements = placements_for(mesh, x.shape, *logical_axes, rules=rules)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def shard_tree(tree: Any, shardings: Any, mesh: DeviceMesh) -> Any:
    """Distribute each tensor of ``tree`` (the same on every rank) onto
    ``mesh`` with its placements from ``shardings``."""
    return tree_map(lambda t, pl: distribute_tensor(t, mesh, pl), tree,
                     shardings)
