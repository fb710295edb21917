"""Mesh and sharding primitives of the port (``ray_tpu/parallel``): a
named device mesh over ``torch.distributed`` ranks and the logical-axis
rule table, whose specs become DTensor placements. ``axis`` holds the
named-axis collectives that code inside ``local_map`` calls (JAX's
``jax.lax`` ops under ``shard_map``); GPipe's ``pipelined`` is imported
from ``parallel.pipeline``, as in the JAX package."""

from ray_tpu_torch.parallel.mesh import (
    MESH_AXES,
    MeshConfig,
    batch_axes,
    make_mesh,
    mesh_shape,
    num_model_replicas,
    single_device_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    constrain,
    logical_to_spec,
    shard_tree,
    tree_shardings,
    tree_specs,
)

__all__ = [
    "MESH_AXES", "MeshConfig", "batch_axes", "make_mesh", "mesh_shape",
    "num_model_replicas", "single_device_mesh",
    "DEFAULT_RULES", "constrain", "logical_to_spec", "shard_tree",
    "tree_shardings", "tree_specs",
]
