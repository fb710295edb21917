"""Device-mesh construction and axis conventions (port of
``ray_tpu/parallel/mesh.py``).

Parallelism is a named mesh over the ranks of the default
``torch.distributed`` process group (NCCL on the card, gloo on the CPU),
with the JAX package's six axis names:

===========  =============================================================
axis         meaning
===========  =============================================================
``data``     pure data parallelism (batch sharding, gradients summed)
``fsdp``     ZeRO-3-style parameter/optimizer sharding (also shards batch)
``tensor``   tensor (Megatron-style) model parallelism
``seq``      sequence/context parallelism (ring attention / Ulysses)
``expert``   expert parallelism for MoE dispatch
``stage``    pipeline stages
===========  =============================================================

The :class:`~torch.distributed.device_mesh.DeviceMesh` holds only the
axes of size > 1 (one axis of size 1 for a one-rank mesh), so DTensor
walks one placement a real axis on every op; :func:`mesh_shape` still
names all six axes, with size 1 for an axis the mesh dropped. Rank ``r``
sits where JAX's reshape of the device list puts device ``r``: row-major
over the axes in :data:`MESH_AXES` order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# The JAX package's axis order: DCN-friendly axes (stage, data) first,
# the ones that talk most (seq, tensor) last.
MESH_AXES = ("stage", "data", "fsdp", "expert", "seq", "tensor")

# The axis a one-rank mesh keeps.
_ONE_RANK_AXIS = "fsdp"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. ``-1`` on one axis means "all remaining
    devices"."""

    data: int = 1
    fsdp: int = -1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    stage: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {
            "stage": self.stage,
            "data": self.data,
            "fsdp": self.fsdp,
            "expert": self.expert,
            "seq": self.seq,
            "tensor": self.tensor,
        }
        wildcard = [k for k, v in sizes.items() if v == -1]
        if len(wildcard) > 1:
            raise ValueError(
                f"at most one mesh axis may be -1, got {wildcard}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wildcard:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but {n_devices} are "
                f"available")
        return sizes


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default torch.distributed process group: "
            "call torch.distributed.init_process_group first (one rank "
            "per device)")
    return dist.get_world_size()


def make_mesh(config: Optional[MeshConfig] = None, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A named mesh over every rank of the default process group, shaped
    by ``config`` (default: all ranks on ``fsdp``). ``device_type`` is
    ``"cuda"`` unless the caller asks for ``"cpu"`` (gloo)."""
    config = config or MeshConfig()
    sizes = config.resolve(_world_size())
    names = tuple(a for a in MESH_AXES if sizes[a] > 1) or (_ONE_RANK_AXIS,)
    return init_device_mesh(device_type, tuple(sizes[a] for a in names),
                            mesh_dim_names=names)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A one-rank mesh: the default process group must hold one rank."""
    return make_mesh(MeshConfig(fsdp=1), device_type=device_type)


def mesh_shape(mesh) -> Dict[str, int]:
    """Size of each of the six axes of a :class:`DeviceMesh` (1 for an
    axis it does not hold)."""
    held = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: held.get(a, 1) for a in MESH_AXES}


def batch_axes(mesh) -> List[str]:
    """Mesh axes over which the global batch is sharded."""
    return [a for a in ("data", "fsdp") if mesh_shape(mesh).get(a, 1) > 1]


def num_model_replicas(mesh) -> int:
    s = mesh_shape(mesh)
    return s.get("data", 1) * s.get("fsdp", 1)
