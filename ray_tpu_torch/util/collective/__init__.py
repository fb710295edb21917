"""Host-tier collective communication between the runtime's processes
(the port of ``ray_tpu/util/collective``)."""

from ray_tpu_torch.util.collective.collective import (
    CollectiveGroup,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reduce,
    reducescatter,
    send,
)

__all__ = [
    "CollectiveGroup", "allgather", "allreduce", "barrier", "broadcast",
    "destroy_collective_group", "get_collective_group_size", "get_rank",
    "init_collective_group", "is_group_initialized", "recv", "reduce",
    "reducescatter", "send",
]
