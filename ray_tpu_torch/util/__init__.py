"""Utilities (the counterpart of ``ray_tpu/util``): placement groups and
scheduling strategies (exported here, as JAX's are),
:mod:`~ray_tpu_torch.util.metrics`, :mod:`~ray_tpu_torch.util.tracing`
and the host-tier :mod:`~ray_tpu_torch.util.collective`."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    DoesNotExist,
    Exists,
    In,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    NotIn,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "get_current_placement_group",
    "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "In",
    "NotIn",
    "Exists",
    "DoesNotExist",
]
