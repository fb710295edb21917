"""Scheduling strategies for tasks and actors (the port's copy of
``ray_tpu/util/scheduling_strategies.py``).

Re-design of the reference strategy objects (reference:
``python/ray/util/scheduling_strategies.py``): plain dataclasses consumed by
the submit paths, which translate them into scheduling fields. The
in-process runtime honours the placement-group strategy; it has one node,
so node affinity, label selectors and ``"SPREAD"`` are accepted and place
nothing differently (JAX's node-side policies come with the cluster
runtime).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy:
    """Schedule onto a reserved placement-group bundle.

    Reference: ``scheduling_strategies.py`` PlacementGroupSchedulingStrategy.
    The task/actor charges the group's reserved bundle resources instead
    of free node capacity, so gang placement survives contention.
    """

    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy:
    """Pin to one node. ``soft=True`` falls back to the default policy when
    the node is gone/full (reference: NodeAffinitySchedulingStrategy)."""

    node_id: str
    soft: bool = False


# Label-match operators (reference: ``ray.util.scheduling_strategies``
# In/NotIn/Exists/DoesNotExist). Each lowers to the JSON value spec a
# label selector carries.

def In(*values: str):
    """Label value must be one of ``values``."""
    return {"in": [str(v) for v in values]}


def NotIn(*values: str):
    """Label value must not be any of ``values`` (absent keys match)."""
    return {"not_in": [str(v) for v in values]}


def Exists():
    """Label key must be present (any value)."""
    return {"exists": True}


def DoesNotExist():
    """Label key must be absent."""
    return {"exists": False}


@dataclasses.dataclass
class NodeLabelSchedulingStrategy:
    """Constrain placement by node labels (reference:
    NodeLabelSchedulingStrategy + the node-label scheduling policy,
    ``raylet/scheduling/policy/node_label_scheduling_policy.h``).

    ``hard`` selectors must all match or the node is ineligible; ``soft``
    selectors rank eligible nodes (full-soft-match preferred). Values may be
    a plain string (exact match) or one of :func:`In`/:func:`NotIn`/
    :func:`Exists`/:func:`DoesNotExist`.
    """

    hard: Optional[dict] = None
    soft: Optional[dict] = None

    def encode(self) -> bytes:
        import json

        def norm(sel):
            out = {}
            for k, v in (sel or {}).items():
                out[k] = {"in": [str(v)]} if isinstance(v, str) else dict(v)
            return out

        return json.dumps(
            {"hard": norm(self.hard), "soft": norm(self.soft)},
            sort_keys=True).encode()


# String strategies "DEFAULT" (hybrid pack-then-spread) and "SPREAD"
# (min-utilization) are accepted anywhere a strategy object is.
SchedulingStrategyT = Optional[Any]
