"""Placement groups: gang reservation of resource bundles (the port's copy
of ``ray_tpu/util/placement_group.py``).

Re-design of the reference API (reference:
``python/ray/util/placement_group.py:145``): a group reserves every bundle;
tasks and actors then target a bundle with
``PlacementGroupSchedulingStrategy`` (or the ``placement_group=`` option)
and consume the reserved resources instead of free capacity.

The in-process runtime places a group on its one node, so the strategies
are validated but all pack (``STRICT_SPREAD`` of more than one bundle is
infeasible); a process connected to a cluster reserves the bundles on the
node managers through the GCS's 2PC, by the strategy's bundle policy. A
local group's state is the :class:`PlacementGroupInfo` dataclass, a
cluster group's the wire's message of the same name, both with the
fields of JAX's protobuf ``PlacementGroupInfo`` (the card's machine has
no protobuf); the request that creates a group is the dataclass.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Dict, List, Optional

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


@dataclasses.dataclass
class Bundle:
    """One bundle of a group: its index, its resources and the node that
    holds it ("" until placed)."""

    index: int
    resources: Dict[str, float] = dataclasses.field(default_factory=dict)
    node_id: str = ""


@dataclasses.dataclass
class PlacementGroupInfo:
    """A group's request and state (PENDING, CREATED, INFEASIBLE or
    REMOVED), the fields of JAX's protobuf message."""

    group_id: bytes
    name: str = ""
    strategy: str = "PACK"
    bundles: List[Bundle] = dataclasses.field(default_factory=list)
    state: str = "PENDING"


class PlacementGroup:
    """Handle to a (possibly still-placing) placement group."""

    def __init__(self, group_id: bytes, bundles: List[Dict[str, float]],
                 strategy: str = "PACK", name: str = ""):
        self.id = group_id
        self.bundle_specs = list(bundles)
        self.strategy = strategy
        self.name = name

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def _state(self) -> PlacementGroupInfo:
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod.global_worker().core
        info = core.get_placement_group(self.id)
        if info is None:
            raise ValueError(
                f"placement group {self.id.hex()[:12]} does not exist")
        return info

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until every bundle is reserved (state CREATED).

        Returns False on timeout or infeasibility (reference: ``pg.wait``).
        """
        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            state = self._state().state
            if state == "CREATED":
                return True
            if state in ("INFEASIBLE", "REMOVED"):
                return False
            time.sleep(0.05)
        return False

    def ready(self):
        """ObjectRef that resolves once the group is usable — implemented, as
        in the reference, by scheduling a trivial task into bundle 0 so the
        full lease path is exercised (``placement_group.py:145`` ready())."""
        import ray_tpu_torch

        return ray_tpu_torch.remote(num_cpus=0)(_pg_ready).options(
            placement_group=self, placement_group_bundle_index=0).remote()

    def bundle_node_ids(self) -> List[str]:
        """Node id hosting each bundle (empty strings until placed)."""
        return [b.node_id for b in self._state().bundles]

    def __repr__(self):
        return (f"PlacementGroup(id={self.id.hex()[:12]}, "
                f"bundles={self.bundle_specs}, strategy={self.strategy!r})")


def _pg_ready():
    """``PlacementGroup.ready``'s task (module-level: a cluster worker
    imports it by name)."""
    return True


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    """Reserve a group of resource bundles (reference:
    ``python/ray/util/placement_group.py:145``).

    Placement is asynchronous: use ``pg.wait()`` / ``pg.ready()`` to block.
    """
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"Invalid strategy {strategy!r}; expected one of "
            f"{VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement_group requires at least one bundle")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError(f"each bundle must be a non-empty dict, got {b!r}")
        if any(v < 0 for v in b.values()):
            raise ValueError(f"bundle resources must be >= 0: {b!r}")
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker().core
    group_id = uuid.uuid4().bytes
    req = PlacementGroupInfo(
        group_id=group_id, name=name, strategy=strategy,
        bundles=[Bundle(index=i, resources={k: float(v)
                                            for k, v in b.items()})
                 for i, b in enumerate(bundles)])
    core.create_placement_group(req)
    return PlacementGroup(group_id, bundles, strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release every bundle reservation (reference: remove_placement_group)."""
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker().core
    core.remove_placement_group(pg.id)


def placement_group_table(pg: Optional[PlacementGroup] = None) -> Dict:
    """Debug view of one (or every) placement group."""
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker().core
    if pg is not None:
        info = core.get_placement_group(pg.id)
        if info is None:
            raise ValueError(
                f"placement group {pg.id.hex()[:12]} does not exist")
        return _info_to_dict(info)
    raise NotImplementedError("pass a PlacementGroup handle")


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The placement group capturing the current task (if any) — set when a
    task scheduled with ``placement_group_capture_child_tasks=True`` runs."""
    from ray_tpu_torch._private import pg_context

    ctx = pg_context.get()
    if ctx is None:
        return None
    group_id, _bundle, _capture = ctx
    return PlacementGroup(group_id, [], "PACK")


def _info_to_dict(info: PlacementGroupInfo) -> Dict:
    return {
        "placement_group_id": bytes(info.group_id).hex(),
        "name": info.name,
        "strategy": info.strategy,
        "state": info.state,
        "bundles": {b.index: dict(b.resources) for b in info.bundles},
        "bundles_to_node_id": {b.index: b.node_id for b in info.bundles},
    }
