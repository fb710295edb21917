"""Task / actor submission options (the port's copy of
``ray_tpu/_private/options.py``).

Re-design of the reference options plumbing (reference:
``python/ray/_private/ray_option_utils.py``): a validated dataclass shared by
``@remote`` decorators and ``.options(...)`` overrides.

Cards, not chips: the port's accelerator is the CUDA card, so
``num_gpus`` charges the ``"GPU"`` resource and ``num_tpus`` (the JAX
package's chip count) is refused with a ``ValueError`` that names
``num_gpus``, as ``resources={"GPU": ...}`` is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


def is_streaming(num_returns: Any) -> bool:
    """True when ``num_returns`` requests a streaming generator task
    (``"streaming"``, or the reference's ``"dynamic"`` alias)."""
    return num_returns in ("streaming", "dynamic")


_NUM_TPUS_REFUSED = (
    "num_tpus is the JAX package's TPU chip count; the port schedules "
    "CUDA cards: use num_gpus")


@dataclasses.dataclass
class RemoteOptions:
    # Resources. ``num_gpus`` is the accelerator: cards, charged as "GPU".
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    memory: Optional[float] = None
    resources: Optional[Dict[str, float]] = None

    # Task behavior. num_returns: int, or "streaming"/"dynamic" for
    # generator tasks whose yields become an ObjectRefGenerator.
    num_returns: Any = 1
    max_retries: Optional[int] = None
    retry_exceptions: Any = False  # False | True | list of exception types
    name: Optional[str] = None

    # Actor behavior.
    max_restarts: int = 0
    max_task_retries: int = 0
    # None = unset: sync actors run ordered (1); async actors default to
    # 1000 concurrent awaits. An EXPLICIT 1 stays 1 even on async actors
    # (e.g. a serve deployment with max_ongoing_requests=1 must serialize).
    max_concurrency: Optional[int] = None
    max_pending_calls: int = -1
    lifetime: Optional[str] = None  # None | "detached"
    namespace: Optional[str] = None
    get_if_exists: bool = False

    # Placement.
    scheduling_strategy: Any = None  # None|"DEFAULT"|"SPREAD"|strategy object
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    # Environment.
    runtime_env: Optional[Dict[str, Any]] = None

    # Concurrency groups for actors: {"group": max_concurrency}.
    concurrency_groups: Optional[Dict[str, int]] = None

    # Internal.
    _is_actor: bool = False
    # Set at ActorClass._remote time (the client sees the class): async
    # actors get a wider submitter send window so max_concurrency isn't
    # silently capped by the in-flight push limit.
    _is_async_actor: bool = False

    def merged_with(self, overrides: Dict[str, Any]) -> "RemoteOptions":
        if "num_tpus" in overrides:
            raise ValueError(_NUM_TPUS_REFUSED)
        known = {f.name for f in dataclasses.fields(self)}
        bad = set(overrides) - known
        if bad:
            raise ValueError(f"Unknown options: {sorted(bad)}")
        return dataclasses.replace(self, **overrides)

    def task_resources(self, default_num_cpus: float = 1.0) -> Dict[str, float]:
        """Resolve the resource demand of one invocation."""
        req: Dict[str, float] = {}
        cpus = self.num_cpus
        if cpus is None:
            cpus = 0.0 if self._is_actor else default_num_cpus
        if cpus:
            req["CPU"] = float(cpus)
        if self.num_gpus:
            req["GPU"] = float(self.num_gpus)
        if self.memory:
            req["memory"] = float(self.memory)
        for k, v in (self.resources or {}).items():
            if k in ("CPU", "GPU"):
                raise ValueError(
                    f"Use num_cpus/num_gpus instead of resources[{k!r}]")
            req[k] = float(v)
        return req


def options_from_decorator_kwargs(kwargs: Dict[str, Any], is_actor: bool) -> RemoteOptions:
    opts = RemoteOptions(_is_actor=is_actor)
    return opts.merged_with(kwargs)


@dataclasses.dataclass
class PlacementFields:
    """Resolved scheduling-strategy fields, 1:1 with the TaskSpec proto
    (reference: TaskSpecification scheduling_strategy,
    ``common/task/task_spec.h`` + ``scheduling_strategies.py``)."""

    placement_group_id: bytes = b""
    bundle_index: int = -1
    capture_child_tasks: bool = False
    affinity_node_id: str = ""
    affinity_soft: bool = False
    strategy: str = ""  # "" | "DEFAULT" | "SPREAD"
    label_selector: bytes = b""  # JSON, NodeLabelSchedulingStrategy.encode()


def resolve_placement(options: RemoteOptions) -> PlacementFields:
    """Collapse ``scheduling_strategy`` / ``placement_group=`` options (and,
    absent both, the worker's capture context) into TaskSpec fields.

    Matches reference precedence: an explicit strategy object wins, then the
    legacy ``placement_group=`` option, then
    ``placement_group_capture_child_tasks`` inherited from the running task.
    """
    out = PlacementFields()
    strat = options.scheduling_strategy
    pg = options.placement_group
    idx = options.placement_group_bundle_index
    capture = options.placement_group_capture_child_tasks
    if strat is not None:
        if isinstance(strat, str):
            if strat not in ("DEFAULT", "SPREAD"):
                raise ValueError(
                    f"Unknown scheduling strategy {strat!r}; expected "
                    "'DEFAULT', 'SPREAD', or a strategy object")
            out.strategy = strat
        elif hasattr(strat, "placement_group"):
            pg = strat.placement_group
            idx = strat.placement_group_bundle_index
            capture = strat.placement_group_capture_child_tasks
        elif hasattr(strat, "node_id"):
            out.affinity_node_id = strat.node_id
            out.affinity_soft = bool(strat.soft)
            return out
        elif hasattr(strat, "hard") and hasattr(strat, "encode"):
            out.label_selector = strat.encode()
            return out
        else:
            raise ValueError(f"Unknown scheduling strategy {strat!r}")
    if pg is not None:
        group_id = pg.id if hasattr(pg, "id") else pg
        if idx >= len(getattr(pg, "bundle_specs", [])) and \
                getattr(pg, "bundle_specs", None):
            raise ValueError(
                f"placement_group_bundle_index {idx} out of range for a "
                f"group with {len(pg.bundle_specs)} bundles")
        out.placement_group_id = group_id
        out.bundle_index = idx
        out.capture_child_tasks = bool(capture)
        return out
    if not out.strategy:
        # Inherit the capturing group of the currently-executing task.
        from ray_tpu_torch._private import pg_context

        ctx = pg_context.get()
        if ctx is not None:
            gid, _bidx, cap = ctx
            if cap:
                out.placement_group_id = gid
                out.bundle_index = -1
                out.capture_child_tasks = True
    return out
