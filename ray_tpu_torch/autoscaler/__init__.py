"""ray_tpu_torch.autoscaler: the card-pool arbiter (the local-mode half
of ``ray_tpu/autoscaler``, ROADMAP.md queue A item 19a).

Only the arbiter's names are exported (:mod:`.arbiter`). The cluster
autoscaler (``Autoscaler``, ``NodeProvider``, ``FakeNodeProvider`` and
``request_resources``) needs the cluster runtime: reaching one of them
raises ``not_ported`` naming item 19b.
"""

from ray_tpu_torch.autoscaler.arbiter import (
    ABORTED,
    ABORTING,
    COMMITTED,
    FREED,
    FREEING,
    GRANTING,
    PENDING,
    POOL_KV_NS,
    RETURN_FREEING,
    RETURN_GRANTING,
    RETURNED,
    TERMINAL,
    TRANSITIONAL,
    ChipPoolArbiter,
    DictKv,
    InternalKv,
    InvalidLeaseTransition,
    PoolLedger,
    ServeWorkload,
    SloGuard,
    TrainWorkload,
    compute_allocation,
    read_pool_state,
)

_CLUSTER_NAMES = ("Autoscaler", "NodeProvider", "FakeNodeProvider",
                  "request_resources")


def __getattr__(name):
    if name in _CLUSTER_NAMES:
        from ray_tpu_torch.exceptions import not_ported

        raise not_ported(f"ray_tpu_torch.autoscaler.{name} (the cluster "
                         f"autoscaler)", "item 19b")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ChipPoolArbiter", "DictKv", "InternalKv", "InvalidLeaseTransition",
    "PoolLedger", "ServeWorkload", "SloGuard", "TrainWorkload",
    "compute_allocation", "read_pool_state",
    "PENDING", "FREEING", "FREED", "GRANTING", "COMMITTED",
    "RETURN_FREEING", "RETURN_GRANTING", "RETURNED", "ABORTING",
    "ABORTED", "TERMINAL", "TRANSITIONAL", "POOL_KV_NS",
]
