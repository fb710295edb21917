"""The per-process Worker singleton and the public init/get/put/wait surface
(the port's copy of ``ray_tpu/_private/worker.py``).

Re-design of the reference driver/worker plumbing (reference:
``python/ray/_private/worker.py`` — ``init`` :1275, ``get`` :2636, global
``Worker`` :427). The Worker owns a :class:`CoreRuntime`: the in-process
:class:`LocalRuntime`, or a
:class:`~ray_tpu_torch._private.runtime.cluster.ClusterRuntime` connected
to a cluster (JAX's ``init``, ``ray_tpu/_private/worker.py:51-130``):
``address="host:port"`` connects to that GCS, ``"auto"`` reads
``RAY_TPU_ADDRESS`` and then the port's own address file
(:data:`ADDRESS_FILE`, a name of the port's, so that the two packages
never find each other's head), and ``RAY_TPU_START_CLUSTER=1`` with no
address starts a local cluster (:mod:`ray_tpu_torch.cluster_utils`) and
connects to it. ``"ray://"`` (remote drivers) raises ``not_ported``
naming its ROADMAP.md item. This module's globals are the port's own: a
process may run ``ray_tpu.init()`` and ``ray_tpu_torch.init()`` side by
side, and neither reaches the other's runtime.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime.interface import CoreRuntime

# ROADMAP.md queue A's entries that hold the rest of JAX's cluster runtime.
ITEM_20C = "item 20c (runtime environments and the node agent)"
ITEM_20D = "item 20d (remote drivers, the ray:// client proxy)"

# The port's address file for ``init(address="auto")``: the head node's
# GCS address, one line (JAX's CLI reads its own, scripts/cli.py:104-110).
ADDRESS_FILE = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            "ray_tpu_torch_current_cluster")

_global_lock = threading.Lock()
_global_worker: Optional["Worker"] = None


class Worker:
    def __init__(self, core: CoreRuntime, mode: str, namespace: str = "default"):
        self.core = core
        self.mode = mode  # "local" | "driver" | "worker"
        self.namespace = namespace
        self.session_name = f"session_{os.getpid()}"


def global_worker() -> Worker:
    w = _global_worker
    if w is None:
        # Auto-init like the reference does on first API use.
        init()
        w = _global_worker
        assert w is not None
    return w


def global_worker_or_none() -> Optional[Worker]:
    return _global_worker


def is_initialized() -> bool:
    return _global_worker is not None


def _auto_address() -> str:
    """``RAY_TPU_ADDRESS``, else the port's address file; a
    ``ConnectionError`` when neither names a cluster."""
    env = os.environ.get("RAY_TPU_ADDRESS", "")
    if env and env != "auto":
        return env
    try:
        with open(ADDRESS_FILE) as f:
            found = f.read().strip()
    except OSError:
        found = ""
    if not found:
        raise ConnectionError(
            "address='auto' found no running cluster: start a head node "
            "or set RAY_TPU_ADDRESS")
    return found


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    num_tpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    _system_config: Optional[Dict[str, Any]] = None,
    **kwargs,
):
    """Start the in-process runtime, or connect to a cluster.

    ``address=None`` starts the in-process runtime (or, with
    ``RAY_TPU_START_CLUSTER=1``, a local cluster of one node with
    ``num_cpus`` and ``num_gpus``, which :func:`shutdown` stops);
    ``address="host:port"`` connects to that cluster's GCS;
    ``address="auto"`` finds one (:func:`_auto_address`). ``num_gpus=None``
    counts the visible cards
    (:mod:`~ray_tpu_torch._private.accelerators.cuda`), as JAX's
    ``num_tpus=None`` counts the visible chips; ``num_tpus`` raises a
    ``ValueError``.
    """
    global _global_worker
    with _global_lock:
        if _global_worker is not None:
            if ignore_reinit_error:
                return RuntimeContextInfo(_global_worker)
            raise RuntimeError(
                "ray_tpu_torch.init() has already been called. "
                "Pass ignore_reinit_error=True to ignore.")

        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        GLOBAL_CONFIG.initialize(_system_config)

        if address is None and os.environ.get("RAY_TPU_ADDRESS"):
            address = os.environ["RAY_TPU_ADDRESS"]
        if address is not None and address.startswith("ray://"):
            from ray_tpu_torch.exceptions import not_ported

            raise not_ported(f"init(address={address!r})", ITEM_20D)
        if address == "auto":
            address = _auto_address()
        if num_tpus is not None:
            raise ValueError(
                "init(num_tpus=...): the port's accelerator is the CUDA "
                "card; pass num_gpus")
        if num_cpus is None:
            num_cpus = os.cpu_count() or 1
        if num_gpus is None:
            from ray_tpu_torch._private.accelerators.cuda import \
                detect_num_cards

            num_gpus = detect_num_cards()
        cluster = None
        if address is None and \
                os.environ.get("RAY_TPU_START_CLUSTER") == "1":
            from ray_tpu_torch.cluster_utils import Cluster

            cluster = Cluster(head_node_args={
                "num_cpus": num_cpus, "num_gpus": num_gpus,
                "resources": resources})
            address = cluster.address
        if address is None:
            from ray_tpu_torch._private.runtime.local import LocalRuntime

            core: CoreRuntime = LocalRuntime(
                num_cpus=num_cpus, num_gpus=num_gpus, resources=resources)
            mode = "local"
        else:
            from ray_tpu_torch._private.runtime.cluster import \
                ClusterRuntime

            try:
                core = ClusterRuntime.connect(
                    address, namespace=namespace or "default")
            except BaseException:
                if cluster is not None:
                    cluster.shutdown()
                raise
            core.started_cluster = cluster
            mode = "driver"

        _global_worker = Worker(core, mode, namespace or "default")
        atexit.register(shutdown)
        return RuntimeContextInfo(_global_worker)


class RuntimeContextInfo:
    """Value returned by init(); mirrors the reference's ClientContext dict-ish."""

    def __init__(self, worker: Worker):
        self.worker = worker
        self.address_info = {"node_id": getattr(worker.core, "node_id", None)}

    def __getitem__(self, k):
        return self.address_info[k]

    def disconnect(self):
        shutdown()


def shutdown():
    global _global_worker
    with _global_lock:
        w = _global_worker
        if w is None:
            return
        _global_worker = None
    try:
        w.core.shutdown()
    except Exception:  # noqa: BLE001 — shutdown is best-effort, as in JAX
        pass
    cluster = getattr(w.core, "started_cluster", None)
    if cluster is not None:  # RAY_TPU_START_CLUSTER=1 started it
        cluster.shutdown()


# ---------------------------------------------------------------- public ops
def put(value: Any, *, _owner=None) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed.")
    return global_worker().core.put(value, _owner)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *,
        timeout: Optional[float] = None):
    from ray_tpu_torch.dag import CompiledDAGRef

    if isinstance(refs, CompiledDAGRef):
        # Compiled-DAG results live in channels, not the object store
        # (reference: ray.get on a CompiledDAGRef).
        return refs.get(timeout=timeout)
    is_single = isinstance(refs, ObjectRef)
    if is_single:
        refs = [refs]
    refs = list(refs)
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(
                f"get() expects ObjectRef or list of ObjectRefs, got {type(r)}")
    values = global_worker().core.get(refs, timeout)
    return values[0] if is_single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs.")
    refs = list(refs)
    if len(set(refs)) != len(refs):
        raise ValueError("wait() expects a list of unique ObjectRefs.")
    if num_returns > len(refs):
        raise ValueError(
            f"num_returns ({num_returns}) exceeds number of refs ({len(refs)})")
    if num_returns <= 0:
        raise ValueError("num_returns must be > 0")
    return global_worker().core.wait(refs, num_returns, timeout, fetch_local)


def kill(actor, *, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle.")
    global_worker().core.kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    from ray_tpu_torch._private.object_ref import ObjectRefGenerator

    if isinstance(ref, ObjectRefGenerator):
        # Cancelling a streaming generator cancels its producing task; the
        # consumer surfaces the stored TaskCancelledError past the last
        # produced item (reference: cancel accepts the stream handle).
        ref = ref._length_ref
    if not isinstance(ref, ObjectRef):
        raise TypeError("cancel() expects an ObjectRef.")
    global_worker().core.cancel(ref, force, recursive)


def get_actor(name: str, namespace: Optional[str] = None):
    from ray_tpu_torch.actor import ActorHandle

    actor_id, cls, options = global_worker().core.get_named_actor(name, namespace)
    return ActorHandle._from_actor_id(actor_id, cls, options)


def list_named_actors(all_namespaces: bool = False):
    return global_worker().core.list_named_actors(all_namespaces)


def nodes() -> List[Dict[str, Any]]:
    return global_worker().core.nodes()


def cluster_resources() -> Dict[str, float]:
    return global_worker().core.cluster_resources()


def available_resources() -> Dict[str, float]:
    return global_worker().core.available_resources()
