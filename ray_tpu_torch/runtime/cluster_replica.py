"""Processes of a group as actors of the cluster runtime: serve's
replicas (JAX's replicas are actors of its runtime:
``ray_tpu/serve/api.py:1098-1101``, ``:1147-1152``), the trainer's
workers (``ray_tpu/train/backend_executor.py:249-265``) and RLlib's
learners and env runners.

When the process is a driver connected to a cluster
(``ray_tpu_torch.init(address=...)``), each of those groups creates its
members as actors of :class:`~ray_tpu_torch.runtime.replica.Replica`
that the GCS places (:class:`ClusterReplica`), instead of forking
replica processes of its own: the serve controller
(:mod:`ray_tpu_torch.runtime.controller`), the trainer's ``WorkerGroup``
(:mod:`ray_tpu_torch.train.backend_executor`), the learner group and
``start_runner`` (:mod:`ray_tpu_torch.rllib`). The actor asks the cluster
for its ``num_cpus``, ``num_gpus`` and other resources: the node that
hosts it books its cards and sets its ``CUDA_VISIBLE_DEVICES``, and
nothing comes out of the driver's card book. A COMPACT deployment's
replicas go into its PACK placement group, a SPREAD one's take the
``SPREAD`` strategy.

:class:`ClusterReplica` has the interface of
:class:`~ray_tpu_torch.runtime.replica.ReplicaProcess` that the
controller, the handles and the groups use (``call``, ``stream``,
``control``, ``ready``, ``wait_ready``, ``alive``, ``dead``, ``kill``,
``stop``, ``pid``, ``info``, ``replica_id``), so the routing table, the
drains, health, the autoscaler, the trainer's liveness checks and the
learner calls read one interface for both backends. A call is
``handle_request.remote``, a stream ``handle_request_streaming`` as an
``ObjectRefGenerator`` (JAX ``:1734``), a control op the method of the
same name. The objects these leave in the node stores go with their last
reference (the runtime's reference counts): a call's result once its
future resolved, a streamed item once its reader dropped it.

The routing table also lives in the GCS (JAX ``:60-95``): on every change
the controller writes each deployment's replicas (their ids and actor
handles) to the GCS KV and publishes the deployment's name on the
``SERVE_ROUTES`` channel (:func:`publish_routes`). A handle in any
process of the cluster but the serving one (whose handles hear the
controller directly) subscribes on its first use
(:func:`subscribe_routes`, over the runtime's GCS subscription, which
resubscribes after a GCS restart and then marks every table stale) and
re-reads its table on each event. A handle injected into a replica
routes from the replica's own worker over that table
(:class:`GcsRoutes`), not through the serving process.

The chaos plan (:mod:`ray_tpu_torch._private.chaos`) reaches replica
processes over their pipe; a cluster actor has none, so
:meth:`ClusterReplica.push_chaos` sends nothing (ROADMAP.md §C).
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker as _worker

#: The GCS pubsub channel of route events (JAX's ``ROUTES_CHANNEL``).
ROUTES_CHANNEL = "SERVE_ROUTES"
#: The GCS KV namespace and key prefix of the routing tables.
ROUTES_NS = "serve"
ROUTES_PREFIX = "routes/"
#: Actor slots a replica keeps beyond its requests' for the control ops
#: (health, metrics, pressure, drain), so a full replica still answers.
CONTROL_SLOTS = 4


def cluster_core():
    """This process's cluster runtime, or None when it runs the
    in-process runtime or none."""
    from ray_tpu_torch._private.runtime.cluster import ClusterRuntime

    w = _worker.global_worker_or_none()
    core = getattr(w, "core", None)
    return core if isinstance(core, ClusterRuntime) else None


class _ClusterStream:
    """The items of one streamed request as the replica yields them, over
    the call's ``ObjectRefGenerator``: ``next(timeout)`` raises
    ``StopIteration`` at the end, the replica's error, or
    ``ActorDiedError``; :meth:`close` of an unfinished stream cancels the
    replica's task, which closes the user's generator. Each item is a
    node-store object whose one reference is the one read here: it goes
    from the stores when that reference does; the items a stream that
    ended early never read are the generator's to reap
    (``release_stream_tail``)."""

    def __init__(self, owner: "ClusterReplica", gen):
        self._owner = owner
        self._gen = gen
        self._done = False

    def next(self, timeout: Optional[float] = None):
        if self._done:
            raise StopIteration
        core = _worker.global_worker().core
        try:
            ref = self._gen._next_internal(timeout)
            return core.get([ref], timeout)[0]
        except exceptions.GetTimeoutError:
            raise TimeoutError(f"no streamed item from {self._owner.peer} "
                               f"within {timeout} s") from None
        except BaseException:
            self._done = True
            raise

    def close(self) -> None:
        if not self._done:
            try:
                _worker.cancel(self._gen.completed())
            except Exception:  # noqa: BLE001 — the task ended meanwhile
                pass
            self._done = True


def driver_host() -> str:
    """The host of this process as the cluster runtime knows it (its
    node's address), where a group's rendezvous or store is hosted;
    loopback without a cluster."""
    core = cluster_core()
    if core is None:
        return "127.0.0.1"
    return core.node_address.rsplit(":", 1)[0]


class ClusterReplica:
    """One member of a group as an actor the GCS placed (module
    docstring). ``actor`` attaches to a replica another process created
    (a handle's view of the routing table); otherwise the actor is
    created now with ``actor_options`` (``num_cpus``, ``num_gpus``,
    ``resources``, ``max_restarts``; ``max_concurrency`` is
    ``sync_workers`` plus ``control_slots``, the slots a serve replica
    keeps for its control ops and a train worker or runner does not) and
    ``strategy`` (a placement group strategy, ``"SPREAD"`` or None).
    ``num_threads`` sets the actor's torch intra-op threads, as a replica
    process's ``num_threads``."""

    _seq = itertools.count()

    def __init__(self, name: str, cls_or_fn=None, init_args=(),
                 init_kwargs=None, is_function: bool = False,
                 sync_workers: int = 8,
                 actor_options: Optional[Dict[str, Any]] = None,
                 strategy: Any = None, actor=None,
                 replica_id: Optional[str] = None,
                 control_slots: int = CONTROL_SLOTS,
                 num_threads: Optional[int] = None):
        self.name = name
        self.replica_id = replica_id or \
            f"{name}-{_worker.global_worker().core.worker_id[:6]}-" \
            f"{next(self._seq)}"
        self.info: Dict[str, Any] = {}
        self._killed = False
        if actor is None:
            import ray_tpu_torch
            from ray_tpu_torch.runtime.replica import Replica

            opts = dict(actor_options or {})
            options = {"max_concurrency": int(sync_workers)
                       + int(control_slots),
                       "max_restarts": int(opts.get("max_restarts", 0)),
                       "num_cpus": float(opts.get("num_cpus", 1) or 1)}
            if opts.get("num_gpus"):
                options["num_gpus"] = float(opts["num_gpus"])
            if opts.get("resources"):
                options["resources"] = dict(opts["resources"])
            if strategy is not None:
                options["scheduling_strategy"] = strategy
            actor = ray_tpu_torch.remote(Replica).options(**options).remote(
                cls_or_fn, init_args, init_kwargs, is_function,
                sync_workers, num_threads)
            self._ready: Future = self._future(actor.info.remote())
            self._ready.add_done_callback(self._on_ready)
        else:
            self._ready = Future()
            self._ready.set_result({})
        self.actor = actor

    def _on_ready(self, fut: Future) -> None:
        if fut.exception() is None:
            self.info = fut.result()

    # ------------------------------------------------------------ state
    @property
    def pid(self) -> Optional[int]:
        return self.info.get("pid")

    @property
    def peer(self) -> str:
        return f"replica actor {self.replica_id}"

    @property
    def dead(self) -> bool:
        if self._killed:
            return True
        core = cluster_core()
        return core is not None and \
            core.actor_death(self.actor._actor_id) is not None

    @property
    def alive(self) -> bool:
        return not self.dead

    @property
    def ready(self) -> Optional[bool]:
        """True once built, False if it failed to start, None while
        starting."""
        if not self._ready.done():
            return None
        return self._ready.exception() is None

    def wait_ready(self, timeout_s: float) -> Dict[str, Any]:
        """Block until the replica built its class; returns its ``{"pid",
        "node_id", "cuda_visible_devices", "init_s"}``. A replica whose
        constructor raised, or that did not start in time, is killed and
        the error raised: there is no fallback."""
        try:
            return self._ready.result(timeout=timeout_s)
        except TimeoutError:
            self.kill()
            raise TimeoutError(f"replica of {self.name!r} did not start "
                               f"within {timeout_s} s") from None
        except Exception as e:
            self.kill()
            raise RuntimeError(
                f"replica of {self.name!r} failed to start: {e}") from e

    # --------------------------------------------------------- requests
    @staticmethod
    def _future(ref) -> Future:
        """The future of ``ref``'s value (it holds the reference until it
        resolves)."""
        return _worker.global_worker().core.as_future(ref)

    def call(self, method: Optional[str], args, kwargs,
             model_id: str = "", request_ctx=None) -> Future:
        return self._future(self.actor.handle_request.remote(
            method, args, kwargs, model_id, request_ctx))

    def stream(self, method: Optional[str], args, kwargs,
               model_id: str = "", request_ctx=None,
               on_done: Optional[Callable[[], None]] = None):
        """``on_done()`` runs once the replica has ended the stream (its
        end, its error or its death), as JAX's completion callback."""
        gen = self.actor.handle_request_streaming.options(
            num_returns="streaming").remote(method, args, kwargs, model_id,
                                            request_ctx)
        if on_done is not None:
            self._future(gen.completed()).add_done_callback(
                lambda _f: on_done())
        return _ClusterStream(self, gen)

    def control(self, op: str, *args) -> Future:
        from ray_tpu_torch.runtime.replica import CONTROL_OPS

        if op not in CONTROL_OPS:
            fut: Future = Future()
            fut.set_exception(ValueError(f"unknown replica control {op!r}"))
            return fut
        return self._future(getattr(self.actor, op).remote(*args))

    def push_chaos(self, shared) -> None:
        """Nothing: a cluster replica has no pipe for the plan."""

    # ---------------------------------------------------------- lifetime
    def kill(self) -> None:
        """Kill the actor without restart (its node reaps the worker and
        the references it held)."""
        self._killed = True
        try:
            _worker.kill(self.actor, no_restart=True)
        except Exception:  # noqa: BLE001 — the cluster is already gone
            pass

    def stop(self, timeout_s: float = 10.0) -> None:
        """As :meth:`kill`: an actor's worker ends with its actor."""
        self.kill()


# ------------------------------------------------------------ the routes
def publish_routes(name: str, replicas: List[ClusterReplica]) -> None:
    """Write ``name``'s routing table to the GCS KV (``None`` when the
    deployment is gone), then publish a route event for it."""
    from ray_tpu_torch._private import messages as pb
    from ray_tpu_torch._private.serialization import dumps

    core = cluster_core()
    if core is None:
        return
    key = ROUTES_PREFIX + name
    if replicas is None:
        core.gcs.KvDel(pb.KvRequest(ns=ROUTES_NS, key=key))
    else:
        core.gcs.KvPut(pb.KvRequest(
            ns=ROUTES_NS, key=key, overwrite=True,
            value=dumps([(r.replica_id, r.actor) for r in replicas])))
    core.gcs.Publish(pb.PublishRequest(channel=ROUTES_CHANNEL,
                                       data=name.encode()))


def subscribe_routes(callback: Callable[[Optional[str]], None]) -> None:
    """``callback(name)`` on each route event of this process's cluster,
    and ``callback(None)`` after its subscription was restored (a GCS
    restart), when any table may have changed unseen."""
    core = cluster_core()
    if core is None:
        raise RuntimeError("serve routes over the GCS need a cluster "
                           "runtime in this process")
    core.on_channel(ROUTES_CHANNEL, lambda data: callback(
        None if data is None else data.decode()))


class GcsRoutes:
    """The routing tables as a process without the controller sees them:
    read from the GCS KV, with the controller's table interface
    (``get_routes``, ``list_deployments``, ``subscribe``, the loads and
    pressure views, which are empty here, so routing uses this process's
    own in-flight counts). A replica keeps one :class:`ClusterReplica`
    view per replica id, so a table read twice holds the same objects."""

    def __init__(self):
        self._views: Dict[str, ClusterReplica] = {}
        self._lock = threading.Lock()

    def get_routes(self, name: str) -> Tuple[int, List[ClusterReplica]]:
        from ray_tpu_torch._private import messages as pb
        from ray_tpu_torch._private.serialization import loads

        core = cluster_core()
        reply = core.gcs.KvGet(pb.KvRequest(ns=ROUTES_NS,
                                            key=ROUTES_PREFIX + name))
        table = loads(reply.value) if reply.found else []
        with self._lock:
            views = []
            for rid, actor in table:
                view = self._views.get(rid)
                if view is None:
                    view = self._views[rid] = ClusterReplica(
                        name, actor=actor, replica_id=rid)
                views.append(view)
        return 0, [v for v in views if not v.dead]

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        from ray_tpu_torch._private import messages as pb

        keys = cluster_core().gcs.KvKeys(pb.KvRequest(
            ns=ROUTES_NS, prefix=ROUTES_PREFIX)).keys
        return {k[len(ROUTES_PREFIX):]: {} for k in keys}

    def subscribe(self, callback: Callable[[Optional[str]], None]) -> None:
        subscribe_routes(callback)

    def get_replica_loads(self, name: str) -> List[int]:
        return []

    def get_replica_pressure(self, name: str) -> List[Dict[str, Any]]:
        return []
