"""The serve controller of the port's runtime: the part of
``ServeController`` (``ray_tpu/serve/api.py:366-1207``) that a colocated
deployment needs, as an object in the serving process.

It holds the deployment specs and their replica processes
(:class:`~ray_tpu_torch.runtime.replica.ReplicaProcess`), serves the
routing table to handles (a version per deployment and a callback on
every change, where JAX publishes a route event), and reconciles on a
thread of its own every ``RECONCILE_S``:

* a replica whose process died, or that did not answer a health probe
  within ``HEALTH_TIMEOUT_S``, leaves the routing table and is replaced
  (killed first if it still runs);
* a drain (:meth:`ServeController.drain_replicas`) takes replicas out of
  rotation at once, waits for their in-flight requests up to their
  deadline, retires them and starts their replacements.

A replica that asks for GPUs (``ray_actor_options={"num_gpus": n}``)
gets its cards through ``CUDA_VISIBLE_DEVICES``, the counterpart of
``ray_tpu/_private/node_manager/server.py:1037``: ``n`` cards of its own
for a whole ``n``, or a share of one card for a fraction below 1, as Ray
takes ``num_gpus`` (replicas whose fractions sum to at most 1 share a
card, packed first-fit onto the cards already shared). The shares come
from :data:`CARDS`, the process's one book of card shares, which a
``use_gpu`` trainer's workers take theirs from too (JAX counts replicas
and train workers against one runtime's ``TPU`` resource); a share goes
back only once its process has exited. A deployment that does not fit
the host's cards raises, and a replacement waits for its share to free.

A deployment's ``placement_strategy`` is JAX's (``serve/api.py:419-463``,
``:967-1032``, ``:1071-1100``): ``"COMPACT"`` gangs its replicas into one
PACK placement group of :mod:`ray_tpu_torch.util.placement_group`, a
bundle a replica holding the replica's CPU and card request; a redeploy
of the same shape keeps the group, a change of strategy or of resources
removes it and takes a new one, and :meth:`ServeController.delete`
removes it. ``"SPREAD"`` spreads the replicas. Any other value is kept
and changes nothing, as in JAX. The host is one node (its id, which the
local runtime reports too, reaches each replica in ``RAY_TPU_NODE_ID``),
so the strategies differ only on the cards: a fractional replica packs
onto a card already shared unless its deployment is SPREAD, which puts
it on the least used card.

On a cluster (the serving process is a driver of
``ray_tpu_torch.init(address=...)``) the replicas are cluster actors the
GCS places (:mod:`ray_tpu_torch.runtime.cluster_replica`, JAX
``serve/api.py:1098-1101``, ``:1147-1152``): the controller takes no
card share for them (the node hosting a replica books its card), a
COMPACT deployment's replicas go into its PACK group and a SPREAD one's
take the ``SPREAD`` strategy, and every routing change is written to the
GCS and published as a route event, which handles in any process of the
cluster read. The controller itself stays an object of the serving
process (ROADMAP.md §C).

A preemption notice (:mod:`ray_tpu_torch.checkpoint.preempt`; JAX
``serve/api.py:396-411``, ``:710-770``) drains the replicas on the node
it names: every replica for ``node`` ``*``, ``""`` or ``all``, else those
whose node id starts with it (each replica is asked its node id outside
the controller's lock, within 2 s). Each goes through the drain path
with ``cause="preemption"`` and the notice's id as the drain's cause
event, and reconcile starts its replacement.

The controller also carries the chaos plan (:mod:`ray_tpu_torch._private.chaos`)
to its replica processes: it pushes the plan and the firings spent so far
to every replica when either changes, and to every replica it spawns.

It records the serve failure plane as JAX's does: a drain's
``serve.drain_begin`` and ``serve.drain_end`` flight events,
``SERVE_REPLICA_DRAINS`` and ``SERVE_DRAIN_SECONDS``, and each death it
observes in ``SERVE_REPLICA_DEATHS`` (``cause="died"``, or ``"drain"``
for a replica that died draining). :meth:`ServeController.metrics_text`
is the ``GET /metrics`` body: this process's registry with each live
replica's samples, labelled ``replica="<replica_id>"``.

The autoscaler (JAX ``serve/api.py:100-120``, ``:416-426``,
``:480-605``, ``:793-823``): a deployment deployed with an
``autoscaling_config`` (or ``num_replicas="auto"``) starts at
``min_replicas``, and each reconcile pass sets its replica target from
the replicas' pressure (:meth:`ServeController._pressure_desired`: the
ongoing count, the engines' queue depth, KV starvation, prefill tokens,
the importable floor and ingress sheds), clamped to ``[min, max]`` and
the chip-pool arbiter's cap, once the change has held for the up or down
delay. Each decision counts ``SERVE_AUTOSCALE_DECISIONS`` and emits
``serve.autoscale``. Scale-down always goes through the drain path: a
replica still starting is retired first, then the victims leave the
routing table and drain (``cause="scale_down"``, the decision as their
cause event). :meth:`ServeController.pool_set_replicas` and
:meth:`ServeController.pool_state` are the arbiter's surface
(:mod:`ray_tpu_torch.autoscaler.arbiter`).

The controller's KV (``kv``: None for a dict of its own, a dict, or a
``torch.distributed`` store such as ``TCPStore``/``FileStore``, as the
checkpoint plane's :class:`~ray_tpu_torch.checkpoint.plane.StoreKV`)
holds ``deployments``: each deployment's replica count, pids and cards,
rewritten on every routing change, and ``role_groups`` (the
disaggregated pairs), so another process can read the serve state.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from concurrent.futures import wait as wait_futures
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.checkpoint import preempt as _preempt
from ray_tpu_torch.checkpoint.plane import StoreKV, as_kv
from ray_tpu_torch.runtime.cluster_replica import (ClusterReplica,
                                                   cluster_core,
                                                   publish_routes)
from ray_tpu_torch.runtime.replica import ReplicaProcess
from ray_tpu_torch.util import metrics as _metrics

logger = logging.getLogger(__name__)

SERVE_KV_NS = "__serve__"


def _visible_gpus() -> List[str]:
    """The cards this process may hand out, by the ids its own
    ``CUDA_VISIBLE_DEVICES`` names (all of them when it is unset)."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [d.strip() for d in env.split(",") if d.strip()]
    return [str(i) for i in range(torch.cuda.device_count())]


# A card's shares may sum to 1 within this slack (0.1 + 0.2 + 0.7).
_SHARE_EPS = 1e-9


def _gpus_per_replica(actor_options: Dict[str, Any]) -> float:
    """A replica's ``num_gpus``: 0, a fraction of one card below 1, or a
    whole number of cards."""
    n = float(actor_options.get("num_gpus") or 0)
    if n < 0 or (n >= 1 and n != int(n)):
        raise ValueError(f"num_gpus={n}: a replica takes a fraction of "
                         f"one GPU below 1, or whole GPUs")
    return int(n) if n >= 1 else n


def _place(use: Dict[str, float], cards: List[str],
           gpus: float, spread: bool = False) -> Optional[List[str]]:
    """The cards a replica asking ``gpus`` takes given each card's used
    share (``use`` is updated), or None when they are not free. A
    fraction goes to the first card it fits, shared cards first, or with
    ``spread`` the least used card first."""
    if gpus >= 1:
        free = [c for c in cards if use.get(c, 0.0) <= _SHARE_EPS]
        if len(free) < gpus:
            return None
        taken = free[:int(gpus)]
        for c in taken:
            use[c] = 1.0
        return taken
    if spread:
        order = sorted(cards, key=lambda c: use.get(c, 0.0))
    else:
        order = sorted(cards, key=lambda c: use.get(c, 0.0) <= _SHARE_EPS)
    for c in order:
        if use.get(c, 0.0) + gpus <= 1.0 + _SHARE_EPS:
            use[c] = use.get(c, 0.0) + gpus
            return [c]
    return None


class CardBook:
    """The host's card shares, one book for the serving process: each
    card's share in use by serve replicas and ``use_gpu`` train workers
    (``runtime/controller.py`` and ``train/backend_executor.py`` take and
    give through :data:`CARDS`), and the cards a cluster node built in
    the process owns (``node_manager/server.py`` claims them). Cards are the ones :func:`_visible_gpus`
    names when a share is taken."""

    def __init__(self):
        self._cond = threading.Condition()
        self._use: Dict[str, float] = {}   # card -> share in use

    def use(self) -> Dict[str, float]:
        with self._cond:
            return dict(self._use)

    def take(self, gpus: float, count: int = 1, spread: bool = False,
             timeout_s: float = 0.0) -> Optional[List[List[str]]]:
        """The cards of ``count`` holders of ``gpus`` each (:func:`_place`),
        all taken or none; waits up to ``timeout_s`` for shares given
        back, then None."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                use, cards = dict(self._use), _visible_gpus()
                got = []
                for _ in range(count):
                    placed = _place(use, cards, gpus, spread)
                    if placed is None:
                        break
                    got.append(placed)
                if len(got) == count:
                    self._use = use
                    return got
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cond.wait(left)

    def claim(self, cards: List[str]) -> bool:
        """Take the whole of each of ``cards`` (a cluster node's, for its
        lifetime), all or none: False when any share of one is in use."""
        with self._cond:
            if any(self._use.get(c, 0.0) > _SHARE_EPS for c in cards):
                return False
            for c in cards:
                self._use[c] = 1.0
            return True

    def give(self, cards: List[str], share: float) -> None:
        """Return ``share`` of each of ``cards`` (its holder has exited)."""
        with self._cond:
            for c in cards:
                self._use[c] = max(self._use.get(c, 0.0) - share, 0.0)
            self._cond.notify_all()

    def free_cards(self) -> int:
        """Cards no share of which is in use."""
        with self._cond:
            return sum(1 for c in _visible_gpus()
                       if self._use.get(c, 0.0) <= _SHARE_EPS)


#: The serving process's one card book.
CARDS = CardBook()

DEFAULT_AUTOSCALING = {
    "min_replicas": 1,
    "max_replicas": 4,
    "target_ongoing_requests": 2.0,
    "upscale_delay_s": 0.3,
    "downscale_delay_s": 2.0,
    # Engine pressure: desired replicas also scale on the admission-queue
    # depth per replica, on paged-KV arena starvation (every engine
    # replica with no free or reclaimable block) and on ingress sheds
    # since the last decision. 0 disables a signal.
    "target_queue_depth": 4.0,
    "kv_starvation_upscale": True,
    "shed_upscale": True,
    # The split's roles (off by default): prefill fleets scale on waiting
    # prompt tokens per replica; decode fleets add a replica when every
    # engine's importable-block headroom drops under the floor.
    "target_prefill_queue_tokens": 0.0,
    "importable_floor": 0.0,
}


def _replica_bundle(actor_options: Dict[str, Any]) -> Dict[str, float]:
    """One replica's whole resource request, a COMPACT group's bundle."""
    opts = actor_options or {}
    bundle: Dict[str, float] = {"CPU": float(opts.get("num_cpus", 1) or 1)}
    if opts.get("num_gpus"):
        bundle["GPU"] = float(opts["num_gpus"])
    if opts.get("memory"):
        bundle["memory"] = float(opts["memory"])
    for k, v in (opts.get("resources") or {}).items():
        bundle[k] = float(v)
    return bundle


def _host_node_id() -> str:
    """This host's node id: the local runtime's when it runs, else one
    minted now and kept in ``RAY_TPU_NODE_ID``, which a runtime started
    later in this process, and every replica process, takes."""
    w = _worker.global_worker_or_none()
    if w is not None:
        return w.core.node_id.hex()
    return os.environ.setdefault("RAY_TPU_NODE_ID",
                                 NodeID.from_random().hex())


class ServeController:
    """Reconciles deployment specs into replica processes."""

    REPLICA_START_S = 600.0         # spawn, CUDA, the model's weights
    GROUP_WAIT_S = 30.0             # a COMPACT group's placement
    PREEMPT_PROBE_S = 2.0           # the replicas' node-id answers
    RECONCILE_S = 0.5
    HEALTH_TIMEOUT_S = 30.0
    DRAIN_GRACE_S = 2.0            # slack past the replica's own deadline
    LOADS_TTL_S = 0.4
    PRESSURE_TTL_S = 0.5

    def __init__(self, kv=None):
        if isinstance(kv, dist.Store):
            kv = StoreKV(kv, SERVE_KV_NS)
        self.kv = as_kv({} if kv is None else kv)
        self.deployments: Dict[str, Dict[str, Any]] = {}
        self.replicas: Dict[str, List[ReplicaProcess]] = {}
        # Replacements still starting, off the routing table until ready.
        self._starting: Dict[str, List[ReplicaProcess]] = {}
        # Draining replicas: name -> [{replica, future, t0, deadline,
        # cause}], out of the routing table but not yet retired.
        self._draining: Dict[str, List[Dict[str, Any]]] = {}
        self._route_version: Dict[str, int] = {}
        self._loads_cache: Dict[str, Any] = {}
        self._pressure_cache: Dict[str, Any] = {}
        self._probes: Dict[int, Any] = {}       # id(replica) -> (t0, future)
        # id(replica) -> (its cards, its share of each), booked in CARDS
        self._gpu_held: Dict[int, Tuple[List[str], float]] = {}
        self._listeners: List[Callable[[str], None]] = []
        # Logical name -> {"prefill": name, "decode": name}.
        self._role_groups: Dict[str, Dict[str, str]] = {}
        # A COMPACT deployment's placement group, by deployment name.
        self._groups: Dict[str, Any] = {}
        # The autoscaler's pending intent (desired, since) and the sheds
        # its last decision saw, by deployment name.
        self._scale_intent: Dict[str, Tuple[int, float]] = {}
        self._shed_seen: Dict[str, float] = {}
        self.node_id = _host_node_id()
        self._lock = threading.RLock()
        self._stop = threading.Event()
        chaos.subscribe(self._push_chaos)
        self._preempt_cb = _preempt.register_preempt_callback(
            self._on_preempt)
        _preempt.ensure_listener()
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True, name="serve-controller")
        self._thread.start()

    # ------------------------------------------------------------- deploy
    def deploy(self, name: str, cls_or_fn, init_args, init_kwargs,
               num_replicas, is_function: bool,
               max_concurrency: int = 100,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               placement_strategy: Optional[str] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None) -> bool:
        """Start ``num_replicas`` replica processes of ``cls_or_fn`` and
        route to them once every one is built; a redeploy of ``name``
        replaces its replicas. With ``autoscaling_config`` (over
        :data:`DEFAULT_AUTOSCALING`) or ``num_replicas="auto"`` the
        deployment starts at ``min_replicas`` and the autoscaler moves
        it. A replica that fails to start fails the deploy (its error
        raised, the others stopped): nothing falls back to serving in
        this process. A COMPACT deployment's placement group is placed
        before its replicas start (a ``ValueError``, with the deployment
        gone, when the host cannot hold it)."""
        opts = dict(ray_actor_options or {})
        autoscaling = None
        if autoscaling_config is not None or num_replicas == "auto":
            autoscaling = {**DEFAULT_AUTOSCALING,
                           **(autoscaling_config or {})}
            num_replicas = autoscaling["min_replicas"]
        spec = {"cls": cls_or_fn, "args": init_args, "kwargs": init_kwargs,
                "num_replicas": int(num_replicas),
                "is_function": is_function,
                "max_concurrency": max_concurrency, "actor_options": opts,
                "gpus": _gpus_per_replica(opts), "retry_at": 0.0,
                "placement": placement_strategy,
                "autoscaling": autoscaling, "pool_cap": None}
        on_cluster = cluster_core() is not None
        with self._lock:
            # The shares a redeploy frees count as free: the running
            # deployment goes only once the new spec is known to fit. On a
            # cluster the GCS places the replicas' cards.
            use = CARDS.use()
            for r in self._replicas_of(name):
                cards, share = self._gpu_held.get(id(r), ([], 0.0))
                for c in cards:
                    use[c] -= share
            busy = sum(use.values())
            if spec["gpus"] and not on_cluster and any(
                    _place(use, _visible_gpus(), spec["gpus"]) is None
                    for _ in range(spec["num_replicas"])):
                raise ValueError(
                    f"deployment {name!r} asks for {spec['num_replicas']} "
                    f"replicas x {spec['gpus']} GPU(s); this host has "
                    f"{len(_visible_gpus())}, {busy:g} of them in use")
        # The running replicas go first, and with them a group whose shape
        # changed: on one host the new group may need its reservation.
        with self._lock:
            group = self._groups.get(name)
        if placement_strategy != "COMPACT" or group is None or \
                group.bundle_specs != self._bundles(spec):
            group = None
        self.delete(name, keep_group=group)
        if placement_strategy == "COMPACT" and group is None:
            group = self._place_group(name, spec)
        with self._lock:
            started = [self._start_replica(name, spec, group)
                       for _ in range(spec["num_replicas"])]
        try:
            if None in started:
                # A trainer took the shares since the check above.
                raise ValueError(
                    f"deployment {name!r}: {spec['num_replicas']} replicas "
                    f"x {spec['gpus']} GPU(s) no longer fit this host's "
                    f"cards")
            for r in started:
                r.wait_ready(self.REPLICA_START_S)
        except Exception:
            started = [r for r in started if r is not None]
            for r in started:
                self._retire(r, kill=True)
            if group is not None:
                self._remove_group(group)
            raise
        with self._lock:
            self.deployments[name] = spec
            self.replicas[name] = started
            if group is not None:
                self._groups[name] = group
            self._routes_changed(name)
        return True

    @staticmethod
    def _bundles(spec) -> List[Dict[str, float]]:
        return [_replica_bundle(spec["actor_options"])] * spec["num_replicas"]

    def _place_group(self, name: str, spec):
        """A new PACK placement group for a COMPACT deployment's replicas,
        one bundle a replica, placed before this returns."""
        from ray_tpu_torch.util.placement_group import placement_group

        bundles = self._bundles(spec)
        group = placement_group(bundles, strategy="PACK",
                                name=f"serve:{name}")
        if not group.wait(self.GROUP_WAIT_S):
            self._remove_group(group)
            raise ValueError(
                f"deployment {name!r}: the COMPACT placement group of "
                f"{spec['num_replicas']} x {bundles[0]} cannot be placed on "
                f"this host (it has {_worker.cluster_resources()})")
        return group

    @staticmethod
    def _remove_group(group) -> None:
        from ray_tpu_torch.util.placement_group import remove_placement_group

        try:
            remove_placement_group(group)
        except Exception:  # noqa: BLE001 — the runtime already went
            logger.exception("serve: removing a placement group failed")

    def _start_replica(self, name: str, spec, group=None):
        """Start one replica: a cluster actor on a cluster (in ``group``
        for a COMPACT deployment), else a replica process (None when its
        share of cards is not free yet), which gets the chaos plan before
        its first request."""
        if cluster_core() is not None:
            strategy = None
            if spec["placement"] == "COMPACT" and group is not None:
                from ray_tpu_torch.util.scheduling_strategies import \
                    PlacementGroupSchedulingStrategy

                strategy = PlacementGroupSchedulingStrategy(
                    placement_group=group, placement_group_bundle_index=-1)
            elif spec["placement"] == "SPREAD":
                strategy = "SPREAD"
            return ClusterReplica(
                name, spec["cls"], spec["args"], spec["kwargs"],
                spec["is_function"], sync_workers=spec["max_concurrency"],
                actor_options=spec["actor_options"], strategy=strategy)
        env = {"RAY_TPU_NODE_ID": self.node_id}
        cards: List[str] = []
        share = 1.0 if spec["gpus"] >= 1 else spec["gpus"]
        if spec["gpus"]:
            got = CARDS.take(spec["gpus"],
                             spread=spec["placement"] == "SPREAD")
            if got is None:
                return None
            cards = got[0]
            env["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
        try:
            replica = ReplicaProcess(
                name, spec["cls"], spec["args"], spec["kwargs"],
                spec["is_function"], sync_workers=spec["max_concurrency"],
                env=env, num_threads=int(
                    spec["actor_options"].get("num_cpus", 1) or 1))
        except BaseException:
            CARDS.give(cards, share)
            raise
        replica.push_chaos(chaos.state())
        if cards:
            self._gpu_held[id(replica)] = (cards, share)
        return replica

    def _retire(self, replica: ReplicaProcess, kill: bool = False) -> None:
        """Stop a replica (SIGKILL with ``kill``), wait for its process to
        exit, then give its cards back to the book."""
        if kill:
            replica.kill()
        else:
            replica.stop()
        with self._lock:
            self._probes.pop(id(replica), None)
            cards, share = self._gpu_held.pop(id(replica), ([], 0.0))
        CARDS.give(cards, share)

    def _push_chaos(self) -> None:
        """The chaos plan or its firings changed: every replica process
        gets the new state."""
        shared = chaos.state()
        with self._lock:
            replicas = [r for name in set(self.deployments) | set(
                self._starting) | set(self._draining)
                for r in self._replicas_of(name)]
        for r in replicas:
            r.push_chaos(shared)

    def _replicas_of(self, name: str) -> List[ReplicaProcess]:
        """Every replica process of ``name``: routed, starting, draining."""
        return (self.replicas.get(name, []) + self._starting.get(name, [])
                + [e["replica"] for e in self._draining.get(name, [])])

    def delete(self, name: str, keep_group=None) -> bool:
        """Stop every replica of ``name`` and remove its placement group
        (unless it is ``keep_group``, which a redeploy reuses)."""
        with self._lock:
            doomed = self._replicas_of(name)
            spec = self.deployments.pop(name, None)
            for table in (self.replicas, self._starting, self._draining):
                table.pop(name, None)
            group = self._groups.pop(name, None)
            if spec is not None:
                self._routes_changed(name)
        for r in doomed:
            self._retire(r, kill=True)
        if group is not None and group is not keep_group:
            self._remove_group(group)
        return spec is not None

    def shutdown(self) -> None:
        chaos.unsubscribe(self._push_chaos)
        _preempt.unregister_preempt_callback(self._preempt_cb)
        self._stop.set()
        self._thread.join(timeout=10)
        for name in list(self.deployments):
            self.delete(name)

    # -------------------------------------------------------- role groups
    def set_role_group(self, name: str, group: Dict[str, str]) -> None:
        with self._lock:
            self._role_groups[name] = dict(group)
            self._write_role_groups()

    def get_role_group(self, name: str) -> Optional[Dict[str, str]]:
        with self._lock:
            group = self._role_groups.get(name)
            return dict(group) if group else None

    def delete_role_group(self, name: str) -> bool:
        with self._lock:
            found = self._role_groups.pop(name, None) is not None
            self._write_role_groups()
            return found

    def _write_role_groups(self) -> None:
        self.kv.put("role_groups", json.dumps(self._role_groups).encode())

    # ------------------------------------------------------------- routes
    def subscribe(self, callback: Callable[[str], None]) -> None:
        """``callback(name)`` runs whenever ``name``'s routing table
        changes (JAX's route-change event)."""
        with self._lock:
            self._listeners.append(callback)

    def _routes_changed(self, name: str) -> None:
        """A new routing table version: the loads and pressure caches are
        aligned with the old table, so they go; listeners hear of it and
        the KV's record is rewritten."""
        self._loads_cache.pop(name, None)
        self._pressure_cache.pop(name, None)
        self._route_version[name] = self._route_version.get(name, 0) + 1
        if cluster_core() is not None:
            try:
                publish_routes(name, self.replicas.get(name)
                               if name in self.deployments else None)
            except Exception:  # noqa: BLE001 — the GCS restarting
                logger.exception("serve: publishing %s's routes failed",
                                 name)
        for cb in list(self._listeners):
            try:
                cb(name)
            except Exception:  # noqa: BLE001 — one bad listener only
                logger.exception("route listener failed")
        record = {n: {"num_replicas": s["num_replicas"],
                      "placement": s["placement"],
                      "placement_group": (self._groups[n].id.hex()
                                          if n in self._groups else None),
                      "replicas": [{"pid": r.pid,
                                    "cards": self._gpu_held.get(
                                        id(r), ([], 0.0))[0]}
                                   for r in self.replicas.get(n, [])]}
                  for n, s in self.deployments.items()}
        self.kv.put("deployments", json.dumps(record).encode())

    def get_replicas(self, name: str) -> List[ReplicaProcess]:
        with self._lock:
            return list(self.replicas.get(name, []))

    def get_routes(self, name: str):
        """(version, replicas): the versioned routing table, without the
        replicas already seen dead (reconcile replaces them)."""
        with self._lock:
            return (self._route_version.get(name, 0),
                    [r for r in self.replicas.get(name, []) if not r.dead])

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: {"num_replicas": spec["num_replicas"]}
                    for name, spec in self.deployments.items()}

    def replica_records(self) -> List[Dict[str, Any]]:
        """Every replica process, routed, starting or draining, with the
        keys of the state API's ``list_actors`` (the replica's id in
        place of an actor id; ``state`` ALIVE, STARTING or DRAINING)."""
        rows = []
        with self._lock:
            for name in set(self.deployments) | set(self._starting) | \
                    set(self._draining):
                spec = self.deployments.get(name) or {}
                cls = spec.get("cls")
                states = ([(r, "ALIVE") for r in self.replicas.get(name, [])]
                          + [(r, "STARTING")
                             for r in self._starting.get(name, [])]
                          + [(e["replica"], "DRAINING")
                             for e in self._draining.get(name, [])])
                for r, state in states:
                    rows.append({
                        "actor_id": r.replica_id,
                        "class_name": getattr(cls, "__name__", name),
                        "state": state if r.alive else "DEAD",
                        "name": r.replica_id, "namespace": "serve",
                        "node_id": r.info.get("node_id") or self.node_id,
                        "num_restarts": 0,
                        "death_cause": ""})
        return rows

    def _fan_out(self, name: str, op: str, cache: Dict[str, Any],
                 ttl: float, missing, read):
        """One control call to every routed replica under one shared
        1-second deadline (a dying replica must not stall the others),
        aligned with ``get_routes`` order and TTL-cached."""
        now = time.monotonic()
        cached = cache.get(name)
        if cached is not None and now - cached[0] < ttl:
            return cached[1]
        replicas = self.get_replicas(name)
        futs = [r.control(op) for r in replicas]
        wait_futures(futs, timeout=1.0)
        out = [missing(i) for i in range(len(futs))]
        for i, f in enumerate(futs):
            if f.done() and f.exception() is None:
                out[i] = read(i, f.result())
        cache[name] = (now, out)
        return out

    def get_replica_loads(self, name: str) -> List[int]:
        """Per-replica ongoing-request counts (a silent replica reads as
        loaded, so the router avoids it)."""
        return self._fan_out(name, "metrics", self._loads_cache,
                             self.LOADS_TTL_S, lambda i: 1 << 20,
                             lambda i, m: m["ongoing"])

    def get_replica_pressure(self, name: str) -> List[Dict[str, Any]]:
        """Per-replica pressure snapshots (the prefix-affinity router and
        the ingress admission gate read these)."""
        return self._fan_out(
            name, "pressure", self._pressure_cache, self.PRESSURE_TTL_S,
            lambda i: {"replica": i, "unreachable": True},
            lambda i, snap: {"replica": i, **(snap or {})})

    # ------------------------------------------------------------ metrics
    def metrics_text(self, timeout_s: float = 2.0) -> str:
        """The ``GET /metrics`` body: this process's registry rendered
        as ``prometheus_text`` renders it, each metric family followed
        by every live replica's samples of it (``collect_samples``:
        counters and gauges, a histogram's ``_count`` and ``_sum``),
        each labelled ``replica="<replica_id>"``; families only replicas
        have come last, untyped. Replicas that do not answer within
        ``timeout_s`` are left out.

        The rule for a respawn: only live replicas are asked, and a
        replica id names one process, never reused. A dead replica's
        samples leave the text with it and its replacement's series
        start at zero under a new label, so nothing is counted twice
        and no series seems to reset."""
        with self._lock:
            replicas = [r for name in set(self.deployments) | set(
                self._draining) for r in self._replicas_of(name)
                if r.alive and r.ready]
        futs = [(r, r.control("samples")) for r in replicas]
        wait_futures([f for _, f in futs], timeout=timeout_s)
        extra: Dict[str, List[str]] = {}
        for r, f in futs:
            if not f.done() or f.exception() is not None:
                continue
            label = (("replica", r.replica_id),)
            for sname, key, value in f.result():
                labels = ",".join(f'{k}="{v}"'
                                  for k, v in tuple(key) + label)
                extra.setdefault(sname, []).append(
                    f"{sname}{{{labels}}} {value}")
        lines: List[str] = []
        for m in _metrics.all_metrics():
            lines.extend(m.render())
            names = ([m.name + "_count", m.name + "_sum"]
                     if isinstance(m, _metrics.Histogram) else [m.name])
            for n in names:
                lines.extend(extra.pop(n, ()))
        for sname, rows in extra.items():
            lines.append(f"# TYPE {sname} untyped")
            lines.extend(rows)
        return "\n".join(lines) + "\n"

    # -------------------------------------------------------------- drain
    def drain_replicas(self, name: str, count: int = 1,
                       cause: str = "operator") -> int:
        """Drain ``count`` replicas of ``name`` out of rotation without
        shrinking the spec: each stops admitting, finishes its in-flight
        requests up to ``RAY_TPU_SERVE_DRAIN_S`` and is retired, and
        reconcile starts its replacement (a rolling replace). Returns how
        many drains started."""
        started = 0
        with self._lock:
            current = list(self.replicas.get(name, []))
            while current and started < count:
                self._begin_drain(name, current.pop(), cause)
                started += 1
            if started:
                self.replicas[name] = current
                self._routes_changed(name)
        return started

    def _begin_drain(self, name: str, victim: ReplicaProcess, cause: str,
                     cause_event: str = "") -> None:
        """Ask ``victim`` to drain and track it until it is retired (the
        caller holds the lock and takes it off the routing table)."""
        deadline_s = float(os.environ.get("RAY_TPU_SERVE_DRAIN_S", "30"))
        now = time.monotonic()
        self._draining.setdefault(name, []).append({
            "replica": victim, "cause": cause, "t0": now,
            "deadline": now + deadline_s,
            "future": victim.control("drain", deadline_s),
            "event_id": _events.emit(
                "serve.drain_begin", cause=cause_event, subject={
                    "deployment": name, "replica": victim.replica_id},
                drain_cause=cause, deadline_s=deadline_s)})
        mdefs.SERVE_REPLICA_DRAINS.inc(
            tags={"deployment": name, "cause": cause})

    # --------------------------------------------------------- preemption
    def _on_preempt(self, notice: Dict[str, Any]) -> None:
        # Elastic control signals (capacity hints, world-target asks)
        # ride the same channel and are the trainers' to latch.
        if notice.get("kind") == "capacity" or \
                notice.get("world_target") is not None:
            return
        try:
            self._drain_for_preemption(notice)
        except Exception:  # noqa: BLE001 — a drain is best effort
            logger.exception("serve: preemption drain failed")

    def _drain_for_preemption(self, notice: Dict[str, Any]) -> None:
        """Drain the replicas on the node a preemption notice names (every
        replica for an unscoped one) instead of letting the host's kill
        cut their in-flight requests; reconcile starts replacements."""
        target = str(notice.get("node", "*") or "*")
        with self._lock:
            snapshot = {name: list(reps)
                        for name, reps in self.replicas.items() if reps}
        if target in ("", "*", "all"):
            hits = snapshot
        else:
            # The node-id probe waits on replies, so it runs outside the
            # lock: holding it would stall deploys and the respawns the
            # notice's deadline depends on.
            flat = [(name, r) for name, reps in snapshot.items()
                    for r in reps]
            futs = [r.control("node_id") for _, r in flat]
            wait_futures(futs, timeout=self.PREEMPT_PROBE_S)
            hits = {}
            for (name, r), f in zip(flat, futs):
                if not f.done() or f.exception() is not None:
                    continue
                nid = str(f.result() or "")
                if nid and nid.startswith(target):
                    hits.setdefault(name, []).append(r)
        cause_event = str(notice.get("notice_id", ""))
        with self._lock:
            # Reconcile may have replaced a probed replica meanwhile.
            for name, victims in hits.items():
                current = list(self.replicas.get(name, []))
                victims = [r for r in victims if r in current]
                if not victims:
                    continue
                for r in victims:
                    self._begin_drain(name, r, "preemption", cause_event)
                self.replicas[name] = [r for r in current
                                       if r not in victims]
                self._routes_changed(name)

    def draining_count(self, name: str) -> int:
        with self._lock:
            return len(self._draining.get(name, []))

    def _advance_drains(self, name: str) -> None:
        """Retire the replicas whose drain answered (drained or past its
        own deadline), died, or outlived its deadline and grace."""
        now = time.monotonic()
        with self._lock:
            entries = self._draining.get(name, [])
            done = [e for e in entries
                    if e["future"].done() or not e["replica"].alive
                    or now > e["deadline"] + self.DRAIN_GRACE_S]
            self._draining[name] = [e for e in entries if e not in done]
            if not self._draining[name]:
                del self._draining[name]
        for e in done:
            fut = e["future"]
            res = (fut.result() if fut.done() and fut.exception() is None
                   else None)
            if res is not None:
                outcome = "drained" if res.get("drained") else "deadline"
            elif fut.done() or not e["replica"].alive:
                outcome = "died"
            else:
                outcome = "deadline"
            mdefs.SERVE_DRAIN_SECONDS.observe(
                now - e["t0"], tags={"deployment": name,
                                     "outcome": outcome})
            _events.emit("serve.drain_end", cause=e["event_id"],
                         subject={"deployment": name,
                                  "replica": e["replica"].replica_id},
                         outcome=outcome, drain_cause=e["cause"],
                         waited_s=now - e["t0"])
            if outcome == "died":
                mdefs.SERVE_REPLICA_DEATHS.inc(
                    tags={"deployment": name, "cause": "drain"})
            logger.info("serve: drain of a %s replica (%s) ended after "
                        "%.2f s: %s", name, e["cause"], now - e["t0"],
                        outcome)
            self._retire(e["replica"])

    # ---------------------------------------------------------- reconcile
    def _reconcile_loop(self) -> None:
        while not self._stop.wait(self.RECONCILE_S):
            with self._lock:
                names = set(self.deployments) | set(self._draining)
            for name in names:
                try:
                    self._advance_drains(name)
                    self._autoscale_once(name)
                    self._reconcile_once(name)
                except Exception:  # noqa: BLE001 — keep reconciling
                    logger.exception("serve: reconcile of %s failed", name)

    def _healthy(self, r: ReplicaProcess, now: float) -> bool:
        """Alive, and its last health probe answered within
        HEALTH_TIMEOUT_S (a probe is sent each pass when none waits)."""
        if not r.alive:
            return False
        t0, fut = self._probes.get(id(r), (now, None))
        if fut is not None and not fut.done():
            return now - t0 < self.HEALTH_TIMEOUT_S
        self._probes[id(r)] = (now, r.control("health"))
        return True

    def _reconcile_once(self, name: str, cause_event: str = "") -> None:
        """Bring ``name``'s replicas to its target: replace the dead and
        the hung, route the replacements that came up, start more, or
        shrink. A shrink retires replicas still starting first, then
        drains routed ones (``cause="scale_down"``, ``cause_event`` as
        the drain's cause)."""
        now = time.monotonic()
        doomed: List[ReplicaProcess] = []
        with self._lock:
            spec = self.deployments.get(name)
            if spec is None:
                return
            current = self.replicas.get(name, [])
            live = [r for r in current if self._healthy(r, now)]
            lost = [r for r in current if r not in live]
            for r in lost:          # their cards free for the replacements
                logger.warning("serve: a replica of %s (pid %s) died or "
                               "hung; replacing it", name, r.pid)
                mdefs.SERVE_REPLICA_DEATHS.inc(
                    tags={"deployment": name, "cause": "died"})
                self._retire(r, kill=True)
            starting = self._starting.get(name, [])
            ready = [r for r in starting if r.ready]
            failed = [r for r in starting if r.ready is False]
            pending = [r for r in starting if r.ready is None]
            # Scale-down: a replica not routed yet goes before a routed
            # one drains (newest first).
            excess = len(live) + len(ready) + len(pending) - \
                spec["num_replicas"]
            for group in (pending, ready):
                while excess > 0 and group:
                    doomed.append(group.pop())
                    excess -= 1
            victims = []
            while excess > 0 and live:
                victims.append(live.pop())
                excess -= 1
            for r in victims:
                self._begin_drain(name, r, "scale_down", cause_event)
            self._starting[name] = pending
            live += ready
            while (len(live) + len(self._starting[name])
                   < spec["num_replicas"] and now >= spec["retry_at"]):
                r = self._start_replica(name, spec, self._groups.get(name))
                if r is None:
                    break             # its cards are still held
                self._starting[name].append(r)
            if lost or ready or victims:
                self.replicas[name] = live
                self._routes_changed(name)
        for r in doomed:
            self._retire(r, kill=True)
        for r in failed:
            try:
                r.wait_ready(0)
            except Exception:  # noqa: BLE001 — logged; retried in 5 s
                logger.exception("serve: a replacement replica of %s "
                                 "failed to start", name)
            spec["retry_at"] = time.monotonic() + 5.0
            self._retire(r, kill=True)

    # ---------------------------------------------------------- autoscale
    def _pressure_desired(self, name: str, cfg: Dict[str, Any],
                          current: int) -> Tuple[int, str]:
        """(desired, signal) under the pressure policy: the largest of the
        ongoing-count target, the engines' queue-depth target, arena
        starvation, the prefill-token target, the importable floor and
        the ingress sheds since the last decision, each read off the
        replicas' pressure snapshots."""
        snaps = [s for s in self.get_replica_pressure(name)
                 if s and not s.get("unreachable")]
        ongoing = sum(float(s.get("ongoing") or 0) for s in snaps)
        desired = math.ceil(ongoing / max(cfg["target_ongoing_requests"],
                                          1e-9))
        signal = "ongoing"
        tq = float(cfg.get("target_queue_depth") or 0)
        if tq > 0:
            queue = sum(float(s.get("queue_depth") or 0) for s in snaps)
            d_q = math.ceil(queue / tq)
            if d_q > desired:
                desired, signal = d_q, "queue"
        engines = [s for s in snaps
                   if float(s.get("kv_blocks_total") or 0) > 0]
        if cfg.get("kv_starvation_upscale"):
            starved = [s for s in engines
                       if (float(s.get("kv_blocks_free") or 0)
                           + float(s.get("kv_blocks_cached") or 0)) <= 0]
            if engines and len(starved) == len(engines) and \
                    current + 1 > desired:
                # Every engine replica has nothing left to admit with.
                desired, signal = current + 1, "kv"
        tpt = float(cfg.get("target_prefill_queue_tokens") or 0)
        if tpt > 0:
            ptoks = sum(float(s.get("prefill_queue_tokens") or 0)
                        for s in snaps)
            d_p = math.ceil(ptoks / tpt)
            if d_p > desired:
                desired, signal = d_p, "prefill_tokens"
        imp_floor = float(cfg.get("importable_floor") or 0)
        if imp_floor > 0:
            low = [s for s in engines
                   if float(s.get("kv_blocks_importable") or 0)
                   < imp_floor]
            if engines and len(low) == len(engines) and \
                    current + 1 > desired:
                # The next KV handoff's reservation is about to fail.
                desired, signal = current + 1, "importable"
        if cfg.get("shed_upscale"):
            sheds = mdefs.serve_shed_total(name)
            last = self._shed_seen.setdefault(name, sheds)
            self._shed_seen[name] = sheds
            if sheds > last and current + 1 > desired:
                desired, signal = current + 1, "shed"
        return desired, signal

    def _autoscale_once(self, name: str) -> None:
        """One autoscaler decision for ``name``: the pressure policy's
        desired count, clamped to ``[min, max]`` and the pool arbiter's
        cap, applied once it has held for the up or down delay."""
        with self._lock:
            spec = self.deployments.get(name)
            if spec is None or spec["autoscaling"] is None or \
                    not self.replicas.get(name):
                return
            cfg = spec["autoscaling"]
            current = spec["num_replicas"]
            cap = spec["pool_cap"]
        desired, signal = self._pressure_desired(name, cfg, current)
        lo, hi = cfg["min_replicas"], cfg["max_replicas"]
        if cap is not None:
            # Cards leased away by the arbiter are a hard ceiling, below
            # min_replicas too: its SLO guard is the way back.
            hi = min(hi, int(cap))
            lo = min(lo, hi)
        desired = max(lo, min(hi, desired))
        if desired == current:
            self._scale_intent.pop(name, None)
            return
        now = time.monotonic()
        intent = self._scale_intent.get(name)
        if intent is None or intent[0] != desired:
            self._scale_intent[name] = (desired, now)
            return
        delay = (cfg["upscale_delay_s"] if desired > current
                 else cfg["downscale_delay_s"])
        if now - intent[1] < delay:
            return
        with self._lock:
            live = self.deployments.get(name)
            if live is None or live["num_replicas"] != current:
                return      # the arbiter moved the target meanwhile
            live["num_replicas"] = desired
        self._scale_intent.pop(name, None)
        direction = "up" if desired > current else "down"
        mdefs.SERVE_AUTOSCALE_DECISIONS.inc(tags={
            "deployment": name, "direction": direction, "signal": signal})
        # The scale-down drains below cite this decision as their cause.
        scale_ev = _events.emit(
            "serve.autoscale", subject={"deployment": name},
            direction=direction, signal=signal, current=current,
            desired=desired)
        self._reconcile_once(name, cause_event=scale_ev)

    # ------------------------------------------------- the pool's surface
    def pool_set_replicas(self, name: str, target: int,
                          cap: Optional[int] = None,
                          cause: str = "pool") -> Dict[str, Any]:
        """The pool arbiter's ask: set ``name``'s replica target and its
        cap in one step (``cap=None`` lifts it), and reconcile in the
        caller's thread; a shrink goes through the drain path. Returns
        the previous target and cap, so a restarted arbiter can repeat
        the ask."""
        with self._lock:
            spec = self.deployments.get(name)
            if spec is None:
                raise ValueError(f"unknown deployment {name!r}")
            prev = {"target": spec["num_replicas"], "cap": spec["pool_cap"]}
            spec["num_replicas"] = max(int(target), 0)
            spec["pool_cap"] = None if cap is None else max(int(cap), 0)
            self._scale_intent.pop(name, None)
        logger.info("pool: %s replicas -> %d (cap=%s, cause=%s)",
                    name, target, cap, cause)
        self._reconcile_once(name)
        return prev

    def pool_state(self, name: str) -> Dict[str, Any]:
        """What the arbiter confirms a stage against: the routed replicas
        (not those starting or draining), the target, the drains in
        flight and the cap."""
        with self._lock:
            spec = self.deployments.get(name) or {}
            return {"routed": len(self.replicas.get(name, [])),
                    "target": spec.get("num_replicas", 0),
                    "draining": len(self._draining.get(name, [])),
                    "cap": spec.get("pool_cap")}
