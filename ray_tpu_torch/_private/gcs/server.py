"""GCS server: the cluster control plane (the port's copy of
``ray_tpu/_private/gcs/server.py``, ``GcsServer`` :86).

Reference: ``src/ray/gcs/gcs_server`` — one process hosting node
membership with heartbeats and health checks, the KV, the actor table
with its scheduler and restarts, pubsub, placement groups (2PC over the
node managers) and the object directory, served over the port's wire
(:mod:`ray_tpu_torch._private.rpc`).

Distributed reference counts, as JAX's (``UpdateRefCounts`` :1557,
``ReapHolder`` :1604, ``_free_if_still_zero`` :1642): each holder (a
driver or worker process, :mod:`~ray_tpu_torch._private.refcount`)
flushes count deltas; an object whose summed count returns to zero is
freed from every node that stores it after a short grace
(``FREE_GRACE_S``) and remembered in a bounded table of freed objects
(``MAX_FREED_REMEMBERED``), so a late increment or location update never
brings it back and a borrower's get fails fast. A holder's counts go when
its node dies (worker holders), when its node manager reports its
process dead (``ReapHolder``), or when it stops flushing for
``DRIVER_HOLDER_TTL_S``. The port runs the graced frees on a thread of
its own where JAX starts a timer for each.

Fault tolerance, as JAX's: with ``persist_path`` set (or
``RAY_TPU_GCS_PERSIST_PATH``, or ``RAY_TPU_GCS_WAL_URL=logd://host:port``
for a log server that survives the head machine), the durable tables
(KV, actors, placement groups, object directory, reference counts and
their holders, the freed table) persist through a write-ahead log of
idempotent upsert records that compacts into a snapshot
(:mod:`~ray_tpu_torch._private.gcs.wal`); recovery loads the snapshot
and replays the log. Nodes are not persisted: a restarted GCS
answers their next heartbeat with ``ok=false`` and they register again.
The heartbeat and health periods keep JAX's env names
(``RAY_TPU_HEARTBEAT_TTL_S``, the node side's
``RAY_TPU_HEARTBEAT_PERIOD_S``).

Left out here, with the ROADMAP.md item that brings them: the head's
metrics TSDB, flight-event store, export events and job reconciler (the
dashboard and job plane of item 18b). Worker task
events land in a bounded ring served under the reserved
``__task_events__`` KV namespace, as JAX's.
"""

from __future__ import annotations

import argparse
import heapq
import json
import logging
import os
import pickle
import queue
import random
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import rpc

logger = logging.getLogger(__name__)

HEALTH_CHECK_PERIOD_S = 0.5
# Node-liveness TTL: a node whose heartbeats lapse this long is probed
# and, only if unreachable, marked dead (RAY_TPU_HEARTBEAT_TTL_S).
HEALTH_FAILURE_THRESHOLD_S = 3.0
# One probe per lapsed node per this window.
HEALTH_PROBE_BACKOFF_S = 2.0


# A holder that stops flushing and pinging for this long is taken for
# crashed and its counts reaped (every holder with counts pings each
# PING_PERIOD_S, 2 s).
DRIVER_HOLDER_TTL_S = 10.0
FREE_GRACE_S = 0.5
MAX_FREED_REMEMBERED = 65536


def _health_failure_threshold_s() -> float:
    return float(os.environ.get("RAY_TPU_HEARTBEAT_TTL_S",
                                HEALTH_FAILURE_THRESHOLD_S))


class _SubEntry:
    """One pubsub subscriber: its delivery queue and its id."""

    __slots__ = ("q", "sub_id")

    def __init__(self, q: "queue.Queue", sub_id: str):
        self.q = q
        self.sub_id = sub_id


class GcsServer:
    def __init__(self, port: int = 0, persist_path: Optional[str] = None):
        self._nodes: Dict[str, pb.NodeInfo] = {}
        self._last_heartbeat: Dict[str, float] = {}
        self._kv: Dict[Tuple[str, str], bytes] = {}
        self._task_events: "deque" = deque(
            maxlen=int(os.environ.get("RAY_TPU_TASK_EVENTS_MAX", 10000)))
        self._actors: Dict[bytes, pb.ActorInfo] = {}
        self._actor_names: Dict[Tuple[str, str], bytes] = {}
        self._subscribers: Dict[str, List[_SubEntry]] = defaultdict(list)
        self._pubsub_queue_max = int(os.environ.get(
            "RAY_TPU_PUBSUB_QUEUE_MAX", 10000))
        self._pgroups: Dict[bytes, pb.PlacementGroupInfo] = {}
        self._placing: Set[bytes] = set()
        self._actor_placing: Dict[str, int] = {}
        self._locations: Dict[bytes, Set[str]] = defaultdict(set)
        self._object_sizes: Dict[bytes, int] = {}
        self._restore_pending: List[bytes] = []
        # Reference counts: object -> {holder -> count}; an object is
        # freed when its summed count returns to zero.
        self._refcounts: Dict[bytes, Dict[str, int]] = {}
        # holder -> (node_id, is_driver, last seen, monotonic).
        self._holder_meta: Dict[str, Tuple[str, bool, float]] = {}
        # Recently freed objects (bounded FIFO): late increments and
        # location updates for these are refused.
        self._freed: Dict[bytes, float] = {}
        # Graced frees: a heap of (due, seq, object ids).
        self._free_heap: List[Tuple[float, int, List[bytes]]] = []
        self._free_seq = 0
        self._free_cv = threading.Condition()

        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # Bounded pool for actor creation/restart work.
        self._work_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="gcs-work")
        self._persist_path = persist_path or os.environ.get(
            "RAY_TPU_GCS_PERSIST_PATH") or None
        self._wal_url = os.environ.get("RAY_TPU_GCS_WAL_URL", "")
        self._wal = None
        if self._persist_path or self._wal_url:
            from ray_tpu_torch._private.gcs.wal import (WriteAheadLog,
                                                        parse_records)
            from ray_tpu_torch._private.gcs.wal_backend import \
                backend_from_url

            base = self._persist_path or os.path.join(
                os.getcwd(), "gcs_state")
            backend = backend_from_url(self._wal_url, base + ".wal", base)
            loaded = False
            snap = backend.load_snapshot()
            if snap:
                self._load_snapshot(snap)
                loaded = True
            replayed = 0
            for rec in parse_records(backend.read_log()):
                try:
                    self._apply_wal_record(rec)
                    replayed += 1
                except Exception:  # noqa: BLE001 — one bad record must not
                    logger.exception("skipping unreplayable WAL record")
            if loaded or replayed:
                self._finish_restore()
            self._wal = WriteAheadLog(backend, self._state_blob)
        self._server, self.port = rpc.serve("GcsService", self, port=port)
        self._spawn(self._health_loop, "gcs-health")
        self._spawn(self._free_loop, "gcs-free")

    def _spawn(self, target, name: str) -> None:
        t = threading.Thread(target=target, daemon=True, name=name)
        self._threads.append(t)
        t.start()

    # ------------------------------------------------------------ persistence
    def _wal_append(self, record) -> None:
        if self._wal is not None:
            self._wal.append(record)

    def wal_sync(self, timeout_s: float = 10.0) -> bool:
        """Write barrier: True once every mutation accepted so far is
        durable in the WAL backend (True without persistence)."""
        if self._wal is None:
            return True
        return self._wal.sync(timeout_s)

    def _state_blob(self) -> bytes:
        with self._lock:
            state = {
                "kv": dict(self._kv),
                "actors": {k: v.SerializeToString()
                           for k, v in self._actors.items()},
                "actor_names": dict(self._actor_names),
                "pgroups": {k: v.SerializeToString()
                            for k, v in self._pgroups.items()},
                "locations": {k: sorted(v)
                              for k, v in self._locations.items() if v},
                "object_sizes": dict(self._object_sizes),
                "refcounts": {k: dict(v)
                              for k, v in self._refcounts.items() if v},
                # Holder -> node bindings survive a restart, so a node
                # death reaps its workers' counts afterwards too.
                "holders": {h: (nid, is_drv) for h, (nid, is_drv, _)
                            in self._holder_meta.items()},
                "freed": list(self._freed),
            }
        return pickle.dumps(state)

    def _load_snapshot(self, blob: bytes):
        try:
            state = pickle.loads(blob)
        except Exception:  # noqa: BLE001
            logger.exception("GCS snapshot load failed; starting empty")
            return
        self._kv = dict(state.get("kv", {}))
        for k, raw in state.get("actors", {}).items():
            self._actors[k] = pb.ActorInfo.FromString(raw)
        self._actor_names = dict(state.get("actor_names", {}))
        for k, raw in state.get("pgroups", {}).items():
            self._pgroups[k] = pb.PlacementGroupInfo.FromString(raw)
        for k, nodes in state.get("locations", {}).items():
            self._locations[k] = set(nodes)
        self._object_sizes = dict(state.get("object_sizes", {}))
        now = time.monotonic()
        for k, holders in state.get("refcounts", {}).items():
            self._refcounts[k] = dict(holders)
        for h, (nid, is_drv) in state.get("holders", {}).items():
            self._holder_meta[h] = (nid, is_drv, now)
        for oid in state.get("freed", ()):
            self._freed[oid] = now

    def _claim_actor_name(self, info) -> None:
        """Maintain the name table for one actor update (caller holds the
        lock; WAL replay uses it too). A name is released when its holder
        reports DEAD and claimed only when unheld or held by a dead or
        unknown actor."""
        if not info.name:
            return
        aid = bytes(info.actor_id)
        key = (info.namespace or "default", info.name)
        if info.state == "DEAD":
            if self._actor_names.get(key) == aid:
                del self._actor_names[key]
            return
        cur = self._actor_names.get(key)
        if cur is None or cur == aid:
            self._actor_names[key] = aid
            return
        holder = self._actors.get(cur)
        if holder is None or holder.state == "DEAD":
            self._actor_names[key] = aid

    def _apply_wal_record(self, rec) -> None:
        kind = rec[0]
        if kind == "kv":
            _, ns, key, value = rec
            if value is None:
                self._kv.pop((ns, key), None)
            else:
                self._kv[(ns, key)] = value
        elif kind == "actor":
            info = pb.ActorInfo.FromString(rec[1])
            self._actors[bytes(info.actor_id)] = info
            self._claim_actor_name(info)
        elif kind == "pg":
            self._pgroups[bytes(rec[1])] = \
                pb.PlacementGroupInfo.FromString(rec[2])
        elif kind == "loc":
            _, oid, node_id, added, size = rec
            if added:
                self._locations[oid].add(node_id)
                if size:
                    self._object_sizes[oid] = size
            else:
                self._locations[oid].discard(node_id)
        elif kind == "locs":
            for sub in rec[1]:
                self._apply_wal_record(("loc",) + tuple(sub))
        elif kind == "refs":
            for oid, holder, count in rec[1]:
                holders = self._refcounts.get(oid)
                if count <= 0:
                    if holders is not None:
                        holders.pop(holder, None)
                        if not holders:
                            del self._refcounts[oid]
                else:
                    if holders is None:
                        holders = self._refcounts[oid] = {}
                    holders[holder] = count
        elif kind == "holder":
            _, hid, nid, is_drv = rec
            self._holder_meta[hid] = (nid, is_drv, time.monotonic())
        elif kind == "rmholder":
            hset = set(rec[1])
            for hid in hset:
                self._holder_meta.pop(hid, None)
            for oid in list(self._refcounts):
                holders = self._refcounts[oid]
                for hid in hset & holders.keys():
                    del holders[hid]
                if not holders:
                    del self._refcounts[oid]
        elif kind == "freed":
            now = time.monotonic()
            for oid in rec[1]:
                self._freed[oid] = now
                self._locations.pop(oid, None)
                self._object_sizes.pop(oid, None)
            while len(self._freed) > MAX_FREED_REMEMBERED:
                self._freed.pop(next(iter(self._freed)))
        else:
            logger.warning("unknown WAL record kind %r", kind)

    def _finish_restore(self):
        # Actors mid-creation at crash time would hang their clients: drive
        # them through the restart path once nodes register again.
        self._restore_pending = [
            bytes(k) for k, a in self._actors.items()
            if a.state in ("PENDING", "RESTARTING")]
        # Restored ALIVE actors whose node never comes back are node-dead.
        t = threading.Timer(3 * _health_failure_threshold_s(),
                            self._sweep_restored_actors)
        t.daemon = True
        t.start()
        self._sweep_timer = t
        logger.info("GCS state restored from %s (%d actors, %d kv keys, "
                    "%d pending restarts)", self._persist_path or
                    self._wal_url, len(self._actors), len(self._kv),
                    len(self._restore_pending))

    def _kick_restored_actors(self):
        with self._lock:
            pending, self._restore_pending = self._restore_pending, []
        for aid in pending:
            with self._lock:
                info = self._actors.get(aid)
            if info is not None and info.state in ("PENDING", "RESTARTING"):
                self._submit_work(self._restart_actor, info)

    def _sweep_restored_actors(self):
        if self._stop.is_set():
            return
        with self._lock:
            gone_nodes = {a.node_id for a in self._actors.values()
                          if a.state == "ALIVE"
                          and a.node_id and a.node_id not in self._nodes}
        for node_id in gone_nodes:
            self._on_node_dead(node_id)

    def _submit_work(self, fn, *args) -> None:
        try:
            self._work_pool.submit(fn, *args)
        except RuntimeError:  # the pool shut down with the server
            pass

    # ------------------------------------------------------------- helpers
    def _publish(self, channel: str, data: bytes):
        with self._lock:
            subs = list(self._subscribers.get(channel, []))
        for ent in subs:
            if ent.q.qsize() >= self._pubsub_queue_max:
                continue  # a wedged subscriber sheds, the rest still get it
            ent.q.put(pb.PubsubMessage(channel=channel, data=data))

    def _node_stub(self, node_id: str) -> Optional[rpc.Stub]:
        with self._lock:
            info = self._nodes.get(node_id)
        if info is None or not info.alive:
            return None
        return rpc.get_stub("NodeService", info.address)

    # ------------------------------------------------------------- nodes
    def RegisterNode(self, request, context):
        info = request.info
        with self._lock:
            info.alive = True
            self._nodes[info.node_id] = info
            self._last_heartbeat[info.node_id] = time.monotonic()
        logger.info("node %s registered at %s", info.node_id[:8],
                    info.address)
        self._publish("NODE", pickle.dumps(
            {"event": "alive", "node_id": info.node_id}))
        if self._restore_pending:
            self._submit_work(self._kick_restored_actors)
        return pb.RegisterNodeReply(ok=True)

    def DrainNode(self, request, context):
        self._mark_dead(request.node_id, "drained")
        return pb.Empty()

    def Heartbeat(self, request, context):
        changed = False
        with self._lock:
            info = self._nodes.get(request.node_id)
            if info is None:
                return pb.HeartbeatReply(ok=False)  # unknown: re-register
            self._last_heartbeat[request.node_id] = time.monotonic()
            for k, v in request.available.items():
                if info.available.get(k) != v:
                    changed = True
                info.available[k] = v
        if changed:
            # Resource-view gossip (reference ray_syncer.h:83): changes
            # are pushed to the subscribed node managers as deltas.
            self._publish("NODE_RES", pickle.dumps(
                {"node_id": request.node_id,
                 "available": dict(request.available)}))
        return pb.HeartbeatReply(ok=True)

    def GetNodes(self, request, context):
        with self._lock:
            return pb.GetNodesReply(nodes=list(self._nodes.values()))

    def _health_loop(self):
        """Reference: GcsHealthCheckManager (gcs_health_check_manager.h:45)."""
        probe_backoff: Dict[str, float] = {}
        while not self._stop.wait(HEALTH_CHECK_PERIOD_S):
            now = time.monotonic()
            node_ttl = _health_failure_threshold_s()
            with self._lock:
                lapsed = [(node_id, info.address)
                          for node_id, info in self._nodes.items()
                          if info.alive and now - self._last_heartbeat.get(
                              node_id, now) > node_ttl]
                # A crashed process sends no last flush and its pings
                # stop; a worker reap lost to a GCS outage lands here too.
                stale = [hid for hid, (_, _d, seen)
                         in self._holder_meta.items()
                         if now - seen > DRIVER_HOLDER_TTL_S]
            if stale:
                logger.warning("reaping %d stale holder(s)", len(stale))
                self._reap_holders(stale)
            for node_id, address in lapsed:
                # A lapsed node is probed first: one that answers is slow,
                # not dead (co-tenant load stalls heartbeat senders).
                if now - probe_backoff.get(node_id, 0.0) < \
                        HEALTH_PROBE_BACKOFF_S:
                    continue
                probe_backoff[node_id] = now
                self._submit_work(self._probe_lapsed_node, node_id, address)

    def _probe_lapsed_node(self, node_id: str, address: str) -> None:
        alive = False
        try:
            rpc.get_stub("NodeService", address).GetObjectsMeta(
                pb.GetObjectsMetaRequest(object_ids=[]), timeout=1.5)
            alive = True
        except Exception:  # noqa: BLE001 — unreachable: confirmed dead
            pass
        if alive:
            with self._lock:
                info = self._nodes.get(node_id)
                if info is not None and info.alive:
                    self._last_heartbeat[node_id] = time.monotonic()
            logger.warning("node %s heartbeats lapsed past the TTL but its "
                           "node manager answered a probe; keeping it",
                           node_id[:8])
        else:
            self._mark_dead(node_id, "missed heartbeats; probe failed")

    def _mark_dead(self, node_id: str, reason: str):
        with self._lock:
            info = self._nodes.get(node_id)
            if info is None or not info.alive:
                return
            info.alive = False
        logger.warning("node %s marked dead: %s", node_id[:8], reason)
        self._publish("NODE", pickle.dumps(
            {"event": "dead", "node_id": node_id, "reason": reason}))
        self._on_node_dead(node_id)

    # ------------------------------------------------------------- kv
    def KvPut(self, request, context):
        if request.ns == "__task_events__":
            return pb.KvReply(ok=False)  # reserved: reads serve the ring
        key = (request.ns, request.key)
        with self._lock:
            if not request.overwrite and key in self._kv:
                return pb.KvReply(ok=False)
            self._kv[key] = request.value
            # Inside the lock: log order must match apply order.
            self._wal_append(("kv", request.ns, request.key, request.value))
        return pb.KvReply(ok=True)

    def KvGet(self, request, context):
        if request.ns == "__task_events__":
            with self._lock:
                events = list(self._task_events)
            return pb.KvReply(found=True, value=pickle.dumps(events))
        with self._lock:
            val = self._kv.get((request.ns, request.key))
        if val is None:
            return pb.KvReply(found=False)
        return pb.KvReply(found=True, value=val)

    def KvDel(self, request, context):
        with self._lock:
            old = self._kv.pop((request.ns, request.key), None)
            if old is not None:
                self._wal_append(("kv", request.ns, request.key, None))
        return pb.KvReply(ok=old is not None)

    def KvKeys(self, request, context):
        with self._lock:
            keys = [k for ns, k in self._kv
                    if ns == request.ns and k.startswith(request.prefix)]
        return pb.KvReply(keys=keys, ok=True)

    # ------------------------------------------------------------- actors
    def RegisterActor(self, request, context):
        info = request.info
        with self._lock:
            if info.name:
                key = (info.namespace or "default", info.name)
                existing = self._actor_names.get(key)
                if existing is not None and \
                        self._actors[existing].state != "DEAD":
                    return pb.RegisterActorReply(
                        ok=False,
                        error=f"Actor name {info.name!r} already taken")
                self._actor_names[key] = info.actor_id
            self._actors[info.actor_id] = info
            self._wal_append(("actor", info.SerializeToString()))
        self._publish("ACTOR", info.SerializeToString())
        if info.state == "PENDING":
            # GCS-direct actor creation (reference: gcs_actor_scheduler.cc:60).
            self._submit_work(self._restart_actor, info)
        return pb.RegisterActorReply(ok=True)

    def UpdateActor(self, request, context):
        info = request.info
        restart = False
        with self._lock:
            if info.state == "RESTARTING":
                # A node manager reported the actor's worker died; the GCS
                # owns the restart budget (gcs_actor_manager.cc:1372).
                if info.num_restarts < info.max_restarts or \
                        info.max_restarts < 0:
                    info.num_restarts += 1
                    restart = True
                else:
                    info.state = "DEAD"
                    info.death_cause = info.death_cause or "worker died"
            self._actors[info.actor_id] = info
            self._claim_actor_name(info)
            self._wal_append(("actor", info.SerializeToString()))
        self._publish("ACTOR", info.SerializeToString())
        if restart:
            self._submit_work(self._restart_actor, info)
        return pb.Empty()

    def GetActor(self, request, context):
        with self._lock:
            if request.actor_id:
                info = self._actors.get(request.actor_id)
            else:
                aid = self._actor_names.get(
                    (request.namespace or "default", request.name))
                info = self._actors.get(aid) if aid else None
        if info is None:
            return pb.GetActorReply(found=False)
        return pb.GetActorReply(found=True, info=info)

    def ListActors(self, request, context):
        with self._lock:
            actors = [a for a in self._actors.values()
                      if request.all_namespaces
                      or a.namespace == (request.namespace or "default")]
        return pb.ListActorsReply(actors=actors)

    def _on_node_dead(self, node_id: str):
        """Reap the dead node's worker holders, re-place its bundles and
        restart or kill its actors (reference:
        GcsActorManager::OnNodeDead, gcs_actor_manager.cc:1279;
        GcsPlacementGroupManager::OnNodeDead, :585). Drivers survive a
        node failover: their counts go by the ping TTL."""
        with self._lock:
            holders = [hid for hid, (nid, is_driver, _)
                       in self._holder_meta.items()
                       if nid == node_id and not is_driver]
        if holders:
            self._reap_holders(holders)
        to_replace: List[pb.PlacementGroupInfo] = []
        with self._lock:
            for info in self._pgroups.values():
                if info.state in ("REMOVED", "INFEASIBLE"):
                    continue
                hit = [b for b in info.bundles if b.node_id == node_id]
                if not hit:
                    continue
                for b in hit:
                    b.node_id = ""
                info.state = "RESCHEDULING"
                to_replace.append(info)
                self._wal_append(("pg", bytes(info.group_id),
                                  info.SerializeToString()))
        for info in to_replace:
            self._publish("PLACEMENT_GROUP", info.SerializeToString())
            self._submit_place(info)
        with self._lock:
            affected = [a for a in self._actors.values()
                        if a.node_id == node_id and a.state == "ALIVE"]
        for info in affected:
            if info.num_restarts < info.max_restarts or info.max_restarts < 0:
                info.num_restarts += 1
                info.state = "RESTARTING"
                self._wal_append(("actor", info.SerializeToString()))
                self._publish("ACTOR", info.SerializeToString())
                self._submit_work(self._restart_actor, info)
            else:
                info.state = "DEAD"
                info.death_cause = f"node {node_id[:8]} died"
                self.UpdateActor(pb.UpdateActorRequest(info=info), None)

    def _restart_actor(self, info: pb.ActorInfo):
        """Reference: GcsActorManager RestartActor
        (gcs_actor_manager.cc:1372). Transient fullness retries; a demand
        no alive node can ever hold leaves the actor DEAD."""
        deadline = time.monotonic() + 60.0
        last_err = "no feasible node for restart"
        while not self._stop.is_set():
            candidates, waitable = self._schedule_actor(info)
            retriable = waitable
            if waitable:
                last_err = "matching nodes are full (retrying)"
            for node_id in candidates:
                stub = self._node_stub(node_id)
                if stub is None:
                    continue
                with self._lock:
                    self._actor_placing[node_id] = \
                        self._actor_placing.get(node_id, 0) + 1
                try:
                    reply = stub.CreateActorOnNode(
                        pb.CreateActorOnNodeRequest(info=info), timeout=600)
                except Exception as e:  # noqa: BLE001
                    last_err = f"restart failed: {e}"
                    continue
                finally:
                    with self._lock:
                        self._actor_placing[node_id] -= 1
                        if self._actor_placing[node_id] <= 0:
                            del self._actor_placing[node_id]
                if reply.ok:
                    if self._killed_meanwhile(info):
                        # Killed while its node built it: the kill found
                        # no worker to stop, so stop the one built now.
                        self._kill_built(info, reply.worker_address)
                        return
                    info.state = "ALIVE"
                    info.node_id = node_id
                    info.address = reply.worker_address
                    info.fast_address = reply.fast_address
                    self.UpdateActor(pb.UpdateActorRequest(info=info), None)
                    return
                last_err = reply.error
                if "pg-wait" in (reply.error or "") or \
                        "insufficient resources" in (reply.error or ""):
                    retriable = True
            if not retriable or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        if self._stop.is_set():
            return
        info.state = "DEAD"
        info.death_cause = last_err
        self.UpdateActor(pb.UpdateActorRequest(info=info), None)

    def _killed_meanwhile(self, info: pb.ActorInfo) -> bool:
        """Whether the actor this placement builds was killed since (a
        kill stores a DEAD copy of its record)."""
        with self._lock:
            cur = self._actors.get(bytes(info.actor_id))
        return cur is not None and cur is not info and cur.state == "DEAD"

    @staticmethod
    def _kill_built(info: pb.ActorInfo, address: str) -> None:
        try:
            rpc.get_stub("WorkerService", address).KillActor(
                pb.KillActorRequest(actor_id=bytes(info.actor_id),
                                    no_restart=True), timeout=5)
        except Exception:  # noqa: BLE001 — the worker is gone already
            pass

    def _schedule_actor(self, info: pb.ActorInfo):
        """Candidate nodes, best first (GcsActorScheduler), and whether a
        miss is transient (``waitable``: a matching node could hold the
        demand once capacity frees)."""
        spec = pickle.loads(info.spec)
        pg = spec.get("pg")
        if pg is not None:
            group_id, idx = pg
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and not self._stop.is_set():
                with self._lock:
                    ginfo = self._pgroups.get(group_id)
                    if ginfo is None:
                        return [], False
                    if ginfo.state == "CREATED":
                        if idx >= 0:
                            return [b.node_id for b in ginfo.bundles
                                    if b.index == idx and b.node_id], False
                        return list(dict.fromkeys(
                            b.node_id for b in ginfo.bundles
                            if b.node_id)), False
                    if ginfo.state in ("REMOVED", "INFEASIBLE"):
                        return [], False
                time.sleep(0.05)
            return [], False
        demand: Dict[str, float] = spec.get("resources", {})

        def fits(n):
            return all(n.available.get(k, 0.0) + 1e-9 >= v
                       for k, v in demand.items())

        def ever_fits(n):
            return all(n.resources.get(k, 0.0) + 1e-9 >= v
                       for k, v in demand.items())

        with self._lock:
            eligible = [n for n in self._nodes.values() if n.alive]
        affinity = spec.get("affinity")
        if affinity:
            node_id, soft = affinity
            pinned = [n for n in eligible if n.node_id == node_id]
            if not soft:
                eligible = pinned
            elif pinned and any(fits(n) for n in pinned):
                eligible = pinned
        preferred: List = []
        labels_raw = spec.get("labels")
        if labels_raw:
            from ray_tpu_torch._private.scheduler import policies

            selector = json.loads(labels_raw)
            hard = selector.get("hard") or {}
            soft_sel = selector.get("soft") or {}
            eligible = [n for n in eligible
                        if policies.match_labels(dict(n.labels), hard)]
            if soft_sel:
                preferred = [n for n in eligible
                             if policies.match_labels(dict(n.labels),
                                                      soft_sel)]
        candidates = [n for n in (preferred or eligible) if fits(n)]
        if not candidates and preferred:
            candidates = [n for n in eligible if fits(n)]
        if not candidates:
            return [], any(ever_fits(n) for n in eligible)
        if spec.get("strategy") == "SPREAD":
            # Fewest actors first, in-flight placements counted, random
            # tie-break.
            with self._lock:
                load = {n.node_id: self._actor_placing.get(n.node_id, 0)
                        for n in candidates}
                for a in self._actors.values():
                    if a.state == "ALIVE" and a.node_id in load:
                        load[a.node_id] += 1
            best = min(candidates, key=lambda n: (load[n.node_id],
                                                  random.random()))
            return [best.node_id], False
        best = max(candidates, key=lambda n: sum(n.available.values()))
        return [best.node_id], False

    # ------------------------------------------------------------- pubsub
    def Publish(self, request, context):
        if request.channel == "TASK_EVENT":
            # Task-event sink (reference gcs_task_manager.h): ring-buffered
            # and served under the reserved "__task_events__" namespace.
            try:
                events = pickle.loads(request.data)
                with self._lock:
                    self._task_events.extend(events)
            except Exception:  # noqa: BLE001 — a bad batch must not fail
                pass
        self._publish(request.channel, request.data)
        return pb.Empty()

    def Subscribe(self, request, context):
        q: "queue.Queue" = queue.Queue()
        ent = _SubEntry(q, request.subscriber_id or f"anon-{id(q):x}")
        with self._lock:
            for ch in request.channels:
                self._subscribers[ch].append(ent)
        try:
            while not self._stop.is_set():
                try:
                    msg = q.get(timeout=0.5)
                except queue.Empty:
                    if context is not None and not context.is_active():
                        break
                    continue
                yield msg
        finally:
            with self._lock:
                for ch in request.channels:
                    if ent in self._subscribers.get(ch, []):
                        self._subscribers[ch].remove(ent)

    # ---------------------------------------------------- placement groups
    def CreatePlacementGroup(self, request, context):
        info = pb.PlacementGroupInfo(
            group_id=request.group_id, name=request.name,
            strategy=request.strategy, bundles=list(request.bundles),
            state="PENDING")
        with self._lock:
            self._pgroups[request.group_id] = info
            self._wal_append(("pg", bytes(request.group_id),
                              info.SerializeToString()))
        self._submit_place(info)
        return pb.Empty()

    def _submit_place(self, info: pb.PlacementGroupInfo):
        """At most one placement run per group."""
        gid = bytes(info.group_id)
        with self._lock:
            if gid in self._placing:
                return
            self._placing.add(gid)

        def run():
            try:
                self._place_group(info)
            finally:
                with self._lock:
                    self._placing.discard(gid)
                    # A node death during the run may have cleared more
                    # bundles after our last look.
                    resubmit = (not self._stop.is_set()
                                and info.state not in ("REMOVED",
                                                       "INFEASIBLE")
                                and any(not b.node_id
                                        for b in info.bundles))
                if resubmit:
                    self._submit_place(info)

        # A thread of its own, not the work pool: PG-targeted actor
        # creations wait in pool slots for CREATED.
        self._spawn(run, f"pg-place-{gid.hex()[:8]}")

    def _cancel_bundles(self, group_id: bytes, node_ids) -> None:
        for node_id in node_ids:
            stub = self._node_stub(node_id)
            if stub:
                try:
                    stub.CancelBundle(pb.CancelBundleRequest(
                        group_id=group_id))
                except Exception:  # noqa: BLE001
                    pass

    def _place_group(self, info: pb.PlacementGroupInfo):
        """2PC bundle placement (reference: GcsPlacementGroupScheduler
        prepare/commit across raylets, gcs_placement_group_scheduler.cc)."""
        from ray_tpu_torch._private.scheduler.policies import (
            feasible_anywhere, place_bundles)

        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not self._stop.is_set():
            with self._lock:
                if info.state == "REMOVED":
                    return
                nodes = [n for n in self._nodes.values() if n.alive]
                pending = [b for b in info.bundles if not b.node_id]
                occupied = [b.node_id for b in info.bundles if b.node_id]
            if not pending:
                break
            # Infeasible by total resources: fail fast.
            if nodes and not all(
                    feasible_anywhere(nodes, dict(b.resources))
                    for b in pending):
                break
            assignment = place_bundles(info, nodes, pending=pending,
                                       occupied=occupied)
            if assignment is None:
                time.sleep(0.2)
                continue
            # Phase 1: prepare on every involved node.
            by_node: Dict[str, List[pb.Bundle]] = defaultdict(list)
            for bundle, node_id in zip(pending, assignment):
                by_node[node_id].append(pb.Bundle(
                    index=bundle.index, node_id=node_id,
                    resources=dict(bundle.resources)))
            prepared = []
            ok = True
            for node_id, bundles in by_node.items():
                stub = self._node_stub(node_id)
                try:
                    r = stub.PrepareBundle(pb.PrepareBundleRequest(
                        group_id=info.group_id, bundles=bundles))
                    if not r.success:
                        ok = False
                        break
                    prepared.append(node_id)
                except Exception:  # noqa: BLE001
                    ok = False
                    break
            if not ok:
                self._cancel_bundles(info.group_id, prepared)
                time.sleep(0.2)
                continue
            # Phase 2: commit. A node lost between prepare and commit keeps
            # its bundles pending; the next iteration retries them.
            committed: set = set()
            for node_id, bundles in by_node.items():
                stub = self._node_stub(node_id)
                try:
                    if stub is None:
                        raise ConnectionError(f"node {node_id[:8]} gone")
                    stub.CommitBundle(pb.CommitBundleRequest(
                        group_id=info.group_id, bundles=bundles))
                    committed.add(node_id)
                except Exception:  # noqa: BLE001
                    pass
            rollback = False
            with self._lock:
                if info.state == "REMOVED":
                    rollback = True  # removal raced the commit
                else:
                    for bundle, node_id in zip(pending, assignment):
                        if node_id in committed:
                            bundle.node_id = node_id
                    if all(b.node_id for b in info.bundles):
                        info.state = "CREATED"
            self._cancel_bundles(info.group_id, list(by_node) if rollback
                                 else [n for n in by_node
                                       if n not in committed])
            if rollback:
                return
            if len(committed) < len(by_node):
                time.sleep(0.2)
                continue
            with self._lock:
                self._wal_append(("pg", bytes(info.group_id),
                                  info.SerializeToString()))
            self._publish("PLACEMENT_GROUP", info.SerializeToString())
            return
        with self._lock:
            if info.state == "REMOVED":
                return
            info.state = "CREATED" if all(b.node_id for b in info.bundles) \
                else "INFEASIBLE"
            self._wal_append(("pg", bytes(info.group_id),
                              info.SerializeToString()))
        self._publish("PLACEMENT_GROUP", info.SerializeToString())

    def GetPlacementGroup(self, request, context):
        with self._lock:
            info = self._pgroups.get(request.group_id)
        if info is None:
            return pb.GetPlacementGroupReply(found=False)
        return pb.GetPlacementGroupReply(found=True, info=info)

    def RemovePlacementGroup(self, request, context):
        with self._lock:
            info = self._pgroups.get(request.group_id)
            if info is None:
                return pb.Empty()
            info.state = "REMOVED"
            nodes = {b.node_id for b in info.bundles if b.node_id}
            self._wal_append(("pg", bytes(request.group_id),
                              info.SerializeToString()))
        self._cancel_bundles(request.group_id, nodes)
        self._publish("PLACEMENT_GROUP", info.SerializeToString())
        return pb.Empty()

    # ------------------------------------------------------ object directory
    def _apply_loc_update(self, request) -> Tuple[bool, Optional[str]]:
        """Apply one location update (caller holds the lock):
        ``(applied, sweep_address)``. A freed object's update is not
        applied (logged, it would bring the location back on replay), and
        a copy stored after its free is swept from its node."""
        if request.added:
            if request.object_id in self._freed:
                node = self._nodes.get(request.node_id)
                return False, (node.address if node is not None else None)
            self._locations[request.object_id].add(request.node_id)
            if request.size:
                self._object_sizes[request.object_id] = request.size
        else:
            locs = self._locations.get(request.object_id)
            if locs is not None:
                locs.discard(request.node_id)
                if not locs:
                    del self._locations[request.object_id]
        return True, None

    def _sweep(self, sweeps: Dict[str, List[bytes]]) -> None:
        for addr, oids in sweeps.items():
            self._submit_work(lambda a=addr, o=oids: rpc.get_stub(
                "NodeService", a).FreeObjects(
                    pb.FreeObjectsRequest(object_ids=o), timeout=10))

    def UpdateObjectLocation(self, request, context):
        with self._lock:
            applied, sweep = self._apply_loc_update(request)
            if applied:
                self._wal_append(("loc", request.object_id, request.node_id,
                                  request.added, request.size))
        if not applied:
            if sweep:
                self._sweep({sweep: [request.object_id]})
            return pb.Empty()
        if request.added:
            # Wake blocked get()/wait() callers (reference:
            # pubsub/publisher.h:297 object channel).
            self._publish("OBJECT_LOC", request.object_id)
        return pb.Empty()

    def UpdateObjectLocationsBatch(self, request, context):
        """One RPC and one pubsub wakeup per node-side put batch."""
        sweeps: Dict[str, List[bytes]] = defaultdict(list)
        applied = []
        with self._lock:
            for u in request.updates:
                ok, addr = self._apply_loc_update(u)
                if ok:
                    applied.append((u.object_id, u.node_id, u.added, u.size))
                elif addr:
                    sweeps[addr].append(u.object_id)
            if applied:
                self._wal_append(("locs", applied))
        self._sweep(sweeps)
        if any(a[2] for a in applied):
            self._publish("OBJECT_LOC", b"")
        return pb.Empty()

    def GetObjectLocations(self, request, context):
        with self._lock:
            locs = list(self._locations.get(request.object_id, ()))
            size = self._object_sizes.get(request.object_id, 0)
            freed = request.object_id in self._freed
        return pb.GetObjectLocationsReply(node_ids=locs, size=size,
                                          freed=freed)

    def GetObjectsLocations(self, request, context):
        """Batched has-any-location probe for wait() fan-in."""
        with self._lock:
            found = [bool(self._locations.get(oid))
                     and oid not in self._freed
                     for oid in request.object_ids]
        return pb.GetObjectsMetaReply(found=found)

    # ------------------------------------------------- reference counts
    def UpdateRefCounts(self, request, context):
        to_free: List[bytes] = []
        late: List[bytes] = []
        changes: List[Tuple[bytes, str, int]] = []
        with self._lock:
            if request.holder_id:
                self._holder_meta[request.holder_id] = (
                    request.node_id, request.is_driver, time.monotonic())
            for d in request.deltas:
                if d.object_id in self._freed:
                    # Late traffic for a freed object never brings it
                    # back; a late +1 is a holder that still thinks it
                    # has the object.
                    if d.delta > 0:
                        late.append(d.object_id)
                    continue
                holders = self._refcounts.get(d.object_id)
                if holders is None:
                    if d.delta <= 0:
                        # A decrement of an object never counted makes no
                        # entry and drives no free.
                        continue
                    holders = self._refcounts[d.object_id] = {}
                n = holders.get(request.holder_id, 0) + d.delta
                if n <= 0:
                    holders.pop(request.holder_id, None)
                else:
                    holders[request.holder_id] = n
                # WAL records carry the absolute count (idempotent).
                changes.append((d.object_id, request.holder_id, max(n, 0)))
                if not holders:
                    del self._refcounts[d.object_id]
                    to_free.append(d.object_id)
            # A ping changes nothing persisted and logs nothing.
            if changes and request.holder_id:
                self._wal_append(("holder", request.holder_id,
                                  request.node_id, request.is_driver))
            if changes:
                self._wal_append(("refs", changes))
        self._schedule_free(to_free)
        for oid in late:
            self._publish("OBJECT_FREED", oid)
        return pb.Empty()

    def ReapHolder(self, request, context):
        """Drop every count a dead process held (node managers send this
        when a worker process dies)."""
        self._reap_holders([request.holder_id])
        return pb.Empty()

    def _reap_holders(self, holder_ids) -> None:
        to_free: List[bytes] = []
        with self._lock:
            hset = set(holder_ids)
            for hid in hset:
                self._holder_meta.pop(hid, None)
            for oid in list(self._refcounts):
                holders = self._refcounts[oid]
                for hid in hset & holders.keys():
                    del holders[hid]
                if not holders:
                    del self._refcounts[oid]
                    to_free.append(oid)
            self._wal_append(("rmholder", list(hset)))
        if to_free:
            logger.info("reaped %d holder(s): freeing %d orphaned objects",
                        len(holder_ids), len(to_free))
        self._schedule_free(to_free)

    def _schedule_free(self, oids: List[bytes]) -> None:
        """Free ``oids`` after ``FREE_GRACE_S`` unless a count came back
        meanwhile (defence in depth: the order of borrows and pin
        releases makes a zero final in the task-argument path)."""
        if not oids:
            return
        with self._free_cv:
            self._free_seq += 1
            heapq.heappush(self._free_heap, (
                time.monotonic() + FREE_GRACE_S, self._free_seq,
                list(oids)))
            self._free_cv.notify()

    def _free_loop(self) -> None:
        while not self._stop.is_set():
            with self._free_cv:
                while not self._stop.is_set() and (
                        not self._free_heap
                        or self._free_heap[0][0] > time.monotonic()):
                    wait = (self._free_heap[0][0] - time.monotonic()
                            if self._free_heap else 0.5)
                    self._free_cv.wait(max(0.01, min(wait, 0.5)))
                if self._stop.is_set():
                    return
                _, _, oids = heapq.heappop(self._free_heap)
            try:
                self._free_if_still_zero(oids)
            except Exception:  # noqa: BLE001 — one batch must not stop it
                logger.exception("freeing %d objects failed", len(oids))

    def _free_if_still_zero(self, oids: List[bytes]) -> None:
        """Free the objects still at zero: one ``FreeObjects`` a node for
        the whole batch."""
        survivors: List[bytes] = []
        by_node: Dict[str, List[bytes]] = defaultdict(list)
        now = time.monotonic()
        with self._lock:
            for oid in oids:
                if self._refcounts.get(oid):
                    continue  # a late increment brought it back
                self._freed[oid] = now
                survivors.append(oid)
                for node_id in self._locations.pop(oid, ()):
                    by_node[node_id].append(oid)
                self._object_sizes.pop(oid, None)
            while len(self._freed) > MAX_FREED_REMEMBERED:
                self._freed.pop(next(iter(self._freed)))
            if survivors:
                self._wal_append(("freed", survivors))
        for node_id, node_oids in by_node.items():
            stub = self._node_stub(node_id)
            if stub is None:
                continue
            try:
                stub.FreeObjects(pb.FreeObjectsRequest(object_ids=node_oids),
                                 timeout=10)
            except Exception:  # noqa: BLE001 — the node went meanwhile
                pass
        for oid in survivors:
            self._publish("OBJECT_FREED", oid)

    # ------------------------------------------------------------- lifecycle
    def shutdown(self):
        """Stop serving: the health loop and placement runs end, the WAL
        flushes and compacts, and every connection closes."""
        self._stop.set()
        with self._free_cv:
            self._free_cv.notify_all()
        timer = getattr(self, "_sweep_timer", None)
        if timer is not None:
            timer.cancel()
        self._work_pool.shutdown(wait=False, cancel_futures=True)
        if self._wal is not None:
            try:
                self._wal.close()  # flush + final compaction
            except Exception:  # noqa: BLE001
                pass
        self._server.stop(grace=5.0)
        deadline = time.monotonic() + 5.0
        for t in self._threads + list(self._work_pool._threads):
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))

    def threads(self) -> List[threading.Thread]:
        """The live threads this server started."""
        return [t for t in self._threads + list(self._work_pool._threads)
                if t.is_alive()]


def main():  # pragma: no cover - exercised as a subprocess
    parser = argparse.ArgumentParser(
        description="the port's GCS head in a process of its own")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--persist-path", default=None)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    server = GcsServer(port=args.port, persist_path=args.persist_path)
    print(f"GCS_PORT={server.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
