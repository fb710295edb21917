"""ClusterRuntime: the :class:`CoreRuntime` of a process connected to a
cluster (the port's copy of ``ray_tpu/_private/runtime/cluster.py``,
``ClusterRuntime`` :222, ``connect`` :361).

Reference: the CoreWorker (``src/ray/core_worker/core_worker.cc``):

* normal tasks follow the lease protocol: lease a worker from the local
  node manager, follow spillback, push the task straight to the leased
  worker, keep the lease briefly for the next task of the same shape
  (``normal_task_submitter.cc:23,88-145,202,538``; the per-signature
  runners and the lease cache, JAX's :1498-1775);
* actor tasks go straight to the actor's worker with per-caller sequence
  numbers (``actor_task_submitter.cc:158,580``); a restart re-resolves the
  address through the GCS (create, resolve, submit, restart and kill:
  JAX's :2241-2520), and named actors resolve by name;
* objects: small results ride inline in the push reply into this
  process's memory store and go to the node store when their ref leaves
  the process; larger ones and puts go to the node store with their
  location in the GCS directory, pulled in chunks across nodes on demand
  (``_fetch_object``, JAX's :754). The node store is the native
  shared-memory store (JAX's :101-145, :515-600): a value over
  ``INLINE_RESULT_MAX`` is written by the putting process into a segment
  of its own (one ``writev``, each out-of-band buffer copied once) and
  only its name and size cross the node's socket; a get on the same node
  maps the segment and deserializes in place, so an array or a tensor in
  the value is a view of the mapping, not a copy;
* streaming generators (``release_stream_tail``, :1443), cancellation
  (:2170-2240), placement groups (:2630-2648), ``nodes()`` and the
  resource views;
* the object plane (JAX's :167-212, :472-504, :754-1000, :1088-1410):
  every live ``ObjectRef`` is counted (:mod:`~ray_tpu_torch._private.
  refcount`), and an object leaves the node stores with its last
  reference in the cluster; the refs a task's payload carries, nested
  ones too, are pinned for its flight and an actor's constructor
  arguments until it settles; the task that made a result stays pinned
  (its lineage) while this process holds a ref to it, so a result whose
  every copy died is made again by resubmitting its task, through its
  lost arguments too, up to three rebuilds a get (``_maybe_reconstruct``);
  a payload over ``INLINE_RESULT_MAX`` rides the store by reference
  (``_maybe_promote_payload``), kept for a rebuild while the lineage
  lives; a task whose argument of ``LOCALITY_MIN_BYTES`` or more lives on
  another node leases there with a soft affinity
  (``_apply_locality_hint``), unless it names its own placement; and
  pulls go through a pull manager (:class:`_PullManager`) that shares
  one pull of an object among its getters and bounds the bytes in
  flight. A borrower of an object the cluster freed gets
  ``ObjectLostError``, as does a getter of a result whose every copy is
  gone and whose lineage this process does not hold.

Left for later: a ``runtime_env`` (item 20c). A segment that cannot be
created raises, naming the object's size: no value falls back to the
socket.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.options import is_streaming
from ray_tpu_torch._private.runtime.interface import CoreRuntime
from ray_tpu_torch._private.refcount import ReferenceCounter
from ray_tpu_torch._private.serialization import (SerializedObject,
                                                  Serializer, loads)
from ray_tpu_torch._private.shm import SEGMENT_PREFIX, ShmClient

logger = logging.getLogger(__name__)

INLINE_RESULT_MAX = 100 * 1024  # reference: >100KB promoted to plasma
PUSH_TIMEOUT_S = 24 * 3600.0


def put_to_node(node_stub, oid_binary: bytes, value, owner: str) -> bool:
    """Store a serialized value (a :class:`SerializedObject` or its bytes)
    in a node's store; False when the node refused it. Over
    ``INLINE_RESULT_MAX`` its bytes go into a segment this process
    creates and only the segment's name rides the RPC (JAX's
    ``put_bytes_to_node``, :101-122); a segment that cannot be created
    raises."""
    parts = value.to_parts() if isinstance(value, SerializedObject) \
        else [value]
    size = value.wire_size() if isinstance(value, SerializedObject) \
        else len(value)
    if size <= INLINE_RESULT_MAX:
        reply = node_stub.PutObject(pb.PutObjectRequest(
            object_id=oid_binary, data=b"".join(parts), owner=owner,
            size=size))
        return not reply.rejected
    # The whole object id: the objects of one task differ only in its
    # last bytes.
    seg = f"/{SEGMENT_PREFIX}{oid_binary.hex()}"
    if not ShmClient.create_segment_vectored(seg, parts):
        raise exceptions.RayTpuError(
            f"could not create a shared-memory segment of {size} bytes "
            f"for object {oid_binary.hex()[:16]} in /dev/shm")
    try:
        reply = node_stub.PutObject(pb.PutObjectRequest(
            object_id=oid_binary, shm_name=seg, size=size, owner=owner))
    except BaseException:
        # Unregistered (or refused, which unlinked it already): nothing
        # else would ever unlink it.
        ShmClient.unlink_segment(seg)
        raise
    return not reply.rejected


def read_object_reply(reply) -> Tuple[bool, Any]:
    """``(found, value)`` of a found ``GetObjectReply``: its segment mapped
    and the value deserialized over the mapping (JAX's :125-145); not
    found when this host has no such segment (it was freed between the
    reply and the map, or it lives on another host)."""
    view = ShmClient.map_segment_view(reply.shm_name, reply.size)
    if view is None:
        return False, None
    return True, loads(view)


def loads_payload(data) -> Tuple[Any, int]:
    """A task payload's value and the number of refs it carries (each
    deserialized ref counts a borrow, which the executor flushes before
    it runs the task: JAX's :87)."""
    s = SerializedObject.parse(data)
    return Serializer().deserialize(s), len(s.contained_refs)


def pull_bytes(node_stub, oid_binary: bytes) -> Optional[bytes]:
    """An object's serialized bytes pulled from a node in chunks; None
    when that node does not hold it."""
    buf = bytearray()
    found = False
    for chunk in node_stub.PullObject(
            pb.PullObjectRequest(object_id=oid_binary), timeout=120.0):
        if not chunk.found:
            break
        found = True
        buf.extend(chunk.data)
        if chunk.eof:
            break
    return bytes(buf) if found else None


def fetch_segment_or_pull(node_stub, oid_binary: bytes) -> Optional[bytes]:
    """An object's serialized bytes from one node: a copy of its segment
    when it maps on this host, else pulled; None when that node does not
    hold it."""
    reply = node_stub.GetObject(pb.GetObjectRequest(object_id=oid_binary))
    if reply.found and reply.shm_name:
        data = ShmClient.read_segment(reply.shm_name, reply.size)
        if data is not None:
            return data
    return pull_bytes(node_stub, oid_binary)


class _PullManager:
    """Receiver-side pull admission (JAX's :167, the reference's
    ``pull_manager.h:53``): bounds the bytes of the pulls in flight in
    this process and shares one pull of an object among its getters."""

    def __init__(self, budget_bytes: int):
        self._budget = max(budget_bytes, 1)
        self._avail = self._budget
        self._cv = threading.Condition()
        self._inflight: Dict[bytes, threading.Event] = {}

    def _cost(self, size: int) -> int:
        return min(max(size, 1), self._budget)

    def begin(self, oid: bytes, size: int, wait_s: float = 60.0):
        """Admit a pull: None when this caller pulls, or the event of the
        pull of the same object already in flight. ``wait_s`` bounds the
        wait for budget (the caller's remaining deadline); past it the
        pull is admitted anyway: admission never extends a timeout, and
        an object over the whole budget is admitted alone."""
        cost = self._cost(size)
        deadline = time.monotonic() + max(wait_s, 0.0)
        with self._cv:
            ev = self._inflight.get(oid)
            if ev is not None:
                return ev
            while self._avail < cost:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=min(remaining, 1.0))
                ev = self._inflight.get(oid)
                if ev is not None:
                    return ev
            self._avail -= cost
            self._inflight[oid] = threading.Event()
            return None

    def end(self, oid: bytes, size: int) -> None:
        with self._cv:
            self._avail += self._cost(size)
            ev = self._inflight.pop(oid, None)
            self._cv.notify_all()
        if ev is not None:
            ev.set()


def _run_callback(cb) -> None:
    try:
        cb()
    except Exception:  # noqa: BLE001 — a future callback must not leak
        logger.exception("future completion callback failed")


def _future_set(fut: Future, value: Any) -> None:
    """Resolve an ObjectRef future with get() semantics."""
    if fut.done():
        return
    if isinstance(value, exceptions.RayTaskError):
        fut.set_exception(value.as_instanceof_cause())
    elif isinstance(value, exceptions.RayTpuError):
        fut.set_exception(value)
    else:
        fut.set_result(value)


# Seconds a produced object may stay unfound before it counts as lost
# (when this process holds no lineage to rebuild it).
LOST_AFTER_S = 5.0
# Rebuilds of one object a get may run (JAX's).
MAX_REBUILDS = 3


class _HexId(str):
    """Node and worker ids are hex strings here; ``.hex()`` is identity
    (the ID protocol the runtime context reads)."""

    def hex(self) -> str:  # type: ignore[override]
        return str(self)


class ClusterRuntime(CoreRuntime):
    def __init__(self, gcs_address: str, node_address: str,
                 namespace: str = "default", is_worker: bool = False,
                 worker_id: Optional[str] = None,
                 node_id: Optional[str] = None):
        self.gcs_address = gcs_address
        self.node_address = node_address
        self.namespace = namespace
        self.is_worker = is_worker
        self.worker_id = worker_id or uuid.uuid4().hex
        self.node_id = _HexId(node_id or "")
        self.job_id = JobID.from_int(1)
        self.gcs = rpc.get_stub("GcsService", gcs_address)
        self.node = rpc.get_stub("NodeService", node_address)
        self.memory = MemoryStore()
        self._spread_idx = 0
        self._spread_lock = threading.Lock()
        self._node_addr_cache = None
        # Background work (task submits, actor pushes, prefetches); submit
        # slots bound the submitters in their RPC-active phase.
        self._pool = ThreadPoolExecutor(max_workers=64,
                                        thread_name_prefix="submit")
        # In-flight local tasks: getters wait on these events (made by the
        # first waiter) and futures register completion callbacks.
        self._pending_results: Dict[bytes, Optional[threading.Event]] = {}
        self._pending_callbacks: Dict[bytes, List] = {}
        self._pending_res_lock = threading.Lock()
        self._sig_queues: Dict[Any, dict] = {}
        self._sig_lock = threading.Lock()
        self._cancel_lock = threading.Lock()
        self._cancelled_tasks: set = set()
        self._running_locs: Dict[bytes, str] = {}
        self._children: Dict[bytes, list] = {}
        # Inline results not yet in the node store (they go there when
        # their ref leaves this process), and the ids that have left.
        self._lazy_results: Dict[bytes, bytes] = {}
        self._escaped_ids: set = set()
        self._task_done: set = set()
        # Objects the directory announced (OBJECT_LOC events carry their
        # ids), and the pulls in flight with their byte budget.
        self._located: set = set()
        self._pulls = _PullManager(int(os.environ.get(
            "RAY_TPU_PULL_BUDGET_BYTES", 512 << 20)))
        # The locality hint's directory cache: oid -> (ts, size, nodes).
        self._loc_cache: Dict[bytes, tuple] = {}
        self._submit_slots = threading.BoundedSemaphore(
            int(os.environ.get("RAY_TPU_SUBMIT_RPC_SLOTS", 8)))
        self._completion_slots = threading.BoundedSemaphore(
            int(os.environ.get("RAY_TPU_SUBMIT_RPC_SLOTS", 8)))
        self._actor_cache: Dict[bytes, pb.ActorInfo] = {}
        self._actor_dead: Dict[bytes, str] = {}
        # An actor's constructor arguments, pinned until it settles.
        self._actor_create_pins: Dict[bytes, List[bytes]] = {}
        # A task's flight pins (the refs its payload carries, a promoted
        # payload), released when its returns complete.
        self._flight_pins: Dict[bytes, List[bytes]] = {}
        self._actor_seq: Dict[bytes, int] = {}
        self._actor_session: Dict[bytes, int] = {}
        self._actor_window: Dict[bytes, dict] = {}
        self._actor_lock = threading.Lock()
        self._put_task_id = TaskID.for_normal_task(self.job_id)
        self._put_index = 0
        self._put_lock = threading.Lock()
        self._shutdown = False
        self._lease_cache: Dict[Any, List[dict]] = {}
        self._lease_cache_lock = threading.Lock()
        self._lease_reaper: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []
        self._sub_stream = None
        # Callbacks of the other channels this process subscribes to (the
        # serve route events), by channel.
        self._channel_cbs: Dict[str, List] = {}
        # Ownership: the counts of this process's live refs go to the GCS,
        # which frees an object when every holder's count is gone; the
        # task that made a result stays pinned (its lineage) while this
        # process holds a ref to it (JAX's :314-341).
        self.refs = ReferenceCounter(self.gcs, self.worker_id,
                                     on_local_zero=self._on_ref_zero,
                                     node_id=node_id or "",
                                     is_driver=not is_worker)
        self._lineage: Dict[bytes, pb.TaskSpec] = {}
        self._lineage_lock = threading.RLock()
        self._reconstructing: Dict[bytes, threading.Event] = {}
        self._task_lineage_count: Dict[bytes, int] = {}
        # task id -> a promoted payload's bytes, kept while the lineage
        # lives, to put again when its only store copy died.
        self._lineage_payload_bytes: Dict[bytes, bytes] = {}
        # GCS pubsub drives actor resolution and object readiness wakeups.
        self._ready_cond = threading.Condition()
        self._spawn(self._subscriber_loop, "gcs-subscriber")

    def _spawn(self, target, name: str) -> threading.Thread:
        t = threading.Thread(target=target, daemon=True, name=name)
        self._threads.append(t)
        t.start()
        return t

    @classmethod
    def connect(cls, address: str,
                namespace: str = "default") -> "ClusterRuntime":
        """A driver's runtime on the cluster whose GCS is at ``address``;
        its local node is the alive node of the lowest id."""
        gcs = rpc.get_stub("GcsService", address)
        try:
            reply = gcs.GetNodes(pb.GetNodesRequest(), timeout=10)
        except rpc.RpcError as e:
            raise ConnectionError(
                f"could not reach the cluster's GCS at {address}: "
                f"{e.details()}") from None
        nodes = [n for n in reply.nodes if n.alive]
        if not nodes:
            raise ConnectionError(f"no alive nodes in cluster at {address}")
        local = sorted(nodes, key=lambda n: n.node_id)[0]
        return cls(address, local.address, namespace=namespace,
                   node_id=local.node_id)

    def _refresh_local_node(self) -> bool:
        """Fail over to another alive node when the local one is gone (a
        driver reconnects; test clusters kill nodes under live drivers)."""
        try:
            nodes = [n for n in
                     self.gcs.GetNodes(pb.GetNodesRequest(), timeout=5).nodes
                     if n.alive]
        except Exception:  # noqa: BLE001
            return False
        if any(n.address == self.node_address for n in nodes):
            return True
        if not nodes:
            return False
        pick = sorted(nodes, key=lambda n: n.node_id)[0]
        logger.warning("local node %s unreachable; failing over to %s",
                       self.node_address, pick.address)
        self.node_address = pick.address
        self.node = rpc.get_stub("NodeService", pick.address)
        self.node_id = _HexId(pick.node_id)
        return True

    # ------------------------------------------------------------- pubsub
    def on_channel(self, channel: str, callback) -> None:
        """``callback(data)`` for each message of ``channel`` (one of
        :data:`EXTRA_CHANNELS`), and ``callback(None)`` once the
        subscription is restored after a broken stream, when messages may
        have been missed."""
        with self._ready_cond:
            self._channel_cbs.setdefault(channel, []).append(callback)

    def _dispatch_channel(self, channel: str, data) -> None:
        with self._ready_cond:
            cbs = list(self._channel_cbs.get(channel, ()))
        for cb in cbs:
            try:
                cb(data)
            except Exception:  # noqa: BLE001 — one bad callback only
                logger.exception("%s callback failed", channel)

    #: Channels subscribed besides the runtime's own: the serve route
    #: events (``runtime/cluster_replica.py``).
    EXTRA_CHANNELS = ("SERVE_ROUTES",)

    def _subscriber_loop(self):
        """ACTOR, OBJECT_LOC and :data:`EXTRA_CHANNELS` (and, on a driver,
        LOG) subscription, resubscribing after a broken stream (a GCS
        restart included)."""
        channels = ["ACTOR", "OBJECT_LOC", *self.EXTRA_CHANNELS]
        if not self.is_worker and \
                os.environ.get("RAY_TPU_LOG_TO_DRIVER", "1") != "0":
            channels.append("LOG")
        resubscribed = False
        while not self._shutdown:
            try:
                stream = self.gcs.Subscribe(pb.SubscribeRequest(
                    channels=channels,
                    subscriber_id=f"rt-{self.worker_id[:12]}"),
                    timeout=3600.0)
                self._sub_stream = stream
                if self._shutdown:
                    stream.cancel()
                    return
                if resubscribed:
                    for ch in self.EXTRA_CHANNELS:
                        self._dispatch_channel(ch, None)
                resubscribed = True
                for msg in stream:
                    if msg.channel == "ACTOR":
                        self._on_actor_event(msg.data)
                    elif msg.channel == "LOG":
                        self._on_log_event(msg.data)
                    elif msg.channel in self.EXTRA_CHANNELS:
                        self._dispatch_channel(msg.channel, msg.data)
                    elif msg.data:
                        if len(self._located) > 100_000:
                            self._located.clear()
                        self._located.add(bytes(msg.data))
                    with self._ready_cond:
                        self._ready_cond.notify_all()
            except Exception:  # noqa: BLE001 — broken stream: resubscribe
                pass
            if self._shutdown:
                return
            time.sleep(0.2)

    def _on_log_event(self, data: bytes) -> None:
        """Print a worker's mirrored output with its identity prefix."""
        import sys

        try:
            rec = pickle.loads(data)
            if rec.get("ns", "default") != self.namespace:
                return
            out = sys.stderr if rec.get("stream") == "stderr" else sys.stdout
            for line in rec.get("lines", ()):
                print(f"({rec.get('name', '?')} pid={rec.get('pid', '?')}) "
                      f"{line}", file=out, flush=True)
        except Exception:  # noqa: BLE001
            pass

    def _on_actor_event(self, data: bytes):
        try:
            info = pb.ActorInfo.FromString(data)
        except Exception:  # noqa: BLE001
            return
        key = bytes(info.actor_id)
        if info.state in ("ALIVE", "DEAD"):
            self._release_create_pins(key)
        with self._actor_lock:
            if info.state == "ALIVE":
                self._actor_cache[key] = info
                self._actor_dead.pop(key, None)
            else:
                self._actor_cache.pop(key, None)
                if info.state == "DEAD":
                    self._actor_dead[key] = \
                        info.death_cause or "actor is dead"
                    while len(self._actor_dead) > 4096:
                        self._actor_dead.pop(next(iter(self._actor_dead)))

    # ------------------------------------------------------------- references
    def add_local_reference(self, ref: ObjectRef) -> None:
        self.refs.incr(ref.id().binary())

    def remove_local_reference(self, object_id) -> None:
        if not self._shutdown:
            self.refs.decr(object_id.binary())

    def _on_ref_zero(self, oid: bytes) -> None:
        """This process's last ref went: evict the in-process copy and
        unpin the lineage (the cluster-wide free is the GCS's, once every
        holder's count is gone)."""
        self.memory.delete([ObjectID(oid)])
        self._lazy_results.pop(oid, None)
        self._escaped_ids.discard(oid)
        payload_oid = None
        with self._lineage_lock:
            spec = self._lineage.pop(oid, None)
            if spec is not None:
                task_key = ObjectID(oid).task_id().binary()
                n = self._task_lineage_count.get(task_key, 0) - 1
                if n <= 0:
                    self._task_lineage_count.pop(task_key, None)
                    self._task_done.discard(task_key)
                    self._reconstructing.pop(task_key, None)
                    self._lineage_payload_bytes.pop(task_key, None)
                    payload_oid = bytes(spec.payload_ref) or None
                else:
                    self._task_lineage_count[task_key] = n
        if payload_oid is not None:
            # The lineage went: its promoted payload can go too.
            self.refs.decr(payload_oid)

    def _pin(self, oids) -> List[bytes]:
        oids = list(oids)
        for ob in oids:
            self.refs.incr(ob)
        return oids

    def _unpin(self, oids) -> None:
        for ob in oids or ():
            self.refs.decr(ob)

    # ---------------------------------------------------------------- objects
    def serialize(self, value: Any) -> SerializedObject:
        """``value`` serialized; the refs it carries leave this process
        with it, so the ones this process holds inline go to the node
        store (their readers look them up in the directory)."""
        s = Serializer().serialize(value)
        if s.contained_refs:
            self._flush_escaped(s.contained_refs)
        return s

    def dumps(self, value: Any) -> bytes:
        """``value`` as the wire's bytes (:meth:`serialize`)."""
        return self.serialize(value).to_bytes()

    def _flush_escaped(self, oid_bins) -> None:
        """Mark refs as escaped (sticky: a ref can leave before its task
        finishes) and store any lazily held bytes of theirs, before the
        value that carries them leaves: a borrower finds the object in
        the store, and its borrow reaches the GCS while the sender's pin
        still holds the count."""
        for ob in oid_bins:
            self._escaped_ids.add(ob)
            data = self._lazy_results.pop(ob, None)
            if data is not None:
                self._store_bytes(ob, data)

    def _store_bytes(self, oid_bin: bytes, data) -> None:
        """Store a serialized value (or its bytes) in the local node's
        store, failing over once to another node when it is gone."""
        try:
            put_to_node(self.node, oid_bin, data, self.worker_id)
        except Exception:  # noqa: BLE001 — local node gone: fail over once
            if not self._refresh_local_node():
                raise
            put_to_node(self.node, oid_bin, data, self.worker_id)

    def put(self, value: Any,
            owner_ref: Optional[ObjectRef] = None) -> ObjectRef:
        # Scoped to a per-process random task id: ids never collide across
        # processes (reference: put index within the caller's task).
        with self._put_lock:
            self._put_index += 1
            index = self._put_index
        oid = ObjectID.from_task(self._put_task_id, index)
        s = self.serialize(value)
        self._store_bytes(oid.binary(), s)
        self.memory.put(oid, value)
        return ObjectRef(oid, owner_address=self.node_address)

    def _fetch_object(self, ref: ObjectRef, deadline=None):
        """Try every known location once: ``(found, value, freed,
        pending)``. ``freed``: the GCS freed the object (its count reached
        zero), so it is gone for good; ``pending``: another thread's pull
        of it is in flight, so a miss is no loss (JAX's :754)."""
        oid = ref.id()
        try:
            reply = self.node.GetObject(
                pb.GetObjectRequest(object_id=oid.binary()))
        except Exception:  # noqa: BLE001 — local node gone
            self._refresh_local_node()
            reply = pb.GetObjectReply(found=False)
        if reply.found:
            found, value = read_object_reply(reply)
            if found:
                self.memory.put(oid, value)
                return True, value, False, False
        candidates = []
        if ref.owner_address() and ref.owner_address() != self.node_address:
            candidates.append(ref.owner_address())
        freed, size = False, 0
        try:
            locs = self.gcs.GetObjectLocations(
                pb.GetObjectLocationsRequest(object_id=oid.binary()))
            freed, size = locs.freed, int(locs.size)
            nodes = self._node_addresses()
            candidates.extend(nodes[nid] for nid in locs.node_ids
                              if nid in nodes)
        except Exception:  # noqa: BLE001
            pass
        candidates = [a for a in dict.fromkeys(candidates)
                      if a != self.node_address]
        if not candidates:
            return False, None, freed, False

        def remaining(cap):
            if deadline is None:
                return cap
            return max(0.0, min(cap, deadline - time.monotonic()))

        waited = self._pulls.begin(oid.binary(), size,
                                   wait_s=remaining(60.0))
        if waited is not None:
            waited.wait(timeout=remaining(120.0))
            try:
                return True, self.memory.get_if_ready(oid), freed, False
            except KeyError:
                return False, None, freed, True
        try:
            for addr in candidates:
                try:
                    # Another node of this host: its segment maps here
                    # too, without a copy (a node elsewhere answers with a
                    # name this host has no segment of: pulled).
                    reply = rpc.get_stub("NodeService", addr).GetObject(
                        pb.GetObjectRequest(object_id=oid.binary()))
                    found, value = read_object_reply(reply) if reply.found \
                        else (False, None)
                    if found:
                        self.memory.put(oid, value)
                        return True, value, freed, False
                    data = pull_bytes(rpc.get_stub("NodeService", addr),
                                      oid.binary())
                except Exception:  # noqa: BLE001
                    continue
                if data is not None:
                    value = loads(data)
                    self.memory.put(oid, value)
                    try:  # kept on this node for its other readers
                        put_to_node(self.node, oid.binary(), data,
                                    self.worker_id)
                    except Exception:  # noqa: BLE001
                        pass
                    return True, value, freed, False
            return False, None, freed, False
        finally:
            self._pulls.end(oid.binary(), size)

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float]) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        for ref in refs:
            value = self._get_one(ref, deadline)
            if isinstance(value, exceptions.RayTaskError):
                raise value.as_instanceof_cause()
            if isinstance(value, exceptions.RayTpuError):
                raise value
            out.append(value)
        return out

    def _get_one(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        oid = ref.id()
        backoff = 0.002
        first_miss = None
        rebuilds = 0
        while True:
            try:
                return self.memory.get_if_ready(oid)
            except KeyError:
                pass
            ev = self._pending_event(oid.binary())
            if ev is not None:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise exceptions.GetTimeoutError(
                        f"Timed out getting object {oid.hex()}")
                ev.wait(5.0 if remaining is None else min(remaining, 5.0))
                continue
            found, value, freed, pending = self._fetch_object(ref,
                                                              deadline)
            if found:
                return value
            if not pending and rebuilds < MAX_REBUILDS and \
                    self._maybe_reconstruct(ref):
                rebuilds += 1
                continue
            with self._lineage_lock:
                has_lineage = oid.binary() in self._lineage
            if freed and not has_lineage:
                raise exceptions.ObjectLostError(message=(
                    f"Object {oid.hex()} was freed cluster-wide (its "
                    f"reference count reached zero or its owner died) "
                    f"and cannot be reconstructed by this process."))
            if oid.task_id().binary() in self._task_done and \
                    not has_lineage:
                # Produced, then every copy went, and nothing here can
                # make it again.
                first_miss = first_miss or time.monotonic()
                if time.monotonic() - first_miss > LOST_AFTER_S:
                    raise exceptions.ObjectLostError(message=(
                        f"Object {oid.hex()} lost every copy and cannot "
                        f"be reconstructed by this process."))
            if deadline is not None and time.monotonic() >= deadline:
                raise exceptions.GetTimeoutError(
                    f"Timed out getting object {oid.hex()}")
            if self._shutdown:
                raise exceptions.RayTpuError(
                    "the runtime shut down before the object arrived")
            # OBJECT_LOC events and local results notify the condition; the
            # timeout only covers events that came before the subscription.
            with self._ready_cond:
                if not self.memory.contains(oid):
                    remaining = (None if deadline is None
                                 else max(0.0, deadline - time.monotonic()))
                    self._ready_cond.wait(backoff if remaining is None
                                          else min(backoff, remaining))
            backoff = min(backoff * 2, 0.5)

    def _maybe_reconstruct(self, ref: ObjectRef, depth: int = 0) -> bool:
        """Run again the task that made a result whose every copy is gone
        (JAX's :911; the reference's ``TaskManager::ResubmitTask``,
        ``task_manager.h:274``), first rebuilding its lost ref arguments.
        Only an owner holding the task's lineage can; True when a rebuild
        ran (the caller fetches again)."""
        oid = ref.id().binary()
        with self._lineage_lock:
            spec = self._lineage.get(oid)
        if spec is None or depth > 10:
            return False
        task_key = bytes(spec.task_id)
        # A miss on a task still running only means pending.
        if task_key not in self._task_done:
            return False
        with self._lineage_lock:
            ev = self._reconstructing.get(task_key)
            leader = ev is None
            if leader:
                ev = self._reconstructing[task_key] = threading.Event()
        if not leader:
            ev.wait(300)
            return True
        try:
            # The directory may lag the task's completion: look again
            # before paying for a run.
            for _ in range(3):
                if self.memory.contains(ref.id()) or \
                        self._fetch_object(ref)[0]:
                    return True
                time.sleep(0.05)
            logger.warning("all copies of %s lost; running task %s (%s) "
                           "again", ref.id().hex()[:12], task_key.hex()[:12],
                           spec.name)
            raw = spec.payload
            if spec.payload_ref:
                # The promoted payload's only copy may have died with its
                # node: put it again from the kept bytes.
                raw = self._lineage_payload_bytes.get(task_key, b"")
                if raw and not self._batch_ready([ObjectRef(
                        ObjectID(bytes(spec.payload_ref)),
                        skip_ref_count=True)]):
                    try:
                        put_to_node(self.node, bytes(spec.payload_ref), raw,
                                    self.worker_id)
                    except Exception:  # noqa: BLE001
                        logger.exception("putting the payload of task %s "
                                         "again failed", task_key.hex()[:12])
            if depth < 10 and raw:
                try:
                    (_, args, kwargs), _ = loads_payload(raw)
                    for a in list(args) + list(kwargs.values()):
                        if isinstance(a, ObjectRef) and \
                                not self._fetch_object(a)[0]:
                            self._maybe_reconstruct(a, depth + 1)
                except Exception:  # noqa: BLE001
                    pass
            return_ids = [ObjectID(b) for b in spec.return_ids]
            self._lease_and_push(spec, return_ids, int(spec.max_retries))
            return True
        finally:
            ev.set()
            with self._lineage_lock:
                self._reconstructing.pop(task_key, None)

    def _batch_ready(self, refs: List[ObjectRef]) -> List[ObjectRef]:
        """Readiness of many refs in O(1) RPCs: this process's store, one
        probe of the local node, one directory probe."""
        ready: List[ObjectRef] = []
        rest: List[ObjectRef] = []
        for r in refs:
            (ready if self.memory.contains(r.id())
             or r.id().binary() in self._located else rest).append(r)
        if not rest:
            return ready
        still = rest
        try:
            reply = self.node.GetObjectsMeta(pb.GetObjectsMetaRequest(
                object_ids=[r.id().binary() for r in rest]))
            if len(reply.found) == len(rest):
                still = []
                for r, f in zip(rest, reply.found):
                    (ready if f else still).append(r)
        except Exception:  # noqa: BLE001
            self._refresh_local_node()
        if still:
            try:
                reply = self.gcs.GetObjectsLocations(pb.GetObjectsMetaRequest(
                    object_ids=[r.id().binary() for r in still]))
                ready.extend(r for r, f in zip(still, reply.found) if f)
            except Exception:  # noqa: BLE001
                pass
        return ready

    def wait(self, refs, num_returns, timeout, fetch_local):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready_ids = set()
        fetching = set()
        while True:
            local_ready, probe = [], []
            with self._pending_res_lock:
                for r in refs:
                    oid = r.id()
                    if oid in ready_ids:
                        continue
                    if self.memory.contains(oid):
                        local_ready.append(r)
                    elif oid.binary() not in self._pending_results:
                        probe.append(r)
            for ref in local_ready + self._batch_ready(probe):
                if len(ready_ids) >= num_returns:
                    break
                ready_ids.add(ref.id())
                if fetch_local and not self.memory.contains(ref.id()) \
                        and ref.id() not in fetching:
                    fetching.add(ref.id())
                    self._submit(self._fetch_object, ref)
            if len(ready_ids) >= num_returns or self._shutdown or (
                    deadline is not None and time.monotonic() >= deadline):
                return ([r for r in refs if r.id() in ready_ids],
                        [r for r in refs if r.id() not in ready_ids])
            with self._ready_cond:
                self._ready_cond.wait(0.05)

    def free(self, refs):
        ids = [r.id().binary() for r in refs]
        self.memory.delete([r.id() for r in refs])
        for ob in ids:
            self._lazy_results.pop(ob, None)
            self._located.discard(ob)
        try:
            for n in self.gcs.GetNodes(pb.GetNodesRequest()).nodes:
                if n.alive:
                    rpc.get_stub("NodeService", n.address).FreeObjects(
                        pb.FreeObjectsRequest(object_ids=ids))
        except Exception:  # noqa: BLE001
            pass

    def _submit(self, fn, *args) -> None:
        try:
            self._pool.submit(fn, *args)
        except RuntimeError:  # the pool closed with the runtime
            pass

    # ---------------------------------------------------------------- tasks
    def _check_options(self, options) -> None:
        if options.runtime_env:
            from ray_tpu_torch._private.worker import ITEM_20C
            from ray_tpu_torch.exceptions import not_ported

            raise not_ported("runtime_env on the cluster runtime", ITEM_20C)

    def submit_task(self, function, function_name, args, kwargs, options):
        self._check_options(options)
        task_id = TaskID.for_normal_task(self.job_id)
        streaming = is_streaming(options.num_returns)
        nreturns = 1 if streaming else max(options.num_returns, 1)
        return_ids = [ObjectID.from_task(task_id, i) for i in range(nreturns)]
        s = self.serialize((function, args, kwargs))
        spec = pb.TaskSpec(
            task_id=task_id.binary(), name=function_name,
            return_ids=[oid.binary() for oid in return_ids],
            max_retries=options.max_retries or 0, returns_stream=streaming,
            resources=options.task_resources())
        payload = s.to_bytes()
        payload_oid = self._maybe_promote_payload(task_id, payload, spec)
        from ray_tpu_torch._private.options import resolve_placement

        pf = resolve_placement(options)
        spec.placement_group_id = pf.placement_group_id
        spec.pg_bundle_index = pf.bundle_index
        spec.pg_capture_child_tasks = pf.capture_child_tasks
        spec.affinity_node_id = pf.affinity_node_id
        spec.affinity_soft = pf.affinity_soft
        spec.strategy = pf.strategy
        spec.label_selector = pf.label_selector
        # Every ref the payload carries (nested ones too) is pinned for
        # the task's flight, so its count cannot reach zero before the
        # worker's borrow; a promoted payload too, and besides pinned as
        # long as the lineage lives (released in _on_ref_zero).
        pins = list(s.contained_refs)
        if payload_oid is not None:
            pins.append(payload_oid)
            self.refs.incr(payload_oid)
        self._flight_pins[task_id.binary()] = self._pin(pins)
        with self._lineage_lock:
            for oid in return_ids:
                self._lineage[oid.binary()] = spec
            self._task_lineage_count[task_id.binary()] = \
                self._task_lineage_count.get(task_id.binary(), 0) + nreturns
            if payload_oid is not None:
                self._lineage_payload_bytes[task_id.binary()] = payload
        self._register_pending(return_ids)
        # Child registry for recursive cancellation.
        from ray_tpu_torch._private.runtime.local import current_task_context

        pctx = current_task_context()
        if pctx is not None and pctx.task_id is not None:
            with self._cancel_lock:
                self._children.setdefault(pctx.task_id.binary(), []).append(
                    (task_id.binary(), [o.binary() for o in return_ids]))
        # The refs first: a result that comes back before they exist
        # would find none and not be kept.
        refs = [ObjectRef(oid, owner_address=self.node_address)
                for oid in return_ids]
        # A task is dispatched once its direct ObjectRef args exist
        # (reference: dependency_resolver.h), so dependents never hold
        # workers waiting on producers.
        deps = [a for a in list(args) + list(kwargs.values())
                if isinstance(a, ObjectRef)]
        retries = options.max_retries or 0
        if any(not self.memory.contains(r.id()) for r in deps):
            self._submit(self._wait_deps_then_dispatch, deps, spec,
                         return_ids, retries)
        else:
            self._apply_locality_hint(spec, deps)
            self._dispatch_task(spec, return_ids, retries)
        return refs

    # Locality-aware lease targeting (reference: LocalityAwareLeasePolicy,
    # ``core_worker/lease_policy.h:58``; JAX's :1180-1238): only argument
    # bytes at least this large steer the lease, below it a pull costs
    # less than giving up lease reuse.
    LOCALITY_MIN_BYTES = 100 * 1024
    LOCALITY_CACHE_TTL_S = 5.0

    def _dep_locations(self, oid: ObjectID):
        """``(size, node_ids)`` from the GCS directory, cached for a few
        seconds: a fan-out of tasks sharing one large argument pays one
        directory call."""
        key = oid.binary()
        now = time.monotonic()
        hit = self._loc_cache.get(key)
        if hit is not None and now - hit[0] < self.LOCALITY_CACHE_TTL_S:
            return hit[1], hit[2]
        try:
            locs = self.gcs.GetObjectLocations(
                pb.GetObjectLocationsRequest(object_id=key))
        except Exception:  # noqa: BLE001 — no directory answer: no hint
            return 0, ()
        size = 0 if locs.freed else locs.size
        node_ids = tuple(locs.node_ids)
        if len(self._loc_cache) > 4096:
            self._loc_cache.clear()
        self._loc_cache[key] = (now, size, node_ids)
        return size, node_ids

    def _apply_locality_hint(self, spec: pb.TaskSpec,
                             deps: List[ObjectRef]) -> None:
        """Lease on the node holding the most bytes of the task's
        arguments, as a soft affinity (spillback handles a full node):
        a task whose 1 GB argument lives on node B runs on B instead of
        pulling it. An explicit placement wins."""
        if (spec.placement_group_id or spec.affinity_node_id
                or spec.strategy or spec.label_selector or not deps):
            return
        per_node: Dict[str, int] = {}
        local_bytes = 0
        for ref in deps[:4]:  # a bounded directory cost a submit
            oid = ref.id()
            if self.memory.contains(oid):
                continue  # in this process: no pull either way
            size, node_ids = self._dep_locations(oid)
            if not size:
                continue
            for nid in node_ids:
                if nid == self.node_id:
                    local_bytes += size
                else:
                    per_node[nid] = per_node.get(nid, 0) + size
        if not per_node:
            return
        best, best_bytes = max(per_node.items(), key=lambda kv: kv[1])
        if best_bytes >= self.LOCALITY_MIN_BYTES and best_bytes > local_bytes:
            spec.affinity_node_id = best
            spec.affinity_soft = True

    def _wait_deps_then_dispatch(self, deps, spec, return_ids, retries):
        deadline = time.monotonic() + 300.0
        all_deps = list(deps)
        while not self._shutdown and time.monotonic() < deadline:
            if self._task_cancelled(bytes(spec.task_id)):
                self._store_cancelled(spec, return_ids)
                return
            unready, probe = [], []
            for ref in deps:
                if self.memory.contains(ref.id()):
                    continue
                with self._pending_res_lock:
                    pending = ref.id().binary() in self._pending_results
                (unready if pending else probe).append(ref)
            if probe:
                ready = {r.id() for r in self._batch_ready(probe)}
                unready.extend(r for r in probe if r.id() not in ready)
            if not unready:
                break
            deps = unready
            with self._ready_cond:
                self._ready_cond.wait(0.05)
        # The hint after the deps exist: their locations are known now.
        self._apply_locality_hint(spec, all_deps)
        self._dispatch_task(spec, return_ids, retries)

    def _register_pending(self, return_ids: List[ObjectID]) -> None:
        with self._pending_res_lock:
            for oid in return_ids:
                self._pending_results[oid.binary()] = None

    def _pending_event(self, oid_bin: bytes) -> Optional[threading.Event]:
        with self._pending_res_lock:
            if oid_bin not in self._pending_results:
                return None
            ev = self._pending_results[oid_bin]
            if ev is None:
                ev = self._pending_results[oid_bin] = threading.Event()
            return ev

    def _complete_pending(self, return_ids) -> None:
        """Wake the task's getters and run its futures' callbacks; its
        flight pins go (after its worker flushed its borrows)."""
        cbs: List = []
        if return_ids:
            first = return_ids[0]
            first = first if hasattr(first, "task_id") else ObjectID(first)
            self._unpin(self._flight_pins.pop(first.task_id().binary(),
                                              None))
        with self._pending_res_lock:
            evs = set()
            for oid in return_ids:
                ob = oid.binary() if hasattr(oid, "binary") else oid
                evs.add(self._pending_results.pop(ob, None))
                cbs.extend(self._pending_callbacks.pop(ob, ()))
        for ev in evs:
            if ev is not None:
                ev.set()
        for cb in cbs:
            # Off this thread: user done-callbacks may block.
            try:
                self._pool.submit(_run_callback, cb)
            except RuntimeError:
                _run_callback(cb)
        with self._ready_cond:
            self._ready_cond.notify_all()

    PAYLOAD_INDEX = (1 << 30) - 1   # the object index of a task's payload

    def _maybe_promote_payload(self, task_id: TaskID, payload: bytes,
                               spec: pb.TaskSpec) -> Optional[bytes]:
        """A payload over ``INLINE_RESULT_MAX`` goes into the node store
        (a segment of this process) and the task carries its id (JAX's
        :1334, the reference's ``core_worker.cc:1527``): a retry, a
        spillback or a rebuild ships an id, not the bytes. Its object id,
        which the caller pins, or None when it rides inline."""
        if len(payload) <= INLINE_RESULT_MAX:
            spec.payload = payload
            return None
        oid = ObjectID.from_task(task_id, self.PAYLOAD_INDEX).binary()
        self._store_bytes(oid, payload)
        spec.payload_ref = oid
        return oid

    def fetch_object_bytes(self, oid_binary: bytes,
                           timeout: float = 120.0) -> Optional[bytes]:
        """A store object's serialized bytes (a promoted payload): from
        this node, else from a node the directory names; None when it was
        freed or did not appear in ``timeout``."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not self._shutdown:
            try:
                data = fetch_segment_or_pull(self.node, oid_binary)
                if data is not None:
                    return data
            except Exception:  # noqa: BLE001
                self._refresh_local_node()
            try:
                locs = self.gcs.GetObjectLocations(
                    pb.GetObjectLocationsRequest(object_id=oid_binary))
                if locs.freed:
                    return None
                nodes = self._node_addresses()
                for nid in locs.node_ids:
                    if nid in nodes:
                        data = fetch_segment_or_pull(
                            rpc.get_stub("NodeService", nodes[nid]),
                            oid_binary)
                        if data is not None:
                            return data
            except Exception:  # noqa: BLE001
                pass
            time.sleep(0.05)
        return None

    def release_stream_tail(self, length_ref: ObjectRef,
                            from_index: int) -> None:
        """Free the unconsumed items of an abandoned ObjectRefGenerator once
        its producer has finished (reference: ObjectRefStream deletion,
        ``task_manager.h:104``; JAX frees them through its refcounts)."""
        task_id = length_ref.task_id()

        def _reap():
            from ray_tpu_torch._private.object_ref import STREAM_INDEX_BASE

            try:
                while not self._shutdown:
                    ready, _ = self.wait([length_ref], 1, 60.0, True)
                    if ready:
                        break
                else:
                    return
                n = int(self.get([length_ref], timeout=30)[0])
            except Exception:  # noqa: BLE001 — the stream failed
                return
            tail = [ObjectRef(ObjectID.from_task(task_id,
                                                 STREAM_INDEX_BASE + i),
                              skip_ref_count=True)
                    for i in range(from_index, n)]
            if tail and not self._shutdown:
                self.free(tail)

        self._spawn(_reap, "stream-reaper")

    # ------------------------------------------------------ lease caching
    # Granted leases are kept for a short idle window and same-shaped
    # tasks pipeline onto them (normal_task_submitter.cc:88-145).
    LEASE_CACHE_TTL_S = 0.2
    MAX_SIG_RUNNERS = int(os.environ.get("RAY_TPU_SIG_RUNNERS", 16))
    SIG_PUSH_BATCH = 16

    def _lease_signature(self, spec: pb.TaskSpec):
        """Cache key, or None for placement-specific leases (PG, affinity,
        SPREAD)."""
        if spec.placement_group_id or spec.affinity_node_id or \
                spec.strategy == "SPREAD":
            return None
        return (tuple(sorted(spec.resources.items())),
                bytes(spec.label_selector))

    def _take_cached_lease(self, sig) -> Optional[dict]:
        with self._lease_cache_lock:
            lst = self._lease_cache.get(sig)
            return lst.pop() if lst else None

    def _has_cached_lease(self, sig) -> bool:
        with self._lease_cache_lock:
            return bool(self._lease_cache.get(sig))

    def _cache_lease(self, sig, lease: dict) -> bool:
        lease["ts"] = time.monotonic()
        with self._lease_cache_lock:
            if self._shutdown:
                return False
            self._lease_cache.setdefault(sig, []).append(lease)
            if self._lease_reaper is None:
                self._lease_reaper = self._spawn(self._lease_reaper_loop,
                                                 "lease-reaper")
            return True

    def _lease_reaper_loop(self):
        while not self._shutdown:
            time.sleep(0.05)
            now = time.monotonic()
            expired = []
            with self._lease_cache_lock:
                for sig, lst in list(self._lease_cache.items()):
                    keep = [l for l in lst
                            if now - l["ts"] <= self.LEASE_CACHE_TTL_S]
                    expired.extend(l for l in lst if l not in keep)
                    if keep:
                        self._lease_cache[sig] = keep
                    else:
                        self._lease_cache.pop(sig, None)
            for lease in expired:
                self._return_lease(lease)

    def _return_lease(self, lease: dict) -> None:
        try:
            lease["node"].ReturnWorker(pb.ReturnWorkerRequest(
                worker_id=lease["worker_id"]), timeout=10)
        except Exception:  # noqa: BLE001
            pass

    def _drain_lease_cache(self) -> None:
        with self._lease_cache_lock:
            leases = [l for lst in self._lease_cache.values() for l in lst]
            self._lease_cache.clear()
        for lease in leases:
            self._return_lease(lease)

    # ------------------------------------------------- lease-runner queues
    def _dispatch_task(self, spec: pb.TaskSpec, return_ids: List[ObjectID],
                       retries: int):
        """One queue per lease signature, drained by a bounded set of
        runner threads that each hold one lease (a 1,000-task fan-out pays
        a handful of lease negotiations)."""
        sig = self._lease_signature(spec)
        if sig is None:
            self._submit(self._lease_and_push, spec, return_ids, retries)
            return
        item = [spec, return_ids, retries, 0]
        with self._sig_lock:
            st = self._sig_queues.setdefault(sig, {"items": [],
                                                   "runners": 0})
            st["items"].append(item)
            spawn = st["runners"] < self.MAX_SIG_RUNNERS
            if spawn:
                st["runners"] += 1
        if spawn:
            try:
                self._pool.submit(self._sig_runner_loop, sig, st)
            except RuntimeError:
                with self._sig_lock:
                    st["runners"] -= 1

    def _sig_runner_loop(self, sig, st: dict) -> None:
        lease = None
        lease_cached = False
        while True:
            with self._sig_lock:
                if self._shutdown or not st["items"]:
                    st["runners"] -= 1
                    break
                items = st["items"][:self.SIG_PUSH_BATCH]
                del st["items"][:len(items)]
            live = []
            for item in items:
                if self._task_cancelled(bytes(item[0].task_id)):
                    self._store_cancelled(item[0], item[1])
                else:
                    live.append(item)
            if not live:
                continue
            spec, return_ids = live[0][0], live[0][1]
            try:
                if lease is None:
                    lease = self._take_cached_lease(sig)
                    lease_cached = lease is not None
                if lease is None:
                    lease = self._negotiate_lease(spec, sig)
                    lease_cached = False
                    if lease is None:  # a cached lease appeared: use it
                        with self._sig_lock:
                            st["items"][:0] = live
                        continue
                if self._push_batch_on_lease(live, lease):
                    continue
                # The worker died mid-push (or a stale cached lease).
                self._return_lease(lease)
                lease = None
                requeue = []
                for item in live:
                    if not lease_cached:
                        item[3] += 1
                    if item[3] <= max(item[2], 3):
                        requeue.append(item)
                    else:
                        self._store_error(exceptions.RayTaskError(
                            item[0].name,
                            f"Worker executing {item[0].name} died"),
                            item[1])
                if requeue:
                    with self._sig_lock:
                        st["items"][:0] = requeue
            except exceptions.TaskCancelledError:
                self._store_cancelled(spec, return_ids)
                if len(live) > 1:
                    with self._sig_lock:
                        st["items"][:0] = live[1:]
            except BaseException as e:  # noqa: BLE001
                for item in live:
                    self._store_error(exceptions.RayTaskError.from_exception(
                        e, item[0].name), item[1])
        if lease is not None and not self._cache_lease(sig, lease):
            self._return_lease(lease)

    def _push_batch_on_lease(self, items: List[list], lease: dict) -> bool:
        """Push same-signature tasks to one leased worker; False when the
        worker died (every item goes through the retry gate)."""
        if len(items) == 1:
            return self._push_on_lease(items[0][0], items[0][1], lease)
        for item in items:
            item[0].card_ids = list(lease["card_ids"])
            self._running_locs[bytes(item[0].task_id)] = \
                lease["worker_address"]
        try:
            reply = rpc.get_stub("WorkerService",
                                 lease["worker_address"]).PushTaskBatch(
                pb.PushTaskBatchRequest(specs=[i[0] for i in items]),
                timeout=PUSH_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — may have run: retry gate
            return False
        finally:
            for item in items:
                self._running_locs.pop(bytes(item[0].task_id), None)
        if len(reply.results) != len(items):
            return False
        with self._completion_slots:
            for item, result in zip(items, reply.results):
                self._apply_push_result(result, item[1], item[0].name)
        if self._cancelled_tasks:
            with self._cancel_lock:
                for item in items:
                    self._cancelled_tasks.discard(bytes(item[0].task_id))
        return True

    def _lease_and_push(self, spec: pb.TaskSpec, return_ids: List[ObjectID],
                        retries: int):
        """A placement-specific task: a lease of its own per attempt."""
        try:
            attempt = 0
            while True:
                if self._task_cancelled(bytes(spec.task_id)):
                    self._store_cancelled(spec, return_ids)
                    return
                lease = self._negotiate_lease(spec, None)
                ok = self._push_on_lease(spec, return_ids, lease)
                self._return_lease(lease)
                if ok:
                    return
                # System failures retry by default (reference semantics).
                if attempt < max(retries, 3):
                    attempt += 1
                    time.sleep(0.05)
                    continue
                self._store_error(exceptions.RayTaskError(
                    spec.name, f"Worker executing {spec.name} died"),
                    return_ids)
                return
        except exceptions.TaskCancelledError:
            self._store_cancelled(spec, return_ids)
        except BaseException as e:  # noqa: BLE001
            self._store_error(
                exceptions.RayTaskError.from_exception(e, spec.name),
                return_ids)

    NODE_ADDR_TTL_S = 1.0

    def _node_addresses(self) -> Dict[str, str]:
        now = time.monotonic()
        cached = self._node_addr_cache
        if cached is not None and now - cached[0] < self.NODE_ADDR_TTL_S:
            return cached[1]
        addrs = {n.node_id: n.address
                 for n in self.gcs.GetNodes(pb.GetNodesRequest()).nodes
                 if n.alive}
        self._node_addr_cache = (now, addrs)
        return addrs

    def _pg_lease_targets(self, spec: pb.TaskSpec) -> List[Any]:
        """Stubs of the nodes holding the target bundle(s), once the group
        is placed (reference: WaitPlacementGroupReady)."""
        gid = bytes(spec.placement_group_id)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            reply = self.gcs.GetPlacementGroup(
                pb.GetPlacementGroupRequest(group_id=gid))
            if not reply.found:
                raise exceptions.RayTpuError(
                    f"Task {spec.name} targets placement group "
                    f"{gid.hex()[:12]} which does not exist")
            info = reply.info
            if info.state == "REMOVED":
                raise exceptions.RayTpuError(
                    f"Task {spec.name} targets removed placement group "
                    f"{gid.hex()[:12]}")
            if info.state == "INFEASIBLE":
                raise exceptions.RayTpuError(
                    f"Placement group {gid.hex()[:12]} is infeasible; "
                    f"task {spec.name} can never be placed")
            if info.state == "CREATED":
                node_ids = list(dict.fromkeys(
                    b.node_id for b in info.bundles if b.node_id and (
                        spec.pg_bundle_index < 0
                        or b.index == spec.pg_bundle_index)))
                addrs = self._node_addresses()
                stubs = [rpc.get_stub("NodeService", addrs[nid])
                         for nid in node_ids if nid in addrs]
                if stubs:
                    return stubs
            time.sleep(0.05)
        raise exceptions.RayTpuError(
            f"Timed out waiting for placement group {gid.hex()[:12]} "
            f"to be placed (task {spec.name})")

    def _affinity_target(self, spec: pb.TaskSpec):
        addr = self._node_addresses().get(spec.affinity_node_id)
        if addr is None:
            # A node added since the cached read: read the table again.
            self._node_addr_cache = None
            addr = self._node_addresses().get(spec.affinity_node_id)
        if addr is not None:
            return rpc.get_stub("NodeService", addr)
        if spec.affinity_soft:
            return self.node
        raise exceptions.RayTpuError(
            f"Task {spec.name} has hard node affinity to "
            f"{spec.affinity_node_id[:8]} which is not alive")

    def _push_on_lease(self, spec: pb.TaskSpec, return_ids: List[ObjectID],
                       lease: dict) -> bool:
        """Push one task to a leased worker and apply its result; False
        when the worker died (the task may or may not have run)."""
        tid = bytes(spec.task_id)
        if self._task_cancelled(tid):
            self._store_cancelled(spec, return_ids)
            return True
        spec.card_ids = list(lease["card_ids"])
        self._running_locs[tid] = lease["worker_address"]
        try:
            result = rpc.get_stub("WorkerService",
                                  lease["worker_address"]).PushTask(
                pb.PushTaskRequest(spec=spec), timeout=PUSH_TIMEOUT_S)
        except Exception:  # noqa: BLE001 — worker gone or chaos
            return False
        finally:
            self._running_locs.pop(tid, None)
        with self._completion_slots:
            self._apply_push_result(result, return_ids, spec.name)
        if self._cancelled_tasks:
            with self._cancel_lock:
                self._cancelled_tasks.discard(tid)
        return True

    def _next_spread_target(self):
        try:
            addrs = sorted(self._node_addresses().values())
        except Exception:  # noqa: BLE001
            return self.node
        if not addrs:
            return self.node
        with self._spread_lock:
            self._spread_idx = (self._spread_idx + 1) % len(addrs)
            addr = addrs[self._spread_idx]
        return rpc.get_stub("NodeService", addr)

    def _negotiate_lease(self, spec: pb.TaskSpec, sig) -> Optional[dict]:
        """A fresh worker lease, under a submit slot. None when a cached
        lease of the same signature appeared meanwhile (the caller takes
        that one: without this, every worker can end up parked in the
        cache while every negotiator waits for one)."""
        self._submit_slots.acquire()
        slot_acquired = time.monotonic()
        try:
            pg_targets: List[Any] = []
            if spec.placement_group_id:
                pg_targets = self._pg_lease_targets(spec)
                target = pg_targets[0]
            elif spec.affinity_node_id:
                target = self._affinity_target(spec)
            elif spec.strategy == "SPREAD":
                target = self._next_spread_target()
            else:
                target = self.node
            deadline = time.monotonic() + 300.0
            backoff = 0.01
            spillbacks = 0
            while True:
                if self._shutdown:
                    raise exceptions.RayTpuError("the runtime shut down")
                if self._task_cancelled(bytes(spec.task_id)):
                    raise exceptions.TaskCancelledError(
                        TaskID(bytes(spec.task_id)))
                if sig is not None and self._has_cached_lease(sig):
                    return None
                # Fairness: a capacity-starved negotiation cycles its slot.
                if time.monotonic() - slot_acquired > 2.0:
                    self._submit_slots.release()
                    time.sleep(0.005)
                    self._submit_slots.acquire()
                    slot_acquired = time.monotonic()
                try:
                    reply = target.RequestWorkerLease(
                        pb.LeaseRequest(spec=spec))
                except Exception:  # noqa: BLE001 — lease target died
                    if spec.placement_group_id:
                        time.sleep(0.1)
                        pg_targets = self._pg_lease_targets(spec)
                        target = pg_targets[0]
                        continue
                    if spec.affinity_node_id and not spec.affinity_soft:
                        raise exceptions.RayTpuError(
                            f"Node {spec.affinity_node_id[:8]} died while "
                            f"task {spec.name} was pinned to it")
                    if not self._refresh_local_node():
                        raise exceptions.RayTpuError(
                            "no alive nodes in cluster")
                    target = self.node
                    continue
                if reply.granted:
                    break
                if reply.error == "infeasible":
                    where = ("placement group bundle"
                             if spec.placement_group_id else "cluster node")
                    raise exceptions.RayTpuError(
                        f"Task {spec.name} demands {dict(spec.resources)} "
                        f"which no {where} can ever satisfy.")
                if reply.error == "pg-unknown":
                    time.sleep(0.05)
                    pg_targets = self._pg_lease_targets(spec)
                    target = pg_targets[0]
                    continue
                if reply.error == "pg-wait" and len(pg_targets) > 1:
                    pg_targets = pg_targets[1:] + pg_targets[:1]
                    target = pg_targets[0]
                if reply.spillback_address:
                    target = rpc.get_stub("NodeService",
                                          reply.spillback_address)
                    # Damp spillback ping-pong between stale views.
                    spillbacks += 1
                    if spillbacks % 8 == 0:
                        time.sleep(min(0.05 * (spillbacks // 8), 0.5))
                    continue
                if time.monotonic() > deadline:
                    raise exceptions.RayTpuError(
                        f"Timed out leasing a worker for {spec.name}")
                time.sleep(backoff)
                backoff = min(backoff * 1.5, 0.1)
            return {"node": target, "worker_id": reply.worker_id,
                    "worker_address": reply.worker_address,
                    "card_ids": list(reply.card_ids)}
        finally:
            self._submit_slots.release()

    def _apply_push_result(self, result: pb.PushTaskResult,
                           return_ids: List[ObjectID], name: str):
        if not result.ok:
            err = loads(result.error) if result.error else \
                exceptions.RayTaskError(name, "task failed")
            self._store_error(err, return_ids)
            return
        for i, oid in enumerate(return_ids):
            if i < len(result.in_store) and result.in_store[i]:
                continue  # a large result: fetched from the store on demand
            if self._unreferenced(oid.binary()):
                continue
            data = result.inline_results[i]
            self.memory.put(oid, loads(data))
            # Stored lazily: only a ref that leaves this process needs the
            # node store. Store first, then check: a concurrent
            # _flush_escaped adds to the set before it pops.
            ob = oid.binary()
            self._lazy_results[ob] = data
            if ob in self._escaped_ids:
                taken = self._lazy_results.pop(ob, None)
                if taken is not None:
                    self._store_bytes(ob, taken)
        if return_ids:
            self._task_done.add(return_ids[0].task_id().binary())
        self._complete_pending(return_ids)

    def _unreferenced(self, ob: bytes) -> bool:
        """A result no ref of this process names and none took out of it:
        nothing can read it, so it is not kept (its refs went before the
        task finished)."""
        return ob not in self._escaped_ids and self.refs.local_count(ob) == 0

    def _store_error(self, err, return_ids):
        try:
            blob = self.dumps(err)
        except Exception:  # noqa: BLE001 — unpicklable error chain
            blob = None
        for oid in return_ids:
            if self._unreferenced(oid.binary()):
                continue
            self.memory.put(oid, err)
            if blob is not None:
                self._lazy_results[oid.binary()] = blob
                if oid.binary() in self._escaped_ids:
                    self._flush_escaped([oid.binary()])
        if return_ids:
            self._task_done.add(return_ids[0].task_id().binary())
        self._complete_pending(return_ids)

    # ---------------------------------------------------------- cancellation
    def cancel(self, ref, force, recursive):
        """Cancel a task (reference: ``CoreWorker::CancelTask``,
        ``core_worker.h:961``): a pending task is dropped where it waits; a
        running one gets a CancelTask RPC to its worker; a finished one is
        left as it is."""
        self._cancel_task(ref.task_id().binary(), [ref.id().binary()],
                          force, recursive)

    def _task_cancelled(self, tid: bytes) -> bool:
        if not self._cancelled_tasks:
            return False
        with self._cancel_lock:
            return bytes(tid) in self._cancelled_tasks

    def _store_cancelled(self, spec, return_ids) -> None:
        tid = bytes(spec.task_id)
        self._store_error(exceptions.TaskCancelledError(TaskID(tid)),
                          return_ids)
        with self._cancel_lock:
            self._cancelled_tasks.discard(tid)

    def _cancel_task(self, tid: bytes, oid_bins: List[bytes], force: bool,
                     recursive: bool) -> None:
        if tid in self._task_done:
            return
        with self._cancel_lock:
            self._cancelled_tasks.add(tid)
            loc = self._running_locs.get(tid)
            children = list(self._children.get(tid, ())) if recursive \
                else []
        if loc:
            try:
                rpc.get_stub("WorkerService", loc).CancelTask(
                    pb.CancelTaskRequest(task_id=tid, force=force,
                                         recursive=recursive), timeout=10)
            except Exception:  # noqa: BLE001 — the worker already went
                pass
        for ctid, coids in children:
            self._cancel_task(ctid, coids, force, True)

    def cancel_children(self, parent_tid: bytes, force: bool) -> None:
        """Cancel every task a locally executing task submitted."""
        with self._cancel_lock:
            children = list(self._children.pop(parent_tid, ()))
        for ctid, coids in children:
            self._cancel_task(ctid, coids, force, True)

    def drop_children(self, parent_tid: bytes) -> None:
        with self._cancel_lock:
            self._children.pop(parent_tid, None)

    # ---------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, options) -> ActorID:
        self._check_options(options)
        actor_id = ActorID.of(self.job_id)
        from ray_tpu_torch._private.options import resolve_placement

        pf = resolve_placement(options)
        s = self.serialize((cls, args, kwargs, options))
        spec = pickle.dumps({
            "resources": dict(options.task_resources()),
            "payload": s.to_bytes(),
            "pg": ((pf.placement_group_id, pf.bundle_index)
                   if pf.placement_group_id else None),
            "pg_capture": pf.capture_child_tasks,
            "labels": pf.label_selector.decode() if pf.label_selector
            else None,
            "affinity": ((pf.affinity_node_id, pf.affinity_soft)
                         if pf.affinity_node_id else None),
            "strategy": pf.strategy,
        })
        # The constructor's refs stay pinned until the actor settles
        # (ALIVE after its constructor's borrows, or DEAD): placement can
        # outlast the caller's last ref.
        if s.contained_refs:
            with self._actor_lock:
                self._actor_create_pins[actor_id.binary()] = self._pin(
                    s.contained_refs)
        reply = self.gcs.RegisterActor(pb.RegisterActorRequest(
            info=pb.ActorInfo(
                actor_id=actor_id.binary(), name=options.name or "",
                namespace=options.namespace or self.namespace,
                class_name=cls.__name__, state="PENDING",
                max_restarts=options.max_restarts, spec=spec)))
        if not reply.ok:
            raise ValueError(reply.error)
        return actor_id

    def _release_create_pins(self, actor_key: bytes) -> None:
        with self._actor_lock:
            pins = self._actor_create_pins.pop(actor_key, None)
        self._unpin(pins)

    def _resolve_actor(self, actor_id: ActorID,
                       timeout_s: float = 600.0) -> pb.ActorInfo:
        """The actor's worker address: one GetActor, then waits on ACTOR
        events with a periodic GCS refresh."""
        key = actor_id.binary()
        deadline = time.monotonic() + timeout_s
        checked_gcs = False
        while True:
            with self._actor_lock:
                info = self._actor_cache.get(key)
                dead = self._actor_dead.get(key)
            if info is not None and info.state == "ALIVE":
                return info
            if dead is not None:
                raise exceptions.ActorDiedError(actor_id, dead)
            if not checked_gcs:
                checked_gcs = True
                try:
                    reply = self.gcs.GetActor(
                        pb.GetActorRequest(actor_id=key))
                except rpc.RpcError:  # the GCS restarting: retry
                    reply = pb.GetActorReply(found=False)
                if reply.found and reply.info.state in ("ALIVE", "DEAD"):
                    # Settled (releases the constructor's pins too).
                    self._on_actor_event(reply.info.SerializeToString())
                    continue
            if self._shutdown or time.monotonic() > deadline:
                raise exceptions.GetTimeoutError(
                    f"Actor {actor_id.hex()} not ALIVE within {timeout_s}s")
            with self._ready_cond:
                self._ready_cond.wait(timeout=1.0)
            checked_gcs = False

    def submit_actor_task(self, actor_id, method_name, args, kwargs,
                          options):
        task_id = TaskID.for_actor_task(actor_id)
        streaming = is_streaming(options.num_returns)
        nreturns = 1 if streaming else max(options.num_returns, 1)
        return_ids = [ObjectID.from_task(task_id, i) for i in range(nreturns)]
        # Sequence numbers are scoped to a caller session, which rotates
        # when the cached address is invalidated: a restarted actor sees
        # the new session start from 0.
        with self._actor_lock:
            session = self._actor_session.get(actor_id.binary(), 0)
            seq = self._actor_seq.get(actor_id.binary(), 0)
            self._actor_seq[actor_id.binary()] = seq + 1
        if getattr(options, "_is_async_actor", False):
            from ray_tpu_torch._private.concurrency import \
                effective_max_concurrency

            eff = effective_max_concurrency(True, options.max_concurrency)
            st = self._actor_window_state(actor_id.binary())
            st["window"] = max(self.ACTOR_SEND_WINDOW,
                               min(eff, self.ASYNC_ACTOR_SEND_WINDOW_MAX))
        s = self.serialize((None, args, kwargs))
        spec = pb.TaskSpec(
            task_id=task_id.binary(), name=method_name,
            method_name=method_name,
            return_ids=[oid.binary() for oid in return_ids],
            actor_id=actor_id.binary(), sequence_no=seq,
            caller_address=f"{self.worker_id}:{session}".encode(),
            returns_stream=streaming)
        payload_oid = self._maybe_promote_payload(task_id, s.to_bytes(), spec)
        # Pinned for the push, as a task's (actor tasks keep no lineage).
        pins = list(s.contained_refs)
        if payload_oid is not None:
            pins.append(payload_oid)
        self._flight_pins[task_id.binary()] = self._pin(pins)
        self._register_pending(return_ids)
        refs = [ObjectRef(oid, owner_address=self.node_address)
                for oid in return_ids]   # before a result can come back
        self._submit(self._push_actor_task, actor_id, spec, return_ids,
                     options.max_task_retries)
        return refs

    def _invalidate_actor(self, actor_id: ActorID):
        with self._actor_lock:
            self._actor_cache.pop(actor_id.binary(), None)
            self._actor_session[actor_id.binary()] = \
                self._actor_session.get(actor_id.binary(), 0) + 1
            self._actor_seq[actor_id.binary()] = 0
            st = self._actor_window.get(actor_id.binary())
        if st is not None:
            with st["cond"]:
                st["done"] = 0
                st["cond"].notify_all()

    # Max concurrent pushes per actor (each ordered push holds a worker
    # thread until its turn); async actors hold a push open for the whole
    # await, so their window is their concurrency as one caller sees it.
    ACTOR_SEND_WINDOW = 16
    ASYNC_ACTOR_SEND_WINDOW_MAX = 48

    def _actor_window_state(self, aid: bytes) -> dict:
        with self._actor_lock:
            st = self._actor_window.get(aid)
            if st is None:
                st = self._actor_window[aid] = {
                    "cond": threading.Condition(), "done": 0,
                    "window": self.ACTOR_SEND_WINDOW}
            return st

    def _push_actor_task(self, actor_id: ActorID, spec: pb.TaskSpec,
                         return_ids: List[ObjectID], retries: int):
        attempt = 0
        st = self._actor_window_state(actor_id.binary())
        seq = spec.sequence_no
        gate_deadline = time.monotonic() + 120.0
        tid = bytes(spec.task_id)
        with st["cond"]:
            while seq >= st["done"] + st["window"] and \
                    not self._shutdown and time.monotonic() < gate_deadline:
                if self._task_cancelled(tid):
                    break
                st["cond"].wait(1.0)
        try:
            if self._task_cancelled(tid):
                # Still pushed, as a tombstone: the worker must advance
                # this caller's sequence or later tasks wedge.
                spec.cancelled = True
            while True:
                try:
                    info = self._resolve_actor(actor_id)
                    self._running_locs[tid] = info.address
                    result = rpc.get_stub("WorkerService",
                                          info.address).PushTask(
                        pb.PushTaskRequest(spec=spec), timeout=PUSH_TIMEOUT_S)
                    self._apply_push_result(result, return_ids, spec.name)
                    return
                except exceptions.ActorDiedError as e:
                    self._store_error(e, return_ids)
                    return
                except BaseException as e:  # noqa: BLE001
                    self._invalidate_actor(actor_id)
                    # Not retried by default: the push may have run.
                    if attempt < retries:
                        attempt += 1
                        time.sleep(0.1)
                        continue
                    self._store_error(exceptions.ActorDiedError(
                        actor_id, f"actor task failed: {e}"), return_ids)
                    return
        finally:
            self._running_locs.pop(tid, None)
            if self._cancelled_tasks:
                with self._cancel_lock:
                    self._cancelled_tasks.discard(tid)
            with st["cond"]:
                st["done"] = max(st["done"], seq + 1)
                st["cond"].notify_all()

    def kill_actor(self, actor_id, no_restart):
        reply = self.gcs.GetActor(
            pb.GetActorRequest(actor_id=actor_id.binary()))
        if not reply.found:
            return
        info = reply.info
        if info.state == "ALIVE" and info.address:
            try:
                rpc.get_stub("WorkerService", info.address).KillActor(
                    pb.KillActorRequest(actor_id=actor_id.binary(),
                                        no_restart=no_restart), timeout=5)
            except Exception:  # noqa: BLE001
                pass
        info.state = "DEAD"
        info.death_cause = "killed via ray_tpu_torch.kill()"
        if no_restart:
            info.max_restarts = 0
        self.gcs.UpdateActor(pb.UpdateActorRequest(info=info))
        self._on_actor_event(info.SerializeToString())

    def actor_death(self, actor_id: ActorID) -> Optional[str]:
        """The death cause of an actor this process has seen die (the
        ACTOR events it subscribes to), else None."""
        with self._actor_lock:
            return self._actor_dead.get(actor_id.binary())

    def get_named_actor(self, name: str, namespace: Optional[str]):
        ns = namespace or self.namespace
        if "/" in name:
            ns, name = name.split("/", 1)
        reply = self.gcs.GetActor(pb.GetActorRequest(name=name, namespace=ns))
        if not reply.found or reply.info.state == "DEAD":
            raise ValueError(
                f"Failed to look up actor {name!r} in namespace {ns!r}")
        info = reply.info
        cls, _args, _kwargs, options = loads(
            pickle.loads(info.spec)["payload"])
        return ActorID(bytes(info.actor_id)), cls, options

    def list_named_actors(self, all_namespaces: bool):
        reply = self.gcs.ListActors(pb.ListActorsRequest(
            namespace=self.namespace, all_namespaces=all_namespaces))
        named = [a for a in reply.actors if a.name and a.state != "DEAD"]
        if all_namespaces:
            return [{"name": a.name, "namespace": a.namespace}
                    for a in named]
        return [a.name for a in named]

    def actor_state(self, actor_id: ActorID) -> Dict[str, Any]:
        reply = self.gcs.GetActor(
            pb.GetActorRequest(actor_id=actor_id.binary()))
        if not reply.found:
            return {}
        info = reply.info
        return {"name": info.name, "state": info.state,
                "node_id": info.node_id, "num_restarts": info.num_restarts}

    # ---------------------------------------------------------------- misc
    def as_future(self, ref: ObjectRef) -> Future:
        """ObjectRef -> Future: a completion callback for locally in-flight
        tasks, a polling task for refs owned elsewhere."""
        fut: Future = Future()
        oid = ref.id()

        def resolve_from_store() -> bool:
            try:
                value = self.memory.get_if_ready(oid)
            except KeyError:
                return False
            _future_set(fut, value)
            return True

        if resolve_from_store():
            return fut

        def poll():
            try:
                _future_set(fut, self._get_one(ref, None))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        def on_complete():
            if not resolve_from_store():
                self._submit(poll)  # a result that lives in the node store

        ob = oid.binary()
        with self._pending_res_lock:
            registered = ob in self._pending_results
            if registered:
                self._pending_callbacks.setdefault(ob, []).append(
                    on_complete)
        if not registered:
            self._submit(poll)
        return fut

    def nodes(self) -> List[Dict[str, Any]]:
        return [{
            "NodeID": n.node_id, "Alive": n.alive,
            "NodeManagerAddress": n.address,
            "Resources": dict(n.resources), "Available": dict(n.available),
            "Labels": dict(n.labels), "alive": n.alive,
        } for n in self.gcs.GetNodes(pb.GetNodesRequest()).nodes]

    def _sum_alive(self, field: str) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for n in self.gcs.GetNodes(pb.GetNodesRequest()).nodes:
            if n.alive:
                for k, v in getattr(n, field).items():
                    totals[k] = totals.get(k, 0.0) + v
        return totals

    def cluster_resources(self) -> Dict[str, float]:
        return self._sum_alive("resources")

    def available_resources(self) -> Dict[str, float]:
        return self._sum_alive("available")

    # ------------------------------------------------------ placement groups
    def current_placement_group_id(self) -> Optional[bytes]:
        from ray_tpu_torch._private import pg_context

        ctx = pg_context.get()
        return ctx[0] if ctx else None

    def create_placement_group(self, req) -> None:
        """``req`` is the port's ``PlacementGroupInfo`` dataclass
        (:mod:`ray_tpu_torch.util.placement_group`); its bundles are
        reserved through the node managers' 2PC."""
        self.gcs.CreatePlacementGroup(pb.CreatePlacementGroupRequest(
            group_id=req.group_id, name=req.name, strategy=req.strategy,
            bundles=[pb.Bundle(index=b.index, resources=dict(b.resources))
                     for b in req.bundles]))

    def remove_placement_group(self, group_id: bytes) -> None:
        self.gcs.RemovePlacementGroup(
            pb.RemovePlacementGroupRequest(group_id=group_id))

    def get_placement_group(self, group_id: bytes):
        reply = self.gcs.GetPlacementGroup(
            pb.GetPlacementGroupRequest(group_id=group_id))
        return reply.info if reply.found else None

    # ---------------------------------------------------------------- life
    def shutdown(self):
        """Return held leases, stop the subscriber, the pool and the
        reapers; the threads this runtime started end before it returns
        (a task still running user code keeps its thread until it
        returns)."""
        if self._shutdown:
            return
        self._shutdown = True
        self._drain_lease_cache()
        try:
            self.refs.shutdown()  # every count this process held goes
        except Exception:  # noqa: BLE001 — the GCS is gone already
            pass
        stream = self._sub_stream
        if stream is not None:
            stream.cancel()
        with self._ready_cond:
            self._ready_cond.notify_all()
        self._pool.shutdown(wait=False, cancel_futures=True)
        deadline = time.monotonic() + 10.0
        for t in self._threads + list(self._pool._threads):
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))

    def runtime_threads(self) -> List[threading.Thread]:
        """The live threads this runtime started."""
        return [t for t in self._threads + list(self._pool._threads)
                if t.is_alive()]
