"""Node manager: the per-node daemon (the port's copy of
``ray_tpu/_private/node_manager/server.py``, ``NodeManager`` :74).

Reference: ``src/ray/raylet`` — a worker pool, the local scheduler with
spillback (``RequestWorkerLease`` :795, ``_grant_lease`` :925,
``_queue_for_resources`` :951, ``ReturnWorker`` :977), actor placement
(``CreateActorOnNode`` :1003), placement-bundle 2PC (``PrepareBundle``
:1059, ``CommitBundle`` :1074, ``CancelBundle`` :1086), the node's object
store and its transfer endpoint (``PutObject``, ``GetObject``,
``PullObject``, ``FreeObjects``), and heartbeats with dead-worker checks.

Where the port differs:

* **Workers are forked, not spawned.** JAX starts ``python -m
  ...default_worker`` (``_spawn_worker`` :628); a spawned process would
  pay a 5-7 s torch import here. The port forks each worker from the
  runtime's one fork server (``runtime/replica.py``, :data:`PRELOAD`),
  which imported torch and never touched CUDA.
* **Cards.** A node owns card ids, ``range(num_gpus)`` unless
  ``card_ids`` names others (two nodes of one host own disjoint ones).
  A worker is forked with ``CUDA_VISIBLE_DEVICES`` set before anything
  in it touches CUDA: the ids of the whole cards its lease or actor was
  granted, every card of the node for a fraction of one, none for a CPU
  task (JAX sets ``TPU_VISIBLE_CHIPS`` in the same place, :1035-1037). A
  worker keeps that set for its life and is only leased again for the
  same one, so a worker that has touched a card never serves another. A
  node built in a process takes its cards out of that process's card
  book (``runtime/controller.py::CARDS``, which also books the serve
  replicas and train workers of the process) for its lifetime and gives
  them back at :meth:`NodeManager.shutdown`; a card the book already
  lends out cannot make a node.
* **The object store** is the native shared-memory store
  (:class:`~ray_tpu_torch._private.shm.ShmStore`, JAX's :95-135), the
  node's store of record: a put whose request names a segment the client
  created (``shm_name``) is registered, inline bytes are written into a
  segment of the store's own, ``GetObject`` answers with the segment's
  name and size (the reader maps it), ``PullObject`` streams a segment to
  another node in chunks, ``FreeObjects`` and :meth:`NodeManager.shutdown`
  unlink the segments, and the heartbeat loop sets the store's gauges
  (``STORE_USED_BYTES``, ``STORE_OBJECTS``) from its ``stats()``. JAX
  falls back to a dict when the native library does not build; the port
  raises. The budget (``RAY_TPU_OBJECT_STORE_BYTES``, 4 GiB by default)
  counts the whole pages each segment takes.
* **Spilling** (JAX's :105-114, :1105-1166, the reference's
  ``LocalObjectManager``, ``local_object_manager.h:41``): past
  ``SPILL_HIGH`` of the budget a thread of the node writes the least
  recently used objects to files under the node's spill directory
  (``spill_dir``, else ``ray_tpu_spill_<node>`` in the temp dir) down to
  ``SPILL_LOW``; a put that does not fit drains synchronously first, and
  waits for a drain in progress, instead of being refused. A spilled
  object is brought back on get (``_restore_spilled``), served from its
  file to a pull, and counts as present; a spill that fails (a full
  disk) raises with the path and the size and drops nothing. The spill
  directory goes at shutdown.
* **The memory monitor** (JAX's :1168-1229, the reference's
  ``memory_monitor.h:52``): above ``RAY_TPU_MEMORY_USAGE_THRESHOLD`` of
  the host's memory (the cgroup's limit when one is set; a
  ``RAY_TPU_MEMORY_USAGE_FILE`` overrides the reading, as JAX's test
  does) the node kills its newest leased task worker, whose owner's
  retry runs the task again.
* **Reference holders**: a worker process that dies, or an idle one the
  node reaps, has its counts dropped at the GCS (``ReapHolder``, JAX's
  :737, :757).

The runtime-env agent (JAX's :441-531) is item 20c.
"""

from __future__ import annotations

import logging
import mmap
import os
import pickle
import shutil
import tempfile
import threading
import time
import uuid
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.scheduler import policies

logger = logging.getLogger(__name__)

HEARTBEAT_PERIOD_S = 0.5
CLUSTER_VIEW_TTL_S = 1.0
IDLE_WORKER_TTL_S = 60.0
CHUNK_SIZE = 8 * 1024 * 1024
# Seconds a forked worker has to announce itself.
WORKER_START_S = 60.0
# Workers a node forks at its start, at most one a CPU (JAX's 4: a fork
# from the warm server costs milliseconds, so fewer idle processes wait).
PRESTART_WORKERS = 2


def _pages(nbytes: int) -> int:
    """The bytes of the whole pages a segment of ``nbytes`` takes."""
    return -(-nbytes // mmap.PAGESIZE) * mmap.PAGESIZE


def _heartbeat_period_s() -> float:
    """Env-tunable (RAY_TPU_HEARTBEAT_PERIOD_S) together with the GCS
    side's RAY_TPU_HEARTBEAT_TTL_S."""
    return float(os.environ.get("RAY_TPU_HEARTBEAT_PERIOD_S",
                                HEARTBEAT_PERIOD_S))


class _Worker:
    def __init__(self, worker_id: str, proc, cards: str):
        self.worker_id = worker_id
        self.proc = proc
        self.cards = cards          # its CUDA_VISIBLE_DEVICES, fixed
        self.address: Optional[str] = None
        self.pid = 0
        self.ready = threading.Event()
        self.leased_for: Optional[bytes] = None
        self.is_actor_worker = False
        self.idle_since = time.monotonic()
        self.busy_since = 0.0

    def alive(self) -> bool:
        return self.proc.exitcode is None


def fork_worker(env: Dict[str, str], *args):
    """Start one worker process from the runtime's fork server; ``env`` is
    its whole environment (``CUDA_VISIBLE_DEVICES`` included), set before
    it imports anything more."""
    import multiprocessing as mp

    from ray_tpu_torch._private.workers import default_worker
    from ray_tpu_torch.runtime import replica

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(list(replica.PRELOAD))
    proc = ctx.Process(target=default_worker.forked_main,
                       args=(env,) + args, daemon=True,
                       name=f"ray-tpu-worker-{args[2][:8]}")
    proc.start()
    return proc


class NodeManager:
    def __init__(self, gcs_address: str, port: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 node_id: Optional[str] = None,
                 card_ids: Optional[List[int]] = None,
                 spill_dir: Optional[str] = None):
        self.node_id = node_id or uuid.uuid4().hex
        self.gcs_address = gcs_address
        self.gcs = rpc.get_stub("GcsService", gcs_address)
        # The budget is held here, where objects spill past it, so the
        # C++ store never evicts. Built first: a failed build raises
        # before the node takes anything.
        from ray_tpu_torch._private.shm import ShmStore

        self._shm = ShmStore(capacity_bytes=1 << 62)

        resources = dict(resources or {"CPU": float(os.cpu_count() or 4)})
        n_cards = resources.get("GPU", 0.0)
        if n_cards != int(n_cards):
            raise ValueError(f"num_gpus={n_cards}: a node owns whole cards")
        cards = [str(c) for c in (range(int(n_cards)) if card_ids is None
                                  else card_ids)]
        if len(cards) != int(n_cards) or len(set(cards)) != len(cards):
            raise ValueError(f"card_ids {card_ids} do not name "
                             f"{int(n_cards)} distinct cards")
        self.cards: List[str] = cards
        self._cards_booked = False
        if cards:
            from ray_tpu_torch.runtime.controller import CARDS

            if not CARDS.claim(cards):
                raise RuntimeError(
                    f"cards {cards} are in use in this process (its card "
                    f"book lends {CARDS.use()}): a node cannot own them")
            self._cards_booked = True
        self.total = resources
        self.available = dict(resources)
        self._res_lock = threading.RLock()
        self._res_cv = threading.Condition(self._res_lock)
        self._lease_queue_slots = threading.Semaphore(self.LEASE_QUEUE_SLOTS)
        # Whole-card asks get concrete card ids (reference: per-GPU-slot
        # resource instances, resource_instance_set.h).
        self._cards_free: List[str] = list(reversed(cards))
        self._cards_held: Dict[bytes, List[str]] = {}

        self._obj_lock = threading.Lock()
        self._store_capacity = int(os.environ.get(
            "RAY_TPU_OBJECT_STORE_BYTES", 4 << 30))
        # The budget counts the whole pages each segment takes in
        # /dev/shm, not its payload bytes: a small object costs a page.
        self._store_pages = 0
        # Spilling: oid hex -> (path, size) of each object on disk.
        self._spill_dir = spill_dir or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_spill_{self.node_id[:12]}")
        self._spilled: Dict[str, Tuple[str, int]] = {}
        self._spill_lock = threading.RLock()
        self._spill_event = threading.Event()
        # Bytes and seconds of the spills and restores, and their counts.
        self.spill_stats = dict(spilled=0, spilled_bytes=0, spill_s=0.0,
                                restored=0, restored_bytes=0, restore_s=0.0)
        # The memory monitor.
        self._mem_threshold = float(os.environ.get(
            "RAY_TPU_MEMORY_USAGE_THRESHOLD", 0.95))
        self._mem_usage_file = os.environ.get("RAY_TPU_MEMORY_USAGE_FILE",
                                              "")
        self.oom_kills = 0

        self._workers: Dict[str, _Worker] = {}
        self._idle: List[str] = []
        self._pool_lock = threading.RLock()
        self._spawning_task = 0
        self._spawning_actor = 0

        # Placement bundles: prepare holds the group's node-total demand;
        # commit turns it into per-bundle availability PG leases charge.
        self._prepared: Dict[bytes, Dict[str, float]] = {}
        self._pg_avail: Dict[bytes, Dict[int, Dict[str, float]]] = {}
        self._pg_totals: Dict[bytes, Dict[int, Dict[str, float]]] = {}
        self._pg_holders: Dict[bytes, Tuple[bytes, int]] = {}
        self._leases: Dict[bytes, Tuple[str, Dict[str, float]]] = {}
        self._actor_demands: Dict[bytes, Tuple[str, Dict[str, float]]] = {}

        self._view: List[pb.NodeInfo] = []
        self._view_ts = 0.0
        self._view_lock = threading.Lock()
        self._view_subscribed = False
        self._view_stream = None
        self._push_slots = threading.BoundedSemaphore(
            int(os.environ.get("RAY_TPU_MAX_CONCURRENT_PUSHES", 8)))

        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._server, self.port = rpc.serve("NodeService", self, port=port)
        self.address = f"127.0.0.1:{self.port}"
        self.fast_address = self.address

        self.labels = dict(labels or {})
        # The GCS may have started milliseconds ago: retry briefly.
        deadline = time.monotonic() + 5.0
        while True:
            try:
                self.gcs.RegisterNode(pb.RegisterNodeRequest(
                    info=self._node_info()))
                break
            except Exception:  # noqa: BLE001 — GCS still starting
                if time.monotonic() >= deadline:
                    self._server.stop()
                    self._shm.close()
                    self._give_cards()
                    raise
                time.sleep(0.1)
        self._spawn(self._heartbeat_loop, "nm-heartbeat")
        self._spawn(self._view_subscriber_loop, "nm-view-sub")
        self._spawn(self._spill_loop, "nm-spill")
        self._spawn(self._memory_monitor_loop, "nm-memmon")
        # Prestart workers so first leases skip the fork (reference:
        # worker pool prestart, worker_pool.h:216).
        self._spawn(self._prestart_workers, "nm-prestart")

    def _spawn(self, target, name: str) -> None:
        t = threading.Thread(target=target, daemon=True, name=name)
        self._threads.append(t)
        t.start()

    def _node_info(self) -> pb.NodeInfo:
        with self._res_lock:
            available = dict(self.available)
        return pb.NodeInfo(
            node_id=self.node_id, address=self.address, alive=True,
            fast_address=self.fast_address, resources=dict(self.total),
            available=available, labels=dict(self.labels))

    def _give_cards(self) -> None:
        if self._cards_booked:
            from ray_tpu_torch.runtime.controller import CARDS

            CARDS.give(self.cards, 1.0)
            self._cards_booked = False

    def _prestart_workers(self):
        n = min(int(self.total.get("CPU", 1)), PRESTART_WORKERS)
        workers = []
        for _ in range(n):
            if self._stop.is_set():
                return
            workers.append(self._spawn_worker(""))
        for w in workers:
            if self._wait_ready(w) and not self._stop.is_set():
                with self._pool_lock:
                    if w.worker_id not in self._idle and \
                            w.leased_for is None and \
                            not w.is_actor_worker:
                        self._idle.append(w.worker_id)

    def _wait_ready(self, w: _Worker, timeout_s: float = WORKER_START_S):
        """Wait for a forked worker to announce itself; False when it died,
        the node stopped or the wait timed out."""
        deadline = time.monotonic() + timeout_s
        while not w.ready.wait(0.05):
            if self._stop.is_set() or not w.alive() or \
                    time.monotonic() > deadline:
                return False
        return True

    # ------------------------------------------------------------ resources
    def _take_cards(self, demand: Dict[str, float], holder) -> None:
        """Concrete card ids for a whole-card demand (caller holds the
        resource lock)."""
        n = demand.get("GPU", 0.0)
        if holder is not None and n >= 1 and n == int(n):
            self._cards_held[holder] = [self._cards_free.pop()
                                        for _ in range(int(n))]

    def _try_acquire(self, demand: Dict[str, float],
                     holder: Optional[bytes] = None) -> bool:
        with self._res_lock:
            if all(self.available.get(k, 0.0) + 1e-9 >= v
                   for k, v in demand.items()):
                for k, v in demand.items():
                    self.available[k] = self.available.get(k, 0.0) - v
                self._take_cards(demand, holder)
                return True
            return False

    def _cards_env(self, holder: bytes, demand: Dict[str, float]) -> str:
        """The ``CUDA_VISIBLE_DEVICES`` of a worker serving ``holder``."""
        with self._res_lock:
            held = self._cards_held.get(holder)
        if held:
            return ",".join(held)
        if demand.get("GPU", 0.0) > 0:
            return ",".join(self.cards)  # a fraction of a card
        return ""

    def _release(self, demand: Dict[str, float],
                 holder: Optional[bytes] = None):
        with self._res_cv:
            for k, v in demand.items():
                self.available[k] = min(
                    self.available.get(k, 0.0) + v, self.total.get(k, 0.0))
            if holder is not None:
                self._cards_free.extend(self._cards_held.pop(holder, []))
            self._res_cv.notify_all()  # wake queued lease requests

    def _acquire_from_bundle(self, group_id: bytes, bundle_index: int,
                             demand: Dict[str, float],
                             holder: bytes) -> Tuple[bool, str]:
        """Charge ``demand`` against a committed bundle's reservation
        (reference: placement_group_resource_manager.h). Card ids were
        debited from ``available`` at prepare time but stay in the free
        list; a PG holder claims its physical cards here."""
        with self._res_lock:
            bundles = self._pg_avail.get(group_id)
            if bundles is None:
                return False, "pg-unknown"
            indices = [bundle_index] if bundle_index >= 0 else sorted(bundles)
            for i in indices:
                avail = bundles.get(i)
                if avail is None:
                    continue
                if all(avail.get(k, 0.0) + 1e-9 >= v
                       for k, v in demand.items()):
                    for k, v in demand.items():
                        avail[k] = avail.get(k, 0.0) - v
                    self._take_cards(demand, holder)
                    self._pg_holders[holder] = (group_id, i)
                    return True, ""
            totals = self._pg_totals.get(group_id, {})
            fits_ever = any(
                all(t.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())
                for i, t in totals.items()
                if bundle_index < 0 or i == bundle_index)
            return False, ("pg-wait" if fits_ever else "infeasible")

    def _release_pg_holder(self, holder: bytes,
                           demand: Dict[str, float]) -> bool:
        """Return a PG charge to its bundle; False if ``holder`` charged
        none (the caller releases to the node)."""
        with self._res_lock:
            key = self._pg_holders.pop(holder, None)
            if key is None:
                return False
            self._cards_free.extend(self._cards_held.pop(holder, []))
            group_id, idx = key
            bundles = self._pg_avail.get(group_id)
            if bundles is None or idx not in bundles:
                for k, v in demand.items():
                    self.available[k] = min(
                        self.available.get(k, 0.0) + v,
                        self.total.get(k, 0.0))
                self._res_cv.notify_all()
                return True
            for k, v in demand.items():
                bundles[idx][k] = bundles[idx].get(k, 0.0) + v
            return True

    def _release_any(self, holder: bytes, demand: Dict[str, float]) -> None:
        if not self._release_pg_holder(holder, demand):
            self._release(demand, holder=holder)

    def _heartbeat_loop(self):
        from ray_tpu_torch._private import chaos

        seq = 0
        while not self._stop.wait(_heartbeat_period_s()):
            seq += 1
            # Chaos site: ``drop_node_hb`` skips this tick's send, so the
            # fault is exactly a lost heartbeat.
            directive = chaos.inject("node_heartbeat",
                                     node=self.node_id) or {}
            if not directive.get("drop"):
                with self._res_lock:
                    available = dict(self.available)
                try:
                    reply = self.gcs.Heartbeat(pb.HeartbeatRequest(
                        node_id=self.node_id, seq=seq, available=available),
                        timeout=2)
                    if not reply.ok:
                        # The GCS restarted or lost us: register again.
                        self.gcs.RegisterNode(pb.RegisterNodeRequest(
                            info=self._node_info()), timeout=2)
                except Exception:  # noqa: BLE001
                    pass
            self._reap_idle_workers()
            self._check_dead_workers()
            used, count = self._shm.stats()
            tags = {"node_id": self.node_id[:12]}
            mdefs.STORE_USED_BYTES.set(used, tags=tags)
            mdefs.STORE_OBJECTS.set(count, tags=tags)

    def store_stats(self) -> Tuple[int, int]:
        """The node store's (bytes in use, objects)."""
        return self._shm.stats()

    def _view_subscriber_loop(self):
        """NODE_RES availability deltas and NODE liveness events
        (reference: ray_syncer's push-based resource view)."""
        while not self._stop.is_set():
            try:
                stream = self.gcs.Subscribe(pb.SubscribeRequest(
                    channels=["NODE_RES", "NODE"],
                    subscriber_id=f"nm-{self.node_id[:12]}"),
                    timeout=3600.0)
                self._view_stream = stream
                self._view_subscribed = True
                for msg in stream:
                    if self._stop.is_set():
                        return
                    try:
                        ev = pickle.loads(msg.data)
                    except Exception:  # noqa: BLE001
                        continue
                    if msg.channel == "NODE_RES":
                        # Copy-on-write: snapshots handed out by
                        # _cluster_view share these messages.
                        with self._view_lock:
                            for i, n in enumerate(self._view):
                                if n.node_id == ev["node_id"]:
                                    cp = pb.NodeInfo()
                                    cp.CopyFrom(n)
                                    cp.available.update(ev["available"])
                                    self._view[i] = cp
                                    break
                    else:  # liveness change: refresh in full
                        self._view_ts = 0.0
            except Exception:  # noqa: BLE001
                pass
            finally:
                self._view_subscribed = False
            if self._stop.wait(1.0):
                return

    def _cluster_view(self) -> List[pb.NodeInfo]:
        now = time.monotonic()
        ttl = (10 * CLUSTER_VIEW_TTL_S if self._view_subscribed
               else CLUSTER_VIEW_TTL_S)
        if now - self._view_ts > ttl:
            try:
                fresh = list(
                    self.gcs.GetNodes(pb.GetNodesRequest(), timeout=2).nodes)
                with self._view_lock:
                    self._view = fresh
                    self._view_ts = now
            except Exception:  # noqa: BLE001
                pass
        with self._view_lock:
            return list(self._view)

    # ------------------------------------------------------------ worker pool
    def _spawn_worker(self, cards: str) -> _Worker:
        worker_id = uuid.uuid4().hex
        env = dict(os.environ)
        env["CUDA_VISIBLE_DEVICES"] = cards
        proc = fork_worker(env, self.address, self.gcs_address, worker_id,
                           self.node_id)
        worker = _Worker(worker_id, proc, cards)
        with self._pool_lock:
            self._workers[worker_id] = worker
        return worker

    def _pop_worker(self, cards: str = "", timeout_s: float = WORKER_START_S,
                    for_actor: bool = False) -> Optional[_Worker]:
        """Reference: WorkerPool::PopWorker (worker_pool.cc:1355): an idle
        worker forked for the same cards, else a fresh fork (task workers
        capped at twice the node's CPUs, actor workers at
        ``RAY_TPU_MAX_ACTOR_WORKERS``)."""
        if for_actor:
            cap = int(os.environ.get("RAY_TPU_MAX_ACTOR_WORKERS", 128))
        else:
            cap = int(os.environ.get(
                "RAY_TPU_MAX_WORKERS",
                max(4, int(self.total.get("CPU", 4)) * 2)))
        start = time.monotonic()
        while True:
            with self._pool_lock:
                for wid in list(self._idle):
                    w = self._workers.get(wid)
                    if w is None or not w.alive():
                        self._idle.remove(wid)
                    elif w.cards == cards:
                        self._idle.remove(wid)
                        return w
                used = sum(1 for w in self._workers.values()
                           if w.is_actor_worker == for_actor)
                used += self._spawning_actor if for_actor \
                    else self._spawning_task
                if used < cap:
                    if for_actor:
                        self._spawning_actor += 1
                    else:
                        self._spawning_task += 1
                    break
            if time.monotonic() - start > 1.0:
                return None
            time.sleep(0.005)
        try:
            worker = self._spawn_worker(cards)
            worker.is_actor_worker = for_actor
        finally:
            with self._pool_lock:
                if for_actor:
                    self._spawning_actor -= 1
                else:
                    self._spawning_task -= 1
        return worker if self._wait_ready(worker, timeout_s) else None

    def _reap_holder(self, worker_id: str) -> None:
        """Drop a gone worker's reference counts at the GCS."""
        try:
            self.gcs.ReapHolder(pb.ReapHolderRequest(holder_id=worker_id),
                                timeout=5)
        except Exception:  # noqa: BLE001 — the GCS's holder TTL catches it
            pass

    def _reap_idle_workers(self):
        now = time.monotonic()
        reaped = []
        with self._pool_lock:
            keep = []
            for wid in self._idle:
                w = self._workers.get(wid)
                if w is None or not w.alive():
                    continue
                if now - w.idle_since > IDLE_WORKER_TTL_S:
                    w.proc.terminate()
                    self._workers.pop(wid, None)
                    reaped.append(wid)
                else:
                    keep.append(wid)
            self._idle = keep
        for wid in reaped:
            self._reap_holder(wid)

    def _check_dead_workers(self):
        """Hand a dead actor worker's restart decision to the GCS
        (reference: worker-death notification ->
        GcsActorManager::OnWorkerDead)."""
        with self._pool_lock:
            dead = [w for w in self._workers.values()
                    if not w.alive() and w.ready.is_set()]
            for w in dead:
                self._workers.pop(w.worker_id, None)
                if w.worker_id in self._idle:
                    self._idle.remove(w.worker_id)
        for w in dead:
            w.proc.join(timeout=1.0)
            self._reap_holder(w.worker_id)
            for actor_id, (wid, demand) in list(self._actor_demands.items()):
                if wid != w.worker_id:
                    continue
                del self._actor_demands[actor_id]
                self._release_any(actor_id, demand)
                try:
                    reply = self.gcs.GetActor(
                        pb.GetActorRequest(actor_id=actor_id), timeout=5)
                    if reply.found and reply.info.state == "ALIVE" \
                            and reply.info.node_id == self.node_id:
                        info = reply.info
                        info.state = "RESTARTING"
                        info.death_cause = "worker process died"
                        self.gcs.UpdateActor(
                            pb.UpdateActorRequest(info=info), timeout=5)
                except Exception:  # noqa: BLE001
                    pass

    def AnnounceWorker(self, request, context):
        with self._pool_lock:
            w = self._workers.get(request.worker_id)
            if w is None:
                logger.warning("rejecting unknown worker %s",
                               request.worker_id[:8])
                return pb.Empty()
            w.address = request.address
            w.pid = request.pid
            w.ready.set()
        return pb.Empty()

    def worker_pids(self) -> List[int]:
        """Pids of this node's live worker processes."""
        with self._pool_lock:
            return [w.proc.pid for w in self._workers.values() if w.alive()]

    # ------------------------------------------------------------ leases
    def _granted(self, lease_id: bytes, demand: Dict[str, float],
                 worker: _Worker):
        worker.leased_for = lease_id
        worker.busy_since = time.monotonic()
        self._leases[lease_id] = (worker.worker_id, demand)
        with self._res_lock:
            cards = [int(c) for c in self._cards_held.get(lease_id, ())]
        return pb.LeaseReply(granted=True, worker_address=worker.address,
                             worker_fast_address=worker.address,
                             worker_id=worker.worker_id, card_ids=cards)

    def RequestWorkerLease(self, request, context):
        """Reference: NodeManager::HandleRequestWorkerLease
        (raylet/node_manager.cc:1868) + ClusterTaskManager scheduling."""
        spec = request.spec
        demand = dict(spec.resources)
        lease_id = uuid.uuid4().bytes
        if spec.runtime_env:
            from ray_tpu_torch._private.worker import ITEM_20C
            from ray_tpu_torch.exceptions import not_ported

            raise not_ported("a task's runtime_env", ITEM_20C)
        if spec.placement_group_id:
            # The bundle lives here or nowhere: never spill back.
            ok, err = self._acquire_from_bundle(
                bytes(spec.placement_group_id), spec.pg_bundle_index,
                demand, lease_id)
            if not ok:
                return pb.LeaseReply(granted=False, error=err)
            worker = self._pop_worker(self._cards_env(lease_id, demand))
            if worker is None:
                self._release_pg_holder(lease_id, demand)
                return pb.LeaseReply(granted=False,
                                     error="worker start timeout")
            return self._granted(lease_id, demand, worker)
        selector = policies.parse_label_selector(spec.label_selector)
        if selector is not None:
            return self._lease_with_labels(spec, demand, lease_id, selector)
        if spec.strategy == "SPREAD":
            # Compare post-charge utilization (spread_scheduling_policy);
            # a margin damps spillback ping-pong on stale views.
            others = [n for n in self._cluster_view()
                      if n.node_id != self.node_id]
            best = policies.pick_node_spread(others, demand)
            if best is not None:
                with self._res_lock:
                    me = pb.NodeInfo(node_id=self.node_id, alive=True,
                                     resources=dict(self.total),
                                     available=dict(self.available))
                best_node = next(n for n in others if n.node_id == best)
                if policies.util_after(best_node, demand) + 0.02 < \
                        policies.util_after(me, demand):
                    return pb.LeaseReply(granted=False,
                                         spillback_node_id=best,
                                         spillback_address=best_node.address)
        if self._try_acquire(demand, holder=lease_id):
            return self._grant_lease(lease_id, demand)
        if spec.affinity_node_id and not spec.affinity_soft:
            # Hard affinity: never spill; wait here or fail when this node
            # can never hold the demand.
            if not all(self.total.get(k, 0.0) + 1e-9 >= v
                       for k, v in demand.items()):
                return pb.LeaseReply(granted=False, error="infeasible")
            return self._queue_for_resources(lease_id, demand)
        nodes = [n for n in self._cluster_view() if n.node_id != self.node_id]
        picker = (policies.pick_node_spread if spec.strategy == "SPREAD"
                  else policies.pick_node_hybrid)
        target = picker(nodes, demand)
        if target is None:
            view = self._cluster_view() or [self._node_info()]
            if not policies.feasible_anywhere(view, demand):
                return pb.LeaseReply(granted=False, error="infeasible")
            # Nowhere else to go now: queue here instead of making the
            # client poll.
            return self._queue_for_resources(lease_id, demand)
        addr = next(n.address for n in nodes if n.node_id == target)
        return pb.LeaseReply(granted=False, spillback_node_id=target,
                             spillback_address=addr)

    def _lease_with_labels(self, spec, demand: Dict[str, float],
                           lease_id: bytes, selector: Dict[str, dict]):
        """Node-label scheduling: hard selectors gate eligibility, soft ones
        rank, then the base policy places among the surviving tier."""
        hard = selector.get("hard") or {}
        soft = selector.get("soft") or {}
        local_hard = policies.match_labels(self.labels, hard)
        local_soft = local_hard and policies.match_labels(self.labels, soft)
        view = self._cluster_view()
        others = [n for n in view if n.node_id != self.node_id]
        picker = (policies.pick_node_spread if spec.strategy == "SPREAD"
                  else policies.pick_node_hybrid)
        if soft:
            if local_soft and self._try_acquire(demand, holder=lease_id):
                return self._grant_lease(lease_id, demand)
            soft_fit = [n for n in others if n.alive
                        and policies.match_labels(dict(n.labels), hard)
                        and policies.match_labels(dict(n.labels), soft)]
            target = picker(soft_fit, demand)
            if target is not None:
                addr = next(n.address for n in others
                            if n.node_id == target)
                return pb.LeaseReply(granted=False,
                                     spillback_node_id=target,
                                     spillback_address=addr)
        if local_hard and self._try_acquire(demand, holder=lease_id):
            return self._grant_lease(lease_id, demand)
        hard_fit = [n for n in others if n.alive
                    and policies.match_labels(dict(n.labels), hard)]
        target = picker(hard_fit, demand)
        if target is not None:
            addr = next(n.address for n in others if n.node_id == target)
            return pb.LeaseReply(granted=False, spillback_node_id=target,
                                 spillback_address=addr)
        if not policies.feasible_with_labels(view, demand, selector):
            return pb.LeaseReply(granted=False, error="infeasible")
        if local_hard:
            return self._queue_for_resources(lease_id, demand)
        return pb.LeaseReply(granted=False)

    def _grant_lease(self, lease_id: bytes, demand: Dict[str, float]):
        worker = self._pop_worker(self._cards_env(lease_id, demand))
        if worker is None:
            self._release(demand, holder=lease_id)
            return pb.LeaseReply(granted=False,
                                 error="worker start timeout")
        return self._granted(lease_id, demand, worker)

    LEASE_QUEUE_WAIT_S = 2.0
    # Queued lease RPCs each hold a server thread; bounding them keeps
    # ReturnWorker, which frees what they wait for, served.
    LEASE_QUEUE_SLOTS = 32

    def _queue_for_resources(self, lease_id: bytes,
                             demand: Dict[str, float]):
        """Hold the lease RPC briefly until resources free up (the raylet
        queues lease requests); on either bound the client retries."""
        if not self._lease_queue_slots.acquire(blocking=False):
            return pb.LeaseReply(granted=False)
        try:
            deadline = time.monotonic() + self.LEASE_QUEUE_WAIT_S
            with self._res_cv:
                while not self._stop.is_set() and \
                        time.monotonic() < deadline:
                    if self._try_acquire(demand, holder=lease_id):
                        break
                    self._res_cv.wait(0.05)
                else:
                    return pb.LeaseReply(granted=False)
            return self._grant_lease(lease_id, demand)
        finally:
            self._lease_queue_slots.release()

    def ReturnWorker(self, request, context):
        lease_id = request.lease_id
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            for lid, (wid, demand) in list(self._leases.items()):
                if wid == request.worker_id:
                    lease = self._leases.pop(lid, None)
                    lease_id = lid
                    break
        if lease is not None:
            self._release_any(lease_id, lease[1])
        with self._pool_lock:
            w = self._workers.get(request.worker_id)
            if w and w.alive() and not w.is_actor_worker:
                w.leased_for = None
                w.idle_since = time.monotonic()
                if request.worker_id not in self._idle:
                    self._idle.append(request.worker_id)
        return pb.Empty()

    def CreateActorOnNode(self, request, context):
        """Lease a dedicated worker and build the actor on it (reference:
        GcsActorScheduler raylet leg, gcs_actor_scheduler.cc:107)."""
        info = request.info
        aid = bytes(info.actor_id)
        spec = pickle.loads(info.spec)
        demand = dict(spec.get("resources", {}))
        pg = spec.get("pg")
        if pg is not None:
            ok, err = self._acquire_from_bundle(pg[0], pg[1], demand, aid)
            if not ok:
                return pb.CreateActorOnNodeReply(
                    ok=False, error=f"insufficient resources ({err})")
        elif not self._try_acquire(demand, holder=aid):
            return pb.CreateActorOnNodeReply(
                ok=False, error="insufficient resources")
        cards = self._cards_env(aid, demand)
        worker = self._pop_worker(cards, for_actor=True)
        if worker is None:
            self._release_any(aid, demand)
            return pb.CreateActorOnNodeReply(ok=False,
                                             error="worker start timeout")
        worker.is_actor_worker = True
        worker.leased_for = aid
        self._actor_demands[aid] = (worker.worker_id, demand)
        info.node_id = self.node_id
        info.address = worker.address
        info.fast_address = worker.address
        env = {"CUDA_VISIBLE_DEVICES": cards}
        try:
            reply = rpc.get_stub("WorkerService", worker.address).CreateActor(
                pb.CreateActorRequest(info=info, env=env), timeout=600)
        except Exception as e:  # noqa: BLE001
            reply = pb.CreateActorReply(ok=False, error=str(e))
        if not reply.ok:
            self._actor_demands.pop(aid, None)
            self._release_any(aid, demand)
            return pb.CreateActorOnNodeReply(ok=False, error=reply.error)
        return pb.CreateActorOnNodeReply(ok=True,
                                         worker_address=worker.address,
                                         fast_address=worker.address)

    # ------------------------------------------------------------ bundles
    def PrepareBundle(self, request, context):
        total_demand: Dict[str, float] = defaultdict(float)
        for b in request.bundles:
            for k, v in b.resources.items():
                total_demand[k] += v
        # A re-prepare supersedes the previous attempt: release it.
        stale = self._prepared.pop(request.group_id, None)
        if stale is not None:
            self._release(stale)
        if self._try_acquire(dict(total_demand)):
            self._prepared[request.group_id] = dict(total_demand)
            return pb.PrepareBundleReply(success=True)
        return pb.PrepareBundleReply(success=False)

    def CommitBundle(self, request, context):
        if self._prepared.pop(request.group_id, None) is None:
            return pb.Empty()  # already cancelled or a duplicate commit
        with self._res_lock:
            avail = self._pg_avail.setdefault(request.group_id, {})
            totals = self._pg_totals.setdefault(request.group_id, {})
            for b in request.bundles:
                avail[b.index] = dict(b.resources)
                totals[b.index] = dict(b.resources)
        return pb.Empty()

    def CancelBundle(self, request, context):
        demand = self._prepared.pop(request.group_id, None)
        if demand is not None:
            self._release(demand)
            return pb.Empty()
        with self._res_lock:
            avail = self._pg_avail.pop(request.group_id, None)
            self._pg_totals.pop(request.group_id, None)
        if avail is not None:
            # Only the unconsumed share: running PG holders return theirs
            # to the node when they finish.
            freed: Dict[str, float] = defaultdict(float)
            for res in avail.values():
                for k, v in res.items():
                    freed[k] += v
            self._release(dict(freed))
        return pb.Empty()

    # ----------------------------------------------------------- spilling
    SPILL_HIGH = 0.9  # spilling starts above this share of the budget
    SPILL_LOW = 0.7   # ... and runs down to this share
    # Seconds a put that does not fit waits for drains before it fails.
    SEAT_WAIT_S = 120.0

    def _maybe_spill(self) -> None:
        """Wake the spill thread past the high-water mark (the put and get
        handlers never wait on the disk for it)."""
        if self._store_pages > self._store_capacity * self.SPILL_HIGH:
            self._spill_event.set()

    def _spill_loop(self) -> None:
        while not self._stop.is_set():
            if not self._spill_event.wait(0.25):
                continue
            self._spill_event.clear()
            try:
                self._drain_to_low_water()
            except Exception:  # noqa: BLE001 — the next put raises it
                logger.exception("background spill failed")

    def _drain_to_low_water(self, min_free_bytes: int = 0) -> None:
        """Spill least recently used objects until the store is at the
        low-water mark, or low enough that ``min_free_bytes`` fits (JAX's
        :1131). The lock is taken a victim at a time, so restores and
        pulls interleave with a drain. A failed write raises, naming the
        path and the size; the object stays in the store."""
        from ray_tpu_torch._private.shm import ShmClient

        target = min(self._store_capacity * self.SPILL_LOW,
                     max(self._store_capacity - min_free_bytes, 0))
        os.makedirs(self._spill_dir, exist_ok=True)
        while not self._stop.is_set() and self._store_pages > target:
            with self._spill_lock:
                oid = self._shm.coldest()
                if oid is None:
                    return
                meta = self._shm.get(oid)
                if meta is None:
                    continue
                view = ShmClient.map_segment_view(*meta)
                if view is None:   # unlinked under us: drop the entry
                    self._forget(oid, meta[1])
                    continue
                path = os.path.join(self._spill_dir, oid)
                tmp = f"{path}.tmp"
                t0 = time.perf_counter()
                try:
                    with open(tmp, "wb") as f:
                        f.write(view)
                    os.replace(tmp, path)
                except OSError as e:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise RuntimeError(
                        f"spilling object {oid[:16]} ({meta[1]} bytes) to "
                        f"{path} failed: {e}") from e
                finally:
                    del view
                self._spilled[oid] = (path, meta[1])
                self._forget(oid, meta[1])
                st = self.spill_stats
                st["spilled"] += 1
                st["spilled_bytes"] += meta[1]
                st["spill_s"] += time.perf_counter() - t0

    def _forget(self, oid_hex: str, size: int) -> None:
        """Drop an object from the store and its pages from the budget."""
        with self._obj_lock:
            if self._shm.delete(oid_hex):
                self._store_pages -= _pages(size)

    def _restore_spilled(self, oid_hex: str) -> bool:
        """Bring a spilled object back into the store (JAX's :1168): its
        file copied into a segment the store indexes, others spilled to
        make room. False when it is in neither."""
        from ray_tpu_torch._private.shm import SEGMENT_PREFIX

        with self._spill_lock:
            meta = self._spilled.get(oid_hex)
            if meta is None:
                return self._shm.contains(oid_hex)
            path, size = meta
            seg = f"/{SEGMENT_PREFIX}{oid_hex}"
            t0 = time.perf_counter()

            def seat():
                try:
                    shutil.copyfile(path, f"/dev/shm{seg}")
                except OSError as e:
                    raise RuntimeError(
                        f"restoring object {oid_hex[:16]} ({size} bytes) "
                        f"from {path} failed: {e}") from e
                if self._shm.register(oid_hex, seg, size):
                    return True
                os.unlink(f"/dev/shm{seg}")
                return False

            self._seat(oid_hex, size, seat)
            self._spilled.pop(oid_hex, None)
            try:
                os.unlink(path)
            except OSError:
                pass
            st = self.spill_stats
            st["restored"] += 1
            st["restored_bytes"] += size
            st["restore_s"] += time.perf_counter() - t0
        self._maybe_spill()
        return True

    def spilled_objects(self) -> Dict[str, Tuple[str, int]]:
        """The spilled objects: oid hex -> (file, bytes)."""
        with self._spill_lock:
            return dict(self._spilled)

    # ------------------------------------------------------ memory monitor
    def _memory_usage_fraction(self) -> float:
        if self._mem_usage_file:
            try:
                with open(self._mem_usage_file) as f:
                    return float(f.read().strip() or 0.0)
            except (OSError, ValueError):
                return 0.0
        try:  # the cgroup's limit, when one is set
            with open("/sys/fs/cgroup/memory.current") as f:
                cur = int(f.read())
            with open("/sys/fs/cgroup/memory.max") as f:
                mx = f.read().strip()
            if mx != "max":
                return cur / max(int(mx), 1)
        except (OSError, ValueError):
            pass
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    k, v = line.split(":", 1)
                    info[k] = int(v.strip().split()[0])
            return 1.0 - info["MemAvailable"] / max(info["MemTotal"], 1)
        except (OSError, ValueError, KeyError):
            return 0.0

    def _memory_monitor_loop(self) -> None:
        while not self._stop.wait(0.25):
            if self._memory_usage_fraction() < self._mem_threshold:
                continue
            if self._shed_memory():
                # Time for the freed memory to show before the next look.
                self._stop.wait(1.0)

    def _shed_memory(self) -> bool:
        """Kill the newest leased task worker (newest first sheds the
        work most likely to be retried; the owner's retry budget decides
        on the crash-retry path)."""
        with self._pool_lock:
            busy = [w for w in self._workers.values()
                    if w.leased_for is not None and not w.is_actor_worker
                    and w.alive()]
            if not busy:
                return False
            victim = max(busy, key=lambda w: w.busy_since)
        logger.warning("memory usage above %.2f: killing the newest task "
                       "worker %s", self._mem_threshold, victim.worker_id)
        try:
            victim.proc.kill()
        except Exception:  # noqa: BLE001
            return False
        self.oom_kills += 1
        return True

    # ------------------------------------------------------------ objects
    def _seat(self, oid_hex: str, size: int, attempt) -> None:
        """Run ``attempt()`` (which seats the object) once the budget has
        room for ``size``, spilling to make it (JAX's
        ``_seat_with_backpressure`` :1290): a put that does not fit drains
        the store synchronously and waits for other drains, up to
        ``SEAT_WAIT_S``. It raises only when the object can never fit,
        the wait ran out, or a spill failed."""
        need = _pages(size)
        if need > self._store_capacity:
            raise RuntimeError(
                f"object {oid_hex[:16]} ({size} bytes) is larger than the "
                f"node store's {self._store_capacity} bytes "
                f"(RAY_TPU_OBJECT_STORE_BYTES)")
        deadline = time.monotonic() + self.SEAT_WAIT_S
        while True:
            with self._obj_lock:
                if self._store_pages + need <= self._store_capacity:
                    ok = attempt()
                    if ok:
                        self._store_pages += need
                    break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"the node store could not make room for object "
                    f"{oid_hex[:16]} ({size} bytes) within "
                    f"{self.SEAT_WAIT_S} s")
            self._drain_to_low_water(min_free_bytes=need)
            if self._store_pages + need > self._store_capacity:
                time.sleep(0.01)  # another drain or a restore holds room
        if not ok:
            raise RuntimeError(
                f"the node store could not seat object {oid_hex[:16]} "
                f"({size} bytes) in /dev/shm")

    def _store_object(self, request) -> int:
        """Seat one object in the store (JAX's :1252-1290): register the
        segment a client made, or write inline bytes into one, spilling
        others first when the budget is full. A put that fails has its
        client's segment unlinked (nothing indexes it)."""
        from ray_tpu_torch._private.shm import ShmClient

        oid_hex = request.object_id.hex()
        size = request.size or len(request.data)
        if self._shm.contains(oid_hex):
            return size           # immutable: a re-put changes nothing
        if oid_hex in self._spilled:
            if request.shm_name:  # a new copy nothing will index
                ShmClient.unlink_segment(request.shm_name)
            return size
        if request.shm_name:
            def attempt():
                return self._shm.register(oid_hex, request.shm_name, size)
        else:
            def attempt():
                return self._shm.put(oid_hex, request.data) is not None
        try:
            self._seat(oid_hex, size, attempt)
        except BaseException:
            if request.shm_name:
                ShmClient.unlink_segment(request.shm_name)
            raise
        self._maybe_spill()
        return size

    def PutObject(self, request, context):
        size = self._store_object(request)
        try:
            self.gcs.UpdateObjectLocation(pb.ObjectLocationUpdate(
                object_id=request.object_id, node_id=self.node_id,
                added=True, size=size))
        except Exception:  # noqa: BLE001
            pass
        return pb.PutObjectReply(rejected=False)

    def PutObjectBatch(self, request, context):
        batch = pb.ObjectLocationBatch()
        for item in request.items:
            batch.updates.append(pb.ObjectLocationUpdate(
                object_id=item.object_id, node_id=self.node_id,
                added=True, size=self._store_object(item)))
        try:
            self.gcs.UpdateObjectLocationsBatch(batch)
        except Exception:  # noqa: BLE001
            pass
        return pb.PutObjectBatchReply(rejected=[False] * len(batch.updates))

    def GetObject(self, request, context):
        """The object's segment name and size (the reader maps it); a
        spilled object is restored first (for ``metadata_only`` its
        presence is enough)."""
        oid_hex = request.object_id.hex()
        meta = self._shm.get(oid_hex)
        if meta is None:
            spilled = self._spilled.get(oid_hex)
            if spilled is None:
                return pb.GetObjectReply(found=False)
            if request.metadata_only:
                return pb.GetObjectReply(found=True, size=spilled[1])
            if self._restore_spilled(oid_hex):
                meta = self._shm.get(oid_hex)
            if meta is None:
                return pb.GetObjectReply(found=False)
        name, size = meta
        if request.metadata_only:
            return pb.GetObjectReply(found=True, size=size)
        return pb.GetObjectReply(found=True, shm_name=name, size=size)

    def GetObjectsMeta(self, request, context):
        """Batched local readiness (reference: plasma Contains); a
        spilled object is present."""
        return pb.GetObjectsMetaReply(found=[
            self._shm.contains(oid.hex()) or oid.hex() in self._spilled
            for oid in request.object_ids])

    def PullObject(self, request, context):
        """Chunked transfer out of the mapped segment, or out of a spilled
        object's file without restoring it (reference: ObjectManager
        chunks, object_manager.h:117), outbound streams capped
        (PushManager, push_manager.h:30)."""
        from ray_tpu_torch._private.shm import ShmClient

        oid_hex = request.object_id.hex()
        meta = self._shm.get(oid_hex)
        view = None if meta is None else ShmClient.map_segment_view(*meta)
        spilled = self._spilled.get(oid_hex) if view is None else None
        if (view is None and spilled is None) or \
                not self._push_slots.acquire(timeout=60.0):
            yield pb.ObjectChunk(object_id=request.object_id, found=False,
                                 eof=True)
            return
        try:
            if view is None:
                try:
                    with open(spilled[0], "rb") as f:
                        view = memoryview(f.read())
                except OSError:
                    yield pb.ObjectChunk(object_id=request.object_id,
                                         found=False, eof=True)
                    return
            total = len(view)
            for off in range(0, max(total, 1), CHUNK_SIZE):
                yield pb.ObjectChunk(object_id=request.object_id,
                                     total_size=total, offset=off,
                                     data=bytes(view[off:off + CHUNK_SIZE]),
                                     found=True,
                                     eof=off + CHUNK_SIZE >= total)
        finally:
            self._push_slots.release()

    def FreeObjects(self, request, context):
        batch = pb.ObjectLocationBatch()
        for oid in request.object_ids:
            with self._obj_lock:
                meta = self._shm.get(oid.hex())
                if meta is not None and self._shm.delete(oid.hex()):
                    self._store_pages -= _pages(meta[1])
            with self._spill_lock:
                spilled = self._spilled.pop(oid.hex(), None)
            if spilled is not None:
                try:
                    os.unlink(spilled[0])
                except OSError:
                    pass
            batch.updates.append(pb.ObjectLocationUpdate(
                object_id=oid, node_id=self.node_id, added=False))
        try:
            self.gcs.UpdateObjectLocationsBatch(batch)
        except Exception:  # noqa: BLE001
            pass
        return pb.Empty()

    # ------------------------------------------------------------ lifecycle
    def shutdown(self, graceful: bool = True):
        """Stop the node. ``graceful=False`` is a crash: no drain notice,
        so the GCS health checker must find the death. Every worker
        process is killed and reaped, the node's threads end, its store's
        segments and its spill directory go, and its cards go back to the
        process's card book."""
        self._stop.set()
        if graceful:
            try:
                self.gcs.DrainNode(pb.DrainNodeRequest(node_id=self.node_id),
                                   timeout=2)
            except Exception:  # noqa: BLE001
                pass
        stream = self._view_stream
        if stream is not None:
            stream.cancel()
        self._server.stop(grace=5.0)
        # Twice, so workers forked by the prestart thread meanwhile go too.
        for _ in range(2):
            with self._pool_lock:
                workers = list(self._workers.values())
            for w in workers:
                if w.alive():
                    w.proc.kill()
            for w in workers:
                w.proc.join(timeout=5.0)
            time.sleep(0.05)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        self._shm.close()
        shutil.rmtree(self._spill_dir, ignore_errors=True)
        self._give_cards()

    def threads(self) -> List[threading.Thread]:
        return [t for t in self._threads if t.is_alive()]

