"""Worker group + backend executor for distributed training (port of
``ray_tpu/train/backend_executor.py``).

Reference call stack (SURVEY.md §3.4): ``BackendExecutor.start``
(``train/_internal/backend_executor.py:142``) creates the worker group,
shares accelerator visibility among colocated workers, assigns ranks,
runs ``train_loop_per_worker`` and polls a session queue for results.

Each :class:`TrainWorker` is hosted one of two ways, both answering
the interface of :class:`~ray_tpu_torch.runtime.replica.ReplicaProcess`
(calls answered on a pool of three threads, so ``run``, ``poll`` and
``stop`` run concurrently as ``max_concurrency=3`` gives the JAX actor):

* **on a cluster** (the driver ran ``ray_tpu_torch.init(address=...)``),
  as JAX's: an actor of the cluster runtime
  (:class:`~ray_tpu_torch.runtime.cluster_replica.ClusterReplica`) with
  ``num_cpus=cpus_per_worker``, ``num_gpus=gpus_per_worker`` when
  ``use_gpu``, the other resources of ``worker_resources()`` and
  ``max_concurrency=3``, which the GCS places. The node that hosts it
  books its cards and sets its ``CUDA_VISIBLE_DEVICES``; nothing comes
  out of the driver's card book, and a placement the cluster can never
  make fails the start with the runtime's error at once;
* **otherwise**, in a process of its own forked from the replicas' fork
  server (which imported torch once, so a restart costs no torch
  import), seeing its cards through ``CUDA_VISIBLE_DEVICES`` (an empty
  one when ``use_gpu`` is off). A ``use_gpu`` group takes its cards from
  the serving process's one card book (``runtime/controller.py::CARDS``),
  where the serve replicas take theirs, so a worker never lands on a
  card a replica holds; a group that does not fit waits for shares to
  come back up to ``WORKER_START_S`` and gives its own back when it
  stops.

``TorchBackend.on_start`` forms the ``torch.distributed`` group from
worker 0 (the JAX package's ``jax.distributed`` bootstrap): worker 0
reserves a port, every worker calls ``init_process_group`` with
``tcp://`` on it (NCCL on cards, gloo on the CPU), and one all-reduce
proves the group formed; failing that after port-rebind retries raises
:class:`~ray_tpu_torch.exceptions.DistributedBootstrapError`.

Elastic failure detection (reference: Train v2 worker-group health checks):
every ``poll()`` is also a liveness probe. Three independent channels
feed it:

1. **process death** — a dead worker's pending calls fail with
   ``ActorDiedError`` (annotated with the failed rank and, for a chaos
   kill, the firing's event id);
2. **heartbeats** — each worker runs a heartbeat thread that stamps a
   timestamp returned by ``poll()`` AND writes it to the controller's
   store (``__train__`` namespace: the JAX package's GCS KV) so a
   controller can see lapses even when the pipe is slow; a lapse past
   ``RAY_TPU_TRAIN_HEARTBEAT_TTL_S`` raises
   ``WorkerHangError(kind="heartbeat")``, and so does a poll that gets
   no answer in ``POLL_TIMEOUT_S``;
3. **step progress** — ``progress_ts`` moves on every ``train.report``;
   the trainer's per-step watchdog turns a stall into
   ``WorkerHangError(kind="watchdog")`` (hung collective).

The chaos harness (``_private/chaos.py``) can kill a worker at a step
boundary, drop/delay heartbeats, or wedge a step — each detection path
above is exercised by a real injected fault in tests. The plan reaches a
forked worker over its pipe; a cluster actor has none, so chaos runs in
local mode only (ROADMAP.md §C).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import threading
import time
import uuid
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import chaos
from ray_tpu_torch.checkpoint import preempt
from ray_tpu_torch.checkpoint.plane import CKPT_KV_NS, StoreKV
from ray_tpu_torch.runtime.replica import ReplicaProcess
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig

logger = logging.getLogger(__name__)

# Namespace for worker heartbeat records in the controller's store.
TRAIN_KV_NS = "__train__"


def _hb_period_s() -> float:
    return float(os.environ.get("RAY_TPU_TRAIN_HEARTBEAT_S", 0.5))


def _hb_ttl_s() -> float:
    return float(os.environ.get("RAY_TPU_TRAIN_HEARTBEAT_TTL_S", 5.0))


# Seconds a poll round may go unanswered before the rank is declared
# hung (the JAX actor call has no limit; a pipe can wedge).
POLL_TIMEOUT_S = 60.0
# Seconds a worker process may take to come up (fork, imports, env).
WORKER_START_S = 600.0


class TrainWorker:
    """Hosts one training process (reference: ``RayTrainWorker``), inside
    its own worker process. ``store_address`` is the controller's store
    (``host:port``): heartbeats, the checkpoint plane's KV and the
    preemption channel go through it."""

    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 local_world_size: int, env: Optional[Dict[str, str]] = None,
                 group_id: str = "", store_address: Optional[str] = None):
        self.rank = world_rank
        self.group_id = group_id
        for k, v in (env or {}).items():
            os.environ[k] = v
        self._ctx = session_mod.TrainContext(
            world_rank, world_size, local_rank, local_world_size)
        self._session: Optional[session_mod._Session] = None
        self._lock = threading.Lock()
        self._hb_ts: Optional[float] = None
        self._store_address = store_address
        self._hb_kv = self._ckpt_kv = None
        if store_address:
            # One client a user: heartbeats, the plane's commit thread.
            self._hb_kv = StoreKV(preempt.connect_store(store_address),
                                  TRAIN_KV_NS)
            self._ckpt_kv = StoreKV(preempt.connect_store(store_address),
                                    CKPT_KV_NS)
            preempt.attach(store_address)

    def setup(self, env: Dict[str, str]):
        for k, v in env.items():
            os.environ[k] = v
        return True

    def node_ip(self) -> str:
        """Address of this worker's host for the rendezvous: its cluster
        node's host, or loopback for a forked worker (on the controller's
        host)."""
        from ray_tpu_torch.runtime.cluster_replica import driver_host

        return driver_host()

    def reserve_port(self) -> int:
        """Free port on this worker's host for the rendezvous store."""
        with socket.socket() as s:
            s.bind(("", 0))
            return s.getsockname()[1]

    def init_torch_distributed(self, init_method: str, world_size: int,
                               backend: str, timeout_s: float) -> int:
        """Join the workers' process group (reference analog: MASTER_ADDR
        + ``dist.init_process_group``, ``train/torch/config.py:153``).
        Worker 0 hosts the rendezvous store at ``init_method``. One
        all-reduce of ones proves the group formed (NCCL forms its
        communicator lazily otherwise)."""
        import torch
        import torch.distributed as dist

        if not dist.is_initialized():
            kwargs = {}
            device = torch.device("cpu")
            if backend == "nccl":
                device = torch.device("cuda", 0)
                torch.cuda.set_device(device)
                kwargs["device_id"] = device
            dist.init_process_group(
                backend, init_method=init_method, rank=self.rank,
                world_size=world_size,
                timeout=timedelta(seconds=max(timeout_s, 1.0)), **kwargs)
            ones = torch.ones(1, device=device)
            dist.all_reduce(ones)
            if int(ones.item()) != world_size:
                raise RuntimeError(f"all-reduce of ones over the new group "
                                   f"gave {ones.item()}, want {world_size}")
        return dist.get_rank()

    # ------------------------------------------------------- liveness
    def _heartbeat_loop(self, s: "session_mod._Session") -> None:
        """Stamp liveness every period until the session ends. Beats are
        surfaced two ways: the ``_hb_ts`` field returned by ``poll()``
        (the pipe) and a store record (``__train__`` namespace) so lapses
        are visible to the controller even if polls stall. The chaos
        ``train_heartbeat`` site can drop or delay beats."""
        period = _hb_period_s()
        kv = self._hb_kv
        key = f"hb/{self.group_id}/{self.rank:05d}"
        while not s.finished.wait(period):
            if s.stop.is_set():
                return
            d = chaos.inject("train_heartbeat", rank=self.rank) or {}
            if d.get("delay_s"):
                time.sleep(float(d["delay_s"]))
            if d.get("drop"):
                continue
            now = time.time()
            self._hb_ts = now
            if kv is not None:
                try:
                    kv.put(key, json.dumps({"ts": now, "rank": self.rank,
                                            "pid": os.getpid()}).encode())
                except Exception:  # noqa: BLE001 — KV push is best-effort
                    kv = None  # stop retrying a dead channel this session

    def stop(self) -> bool:
        """Cooperative teardown: flag the running session to unwind at its
        next report or save (elastic restart/resize)."""
        with self._lock:
            s = self._session
        if s is not None:
            s.stop.set()
        return True

    def run(self, fn: Callable, config: Optional[Dict[str, Any]],
            restore_checkpoint_path: Optional[str],
            run_dir: Optional[str] = None,
            datasets: Optional[Dict[str, Any]] = None):
        """Run the user train loop to completion (a blocking call). An
        error of the loop that is not a framework error comes back as
        :class:`~ray_tpu_torch.exceptions.RayTaskError` (the controller
        charges it to ``max_failures``). ``datasets`` is this rank's
        ``{name: DataIterator}``, its blocks carried in it."""
        ckpt = (Checkpoint(restore_checkpoint_path)
                if restore_checkpoint_path else None)
        s = session_mod._Session(self._ctx, ckpt, run_dir=run_dir,
                                 group_id=self.group_id, kv=self._ckpt_kv,
                                 dataset_shards=datasets)
        with self._lock:
            self._session = s
        session_mod._set_session(s)
        self._hb_ts = time.time()
        threading.Thread(target=self._heartbeat_loop, args=(s,),
                         daemon=True,
                         name=f"train-hb-{self.rank}").start()
        try:
            s.result = fn(config) if config is not None else fn()
            return s.result
        except exceptions.RayTpuError:
            raise
        except Exception as e:  # noqa: BLE001 — the user's loop failed
            raise exceptions.RayTaskError.from_exception(
                e, getattr(fn, "__qualname__", repr(fn))) from None
        finally:
            if s.checkpoint_plane is not None and not chaos.process_dying():
                # Join in-flight async saves so a committed manifest is
                # durable before the controller sees this worker finish.
                # Skipped when unwinding a chaos-injected kill: a dead
                # process would never have flushed either.
                try:
                    s.checkpoint_plane.close()
                except Exception:  # noqa: BLE001 — loop outcome wins
                    logger.exception("checkpoint plane close failed")
            s.ledger.close()  # freeze the attempt's goodput wall clock
            s.finished.set()
            session_mod._set_session(None)

    def poll(self) -> Dict[str, Any]:
        """Drain pending reports (runs concurrently with ``run``)."""
        with self._lock:
            s = self._session
        if s is None:
            return {"reports": [], "finished": False}
        reports = []
        while True:
            try:
                r = s.reports.get_nowait()
            except queue.Empty:
                break
            # Checkpoints cross the process boundary as paths.
            if r.get("checkpoint") is not None:
                r = dict(r, checkpoint_path=r.pop("checkpoint").path)
            reports.append(r)
        return {"reports": reports, "finished": s.finished.is_set(),
                "heartbeat_ts": self._hb_ts,
                "progress_ts": s.progress_ts, "last_step": s.last_step,
                # Goodput ledger snapshot (components sum to wall_s):
                # the controller differences consecutive snapshots into
                # ray_tpu_train_goodput_seconds_total{component}.
                "ledger": s.ledger.snapshot(), "pid": os.getpid()}


def visible_cards() -> List[str]:
    """The cards a ``use_gpu`` run may hand out; raises when there is no
    card (a GPU run never carries on in CPU processes)."""
    import torch

    from ray_tpu_torch.runtime.controller import _visible_gpus

    if not torch.cuda.is_available():
        raise RuntimeError(
            "ScalingConfig(use_gpu=True) but this host has no CUDA card; "
            "pass use_gpu=False to train in CPU processes")
    return _visible_gpus()


class WorkerGroup:
    """Reference: ``train/_internal/worker_group.py``. Starts
    ``scaling.num_workers`` workers (cluster actors on a cluster, else
    processes each on its cards: module docstring), waits until each is
    up, and pushes the chaos plan to them."""

    def __init__(self, scaling: ScalingConfig, group_id: str = "",
                 store_address: Optional[str] = None):
        from ray_tpu_torch.runtime.cluster_replica import cluster_core

        self.scaling = scaling
        self.group_id = group_id or uuid.uuid4().hex[:8]
        # The shares this group holds in the card book: (cards, share).
        self._held: List[Tuple[List[str], float]] = []
        self.workers: List[ReplicaProcess] = []
        n = scaling.num_workers
        kwargs = {"group_id": self.group_id, "store_address": store_address}
        threads = max(1, int(scaling.cpus_per_worker))
        try:
            if cluster_core() is not None:
                self._start_actors(kwargs, threads)
            else:
                self._fork(kwargs, threads)
            for w in self.workers:
                w.wait_ready(WORKER_START_S)
        except BaseException:
            self.shutdown()
            raise
        self._push_chaos()
        chaos.subscribe(self._push_chaos)

    def _start_actors(self, kwargs: Dict[str, Any], threads: int) -> None:
        """The workers as actors the GCS places (JAX ``:249-265``)."""
        from ray_tpu_torch.runtime.cluster_replica import ClusterReplica

        scaling, n = self.scaling, self.scaling.num_workers
        res = scaling.worker_resources()
        opts: Dict[str, Any] = {
            "num_cpus": res.get("CPU", 1),
            "resources": {k: v for k, v in res.items()
                          if k not in ("CPU", "GPU")}}
        if scaling.use_gpu:
            opts["num_gpus"] = float(scaling.gpus_per_worker or 1.0)
        for rank in range(n):
            self.workers.append(ClusterReplica(
                "train", TrainWorker, (rank, n, rank, n), kwargs, False,
                sync_workers=3, actor_options=opts, control_slots=0,
                num_threads=threads))

    def _fork(self, kwargs: Dict[str, Any], threads: int) -> None:
        """The workers as processes forked here, on cards of this
        process's card book."""
        from ray_tpu_torch.runtime.controller import CARDS, _place

        scaling, n = self.scaling, self.scaling.num_workers
        if scaling.use_gpu:
            cards = visible_cards()
            per = float(scaling.gpus_per_worker or 1.0)
            empty: Dict[str, float] = {}
            got = None
            if all(_place(empty, cards, per) is not None for _ in range(n)):
                # It fits the host: wait for replicas (or another group)
                # to give shares back.
                got = CARDS.take(per, n, timeout_s=WORKER_START_S)
            if got is None:
                raise RuntimeError(
                    f"{n} workers of {per} GPU each do not fit the "
                    f"host's cards {cards} (in use: {CARDS.use()})")
            self._held = [(c, 1.0 if per >= 1 else per) for c in got]
            envs = [{"CUDA_VISIBLE_DEVICES": ",".join(c)} for c in got]
        else:
            envs = [{"CUDA_VISIBLE_DEVICES": ""} for _ in range(n)]
        for rank in range(n):
            self.workers.append(ReplicaProcess(
                "train", TrainWorker, (rank, n, rank, n), kwargs,
                False, sync_workers=3, env=envs[rank],
                num_threads=threads))

    def _push_chaos(self) -> None:
        shared = chaos.state()
        for w in self.workers:
            w.push_chaos(shared)

    def _results(self, futures: List[Future],
                 timeout_s: Optional[float]) -> List[Any]:
        """Each future's result in rank order; the first failure raises
        with ``failed_rank`` set on it (and, for a worker a chaos kill
        ended, the firing's ``event_id``)."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        out = []
        for rank, fut in enumerate(futures):
            left = None if deadline is None else max(
                deadline - time.monotonic(), 0.0)
            try:
                out.append(fut.result(timeout=left))
            except FutureTimeout:
                raise exceptions.WorkerHangError(
                    f"rank {rank} did not answer within {timeout_s:.1f}s",
                    rank=rank, kind="heartbeat") from None
            except BaseException as e:  # noqa: BLE001 — annotate + re-raise
                self._annotate(e, rank)
                raise
        return out

    def _annotate(self, e: BaseException, rank: int) -> None:
        try:
            e.failed_rank = rank
            if isinstance(e, exceptions.ActorDiedError):
                pid = self.workers[rank].pid
                kills = [x for x in chaos.injection_log()
                         if x.get("pid") == pid and
                         x.get("action") == "kill_worker"]
                if kills:
                    e.event_id = kills[-1].get("event_id", "")
        except Exception:  # noqa: BLE001 — frozen exception type
            pass

    def first_dead(self, grace_s: float) -> Optional[BaseException]:
        """The error of the first worker process found dead within
        ``grace_s`` (annotated like a failed call), or None."""
        deadline = time.monotonic() + grace_s
        while True:
            for rank, w in enumerate(self.workers):
                if not w.alive:
                    err = exceptions.ActorDiedError(
                        error_msg=f"train worker process {w.pid} "
                                  f"(rank {rank}) died")
                    self._annotate(err, rank)
                    return err
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.02)

    def execute_async(self, method: str, *args, **kwargs) -> List[Future]:
        return [w.call(method, args, kwargs) for w in self.workers]

    def execute(self, method: str, *args, timeout_s: Optional[float] = None,
                **kwargs) -> List[Any]:
        return self._results(self.execute_async(method, *args, **kwargs),
                             timeout_s)

    def execute_per_rank(self, method: str, *args,
                         timeout_s: Optional[float] = None,
                         **kwargs) -> List[Any]:
        """Like :meth:`execute`; a failure is attributed: raises the first
        failing rank's exception with ``failed_rank`` set on it. Every
        call goes out before any answer is read, so one round costs one
        round trip."""
        return self.execute(method, *args, timeout_s=timeout_s, **kwargs)

    def shutdown(self, graceful: bool = False):
        """Kill the workers (``graceful``: ask each to exit first, as at
        the end of a finished run), then give the group's card shares
        back to the book (a cluster group holds none)."""
        from ray_tpu_torch.runtime.controller import CARDS

        chaos.unsubscribe(self._push_chaos)
        for w in self.workers:
            try:
                if graceful:
                    w.stop(timeout_s=10.0)
                else:
                    w.kill()
            except Exception:  # noqa: BLE001 — teardown must proceed
                logger.exception("train worker teardown failed")
        self.workers = []
        held, self._held = self._held, []
        for cards, share in held:
            CARDS.give(cards, share)


class TorchBackend:
    """Backend plugin (reference ABC: ``train/backend.py``; the JAX
    package's ``JaxBackend``)."""

    # Rendezvous retries: a stale/raced port rebinds to a fresh one with
    # exponential backoff before the environment is declared unable to
    # form a process group.
    COORD_ATTEMPTS = 3
    COORD_BACKOFF_S = 0.5

    def on_start(self, worker_group: WorkerGroup, scaling: ScalingConfig):
        env = {"RAY_TPU_TRAIN_WORLD_SIZE": str(scaling.num_workers)}
        worker_group.execute("setup", env, timeout_s=60.0)
        if scaling.torch_distributed and scaling.num_workers > 1:
            self._bootstrap_torch_distributed(worker_group, scaling)

    def _bootstrap_torch_distributed(self, worker_group: WorkerGroup,
                                     scaling: ScalingConfig) -> None:
        attempts = int(os.environ.get("RAY_TPU_TORCH_COORD_ATTEMPTS",
                                      self.COORD_ATTEMPTS))
        timeout_s = float(os.environ.get("RAY_TPU_TORCH_COORD_TIMEOUT_S",
                                         60.0))
        backend = "nccl" if scaling.use_gpu else "gloo"
        w0 = worker_group.workers[0]
        host = w0.call("node_ip", (), {}).result(timeout=60.0)
        last_err: Optional[BaseException] = None
        for attempt in range(attempts):
            # Fresh port every attempt: the dominant transient failure is
            # a rendezvous port that raced another bind or lingers in
            # TIME_WAIT from a previous (failed) group.
            port = w0.call("reserve_port", (), {}).result(timeout=60.0)
            init_method = f"tcp://{host}:{port}"
            try:
                # Bounded join (the group's own timeout, plus slack for
                # the all-reduce): a rendezvous that never completes
                # reaches the retry path instead of hanging.
                ranks = worker_group.execute(
                    "init_torch_distributed", init_method,
                    scaling.num_workers, backend, timeout_s,
                    timeout_s=timeout_s + 30.0)
                logger.info("torch.distributed group formed (%s): %s "
                            "ranks=%s", backend, init_method, ranks)
                return
            except (exceptions.ActorDiedError,
                    exceptions.WorkerHangError):
                raise            # a worker died or wedged: not a bind race
            except Exception as e:  # noqa: BLE001 — bind/timeout/raced port
                last_err = e
                backoff = self.COORD_BACKOFF_S * (2 ** attempt)
                logger.warning(
                    "torch.distributed bootstrap attempt %d/%d failed on "
                    "%s (%s); rebinding the rendezvous port and retrying "
                    "in %.1fs", attempt + 1, attempts, init_method, e,
                    backoff)
                time.sleep(backoff)
        raise exceptions.DistributedBootstrapError(
            f"could not form a {backend} process group after {attempts} "
            f"rendezvous attempts: {last_err}")

    def on_shutdown(self, worker_group: WorkerGroup):
        pass


class BackendExecutor:
    """Reference: ``train/_internal/backend_executor.py:69``. ``store`` is
    the controller's ``TCPStore`` (its address goes to the workers)."""

    def __init__(self, scaling: ScalingConfig,
                 backend: Optional[TorchBackend] = None, store=None):
        self.scaling = scaling
        self.backend = backend or TorchBackend()
        self.store = store
        self.kv = StoreKV(store, TRAIN_KV_NS) if store is not None else None
        self.worker_group: Optional[WorkerGroup] = None
        self._training_started_at: Optional[float] = None
        # rank -> (newest heartbeat stamp observed, controller-monotonic
        # time it changed) — the basis for skew-proof lapse detection.
        self._hb_seen: Dict[int, Tuple[float, float]] = {}

    @property
    def group_id(self) -> str:
        return self.worker_group.group_id if self.worker_group else ""

    def start(self):
        address = None
        if self.store is not None:
            address = f"{self.store.host}:{self.store.port}"
        self.worker_group = WorkerGroup(self.scaling, store_address=address)
        self.backend.on_start(self.worker_group, self.scaling)

    def start_training(self, train_fn: Callable,
                       config: Optional[Dict[str, Any]],
                       restore_checkpoint_path: Optional[str],
                       run_dir: Optional[str] = None,
                       datasets: Optional[List[Dict[str, Any]]] = None
                       ) -> List[Future]:
        """``datasets`` is PER-RANK: element ``i`` is rank i's
        ``{name: DataIterator}`` map of disjoint shards, each holding its
        blocks (they cross the worker's pipe with the call); every other
        argument is the same for every rank."""
        assert self.worker_group is not None
        futs = [w.call("run", (train_fn, config, restore_checkpoint_path,
                               run_dir, datasets[rank] if datasets
                               else None), {})
                for rank, w in enumerate(self.worker_group.workers)]
        self._hb_seen.clear()
        self._training_started_at = time.monotonic()
        return futs

    def run_results(self, futs: List[Future],
                    grace_s: float = 1.0) -> List[Any]:
        """The finished runs' results (raises the first failed rank's
        error, attributed). A run that failed while another worker's
        process is dead (or dies within ``grace_s``) is that worker's
        loss: a collective fails in every peer of a dead rank."""
        assert self.worker_group is not None
        try:
            return self.worker_group._results(futs, None)
        except exceptions.ActorDiedError:
            raise
        except BaseException as e:  # noqa: BLE001 — reclassified below
            # A peer's collective error reaches the loop as a plain
            # error (RayTaskError); wait a moment for the death that
            # caused it to show.
            dead = self.worker_group.first_dead(
                grace_s if isinstance(e, exceptions.RayTaskError) else 0.0)
            if dead is not None:
                raise dead from e
            raise

    def poll(self) -> List[Dict[str, Any]]:
        """Drain worker reports AND probe liveness: raises
        ``ActorDiedError`` (with ``failed_rank``) for a dead worker, and
        ``WorkerHangError(kind="heartbeat")`` when a live-looking worker's
        heartbeats lapsed past ``RAY_TPU_TRAIN_HEARTBEAT_TTL_S`` or its
        poll went unanswered."""
        assert self.worker_group is not None
        polls = self.worker_group.execute_per_rank(
            "poll", timeout_s=POLL_TIMEOUT_S)
        self._check_heartbeats(polls)
        return polls

    def _check_heartbeats(self, polls: List[Dict[str, Any]]) -> None:
        """Staleness is measured CONTROLLER-side: a rank lapses when the
        heartbeat stamp it reports stops *changing* for longer than the
        TTL on the controller's monotonic clock — never by differencing
        two hosts' wall clocks."""
        ttl = _hb_ttl_s()
        if ttl <= 0 or self._training_started_at is None:
            return
        mono = time.monotonic()
        for rank, p in enumerate(polls):
            if p.get("finished") or "heartbeat_ts" not in p:
                continue
            hb = float(p.get("heartbeat_ts") or 0.0)
            seen = self._hb_seen.get(rank)
            if seen is None or hb > seen[0]:
                self._hb_seen[rank] = (hb, mono)
                continue
            if mono - seen[1] > ttl:
                # Second opinion from the store's record before declaring
                # a lapse — only probed once the pipe's stamp is stale,
                # so the common case costs no store round-trip.
                kv_hb = self._kv_heartbeat(rank)
                if kv_hb > seen[0]:
                    self._hb_seen[rank] = (kv_hb, mono)
                    continue
                raise exceptions.WorkerHangError(
                    f"rank {rank} heartbeats stalled "
                    f"{mono - seen[1]:.1f}s (TTL {ttl:.1f}s)",
                    rank=rank, kind="heartbeat")

    def _kv_heartbeat(self, rank: int) -> float:
        if self.kv is None:
            return 0.0
        try:
            raw = self.kv.get(f"hb/{self.group_id}/{rank:05d}")
            return float(json.loads(raw)["ts"]) if raw else 0.0
        except Exception:  # noqa: BLE001 — KV probe is best-effort
            return 0.0

    def shutdown(self, graceful: bool = False):
        if self.worker_group is not None:
            group_id = self.worker_group.group_id
            try:
                self.backend.on_shutdown(self.worker_group)
            except Exception:  # noqa: BLE001 — teardown must proceed
                logger.exception("backend on_shutdown failed")
            self.worker_group.shutdown(graceful=graceful)
            self._drop_heartbeat_records(group_id)
            self.worker_group = None
            self._training_started_at = None
            self._hb_seen.clear()

    def _drop_heartbeat_records(self, group_id: str) -> None:
        """GC this generation's ``hb/<group_id>/*`` records — every
        elastic restart mints a fresh group_id, so without the sweep a
        long run accumulates stale heartbeat keys."""
        if self.kv is None:
            return
        try:
            for key in self.kv.list(f"hb/{group_id}/"):
                self.kv.delete(key)
        except Exception:  # noqa: BLE001 — KV gc is best-effort
            pass
