"""LocalRuntime: in-process task/actor execution with real future semantics.

Re-design of the reference single-process paths (reference: local mode in
``python/ray/_private/worker.py`` + the CoreWorker task lifecycle in
``src/ray/core_worker/core_worker.cc``): tasks run on a thread pool once their
``ObjectRef`` dependencies are ready (dependency-resolution mirrors
``transport/dependency_resolver.h`` — top-level args are resolved to values,
nested refs are passed through); errors become ``RayTaskError`` values stored
in the task's return objects and re-raised at ``get``; retries honour
``max_retries``/``retry_exceptions`` (reference: ``task_manager.h:212``);
actors are threads with ordered (or concurrent) inboxes mirroring the actor
scheduling queues of ``transport/actor_scheduling_queue.h``.

Resource admission mirrors the raylet's local resource manager
(reference: ``raylet/local_task_manager.cc``): a dispatcher admits queued
tasks only when their resource demand fits the node's available resources,
and — like the reference raylet — a task blocked in ``get()`` temporarily
returns its CPU resources so nested task trees cannot deadlock the node.

This is the port's copy of ``ray_tpu/_private/runtime/local.py``, the runtime
``ray_tpu_torch.init()`` starts. Functions and classes run as they are, never
serialized (there is no wire in process), and the store holds each value by
reference, so a CUDA tensor stays on its card. The node's accelerator is the
CUDA card (``"GPU"``); local mode assigns no card ids, so a ``num_gpus=1``
actor on a one-card host uses ``cuda`` as any code in the process does.
Placement groups are single-node and their state is a dataclass
(:class:`~ray_tpu_torch.util.placement_group.PlacementGroupInfo`) where JAX
keeps a protobuf message. :meth:`LocalRuntime.shutdown` ends the dispatcher,
the task pool and the actors' threads before it returns.
"""

from __future__ import annotations

import asyncio
import contextvars
import dataclasses
import inspect
import logging
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch import exceptions
from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID, ObjectID,
                                        TaskID)
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private import options as opt_mod
from ray_tpu_torch._private.options import RemoteOptions
from ray_tpu_torch._private.runtime.interface import CoreRuntime

logger = logging.getLogger(__name__)

# Seconds ``LocalRuntime.shutdown`` waits in all for the runtime's threads.
SHUTDOWN_JOIN_S = 10.0

_context: contextvars.ContextVar[Optional["_TaskCtx"]] = contextvars.ContextVar(
    "ray_tpu_task_ctx", default=None)


def current_task_context() -> Optional["_TaskCtx"]:
    return _context.get()


class _TaskCtx:
    __slots__ = ("task_id", "actor_id", "attempt", "name", "resources",
                 "ledger")

    def __init__(self, task_id, actor_id=None, attempt=0, name="",
                 resources=None, ledger=None):
        self.task_id = task_id
        self.actor_id = actor_id
        self.attempt = attempt
        self.name = name
        self.resources = resources or {}
        self.ledger = ledger  # bundle ledger for PG tasks; None = main


def _resolve_retry(exc: BaseException, retry_exceptions, retries_left: int) -> bool:
    if retries_left <= 0:
        return False
    if isinstance(exc, exceptions.TaskCancelledError):
        return False
    if retry_exceptions is False:
        # Only system failures are retried by default; in-process execution
        # has no worker crashes, so application errors never retry.
        return False
    if retry_exceptions is True:
        return True
    return isinstance(exc, tuple(retry_exceptions))


class _ResourceLedger:
    """Node-local resource accounting with blocking-release semantics."""

    def __init__(self, total: Dict[str, float]):
        self.total = dict(total)
        self.available = dict(total)
        self.cv = threading.Condition()

    def feasible(self, demand: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        with self.cv:
            if all(self.available.get(k, 0.0) + 1e-9 >= v for k, v in demand.items()):
                for k, v in demand.items():
                    self.available[k] = self.available.get(k, 0.0) - v
                return True
            return False

    def release(self, demand: Dict[str, float]) -> None:
        with self.cv:
            for k, v in demand.items():
                self.available[k] = self.available.get(k, 0.0) + v
            self.cv.notify_all()

    def snapshot(self) -> Dict[str, float]:
        with self.cv:
            return {k: round(v, 6) for k, v in self.available.items()}


class _LocalActor:
    """An actor instance executing methods on its own thread(s).

    Ordered single-thread execution for ``max_concurrency == 1`` (the
    reference's ordered actor scheduling queue); a small pool when more
    concurrency is requested; an asyncio loop when the class defines any
    coroutine methods (reference: fibers / async actors).
    """

    def __init__(self, runtime: "LocalRuntime", actor_id: ActorID, cls: type,
                 args: tuple, kwargs: dict, options: RemoteOptions):
        self.runtime = runtime
        self.actor_id = actor_id
        self.cls = cls
        self.init_args = args
        self.init_kwargs = kwargs
        self.options = options
        self.instance = None
        self.dead = False
        self.death_cause: Optional[BaseException] = None
        from ray_tpu_torch._private import concurrency as _conc

        # Inherited coroutine (and async-generator) methods count too.
        self.is_async = _conc.class_is_async(cls)
        self.max_concurrency = _conc.effective_max_concurrency(
            self.is_async, options.max_concurrency)
        # Concurrency groups (reference: concurrency_group_manager.h):
        # per-group caps; declaring groups on a sync actor switches it to
        # threaded execution (same rule as the cluster worker).
        self.groups: Dict[str, int] = dict(options.concurrency_groups or {})
        self._inbox: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._thread: Optional[threading.Thread] = None
        # Every executor this actor starts (its threads end with it).
        self._group_pools: Dict[str, ThreadPoolExecutor] = {}

    def start(self):
        t = threading.Thread(target=self._run,
                             name=f"actor-{self.actor_id.hex()[:8]}",
                             daemon=True)
        self._thread = t
        t.start()

    # -- thread bodies ----------------------------------------------------
    def _run(self):
        if getattr(self, "pg_ctx", None) is not None:
            # Capturing PG: the actor thread inherits the group, so the
            # constructor and every (ordered-mode) method schedule children
            # into it (placement_group_capture_child_tasks).
            from ray_tpu_torch._private import pg_context
            pg_context.set(*self.pg_ctx)
        try:
            self.instance = self.cls(*self.init_args, **self.init_kwargs)
        except BaseException as e:  # noqa: BLE001
            self._die(exceptions.RayTaskError.from_exception(
                e, f"{self.cls.__name__}.__init__"))
            return
        self.runtime._actor_started(self.actor_id)
        try:
            if self.is_async:
                self._run_async_loop()
            elif self.max_concurrency > 1 or self.groups:
                self._run_concurrent()
            else:
                self._run_ordered()
        finally:
            # The actor is gone and its last call returned: drop the
            # instance, so what it holds (an engine's device memory) is
            # freed, though the runtime keeps the actor's record.
            self.instance = None

    def _run_ordered(self):
        while True:
            item = self._inbox.get()
            if item is None:
                return
            self._execute(*item)

    def _group_of(self, method_name: str) -> str:
        from ray_tpu_torch._private import concurrency as _conc

        return _conc.group_of(getattr(self.instance, method_name, None),
                              self.groups)

    def _run_concurrent(self):
        # One pool PER concurrency group, sized to the group's cap (the
        # default group gets max_concurrency) — the pool itself is the
        # gate, so a backlogged group queues in its own executor and can
        # never occupy another group's threads (reference:
        # concurrency_group_manager.h: one BoundedExecutor per group).
        self._group_pools.update({
            name: ThreadPoolExecutor(
                max_workers=int(cap),
                thread_name_prefix=f"actor-{self.actor_id.hex()[:6]}-{name}")
            for name, cap in self.groups.items()})
        self._group_pools[""] = self._pool = ThreadPoolExecutor(
            max_workers=self.max_concurrency,
            thread_name_prefix=f"actor-{self.actor_id.hex()[:6]}")
        while True:
            item = self._inbox.get()
            if item is None:
                # Calls already handed to a pool finish first (as in
                # JAX; the instance is dropped after them).
                for pool in self._group_pools.values():
                    pool.shutdown(wait=True)
                return
            try:
                pool = self._group_pools[self._group_of(item[0])]
            except ValueError as e:
                self.runtime._store_error(
                    exceptions.RayTaskError.from_exception(
                        e, f"{self.cls.__name__}.{item[0]}"), item[3])
                continue
            pool.submit(self._execute, *item)

    def _run_async_loop(self):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        # The inbox is read on a thread of this actor's own (not the
        # loop's default executor), so shutdown can join it.
        inbox = self._group_pools["__inbox__"] = ThreadPoolExecutor(
            max_workers=1,
            thread_name_prefix=f"actor-{self.actor_id.hex()[:6]}-inbox")
        sems = {"": asyncio.Semaphore(self.max_concurrency)}
        for name, cap in self.groups.items():
            sems[name] = asyncio.Semaphore(int(cap))

        async def pump():
            while True:
                item = await loop.run_in_executor(inbox, self._inbox.get)
                if item is None:
                    return
                try:
                    sem = sems[self._group_of(item[0])]
                except ValueError as e:
                    self.runtime._store_error(
                        exceptions.RayTaskError.from_exception(
                            e, f"{self.cls.__name__}.{item[0]}"), item[3])
                    continue

                # Acquire INSIDE the task: a saturated group must not
                # head-of-line block the pump (other groups keep flowing)
                # — same placement as the cluster worker's
                # _run_async_actor_method.
                async def run(item=item, sem=sem):
                    async with sem:
                        await self._execute_async(*item)

                loop.create_task(run())

        try:
            loop.run_until_complete(pump())
        finally:
            try:
                pending = asyncio.all_tasks(loop)
                for t in pending:
                    t.cancel()
                loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
            except Exception:
                pass
            loop.close()
            inbox.shutdown(wait=False)

    # -- execution --------------------------------------------------------
    def _execute(self, method_name: str, args, kwargs, return_ids: List[ObjectID],
                 task_id: TaskID, streaming: bool = False):
        token = _context.set(_TaskCtx(task_id, self.actor_id,
                                      name=f"{self.cls.__name__}.{method_name}"))
        try:
            if method_name == "__ray_dag_loop__":
                # Compiled-DAG pinned loop (see experimental/channel.py).
                from ray_tpu_torch.experimental.channel import run_dag_loop

                result = run_dag_loop(self.instance, *args)
            else:
                method = getattr(self.instance, method_name)
                result = method(*args, **kwargs)
            if inspect.isgenerator(result):
                self.runtime._store_generator(result, return_ids, task_id,
                                              streaming=streaming)
            elif streaming:
                raise TypeError(
                    f"num_returns='streaming' requires a generator method, "
                    f"but {method_name!r} returned {type(result).__name__}")
            else:
                self.runtime._store_results(result, return_ids)
        except exceptions.AsyncioActorExit:
            self.runtime._store_results(None, return_ids)
            self.terminate()
        except BaseException as e:  # noqa: BLE001
            if self._maybe_simulated_death(e, return_ids):
                return
            if self._maybe_died_in_flight(return_ids):
                return
            err = exceptions.RayTaskError.from_exception(
                e, f"{self.cls.__name__}.{method_name}", task_id)
            self.runtime._store_error(err, return_ids)
        finally:
            _context.reset(token)

    def _maybe_died_in_flight(self, return_ids) -> bool:
        """The actor died OUT FROM UNDER this in-flight call (a
        concurrent task hit a simulated process death and the dying
        event loop cancelled this one): a real process death fails every
        in-flight call with actor death, so the caller must see
        ActorDiedError — not a RayTaskError(CancelledError) that reads
        as a bug in the user method."""
        with self._lock:
            if not self.dead:
                return False
            cause = self.death_cause
        self.runtime._store_error(
            exceptions.ActorDiedError(
                self.actor_id,
                f"Actor {self.actor_id.hex()} died: {cause}"),
            return_ids)
        return True

    def _maybe_simulated_death(self, e: BaseException, return_ids) -> bool:
        """Chaos-injected process kill: the in-process runtime cannot lose
        a real OS process, so the harness raises SimulatedProcessDeath and
        this converts it into genuine actor death — ActorDiedError on the
        in-flight call and every queued one, exactly what a controller
        polling a worker whose host died would observe."""
        from ray_tpu_torch._private import chaos

        if not isinstance(e, chaos.SimulatedProcessDeath):
            return False
        err = exceptions.ActorDiedError(
            self.actor_id,
            f"Actor {self.actor_id.hex()} died: {e.reason}")
        self.runtime._store_error(err, return_ids)
        self._die(err)
        chaos._clear_dying()
        return True

    async def _execute_async(self, method_name, args, kwargs, return_ids,
                             task_id, streaming: bool = False):
        # ContextVar set inside an asyncio task is task-local, so concurrent
        # coroutines keep distinct task contexts.
        token = _context.set(_TaskCtx(task_id, self.actor_id,
                                      name=f"{self.cls.__name__}.{method_name}"))
        try:
            method = getattr(self.instance, method_name)
            result = method(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            if inspect.isasyncgen(result):
                if streaming:
                    from ray_tpu_torch._private.object_ref import \
                        drain_stream_async

                    n = await drain_stream_async(result, task_id,
                                                 self.runtime.store.put)
                    self.runtime._store_results(n, return_ids)
                else:
                    self.runtime._store_results(
                        [item async for item in result], return_ids)
            elif inspect.isgenerator(result):
                self.runtime._store_generator(result, return_ids, task_id,
                                              streaming=streaming)
            elif streaming:
                raise TypeError(
                    f"num_returns='streaming' requires a generator method, "
                    f"but {method_name!r} returned {type(result).__name__}")
            else:
                self.runtime._store_results(result, return_ids)
        except exceptions.AsyncioActorExit:
            self.runtime._store_results(None, return_ids)
            self.terminate()
        except BaseException as e:  # noqa: BLE001
            if self._maybe_simulated_death(e, return_ids):
                return
            if self._maybe_died_in_flight(return_ids):
                return
            err = exceptions.RayTaskError.from_exception(
                e, f"{self.cls.__name__}.{method_name}", task_id)
            self.runtime._store_error(err, return_ids)
        finally:
            _context.reset(token)

    # -- lifecycle --------------------------------------------------------
    def submit(self, method_name, args, kwargs, return_ids, task_id,
               streaming: bool = False):
        with self._lock:
            if self.dead:
                err = exceptions.ActorDiedError(
                    self.actor_id,
                    f"Actor {self.actor_id.hex()} is dead: {self.death_cause}")
                self.runtime._store_error(err, return_ids)
                return
            if (self.options.max_pending_calls >= 0
                    and self._inbox.qsize() >= self.options.max_pending_calls):
                raise exceptions.PendingCallsLimitExceeded(
                    f"Actor {self.actor_id.hex()} has "
                    f">={self.options.max_pending_calls} pending calls")
            self._inbox.put((method_name, args, kwargs, return_ids, task_id,
                             streaming))

    def _die(self, cause: Optional[BaseException]):
        with self._lock:
            if self.dead:
                return
            self.dead = True
            self.death_cause = cause
        # Fail everything still queued, then unblock the worker thread.
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            return_ids = item[3]
            self.runtime._store_error(
                exceptions.ActorDiedError(self.actor_id, f"Actor died: {cause}"),
                return_ids)
        self._inbox.put(None)
        self.runtime._actor_died(self.actor_id, cause)

    def terminate(self, no_restart: bool = True):
        with self._lock:
            if self.dead:
                return
            self.dead = True
        self._inbox.put(None)
        self.runtime._actor_died(self.actor_id, None)

    def threads(self) -> List[threading.Thread]:
        """The threads this actor started (its own, its pools')."""
        out = [self._thread] if self._thread is not None else []
        for pool in list(self._group_pools.values()):
            out += list(pool._threads)
        return out


class _AnyBundleLedger:
    """Per-task view over a group's bundle ledgers for bundle_index=-1: the
    acquire picks whichever bundle fits and the release returns to it."""

    def __init__(self, ledgers: Dict[Any, "_ResourceLedger"]):
        self._ledgers = [l for i, l in sorted(ledgers.items())]
        self._charged: Optional[_ResourceLedger] = None
        self.total: Dict[str, float] = {}
        for led in self._ledgers:
            for k, v in led.total.items():
                self.total[k] = max(self.total.get(k, 0.0), v)

    @property
    def dead(self) -> bool:
        return any(getattr(l, "dead", False) for l in self._ledgers)

    def feasible(self, demand: Dict[str, float]) -> bool:
        return any(all(led.total.get(k, 0.0) + 1e-9 >= v
                       for k, v in demand.items()) for led in self._ledgers)

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        if self._charged is not None:
            # Re-acquisition after a blocked-get release sticks to the
            # bundle this task originally charged.
            return self._charged.try_acquire(demand)
        for led in self._ledgers:
            if led.try_acquire(demand):
                self._charged = led
                return True
        return False

    def release(self, demand: Dict[str, float]) -> None:
        if self._charged is not None:
            self._charged.release(demand)

    @property
    def cv(self):
        return (self._charged or self._ledgers[0]).cv


class _PendingTask:  # admission unit; ``ledger=None`` charges the main ledger
    __slots__ = ("fn", "demand", "return_ids", "warned", "ledger")

    def __init__(self, fn, demand, return_ids, ledger=None):
        self.fn = fn
        self.demand = demand
        self.return_ids = return_ids
        self.warned = False
        self.ledger = ledger


class LocalRuntime(CoreRuntime):
    def __init__(self, num_cpus: float = 8, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 node_ip: str = "127.0.0.1"):
        self.job_id = JobID.from_int(1)
        self.node_id = NodeID.from_random()
        self.node_ip = node_ip
        self.store = MemoryStore()
        # Elastic pool: tasks may block on nested get(); true parallelism is
        # limited by resource admission, not pool size.
        self.pool = ThreadPoolExecutor(max_workers=max(64, int(num_cpus) * 8),
                                       thread_name_prefix="task")
        total: Dict[str, float] = {"CPU": float(num_cpus)}
        if num_gpus:
            total["GPU"] = float(num_gpus)
        total.update(resources or {})
        self.ledger = _ResourceLedger(total)
        # Placement groups, single-node edition: a group reserves its summed
        # resources from the main ledger at creation; PG-targeted tasks then
        # charge per-bundle ledgers (bundle_index=-1 charges a group-level
        # ledger — a local-mode simplification of "any bundle").
        self._pgroups: Dict[bytes, Any] = {}
        self._pg_ledgers: Dict[bytes, Dict[Any, _ResourceLedger]] = {}
        self._dispatch_queue: "queue.Queue[Optional[_PendingTask]]" = queue.Queue()
        self._pending: List[_PendingTask] = []
        self._actors: Dict[ActorID, _LocalActor] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._actor_meta: Dict[ActorID, Dict[str, Any]] = {}
        self._cancelled: set = set()
        self._lock = threading.Lock()
        self._shutdown = False
        # Local reference counts: live ObjectRef instances per object. When a
        # count returns to zero the stored value is evicted (single-process
        # analog of the distributed refcount GC).
        self._refcounts: Dict[ObjectID, int] = {}
        self._ref_lock = threading.Lock()
        self._reapers: List[threading.Thread] = []
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="dispatcher", daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------- dispatch
    def _dispatch_loop(self):
        """Admit queued tasks when their resource demand fits (reference:
        ``LocalTaskManager::DispatchScheduledTasksToWorkers``)."""
        while True:
            # Block for new arrivals or a resource release.
            try:
                item = self._dispatch_queue.get(timeout=0.1)
            except queue.Empty:
                item = False  # timeout: re-scan pending (resources may be free)
            if self._shutdown:
                return
            if item is None:
                return
            if item is not False:
                self._pending.append(item)
            still_pending = []
            for t in self._pending:
                led = t.ledger if t.ledger is not None else self.ledger
                if t.ledger is not None and getattr(led, "dead", False):
                    # The task's placement group was removed while it was
                    # queued (cluster analog: pg-unknown lease rejection).
                    self._store_error(
                        exceptions.RayTpuError(
                            "placement group was removed before the task "
                            "could be scheduled"), t.return_ids)
                    continue
                if not led.feasible(t.demand):
                    if not t.warned:
                        t.warned = True
                        logger.warning(
                            "Task demands %s which exceeds total cluster resources"
                            " %s; it will hang until resources are added (parity"
                            " with reference infeasible tasks).",
                            t.demand, led.total)
                    still_pending.append(t)
                elif led.try_acquire(t.demand):
                    self.pool.submit(t.fn)
                else:
                    still_pending.append(t)
            self._pending = still_pending

    def _enqueue(self, fn, demand, return_ids, ledger=None):
        self._dispatch_queue.put(
            _PendingTask(fn, demand, return_ids, ledger=ledger))

    # ---------------------------------------------------------------- objects
    def put(self, value: Any, owner_ref: Optional[ObjectRef] = None) -> ObjectRef:
        ctx = current_task_context()
        task_id = ctx.task_id if ctx else TaskID.for_driver(self.job_id)
        with self._lock:
            oid = ObjectID.from_task(task_id, self._next_put_index())
        self.store.put(oid, value)
        return ObjectRef(oid, owner_address="local")

    _put_index = 0

    def _next_put_index(self) -> int:
        self._put_index += 1
        return 2**31 + (self._put_index % 2**30)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        ctx = current_task_context()
        release = {}
        led = self.ledger
        if ctx is not None and ctx.resources:
            # A task blocked in get() returns its CPU so dependents can run
            # (reference: raylet releases CPU of blocked workers). PG tasks
            # return it to their bundle ledger so same-bundle children can
            # be admitted (the canonical tree-of-tasks-in-a-PG pattern).
            release = {k: v for k, v in ctx.resources.items() if k == "CPU"}
            if ctx.ledger is not None:
                led = ctx.ledger
        if release:
            led.release(release)
            self._dispatch_queue.put(False)
        try:
            deadline = None if timeout is None else time.monotonic() + timeout
            out = []
            for ref in refs:
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                value = self.store.get(ref.id(), remaining)
                if isinstance(value, exceptions.RayTaskError):
                    raise value.as_instanceof_cause()
                if isinstance(value, exceptions.RayTpuError):
                    raise value
                out.append(value)
            return out
        finally:
            if release:
                self._reacquire(release, led)

    def _reacquire(self, demand, ledger=None):
        led = ledger if ledger is not None else self.ledger
        while not led.try_acquire(demand) and not self._shutdown:
            with led.cv:
                led.cv.wait(timeout=0.05)

    def wait(self, refs, num_returns, timeout, fetch_local):
        ids = [r.id() for r in refs]
        ready_ids, _ = self.store.wait(ids, num_returns, timeout)
        ready_set = set(ready_ids)
        ready = [r for r in refs if r.id() in ready_set]
        not_ready = [r for r in refs if r.id() not in ready_set]
        return ready, not_ready

    def free(self, refs):
        self.store.delete([r.id() for r in refs])

    # ------------------------------------------------------------- references
    def add_local_reference(self, ref: ObjectRef) -> None:
        with self._ref_lock:
            self._refcounts[ref.id()] = self._refcounts.get(ref.id(), 0) + 1

    def remove_local_reference(self, object_id: ObjectID) -> None:
        if self._shutdown:
            return
        with self._ref_lock:
            n = self._refcounts.get(object_id, 0) - 1
            if n <= 0:
                self._refcounts.pop(object_id, None)
            else:
                self._refcounts[object_id] = n
        if n == 0:
            self.store.delete([object_id])

    # ---------------------------------------------------------------- tasks
    def submit_task(self, function, function_name, args, kwargs, options):
        task_id = TaskID.for_normal_task(self.job_id)
        nreturns = options.num_returns
        if opt_mod.is_streaming(nreturns):
            nreturns = 1
        return_ids = [ObjectID.from_task(task_id, i) for i in range(max(nreturns, 1))]
        retries = options.max_retries
        if retries is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            retries = GLOBAL_CONFIG.task_max_retries
        demand = options.task_resources()
        from ray_tpu_torch._private.options import resolve_placement

        pf = resolve_placement(options)
        pg_ctx = ((pf.placement_group_id, pf.bundle_index,
                   pf.capture_child_tasks)
                  if pf.placement_group_id else None)

        def on_ready(rargs, rkwargs):
            def run(ledger=None):
                self._run_task(function, function_name, rargs, rkwargs,
                               return_ids, task_id, retries, options,
                               demand, ledger=ledger, pg_ctx=pg_ctx)

            if pf.placement_group_id:
                # Resolve the bundle ledger off-thread: the group may still
                # be placing (reference: tasks queue on a pending group).
                def admit():
                    try:
                        ledger = self._pg_bundle_ledger(
                            pf.placement_group_id, pf.bundle_index)
                    except BaseException as e:  # noqa: BLE001
                        self._store_error(
                            e if isinstance(e, exceptions.RayTpuError)
                            else exceptions.RayTaskError.from_exception(
                                e, function_name),
                            return_ids)
                        return
                    self._enqueue(lambda: run(ledger), demand, return_ids,
                                  ledger=ledger)

                self.pool.submit(admit)
            else:
                self._enqueue(run, demand, return_ids)

        self._schedule_when_ready(args, kwargs, on_ready, return_ids)
        return [ObjectRef(oid, owner_address="local") for oid in return_ids]

    def _schedule_when_ready(self, args, kwargs, submit, return_ids):
        """Resolve top-level ObjectRef args, then call ``submit``."""
        deps: List[ObjectRef] = [a for a in args if isinstance(a, ObjectRef)]
        deps += [v for v in kwargs.values() if isinstance(v, ObjectRef)]

        def finish(rargs, rkwargs):
            try:
                submit(rargs, rkwargs)
            except BaseException as e:  # noqa: BLE001
                self._store_error(
                    e if isinstance(e, exceptions.RayTpuError)
                    else exceptions.RayTaskError.from_exception(e, "submit"),
                    return_ids)

        if not deps:
            finish(args, kwargs)
            return
        pending = [len(deps)]
        lock = threading.Lock()

        def on_dep(_oid, _value):
            with lock:
                pending[0] -= 1
                if pending[0] != 0:
                    return
            resolved: Dict[ObjectID, Any] = {}
            failed = None
            for d in deps:
                v = self.store.get_if_ready(d.id())
                if isinstance(v, (exceptions.RayTaskError, exceptions.RayTpuError)):
                    failed = v
                resolved[d.id()] = v
            if failed is not None:
                # Dependency failed -> propagate the error without executing.
                self._store_error(failed, return_ids)
                return
            rargs = tuple(resolved[a.id()] if isinstance(a, ObjectRef) else a
                          for a in args)
            rkwargs = {k: (resolved[v.id()] if isinstance(v, ObjectRef) else v)
                       for k, v in kwargs.items()}
            finish(rargs, rkwargs)

        for d in deps:
            self.store.on_ready(d.id(), on_dep)

    def _run_task(self, function, function_name, args, kwargs, return_ids,
                  task_id, retries_left, options, demand, attempt=0,
                  ledger=None, pg_ctx=None):
        retried = False
        try:
            if task_id in self._cancelled:
                self._cancelled.discard(task_id)
                self._store_error(exceptions.TaskCancelledError(task_id), return_ids)
                return
            token = _context.set(_TaskCtx(
                task_id, attempt=attempt, name=function_name,
                resources=demand, ledger=ledger))
            if pg_ctx is not None:
                from ray_tpu_torch._private import pg_context
                pg_context.set(*pg_ctx)
            try:
                result = function(*args, **kwargs)
                if inspect.isgenerator(result):
                    self._store_generator(
                        result, return_ids, task_id,
                        streaming=opt_mod.is_streaming(options.num_returns))
                elif opt_mod.is_streaming(options.num_returns):
                    raise TypeError(
                        f"num_returns='streaming' requires a generator "
                        f"function, but {function_name!r} returned "
                        f"{type(result).__name__}")
                else:
                    self._store_results(result, return_ids)
            except BaseException as e:  # noqa: BLE001
                if _resolve_retry(e, options.retry_exceptions, retries_left):
                    # Resources stay held across the immediate in-place retry.
                    retried = True
                    self.pool.submit(self._run_task, function, function_name,
                                     args, kwargs, return_ids, task_id,
                                     retries_left - 1, options, demand,
                                     attempt + 1, ledger, pg_ctx)
                else:
                    self._store_error(
                        exceptions.RayTaskError.from_exception(
                            e, function_name, task_id),
                        return_ids)
            finally:
                if pg_ctx is not None:
                    from ray_tpu_torch._private import pg_context
                    pg_context.clear()
                _context.reset(token)
        finally:
            if not retried:
                (ledger if ledger is not None else self.ledger).release(demand)
                # Wake the dispatcher so freed resources admit pending tasks.
                self._dispatch_queue.put(False)

    def _store_results(self, result, return_ids: List[ObjectID]):
        n = len(return_ids)
        if n == 1:
            self.store.put(return_ids[0], result)
            return
        if not isinstance(result, (tuple, list)) or len(result) != n:
            err = exceptions.RayTpuError(
                f"Task declared num_returns={n} but returned "
                f"{type(result).__name__} of length "
                f"{len(result) if isinstance(result, (tuple, list)) else 'n/a'}")
            self._store_error(err, return_ids)
            return
        for oid, v in zip(return_ids, result):
            self.store.put(oid, v)

    def _store_generator(self, gen, return_ids: List[ObjectID], task_id,
                         streaming: bool = False):
        if streaming:
            # Each yield becomes its own store object at the deterministic
            # stream id the caller's ObjectRefGenerator polls; the declared
            # return carries the count (ObjectRefStream semantics).
            from ray_tpu_torch._private.object_ref import drain_stream

            self._store_results(
                drain_stream(gen, task_id, self.store.put), return_ids)
            return
        values = list(gen)
        self._store_results(tuple(values) if len(return_ids) > 1 else values,
                            return_ids)

    def release_stream_tail(self, length_ref: ObjectRef,
                            from_index: int) -> None:
        """Delete unconsumed stream items of an abandoned
        ObjectRefGenerator once its task has stored them all."""
        task_id = length_ref.task_id()

        def _reap():
            from ray_tpu_torch._private.object_ref import STREAM_INDEX_BASE

            try:
                # Outlast the producer, but not the runtime.
                while not self._shutdown:
                    ready, _ = self.wait([length_ref], num_returns=1,
                                         timeout=0.2, fetch_local=True)
                    if ready:
                        break
                else:
                    return
                n = int(self.get([length_ref], timeout=30)[0])
            except Exception:  # noqa: BLE001
                # Errored stream: free the contiguous prefix of stored
                # items.
                i = from_index
                while True:
                    oid = ObjectID.from_task(task_id, STREAM_INDEX_BASE + i)
                    if not self.store.contains(oid):
                        return
                    self.store.delete([oid])
                    i += 1
            self.store.delete([
                ObjectID.from_task(task_id, STREAM_INDEX_BASE + i)
                for i in range(from_index, n)])

        t = threading.Thread(target=_reap, daemon=True, name="stream-reaper")
        with self._lock:
            self._reapers = [r for r in self._reapers if r.is_alive()]
            self._reapers.append(t)
        t.start()

    def _store_error(self, err, return_ids: List[ObjectID]):
        for oid in return_ids:
            self.store.put(oid, err)

    def cancel(self, ref: ObjectRef, force: bool, recursive: bool):
        task_id = ref.task_id()
        if self.store.contains(ref.id()):
            return  # already finished; cancel is a no-op
        self._cancelled.add(task_id)
        # Pending (not yet dispatched) tasks observe the flag in _run_task and
        # store TaskCancelledError; a task already running on a thread cannot
        # be preempted in-process (the cluster runtime force-kills the worker).

    # ---------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, options) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        name = options.name
        ns = options.namespace or "default"
        actor = _LocalActor(self, actor_id, cls, args, kwargs, options)
        from ray_tpu_torch._private.options import resolve_placement

        pf = resolve_placement(options)
        actor.pg_ctx = ((pf.placement_group_id, pf.bundle_index,
                         pf.capture_child_tasks)
                        if pf.placement_group_id else None)
        with self._lock:
            if name:
                key = (ns, name)
                if key in self._named_actors:
                    if options.get_if_exists:
                        return self._named_actors[key]
                    raise ValueError(f"Actor with name {name!r} already exists "
                                     f"in namespace {ns!r}")
                self._named_actors[key] = actor_id
            self._actors[actor_id] = actor
            self._actor_meta[actor_id] = {
                "name": name or "", "namespace": ns, "class_name": cls.__name__,
                "state": "STARTING", "pid": 0,
            }
        actor.start()
        return actor_id

    def _actor_started(self, actor_id):
        with self._lock:
            meta = self._actor_meta.get(actor_id)
            if meta and meta["state"] == "STARTING":
                meta["state"] = "ALIVE"

    def _actor_died(self, actor_id, cause):
        with self._lock:
            meta = self._actor_meta.get(actor_id)
            if meta:
                meta["state"] = "DEAD"
                key = (meta["namespace"], meta["name"])
                if self._named_actors.get(key) == actor_id:
                    del self._named_actors[key]

    def submit_actor_task(self, actor_id, method_name, args, kwargs, options):
        actor = self._actors.get(actor_id)
        task_id = TaskID.for_actor_task(actor_id)
        streaming = opt_mod.is_streaming(options.num_returns)
        nreturns = 1 if streaming else max(options.num_returns, 1)
        return_ids = [ObjectID.from_task(task_id, i) for i in range(nreturns)]
        if actor is None:
            self._store_error(
                exceptions.ActorDiedError(actor_id, "Actor handle is invalid."),
                return_ids)
        else:
            self._schedule_when_ready(
                args, kwargs,
                lambda rargs, rkwargs: actor.submit(method_name, rargs, rkwargs,
                                                    return_ids, task_id,
                                                    streaming),
                return_ids)
        return [ObjectRef(oid, owner_address="local") for oid in return_ids]

    def kill_actor(self, actor_id, no_restart):
        actor = self._actors.get(actor_id)
        if actor is None:
            return
        actor._die(exceptions.ActorDiedError(
            actor_id, f"Actor {actor_id.hex()} was killed via kill()."))

    def get_named_actor(self, name: str, namespace: Optional[str]):
        ns = namespace or "default"
        if "/" in name:
            ns, name = name.split("/", 1)
        with self._lock:
            actor_id = self._named_actors.get((ns, name))
            if actor_id is None:
                raise ValueError(f"Failed to look up actor {name!r} in "
                                 f"namespace {ns!r}")
            actor = self._actors[actor_id]
        return actor_id, actor.cls, actor.options

    def list_named_actors(self, all_namespaces: bool):
        with self._lock:
            if all_namespaces:
                return [{"name": n, "namespace": ns} for ns, n in self._named_actors]
            return [n for ns, n in self._named_actors if ns == "default"]

    def actor_state(self, actor_id: ActorID) -> Dict[str, Any]:
        with self._lock:
            return dict(self._actor_meta.get(actor_id, {}))

    # ---------------------------------------------------------------- misc
    def as_future(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def cb(_oid, value):
            if isinstance(value, exceptions.RayTaskError):
                fut.set_exception(value.as_instanceof_cause())
            elif isinstance(value, exceptions.RayTpuError):
                fut.set_exception(value)
            else:
                fut.set_result(value)

        self.store.on_ready(ref.id(), cb)
        return fut

    def nodes(self):
        return [{
            "NodeID": self.node_id.hex(),
            "Alive": True,
            "NodeManagerAddress": self.node_ip,
            "Resources": dict(self.ledger.total),
            "alive": True,
        }]

    def cluster_resources(self):
        return dict(self.ledger.total)

    def available_resources(self):
        return self.ledger.snapshot()

    # ------------------------------------------------------ placement groups
    def create_placement_group(self, req):
        """Single-node placement: reserve the group's summed resources from
        the main ledger (async-waiting while busy), then carve per-bundle
        ledgers PG-targeted tasks charge (cluster analog: 2PC + per-bundle
        availability in the node manager)."""
        info = dataclasses.replace(
            req, bundles=[dataclasses.replace(b) for b in req.bundles],
            state="PENDING")
        with self._lock:
            self._pgroups[req.group_id] = info
        total: Dict[str, float] = {}
        for b in req.bundles:
            for k, v in b.resources.items():
                total[k] = total.get(k, 0.0) + v
        infeasible = (
            not self.ledger.feasible(total)
            or (req.strategy == "STRICT_SPREAD" and len(req.bundles) > 1))
        if infeasible:
            info.state = "INFEASIBLE"
            return

        def place():
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and not self._shutdown:
                if self.ledger.try_acquire(total):
                    ledgers: Dict[Any, _ResourceLedger] = {
                        b.index: _ResourceLedger(dict(b.resources))
                        for b in info.bundles}
                    with self._lock:
                        if info.state == "REMOVED":
                            self.ledger.release(total)
                            return
                        self._pg_ledgers[bytes(req.group_id)] = ledgers
                        for b in info.bundles:
                            b.node_id = self.node_id.hex()
                        info.state = "CREATED"
                    return
                time.sleep(0.02)
            if info.state == "PENDING":
                info.state = "INFEASIBLE"

        self.pool.submit(place)

    def remove_placement_group(self, group_id: bytes):
        with self._lock:
            info = self._pgroups.get(group_id)
            if info is None or info.state == "REMOVED":
                return
            was_created = info.state == "CREATED"
            info.state = "REMOVED"
            ledgers = self._pg_ledgers.pop(group_id, None)
        if was_created and ledgers is not None:
            # Return the unconsumed share; charges held by still-running
            # tasks drain into the orphaned bundle ledgers (accepted local-
            # mode simplification — the cluster runtime credits the node).
            # ``dead`` stops the dispatcher from admitting queued PG tasks
            # out of the orphaned ledgers (that capacity was just freed).
            freed: Dict[str, float] = {}
            for led in ledgers.values():
                led.dead = True
                for k, v in led.snapshot().items():
                    freed[k] = freed.get(k, 0.0) + v
            self.ledger.release(freed)
            self._dispatch_queue.put(False)

    def get_placement_group(self, group_id: bytes):
        with self._lock:
            return self._pgroups.get(group_id)

    def current_placement_group_id(self):
        from ray_tpu_torch._private import pg_context

        ctx = pg_context.get()
        return ctx[0] if ctx else None

    def _pg_bundle_ledger(self, group_id: bytes, bundle_index: int) \
            -> _ResourceLedger:
        """Ledger a PG-targeted task charges; blocks while the group places."""
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not self._shutdown:
            with self._lock:
                info = self._pgroups.get(group_id)
                state = info.state if info is not None else None
                ledgers = self._pg_ledgers.get(group_id)
            if info is None:
                raise exceptions.RayTpuError(
                    f"placement group {group_id.hex()[:12]} does not exist")
            if state == "REMOVED":
                raise exceptions.RayTpuError(
                    f"placement group {group_id.hex()[:12]} was removed")
            if state == "INFEASIBLE":
                raise exceptions.RayTpuError(
                    f"placement group {group_id.hex()[:12]} is infeasible")
            if state == "CREATED" and ledgers is not None:
                if bundle_index < 0:
                    return _AnyBundleLedger(ledgers)
                led = ledgers.get(bundle_index)
                if led is None:
                    raise exceptions.RayTpuError(
                        f"bundle index {bundle_index} does not exist in "
                        f"placement group {group_id.hex()[:12]}")
                return led
            time.sleep(0.01)
        raise exceptions.RayTpuError(
            f"timed out waiting for placement group "
            f"{group_id.hex()[:12]} to be placed")

    def shutdown(self):
        """Stop the runtime: end the dispatcher, the task pool, every
        actor's threads and the stream reapers, waiting up to
        ``SHUTDOWN_JOIN_S`` in all for them to exit (a task still running
        user code keeps its thread until it returns, as in JAX;
        :meth:`runtime_threads` lists what is left)."""
        if self._shutdown:
            return
        self._shutdown = True
        self._dispatch_queue.put(None)
        actors = list(self._actors.values())
        for actor in actors:
            actor.terminate()
        self.pool.shutdown(wait=False, cancel_futures=True)
        deadline = time.monotonic() + SHUTDOWN_JOIN_S
        for t in self._threads():
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))

    def _threads(self) -> List[threading.Thread]:
        threads = [self._dispatcher] + list(self.pool._threads)
        with self._lock:
            threads += self._reapers
            actors = list(self._actors.values())
        for actor in actors:
            threads += actor.threads()
        return threads

    def runtime_threads(self) -> List[threading.Thread]:
        """The live threads this runtime started."""
        return [t for t in self._threads() if t.is_alive()]
