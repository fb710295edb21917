"""Worker process: executes tasks and hosts actors (the port's copy of
``ray_tpu/_private/workers/default_worker.py``: ``WorkerServer`` :256,
``_ActorRunner`` :146, ``_stream_generator`` :333).

Reference: ``python/ray/_private/workers/default_worker.py`` + the
executor side of the CoreWorker (``core_worker.cc:3813`` HandlePushTask).
This process:

* is forked by its node manager from the runtime's fork server
  (:func:`forked_main`), with the environment the node chose
  (``CUDA_VISIBLE_DEVICES`` among it) set before it imports anything
  more, then serves ``WorkerService`` on the port's wire and announces
  itself to its node manager;
* connects a cluster runtime of its own in mode ``"worker"``, so a task
  that calls the API (a nested task, a ``get``) works;
* executes pushed normal tasks one at a time, sync or ``async def``,
  streaming generators included (each yielded item is its own store
  object, visible to the caller before the task ends);
* hosts actors: ordered with per-caller sequence numbers
  (``actor_scheduling_queue.h``), threaded with ``max_concurrency`` and
  concurrency groups, or async on an event loop of their own;
* cancels: a running task gets ``TaskCancelledError`` raised into its
  thread, an async actor task its ``asyncio`` cancel, ``force`` ends the
  process, ``recursive`` cancels the task's children;
* mirrors its stdout and stderr to the driver (the ``LOG`` channel) and
  reports task state changes to the GCS (``TASK_EVENT``).

* runs a compiled DAG's pinned loop (``__ray_dag_loop__``, JAX's
  :600-607): the actor executes its schedule over shared-memory channels
  (:func:`~ray_tpu_torch.experimental.channel.run_dag_loop`) until
  teardown closes them, holding one of its concurrency slots meanwhile.

A result or a streamed item over ``INLINE_RESULT_MAX`` goes into a
shared-memory segment this process writes, registered with the node's
store (JAX's :355, :393, :765); a smaller result rides the push reply. A
payload the caller promoted to the store is read from it
(``payload_ref``, JAX's :324). The refs a payload carries are borrows of
this process: they are flushed to the GCS before the task or the
constructor runs (JAX's flush points :486, :598, :673, :787), so the
caller's pin is released after them. Left out, with the ROADMAP.md item
that brings it: runtime environments (20c).
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
import traceback
from concurrent.futures import CancelledError as _FuturesCancelledError
from typing import Any, Dict, List, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import pg_context
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import ActorID, TaskID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime.cluster import (INLINE_RESULT_MAX,
                                                    ClusterRuntime,
                                                    loads_payload,
                                                    put_to_node)

logger = logging.getLogger(__name__)


class _LogTee:
    """Mirror a worker's stdout/stderr to the driver (reference: the log
    monitor + ``log_to_driver`` with a ``(pid=...)`` prefix)."""

    FLUSH_PERIOD_S = 0.1

    def __init__(self, orig, stream_name: str, publisher):
        self._orig = orig
        self._stream = stream_name
        self._publisher = publisher
        self._partial = ""

    def write(self, s):
        self._orig.write(s)
        self._partial += s
        *lines, self._partial = self._partial.split("\n")
        for line in lines:
            if line:
                self._publisher.add(self._stream, line)
        return len(s)

    def flush(self):
        self._orig.flush()

    def fileno(self):
        return self._orig.fileno()

    def isatty(self):
        return False


class _BatchPublisher:
    """Buffers records and publishes them on one GCS channel every
    ``period`` seconds (the log lines, the task events)."""

    def __init__(self, gcs, channel: str, encode, period: float = 0.1,
                 cap: int = 1000):
        self._gcs = gcs
        self._channel = channel
        self._encode = encode
        self._period = period
        self._cap = cap
        self._buf: List[Any] = []
        self._lock = threading.Lock()
        threading.Thread(target=self._flush_loop, daemon=True,
                         name=f"pub-{channel.lower()}").start()

    def add(self, *record) -> None:
        with self._lock:
            self._buf.append(record)
            if len(self._buf) > self._cap:  # chatty: drop the oldest half
                del self._buf[:self._cap // 2]

    def _flush_loop(self):
        while True:
            time.sleep(self._period)
            with self._lock:
                buf, self._buf = self._buf, []
            for data in self._encode(buf) if buf else ():
                try:
                    self._gcs.Publish(pb.PublishRequest(
                        channel=self._channel, data=data))
                except Exception:  # noqa: BLE001 — best effort
                    pass


class _ActorRunner:
    """Execution modes for one hosted actor instance: **ordered**
    (``max_concurrency == 1``, no coroutine methods, no concurrency
    groups; per-caller sequence order, one at a time), **threaded**
    (``max_concurrency > 1`` or concurrency groups on a sync class; calls
    run on RPC threads gated by a semaphore per group) or **async** (any
    ``async def`` method; one event loop thread runs every call, calls
    start in per-caller order and interleave at awaits, capped per group
    by asyncio semaphores)."""

    def __init__(self, instance: Any, max_concurrency: Optional[int] = None,
                 concurrency_groups: Optional[Dict[str, int]] = None):
        from ray_tpu_torch._private import concurrency

        self.instance = instance
        self.cond = threading.Condition()
        self.next_seq: Dict[bytes, int] = {}
        self.dead = False
        self.pg_ctx: Optional[tuple] = None
        self.is_async = concurrency.class_is_async(type(instance))
        mc = concurrency.effective_max_concurrency(self.is_async,
                                                   max_concurrency)
        self.max_concurrency = mc
        self.groups: Dict[str, int] = dict(concurrency_groups or {})
        self.ordered = (not self.is_async and mc == 1 and not self.groups)
        self.loop: Optional[Any] = None
        if self.is_async:
            import asyncio

            self.loop = asyncio.new_event_loop()
            self._async_sems: Dict[str, Any] = {}
            self.async_tasks: Dict[bytes, Any] = {}
            ready = threading.Event()

            def loop_body():
                asyncio.set_event_loop(self.loop)
                ready.set()
                self.loop.run_forever()

            threading.Thread(target=loop_body, daemon=True,
                             name="actor-async-loop").start()
            ready.wait(timeout=10.0)
        else:
            self.sem = threading.Semaphore(mc)
            self._thread_sems = {name: threading.Semaphore(int(cap))
                                 for name, cap in self.groups.items()}

    def _group_of(self, method) -> str:
        from ray_tpu_torch._private import concurrency

        return concurrency.group_of(method, self.groups)

    def thread_sem_for(self, method) -> threading.Semaphore:
        group = self._group_of(method)
        return self._thread_sems[group] if group else self.sem

    def async_sem_for(self, method):
        import asyncio

        group = self._group_of(method)
        sem = self._async_sems.get(group)
        if sem is None:
            cap = self.groups.get(group, self.max_concurrency)
            sem = self._async_sems[group] = asyncio.Semaphore(int(cap))
        return sem

    def stop_loop(self):
        if self.loop is not None:
            try:
                self.loop.call_soon_threadsafe(self.loop.stop)
            except Exception:  # noqa: BLE001 — already closed
                pass

    def wait_turn(self, caller: bytes, seq: int) -> bool:
        deadline = time.monotonic() + 120.0
        with self.cond:
            while not self.dead and self.next_seq.get(caller, 0) != seq:
                if self.next_seq.get(caller, 0) > seq:
                    return False  # duplicate or stale
                if time.monotonic() > deadline:
                    return False  # ordering gap (a stale session)
                self.cond.wait(timeout=1.0)
            return not self.dead

    def complete(self, caller: bytes, seq: int):
        with self.cond:
            self.next_seq[caller] = max(self.next_seq.get(caller, 0),
                                        seq + 1)
            self.cond.notify_all()


class WorkerServer:
    def __init__(self, node_address: str, gcs_address: str, worker_id: str,
                 node_id: str):
        self.worker_id = worker_id
        self.node_id = node_id
        self.runtime = ClusterRuntime(gcs_address, node_address,
                                      is_worker=True, worker_id=worker_id,
                                      node_id=node_id)
        worker_mod._global_worker = worker_mod.Worker(self.runtime, "worker")
        self._actors: Dict[bytes, _ActorRunner] = {}
        self._task_lock = threading.Lock()  # one normal task at a time
        self._cancel_lock = threading.Lock()
        self._running: Dict[bytes, dict] = {}
        self._precancelled: Dict[bytes, float] = {}
        self._exit = threading.Event()
        self._server, self.port = rpc.serve("WorkerService", self)
        self.address = f"127.0.0.1:{self.port}"
        self.node = rpc.get_stub("NodeService", node_address)
        if os.environ.get("RAY_TPU_LOG_TO_DRIVER", "1") != "0":
            import sys

            pid = os.getpid()
            ns = self.runtime.namespace

            def encode_lines(buf):
                by_stream: Dict[str, List[str]] = {}
                for stream, line in buf:
                    by_stream.setdefault(stream, []).append(line)
                return [pickle.dumps({"name": worker_id[:8], "pid": pid,
                                      "ns": ns, "stream": s, "lines": ls})
                        for s, ls in by_stream.items()]

            pub = _BatchPublisher(self.runtime.gcs, "LOG", encode_lines)
            sys.stdout = _LogTee(sys.stdout, "stdout", pub)
            sys.stderr = _LogTee(sys.stderr, "stderr", pub)
        self.task_events: Optional[_BatchPublisher] = None
        if os.environ.get("RAY_TPU_TASK_EVENTS", "1") != "0":
            self.task_events = _BatchPublisher(
                self.runtime.gcs, "TASK_EVENT",
                lambda buf: [pickle.dumps([r[0] for r in buf])], cap=2000)
        self.node.AnnounceWorker(pb.AnnounceWorkerRequest(
            worker_id=worker_id, address=self.address, pid=os.getpid(),
            fast_address=self.address))

    # ------------------------------------------------------------- helpers
    def _put_store(self, oid: bytes, value) -> None:
        """Store a serialized value in the node's store (a segment of this
        process's over ``INLINE_RESULT_MAX``)."""
        if not put_to_node(self.node, oid, value, self.worker_id):
            raise exceptions.RayTpuError(
                f"object store rejected {oid.hex()[:12]}")

    def _stream_generator(self, gen, spec) -> int:
        """Drain a streaming-generator task (reference: ObjectRefStream,
        ``task_manager.h:104``): each yielded value becomes its own store
        object at its deterministic id; returns the item count, which
        rides the declared return."""
        import inspect

        from ray_tpu_torch._private.object_ref import drain_stream

        if inspect.isasyncgen(gen):
            import asyncio

            return asyncio.run(self._drain_stream_async(gen, spec))
        if not (inspect.isgenerator(gen) or hasattr(gen, "__next__")):
            raise TypeError(
                f"num_returns='streaming' requires a generator "
                f"{'method' if spec.actor_id else 'function'}, but "
                f"{spec.name!r} returned {type(gen).__name__}")
        return drain_stream(gen, TaskID(bytes(spec.task_id)),
                            lambda oid, item: self._put_store(
                                oid.binary(), self.runtime.serialize(item)))

    async def _drain_stream_async(self, agen, spec) -> int:
        from ray_tpu_torch._private.object_ref import drain_stream_async

        return await drain_stream_async(
            agen, TaskID(bytes(spec.task_id)),
            lambda oid, item: self._put_store(oid.binary(),
                                              self.runtime.serialize(item)))

    def _payload(self, spec):
        """The task's ``(function or None, args, kwargs)``: its payload
        inline or read from the store, its borrows flushed first."""
        raw = spec.payload
        if spec.payload_ref:
            raw = self.runtime.fetch_object_bytes(bytes(spec.payload_ref))
            if raw is None:
                raise exceptions.ObjectLostError(message=(
                    f"the payload {bytes(spec.payload_ref).hex()[:16]} of "
                    f"task {spec.name} was lost"))
        return self._borrowed(raw)

    def _borrowed(self, raw):
        value, n_borrows = loads_payload(raw)
        if n_borrows:
            # Before the caller's pin release, which follows this push's
            # reply: the order that keeps the count from dipping to zero.
            self.runtime.refs.flush()
        return value

    def _resolve_args(self, args, kwargs):
        """Top-level ObjectRef resolution (nested refs pass through)."""
        refs = [a for a in args if isinstance(a, ObjectRef)]
        refs += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
        if refs:
            values = self.runtime.get(refs, timeout=300.0)
            table = {r.id(): v for r, v in zip(refs, values)}
            args = tuple(table[a.id()] if isinstance(a, ObjectRef) else a
                         for a in args)
            kwargs = {k: (table[v.id()] if isinstance(v, ObjectRef) else v)
                      for k, v in kwargs.items()}
        return args, kwargs

    def _package_results(self, result, return_ids) -> pb.PushTaskResult:
        n = len(return_ids)
        if n == 1:
            values = [result]
        elif isinstance(result, (tuple, list)) and len(result) == n:
            values = list(result)
        else:
            err = exceptions.RayTpuError(
                f"Task declared num_returns={n} but returned "
                f"{type(result).__name__}")
            return pb.PushTaskResult(ok=False, error=pickle.dumps(err))
        out = pb.PushTaskResult(ok=True)
        for oid, value in zip(return_ids, values):
            s = self.runtime.serialize(value)
            if s.wire_size() <= INLINE_RESULT_MAX:
                out.inline_results.append(s.to_bytes())
                out.in_store.append(False)
            else:
                self._put_store(bytes(oid), s)
                out.inline_results.append(b"")
                out.in_store.append(True)
        return out

    def _error_result(self, e: BaseException, name: str) -> pb.PushTaskResult:
        err = e if isinstance(e, exceptions.RayTpuError) else \
            exceptions.RayTaskError.from_exception(e, name)
        try:
            blob = self.runtime.dumps(err)
        except Exception:  # noqa: BLE001 — unpicklable chain: as text
            err = exceptions.RayTaskError(
                name, "".join(traceback.format_exception(e)))
            blob = self.runtime.dumps(err)
        return pb.PushTaskResult(ok=False, error=blob)

    def _report_task(self, spec, state: str, **extra) -> None:
        if self.task_events is not None:
            self.task_events.add({
                "task_id": bytes(spec.task_id).hex()[:16],
                "name": spec.name, "state": state, "ts": time.time(),
                "worker_id": self.worker_id[:12],
                "node_id": self.node_id[:12], **extra})

    def _prune_precancelled(self) -> None:
        """Drop stale early-cancel records (caller holds _cancel_lock)."""
        if len(self._precancelled) > 32:
            cutoff = time.monotonic() - 60.0
            for k, ts in list(self._precancelled.items()):
                if ts < cutoff:
                    del self._precancelled[k]

    def _take_cancel(self, spec) -> bool:
        with self._cancel_lock:
            return spec.cancelled or self._precancelled.pop(
                bytes(spec.task_id), None) is not None

    # ------------------------------------------------------------- service
    def PushTask(self, request, context):
        spec = request.spec
        if spec.actor_id:
            return self._push_actor_task(spec)
        return self._push_normal_task(spec)

    def PushTaskBatch(self, request, context):
        return pb.PushTaskBatchReply(results=[
            self._push_normal_task(spec) for spec in request.specs])

    def _push_normal_task(self, spec) -> pb.PushTaskResult:
        from ray_tpu_torch._private.runtime.local import _TaskCtx, _context

        tid = bytes(spec.task_id)
        with self._task_lock:
            with self._cancel_lock:
                self._prune_precancelled()
                if spec.cancelled or \
                        self._precancelled.pop(tid, None) is not None:
                    return self._error_result(
                        exceptions.TaskCancelledError(TaskID(tid)), spec.name)
                # in_user gates the async-exc: a cancel raises into this
                # thread only while it runs user code.
                entry = {"thread": threading.get_ident(),
                         "in_user": False, "cancelled": False}
                self._running[tid] = entry
            ctx_token = None
            self._report_task(spec, "RUNNING")
            try:
                fn, args, kwargs = self._payload(spec)
                args, kwargs = self._resolve_args(args, kwargs)
                if spec.placement_group_id:
                    # Children of a capturing task inherit its group.
                    pg_context.set(bytes(spec.placement_group_id),
                                   spec.pg_bundle_index,
                                   spec.pg_capture_child_tasks)
                # get_runtime_context() works here, and children this task
                # submits are recorded under it for recursive cancel.
                ctx_token = _context.set(_TaskCtx(TaskID(tid),
                                                  name=spec.name))
                with self._cancel_lock:
                    if entry["cancelled"]:
                        raise exceptions.TaskCancelledError(TaskID(tid))
                    entry["in_user"] = True
                try:
                    result = fn(*args, **kwargs)
                    import inspect

                    if inspect.iscoroutine(result):
                        import asyncio

                        result = asyncio.run(result)
                    if spec.returns_stream:
                        result = self._stream_generator(result, spec)
                    elif hasattr(result, "__next__"):  # legacy generators
                        result = tuple(result) \
                            if len(spec.return_ids) > 1 else list(result)
                finally:
                    with self._cancel_lock:
                        entry["in_user"] = False
                    if spec.placement_group_id:
                        pg_context.clear()
                out = self._package_results(result, spec.return_ids)
                self._report_task(spec, "FINISHED")
                return out
            except BaseException as e:  # noqa: BLE001
                self._report_task(spec, "FAILED", error=repr(e)[:200])
                return self._error_result(e, spec.name)
            finally:
                with self._cancel_lock:
                    self._running.pop(tid, None)
                self.runtime.drop_children(tid)
                if spec.placement_group_id:
                    pg_context.clear()
                if ctx_token is not None:
                    _context.reset(ctx_token)

    def _died(self, spec) -> pb.PushTaskResult:
        err = exceptions.ActorDiedError(ActorID(bytes(spec.actor_id)),
                                        "actor died")
        return pb.PushTaskResult(ok=False, error=self.runtime.dumps(err))

    def _push_actor_task(self, spec) -> pb.PushTaskResult:
        runner = self._actors.get(spec.actor_id)
        if runner is None or runner.dead:
            err = exceptions.ActorDiedError(
                ActorID(bytes(spec.actor_id)), "actor not hosted here")
            return pb.PushTaskResult(ok=False, error=self.runtime.dumps(err))
        if runner.is_async:
            return self._push_async_actor_task(runner, spec)
        from ray_tpu_torch._private.runtime.local import _TaskCtx, _context

        caller = bytes(spec.caller_address)
        ordered = runner.ordered
        sem: Optional[threading.Semaphore] = None
        if ordered:
            if not runner.wait_turn(caller, spec.sequence_no):
                return self._died(spec)
        else:
            try:
                sem = runner.thread_sem_for(
                    getattr(runner.instance, spec.method_name, None))
            except ValueError as e:  # unknown concurrency group
                return self._error_result(e, spec.method_name)
            sem.acquire()
            if runner.dead:
                sem.release()
                return self._died(spec)
        ctx_token = None
        try:
            # After the turn: a cancelled task still advances the caller's
            # sequence (the finally below), so it leaves no ordering hole.
            if self._take_cancel(spec):
                raise exceptions.TaskCancelledError(
                    TaskID(bytes(spec.task_id)))
            self._report_task(spec, "RUNNING",
                              actor_id=bytes(spec.actor_id).hex()[:12])
            _, args, kwargs = self._payload(spec)
            args, kwargs = self._resolve_args(args, kwargs)
            if spec.method_name == "__ray_dag_loop__":
                # The compiled DAG's pinned loop: it occupies this call's
                # turn or concurrency slot until teardown closes its
                # channels.
                from ray_tpu_torch.experimental.channel import run_dag_loop

                result = run_dag_loop(runner.instance, *args)
                out = self._package_results(result, spec.return_ids)
                self._report_task(spec, "FINISHED")
                return out
            method = getattr(runner.instance, spec.method_name)
            ctx_token = _context.set(_TaskCtx(
                TaskID(bytes(spec.task_id)),
                actor_id=ActorID(bytes(spec.actor_id)),
                name=spec.method_name))
            if runner.pg_ctx is not None:
                pg_context.set(*runner.pg_ctx)
            try:
                result = method(*args, **kwargs)
            finally:
                if runner.pg_ctx is not None:
                    pg_context.clear()
            if spec.returns_stream:
                result = self._stream_generator(result, spec)
            out = self._package_results(result, spec.return_ids)
            self._report_task(spec, "FINISHED")
            return out
        except exceptions.AsyncioActorExit:
            self._terminate_actor(spec.actor_id, "exit_actor() called")
            self._report_task(spec, "FINISHED")
            return self._package_results(None, spec.return_ids)
        except BaseException as e:  # noqa: BLE001
            self._report_task(spec, "FAILED", error=repr(e)[:200])
            return self._error_result(e, spec.method_name)
        finally:
            if ctx_token is not None:
                _context.reset(ctx_token)
            if ordered:
                runner.complete(caller, spec.sequence_no)
            else:
                sem.release()

    def _push_async_actor_task(self, runner: _ActorRunner,
                               spec) -> pb.PushTaskResult:
        """Async-actor execution (reference: ``core_worker/fiber.h``): the
        RPC thread admits the call in per-caller order, schedules its
        coroutine on the actor's loop, releases the sequence at once (so
        later calls start while this one awaits) and blocks for the
        result."""
        import asyncio

        caller = bytes(spec.caller_address)
        tid = bytes(spec.task_id)
        fut = None
        try:
            try:
                if not runner.wait_turn(caller, spec.sequence_no):
                    return self._died(spec)
                if self._take_cancel(spec):
                    raise exceptions.TaskCancelledError(TaskID(tid))
                self._report_task(spec, "RUNNING",
                                  actor_id=bytes(spec.actor_id).hex()[:12])
                _, args, kwargs = self._payload(spec)
                args, kwargs = self._resolve_args(args, kwargs)
                if self._take_cancel(pb.TaskSpec(task_id=tid)):
                    raise exceptions.TaskCancelledError(TaskID(tid))
                fut = asyncio.run_coroutine_threadsafe(
                    self._run_async_actor_method(runner, spec, args, kwargs),
                    runner.loop)
            finally:
                # In-order starts, interleaved execution.
                runner.complete(caller, spec.sequence_no)
            result = fut.result()
            out = self._package_results(result, spec.return_ids)
            self._report_task(spec, "FINISHED")
            return out
        except exceptions.AsyncioActorExit:
            self._terminate_actor(spec.actor_id, "exit_actor() called")
            self._report_task(spec, "FINISHED")
            return self._package_results(None, spec.return_ids)
        except (asyncio.CancelledError, _FuturesCancelledError):
            self._report_task(spec, "FAILED", error="cancelled")
            return self._error_result(
                exceptions.TaskCancelledError(TaskID(tid)), spec.method_name)
        except BaseException as e:  # noqa: BLE001
            self._report_task(spec, "FAILED", error=repr(e)[:200])
            return self._error_result(e, spec.method_name)

    async def _run_async_actor_method(self, runner: _ActorRunner, spec,
                                      args, kwargs):
        import asyncio
        import inspect

        from ray_tpu_torch._private.runtime.local import _TaskCtx, _context

        tid = bytes(spec.task_id)
        if self._take_cancel(pb.TaskSpec(task_id=tid)):
            raise exceptions.TaskCancelledError(TaskID(tid))
        runner.async_tasks[tid] = asyncio.current_task()
        try:
            method = getattr(runner.instance, spec.method_name)
            sem = runner.async_sem_for(method)
            async with sem:
                if runner.dead:
                    raise exceptions.ActorDiedError(
                        ActorID(bytes(spec.actor_id)), "actor died")
                # ContextVars: every asyncio task carries its own copy.
                _context.set(_TaskCtx(TaskID(tid),
                                      actor_id=ActorID(bytes(spec.actor_id)),
                                      name=spec.method_name))
                if runner.pg_ctx is not None:
                    pg_context.set(*runner.pg_ctx)
                result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
                if spec.returns_stream:
                    if inspect.isasyncgen(result):
                        result = await self._drain_stream_async(result, spec)
                    else:
                        result = self._stream_generator(result, spec)
                elif inspect.isasyncgen(result):
                    result = [item async for item in result]
                return result
        finally:
            runner.async_tasks.pop(tid, None)

    def CreateActor(self, request, context):
        info = request.info
        try:
            for k, v in request.env.items():
                os.environ[k] = v
            outer = pickle.loads(info.spec)
            cls, args, kwargs, options = self._borrowed(outer["payload"])
            pg_ctx = None
            if outer.get("pg") is not None:
                gid, idx = outer["pg"]
                pg_ctx = (gid, idx, bool(outer.get("pg_capture")))
                pg_context.set(*pg_ctx)
            try:
                args, kwargs = self._resolve_args(args, kwargs)
                instance = cls(*args, **kwargs)
            finally:
                if pg_ctx is not None:
                    pg_context.clear()
            runner = _ActorRunner(
                instance,
                max_concurrency=getattr(options, "max_concurrency", None),
                concurrency_groups=getattr(options, "concurrency_groups",
                                           None))
            runner.pg_ctx = pg_ctx
            self._actors[bytes(info.actor_id)] = runner
            return pb.CreateActorReply(ok=True)
        except BaseException as e:  # noqa: BLE001
            return pb.CreateActorReply(
                ok=False, error="".join(traceback.format_exception(e)))

    def KillActor(self, request, context):
        self._terminate_actor(request.actor_id, "killed")
        return pb.Empty()

    def CancelTask(self, request, context):
        """Executor-side cancel (reference: ``CancelTaskOnExecutor``,
        ``core_worker.h:1655``): ``TaskCancelledError`` raised into a
        running normal task's thread (it lands at the next bytecode),
        ``asyncio`` cancel for an async actor task, a record for a task
        not here yet, the process's exit for ``force``, and the task's
        children for ``recursive``."""
        tid = bytes(request.task_id)
        found = False
        with self._cancel_lock:
            info = self._running.get(tid)
            if info is not None:
                found = True
                if request.force:
                    pass  # below: the whole worker exits
                elif info.get("in_user"):
                    import ctypes

                    ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(info["thread"]),
                        ctypes.py_object(exceptions.TaskCancelledError))
                else:
                    info["cancelled"] = True
            else:
                for runner in self._actors.values():
                    task = runner.async_tasks.get(tid) \
                        if runner.is_async else None
                    if task is not None:
                        found = True
                        runner.loop.call_soon_threadsafe(task.cancel)
                        break
                else:
                    self._prune_precancelled()
                    self._precancelled[tid] = time.monotonic()
        if request.recursive:
            self.runtime.cancel_children(tid, request.force)
        if request.force and found:
            # Reply first, then die: the owner's push fails and its cancel
            # flag stores the cancel error instead of retrying.
            threading.Thread(target=self._delayed_exit, daemon=True).start()
        return pb.CancelTaskReply(found=found)

    def _terminate_actor(self, actor_id: bytes, reason: str):
        runner = self._actors.pop(bytes(actor_id), None)
        if runner is not None:
            runner.dead = True
            with runner.cond:
                runner.cond.notify_all()
            runner.stop_loop()
        # An actor worker is dedicated: exit so the pool reaps it.
        threading.Thread(target=self._delayed_exit, daemon=True).start()

    def _delayed_exit(self):
        time.sleep(0.2)
        os._exit(0)

    def Stacktrace(self, request, context):
        import faulthandler
        import tempfile

        # faulthandler writes to a file descriptor, not a StringIO.
        with tempfile.TemporaryFile("w+") as f:
            faulthandler.dump_traceback(file=f)
            f.seek(0)
            return pb.WorkerStacktraceReply(stacktrace=f.read())

    def run_forever(self):
        """Serve until exit; a worker whose node manager is gone exits
        too (reference: workers die with their raylet)."""
        misses = 0
        while not self._exit.is_set():
            time.sleep(1.0)
            try:
                self.node.GetObjectsMeta(
                    pb.GetObjectsMetaRequest(object_ids=[]), timeout=2)
                misses = 0
            except Exception:  # noqa: BLE001
                misses += 1
                if misses >= 3:
                    os._exit(0)


def forked_main(env: Dict[str, str], node_address: str, gcs_address: str,
                worker_id: str, node_id: str) -> None:
    """The worker process's body, run in a child of the fork server: take
    the node's environment before anything touches CUDA, then serve."""
    os.environ.clear()
    os.environ.update(env)
    logging.basicConfig(
        level=logging.WARNING,
        format=f"[worker {worker_id[:8]}] %(message)s")
    try:
        server = WorkerServer(node_address, gcs_address, worker_id, node_id)
    except rpc.RpcError:  # the node went before this worker announced
        os._exit(1)
    except Exception:  # noqa: BLE001 — the node's start wait times out
        logger.exception("worker start failed")
        os._exit(1)
    server.run_forever()

