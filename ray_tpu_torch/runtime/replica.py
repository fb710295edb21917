"""Serve replicas as processes of their own: the port's counterpart of
``Replica`` (``ray_tpu/serve/api.py:161-364``).

The JAX package hosts each replica in an actor of its own runtime. The
port has no actor core (ROADMAP.md, the re-anchor's runtime choice): a
replica is a ``torch.multiprocessing`` process forked from a
``forkserver`` that imported torch and never touched CUDA (CUDA does not
survive a fork), which builds the user's class once and serves it over
one duplex connection to the serving process.

* :class:`Replica` hosts the callable inside that process, as JAX's
  does: ``handle_request`` and ``handle_request_streaming`` (sync and
  async targets and generators, sync code on a thread pool, the
  multiplexed model id and the request context set around each call),
  ``metrics``, ``pressure``, ``samples`` (its metric registry's
  :func:`~ray_tpu_torch.util.metrics.collect_samples`), ``health`` and
  ``drain``. Admission while draining raises
  :class:`~ray_tpu_torch.exceptions.ReplicaDrainingError`.
* :class:`ReplicaProcess` is the serving process's end: it starts the
  replica and multiplexes many concurrent requests over the connection,
  each with its own id. A streamed item crosses as soon as the replica yields it.
  When the process dies, every request still waiting on it fails with
  :class:`~ray_tpu_torch.exceptions.ActorDiedError`, which the recovery
  journal (:mod:`ray_tpu_torch.serve.recovery`) turns into a resubmit or
  a resume.

A chaos plan (:mod:`ray_tpu_torch._private.chaos`) reaches the replica
as a ``chaos_state`` message, which it installs before reading the next
one; a firing of a capped rule in the replica asks the serving process
(``chaos`` out, ``chaos_reply`` back with the firing's event id), which
counts, records and logs it before the replica acts, and a kill ends the
process (``os._exit``).

Observability crosses the same pipe. The profiling plane's
capture command and program registry are control ops (``capture``,
``programs``; :mod:`ray_tpu_torch._private.cuda_monitor`). Each flight event
(:mod:`ray_tpu_torch._private.events`) and span record
(:mod:`ray_tpu_torch.util.tracing`) the replica emits goes to the
serving process as it is emitted (``events`` and ``spans`` messages),
which appends it to its own ring, where the JAX package publishes them
to the GCS. Metric samples stay in the replica's registry until the
serving process asks for them (the ``samples`` control op, on each
``GET /metrics``). Records and spans name the process by its
``replica_id``.

A deployment's class or function crosses by reference: the replica
imports it by module and qualified name (a ``@serve.deployment`` name
resolves to the class it wraps), so it must be defined at module level,
and its module must import cleanly in a fresh process. Everything else
crosses as pickles this program wrote.
"""

from __future__ import annotations

import asyncio
import atexit
import contextvars
import importlib
import inspect
import itertools
import logging
import os
import pickle
import queue
import signal
import sys
import threading
import time
import traceback
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import torch
import torch.multiprocessing as mp
from multiprocessing import forkserver, resource_tracker

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import chaos, events
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import collect_samples

logger = logging.getLogger(__name__)

#: What the serving process may ask of a replica besides requests.
CONTROL_OPS = ("metrics", "pressure", "samples", "health", "drain",
               "capture", "programs")


class Replica:
    """Hosts one copy of the user callable (inside the replica process).

    Async-native, as JAX's: ``handle_request`` is a coroutine, so an async
    user ``__call__`` overlaps slow requests on the replica's event loop,
    and sync user code runs on a thread pool of ``sync_workers`` threads
    (the deployment's ``max_ongoing_requests``) so it overlaps too."""

    def __init__(self, cls_or_fn, init_args, init_kwargs, is_function: bool,
                 sync_workers: int = 8):
        self.is_function = is_function
        if is_function:
            self.instance = cls_or_fn
        else:
            self.instance = cls_or_fn(*init_args, **(init_kwargs or {}))
        self._ongoing = 0
        self._total = 0
        self._draining = False
        self._m_lock = threading.Lock()
        # OpenMP keeps a thread count per thread: the pool's threads get
        # this process's (``torch.set_num_threads`` in the constructing
        # thread), or each would run the host's count of spinning OpenMP
        # threads and two processes' small ops fight over the cores.
        self._sync_pool = ThreadPoolExecutor(
            max_workers=max(1, int(sync_workers)),
            thread_name_prefix="replica-sync",
            initializer=torch.set_num_threads,
            initargs=(torch.get_num_threads(),))

    def _admit(self) -> None:
        """Count one request in — or reject it if this replica is
        draining. The reject is a CLEAN typed error (the replica did no
        work): routers re-route it to a live replica without consuming
        the request's resume budget."""
        with self._m_lock:
            if self._draining:
                raise exceptions.ReplicaDrainingError(
                    "replica is draining and no longer admits requests")
            self._ongoing += 1
            self._total += 1

    def _release(self) -> None:
        with self._m_lock:
            self._ongoing -= 1

    def _target(self, method: Optional[str]):
        if self.is_function:
            return self.instance
        return getattr(self.instance, method or "__call__")

    @staticmethod
    def _set_context(model_id: str, request_ctx):
        from ray_tpu_torch.serve import context as serve_context
        from ray_tpu_torch.serve import multiplex

        token = multiplex._set_model_id(model_id)
        # The request context must be set BEFORE copy_context() so sync
        # user code sees it in the executor thread, as the model id does.
        rtoken = (serve_context._set_request_context(request_ctx)
                  if request_ctx is not None else None)
        return token, rtoken

    @staticmethod
    def _reset_context(tokens) -> None:
        from ray_tpu_torch.serve import context as serve_context
        from ray_tpu_torch.serve import multiplex

        token, rtoken = tokens
        if rtoken is not None:
            serve_context._reset_request_context(rtoken)
        multiplex._reset_model_id(token)

    async def handle_request(self, method: Optional[str], args, kwargs,
                             multiplexed_model_id: str = "",
                             request_ctx: Optional[Dict[str, Any]] = None):
        self._admit()
        tokens = self._set_context(multiplexed_model_id, request_ctx)
        try:
            target = self._target(method)
            if inspect.iscoroutinefunction(target):
                return await target(*args, **kwargs)
            # Sync user code: off the loop so it cannot stall concurrent
            # requests; the copied context carries the model id along.
            ctx = contextvars.copy_context()
            return await asyncio.get_running_loop().run_in_executor(
                self._sync_pool, lambda: ctx.run(target, *args, **kwargs))
        finally:
            self._reset_context(tokens)
            self._release()

    async def handle_request_streaming(self, method: Optional[str], args,
                                       kwargs, multiplexed_model_id: str = "",
                                       request_ctx: Optional[Dict[str,
                                                                  Any]] = None):
        """Streaming variant: each yield of the user method is one
        streamed item. Accepts sync and async generators. A stream the
        caller abandons closes the user's generator, so its cleanup runs
        (the LLM deployments cancel the request in the engine there)."""
        self._admit()
        tokens = self._set_context(multiplexed_model_id, request_ctx)
        try:
            result = self._target(method)(*args, **kwargs)
            if hasattr(result, "__aiter__"):
                try:
                    async for item in result:
                        yield item
                finally:
                    if hasattr(result, "aclose"):
                        await result.aclose()
            elif hasattr(result, "__next__"):
                # Each item is pulled on the pool (a slow producer cannot
                # stall the replica's other requests), in the copied
                # context that carries the model id and request context.
                loop = asyncio.get_running_loop()
                ctx = contextvars.copy_context()
                sentinel = object()

                def _next():
                    try:
                        return ctx.run(next, result)
                    except StopIteration:
                        return sentinel

                try:
                    while True:
                        item = await loop.run_in_executor(self._sync_pool,
                                                          _next)
                        if item is sentinel:
                            break
                        yield item
                finally:
                    if hasattr(result, "close"):
                        await loop.run_in_executor(self._sync_pool,
                                                   result.close)
            else:
                raise TypeError(
                    f"stream=True requires a generator; "
                    f"{method or '__call__'!r} returned "
                    f"{type(result).__name__}")
        finally:
            self._reset_context(tokens)
            self._release()

    def metrics(self):
        """Ongoing-request count (the router's pow-2 load signal)."""
        with self._m_lock:
            return {"ongoing": self._ongoing, "total": self._total}

    def pressure(self):
        """Router in-flight counts plus whatever the hosted callable
        reports through its own ``pressure()`` (the LLM deployments'
        queue depth, KV blocks free, in-flight prefill tokens)."""
        out = self.metrics()
        if not self.is_function:
            probe = getattr(self.instance, "pressure", None)
            if callable(probe):
                try:
                    out.update(probe() or {})
                except Exception:  # noqa: BLE001 — monitoring must not
                    logger.exception("pressure probe failed")  # fail requests
        return out

    def samples(self):
        """This process's metric samples (the serving process labels
        them with the replica's id in its ``GET /metrics``)."""
        return collect_samples()

    def health(self):
        return True

    def capture(self, cmd):
        """A profiler capture of this process on command (the profiling
        plane's capture, sent over the control pipe); returns its
        record."""
        from ray_tpu_torch._private import cuda_monitor

        return cuda_monitor.capture(cmd)

    def programs(self):
        """This process's instrumented-program registry."""
        from ray_tpu_torch._private import cuda_monitor

        return cuda_monitor.all_program_stats()

    async def drain(self, deadline_s: Optional[float] = None):
        """Controller-initiated graceful drain: stop admitting (new
        requests get a clean :class:`ReplicaDrainingError` reject and
        re-route), finish in-flight requests up to ``deadline_s``
        (default ``RAY_TPU_SERVE_DRAIN_S``, 30 s), then report back so
        the controller retires this replica."""
        if deadline_s is None:
            deadline_s = float(os.environ.get("RAY_TPU_SERVE_DRAIN_S",
                                              "30"))
        with self._m_lock:
            self._draining = True
            remaining = self._ongoing
        t0 = time.monotonic()
        deadline = t0 + max(float(deadline_s), 0.0)
        while remaining > 0 and time.monotonic() < deadline:
            if chaos.enabled():
                # Death while draining: the in-flight streams fall back
                # to the journal's resume path; delay_drain (the
                # serve_drain site) stretches the wait instead.
                chaos.inject("serve_replica", phase="drain")
                chaos.inject("serve_drain")
            await asyncio.sleep(0.02)
            with self._m_lock:
                remaining = self._ongoing
        return {"drained": remaining <= 0,
                "waited_s": time.monotonic() - t0,
                "remaining": remaining}


# ------------------------------------------------------------- references
def resolve(ref):
    """The class or function a ``(module, qualname)`` reference names; a
    ``Deployment`` found there stands for the class or function it
    wraps."""
    module, qualname = ref
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return getattr(obj, "_cls_or_fn", obj)


def reference(cls_or_fn):
    """``(module, qualname)`` of a deployment's class or function, checked
    to resolve back to it."""
    ref = (cls_or_fn.__module__, cls_or_fn.__qualname__)
    try:
        found = resolve(ref)
    except (ImportError, AttributeError):
        found = None
    if found is not cls_or_fn:
        raise ValueError(
            f"{ref[1]!r} of module {ref[0]!r} cannot be imported by name: "
            f"a replica process imports its deployment's class or "
            f"function, so define it at module level")
    return ref


def _portable(err: BaseException) -> BaseException:
    """``err`` as it can cross the connection: itself when it pickles,
    else a RuntimeError naming it. The replica's traceback rides along as
    a note."""
    tb = "".join(traceback.format_exception(err))
    try:
        pickle.loads(pickle.dumps(err))
    except Exception:  # noqa: BLE001 — any pickling failure: stand in
        err = RuntimeError(f"{type(err).__name__}: {err}")
    err.add_note(f"raised in the replica process {os.getpid()}:\n{tb}")
    return err


# ------------------------------------------------------ the replica process
class _ReplicaServer:
    """Serves one :class:`Replica` over the connection: a reader thread
    hands each message to the event loop, where every request runs as a
    task of its own and writes its replies back."""

    #: Seconds a capped chaos firing waits for the serving process's
    #: answer (no answer: it does not fire).
    CHAOS_ASK_S = 30.0

    def __init__(self, conn, replica: Replica):
        self.conn = conn
        self.replica = replica
        self.loop = asyncio.new_event_loop()
        self.tasks: Dict[int, asyncio.Task] = {}
        self.cancelled = set()
        # Replies go from the loop; chaos asks from any thread (the sync
        # pool, the engine's tick thread).
        self._send_lock = threading.Lock()
        self._chaos_ids = itertools.count(1)
        self._chaos_waits: Dict[int, Future] = {}

    def serve(self) -> None:
        threading.Thread(target=self._read, daemon=True,
                         name="replica-reader").start()
        self.loop.run_forever()

    def _read(self) -> None:
        while True:
            try:
                msg = pickle.loads(self.conn.recv_bytes())
            except (EOFError, OSError):
                break            # the serving process is gone: exit too
            if msg[0] == "exit":
                break
            if msg[0] == "chaos_state":
                # Installed here, before any later message is read: a
                # request sent after a push runs under the pushed plan.
                chaos.install(msg[2])
                continue
            if msg[0] == "chaos_reply":
                waiter = self._chaos_waits.pop(msg[1], None)
                if waiter is not None:
                    waiter.set_result(msg[2])
                continue
            self.loop.call_soon_threadsafe(self._dispatch, msg)
        for waiter in list(self._chaos_waits.values()):
            waiter.set_result("")
        self.loop.call_soon_threadsafe(self.loop.stop)

    def _send(self, kind: str, rid: int, value: Any = None) -> None:
        try:
            data = pickle.dumps((kind, rid, value))
        except Exception as e:  # noqa: BLE001 — an unpicklable result
            data = pickle.dumps(("error", rid, _portable(TypeError(
                f"the replica's {kind} cannot be pickled: {e}"))))
        with self._send_lock:
            self.conn.send_bytes(data)

    def forward(self, kind: str):
        """A sink for this process's flight events (``kind="events"``)
        or span records (``"spans"``): each batch goes to the serving
        process at once, so it is there before a kill can end this
        process."""
        def sink(batch):
            try:
                self._send(kind, 0, batch)
            except (OSError, ValueError):
                pass                  # the serving process is gone
        return sink

    def chaos_arbiter(self, generation: int, rule, entry):
        """:func:`chaos.set_arbiter`'s function in a replica: a capped
        rule's firing asks the serving process (which counts, records
        and logs it) and waits for its answer, the firing's event id or
        "" (refused); an unlimited rule's is reported and fires."""
        ask = rule.times >= 0
        seq = next(self._chaos_ids)
        waiter: Future = Future()
        if ask:
            self._chaos_waits[seq] = waiter
        try:
            self._send("chaos", seq, (generation, rule.id, entry, ask))
        except (OSError, ValueError):
            self._chaos_waits.pop(seq, None)
            return ""
        if not ask:
            return True
        try:
            return waiter.result(timeout=self.CHAOS_ASK_S)
        except TimeoutError:
            self._chaos_waits.pop(seq, None)
            return ""

    def _dispatch(self, msg) -> None:
        kind, rid = msg[0], msg[1]
        if kind == "cancel":
            if rid in self.tasks:
                self.cancelled.add(rid)
            return
        run = {"call": self._call, "stream": self._stream,
               "control": self._control}[kind]
        task = self.loop.create_task(run(rid, *msg[2:]))
        self.tasks[rid] = task
        task.add_done_callback(lambda _t, rid=rid: self.tasks.pop(rid, None))

    async def _call(self, rid, method, args, kwargs, model_id, rctx):
        try:
            out = await self.replica.handle_request(method, args, kwargs,
                                                    model_id, rctx)
        except Exception as e:  # noqa: BLE001 — the caller's error
            self._send("error", rid, _portable(e))
        else:
            self._send("result", rid, out)

    async def _stream(self, rid, method, args, kwargs, model_id, rctx):
        agen = self.replica.handle_request_streaming(method, args, kwargs,
                                                     model_id, rctx)
        try:
            try:
                async for item in agen:
                    self._send("item", rid, item)
                    if rid in self.cancelled:
                        break         # a cancelled stream ends here too
            finally:
                self.cancelled.discard(rid)
                await agen.aclose()
        except Exception as e:  # noqa: BLE001 — the caller's error
            self._send("error", rid, _portable(e))
        else:
            self._send("end", rid)

    async def _control(self, rid, op, args):
        try:
            if op not in CONTROL_OPS:
                raise ValueError(f"unknown replica control {op!r}")
            fn = getattr(self.replica, op)
            if inspect.iscoroutinefunction(fn):
                out = await fn(*args)
            else:             # pressure takes the user's locks: off-loop
                out = await self.loop.run_in_executor(None, fn, *args)
        except Exception as e:  # noqa: BLE001 — the caller's error
            self._send("error", rid, _portable(e))
        else:
            self._send("result", rid, out)


def _child_main(conn, spec: bytes, env: Dict[str, str],
                num_threads: int, replica_id: str = "replica") -> None:
    """The replica process: take the serving process's environment
    ``env`` in place of the one the fork server had at its start
    (``CUDA_VISIBLE_DEVICES`` before anything touches CUDA), build the
    user's class, report ready (or the constructor's error) and serve
    until the serving process goes. Its flight events and spans go to
    the serving process from the start, the constructor's included."""
    os.environ.clear()
    os.environ.update(env)
    tracing.set_process_ids(replica_id)
    # A chaos kill ends this process for real (the serving process's
    # journal sees a replica death).
    os.environ["RAY_TPU_CHAOS_HARD_EXIT"] = "1"
    torch.set_num_threads(max(1, num_threads))
    server = _ReplicaServer(conn, None)
    events.set_local_sink(server.forward("events"))
    tracing.set_local_sink(server.forward("spans"))
    t0 = time.perf_counter()
    try:
        ref, args, kwargs, is_function, sync_workers = pickle.loads(spec)
        replica = Replica(resolve(ref), args, kwargs, is_function,
                          sync_workers)
    except Exception as e:  # noqa: BLE001 — reported, then exit
        server._send("init_error", 0, _portable(e))
        conn.close()
        return
    # Through the server's lock: the constructor may have started threads
    # that already emit over the connection.
    server._send("ready", 0, {
        "pid": os.getpid(), "init_s": time.perf_counter() - t0,
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")})
    server.replica = replica
    chaos.set_arbiter(server.chaos_arbiter)
    server.serve()
    # Handoff channels whose reader never came go with the replica.
    kv_transfer = sys.modules.get("ray_tpu_torch.serve.kv_transfer")
    if kv_transfer is not None:
        kv_transfer.reap_channels(force=True)
    # Worker threads (the pool, an engine's tick thread) must not hold
    # the exit: the serving process asked for it or is gone.
    os._exit(0)


# --------------------------------------------- the serving process's end
class ReplicaStream:
    """The items of one streamed request, as the replica yields them.
    ``next(timeout)`` raises ``StopIteration`` at the end, the replica's
    error, or ``ActorDiedError`` if the process died. :meth:`close` of an
    unfinished stream asks the replica to close the user's generator."""

    def __init__(self, owner: "ReplicaProcess", on_done=None):
        self._owner = owner
        self._rid = 0
        self._q: "queue.Queue" = queue.Queue()
        self._done = False           # the consumer saw the end
        self._on_done = on_done      # called once, when the replica ends it

    def _deliver(self, kind: str, value: Any) -> None:
        self._q.put((kind, value))
        if kind != "item" and self._on_done is not None:
            on_done, self._on_done = self._on_done, None
            on_done()

    def next(self, timeout: Optional[float] = None):
        if self._done:
            raise StopIteration
        try:
            kind, value = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"no streamed item from replica process "
                f"{self._owner.pid} within {timeout} s") from None
        if kind == "item":
            return value
        self._done = True
        if kind == "end":
            raise StopIteration
        raise value

    def close(self) -> None:
        if not self._done:
            self._done = True
            self._owner._cancel(self._rid)

    def __del__(self):
        if not self._done:
            # No send from a finalizer: it may run inside another send.
            self._owner._orphans.append(self._rid)


# What the fork server imports once: this module (torch with it), the
# module every train worker's class lives in (a restart would pay its
# imports again), the profiling plane's FLOP formulas (their import
# would otherwise land in a replica's first counted call: a request's
# TTFT),
# and a script's main module, so a class or train loop defined in the
# script that starts the replica resolves in the replica.
PRELOAD = ("__main__", "ray_tpu_torch.runtime.replica",
           "ray_tpu_torch.train.backend_executor",
           "torch.utils.flop_counter")


# Every ReplicaProcess this process started, for stop_all.
_started: "weakref.WeakSet[ReplicaProcess]" = weakref.WeakSet()


def stop_all() -> None:
    """Kill every replica process this process started, then the fork
    server and the resource tracker multiprocessing started for them,
    and wait for each, so that nothing of the runtime outlives its
    caller. Runs at exit, where it is registered when the first replica
    process starts; safe to call more than once.

    The fork server is killed rather than asked to exit: asked, it
    finalizes the torch it preloaded and outlives this process by about a
    second."""
    for proc in list(_started):
        proc.kill()
    server = forkserver._forkserver
    if server._forkserver_pid is not None:
        try:
            os.kill(server._forkserver_pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        server._stop()
    if not mp.active_children():
        # Another live child of this process would hold the tracker open.
        resource_tracker._resource_tracker._stop()


class ReplicaProcess:
    """The serving process's end of one replica process. Spawns it at once;
    :meth:`wait_ready` returns when the user's class is built (or raises
    its constructor's error). ``env`` is set in the process before
    anything touches CUDA (``CUDA_VISIBLE_DEVICES`` of a replica that
    asked for GPUs); ``num_threads`` is its torch intra-op threads.
    ``replica_id`` (``<name>-<n>``, unique in this process) names it on
    its flight events, spans and metric samples.

    Every replica process, a serve replica or a trainer's worker, is
    forked from one ``forkserver`` process that imported :data:`PRELOAD`
    once, so it starts without a torch import of its own. The server
    never touches CUDA, and the child gets this process's whole
    environment as it is when the replica starts."""

    _seq = itertools.count()

    def __init__(self, name: str, cls_or_fn, init_args, init_kwargs,
                 is_function: bool, sync_workers: int = 8,
                 env: Optional[Dict[str, str]] = None, num_threads: int = 1):
        self.name = name
        self.replica_id = f"{name}-{next(self._seq)}"
        self.env = dict(env or {})
        self.info: Dict[str, Any] = {}
        self.dead = False
        spec = pickle.dumps((reference(cls_or_fn), init_args, init_kwargs,
                             is_function, sync_workers))
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(list(PRELOAD))
        self._conn, child = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(
            target=_child_main,
            args=(child, spec, {**os.environ, **self.env}, num_threads,
                  self.replica_id),
            daemon=True, name=f"serve-replica-{name}")
        self._ids = itertools.count(1)
        self._pending: Dict[int, Any] = {}   # id -> Future | ReplicaStream
        self._lock = threading.Lock()        # the pending map
        self._send_lock = threading.Lock()   # the connection's writes
        self._orphans: deque = deque()       # streams dropped unfinished
        self._ready: Future = Future()
        if not _started:
            atexit.register(stop_all)
        self._proc.start()
        _started.add(self)
        child.close()
        threading.Thread(target=self._read, daemon=True,
                         name=f"serve-replica-{name}-reader").start()

    # ------------------------------------------------------------ state
    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    @property
    def alive(self) -> bool:
        return not self.dead and self._proc.is_alive()

    def wait_ready(self, timeout_s: float) -> Dict[str, Any]:
        """Block until the replica built its class; returns its
        ``{"pid", "init_s", "cuda_visible_devices"}``. A replica whose
        constructor raised, or that died or did not start in time, is
        killed and the error raised: there is no fallback."""
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

    @property
    def ready(self) -> Optional[bool]:
        """True once built, False if it failed to start, None while
        starting."""
        if not self._ready.done():
            return None
        return self._ready.exception() is None

    # --------------------------------------------------------- requests
    def call(self, method: Optional[str], args, kwargs,
             model_id: str = "", request_ctx=None) -> Future:
        fut: Future = Future()
        self._submit(fut, "call", method, args, kwargs, model_id,
                     request_ctx)
        return fut

    def stream(self, method: Optional[str], args, kwargs,
               model_id: str = "", request_ctx=None,
               on_done=None) -> ReplicaStream:
        """``on_done()`` runs once, on the reader thread, when the
        replica ends the stream (its end, its error, or its death)."""
        st = ReplicaStream(self, on_done)
        st._rid = self._submit(st, "stream", method, args, kwargs,
                               model_id, request_ctx)
        return st

    def control(self, op: str, *args) -> Future:
        fut: Future = Future()
        self._submit(fut, "control", op, args)
        return fut

    def _submit(self, waiter, kind: str, *fields) -> int:
        rid = next(self._ids)
        data = pickle.dumps((kind, rid) + fields)
        with self._lock:
            dead = self.dead
            if not dead:
                self._pending[rid] = waiter
        if dead:
            self._fail(waiter, self._died_error())
            return rid
        try:
            self._send(data)
        except (OSError, ValueError):
            with self._lock:
                self._pending.pop(rid, None)
            self._fail(waiter, self._died_error())
        return rid

    def _send(self, data: bytes) -> None:
        with self._send_lock:
            while self._orphans:
                self._conn.send_bytes(pickle.dumps(
                    ("cancel", self._orphans.popleft())))
            self._conn.send_bytes(data)

    def _cancel(self, rid: int) -> None:
        try:
            self._send(pickle.dumps(("cancel", rid)))
        except (OSError, ValueError):
            pass                      # the process is gone already

    # ----------------------------------------------------------- replies
    def _read(self) -> None:
        while True:
            try:
                kind, rid, value = pickle.loads(self._conn.recv_bytes())
            except (EOFError, OSError):
                break
            if kind == "ready":
                self.info = value
                self._ready.set_result(value)
                continue
            if kind == "init_error":
                self._ready.set_exception(value)
                continue
            if kind == "chaos":
                self._chaos_fired(rid, *value)
                continue
            if kind == "events":
                events._ingest(value)
                continue
            if kind == "spans":
                tracing._ingest(value)
                continue
            with self._lock:
                waiter = (self._pending.get(rid) if kind == "item"
                          else self._pending.pop(rid, None))
            if waiter is None:
                continue
            if isinstance(waiter, ReplicaStream):
                waiter._deliver(kind, value)
            elif kind == "error":
                waiter.set_exception(value)
            else:
                waiter.set_result(value)
        self._died()

    def push_chaos(self, shared) -> None:
        """Send :func:`chaos.state` to the replica, which installs it
        before it reads its next message."""
        try:
            self._send(pickle.dumps(("chaos_state", 0, shared)))
        except (OSError, ValueError):
            pass                      # the process is gone already

    def _chaos_fired(self, seq: int, generation: int, rule_id: str,
                     entry: Dict[str, Any], ask: bool) -> None:
        """A firing in the replica: decided (recorded and logged) by this
        process's plan; a capped rule's answer, the firing's event id or
        "", goes back."""
        ok = chaos.arbitrate(generation, rule_id, entry)
        if ask:
            try:
                self._send(pickle.dumps(("chaos_reply", seq, ok)))
            except (OSError, ValueError):
                pass

    def _died_error(self) -> exceptions.ActorDiedError:
        return exceptions.ActorDiedError(
            error_msg=f"replica process {self.pid} of {self.name!r} died "
            f"(exit code {self._proc.exitcode})")

    @staticmethod
    def _fail(waiter, err: BaseException) -> None:
        if isinstance(waiter, ReplicaStream):
            waiter._deliver("error", err)
        elif not waiter.done():
            waiter.set_exception(err)

    def _died(self) -> None:
        self._proc.join(timeout=5)
        with self._lock:
            self.dead = True
            waiters, self._pending = list(self._pending.values()), {}
        err = self._died_error()
        if not self._ready.done():
            self._ready.set_exception(err)
        for w in waiters:
            self._fail(w, err)

    # ---------------------------------------------------------- lifetime
    def kill(self) -> None:
        """SIGKILL the process and wait for it."""
        if self._proc.is_alive():
            self._proc.kill()
        self._proc.join(timeout=30)

    def stop(self, timeout_s: float = 10.0) -> None:
        """Ask the process to exit, then kill it if it has not."""
        try:
            self._send(pickle.dumps(("exit", 0)))
        except (OSError, ValueError):
            pass
        self._proc.join(timeout=timeout_s)
        self.kill()
