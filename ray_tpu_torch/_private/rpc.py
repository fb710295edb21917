"""The cluster runtime's wire: length-framed pickled messages over one
persistent TCP connection per peer, with request ids multiplexed on it
and server-streamed replies (the port's copy of ``ray_tpu/_private/
rpc.py`` with ``fastpath.py`` folded in: ``RpcChaos`` :31, ``serve``
:174, ``Stub`` :362, ``get_stub`` :452; ``FastClient`` :82,
``FastServer`` :184).

JAX runs its control plane over gRPC with protobuf messages and its task
plane over the fastpath framing. The card's machine has neither gRPC's
schema for the port nor cloudpickle, so the port carries all three
services (``GcsService``, ``NodeService``, ``WorkerService``; the
methods of :data:`~ray_tpu_torch._private.messages.SERVICES`) on the
fastpath framing alone. A call names its method; request and reply are
the messages of :mod:`~ray_tpu_torch._private.messages`, pickled. A
server-streamed method (``Subscribe``, ``PullObject``) answers with item
frames and an end frame under its request id, and the caller can cancel
it. A :class:`FrameServer` built with a raw handler serves other frame
kinds as JAX's ``FastServer`` does (the WAL log server's).

Frame layout (little-endian), as JAX's fastpath::

    [u32 req_id][u8 kind][u32 len][len bytes payload]

The client keeps JAX's semantics on top: :class:`Stub` retries a call
with exponential backoff when it never reached the server
(``UNAVAILABLE``) and, for idempotent methods only, when it timed out or
its connection broke after the send; :class:`RpcChaos` fails the first
``N`` calls of a method named in ``RAY_TPU_TESTING_RPC_FAILURE``
(``"Service.Method=N,..."``) with an :class:`RpcError` that carries no
code, which the stub does not retry, as JAX's injected ``grpc.RpcError``.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
import socket
import struct
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, Dict, Iterator, Optional

from ray_tpu_torch._private import messages as pb

logger = logging.getLogger(__name__)

_HDR = struct.Struct("<IBI")
_METHOD = struct.Struct("<H")
_MAX_FRAME = 1 << 31

KIND_CALL = 1      # [u16 len][method][pickled request]
KIND_CANCEL = 2    # stop the server stream of this request id
KIND_REPLY_BIT = 0x80
KIND_ITEM = 0x7C   # one item of a server-streamed reply
KIND_END = 0x7D    # the stream's end
KIND_ERR = 0x7F    # the handler raised: utf-8 text


class StatusCode:
    """The gRPC status codes the runtime's retry rules read."""

    UNAVAILABLE = "UNAVAILABLE"          # never reached the server
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
    CONNECTION_LOST = "CONNECTION_LOST"  # broke after the send
    INTERNAL = "INTERNAL"                # the handler raised


class RpcError(Exception):
    """A failed call; ``code()`` is a :class:`StatusCode` or None (chaos)."""

    def __init__(self, code, details: str = ""):
        super().__init__(f"{code}: {details}" if code else details)
        self._code = code
        self._details = details

    def code(self):
        return self._code

    def details(self) -> str:
        return self._details


class RpcChaos:
    """Deterministic RPC failure injection (reference: RpcFailureManager,
    ``rpc_chaos.cc:35``): ``RAY_TPU_TESTING_RPC_FAILURE="Service.Method=N"``
    fails that method's first N calls in this process."""

    def __init__(self):
        self._remaining: Dict[str, int] = {}
        self._lock = threading.Lock()
        spec = os.environ.get("RAY_TPU_TESTING_RPC_FAILURE", "")
        for part in filter(None, (s.strip() for s in spec.split(","))):
            try:
                method, count = part.split("=")
                self._remaining[method] = int(count)
            except ValueError:
                logger.warning("bad RPC chaos spec %r", part)

    def maybe_fail(self, method: str) -> bool:
        with self._lock:
            n = self._remaining.get(method, 0)
            if n == 0:
                return False
            self._remaining[method] = n - 1
            return True


_chaos = RpcChaos()


def reset_chaos() -> None:
    """Re-read ``RAY_TPU_TESTING_RPC_FAILURE``."""
    global _chaos
    _chaos = RpcChaos()


# Methods whose duplicate execution is harmful (a call whose connection
# broke after the send may have run): creates, leases, 2PC votes, pushes.
# For these only UNAVAILABLE (never sent) is retried.
_NON_IDEMPOTENT = frozenset({
    "NodeService.RequestWorkerLease",
    "NodeService.CreateActorOnNode",
    "NodeService.PrepareBundle",
    "NodeService.CommitBundle",
    "WorkerService.CreateActor",
    "WorkerService.PushTask",
    "WorkerService.PushTaskBatch",
})


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Exactly ``n`` bytes, or None at EOF (a frame may arrive in any
    number of pieces)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            return None
        got += r
    return bytes(buf)


def _send_frame(sock, lock, req_id: int, kind: int, payload) -> None:
    with lock:
        sock.sendall(_HDR.pack(req_id, kind, len(payload)))
        sock.sendall(payload)


def _call_payload(method: str, request) -> bytes:
    name = method.encode()
    return _METHOD.pack(len(name)) + name + pickle.dumps(request, protocol=5)


# ------------------------------------------------------------------ client
class _Stream:
    """The caller's end of a server-streamed reply: an iterator of reply
    messages with ``cancel()``."""

    def __init__(self, conn: "Connection", req_id: int,
                 timeout: Optional[float]):
        import queue

        self._conn = conn
        self._req_id = req_id
        self._q: "queue.Queue" = queue.Queue()
        self._timeout = timeout
        self._done = False

    def _deliver(self, kind: int, payload) -> None:
        self._q.put((kind, payload))

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        import queue

        if self._done:
            raise StopIteration
        try:
            kind, payload = self._q.get(timeout=self._timeout)
        except queue.Empty:
            self.cancel()
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "stream item deadline") from None
        if kind == KIND_ITEM:
            return pickle.loads(payload)
        self._done = True
        self._conn._forget(self._req_id)
        if kind == KIND_END:
            raise StopIteration
        raise payload  # an RpcError set by the reader or the handler

    def cancel(self) -> None:
        if self._done:
            return
        self._done = True
        self._conn._forget(self._req_id)
        self._q.put((KIND_END, b""))
        try:
            _send_frame(self._conn._sock, self._conn._send_lock,
                        self._req_id, KIND_CANCEL, b"")
        except OSError:
            pass


class Connection:
    """One multiplexed connection to a :class:`FrameServer`. Calls are
    thread-safe: concurrent callers pipeline frames on the one socket and
    a reader thread hands each reply to its caller by request id. A broken
    connection fails every pending call and marks itself dead."""

    CONNECT_TIMEOUT_S = 5.0

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self.address = address
        try:
            self._sock = socket.create_connection(
                (host, int(port)), timeout=self.CONNECT_TIMEOUT_S)
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connect to {address} failed: {e}") from None
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(None)
        self._send_lock = threading.Lock()
        self._pending: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self.dead = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"rpc-read-{address}")
        self._reader.start()

    def _register(self, waiter) -> int:
        with self._lock:
            if self.dead:
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"connection to {self.address} is closed")
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            req_id = self._next_id
            self._pending[req_id] = waiter
            return req_id

    def _forget(self, req_id: int) -> None:
        with self._lock:
            self._pending.pop(req_id, None)

    def _send(self, req_id: int, kind: int, payload) -> None:
        try:
            _send_frame(self._sock, self._send_lock, req_id, kind, payload)
        except OSError as e:
            self._forget(req_id)
            self._fail(e)
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"send to {self.address} failed: {e}") from None

    def call_future(self, kind: int, payload) -> Future:
        fut: Future = Future()
        req_id = self._register(fut)
        fut.req_id = req_id
        self._send(req_id, kind, payload)
        return fut

    def result(self, fut: Future, timeout: Optional[float]) -> bytes:
        try:
            return fut.result(timeout=timeout)
        except FutureTimeout:
            self._forget(fut.req_id)
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           f"no reply from {self.address} within "
                           f"{timeout}s") from None

    def call(self, kind: int, payload, timeout: Optional[float] = None):
        """One raw frame round trip: the reply's payload."""
        return self.result(self.call_future(kind, payload), timeout)

    def call_method(self, method: str, request, timeout: Optional[float]):
        return pickle.loads(self.call(KIND_CALL, _call_payload(
            method, request), timeout))

    def stream_method(self, method: str, request,
                      timeout: Optional[float]) -> _Stream:
        st = _Stream(self, 0, timeout)
        st._req_id = self._register(st)
        self._send(st._req_id, KIND_CALL, _call_payload(method, request))
        return st

    def _read_loop(self) -> None:
        try:
            while True:
                hdr = _recv_exact(self._sock, _HDR.size)
                if hdr is None:
                    raise ConnectionError("peer closed")
                req_id, kind, length = _HDR.unpack(hdr)
                if length > _MAX_FRAME:
                    raise ConnectionError(f"oversized frame ({length})")
                payload = _recv_exact(self._sock, length)
                if payload is None:
                    raise ConnectionError("peer closed mid-frame")
                with self._lock:
                    waiter = (self._pending.get(req_id)
                              if kind == KIND_ITEM
                              else self._pending.pop(req_id, None))
                if waiter is None:
                    continue
                err = None
                if kind == KIND_ERR:
                    err = RpcError(StatusCode.INTERNAL,
                                   payload.decode("utf-8", "replace"))
                if isinstance(waiter, _Stream):
                    waiter._deliver(kind, err or payload)
                elif not waiter.done():
                    if err is not None:
                        waiter.set_exception(err)
                    else:
                        waiter.set_result(payload)
        except Exception as e:  # noqa: BLE001 — any break kills the client
            self._fail(e)

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            self.dead = True
            pending, self._pending = self._pending, {}
        err = RpcError(StatusCode.CONNECTION_LOST,
                       f"connection to {self.address} lost: {exc}")
        for waiter in pending.values():
            if isinstance(waiter, _Stream):
                waiter._deliver(KIND_ERR, err)
            elif not waiter.done():
                waiter.set_exception(err)
        try:
            # shutdown() before close(): the reader's in-flight recv holds
            # the socket, and a bare close() would never send FIN.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self._fail(ConnectionError("closed"))


_conns: Dict[str, Connection] = {}
_conns_lock = threading.Lock()


def get_connection(address: str) -> Connection:
    """The cached live connection to ``address``, dialled anew when the
    last one died; ``RpcError(UNAVAILABLE)`` when nothing answers."""
    with _conns_lock:
        conn = _conns.get(address)
        if conn is not None and not conn.dead:
            return conn
    conn = Connection(address)
    with _conns_lock:
        old = _conns.get(address)
        if old is not None and not old.dead:
            conn.close()
            return old
        _conns[address] = conn
    return conn


def drop_connection(address: str) -> None:
    with _conns_lock:
        conn = _conns.pop(address, None)
    if conn is not None:
        conn.close()


def close_all_connections() -> None:
    """Close every cached connection of this process and wait for their
    reader threads to end."""
    with _conns_lock:
        conns = list(_conns.values())
        _conns.clear()
    for conn in conns:
        conn.close()
    for conn in conns:
        conn._reader.join(timeout=5.0)


class Stub:
    """Client for one service at one address, with retry and chaos."""

    def __init__(self, service_name: str, address: str,
                 timeout_s: float = 30.0, max_attempts: int = 3):
        self._service = service_name
        self._address = address
        self._timeout = timeout_s
        self._max_attempts = max_attempts
        self._methods = pb.SERVICES[service_name]

    def _invoke(self, name: str, request, timeout: Optional[float] = None):
        full = f"{self._service}.{name}"
        if _chaos.maybe_fail(full):
            raise RpcError(None, f"chaos-injected failure for {full}")
        timeout = timeout or self._timeout
        if self._methods[name][2]:
            return get_connection(self._address).stream_method(
                name, request, timeout)
        retriable = ((StatusCode.UNAVAILABLE,) if full in _NON_IDEMPOTENT
                     else (StatusCode.UNAVAILABLE,
                           StatusCode.DEADLINE_EXCEEDED,
                           StatusCode.CONNECTION_LOST))
        for attempt in range(self._max_attempts):
            try:
                return get_connection(self._address).call_method(
                    name, request, timeout)
            except RpcError as e:
                if e.code() in retriable and \
                        attempt + 1 < self._max_attempts:
                    time.sleep(min(0.05 * 2 ** attempt
                                   + random.uniform(0, 0.02), 1.0))
                    continue
                raise
        raise AssertionError("unreachable")  # pragma: no cover

    def __getattr__(self, name: str):
        if name.startswith("_") or name not in self._methods:
            raise AttributeError(name)
        return lambda request, timeout=None: self._invoke(name, request,
                                                          timeout)


_stubs: Dict[tuple, Stub] = {}
_stubs_lock = threading.Lock()


def get_stub(service_name: str, address: str, **kw) -> Stub:
    key = (service_name, address)
    with _stubs_lock:
        stub = _stubs.get(key)
        if stub is None:
            stub = _stubs[key] = Stub(service_name, address, **kw)
        return stub


# ------------------------------------------------------------------ server
class _Context:
    """What a handler may ask of its call: whether the caller still
    listens (a cancelled stream or a closed connection says no)."""

    def __init__(self, conn_state: dict):
        self._conn_state = conn_state
        self.cancelled = False

    def is_active(self) -> bool:
        return not self.cancelled and not self._conn_state["closed"]


class FrameServer:
    """Accepts connections and serves their frames, each request on a
    thread of its own (a slow request, such as an ordered actor push
    waiting for its turn, must not block the ones pipelined behind it).

    ``handler_obj`` serves a service's methods by name (:func:`serve`);
    ``raw_handler(kind, payload) -> bytes`` serves every other kind."""

    def __init__(self, service_name: str = "", handler_obj: Any = None,
                 raw_handler: Optional[Callable[[int, bytes], bytes]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._service = service_name
        self._methods = pb.SERVICES.get(service_name, {})
        self._obj = handler_obj
        self._raw = raw_handler
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # Rebinding a port the last server of it left in TIME_WAIT (a GCS
        # restarting in place).
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        deadline = time.monotonic() + 5.0
        while True:
            try:
                self._listener.bind((host, port))
                break
            except OSError:
                if port == 0 or time.monotonic() > deadline:
                    self._listener.close()
                    raise RuntimeError(
                        f"{service_name or 'frame server'}: could not bind "
                        f"{host}:{port}") from None
                time.sleep(0.05)
        self._listener.listen(128)
        self.port = self._listener.getsockname()[1]
        self.address = f"{host}:{self.port}"
        self._conns: Dict[socket.socket, dict] = {}
        self._threads: set = set()   # connection and request threads
        self._lock = threading.Lock()
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"rpc-accept-{service_name or 'raw'}-{self.port}")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            state = {"closed": False, "lock": threading.Lock(),
                     "streams": {}}
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns[conn] = state
            self._start(self._conn_loop, (conn, state), "rpc-conn")

    def _start(self, target, args, name: str) -> None:
        t = threading.Thread(target=self._tracked, args=(target, args),
                             daemon=True, name=name)
        with self._lock:
            self._threads.add(t)
        t.start()

    def _tracked(self, target, args) -> None:
        try:
            target(*args)
        finally:
            with self._lock:
                self._threads.discard(threading.current_thread())

    def _conn_loop(self, conn: socket.socket, state: dict) -> None:
        try:
            while True:
                hdr = _recv_exact(conn, _HDR.size)
                if hdr is None:
                    return
                req_id, kind, length = _HDR.unpack(hdr)
                if length > _MAX_FRAME:
                    return
                payload = _recv_exact(conn, length)
                if payload is None:
                    return
                if kind == KIND_CANCEL:
                    ctx = state["streams"].get(req_id)
                    if ctx is not None:
                        ctx.cancelled = True
                    continue
                self._start(self._dispatch,
                            (conn, state, req_id, kind, payload),
                            f"rpc-{self._service or 'raw'}")
        except OSError:
            return
        finally:
            state["closed"] = True
            with self._lock:
                self._conns.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, conn, state, req_id: int, kind: int, payload) -> bool:
        try:
            _send_frame(conn, state["lock"], req_id, kind, payload)
            return True
        except OSError:
            return False

    def _dispatch(self, conn, state, req_id: int, kind: int,
                  payload: bytes) -> None:
        stream = None
        try:
            if kind != KIND_CALL:
                if self._raw is None:
                    raise ValueError(f"unknown frame kind {kind}")
                out = self._raw(kind, payload)
                self._reply(conn, state, req_id, kind | KIND_REPLY_BIT, out)
                return
            (n,) = _METHOD.unpack_from(payload, 0)
            method = payload[2:2 + n].decode()
            if method not in self._methods:
                raise ValueError(f"{self._service} has no method {method!r}")
            request = pickle.loads(payload[2 + n:])
            ctx = _Context(state)
            fn = getattr(self._obj, method)
            if self._methods[method][2]:
                state["streams"][req_id] = ctx
                stream = fn(request, ctx)
                for item in stream:
                    if not ctx.is_active() or not self._reply(
                            conn, state, req_id, KIND_ITEM,
                            pickle.dumps(item, protocol=5)):
                        return
                self._reply(conn, state, req_id, KIND_END, b"")
                return
            out = pickle.dumps(fn(request, ctx), protocol=5)
            self._reply(conn, state, req_id, KIND_CALL | KIND_REPLY_BIT, out)
        except Exception as e:  # noqa: BLE001 — the caller fails fast
            logger.debug("%s handler failed", self._service, exc_info=True)
            self._reply(conn, state, req_id, KIND_ERR,
                        f"{type(e).__name__}: {e}".encode())
        finally:
            state["streams"].pop(req_id, None)
            if stream is not None and hasattr(stream, "close"):
                stream.close()

    def stop(self, grace: Optional[float] = None) -> None:
        """Close the listener and every connection (their callers see the
        connection lost), then wait up to ``grace`` seconds (5 by default)
        for the server's threads: a handler still running user code keeps
        its thread until it returns."""
        with self._lock:
            self._closed = True
            conns = list(self._conns)
        try:
            # shutdown() wakes the accept() that close() alone would not.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)  # wake the reader thread
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        deadline = time.monotonic() + (5.0 if grace is None else grace)
        self._accept_thread.join(max(0.0, deadline - time.monotonic()))
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            # A thread is tracked just before it starts: one not started
            # yet has nothing to wait for.
            if t is not threading.current_thread() and t.is_alive():
                t.join(max(0.0, deadline - time.monotonic()))

    close = stop


def serve(service_name: str, handler_obj: Any, port: int = 0,
          host: str = "127.0.0.1"):
    """Serve ``handler_obj``'s methods (one per method of the service, the
    same name; a streamed method returns an iterator) as
    ``service_name``, each request on a thread of its own. Returns
    ``(server, bound_port)``."""
    server = FrameServer(service_name, handler_obj, host=host, port=port)
    return server, server.port
