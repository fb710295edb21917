"""Serve data plane: the asyncio HTTP ingress over one router (the port of
``ray_tpu/serve/proxy.py``).

* keep-alive HTTP/1.1 with a request loop per connection;
* chunked NDJSON streaming whose writes apply back-pressure
  (``await writer.drain()``: a slow client throttles the pull);
* a bounded executor bridging the blocking handle calls, whose size caps
  in-flight requests;
* the admission gate: per-tenant token buckets and pressure-thresholded
  shedding, answered with 429 and ``Retry-After``;
* ``GET /-/healthz``, ``GET /-/routes`` and ``GET /metrics`` (the
  Prometheus text of this process and its replicas,
  :func:`~ray_tpu_torch.serve.api.metrics_text`: the port's counterpart
  of the node agent's ``/metrics``). ``PUT /-/deploy`` answers 501:
  config-file deploys (``serve/config.py``) are queued after item 13, as
  is the gRPC ingress;
* request tracing: under ``RAY_TPU_TRACING=1`` the ingress mints each
  request's context (:func:`ingress_request_context`, honouring
  ``x-request-id``), which rides every hop to the engine, and closes the
  root ``serve.ingress`` span when the response is written; a shed
  request is counted in ``SERVE_REQ_OUTCOMES`` (``engine="ingress"``);
* role groups: a stream to a group's name is classified
  (:meth:`_Router._classify_disagg`) and split across its prefill and
  decode deployments, or run whole on the decode group; a unary call
  runs on the decode group.

Every stream goes through the recovery journal
(:class:`~ray_tpu_torch.serve.recovery.RecoverableStream`, or
:class:`~ray_tpu_torch.serve.recovery.DisaggRecoverableStream` when
split).
"""

from __future__ import annotations

import asyncio
import http
import json
import logging
import os
import threading
import time
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

_MAX_BODY = 64 << 20
_STREAM_END = object()


def prefix_fingerprint(payload: Any) -> str:
    """Prefix fingerprint of an LLM request: a hash of the first k
    block-aligned chunks of ``prompt_token_ids`` (chunk size
    ``RAY_TPU_PREFIX_FP_CHUNK``, default 64 — the engine's default KV
    block size — over at most ``RAY_TPU_PREFIX_FP_CHUNKS`` chunks).
    Requests sharing a system prompt hash identically, so the router
    can keep them on the replica whose radix cache already holds the
    prefix. Returns "" for non-LLM payloads and prompts shorter than
    one chunk (nothing block-aligned to share). Collisions only cost
    routing locality — the engine's radix index matches exact token
    tuples, never hashes."""
    if not isinstance(payload, dict):
        return ""
    ids = payload.get("prompt_token_ids")
    if not isinstance(ids, (list, tuple)):
        return ""
    chunk = int(os.environ.get("RAY_TPU_PREFIX_FP_CHUNK", "64"))
    max_chunks = int(os.environ.get("RAY_TPU_PREFIX_FP_CHUNKS", "4"))
    k = min(max_chunks, len(ids) // max(chunk, 1))
    if k <= 0:
        return ""
    try:
        head = ",".join(str(int(t)) for t in ids[:k * chunk])
    except (TypeError, ValueError):
        return ""
    return f"{zlib.crc32(head.encode()):08x}"


class AdmissionGate:
    """Ingress admission control: per-tenant token buckets + pressure-
    thresholded load shedding. At saturation the ingress answers 429 +
    Retry-After instead of queueing unboundedly. Pressure comes from the
    router handle's TTL-cached controller snapshots, so the per-request
    cost is a clock read and a few dict lookups.

    Thresholds (env, read per decision):

    * ``RAY_TPU_SHED_QUEUE_DEPTH`` — shed when EVERY reachable replica's
      congestion (engine queue depth + router ongoing, plus an
      arena-exhausted penalty) is at/above this. 0 disables pressure
      shedding (default 32).
    * ``RAY_TPU_SHED_RETRY_AFTER_S`` — advertised back-off (default 1).
    """

    def __init__(self, router: "_Router"):
        self._router = router

    @staticmethod
    def _congestion(snap: Dict[str, Any]) -> float:
        cost = float(snap.get("queue_depth") or 0)
        cost += float(snap.get("ongoing") or 0)
        total = snap.get("kv_blocks_total") or 0
        if total:
            avail = ((snap.get("kv_blocks_free") or 0)
                     + (snap.get("kv_blocks_cached") or 0))
            if avail <= 0:
                # Nothing to admit with even after LRU reclaim: the
                # next request can only queue.
                cost = max(cost, 1e9)
        return cost

    def check(self, deployment: str,
              tenant: str = "") -> Optional[Tuple[float, str]]:
        """None = admit; else ``(retry_after_s, reason)`` with reason in
        {"tenant_rate_limit", "pressure"}, the rejection counted in
        ``ray_tpu_serve_request_outcomes_total``."""
        from ray_tpu_torch.serve import multiplex

        # Pressure first: a pressure shed is the fabric's fault, so it
        # must not consume the tenant's bucket.
        shed = self._pressure_shed(deployment)
        if shed is not None:
            mdefs.SERVE_REQ_OUTCOMES.inc(tags={
                "deployment": deployment, "tenant": tenant,
                "engine": "ingress", "outcome": "shed_pressure"})
            return shed, "pressure"
        wait = multiplex.tenant_rate_limiter().try_acquire(tenant)
        if wait is not None:
            mdefs.SERVE_REQ_OUTCOMES.inc(tags={
                "deployment": deployment, "tenant": tenant,
                "engine": "ingress", "outcome": "shed_tenant"})
            return max(wait, 0.05), "tenant_rate_limit"
        return None

    def _pressure_shed(self, deployment: str) -> Optional[float]:
        """Retry-after seconds when EVERY reachable replica is at/above
        the shed threshold; None (admit) otherwise — failing open
        whenever pressure data is off, missing, or unreachable."""
        threshold = float(os.environ.get("RAY_TPU_SHED_QUEUE_DEPTH",
                                         "32") or 0)
        if threshold <= 0:
            return None
        from ray_tpu_torch.serve import api as serve_api

        # A role group's name has no replicas of its own: the decode
        # group's pressure is the signal (its arena is where every
        # request ends up).
        group = serve_api.get_role_group(deployment)
        target = group["decode"] if group else deployment
        try:
            snaps = self._router.handle(target)._fetch_shared_pressure()
        except RuntimeError:     # serve not running: fail open
            return None
        reachable = [s for s in snaps
                     if s and not s.get("unreachable")]
        if not reachable:
            return None          # no pressure data: fail open
        if all(self._congestion(s) >= threshold for s in reachable):
            return float(os.environ.get("RAY_TPU_SHED_RETRY_AFTER_S",
                                        "1.0"))
        return None


class _Router:
    """Shared deployment-handle cache for the ingress."""

    #: Recently dispatched prefix fingerprints the classifier treats as
    #: probably cached on the decode side (a bounded LRU).
    FP_SEEN_CAP = 512

    def __init__(self):
        self._handles: Dict[str, object] = {}
        self._lock = threading.Lock()
        self.gate = AdmissionGate(self)
        self._fp_seen: "OrderedDict[str, None]" = OrderedDict()

    def handle(self, name: str):
        from ray_tpu_torch.serve.api import DeploymentHandle

        with self._lock:
            h = self._handles.get(name)
            if h is None:
                h = self._handles[name] = DeploymentHandle(name)
            return h

    @staticmethod
    def _check_public(method: Optional[str]) -> None:
        # Only public methods are network-routable.
        if method and method.startswith("_"):
            raise LookupError("method not found")

    # ------------------------------------------- disaggregated classify
    def _note_fp(self, fp: str) -> None:
        with self._lock:
            self._fp_seen.pop(fp, None)
            self._fp_seen[fp] = None
            while len(self._fp_seen) > self.FP_SEEN_CAP:
                self._fp_seen.popitem(last=False)

    def _classify_disagg(self, group: Dict[str, str], payload) -> bool:
        """True: split (prefill replica, KV handoff, decode replica);
        False: the decode group runs the request colocated. The estimate
        is the net prefill cost, the prompt's tokens less the
        fingerprint-matched prefix a decode replica likely holds (a seen
        fingerprint means its block-aligned head is hot in some radix
        cache, so prefilling it there is cheap). Split when that clears
        ``RAY_TPU_DISAGG_PREFILL_THRESHOLD`` tokens (default 128; <= 0
        splits every LLM request), or when the pressure feed shows every
        decode replica already queueing ``RAY_TPU_DISAGG_QUEUE_TOKENS``
        prefill tokens (> 0 enables)."""
        prompt = payload.get("prompt_token_ids") or ()
        plen = len(prompt)
        fp = prefix_fingerprint(payload)
        covered = 0
        if fp:
            chunk = int(os.environ.get("RAY_TPU_PREFIX_FP_CHUNK", "64"))
            max_chunks = int(os.environ.get("RAY_TPU_PREFIX_FP_CHUNKS",
                                            "4"))
            with self._lock:
                seen = fp in self._fp_seen
            if seen:
                covered = min(plen,
                              min(max_chunks, plen // max(chunk, 1))
                              * chunk)
            self._note_fp(fp)
        net_prefill = plen - covered
        threshold = float(os.environ.get(
            "RAY_TPU_DISAGG_PREFILL_THRESHOLD", "128"))
        if net_prefill >= threshold:
            return True
        floor = float(os.environ.get("RAY_TPU_DISAGG_QUEUE_TOKENS",
                                     "0") or 0)
        if floor > 0:
            try:
                snaps = self.handle(
                    group["decode"])._fetch_shared_pressure()
            except RuntimeError:      # no controller: the size rule only
                snaps = []
            live = [s for s in snaps if s and not s.get("unreachable")]
            if live and all(
                    float(s.get("prefill_queue_tokens") or 0) >= floor
                    for s in live):
                return True
        return False

    def call(self, name: str, method: Optional[str], payload,
             model_id: str = "", timeout_s: float = 60.0,
             request_ctx: Optional[Dict[str, Any]] = None):
        from ray_tpu_torch.serve import api as serve_api

        self._check_public(method)
        group = serve_api.get_role_group(name)
        if group is not None:
            # A unary completion runs colocated on the decode group (its
            # engines take plain submits); only streams split.
            name = group["decode"]
        h = self.handle(name).options(
            method, multiplexed_model_id=model_id,
            request_context=request_ctx,
            prefix_key=prefix_fingerprint(payload))
        return h.remote(payload).result(timeout_s=timeout_s)

    def stream(self, name: str, method: Optional[str], payload,
               model_id: str = "",
               request_ctx: Optional[Dict[str, Any]] = None):
        """Streaming dispatch through the RECOVERY JOURNAL: the returned
        iterator survives replica death (queued/prefilling requests
        resubmit; mid-decode LLM requests resume as prompt + emitted
        tokens) and drain rejects re-route for free. Its ``.journal``
        tells the ingress whether to send the ``x-ray-tpu-resumed``
        marker.

        A role group's name classifies first: a request whose net
        prefill justifies the transfer splits across the (prefill,
        decode) pair with a journaled KV handoff
        (:class:`~ray_tpu_torch.serve.recovery.DisaggRecoverableStream`);
        the rest run colocated on the decode group."""
        from ray_tpu_torch.serve import api as serve_api
        from ray_tpu_torch.serve.recovery import (DisaggRecoverableStream,
                                                  RecoverableStream,
                                                  RequestJournal,
                                                  is_llm_payload)

        self._check_public(method)
        group = serve_api.get_role_group(name)
        if group is not None:
            if is_llm_payload(payload) and \
                    self._classify_disagg(group, payload):
                journal = RequestJournal(name, method, payload,
                                         model_id=model_id,
                                         request_ctx=request_ctx)
                return DisaggRecoverableStream(
                    self.handle(group["prefill"]),
                    self.handle(group["decode"]),
                    journal, per_item_timeout_s=60.0)
            name = group["decode"]
        journal = RequestJournal(name, method, payload, model_id=model_id,
                                 request_ctx=request_ctx)
        return RecoverableStream(self.handle(name), journal,
                                 per_item_timeout_s=60.0)


def ingress_request_context(deployment: str, tenant: str = "",
                            request_id: str = "") -> Optional[Dict[str, Any]]:
    """Mint the serve request context at the ingress: a fresh trace id
    plus a pre-allocated ingress span id the ingress closes when the
    response completes. None when tracing is disabled (the data plane
    then pays one env check per request). An ``x-request-id`` supplied
    by the client is honoured so external systems can correlate."""
    if not tracing.enabled():
        return None
    return {"request_id": request_id or tracing.gen_id(),
            "trace_id": tracing.gen_id(),
            "parent_span_id": tracing.gen_id(),  # = the ingress span id
            "deployment": deployment, "tenant": tenant}


def _close_ingress_span(rctx: Optional[Dict[str, Any]], t0: float,
                        status: Any, path: str) -> None:
    """Emit the root ``serve.ingress`` span retrospectively (it covers
    parse -> route -> full response write, so its id must exist before
    its duration does)."""
    if rctx is None:
        return
    tracing.emit_span("serve.ingress", trace_id=rctx["trace_id"],
                      span_id=rctx["parent_span_id"], ts=t0,
                      dur=time.time() - t0, kind="ingress",
                      request_id=rctx["request_id"],
                      deployment=rctx.get("deployment", ""),
                      http_path=path, status=str(status))


def _list_routes() -> Dict[str, str]:
    from ray_tpu_torch.serve import api

    try:
        deployments = api._get_controller().list_deployments()
    except RuntimeError:         # serve not running
        return {}
    return {f"/{d}": d for d in deployments}


def _chunk(item) -> bytes:
    data = json.dumps(item).encode() + b"\n"
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


class AsyncHttpProxy:
    """Asyncio HTTP/1.1 ingress (keep-alive, streaming, back-pressure)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 max_concurrency: int = 64, router: Optional[_Router] = None):
        self.router = router or _Router()
        # The executor bounds concurrent blocking router calls: requests
        # beyond it queue in asyncio (cheap futures), not in threads.
        self._pool = ThreadPoolExecutor(max_workers=max_concurrency,
                                        thread_name_prefix="serve-http")
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._host, self._want_port = host, port
        self.port: int = 0
        self._server = None
        self._boot_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-http-loop")
        self._thread.start()
        if not self._started.wait(10) or self.port == 0:
            if self._boot_error is not None:
                raise RuntimeError(
                    f"HTTP proxy failed to bind {host}:{port}: "
                    f"{self._boot_error}") from self._boot_error
            raise RuntimeError("HTTP proxy failed to start")

    def _run(self):
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._handle_conn, self._host, self._want_port)
            self.port = self._server.sockets[0].getsockname()[1]

        try:
            self._loop.run_until_complete(boot())
        except OSError as e:      # surface bind errors to the constructor
            self._boot_error = e
            self._started.set()
            self._loop.close()
            return
        self._started.set()
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    # ------------------------------------------------------------- parsing
    async def _read_request(self, reader):
        """One request, or None on clean EOF, or (status, message) for a
        protocol error the connection must answer-then-close."""
        try:
            line = await reader.readline()
        except (asyncio.LimitOverrunError, ValueError):
            return 431, "request line too long"
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, path, version = line.decode("latin1").strip().split(" ", 2)
        except ValueError:
            return 400, "malformed request line"
        headers: Dict[str, str] = {}
        while True:
            try:
                h = await reader.readline()
            except (asyncio.LimitOverrunError, ValueError):
                return 431, "header too long"
            if not h or h in (b"\r\n", b"\n"):
                break
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # Accepting a chunked body as empty would desync the
            # keep-alive loop (its bytes would parse as the next request).
            return 501, "chunked request bodies are not supported"
        try:
            length = int(headers.get("content-length", 0) or 0)
        except ValueError:
            return 400, "malformed Content-Length"
        if length < 0:
            return 400, "malformed Content-Length"
        if length > _MAX_BODY:
            return 413, "request body too large"
        body = await reader.readexactly(length) if length else b""
        return method, path, version, headers, body

    @staticmethod
    def _response(status: int, body: bytes,
                  content_type: str = "application/json",
                  keep_alive: bool = True,
                  extra_headers: Optional[Dict[str, str]] = None) -> bytes:
        try:
            reason = http.HTTPStatus(status).phrase
        except ValueError:
            reason = "Unknown"
        conn = "keep-alive" if keep_alive else "close"
        extra = "".join(f"{k}: {v}\r\n"
                        for k, v in (extra_headers or {}).items())
        return (f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"{extra}"
                f"Connection: {conn}\r\n\r\n").encode() + body

    async def _reply(self, writer, status: int, obj,
                     keep_alive: bool, **kw) -> bool:
        writer.write(self._response(status, json.dumps(obj).encode(),
                                    keep_alive=keep_alive, **kw))
        await writer.drain()
        return True

    # ---------------------------------------------------------- connection
    async def _handle_conn(self, reader, writer):
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                if req is None:
                    return
                if len(req) == 2:  # protocol error: answer, then close
                    status, msg = req
                    await self._reply(writer, status, {"error": msg}, False)
                    return
                method, path, version, headers, body = req
                close = (headers.get("connection", "").lower() == "close"
                         or version == "HTTP/1.0")
                try:
                    done = await self._route(method, path, headers, body,
                                             writer, keep_alive=not close)
                except (ConnectionError, asyncio.CancelledError):
                    return
                except Exception as e:  # noqa: BLE001 — the request's 500
                    done = await self._reply(writer, 500, {"error": str(e)},
                                             not close)
                if not done or close:
                    return
        finally:
            writer.close()

    async def _route(self, method: str, path: str, headers, body: bytes,
                     writer, keep_alive: bool) -> bool:
        """Handle one request; returns False to drop the connection."""
        loop = asyncio.get_running_loop()
        path = path.split("?", 1)[0]
        if method == "GET" and path == "/-/healthz":
            return await self._reply(writer, 200, {"status": "ok"},
                                     keep_alive)
        if method == "GET" and path == "/-/routes":
            routes = await loop.run_in_executor(self._pool, _list_routes)
            return await self._reply(writer, 200, routes, keep_alive)
        if method == "GET" and path == "/metrics":
            from ray_tpu_torch.serve.api import metrics_text

            text = await loop.run_in_executor(self._pool, metrics_text)
            writer.write(self._response(
                200, text.encode(), keep_alive=keep_alive,
                content_type="text/plain; version=0.0.4"))
            await writer.drain()
            return True
        if method in ("PUT", "POST") and path == "/-/deploy":
            return await self._reply(
                writer, 501,
                {"error": "config-file deploys (serve/config.py) are not "
                          "ported yet: ROADMAP.md queue A, after item 13"},
                keep_alive)
        if method != "POST":
            return await self._reply(writer, 404, {"error": "not found"},
                                     keep_alive)

        parts = path.strip("/").split("/")
        name = parts[0]
        stream = len(parts) >= 2 and parts[1] == "stream"
        call_method = (parts[2] if stream and len(parts) > 2 else
                       parts[1] if len(parts) > 1 else None)
        if not name or (call_method and call_method.startswith("_")):
            return await self._reply(writer, 404,
                                     {"error": "method not found"},
                                     keep_alive)
        model_id = headers.get("serve_multiplexed_model_id", "")
        payload = json.loads(body) if body else {}
        # The admission gate, before any dispatch work.
        shed = await loop.run_in_executor(
            self._pool, self.router.gate.check, name, model_id)
        if shed is not None:
            retry_after, reason = shed
            return await self._reply(
                writer, 429, {"error": f"overloaded: {reason}",
                              "retry_after_s": retry_after}, keep_alive,
                extra_headers={"Retry-After":
                               f"{max(retry_after, 0.05):.3f}"})

        # Request tracing starts here: one trace a request, which every
        # hop (route, replica dispatch, engine admission, prefill, decode
        # windows) parents into.
        rctx = ingress_request_context(
            name, tenant=model_id,
            request_id=headers.get("x-request-id", ""))
        ing_t0 = time.time()

        if not stream:
            try:
                result = await loop.run_in_executor(
                    self._pool, self.router.call, name, call_method,
                    payload, model_id, 60.0, rctx)
            except BaseException:
                _close_ingress_span(rctx, ing_t0, "error", path)
                raise
            done = await self._reply(writer, 200, result, keep_alive)
            _close_ingress_span(rctx, ing_t0, 200, path)
            return done

        # Streaming: pull the first item BEFORE committing to 200 so
        # pre-stream failures surface as errors, not empty streams.
        items = self.router.stream(name, call_method, payload, model_id,
                                   rctx)

        def pull():
            try:
                return next(items)
            except StopIteration:
                return _STREAM_END

        try:
            first = await loop.run_in_executor(self._pool, pull)
        except BaseException:
            items.close()
            _close_ingress_span(rctx, ing_t0, "error", path)
            raise
        journal = items.journal
        from ray_tpu_torch.serve.recovery import RESUMED_MARKER

        marker_sent = journal.needs_marker
        # A SAMPLED request already resumed during the first pull: the
        # header says so before any token reaches the client.
        extra = (f"{RESUMED_MARKER}: {journal.resumes}\r\n"
                 if marker_sent else "")
        conn = "keep-alive" if keep_alive else "close"
        writer.write((f"HTTP/1.1 200 OK\r\n"
                      f"Content-Type: application/x-ndjson\r\n"
                      f"Transfer-Encoding: chunked\r\n"
                      f"{extra}"
                      f"Connection: {conn}\r\n\r\n").encode())
        item = first
        try:
            while item is not _STREAM_END:
                writer.write(_chunk(item))
                await writer.drain()  # back-pressure: slow client, slow pull
                item = await loop.run_in_executor(self._pool, pull)
            if journal.needs_marker and not marker_sent:
                # The sampled resume happened MID-stream (headers long
                # gone): a trailing NDJSON control object carries it.
                writer.write(_chunk({RESUMED_MARKER: journal.resumes}))
            writer.write(b"0\r\n\r\n")
            await writer.drain()
            _close_ingress_span(rctx, ing_t0, 200, path)
            return True
        except Exception:  # noqa: BLE001 — mid-stream failure: abort the
            # connection so the client sees truncation, not completion.
            logger.exception("streaming response for %s failed mid-stream",
                             name)
            items.close()
            _close_ingress_span(rctx, ing_t0, "aborted", path)
            return False

    def stop(self):
        def _shutdown():
            if self._server is not None:
                self._server.close()
            # Open keep-alive connections end with the ingress.
            for task in asyncio.all_tasks(self._loop):
                task.cancel()
            self._loop.call_soon(self._loop.stop)

        self._loop.call_soon_threadsafe(_shutdown)
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)


__all__ = ["AdmissionGate", "AsyncHttpProxy", "ingress_request_context",
           "prefix_fingerprint"]
