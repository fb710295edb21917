"""Request tracing: spans that join one request's hops across processes
(the port of ``ray_tpu/util/tracing.py``).

Off by default (``RAY_TPU_TRACING=1`` enables): the hot path pays one
env check when disabled. A span record carries ``trace_id``,
``span_id`` and ``parent_span_id``; :func:`spans_to_chrome_events`
renders records as a chrome trace with flow arrows from parent to child.

The JAX package publishes span records to the GCS and carries a trace
across task submissions in the task spec (``inject_context``,
``execute_span``). The port has neither tasks nor a GCS:

* a serve request's context crosses the process hop inside the
  request's payload (``request_ctx``: ``trace_id`` and the route span's
  id as ``parent_span_id``), as the JAX serve plane already does;
* span records go to this process's bounded ring (:func:`local_spans`);
  a replica process also sends each record over its pipe
  (:func:`set_local_sink`) and the serving process appends it to its
  ring (:func:`_ingest`), so one request's ingress, route and engine
  spans end up in one ring.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

_local = threading.local()

SPAN_RING_MAX = int(os.environ.get("RAY_TPU_SPAN_RING_MAX", "20000"))

# This process's identity on every span and flight record: the serving
# process is "serving"; a replica process names itself by its replica id.
_ids = {"worker_id": "serving", "node_id": ""}
# Where this process's span records go besides its ring (a replica
# process forwards them to the serving process).
_local_sink: Optional[Callable[[List[Dict[str, Any]]], None]] = None


class _SpanRing:
    """This process's span store: bounded, the overflow counted as loss
    (``ray_tpu_events_dropped_total{buffer="spans"}``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []

    def _extend(self, records: List[Dict[str, Any]]) -> None:
        evicted = 0
        with self._lock:
            self._records.extend(records)
            if len(self._records) > SPAN_RING_MAX:
                evicted = len(self._records) - SPAN_RING_MAX
                del self._records[:evicted]
        if evicted:
            # events imports this module: a lazy import.
            from ray_tpu_torch._private.events import _count_dropped

            _count_dropped("spans", evicted)

    def add(self, record: Dict[str, Any]) -> None:
        self._extend([record])
        sink = _local_sink
        if sink is not None:
            try:
                sink([record])
            except Exception:  # noqa: BLE001 — spans are best-effort
                pass

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


_ring = _SpanRing()
# The span reporter (anything with ``add(record)``); tests swap in their
# own, as the JAX package's do.
_reporter: Any = _ring


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TRACING", "0") == "1"


def current() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span in this thread, if any."""
    return getattr(_local, "ctx", None)


def set_context(trace_id: str, span_id: str) -> None:
    _local.ctx = (trace_id, span_id)


def set_local_sink(fn: Optional[Callable[[List[Dict[str, Any]]], None]]) -> None:
    """Send this process's span records to ``fn(batch)`` as well as its
    ring (a replica process forwards them to the serving process)."""
    global _local_sink
    _local_sink = fn


def set_process_ids(worker_id: str, node_id: str = "") -> None:
    """Name this process on its span and flight records."""
    _ids.update(worker_id=str(worker_id), node_id=str(node_id))


def _process_ids() -> Dict[str, str]:
    return dict(_ids)


def _ingest(records: List[Dict[str, Any]]) -> None:
    """Span records another process emitted (a replica's, arriving over
    its pipe): into this ring, not forwarded again."""
    _ring._extend([r for r in records if isinstance(r, dict)])


def local_spans(trace_id: Optional[str] = None,
                request_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """This process's span records, optionally one trace's, or the
    traces that carry ``request_id``."""
    recs = _ring.records()
    if request_id is not None:
        tids = {r.get("trace_id") for r in recs
                if r.get("request_id") == request_id}
        recs = [r for r in recs if r.get("trace_id") in tids]
    if trace_id is not None:
        recs = [r for r in recs if r.get("trace_id") == trace_id]
    return recs


def clear_spans() -> None:
    _ring.clear()


def gen_id() -> str:
    """A fresh 16-hex trace/span/request id (the serve plane mints
    request ids and pre-allocates span ids with it)."""
    return uuid.uuid4().hex[:16]


def emit_span(name: str, *, trace_id: str, ts: float, dur: float,
              span_id: Optional[str] = None, parent_span_id: str = "",
              kind: str = "task", **attrs) -> str:
    """Record a span RETROSPECTIVELY with an explicit start/duration.

    The serve request path needs this because its phases are measured by
    bookkeeping (a request's queue wait ends when the admission loop
    picks it up, in a different thread than the one that submitted it),
    so a context manager around the work is impossible. Returns the span
    id ('' when tracing is disabled)."""
    if not enabled():
        return ""
    span_id = span_id or gen_id()
    ids = _process_ids()
    _reporter.add({
        "state": "SPAN", "name": name, "kind": kind,
        "task_id": span_id,
        "trace_id": trace_id, "span_id": span_id,
        "parent_span_id": parent_span_id or "",
        "ts": ts, "dur": max(dur, 0.0), **ids, **attrs})
    return span_id


@contextmanager
def explicit_span(name: str, *, trace_id: str,
                  span_id: Optional[str] = None,
                  parent_span_id: str = "", kind: str = "task", **attrs):
    """Like :func:`span` but with a CALLER-CHOSEN span id, so the caller
    can hand that id to other processes as a parent BEFORE the span
    closes (the serve route span does this: engine lifecycle spans in
    the replica parent to it while the route call is still running).
    Sets the thread-local context while it runs."""
    if not enabled():
        yield None
        return
    span_id = span_id or gen_id()
    prev = current()
    set_context(trace_id, span_id)
    t0 = time.time()
    try:
        yield span_id
    finally:
        _local.ctx = prev
        ids = _process_ids()
        _reporter.add({
            "state": "SPAN", "name": name, "kind": kind,
            "task_id": span_id,
            "trace_id": trace_id, "span_id": span_id,
            "parent_span_id": parent_span_id or "",
            "ts": t0, "dur": time.time() - t0, **ids, **attrs})


@contextmanager
def span(name: str, kind: str = "task",
         trace_id: Optional[str] = None,
         parent_span_id: Optional[str] = None, **attrs):
    """Run a span: sets the thread-local context (spans opened inside
    parent to it) and records it on exit. With no explicit trace
    context, continues the current one or starts fresh."""
    if not enabled():
        yield None
        return
    prev = current()
    if trace_id is None:
        if prev is not None:
            trace_id, parent_span_id = prev
        else:
            trace_id = gen_id()
    span_id = gen_id()
    set_context(trace_id, span_id)
    t0 = time.time()
    try:
        yield span_id
    finally:
        _local.ctx = prev
        ids = _process_ids()
        _reporter.add({
            "state": "SPAN", "name": name, "kind": kind,
            "task_id": span_id,
            "trace_id": trace_id, "span_id": span_id,
            "parent_span_id": parent_span_id or "",
            "ts": t0, "dur": time.time() - t0, **ids, **attrs})


def spans_to_chrome_events(records: List[Dict[str, Any]]) \
        -> List[Dict[str, Any]]:
    """Span records -> chrome trace X events + flow arrows linking
    parent to child (visible as arrows across process rows in
    chrome://tracing / perfetto)."""
    by_id = {r["span_id"]: r for r in records}
    out: List[Dict[str, Any]] = []
    for r in records:
        out.append({
            "name": r["name"], "cat": f"span:{r.get('kind', 'task')}",
            "ph": "X", "ts": r["ts"] * 1e6,
            "dur": max(r.get("dur", 0.0), 1e-5) * 1e6,
            "pid": r.get("node_id", ""), "tid": r.get("worker_id", ""),
            "args": {"trace_id": r["trace_id"], "span_id": r["span_id"],
                     "parent_span_id": r.get("parent_span_id", "")},
        })
        parent = by_id.get(r.get("parent_span_id", ""))
        if parent is not None:
            mid = parent["ts"] + max(parent.get("dur", 0.0), 0.0) / 2
            out.append({"name": "trace", "cat": "flow", "ph": "s",
                        "id": r["span_id"], "ts": mid * 1e6,
                        "pid": parent.get("node_id", ""),
                        "tid": parent.get("worker_id", "")})
            out.append({"name": "trace", "cat": "flow", "ph": "f",
                        "bp": "e", "id": r["span_id"],
                        "ts": r["ts"] * 1e6,
                        "pid": r.get("node_id", ""),
                        "tid": r.get("worker_id", "")})
    return out


def connected(records: List[Dict[str, Any]], root: str = "serve.ingress"
              ) -> bool:
    """True when ``records`` are one trace rooted at one ``root`` span:
    one trace id, and every other span's parent another span of it."""
    if not records or len({r.get("trace_id") for r in records}) != 1:
        return False
    roots = [r for r in records if r.get("name") == root]
    ids = {r.get("span_id") for r in records}
    return len(roots) == 1 and all(
        r is roots[0] or r.get("parent_span_id") in ids for r in records)


__all__ = ["clear_spans", "connected", "current", "emit_span", "enabled",
           "explicit_span", "gen_id", "local_spans", "set_context",
           "set_local_sink", "set_process_ids", "span",
           "spans_to_chrome_events"]
