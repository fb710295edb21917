"""The flight recorder: typed, causally-linked control-plane events (the
port of the flight-recorder half of ``ray_tpu/_private/events.py``).

Every control-plane decision (a drain, a resume, a weight swap, a chaos
injection) emits one record carrying an ``event_id``, a ``cause`` link
to the parent event id, and ``subject`` keys (replica, run, deployment,
request_id...). Records land in a bounded per-process ring, so "why did
this request resume" resolves to one connected chain
(:func:`causal_chain`) instead of disconnected counters.

The JAX package ships a process's records to the GCS through a
``BufferedPublisher``. The port has no GCS: the serving process's ring
is the store. A replica process installs a sink
(:func:`set_local_sink`) that sends each record over its pipe as it is
emitted (``ray_tpu_torch/runtime/replica.py``), and the serving process
appends it to its own ring (:func:`_ingest`), so a chaos kill in a
replica and the resume it causes in the serving process sit in one ring.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterable, List, Optional, Set

from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.util.tracing import _process_ids

logger = logging.getLogger(__name__)

# Overflow accounting: the ring sheds load by design (events are
# best-effort), but silent shedding is an observability hole. Every drop
# increments ray_tpu_events_dropped_total (tagged by buffer) and the
# first drop per buffer logs once per process.
_drop_logged: set = set()


def _count_dropped(buffer: str, n: int) -> None:
    if n <= 0:
        return
    mdefs.EVENTS_DROPPED.inc(n, tags={"buffer": buffer})
    if buffer not in _drop_logged:
        _drop_logged.add(buffer)
        logger.warning(
            "event buffer %r overflowed: dropped %d record(s) — further "
            "drops are counted in ray_tpu_events_dropped_total but not "
            "logged", buffer, n)


def dropped_counts() -> Dict[str, float]:
    """Per-buffer drop totals recorded so far by this process."""
    return {dict(key).get("buffer", "?"): v
            for _, key, v in mdefs.EVENTS_DROPPED.samples()}


FLIGHT_RING_MAX = int(os.environ.get("RAY_TPU_FLIGHT_RING_MAX", "20000"))

_flight_lock = threading.Lock()
_flight: List[Dict[str, Any]] = []
# Where this process's records go besides its own ring: a replica
# process sends them to the serving process.
_local_sink: Optional[Callable[[List[Dict[str, Any]]], None]] = None


def set_local_sink(fn: Optional[Callable[[List[Dict[str, Any]]], None]]) -> None:
    """Send this process's flight events to ``fn(batch)`` as well as its
    ring (a replica process forwards them to the serving process)."""
    global _local_sink
    _local_sink = fn


def _append(records: List[Dict[str, Any]]) -> None:
    """Append to the ring, evicting (and counting) past its cap."""
    evicted = 0
    with _flight_lock:
        _flight.extend(records)
        if len(_flight) > FLIGHT_RING_MAX:
            evicted = len(_flight) - FLIGHT_RING_MAX
            del _flight[:evicted]
    if evicted:
        _count_dropped("flight", evicted)


def emit(etype: str, cause: Optional[str] = None,
         subject: Optional[Dict[str, Any]] = None, **attrs) -> str:
    """Record one flight event; returns its event id.

    ``cause`` is the parent event id ("" breaks the chain); ``subject``
    keys identify what the event is about (replica, run, deployment,
    request_id, trace_id). Extra keyword attrs ride under ``attrs``.
    Never raises: the recorder is best-effort by design."""
    event_id = uuid.uuid4().hex[:16]
    try:
        rec: Dict[str, Any] = {
            "event_id": event_id,
            "type": str(etype),
            "ts": time.time(),
            "cause": str(cause or ""),
            "subject": {str(k): str(v) for k, v in (subject or {}).items()
                        if v not in (None, "")},
            **_process_ids(),
        }
        if attrs:
            rec["attrs"] = {str(k): v for k, v in attrs.items()}
        _append([rec])
        mdefs.EVENTS_TOTAL.inc(tags={"type": str(etype)})
        sink = _local_sink
        if sink is not None:
            sink([rec])
    except Exception:  # noqa: BLE001 — recording must never break callers
        logger.debug("flight emit failed", exc_info=True)
    return event_id


def _ingest(records: List[Dict[str, Any]]) -> None:
    """Records another process emitted (a replica's, arriving over its
    pipe): into this ring as they are. Their ``ray_tpu_events_total``
    was counted in the emitting process's registry."""
    _append([r for r in records if isinstance(r, dict)])


def _subject_matches(rec: Dict[str, Any], subject: Dict[str, Any]) -> bool:
    sub = rec.get("subject", {})
    return all(sub.get(str(k)) == str(v) for k, v in subject.items())


def match_events(records: Iterable[Dict[str, Any]],
                 types: Optional[Iterable[str]] = None,
                 subject: Optional[Dict[str, Any]] = None,
                 since: Optional[float] = None,
                 until: Optional[float] = None,
                 limit: int = 1000) -> List[Dict[str, Any]]:
    """Filter flight records by type set / subject keys / time window."""
    tset = {str(t) for t in types} if types else None
    out = []
    for r in records:
        if tset is not None and r.get("type") not in tset:
            continue
        if subject and not _subject_matches(r, subject):
            continue
        ts = r.get("ts", 0.0)
        if since is not None and ts < since:
            continue
        if until is not None and ts > until:
            continue
        out.append(r)
    return out[-max(int(limit), 0):]


def local_events(types: Optional[Iterable[str]] = None,
                 subject: Optional[Dict[str, Any]] = None,
                 since: Optional[float] = None,
                 until: Optional[float] = None,
                 limit: int = 1000) -> List[Dict[str, Any]]:
    """Query this process's flight ring (in the serving process, its own
    records and its replicas'). ``since``/``until`` under 1e9 are
    relative seconds before now, the JAX package's query convention."""
    now = time.time()
    if since is not None and float(since) < 1e9:
        since = now - float(since)
    if until is not None and float(until) < 1e9:
        until = now - float(until)
    with _flight_lock:
        recs = list(_flight)
    return match_events(recs, types=types, subject=subject,
                        since=since, until=until, limit=limit)


def latest_event_id(types: Iterable[str],
                    subject: Optional[Dict[str, Any]] = None) -> str:
    """Newest in-ring event id matching ``types`` (+ subject keys), or
    "". Best-effort cause inference for sites that observe an effect
    (a dead replica, a drain rejection) without the trigger's id in
    hand."""
    tset = {str(t) for t in types}
    with _flight_lock:
        for rec in reversed(_flight):
            if rec.get("type") in tset and (
                    not subject or _subject_matches(rec, subject)):
                return rec.get("event_id", "")
    return ""


def causal_chain(records: List[Dict[str, Any]],
                 seed_ids: Iterable[str],
                 subject_rounds: int = 1) -> List[Dict[str, Any]]:
    """Causal closure of the seed events over ``records``: ancestors via
    ``cause`` links, descendants via reverse links, plus
    ``subject_rounds`` rounds of subject-join (events sharing any
    subject key=value with the selected set, re-closed causally each
    round). Sorted by ts."""
    by_id = {r["event_id"]: r for r in records if r.get("event_id")}
    children: Dict[str, List[str]] = {}
    for r in records:
        c = r.get("cause", "")
        if c:
            children.setdefault(c, []).append(r.get("event_id", ""))

    def close(selected: Set[str]) -> Set[str]:
        frontier = list(selected)
        while frontier:
            eid = frontier.pop()
            rec = by_id.get(eid)
            if rec is None:
                continue
            cause = rec.get("cause", "")
            if cause and cause in by_id and cause not in selected:
                selected.add(cause)
                frontier.append(cause)
            for kid in children.get(eid, ()):
                if kid and kid not in selected:
                    selected.add(kid)
                    frontier.append(kid)
        return selected

    selected = close({e for e in seed_ids if e in by_id})
    for _ in range(max(subject_rounds, 0)):
        pairs = set()
        for eid in selected:
            for k, v in by_id[eid].get("subject", {}).items():
                pairs.add((k, v))
        added = {r["event_id"] for r in records
                 if r.get("event_id") and r["event_id"] not in selected
                 and any((k, v) in pairs
                         for k, v in r.get("subject", {}).items())}
        if not added:
            break
        selected = close(selected | added)
    return sorted((by_id[e] for e in selected), key=lambda r: r.get("ts", 0.0))


def flight_span_records(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Map flight events onto the tracing span-record shape so
    ``spans_to_chrome_events`` renders cause links as chrome flow
    arrows alongside real spans."""
    out = []
    for r in records:
        sub = r.get("subject", {})
        out.append({
            "name": r.get("type", "event"), "kind": "flight",
            "trace_id": sub.get("request_id") or sub.get("trace_id")
            or sub.get("lease_id") or "flight",
            "span_id": r.get("event_id", ""),
            "parent_span_id": r.get("cause", ""),
            "ts": r.get("ts", 0.0), "dur": 0.0,
            "node_id": r.get("node_id", ""),
            "worker_id": r.get("worker_id", "control"),
        })
    return out


def clear_flight() -> None:
    with _flight_lock:
        _flight.clear()


__all__ = ["FLIGHT_RING_MAX", "causal_chain", "clear_flight",
           "dropped_counts", "emit", "flight_span_records",
           "latest_event_id", "local_events", "match_events",
           "set_local_sink"]
