"""Distributed reference counting for cluster objects (the port's copy of
``ray_tpu/_private/refcount.py``, ``ReferenceCounter`` :40).

Reference: the ownership and reference-count protocol
(``src/ray/core_worker/reference_count.h:66``), redone for a GCS-centred
control plane as JAX's: each process keeps exact local counts of its
live ``ObjectRef`` instances and flushes *deltas* to the GCS in the
background. The GCS sums the counts across holders and, when an object's
total returns to zero, frees every stored copy and clears its directory
entry (the owner drops its lineage pin too: ``ClusterRuntime``).

Zero-dip safety is by order, not by time: the submitting process pins
every ref its task's payload carries until the push returns, and the
executing worker flushes its borrow (+1) *synchronously* before it runs
user code, so the GCS sees the worker's +1 before the submitter's pin
release. The GCS's short grace before a free stays as defence in depth
for refs handed over outside the task-argument path (refs inside a
``put`` value read by a process that holds no other count).

Holder liveness: every flush names the holder's node; the GCS reaps a
worker holder when its node dies and the node manager reaps one when its
process dies (``ReapHolder``). A driver holder, which survives a node
failover, is reaped by a ping TTL: the counter sends an empty flush at
least every ``PING_PERIOD_S`` while it holds counts.

Where the port differs: :meth:`ReferenceCounter.shutdown` joins the flush
thread, so a runtime's shutdown leaves no thread of it behind; flushes run
one at a time; and the count table's lock is reentrant.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Set

logger = logging.getLogger(__name__)

FLUSH_PERIOD_S = 0.1
PING_PERIOD_S = 2.0


class ReferenceCounter:
    """Per-process local counts with a batched delta flush to the GCS.

    ``on_local_zero(oid_binary)`` runs when this process's count of an
    object reaches zero (it evicts the in-process copy and drops the
    lineage pin)."""

    def __init__(self, gcs_stub, holder_id: str,
                 on_local_zero: Optional[Callable[[bytes], None]] = None,
                 node_id: str = "", is_driver: bool = True):
        self._gcs = gcs_stub
        self._holder = holder_id
        self._node_id = node_id
        self._is_driver = is_driver
        self._on_local_zero = on_local_zero
        self._counts: Dict[bytes, int] = {}
        self._pending: Dict[bytes, int] = {}
        # +1/-1 pairs that failed to reach the GCS: sent again, or their
        # stored copies would never be freed.
        self._transient_retry: Set[bytes] = set()
        # Reentrant: a count dropped by the garbage collector (an
        # ObjectRef's __del__) may run inside this thread's own update.
        self._lock = threading.RLock()
        self._flush_lock = threading.Lock()
        self._last_flush = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._flush_loop, daemon=True, name="refcount-flush")
        self._thread.start()

    # ------------------------------------------------------------------ api
    def incr(self, oid: bytes, n: int = 1) -> None:
        with self._lock:
            self._counts[oid] = self._counts.get(oid, 0) + n
            self._pending[oid] = self._pending.get(oid, 0) + n

    def decr(self, oid: bytes, n: int = 1) -> None:
        zero = False
        with self._lock:
            cur = self._counts.get(oid, 0) - n
            if cur <= 0:
                self._counts.pop(oid, None)
                zero = cur == 0
            else:
                self._counts[oid] = cur
            self._pending[oid] = self._pending.get(oid, 0) - n
        if zero and self._on_local_zero is not None:
            try:
                self._on_local_zero(oid)
            except Exception:  # noqa: BLE001
                logger.exception("on_local_zero failed for %s",
                                 oid.hex()[:12])

    def local_count(self, oid: bytes) -> int:
        with self._lock:
            return self._counts.get(oid, 0)

    def flush(self, force_ping: bool = False) -> bool:
        """Push the pending deltas to the GCS. True on success (or when
        there was nothing to send and no ping was due). Flushes run one
        at a time, so a synchronous flush (a worker's borrow) lands after
        every delta taken before it."""
        with self._flush_lock:
            return self._flush(force_ping)

    def _flush(self, force_ping: bool) -> bool:
        from ray_tpu_torch._private import messages as pb

        with self._lock:
            deltas = {k: v for k, v in self._pending.items() if v != 0}
            # A net-zero pending entry whose local count is zero too: the
            # object was made and dropped inside one flush window; the
            # GCS never saw it, so a +1/-1 pair drives its free.
            transient = {k for k, v in self._pending.items()
                         if v == 0 and self._counts.get(k, 0) == 0}
            transient |= self._transient_retry
            transient -= set(deltas)
            self._transient_retry = set()
            self._pending.clear()
            holding = bool(self._counts)
        ping_due = holding and (
            force_ping
            or time.monotonic() - self._last_flush >= PING_PERIOD_S)
        if not deltas and not transient and not ping_due:
            return True
        req = pb.UpdateRefCountsRequest(
            holder_id=self._holder, node_id=self._node_id,
            is_driver=self._is_driver)
        for oid, delta in deltas.items():
            req.deltas.append(pb.RefCountDelta(object_id=oid, delta=delta))
        for oid in transient:
            req.deltas.append(pb.RefCountDelta(object_id=oid, delta=1))
            req.deltas.append(pb.RefCountDelta(object_id=oid, delta=-1))
        try:
            self._gcs.UpdateRefCounts(req, timeout=5)
            self._last_flush = time.monotonic()
            return True
        except Exception:  # noqa: BLE001 — GCS down: send them again later
            with self._lock:
                for oid, delta in deltas.items():
                    self._pending[oid] = self._pending.get(oid, 0) + delta
                self._transient_retry |= transient
            return False

    def _flush_loop(self) -> None:
        while not self._stop.wait(FLUSH_PERIOD_S):
            self.flush()

    def shutdown(self) -> None:
        """Release every count this process still holds, send it, and
        stop the flush thread."""
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)
        with self._lock:
            for oid, n in self._counts.items():
                self._pending[oid] = self._pending.get(oid, 0) - n
            self._counts.clear()
        self.flush()
