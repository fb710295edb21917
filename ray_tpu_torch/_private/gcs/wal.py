"""Append/compact write-ahead persistence for the GCS (the port's copy
of ``ray_tpu/_private/gcs/wal.py``; ``WriteAheadLog`` :72).

Reference: ``src/ray/gcs/gcs_server/gcs_table_storage.h:220`` — the
reference persists per-table mutations to its storage backend as they
happen; this build's earlier design re-pickled and fsynced the ENTIRE
state on every debounce interval, which at a few thousand objects burned
a core machine-wide. The redesign: mutations append small records to a
log (batched writes, one fsync per batch — O(delta), not O(state)); when
the log outgrows a threshold it is compacted by writing one full snapshot
and truncating the log.

Records are idempotent absolute upserts (e.g. "this holder's count for
this object is now 3", never "+1"), so the compaction race — a mutation
landing between the snapshot capture and the log truncation appears in
BOTH the snapshot and the post-truncation log — replays harmlessly.

Recovery: load the snapshot, then replay the log over it.
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
import threading
import time
from collections import deque
from typing import Callable, Iterator, Tuple

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<I")

def parse_records(data: bytes) -> Iterator[Tuple]:
    """Records from framed log bytes, tolerating a torn final record
    (a crash mid-append truncates cleanly at the last whole record)."""
    off, total = 0, len(data)
    while True:
        if off + _LEN.size > total:
            return
        (n,) = _LEN.unpack_from(data, off)
        off += _LEN.size
        if off + n > total:
            return  # torn tail record
        blob = data[off:off + n]
        off += n
        try:
            yield pickle.loads(blob)
        except Exception:  # noqa: BLE001 — corrupt record: stop
            logger.warning("corrupt WAL record; ignoring tail")
            return


class WriteAheadLog:
    """Batched appender with snapshot-based compaction over a pluggable
    :class:`~ray_tpu_torch._private.gcs.wal_backend.WalBackend` (local files by
    default; a remote log server for head-machine-loss survival).

    ``snapshot_fn()`` must return the full-state blob under the owner's
    state locks.
    """

    FLUSH_PERIOD_S = 0.05

    def __init__(self, path_or_backend, snapshot_fn: Callable[[], bytes],
                 snapshot_path: str = "",
                 compact_threshold: int = 8 << 20):
        from ray_tpu_torch._private.gcs.wal_backend import (FileWalBackend,
                                                      WalBackend)

        if isinstance(path_or_backend, WalBackend):
            self._backend = path_or_backend
        else:
            self._backend = FileWalBackend(path_or_backend, snapshot_path)
        self._snapshot_fn = snapshot_fn
        self._threshold = compact_threshold
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stop = False
        # Durability watermarks for sync(): records queued vs. records
        # acknowledged durable by the backend.
        self._seq_queued = 0
        self._seq_durable = 0
        self._backend_tag = type(self._backend).__name__
        self._sync_timeout_logged = False
        self._size = len(self._backend.read_log())
        self._thread = threading.Thread(target=self._writer_loop,
                                        daemon=True, name="gcs-wal")
        self._thread.start()

    # ---------------------------------------------------------------- api
    def append(self, record: Tuple) -> None:
        """Queue one record (non-blocking; the writer thread batches)."""
        with self._cv:
            self._q.append(record)
            self._seq_queued += 1
            if len(self._q) == 1:
                self._cv.notify()

    def sync(self, timeout_s: float = 10.0) -> bool:
        """Block until every record queued BEFORE this call is durable in
        the backend (or the deadline passes; returns False then). The
        fault-tolerance tests use this instead of guessing a sleep that
        outruns the batched writer under load; a production caller can
        use it as a write barrier before acting on persisted state."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            target = self._seq_queued
            while self._seq_durable < target:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    gap = target - self._seq_durable
                    # Logged inside sync() itself: most callers ignore the
                    # bool, and a silent False here means the caller may
                    # act on state the WAL never made durable.
                    if not self._sync_timeout_logged:
                        self._sync_timeout_logged = True
                        logger.warning(
                            "WAL sync() timed out after %.1fs with %d "
                            "record(s) queued but not durable (queued=%d "
                            "durable=%d, backend=%s)",
                            timeout_s, gap, target, self._seq_durable,
                            self._backend_tag)
                    return False
                self._cv.wait(min(remaining, 0.05))
        return True


    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # Writer wedged (e.g. fsync stalled): draining/compacting here
            # would interleave two writers on one file and could install a
            # torn snapshot. Leave the log as-is — replay recovers it.
            logger.warning("WAL writer did not stop; skipping final "
                           "compaction (log replays on next start)")
            return
        # Final compaction: restart loads one snapshot, no replay.
        try:
            self._drain_to_file()
            self._compact()
        except Exception:  # noqa: BLE001
            logger.exception("final WAL compaction failed")
        self._backend.close()

    # ------------------------------------------------------------- writer
    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait(0.5)
                if self._stop:
                    return
            # Brief coalesce: one write+fsync for a burst of records.
            time.sleep(self.FLUSH_PERIOD_S)
            try:
                # Drain the WHOLE queue this wake (one write+fsync per
                # 4096-record chunk, no sleep between chunks): capping a
                # wake at one chunk throttled the log to ~80k records/s
                # and left actor-churn bursts unflushed when the process
                # was killed (scale-stress hotspot #1).
                while True:
                    with self._cv:
                        empty = not self._q
                    if empty:
                        break
                    self._drain_to_file()
                    if self._size > self._threshold:
                        # Compact mid-drain too: sustained append load
                        # keeps the queue non-empty, and waiting for an
                        # idle moment would grow the log without bound
                        # (records are idempotent upserts, so a mutation
                        # racing the snapshot replays harmlessly).
                        self._compact()
            except Exception:  # noqa: BLE001
                logger.exception("WAL write failed (will retry)")
                time.sleep(0.5)  # backoff before retrying the requeue

    def _drain_to_file(self) -> None:
        with self._cv:
            batch, n = [], 0
            while self._q and n < 4096:
                batch.append(self._q.popleft())
                n += 1
        if not batch:
            return
        parts = []
        for rec in batch:
            blob = pickle.dumps(rec)
            parts.append(_LEN.pack(len(blob)))
            parts.append(blob)
        data = b"".join(parts)
        try:
            self._backend.append(data)
        except Exception:
            # A failed append (remote backend blip) must NOT drop state
            # mutations — requeue the batch at the FRONT (order preserved)
            # and let the writer loop retry; durability is the point.
            with self._cv:
                self._q.extendleft(reversed(batch))
            raise
        self._size += len(data)
        with self._cv:
            self._seq_durable += len(batch)
            self._cv.notify_all()  # wake sync() waiters

    def _compact(self) -> None:
        """Snapshot-then-truncate. Mutations racing the snapshot capture
        end up in both the snapshot and the next log batch — harmless,
        records are idempotent upserts."""
        self._backend.install_snapshot(self._snapshot_fn())
        self._size = 0


__all__ = ["WriteAheadLog", "parse_records"]
