"""In-process object store (the port's copy of
``ray_tpu/_private/memory_store.py``).

Re-design of the reference ``CoreWorkerMemoryStore`` (reference:
``src/ray/core_worker/store_provider/memory_store/``): a thread-safe map of
``ObjectID -> value`` with blocking waits. The in-process runtime keeps
every object here, by reference: a value is never serialized, so a CUDA
tensor put here stays on its card (the cluster's wire, which would copy
it, is not ported).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private.ids import ObjectID


class _Entry:
    __slots__ = ("value", "ready", "callbacks")

    def __init__(self):
        self.value: Any = None
        self.ready = threading.Event()
        self.callbacks: List[Any] = []


_SENTINEL = object()


class MemoryStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._objects: Dict[ObjectID, _Entry] = {}

    def _entry(self, object_id: ObjectID) -> _Entry:
        with self._lock:
            e = self._objects.get(object_id)
            if e is None:
                e = _Entry()
                self._objects[object_id] = e
            return e

    def put(self, object_id: ObjectID, value: Any) -> None:
        e = self._entry(object_id)
        e.value = value
        with self._lock:
            callbacks, e.callbacks = e.callbacks, []
            e.ready.set()
        for cb in callbacks:
            try:
                cb(object_id, e.value)
            except Exception:  # callbacks must not break the putter or peers
                import logging

                logging.getLogger(__name__).exception(
                    "object-ready callback failed for %s", object_id)

    def on_ready(self, object_id: ObjectID, callback) -> None:
        """Invoke ``callback(object_id, value)`` when (or if already) ready."""
        e = self._entry(object_id)
        with self._lock:
            if not e.ready.is_set():
                e.callbacks.append(callback)
                return
        callback(object_id, e.value)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            e = self._objects.get(object_id)
        return e is not None and e.ready.is_set()

    def get_if_ready(self, object_id: ObjectID, default=_SENTINEL):
        with self._lock:
            e = self._objects.get(object_id)
        if e is not None and e.ready.is_set():
            return e.value
        if default is _SENTINEL:
            raise KeyError(object_id)
        return default

    def get(self, object_id: ObjectID, timeout: Optional[float] = None) -> Any:
        e = self._entry(object_id)
        if not e.ready.wait(timeout):
            from ray_tpu_torch.exceptions import GetTimeoutError

            raise GetTimeoutError(f"Timed out getting object {object_id.hex()}")
        return e.value

    def wait(
        self,
        object_ids: Sequence[ObjectID],
        num_returns: int,
        timeout: Optional[float],
    ) -> Tuple[List[ObjectID], List[ObjectID]]:
        """Block until ``num_returns`` of ``object_ids`` are ready or timeout.

        Returns (ready, not_ready) preserving input order, like the reference
        ``ray.wait``.
        """
        entries = [self._entry(oid) for oid in object_ids]
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ready = [oid for oid, e in zip(object_ids, entries) if e.ready.is_set()]
            if len(ready) >= num_returns:
                ready_list = ready[:num_returns]
                ready_set = set(ready_list)
                not_ready = [oid for oid in object_ids if oid not in ready_set]
                return ready_list, not_ready
            if deadline is not None and time.monotonic() >= deadline:
                ready_set = set(ready)
                return ready, [oid for oid in object_ids if oid not in ready_set]
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            pending = next(e for e in entries if not e.ready.is_set())
            if num_returns >= len(entries):
                # Every entry is needed: block on a pending one until it
                # is set (a streamed item's consumer waits here, woken
                # by the put, not by a poll).
                pending.ready.wait(remaining)
                continue
            step = 0.002 if remaining is None else min(0.002, remaining)
            # Block on the first non-ready entry with a short timeout so new
            # completions of *any* entry are noticed promptly.
            pending.ready.wait(step)

    def delete(self, object_ids: Sequence[ObjectID]) -> None:
        with self._lock:
            for oid in object_ids:
                self._objects.pop(oid, None)

    def size(self) -> int:
        with self._lock:
            return len(self._objects)
