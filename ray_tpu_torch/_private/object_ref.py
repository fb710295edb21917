"""ObjectRef: a future-like handle to a (possibly pending) object (the
port's copy of ``ray_tpu/_private/object_ref.py``).

Re-design of the reference ObjectRef (reference: ``python/ray/_raylet.pyx``
``ObjectRef``): carries the 28-byte ``ObjectID`` (task lineage + index) and the
owner's address. Refcounting hooks notify the runtime on creation and GC, so
the in-process runtime frees a value once no ``ObjectRef`` to it is left.
"""

from __future__ import annotations

import time
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID, TaskID

# Index space for streamed generator items: distinct from declared returns
# (0..n-1) and put-scoped ids (2^31 + k).
STREAM_INDEX_BASE = 1 << 30


def drain_stream(gen, task_id: TaskID, put) -> int:
    """Drain a streaming-generator task: each yielded value becomes its own
    store object at the deterministic stream id the consumer's
    ObjectRefGenerator polls; the returned count rides the task's declared
    return (reference: ObjectRefStream, ``task_manager.h:104``). ``put`` is
    the executor's object sink ``(ObjectID, value) -> None``. The single
    implementation keeps the id scheme/count protocol identical across the
    local, async-actor, and cluster-worker executors."""
    i = 0
    for item in gen:
        put(ObjectID.from_task(task_id, STREAM_INDEX_BASE + i), item)
        i += 1
    return i


async def drain_stream_async(agen, task_id: TaskID, put) -> int:
    """Async-generator variant of :func:`drain_stream`."""
    i = 0
    async for item in agen:
        put(ObjectID.from_task(task_id, STREAM_INDEX_BASE + i), item)
        i += 1
    return i


class ObjectRef:
    __slots__ = ("_id", "_owner_address", "_call_site", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: str = "", call_site: str = "",
                 skip_ref_count: bool = False):
        self._id = object_id
        self._owner_address = owner_address
        self._call_site = call_site
        self._registered = False
        if not skip_ref_count:
            from ray_tpu_torch._private import worker as _worker

            w = _worker.global_worker_or_none()
            if w is not None:
                w.core.add_local_reference(self)
                self._registered = True

    # -- identity ---------------------------------------------------------
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self) -> TaskID:
        return self._id.task_id()

    def owner_address(self) -> str:
        return self._owner_address

    def call_site(self) -> str:
        return self._call_site

    @classmethod
    def from_binary(cls, binary: bytes, owner_address: str = "") -> "ObjectRef":
        return cls(ObjectID(binary), owner_address)

    @classmethod
    def nil(cls) -> "ObjectRef":
        return cls(ObjectID.nil(), skip_ref_count=True)

    # -- semantics --------------------------------------------------------
    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        # Pickling keeps id + owner; unpickled in this process it resolves
        # through the same in-process store.
        return (_rebuild_ref, (self._id.binary(), self._owner_address))

    def __del__(self):
        if getattr(self, "_registered", False):
            try:
                from ray_tpu_torch._private import worker as _worker

                w = _worker.global_worker_or_none()
                if w is not None:
                    w.core.remove_local_reference(self._id)
            except Exception:
                pass

    def future(self):
        """Return a concurrent.futures.Future resolving to the object's value."""
        from ray_tpu_torch._private import worker as _worker

        return _worker.global_worker().core.as_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()


def _rebuild_ref(binary: bytes, owner_address: str) -> ObjectRef:
    ref = ObjectRef(ObjectID(binary), owner_address)
    return ref


class ObjectRefGenerator:
    """Stream of ObjectRefs from a generator task (reference:
    ``ObjectRefStream``, ``task_manager.h:104`` / ``_raylet.pyx:284``).

    Yields the ref of item *i* as soon as the executor has stored it — the
    task may still be running. Iteration ends when the task finishes and
    ``i`` reaches the item count (carried by the task's declared return).
    ``num_returns="streaming"`` (or ``"dynamic"``) on a generator task
    returns one of these from ``.remote()``.
    """

    def __init__(self, length_ref: ObjectRef, owner_address: str = ""):
        self._length_ref = length_ref
        self._task_id = length_ref.task_id()
        self._owner_address = owner_address
        self._i = 0
        self._length: Optional[int] = None
        self._exhausted = False

    def _check_length(self) -> Optional[int]:
        if self._length is not None:
            return self._length
        from ray_tpu_torch._private import worker as _worker

        core = _worker.global_worker().core
        ready, _ = core.wait([self._length_ref], num_returns=1, timeout=0,
                             fetch_local=True)
        if ready:
            n = core.get([self._length_ref], timeout=30)[0]
            self._length = int(n)
        return self._length

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        # Blocks until the item arrives, the stream ends, or the task's
        # stored error surfaces via the length ref — task failure (incl.
        # worker death) always stores an error there, so no deadline is
        # needed for liveness (reference: generator __next__ blocks).
        return self._next_internal(timeout=None)

    def _next_internal(self, timeout: Optional[float]) -> ObjectRef:
        from ray_tpu_torch import exceptions
        from ray_tpu_torch._private import worker as _worker

        core = _worker.global_worker().core
        oid = ObjectID.from_task(self._task_id, STREAM_INDEX_BASE + self._i)
        ref = ObjectRef(oid, owner_address=self._owner_address)
        deadline = None if timeout is None else time.monotonic() + timeout
        stall_deadline = None
        while True:
            # Item readiness first: items yielded before a mid-stream
            # failure must stay consumable (the length check below raises
            # the task's stored error once we're past the stored items).
            ready, _ = core.wait([ref], num_returns=1, timeout=0.05,
                                 fetch_local=True)
            if ready:
                self._i += 1
                return ref
            n = self._check_length()
            if n is not None and self._i >= n:
                self._exhausted = True
                raise StopIteration
            if n is not None:
                # The count says this item was produced, so a long miss
                # means it was freed or lost; the in-process runtime has
                # no lineage to rebuild it from.
                if stall_deadline is None:
                    stall_deadline = time.monotonic() + 10.0
                elif time.monotonic() > stall_deadline:
                    raise exceptions.ObjectLostError(
                        message=f"streamed item {self._i} of task "
                                f"{self._task_id.hex()[:16]} was lost")
            if deadline is not None and time.monotonic() > deadline:
                raise exceptions.GetTimeoutError(
                    f"streamed item {self._i} of task "
                    f"{self._task_id.hex()[:16]} did not arrive in "
                    f"{timeout}s")

    def completed(self) -> ObjectRef:
        """Ref resolving when the whole stream has been produced."""
        return self._length_ref

    def __del__(self):
        # Abandoned mid-stream: the tail items have no registered holder,
        # so ask the runtime to reap them once the stream length resolves
        # (reference: ObjectRefStream deletion on generator GC).
        if getattr(self, "_exhausted", True):
            return
        try:
            from ray_tpu_torch._private import worker as _worker

            w = _worker.global_worker_or_none()
            if w is not None:
                reap = getattr(w.core, "release_stream_tail", None)
                if reap is not None:
                    reap(self._length_ref, self._i)
        except Exception:  # noqa: BLE001
            pass

    def __repr__(self):
        return (f"ObjectRefGenerator(task={self._task_id.hex()[:16]}, "
                f"next={self._i})")
