"""Unique identifiers for jobs, tasks, actors, objects, nodes, and placement groups
(the port's copy of ``ray_tpu/_private/ids.py``).

A re-design of the reference id model (reference: ``src/ray/common/id.h``,
``src/ray/common/id_def.h``, spec ``src/ray/design_docs/id_specification.md``):
ids are fixed-size byte strings; an ``ObjectID`` embeds the ``TaskID`` that created
it plus a return/put index, which gives every object a lineage pointer for free
(used by lineage reconstruction). A ``TaskID`` embeds the ``ActorID`` (or a nil
actor id for normal tasks), and an ``ActorID`` embeds the ``JobID``.

Sizes (bytes):
    JobID            4
    ActorID         12  = 8 unique + 4 job
    TaskID          24  = 12 unique + 12 actor
    ObjectID        28  = 24 task + 4 index (little-endian uint32)
    NodeID          16
    WorkerID        16
    PlacementGroupID 16
    ClusterID       16
"""

from __future__ import annotations

import os
import threading
from typing import ClassVar


class _FastRandom:
    """Buffered unique-id entropy: one ``os.urandom`` syscall refills 8KB
    instead of one syscall per id — id creation is on the task-submit hot
    path (reference: ids only need uniqueness, not crypto strength, and
    the reference's ``FromRandom`` likewise uses a userspace PRNG)."""

    def __init__(self):
        self._buf = b""
        self._off = 0
        self._lock = threading.Lock()

    def take(self, n: int) -> bytes:
        with self._lock:
            if self._off + n > len(self._buf):
                self._buf = os.urandom(8192)
                self._off = 0
            out = self._buf[self._off:self._off + n]
            self._off += n
            return out


_rng = _FastRandom()
# A fork must not replay the parent's entropy buffer (duplicate ids).
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=lambda: _rng.__init__())


def _random_bytes(n: int) -> bytes:
    return _rng.take(n)


class BaseID:
    """Immutable fixed-size binary id with hex repr."""

    SIZE: ClassVar[int] = 16
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, "
                f"got {len(binary) if isinstance(binary, bytes) else type(binary)}"
            )
        object.__setattr__(self, "_binary", binary)
        object.__setattr__(self, "_hash", hash((type(self).__name__, binary)))

    def __setattr__(self, *a):  # immutability
        raise AttributeError(f"{type(self).__name__} is immutable")

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_random(cls):
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def from_binary(cls, binary: bytes):
        return cls(binary)

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    # -- accessors --------------------------------------------------------
    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._binary == self._binary

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self).from_binary, (self._binary,))


class ClusterID(BaseID):
    SIZE = 16


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class JobID(BaseID):
    SIZE = 4
    _counter_lock: ClassVar[threading.Lock] = threading.Lock()
    _counter: ClassVar[int] = 0

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(cls.SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._binary, "little")


class ActorID(BaseID):
    SIZE = 12
    UNIQUE_BYTES = 8

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_random_bytes(cls.UNIQUE_BYTES) + job_id.binary())

    @classmethod
    def nil_for_job(cls, job_id: JobID) -> "ActorID":
        return cls(b"\xff" * cls.UNIQUE_BYTES + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._binary[self.UNIQUE_BYTES :])


class TaskID(BaseID):
    SIZE = 24
    UNIQUE_BYTES = 12

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(_random_bytes(cls.UNIQUE_BYTES) + ActorID.nil_for_job(job_id).binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_random_bytes(cls.UNIQUE_BYTES) + actor_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        # Deterministic: the creation task of an actor is identified by the actor id.
        return cls(b"\x00" * cls.UNIQUE_BYTES + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(b"\x01" * cls.UNIQUE_BYTES + ActorID.nil_for_job(job_id).binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._binary[self.UNIQUE_BYTES :])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    SIZE = 28
    INDEX_BYTES = 4
    MAX_INDEX = 2**32 - 1

    @classmethod
    def from_task(cls, task_id: TaskID, index: int) -> "ObjectID":
        if not (0 <= index <= cls.MAX_INDEX):
            raise ValueError(f"object index out of range: {index}")
        return cls(task_id.binary() + index.to_bytes(cls.INDEX_BYTES, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[: TaskID.SIZE])

    def index(self) -> int:
        return int.from_bytes(self._binary[TaskID.SIZE :], "little")

    def job_id(self) -> JobID:
        return self.task_id().job_id()
