"""Shared-memory channels (the port of ``Channel``, ``ChannelClosed`` and
``ChannelTimeout`` of ``ray_tpu/experimental/channel.py``).

A fixed-capacity buffer in POSIX shared memory (``/dev/shm/rtch-*``) that
one writer mutates in place and up to 16 readers consume, synchronized by
a version/ack protocol in the buffer's header instead of messages. The
serve plane moves a KV handoff's staging bytes between replica processes
through one (:mod:`ray_tpu_torch.serve.kv_transfer`).

The JAX package reaches the same layout through a g++ library when one
builds, and through an mmap path otherwise; the port keeps only the mmap
path, byte for byte, so a channel either package created reads in the
other (``tests/test_torch_channel.py``). It still bumps the header's
wake word and wakes futex waiters, so a native reader blocked in
``futex_wait`` sees a write at once. A value is pickled straight into
the segment and unpickled straight out of it (the same bytes as
``pickle.dumps``, one copy each way instead of two). The compiled-DAG loop
(``run_dag_loop``) waits for ROADMAP item 13.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import pickle
import struct
import time
import uuid
from typing import Any, List, Optional

__all__ = ["Channel", "ChannelClosed", "ChannelTimeout", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 1 << 20  # 1 MiB payloads by default
_MAGIC = 0x52544348
# Byte layout: magic u32, n_readers u32, capacity u64, version u64, size
# u64, closed u64; the u32 wake word at 40; acks (16 * u64) at offset 64;
# payload at offset 192.
_VER_OFF = 16
_SIZE_OFF = 24
_CLOSED_OFF = 32
_FUTEX_OFF = 40
_ACKS_OFF = 64
_DATA_OFF = 192
_MAX_READERS = 16
# Both ends map the segment populated: a first touch of each page faults,
# which some virtualised hosts make far dearer than populating in one
# call (~6 µs a page on an H100 host: chip_smoke.py --channel-mbs).
_MAP_FLAGS = mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)


def _futex_setup():
    try:
        import platform

        nr = {"x86_64": 202, "aarch64": 98}.get(platform.machine())
        if nr is None:
            return None, None
        return ctypes.CDLL(None, use_errno=True), nr
    except Exception:  # noqa: BLE001 — no libc handle: no wake
        return None, None


_LIBC, _SYS_FUTEX = _futex_setup()


def _futex_wake(mm: "mmap.mmap") -> None:
    """Bump the shared wake word and FUTEX_WAKE native waiters (this
    path polls; a native peer blocked in futex_wait would otherwise see
    the write only at its 50 ms safety timeout)."""
    if _LIBC is None:
        return
    try:
        word = ctypes.c_uint32.from_buffer(mm, _FUTEX_OFF)
        word.value = (word.value + 1) & 0xFFFFFFFF
        _LIBC.syscall(_SYS_FUTEX, ctypes.addressof(word), 1, 0x7FFFFFFF,
                      None, None, 0)
        del word      # an exported pointer would block mm.close()
    except Exception:  # noqa: BLE001 — the wake is best-effort
        pass


class _Sink:
    """A pickler's file: counts the bytes (``mm`` None) or writes them
    into ``mm`` from ``off`` on. A large buffer (a numpy array's, with
    protocol 5) reaches ``write`` as a view, so neither pass copies it
    but into the segment."""

    def __init__(self, mm=None, off: int = 0):
        self.mm, self.off = mm, off

    def write(self, data) -> int:
        view = memoryview(data).cast("B")
        n = view.nbytes
        if self.mm is not None:
            self.mm[self.off:self.off + n] = view
        self.off += n
        return n


def _pickle_into(value, mm=None, off: int = 0) -> int:
    """``pickle.dumps(value, protocol=5)``'s bytes written at ``off`` of
    ``mm`` (or only counted): the same bytes, without the copy a bytes
    object of them would take. Returns their length."""
    sink = _Sink(mm, off)
    pickle.Pickler(sink, protocol=5).dump(value)
    return sink.off - off


class ChannelClosed(Exception):
    """The writer closed the channel; no further values will arrive."""


class ChannelTimeout(Exception):
    pass


class Channel:
    """One writer, ``n_readers`` readers, one mutable value in flight.

    ``write`` blocks until every reader consumed the previous value;
    ``read`` blocks for the next value. Pickling a Channel gives an
    attach-spec: unpickling it in another process attaches to the same
    segment (a manifest carries one across the replica pipe)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, n_readers: int = 1,
                 name: Optional[str] = None, _create: bool = True,
                 _reader_idx: int = -1):
        if _create and not 1 <= n_readers <= _MAX_READERS:
            raise ValueError(
                f"Channel supports 1..{_MAX_READERS} readers, got "
                f"{n_readers} (the header reserves {_MAX_READERS} ack "
                f"slots)")
        self.name = name or f"/rtch-{uuid.uuid4().hex[:24]}"
        self.capacity = capacity
        self.n_readers = n_readers
        self.reader_idx = _reader_idx
        self._creator = _create
        self._closed_seen = False
        self._mm = None
        self._last_seen = 0
        self._open(_create)

    def _open(self, create: bool) -> None:
        path = f"/dev/shm{self.name}"
        total = _DATA_OFF + self.capacity
        if create:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, total)
                self._mm = mmap.mmap(fd, total, flags=_MAP_FLAGS)
            finally:
                os.close(fd)
            # The magic last: a reader attaching meanwhile waits for it.
            struct.pack_into("<IQQQ", self._mm, 4, self.n_readers,
                             self.capacity, 0, 0)
            struct.pack_into("<I", self._mm, 0, _MAGIC)
            return
        deadline = time.monotonic() + 10.0
        while True:
            mm = self._attach_once(path)
            if mm is not None:
                break
            if time.monotonic() > deadline:
                raise OSError(f"channel {self.name} does not exist (or "
                              f"is not a channel)")
            time.sleep(0.001)
        self._mm = mm
        _, self.n_readers, self.capacity = struct.unpack_from("<IIQ", mm, 0)

    @staticmethod
    def _attach_once(path: str):
        """The segment at ``path`` mapped, or None while it is missing or
        its creator has not finished it (no size, no magic yet)."""
        try:
            fd = os.open(path, os.O_RDWR)
        except FileNotFoundError:
            return None
        try:
            size = os.fstat(fd).st_size
            if size <= _DATA_OFF:
                return None
            mm = mmap.mmap(fd, size, flags=_MAP_FLAGS)
        finally:
            os.close(fd)
        if struct.unpack_from("<I", mm, 0)[0] != _MAGIC:
            mm.close()
            return None
        return mm

    def _version(self) -> int:
        return struct.unpack_from("<Q", self._mm, _VER_OFF)[0]

    def _size(self) -> int:
        return struct.unpack_from("<Q", self._mm, _SIZE_OFF)[0]

    def _closed(self) -> bool:
        return struct.unpack_from("<Q", self._mm, _CLOSED_OFF)[0] != 0

    # --------------------------------------------------------------- pickle
    def __reduce__(self):
        return (_attach, (self.name, self.capacity, self.n_readers,
                          self.reader_idx))

    def reader(self, idx: int) -> "Channel":
        """Attach-spec for reader ``idx`` (what another process gets)."""
        return _attach(self.name, self.capacity, self.n_readers, idx)

    # ------------------------------------------------------------------ ops
    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        size = _pickle_into(value)
        if size > self.capacity:
            raise ValueError(
                f"serialized value ({size} B) exceeds channel capacity "
                f"({self.capacity} B); create the Channel with a larger "
                f"capacity")
        deadline = None if timeout is None else time.monotonic() + timeout
        v = self._version()
        while True:
            acks = struct.unpack_from(f"<{self.n_readers}Q", self._mm,
                                      _ACKS_OFF)
            if all(a == v for a in acks):
                break
            if self._closed():
                raise ChannelClosed(self.name)
            if deadline and time.monotonic() > deadline:
                raise ChannelTimeout(f"write timed out on {self.name}")
            time.sleep(0.0001)
        # Seqlock: an odd version while the bytes change.
        struct.pack_into("<Q", self._mm, _VER_OFF, v + 1)
        _pickle_into(value, self._mm, _DATA_OFF)
        struct.pack_into("<Q", self._mm, _SIZE_OFF, size)
        struct.pack_into("<Q", self._mm, _VER_OFF, v + 2)
        _futex_wake(self._mm)

    def read(self, timeout: Optional[float] = None) -> Any:
        if self._closed_seen:
            raise ChannelClosed(self.name)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            v = self._version()
            if v % 2 == 0 and v != self._last_seen:
                size = self._size()
                # Unpickled from the segment itself (unpickling copies
                # what it keeps). An acking reader's bytes cannot change
                # before its ack; a non-acking one's may, and then the
                # version says so.
                try:
                    with memoryview(self._mm) as whole, \
                            whole[_DATA_OFF:_DATA_OFF + size] as view:
                        value = pickle.loads(view)
                except Exception:  # noqa: BLE001 — torn by a rewrite?
                    if self._version() == v:
                        raise
                    continue
                if self._version() == v:  # seqlock validate
                    self._last_seen = v
                    if self.reader_idx >= 0:
                        struct.pack_into("<Q", self._mm,
                                         _ACKS_OFF + 8 * self.reader_idx, v)
                        _futex_wake(self._mm)
                    return value
                continue
            if self._closed():
                # A pending value (if any) was consumed above.
                self._closed_seen = True
                raise ChannelClosed(self.name)
            if deadline and time.monotonic() > deadline:
                raise ChannelTimeout(f"read timed out on {self.name}")
            time.sleep(0.0001)

    # ------------------------------------------------------ observability
    def reader_acks(self) -> tuple:
        """``(version, [ack_0 .. ack_{n-1}])`` snapshot of the header: a
        reader whose ack trails ``version`` has not consumed the current
        value."""
        ver = self._version()
        acks = struct.unpack_from(f"<{self.n_readers}Q", self._mm,
                                  _ACKS_OFF)
        return ver, list(acks)

    def lagging_readers(self) -> List[int]:
        """Reader indices that have not acked the latest written version."""
        ver, acks = self.reader_acks()
        return [i for i, a in enumerate(acks) if a < ver]

    def close(self) -> None:
        """Writer side: publish the closed sentinel to every reader."""
        if self._mm is not None:
            struct.pack_into("<Q", self._mm, _CLOSED_OFF, 1)
            _futex_wake(self._mm)

    def destroy(self) -> None:
        """Detach and unlink the segment (either side may; unlinking a
        segment already gone is a no-op)."""
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        try:
            os.unlink(f"/dev/shm{self.name}")
        except OSError:
            pass

    def __del__(self):  # detach only; unlink is explicit via destroy()
        try:
            if self._mm is not None:
                self._mm.close()
        except Exception:  # noqa: BLE001
            pass


def _attach(name: str, capacity: int, n_readers: int, reader_idx: int) \
        -> Channel:
    return Channel(capacity=capacity, n_readers=n_readers, name=name,
                   _create=False, _reader_idx=reader_idx)
