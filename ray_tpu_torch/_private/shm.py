"""ctypes binding to the port's native shared-memory object store
(``_private/native/shm_store.cpp``, the port's copy of JAX's
``native/shm_store.cpp``; the port of ``ray_tpu/_private/shm.py``).

Two roles, as plasma's store and client:

* :class:`ShmStore` lives in the node manager: the index, the LRU order
  and each segment's life.
* :class:`ShmClient` lives in workers and drivers: it creates sealed
  segments itself (a put's bytes never cross a socket) and maps them for
  a get without a copy.

Every segment of the port is ``/dev/shm/rtst-*`` (a store's are
``rtst-<store id>.<object id>``, a client's ``rtst-<object id>``), beside
the channels' ``rtch-*``, so a teardown check sees both. The library is
built with the host compiler at first use (:mod:`native_build`); a failed
build raises.

Where the port differs: :meth:`ShmClient.map_segment_view` maps a segment
private and copy-on-write (JAX maps it shared and read-only). The view it
returns is read-only, so a numpy array over it is read-only as in JAX, but
a tensor the reader builds over it (the serializer's tensor path, through
:func:`writable_alias`) may be written in place: the write copies the
pages it touches into the reader's process and never reaches the segment
or its other readers.
"""

from __future__ import annotations

import atexit
import ctypes
import mmap
import os
import pickle
import threading
import uuid
import weakref
from typing import List, Optional, Tuple

#: The prefix of every store segment's name in ``/dev/shm``.
SEGMENT_PREFIX = "rtst-"
_NAME_CAP = 192
_IOV_MAX = 1024

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    from ray_tpu_torch._private import native_build

    lib = native_build.load("shm_store")
    lib.shm_store_create.restype = ctypes.c_void_p
    lib.shm_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.shm_store_destroy.argtypes = [ctypes.c_void_p]
    lib.shm_store_put.restype = ctypes.c_int
    lib.shm_store_put.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_char_p, ctypes.c_uint64]
    lib.shm_store_register.restype = ctypes.c_int
    lib.shm_store_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_uint64]
    lib.shm_store_get.restype = ctypes.c_int
    lib.shm_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_uint64)]
    lib.shm_store_contains.restype = ctypes.c_int
    lib.shm_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_store_coldest.restype = ctypes.c_int
    lib.shm_store_coldest.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64]
    lib.shm_store_delete.restype = ctypes.c_int
    lib.shm_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.shm_store_used.restype = ctypes.c_uint64
    lib.shm_store_used.argtypes = [ctypes.c_void_p]
    lib.shm_store_count.restype = ctypes.c_uint64
    lib.shm_store_count.argtypes = [ctypes.c_void_p]
    lib.shm_client_map.restype = ctypes.c_void_p
    lib.shm_client_map.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.shm_client_unmap.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.shm_client_create.restype = ctypes.c_int
    lib.shm_client_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_uint64]
    lib.shm_client_unlink.restype = ctypes.c_int
    lib.shm_client_unlink.argtypes = [ctypes.c_char_p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The store's library, built and loaded at the first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load()
        return _lib


# Every open store of this process: closed at exit, so a process that
# ends without shutting its nodes down leaves no segment behind.
_open_stores: "weakref.WeakSet[ShmStore]" = weakref.WeakSet()


@atexit.register
def _close_open_stores() -> None:
    for store in list(_open_stores):
        store.close()


class ShmStore:
    """The node manager's store: index, LRU order, segment lifecycle."""

    def __init__(self, capacity_bytes: int = 4 << 30,
                 prefix: Optional[str] = None):
        self._lib = get_lib()
        self.prefix = prefix or f"{SEGMENT_PREFIX}{uuid.uuid4().hex[:12]}"
        self._h = ctypes.c_void_p(
            self._lib.shm_store_create(self.prefix.encode(), capacity_bytes))
        # Calls hold this against close: a call after it finds no handle
        # and answers as an empty store, where the freed handle would
        # crash the process (a request still in flight at a node's end).
        self._h_lock = threading.Lock()
        _open_stores.add(self)

    def _call(self, fn, *args, closed=None):
        with self._h_lock:
            if not self._h:
                return closed
            return fn(self._h, *args)

    def put(self, oid_hex: str, data: bytes) -> Optional[str]:
        """Create, fill and seal a segment of ``data``; its name, or None
        when it did not fit."""
        name = ctypes.create_string_buffer(_NAME_CAP)
        rc = self._call(self._lib.shm_store_put, oid_hex.encode(), data,
                        len(data), name, _NAME_CAP, closed=-1)
        return name.value.decode() if rc == 0 else None

    def register(self, oid_hex: str, name: str, size: int) -> bool:
        """Index a segment a client created and sealed."""
        return self._call(self._lib.shm_store_register, oid_hex.encode(),
                          name.encode(), size, closed=-1) == 0

    def get(self, oid_hex: str) -> Optional[Tuple[str, int]]:
        name = ctypes.create_string_buffer(_NAME_CAP)
        size = ctypes.c_uint64()
        rc = self._call(self._lib.shm_store_get, oid_hex.encode(), name,
                        _NAME_CAP, ctypes.byref(size), closed=-1)
        if rc != 0:
            return None
        return name.value.decode(), size.value

    def read(self, oid_hex: str) -> Optional[bytes]:
        """A copy of an object's bytes (the remote pull's path)."""
        meta = self.get(oid_hex)
        if meta is None:
            return None
        return ShmClient.read_segment(*meta)

    def contains(self, oid_hex: str) -> bool:
        return bool(self._call(self._lib.shm_store_contains,
                               oid_hex.encode(), closed=0))

    def coldest(self) -> Optional[str]:
        """The least recently used object's id (a spill victim), or None
        when the store is empty."""
        buf = ctypes.create_string_buffer(_NAME_CAP)
        if self._call(self._lib.shm_store_coldest, buf, _NAME_CAP,
                      closed=-1) != 0:
            return None
        return buf.value.decode()

    def delete(self, oid_hex: str) -> bool:
        return self._call(self._lib.shm_store_delete, oid_hex.encode(),
                          closed=-1) == 0

    def stats(self) -> Tuple[int, int]:
        """(bytes in use, objects)."""
        return (self._call(self._lib.shm_store_used, closed=0),
                self._call(self._lib.shm_store_count, closed=0))

    def close(self) -> None:
        """Unlink every segment of the store and free its index (once)."""
        with self._h_lock:
            h, self._h = self._h, None
        if h:
            self._lib.shm_store_destroy(h)


def _path(name: str) -> str:
    return f"/dev/shm/{name.lstrip('/')}"


_LIBC = ctypes.CDLL(None, use_errno=True)
_LIBC.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
_LIBC.mprotect.restype = ctypes.c_int


class ShmClient:
    """A worker's or driver's access: create a sealed segment, map one."""

    @staticmethod
    def create_segment(name: str, data: bytes) -> bool:
        return get_lib().shm_client_create(name.encode(), data,
                                           len(data)) == 0

    @staticmethod
    def create_segment_vectored(name: str, parts: List) -> bool:
        """Create and seal a segment from buffers in ``writev`` calls: a
        large out-of-band buffer is copied once, by the kernel, into the
        segment. True when the segment exists afterwards (one that
        existed already holds the same immutable object)."""
        try:
            fd = os.open(_path(name), os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                         0o600)
        except FileExistsError:
            return True
        except OSError:
            return False
        try:
            todo = [p if isinstance(p, bytes) else memoryview(p).cast("B")
                    for p in parts if len(p)]
            while todo:
                written = os.writev(fd, todo[:_IOV_MAX])
                # A partial write: drop the buffers written, cut the next.
                while todo and written >= len(todo[0]):
                    written -= len(todo[0])
                    todo.pop(0)
                if written and todo:
                    todo[0] = todo[0][written:]
            return True
        except OSError:
            try:
                os.unlink(_path(name))
            except OSError:
                pass
            return False
        finally:
            os.close(fd)

    @staticmethod
    def unlink_segment(name: str) -> None:
        get_lib().shm_client_unlink(name.encode())

    @staticmethod
    def read_segment(name: str, size: int) -> Optional[bytes]:
        """A copy of a segment's bytes, or None when it is gone."""
        lib = get_lib()
        ptr = lib.shm_client_map(name.encode(), size)
        if not ptr:
            return None
        try:
            return ctypes.string_at(ptr, size)
        finally:
            lib.shm_client_unmap(ptr, size)

    @staticmethod
    def map_segment_view(name: str, size: int) -> Optional[memoryview]:
        """A read-only view of a segment, without a copy, or None when it
        is gone. The view owns the mapping: slices of it, and arrays and
        tensors deserialized over it, keep it alive, and it goes with the
        last of them. POSIX keeps a mapping valid after the store unlinks
        the segment, so a reader never races a free (and pins the pages
        until it lets go). The pages are read in when mapped
        (``MAP_POPULATE``), then made writable copy-on-write (module
        docstring)."""
        try:
            fd = os.open(_path(name), os.O_RDONLY)
        except OSError:
            return None
        try:
            if os.fstat(fd).st_size < size:
                return None     # a segment still being written
            mm = _PrivateMap(fd, size, flags=mmap.MAP_PRIVATE
                             | getattr(mmap, "MAP_POPULATE", 0),
                             prot=mmap.PROT_READ)
        except (OSError, ValueError):
            return None
        finally:
            os.close(fd)
        view = memoryview(mm)
        # Populated read-only, so no page is copied; writable from here
        # on, so a write copies only the page it touches.
        import numpy as np

        addr = np.frombuffer(view, np.uint8).ctypes.data
        if _LIBC.mprotect(ctypes.c_void_p(addr), size,
                          mmap.PROT_READ | mmap.PROT_WRITE) != 0:
            raise OSError(ctypes.get_errno(),
                          f"mprotect of segment {name} failed")
        return view


class _PrivateMap(mmap.mmap):
    """A reader's private mapping of a segment
    (:meth:`ShmClient.map_segment_view`), writable copy-on-write."""


def _memory_owner(obj):
    """The object that owns the memory under ``obj``: down an array's
    bases and a memoryview's exporters to the first that is neither."""
    while True:
        if isinstance(obj, pickle.PickleBuffer):
            obj = obj.raw()
        inner = getattr(obj, "base", None) if hasattr(obj, "__array__") \
            else getattr(obj, "obj", None) if isinstance(obj, memoryview) \
            else None
        if inner is None or inner is obj:
            return obj
        obj = inner


def writable_alias(array):
    """A writable numpy array over ``array``'s bytes when they lie in a
    reader's private mapping of a segment, whose pages take a write
    copy-on-write, so it stays this process's; None when they lie
    anywhere else. The alias keeps the mapping alive."""
    owner = _memory_owner(array)
    if not isinstance(owner, _PrivateMap):
        return None
    import numpy as np

    raw = (ctypes.c_ubyte * array.nbytes).from_address(array.ctypes.data)
    raw.mapping = owner
    return np.ndarray(array.shape, array.dtype, buffer=raw,
                      strides=array.strides)
