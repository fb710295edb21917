"""Pluggable storage backends for the GCS write-ahead log (the port's
copy of ``ray_tpu/_private/gcs/wal_backend.py``: ``FileWalBackend`` :66,
``WalLogServer`` :117, ``RemoteWalBackend`` :150, ``backend_from_url``
:192). The log server speaks the port's wire
(:class:`~ray_tpu_torch._private.rpc.FrameServer` with a raw handler),
with JAX's frame kinds.

Reference: the GCS persists through a *store client* abstraction with an
in-memory and a Redis-backed implementation
(``src/ray/gcs/gcs_server/store_client/redis_store_client.h:107``) —
Redis is what survives head-MACHINE loss. This build's analog: a
``WalBackend`` interface with

* :class:`FileWalBackend` — local log + snapshot files (survives a head
  *process* restart; the default), and
* :class:`RemoteWalBackend` + :class:`WalLogServer` — a tiny external
  log server over the framed-TCP fastpath plane, holding the log in its
  own storage directory (another machine in production). A replacement
  GCS started anywhere with ``RAY_TPU_GCS_WAL_URL=logd://host:port``
  recovers the full cluster state from it.

Durability contract: ``append()`` returns after the bytes are durable in
the backend (fsync for files, server-side fsync acknowledged for the log
server). ``install_snapshot()`` atomically replaces the snapshot AND
truncates the log (records are idempotent upserts, so a mutation racing
the snapshot replays harmlessly).
"""

from __future__ import annotations

import abc
import argparse
import logging
import os
import pickle
import threading
from typing import Optional

logger = logging.getLogger(__name__)

# Fastpath frame kinds for the log-server protocol (disjoint from the
# task/object planes; one shared framing implementation).
KIND_WAL_APPEND = 16
KIND_WAL_LOAD = 17
KIND_WAL_SNAPSHOT = 18


class WalBackend(abc.ABC):
    """Durable storage for one GCS's log + snapshot."""

    @abc.abstractmethod
    def append(self, data: bytes) -> None:
        """Append pre-framed record bytes; durable on return."""

    @abc.abstractmethod
    def read_log(self) -> bytes:
        """The full current log (framed records, possibly torn tail)."""

    @abc.abstractmethod
    def load_snapshot(self) -> Optional[bytes]:
        """The last installed snapshot blob, or None."""

    @abc.abstractmethod
    def install_snapshot(self, blob: bytes) -> None:
        """Atomically install a snapshot and truncate the log."""

    def close(self) -> None:  # noqa: B027 — optional
        pass


class FileWalBackend(WalBackend):
    """Local files: ``<snapshot_path>`` + ``<log_path>`` (the round-4
    layout, unchanged on disk)."""

    def __init__(self, log_path: str, snapshot_path: str):
        self.log_path = log_path
        self.snapshot_path = snapshot_path
        os.makedirs(os.path.dirname(os.path.abspath(log_path)),
                    exist_ok=True)
        self._file = open(log_path, "ab")
        self._lock = threading.Lock()

    def append(self, data: bytes) -> None:
        with self._lock:
            self._file.write(data)
            self._file.flush()
            os.fsync(self._file.fileno())

    def read_log(self) -> bytes:
        with self._lock:
            self._file.flush()
        try:
            with open(self.log_path, "rb") as f:
                return f.read()
        except OSError:
            return b""

    def load_snapshot(self) -> Optional[bytes]:
        try:
            with open(self.snapshot_path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def install_snapshot(self, blob: bytes) -> None:
        tmp = f"{self.snapshot_path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snapshot_path)
        with self._lock:
            self._file.truncate(0)
            self._file.seek(0)
            os.fsync(self._file.fileno())

    def close(self) -> None:
        with self._lock:
            self._file.close()


class WalLogServer:
    """External log server: serves one GCS's WAL over framed TCP,
    storing in its OWN directory (a different machine in production —
    head-machine loss then loses nothing)."""

    def __init__(self, storage_dir: str, host: str = "127.0.0.1",
                 port: int = 0):
        from ray_tpu_torch._private import rpc

        os.makedirs(storage_dir, exist_ok=True)
        self._store = FileWalBackend(os.path.join(storage_dir, "wal.log"),
                                     os.path.join(storage_dir, "snapshot"))
        self._server = rpc.FrameServer(raw_handler=self._handle, host=host,
                                       port=port)
        self.address = self._server.address

    def _handle(self, kind: int, payload: bytes) -> bytes:
        if kind == KIND_WAL_APPEND:
            self._store.append(payload)
            return b"ok"
        if kind == KIND_WAL_LOAD:
            return pickle.dumps((self._store.load_snapshot(),
                                 self._store.read_log()))
        if kind == KIND_WAL_SNAPSHOT:
            self._store.install_snapshot(payload)
            return b"ok"
        raise ValueError(f"unknown WAL frame kind {kind}")

    def close(self) -> None:
        self._server.close()
        self._store.close()


class RemoteWalBackend(WalBackend):
    """Client for :class:`WalLogServer` (``logd://host:port``)."""

    def __init__(self, address: str):
        self.address = address
        # One KIND_WAL_LOAD returns (snapshot, log); recovery reads both,
        # so cache the pair instead of shipping the full state per
        # accessor. Any write invalidates it.
        self._load_cache: Optional[tuple] = None

    def _call(self, kind: int, payload: bytes, timeout: float = 30.0):
        from ray_tpu_torch._private import rpc

        try:
            conn = rpc.get_connection(self.address)
        except rpc.RpcError:
            raise ConnectionError(
                f"WAL log server unreachable at {self.address}") from None
        return conn.call(kind, payload, timeout=timeout)

    def _load(self) -> tuple:
        if self._load_cache is None:
            self._load_cache = pickle.loads(
                self._call(KIND_WAL_LOAD, b"", timeout=120.0))
        return self._load_cache

    def append(self, data: bytes) -> None:
        self._load_cache = None
        if self._call(KIND_WAL_APPEND, data) != b"ok":
            raise IOError("WAL append not acknowledged")

    def read_log(self) -> bytes:
        return self._load()[1]

    def load_snapshot(self) -> Optional[bytes]:
        return self._load()[0]

    def install_snapshot(self, blob: bytes) -> None:
        self._load_cache = None
        if self._call(KIND_WAL_SNAPSHOT, blob, timeout=120.0) != b"ok":
            raise IOError("WAL snapshot not acknowledged")


def backend_from_url(url: str, default_log: str,
                     default_snapshot: str) -> WalBackend:
    """``logd://host:port`` → remote; empty → local files. An unknown
    scheme raises — silently downgrading durability on a typo would be
    discovered only when the head machine is lost."""
    if url:
        if url.startswith("logd://"):
            return RemoteWalBackend(url[len("logd://"):])
        raise ValueError(
            f"Unknown RAY_TPU_GCS_WAL_URL scheme: {url!r} "
            f"(supported: logd://host:port)")
    return FileWalBackend(default_log, default_snapshot)


def main(argv=None):  # pragma: no cover — subprocess entry
    parser = argparse.ArgumentParser(
        description="standalone GCS WAL log server")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = WalLogServer(args.dir, host=args.host, port=args.port)
    print(f"WAL_LOG_SERVER_ADDRESS={server.address}", flush=True)
    threading.Event().wait()


if __name__ == "__main__":  # pragma: no cover
    main()
