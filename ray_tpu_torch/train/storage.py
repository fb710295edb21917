"""Checkpoint storage and async writes (port of
``ray_tpu/train/storage.py``).

Reference: ``train/_internal/storage.py:358`` (``StorageContext``) and the
orbax-style async checkpointing the reference reaches through Train's
checkpoint upload path: the device→host snapshot is taken synchronously
(so the saved state is consistent even if training mutates it
immediately after), while serialization and the filesystem write happen
on a background thread that the trainer only joins at the next save or
at shutdown.

The JAX package resolves a storage URI through ``pyarrow.fs`` (local,
``s3://``, ``gs://``). The port's hosts have no pyarrow, so its
:class:`StorageContext` takes a plain path or a ``file://`` URI; any
other scheme raises ``not_ported``.
"""

from __future__ import annotations

import os
import pickle
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.train.checkpoint import _flatten

_URI_SEP = "://"
_REMOTE_ITEM = ("a storage item not queued yet (remote file systems need "
                "pyarrow, which the port's hosts lack)")


def local_path(storage_path: str) -> str:
    """The local directory a plain path or a ``file://`` URI names; any
    other URI scheme raises ``not_ported``."""
    if _URI_SEP not in storage_path:
        return os.path.abspath(storage_path)
    scheme, _, rest = storage_path.partition(_URI_SEP)
    if scheme != "file":
        from ray_tpu_torch.models.llama import not_ported

        raise not_ported(f"storage URIs of scheme {scheme!r}",
                         _REMOTE_ITEM)
    return os.path.abspath(rest)


class StorageContext:
    """An experiment's storage root on the local file system.

    ``storage_path`` may be a plain local path or a ``file://`` URI;
    uploads and downloads copy directories under
    ``<root>/<experiment_name>``."""

    def __init__(self, storage_path: str, experiment_name: str):
        self.storage_path = storage_path
        self.experiment_dir = os.path.join(local_path(storage_path),
                                           experiment_name)
        os.makedirs(self.experiment_dir, exist_ok=True)

    def join(self, *parts: str) -> str:
        return os.path.join(self.experiment_dir, *parts)

    def upload_dir(self, local_dir: str, remote_rel: str) -> str:
        """Recursively copy ``local_dir`` under the experiment dir; returns
        the storage path of the uploaded directory."""
        dest = self.join(remote_rel)
        shutil.copytree(local_dir, dest, dirs_exist_ok=True)
        return dest

    def download_dir(self, remote_path: str, local_dir: str) -> str:
        """Copy a stored directory back to ``local_dir``."""
        shutil.copytree(remote_path, local_dir, dirs_exist_ok=True)
        return local_dir

    def delete_dir(self, remote_path: str) -> None:
        shutil.rmtree(remote_path, ignore_errors=True)

    def exists(self, remote_path: str) -> bool:
        return os.path.exists(remote_path)


class AsyncCheckpointer:
    """Orbax-style async checkpoint writer.

    ``save()`` snapshots tensors to host memory *synchronously* (the part
    that must be consistent with the training step), then hands
    serialization + the write to a single background thread. A new save
    first waits for the previous one — at most one write is ever in
    flight, matching orbax AsyncCheckpointer semantics — so checkpoints
    can never interleave on disk. The files are :func:`~ray_tpu_torch.
    train.checkpoint.save_pytree`'s.
    """

    def __init__(self, storage: Optional[StorageContext] = None):
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="async-ckpt")
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()
        self.storage = storage

    def save(self, tree: Any, directory: str, name: str = "state",
             upload_rel: Optional[str] = None) -> Future:
        """Snapshot now, write later. Returns the write's Future (resolves
        to the checkpoint directory, or the storage path if uploaded)."""
        self.wait()  # one write in flight, in order
        # Snapshot point: _flatten COPIES every leaf to the host (a view
        # would let in-place mutation after save() corrupt the
        # checkpoint the background thread is still serializing).
        flat: List[Tuple[str, str, np.ndarray]] = []
        treedef = _flatten(tree, flat)

        def write() -> str:
            os.makedirs(directory, exist_ok=True)
            tmp = os.path.join(directory, f".{name}.npz.tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **{str(i): a for i, (_, _, a) in
                               enumerate(flat)})
            os.replace(tmp, os.path.join(directory, f"{name}.npz"))
            with open(os.path.join(directory,
                                   f"{name}.treedef.pkl"), "wb") as f:
                pickle.dump((treedef, [(k, d) for k, d, _ in flat]), f)
            if self.storage is not None and upload_rel is not None:
                return self.storage.upload_dir(directory, upload_rel)
            return directory

        fut = self._executor.submit(write)
        with self._lock:
            self._pending = fut
        return fut

    def wait(self) -> None:
        """Block until the in-flight write (if any) completes; re-raises
        its error so a failed persist is never silent."""
        with self._lock:
            fut = self._pending
            self._pending = None
        if fut is not None:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._executor.shutdown(wait=True)
