"""Checkpoint: directory-backed training state (port of
``ray_tpu/train/checkpoint.py``; reference: ``train/_checkpoint.py:56``).

A ``Checkpoint`` is a handle to a directory (``from_directory``/
``to_directory``/``as_directory`` mirror the reference API at
``train/_checkpoint.py:179,190,234``). :func:`save_pytree` and
:func:`load_pytree` save and restore a tree of dicts, lists and tuples
whose leaves are torch tensors, numpy arrays or numbers: the leaves go
to one ``.npz`` (a bf16 tensor as its raw 16-bit words, since numpy has
no bf16) and the structure, with each leaf's kind and dtype, to a
pickle this module wrote. A DTensor leaf is saved whole
(``full_tensor``); the caller re-shards it on restore. A restored tensor
is on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    # -- accessors ---------------------------------------------------------
    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            return self.path
        path = os.path.abspath(path)
        if path != self.path:
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, "metadata.json"), "w") as f:
            json.dump(metadata, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, "metadata.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"


def _flatten(tree, leaves: List[Tuple[str, str, np.ndarray]]):
    """The tree's structure with each leaf replaced by its index into
    ``leaves``, which gains ``(kind, dtype name, host array)``."""
    if isinstance(tree, dict):
        return ("dict", [(k, _flatten(v, leaves)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return ("list" if isinstance(tree, list) else "tuple",
                [_flatten(v, leaves) for v in tree])
    if isinstance(tree, torch.Tensor):
        t = tree.full_tensor() if hasattr(tree, "full_tensor") else tree
        t = t.detach().cpu()
        dtype = str(t.dtype).replace("torch.", "")
        arr = (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
               else t.numpy()).copy()
        leaves.append(("torch", dtype, arr))
    else:
        arr = np.array(tree)
        leaves.append(("numpy", str(arr.dtype), arr))
    return ("leaf", len(leaves) - 1)


def _unflatten(node, leaves: List[Any]):
    kind, body = node
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in body}
    if kind in ("list", "tuple"):
        out = [_unflatten(v, leaves) for v in body]
        return out if kind == "list" else tuple(out)
    return leaves[body]


def save_pytree(tree: Any, directory: str, name: str = "state") -> None:
    """Save a tree: leaves to ``<name>.npz``, structure to
    ``<name>.treedef.pkl``."""
    os.makedirs(directory, exist_ok=True)
    flat: List[Tuple[str, str, np.ndarray]] = []
    treedef = _flatten(tree, flat)
    np.savez(os.path.join(directory, f"{name}.npz"),
             **{str(i): a for i, (_, _, a) in enumerate(flat)})
    with open(os.path.join(directory, f"{name}.treedef.pkl"), "wb") as f:
        pickle.dump((treedef, [(k, d) for k, d, _ in flat]), f)


def load_pytree(directory: str, name: str = "state") -> Any:
    """The tree :func:`save_pytree` wrote: torch leaves as CPU tensors of
    their dtype, the others as numpy arrays."""
    with open(os.path.join(directory, f"{name}.treedef.pkl"), "rb") as f:
        treedef, kinds = pickle.load(f)
    data = np.load(os.path.join(directory, f"{name}.npz"))
    leaves = []
    for i, (kind, dtype) in enumerate(kinds):
        arr = data[str(i)]
        if kind == "torch":
            t = torch.from_numpy(arr)
            leaves.append(t.view(torch.bfloat16) if dtype == "bfloat16"
                          else t)
        else:
            leaves.append(arr)
    return _unflatten(treedef, leaves)


class CheckpointManager:
    """Top-k checkpoint retention (reference: ``_internal/checkpoint_manager.py``).

    ``async_write=True`` moves the copy-to-root (and the optional
    ``storage`` upload — a :class:`~ray_tpu_torch.train.storage.StorageContext`)
    onto a background thread, orbax-style: at most one persist in flight,
    and :meth:`flush` joins it before anyone reads ``latest``/``best``.
    """

    def __init__(self, root: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max", async_write: bool = False,
                 storage=None):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self.storage = storage
        self._ckpts: list = []  # (score, path, metrics)
        self._executor = None
        self._pending = None
        if async_write:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-persist")

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict[str, Any]] = None) -> Checkpoint:
        metrics = metrics or {}
        dest = os.path.join(self.root, f"checkpoint_{uuid.uuid4().hex[:8]}")
        # The local copy is ALWAYS synchronous: callers may reuse/mutate
        # the source directory right after register(), so a background
        # copy would capture mixed state. Async mode offloads only the
        # storage upload — the slow leg — which reads the stable `dest`.
        checkpoint.to_directory(dest)

        def persist():
            if self.storage is not None:
                self.storage.upload_dir(dest, os.path.basename(dest))
            return dest

        if self._executor is not None:
            self.flush()  # one persist in flight, in submission order
            if self.storage is not None:
                self._pending = (self._executor.submit(persist), dest)
        else:
            persist()
        persisted = Checkpoint(dest)
        score = metrics.get(self.score_attribute) if self.score_attribute else None
        self._ckpts.append((score, persisted, metrics))
        self._evict()
        return persisted

    def flush(self) -> None:
        """Join the in-flight async persist. A failed persist is dropped
        from the retention list (its directory never completed) before the
        error re-raises, so ``latest``/``best`` can't hand out a
        half-written checkpoint."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        fut, dest = pending
        try:
            fut.result()
        except Exception:
            self._ckpts = [c for c in self._ckpts if c[1].path != dest]
            raise

    def close(self) -> None:
        """Join outstanding persists and release the worker thread."""
        try:
            self.flush()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def _evict(self):
        if self.num_to_keep is None or len(self._ckpts) <= self.num_to_keep:
            return
        if self.score_attribute:
            reverse = self.score_order == "max"
            ordered = sorted(
                self._ckpts,
                key=lambda t: (t[0] is not None, t[0]),
                reverse=reverse,
            )
        else:
            ordered = list(self._ckpts)  # FIFO: oldest evicted first
            ordered.reverse()
        keep = ordered[: self.num_to_keep] if self.score_attribute else \
            self._ckpts[-self.num_to_keep:]
        drop = [c for c in self._ckpts if not any(c[1] is k[1] for k in keep)]
        # Flush only when a dropped directory is the one still being
        # persisted (possible with score-based eviction); the common FIFO
        # case keeps async writes actually asynchronous.
        if self._pending is not None and any(
                c[1].path == self._pending[1] for c in drop):
            self.flush()
        for _, ckpt, _ in drop:
            shutil.rmtree(ckpt.path, ignore_errors=True)
            if self.storage is not None:
                # num_to_keep governs the mirror too, or remote usage
                # grows without bound.
                try:
                    self.storage.delete_dir(self.storage.join(
                        os.path.basename(ckpt.path)))
                except Exception:  # noqa: BLE001 — best-effort prune
                    pass
        self._ckpts = [c for c in self._ckpts if any(c[1] is k[1] for k in keep)]

    @property
    def latest(self) -> Optional[Checkpoint]:
        return self._ckpts[-1][1] if self._ckpts else None

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self._ckpts:
            return None
        if not self.score_attribute:
            return self.latest
        scored = [c for c in self._ckpts if c[0] is not None]
        if not scored:
            return self.latest
        pick = max if self.score_order == "max" else min
        return pick(scored, key=lambda t: t[0])[1]
