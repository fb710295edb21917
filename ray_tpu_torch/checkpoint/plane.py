"""Checkpoint plane (port of ``ray_tpu/checkpoint/plane.py``): async
sharded save, two-phase commit, restore onto any layout.

The on-disk format is the JAX package's, file for file: each
participant writes ``<root>/<run>/step-%010d/shard-%05d-of-%05d.npz``,
raw ``uint8`` payloads, with a ``.json`` spec holding each entry's
shape, its leaf's dtype name and shape, its index into the leaf and the
crc32 of the exact ``.npz`` bytes; the last arrival commits
``MANIFEST.json``. Coordination records live under the ``__ckpt__`` key
scheme (``<run>@<dirhash>/<step>/shard/<nprocs>/<proc>``, then
``.../MANIFEST``) of a small KV (:func:`as_kv`): None is the filesystem
alone (commit atomicity from ``os.link``), a dict serves one process and
a ``torch.distributed`` store (``TCPStore``) serves ranks, where one
``compare_set`` picks the commit's one winner.

* **async snapshot**: :meth:`CheckpointPlane.save_async` copies this
  process's shards to host memory before it returns (the train step
  updates params and moments in place, so a copy still in flight would
  save a torn state) and hands serialization and the write to a
  background thread; its wall time is ``SaveHandle.blocked_ms``.
* **which shards**: a DTensor leaf writes this rank's local shard with
  its global offset (``torch.chunk``'s split, nested over mesh dims);
  only the rank at coordinate 0 of every mesh dim the leaf is
  replicated on writes it (JAX's ``replica_id == 0``), and a Partial
  leaf raises. A plain tensor is one full-array shard.
* **integrity and fallback**: restore verifies each shard's crc32
  before reading it and, for the newest step, falls back to the
  previous committed manifest on a corrupt one; an explicit step raises.
* **restore onto another layout**: every leaf is assembled whole on the
  host, as raw bytes into a tensor of its named dtype (no ``ml_dtypes``
  for bf16), and ``target`` places it (``ShardedTrainer.restore_state``
  distributes it by the trainer's placements: JAX's ``device_put`` of a
  full host array).

The tree: JAX writes ``state.treedef.pkl``, a pickled JAX treedef. The
port writes ``state.tree.json``, the key path of every leaf in the
files' order, beside the same files. A step the JAX package wrote has no
such file: its leaves are read by order against a known layout, the
``paths`` argument (:func:`train_state_paths` for a ``TrainState``).
A ``TrainState``'s leaves go in the JAX ``TrainState``'s order
(:func:`train_state_paths`), so both packages' files line up leaf for
leaf.

A save records JAX's ``CKPT_BLOCK_MS``, ``CKPT_SAVE_SECONDS``,
``CKPT_BYTES`` and ``CKPT_SAVES`` and a restore ``CKPT_RESTORE_SECONDS``
and ``CKPT_BYTES``, tagged with the run; the records
(``SaveHandle.blocked_ms``, the persist record, ``last_restore``) keep
the numbers too. Not here yet: goodput's attribution of the blocked and
restore time (``train/goodput.py``) and the preemption plane
(``preempt.py``), both with the trainer controller, and the chaos sites
(tests monkeypatch ``_write_shard_files``).
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import shutil
import threading
import time
import zipfile
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.exceptions import CheckpointCorruptError
from ray_tpu_torch.models.paged_kv import _STAGING_DTYPES

logger = logging.getLogger(__name__)

# Reserved-by-convention KV namespace for checkpoint coordination records.
CKPT_KV_NS = "__ckpt__"
_STEP_RE = re.compile(r"^step-(\d+)$")
TREE_FILE = "state.tree.json"

# Errors that mean a committed step's data cannot be trusted or read:
# crc32 mismatch, truncated/missing shard files, undecodable spec/npz/
# tree. Restore paths fall back past them.
_CORRUPTION_ERRORS = (CheckpointCorruptError, OSError, ValueError,
                      KeyError, EOFError, zipfile.BadZipFile)

# Leaf dtypes by the name numpy (with ml_dtypes, as JAX writes it) gives
# them: the staging table of the KV handoff, and the integer and bool
# leaves a state holds.
_DTYPES = {**_STAGING_DTYPES, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64,
           "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


# ------------------------------------------------------------------- KV
class DictKV:
    """The KV of one process: a dict behind a lock."""

    def __init__(self, data: Optional[dict] = None):
        self._data = {} if data is None else data
        self._lock = threading.Lock()

    def put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        """Set ``key``; with ``overwrite=False`` only if it is absent.
        True when this call set it."""
        with self._lock:
            if not overwrite and key in self._data:
                return False
            self._data[key] = bytes(value)
            return True

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def list(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


class StoreKV:
    """The KV over a ``torch.distributed`` store (``TCPStore``) shared
    by ranks, its keys under ``namespace/``. ``put(overwrite=False)`` is
    one ``compare_set`` against an absent key, which exactly one caller
    wins."""

    def __init__(self, store, namespace: str = CKPT_KV_NS):
        self._store = store
        self._ns = namespace + "/"

    def put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        full, value = self._ns + key, bytes(value)
        if overwrite:
            self._store.set(full, value)
            return True
        # The value stored after the call: ours if the key was absent.
        # Payloads are unique (they carry the writer), so equality names
        # the winner.
        return bytes(self._store.compare_set(full, b"", value)) == value

    def get(self, key: str) -> Optional[bytes]:
        full = self._ns + key
        if not self._store.check([full]):
            return None
        return bytes(self._store.get(full))

    def list(self, prefix: str) -> List[str]:
        n = len(self._ns)
        return sorted(k[n:] for k in self._store.list_keys()
                      if k.startswith(self._ns + prefix))

    def delete(self, key: str) -> None:
        self._store.delete_key(self._ns + key)


def as_kv(kv):
    """The plane's KV: None (filesystem mode), a dict (one process), a
    ``torch.distributed.Store`` (ranks), or an object with ``put``,
    ``get``, ``list`` and ``delete``."""
    if kv is None or all(hasattr(kv, m) for m in ("put", "get", "list",
                                                  "delete")):
        return kv
    if isinstance(kv, dict):
        return DictKV(kv)
    if isinstance(kv, dist.Store):
        return StoreKV(kv)
    raise TypeError(f"not a checkpoint KV: {type(kv).__name__}")


# ------------------------------------------------------------- the tree
def sorted_key_paths(tree, prefix=()) -> List[Tuple[str, ...]]:
    """Key paths of a dict tree's leaves in JAX's order (keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in sorted_key_paths(tree[k], prefix + (k,))]
    return [prefix]


def at_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def train_state_paths(param_paths: Sequence[Sequence[str]]
                      ) -> List[Tuple[str, ...]]:
    """Key paths of a ``TrainState``'s leaves in the order the JAX
    package flattens its ``TrainState`` (and writes them): ``step``, the
    params in sorted-key order, then ``default_optimizer``'s optax state
    (``chain(clip_by_global_norm, adamw(schedule))``: the clip's and
    the weight decay's empty states hold no leaf): Adam's ``count``,
    ``mu`` and ``nu`` (params in the same order), the schedule's
    ``count``. ``param_paths``: the params' key paths, any order."""
    params = sorted(tuple(p) for p in param_paths)
    return ([("step",)] + [("params",) + p for p in params]
            + [("opt_state", "count")]
            + [("opt_state", "mu") + p for p in params]
            + [("opt_state", "nu") + p for p in params]
            + [("opt_state", "schedule_count")])


def key_paths(tree, prefix=()) -> List[Tuple[str, ...]]:
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in key_paths(v, prefix + (k,))]
    return [prefix]


def _is_train_state(state) -> bool:
    return all(hasattr(state, a) for a in ("step", "params", "opt_state"))


def flatten_state(state) -> Tuple[str, List[Tuple[Tuple[str, ...], Any]]]:
    """(kind, [(key path, leaf)]) of a ``TrainState`` ("TrainState", in
    :func:`train_state_paths`' order) or a dict tree ("tree", keys
    sorted)."""
    if _is_train_state(state):
        opt = state.opt_state
        order = key_paths(state.params)
        mu = dict(zip(order, opt.mu))
        nu = dict(zip(order, opt.nu))
        leaves = []
        for path in train_state_paths(order):
            if path == ("step",):
                leaf = np.int32(state.step)
            elif path[0] == "params":
                leaf = at_path(state.params, path[1:])
            elif path[1] in ("count", "schedule_count"):
                leaf = np.int32(opt.count)
            else:
                leaf = (mu if path[1] == "mu" else nu)[path[2:]]
            leaves.append((path, leaf))
        return "TrainState", leaves
    if isinstance(state, dict):
        return "tree", [(p, at_path(state, p))
                        for p in sorted_key_paths(state)]
    raise TypeError(f"a checkpoint state is a TrainState or a dict tree, "
                    f"got {type(state).__name__}")


def unflatten_state(kind: str, paths: Sequence[Sequence[str]],
                    leaves: Sequence[torch.Tensor]):
    """The state :func:`flatten_state` flattened: nested dicts for
    "tree", and for "TrainState" a ``training.TrainState`` whose params
    are in sorted-key order, with its moments in the same order."""
    paths = [tuple(p) for p in paths]
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    if kind == "tree":
        return tree
    if kind != "TrainState":
        raise ValueError(f"unknown checkpoint tree kind {kind!r}")
    from ray_tpu_torch.models.training import OptState, TrainState

    opt = tree["opt_state"]
    if int(opt["count"]) != int(opt["schedule_count"]):
        raise ValueError(f"Adam's count {int(opt['count'])} and the "
                         f"schedule's {int(opt['schedule_count'])} differ")
    order = sorted_key_paths(tree["params"])
    return TrainState(
        step=int(tree["step"]), params=tree["params"],
        opt_state=OptState(count=int(opt["count"]),
                           mu=[at_path(opt["mu"], p) for p in order],
                           nu=[at_path(opt["nu"], p) for p in order]))


# --------------------------------------------------------------- shards
def _index_to_json(index: Sequence[slice], shape: Sequence[int]
                   ) -> List[List[int]]:
    return [[0 if sl.start is None else int(sl.start),
             dim if sl.stop is None else int(sl.stop)]
            for sl, dim in zip(index, shape)]


def _json_to_index(entry) -> Tuple[slice, ...]:
    return tuple(slice(int(a), int(b)) for a, b in entry)


def _local_index(t: DTensor) -> Tuple[slice, ...]:
    """The global slice of each dim that this rank's shard of ``t``
    holds: ``torch.chunk``'s split of the dim, nested over the mesh dims
    that split it in mesh order (DTensor's ``Shard``)."""
    mesh = t.device_mesh
    coord = mesh.get_coordinate()
    bounds = [[0, n] for n in t.shape]
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard):
            lo, hi = bounds[p.dim]
            step = -(-(hi - lo) // mesh.size(m))
            start = min(lo + coord[m] * step, hi)
            bounds[p.dim] = [start, min(start + step, hi)]
    return tuple(slice(lo, hi) for lo, hi in bounds)


def _host_shards(leaf) -> Tuple[List[int], str,
                                 List[Tuple[Tuple[slice, ...],
                                            torch.Tensor]]]:
    """(shape, dtype name, this process's owned shards as host
    tensors). The copies are complete when this returns (a CPU leaf is
    copied too: the step overwrites it in place). A DTensor leaf
    yields its local shard if this rank is at coordinate 0 of every mesh
    dim it is replicated on, else nothing."""
    if isinstance(leaf, DTensor):
        if any(p.is_partial() for p in leaf.placements):
            raise ValueError(f"cannot save a Partial leaf "
                             f"({leaf.placements}); redistribute it first")
        coord = leaf.device_mesh.get_coordinate()
        owner = all(isinstance(p, Shard) or c == 0
                    for p, c in zip(leaf.placements, coord))
        shards = []
        if owner:
            shards.append((_local_index(leaf),
                           leaf.to_local().detach().to("cpu", copy=True)))
        return list(leaf.shape), _NAMES[leaf.dtype], shards
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.array(leaf))
    host = leaf.detach().to("cpu", copy=True)
    return (list(host.shape), _NAMES[host.dtype],
            [(tuple(slice(None) for _ in host.shape), host)])


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a flat uint8 array (no copy)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


class SaveHandle:
    """Handle to one in-flight async save. ``blocked_ms`` is the wall time
    the caller's step loop was blocked (the device-to-host snapshot)."""

    def __init__(self, step: int, blocked_ms: float, future: Future):
        self.step = step
        self.blocked_ms = blocked_ms
        self._future = future

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Join the background persist; returns this participant's record
        (``committed`` True when a manifest exists for the step; ``bytes``,
        ``save_s`` from the snapshot to the commit attempt, ``crc_s``)."""
        return self._future.result(timeout)


def _default_topology() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointPlane:
    """One run's checkpoint stream: ``<root>/<run>/step-<n>/`` directories
    coordinated through the ``__ckpt__`` KV namespace.

    ``process_index``/``process_count`` identify this participant in the
    two-phase commit; they default to the default process group's rank
    and world size (0 and 1 without one). ``kv``: see :func:`as_kv`;
    every participant of a run must use the same one."""

    def __init__(self, root: str, run: str = "train", *,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 keep: Optional[int] = None, kv=None):
        if "/" in run:
            raise ValueError(f"run name must not contain '/': {run!r}")
        self.root = os.path.abspath(root)
        self.run = run
        if process_index is None or process_count is None:
            process_index, process_count = _default_topology()
        self.process_index = int(process_index)
        self.process_count = max(int(process_count), 1)
        self.keep = keep
        self._kv = as_kv(kv)
        # KV records are scoped by the run's filesystem location (crc32 of
        # the absolute run_dir in the key's run segment): runs that share
        # a run NAME must not see each other's registrations or
        # manifests. Participants of one run share its storage path, so
        # they agree on the scope.
        self._kv_run = (f"{run}@"
                        f"{zlib.crc32(self.run_dir.encode()):08x}")
        self._mtags = {"run": run}
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: Optional[SaveHandle] = None
        self._lock = threading.Lock()
        self._closed = False
        # The newest restore's numbers (step, bytes, seconds, crc_s).
        self.last_restore: Dict[str, Any] = {}
        os.makedirs(self.run_dir, exist_ok=True)

    # ------------------------------------------------------------ layout
    @property
    def run_dir(self) -> str:
        return os.path.join(self.root, self.run)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.run_dir, f"step-{int(step):010d}")

    def _shard_stem(self) -> str:
        return (f"shard-{self.process_index:05d}"
                f"-of-{self.process_count:05d}")

    def _kv_key(self, step: int, suffix: str) -> str:
        return f"{self._kv_run}/{int(step):010d}/{suffix}"

    # -------------------------------------------------------------- save
    def save(self, step: int, state: Any) -> Dict[str, Any]:
        """Synchronous save: snapshot + write + commit attempt, joined."""
        return self.save_async(step, state).result()

    def save_async(self, step: int, state: Any) -> SaveHandle:
        """Snapshot now, persist in the background (one write in flight).

        ``state``: a ``TrainState`` or a dict tree of tensors (DTensors
        included), numpy arrays and numbers. The
        returned handle resolves to this participant's record once the
        shard file is durable and the commit attempt ran."""
        if self._closed:
            raise RuntimeError("CheckpointPlane is closed")
        self.flush()  # one persist in flight, in submission order
        t0 = time.perf_counter()
        kind, flat = flatten_state(state)
        spec_leaves, shard_sets = [], []
        for _, leaf in flat:
            shape, dtype, shards = _host_shards(leaf)
            spec_leaves.append({"shape": shape, "dtype": dtype})
            shard_sets.append(shards)
        blocked_ms = (time.perf_counter() - t0) * 1000.0
        mdefs.CKPT_BLOCK_MS.observe(blocked_ms, tags=self._mtags)
        tree = {"kind": kind, "paths": [list(p) for p, _ in flat]}
        future = self._executor.submit(
            self._persist, int(step), tree, spec_leaves, shard_sets, t0)
        handle = SaveHandle(int(step), blocked_ms, future)
        with self._lock:
            self._pending = handle
        return handle

    def flush(self) -> None:
        """Join the in-flight persist (re-raising its error)."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._closed = True
            self._executor.shutdown(wait=True)

    # The file write, separated so tests can instrument (delay/fail) the
    # background leg without touching the snapshot path.
    def _write_shard_files(self, d: str, spec: Dict[str, Any],
                           entries: Dict[str, np.ndarray]) -> None:
        stem = self._shard_stem()
        tmp_npz = os.path.join(d, f".{stem}.npz.tmp")
        # Serialize to memory first: the crc covers the exact bytes
        # renamed into place (verified before any deserialization)
        # without re-reading the file.
        buf = io.BytesIO()
        np.savez(buf, **entries)
        payload = buf.getbuffer()
        t0 = time.perf_counter()
        spec["crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
        spec["crc_s"] = time.perf_counter() - t0
        with open(tmp_npz, "wb") as f:
            f.write(payload)
        del payload
        npz_path = os.path.join(d, f"{stem}.npz")
        os.replace(tmp_npz, npz_path)
        tmp_spec = os.path.join(d, f".{stem}.json.tmp")
        with open(tmp_spec, "w") as f:
            json.dump(spec, f)
        os.replace(tmp_spec, os.path.join(d, f"{stem}.json"))

    def _persist(self, step: int, tree, spec_leaves, shard_sets,
                 t_start: float) -> Dict[str, Any]:
        try:
            out = self._persist_step(step, tree, spec_leaves, shard_sets,
                                     t_start)
        except BaseException:
            mdefs.CKPT_SAVES.inc(tags={**self._mtags, "outcome": "failed"})
            raise
        mdefs.CKPT_SAVE_SECONDS.observe(out["save_s"], tags=self._mtags)
        mdefs.CKPT_BYTES.inc(out["bytes"], tags={**self._mtags,
                                                 "direction": "save"})
        mdefs.CKPT_SAVES.inc(tags={**self._mtags, "outcome":
                                   "committed" if out["committed"]
                                   else "registered"})
        return out

    def _persist_step(self, step: int, tree, spec_leaves, shard_sets,
                      t_start: float) -> Dict[str, Any]:
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        # Every process writes the tree (identical bytes; atomic replace
        # makes the race harmless) so restore never depends on which
        # participant survived.
        tree_path = os.path.join(d, TREE_FILE)
        tmp = tree_path + f".tmp{self.process_index}"
        with open(tmp, "w") as f:
            json.dump(tree, f)
        os.replace(tmp, tree_path)

        entries: Dict[str, np.ndarray] = {}
        spec_entries: List[Dict[str, Any]] = []
        total = 0
        for li, recs in enumerate(shard_sets):
            shape = spec_leaves[li]["shape"]
            for index, arr in recs:
                key = f"e{len(spec_entries)}"
                raw = _raw(arr)
                entries[key] = raw
                total += raw.nbytes
                spec_entries.append({
                    "key": key, "leaf": li,
                    "index": _index_to_json(index, shape),
                    "shape": list(arr.shape)})
        spec = {"run": self.run, "step": step,
                "process_index": self.process_index,
                "process_count": self.process_count,
                "leaves": spec_leaves, "entries": spec_entries,
                "bytes": total, "ts": time.time()}
        self._write_shard_files(d, spec, entries)
        committed = self._register_and_maybe_commit(step, spec)
        return {"step": step, "dir": d, "bytes": total,
                "shard": self._shard_stem(), "committed": committed,
                "save_s": time.perf_counter() - t_start,
                "crc_s": spec.get("crc_s", 0.0)}

    # ------------------------------------------------------------ commit
    def _register_and_maybe_commit(self, step: int,
                                   spec: Dict[str, Any]) -> bool:
        d = self.step_dir(step)
        record = {"proc": self.process_index,
                  "nprocs": self.process_count,
                  "file": f"{self._shard_stem()}.npz",
                  "spec": f"{self._shard_stem()}.json",
                  "bytes": spec["bytes"], "dir": d, "ts": time.time()}
        # Registrations (and the quorum below) are scoped by topology:
        # a restart re-saving this step at another world size must not
        # count a dead attempt's straggler shards.
        if self._kv is not None:
            self._kv.put(
                self._kv_key(step, f"shard/{self.process_count:05d}"
                                   f"/{self.process_index:05d}"),
                json.dumps(record).encode(), overwrite=True)
            present = self._kv.list(
                self._kv_key(step, f"shard/{self.process_count:05d}/"))
        else:
            present = [f for f in os.listdir(d)
                       if f.startswith("shard-") and
                       f.endswith(f"-of-{self.process_count:05d}.json")]
        if len(present) < self.process_count:
            return False  # not the last arrival; a peer commits
        return self._commit_manifest(step)

    def _commit_manifest(self, step: int) -> bool:
        """Flip the atomic MANIFEST record for a fully-registered step.
        Exactly one participant wins; everyone returns True once a
        manifest exists."""
        d = self.step_dir(step)
        shard_specs = sorted(
            f for f in os.listdir(d)
            if f.startswith("shard-") and
            f.endswith(f"-of-{self.process_count:05d}.json"))
        nbytes = 0
        for s in shard_specs:
            with open(os.path.join(d, s)) as f:
                nbytes += json.load(f).get("bytes", 0)
        manifest = {
            "run": self.run, "step": step, "dir": d,
            "nprocs": self.process_count,
            "shards": [s[:-len(".json")] + ".npz" for s in shard_specs],
            "bytes": nbytes, "ts": time.time(),
            "committed_by": self.process_index,
        }
        payload = json.dumps(manifest).encode()
        path = os.path.join(d, "MANIFEST.json")
        tmp = path + f".tmp{self.process_index}"
        if self._kv is not None:
            if self._kv.put(self._kv_key(step, "MANIFEST"), payload,
                            overwrite=False):
                # Mirror to the filesystem for offline readers.
                with open(tmp, "wb") as f:
                    f.write(payload)
                os.replace(tmp, path)
            return True
        # Pure-filesystem commit: os.link is atomic-exclusive for a
        # fully-written file: the loser's link fails.
        with open(tmp, "wb") as f:
            f.write(payload)
        try:
            os.link(tmp, path)
        except FileExistsError:
            pass
        finally:
            os.unlink(tmp)
        return True

    # ----------------------------------------------------------- reading
    def steps(self) -> List[int]:
        """Committed steps, ascending (KV manifests and on-disk
        manifests: restore must survive a wiped KV)."""
        found = set()
        if self._kv is not None:
            for key in self._kv.list(f"{self._kv_run}/"):
                parts = key.split("/")
                if len(parts) == 3 and parts[2] == "MANIFEST":
                    found.add(int(parts[1]))
        for name in _safe_ls(self.run_dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.run_dir, name,
                                                 "MANIFEST.json")):
                found.add(int(m.group(1)))
        return sorted(found)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict[str, Any]:
        if self._kv is not None:
            raw = self._kv.get(self._kv_key(step, "MANIFEST"))
            if raw:
                return json.loads(raw)
        with open(os.path.join(self.step_dir(step), "MANIFEST.json")) as f:
            return json.load(f)

    def restore(self, target: Optional[Callable] = None,
                step: Optional[int] = None,
                paths: Optional[Sequence[Sequence[str]]] = None) -> Any:
        """Reassemble a state from a committed manifest.

        ``target(path, tensor)`` places each assembled host leaf (the
        port's stand-in for JAX's tree of shardings); None keeps host
        tensors. ``step`` defaults to the newest committed step, and then
        a step whose shards fail verification is skipped (logged) for
        the previous committed manifest; an explicit step raises.
        ``paths``: the leaves' key paths for a step with no tree file
        (the JAX package's; :func:`train_state_paths` reads a
        ``TrainState`` as one). The numbers land in ``last_restore``."""
        t0 = time.perf_counter()
        if step is not None:
            candidates = [int(step)]
        else:
            candidates = list(reversed(self.steps()))
            if not candidates:
                raise FileNotFoundError(
                    f"no committed checkpoint for run {self.run!r} "
                    f"under {self.run_dir}")
        found = None
        last_err: Optional[BaseException] = None
        for cand in candidates:
            try:
                manifest = self.manifest(cand)
                d = manifest.get("dir") or self.step_dir(cand)
                if not os.path.isdir(d):
                    d = self.step_dir(cand)
                found = (cand, _assemble(d, manifest, paths))
                break
            except _CORRUPTION_ERRORS as e:
                last_err = e
                if cand != candidates[-1]:
                    logger.warning(
                        "checkpoint step %d of run %r failed integrity "
                        "verification (%s); falling back to the previous "
                        "committed manifest", cand, self.run, e)
        if found is None:
            if len(candidates) == 1:
                raise last_err
            raise CheckpointCorruptError(
                f"every committed checkpoint of run {self.run!r} failed "
                f"integrity verification (steps {candidates}); last "
                f"error: {last_err}") from last_err
        step, (kind, leaf_paths, leaves, crc_s) = found
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        if target is not None:
            leaves = [target(tuple(p), t) for p, t in zip(leaf_paths,
                                                           leaves)]
        seconds = time.perf_counter() - t0
        self.last_restore = {"step": step, "bytes": nbytes,
                             "seconds": seconds, "crc_s": crc_s}
        mdefs.CKPT_RESTORE_SECONDS.observe(seconds, tags=self._mtags)
        mdefs.CKPT_BYTES.inc(nbytes, tags={**self._mtags,
                                           "direction": "restore"})
        return unflatten_state(kind, leaf_paths, leaves)

    # ---------------------------------------------------------------- gc
    UNCOMMITTED_GRACE_S = 60.0

    def gc(self, keep: Optional[int] = None,
           grace_s: Optional[float] = None) -> List[str]:
        """Collect invisible (uncommitted, stale) step dirs and enforce
        ``keep``-newest retention on committed ones. Returns removed
        directories."""
        keep = keep if keep is not None else self.keep
        grace = self.UNCOMMITTED_GRACE_S if grace_s is None else grace_s
        removed, committed = [], []
        now = time.time()
        with self._lock:
            pending = self._pending
        busy_step = pending.step if pending is not None and \
            not pending.done() else None
        committed_steps = set(self.steps())
        for name in _safe_ls(self.run_dir):
            m = _STEP_RE.match(name)
            if not m:
                continue
            step = int(m.group(1))
            d = os.path.join(self.run_dir, name)
            if os.path.exists(os.path.join(d, "MANIFEST.json")) or \
                    step in committed_steps:
                committed.append((step, d))
                continue
            if step == busy_step:
                continue
            if now - self._last_activity(step, d) > grace:
                removed.append(d)
        if keep is not None and len(committed) > keep:
            removed.extend(d for _, d in committed[:-keep])
        for d in removed:
            step = int(_STEP_RE.match(os.path.basename(d)).group(1))
            shutil.rmtree(d, ignore_errors=True)
            self._drop_kv_records(step)
        return removed

    def _last_activity(self, step: int, d: str) -> float:
        """Newest sign of life for an uncommitted step: file mtimes
        (growing .tmp shard writes update these, the dir's own mtime
        does not) and peers' KV shard registrations. gc() must not
        collect a step a straggler is still writing."""
        newest = 0.0
        try:
            newest = os.path.getmtime(d)
            for name in os.listdir(d):
                try:
                    newest = max(newest,
                                 os.path.getmtime(os.path.join(d, name)))
                except OSError:
                    continue
        except OSError:
            pass
        if self._kv is not None:
            for key in self._kv.list(self._kv_key(step, "shard/")):
                raw = self._kv.get(key)
                if raw:
                    newest = max(newest, float(json.loads(raw).get(
                        "ts", 0.0)))
        return newest

    def _drop_kv_records(self, step: int) -> None:
        if self._kv is None:
            return
        for key in self._kv.list(self._kv_key(step, "")):
            self._kv.delete(key)


def _assemble(d: str, manifest: Dict[str, Any],
              paths: Optional[Sequence[Sequence[str]]] = None):
    """(kind, key paths, full host tensors, crc seconds) from every shard
    file of a committed step."""
    tree_path = os.path.join(d, TREE_FILE)
    if os.path.exists(tree_path):
        with open(tree_path) as f:
            tree = json.load(f)
        kind, leaf_paths = tree["kind"], tree["paths"]
    elif paths is not None:
        kind = "TrainState" if paths and tuple(paths[0]) == ("step",) \
            else "tree"
        leaf_paths = [list(p) for p in paths]
    else:
        raise ValueError(
            f"checkpoint {d} has no {TREE_FILE} (the JAX package wrote "
            f"it): CheckpointPlane.restore reads it given the leaves' key "
            f"paths (paths=, train_state_paths for a TrainState)")
    shard_files = manifest.get("shards") or sorted(
        f for f in os.listdir(d)
        if f.startswith("shard-") and f.endswith(".npz"))
    buffers: List[Optional[torch.Tensor]] = []
    leaves_meta: Optional[List[Dict[str, Any]]] = None
    crc_s = 0.0
    for fname in shard_files:
        with open(os.path.join(d, fname[:-len(".npz")] + ".json")) as f:
            spec = json.load(f)
        # One read serves both the integrity check and deserialization.
        with open(os.path.join(d, fname), "rb") as f:
            raw = f.read()
        want_crc = spec.get("crc32")
        if want_crc is not None:
            t0 = time.perf_counter()
            got_crc = zlib.crc32(raw) & 0xFFFFFFFF
            crc_s += time.perf_counter() - t0
            if got_crc != int(want_crc):
                raise CheckpointCorruptError(
                    f"shard {fname} in {d}: crc32 {got_crc:#010x} != "
                    f"recorded {int(want_crc):#010x}")
        if leaves_meta is None:
            leaves_meta = spec["leaves"]
            buffers = [None] * len(leaves_meta)
        data = np.load(io.BytesIO(raw))
        for entry in spec["entries"]:
            li = entry["leaf"]
            meta = leaves_meta[li]
            dtype = _DTYPES[meta["dtype"]]
            if buffers[li] is None:
                buffers[li] = torch.empty(tuple(meta["shape"]),
                                          dtype=dtype)
            chunk = torch.from_numpy(data[entry["key"]]).view(
                dtype).reshape(tuple(entry["shape"]))
            buffers[li][_json_to_index(entry["index"])] = chunk
        del raw, data
    if leaves_meta is None:
        raise FileNotFoundError(f"no shard files in {d}")
    missing = [i for i, b in enumerate(buffers) if b is None]
    if missing:
        raise ValueError(
            f"checkpoint {d} is missing data for leaves {missing}")
    if len(leaf_paths) != len(buffers):
        raise ValueError(f"checkpoint {d} holds {len(buffers)} leaves, "
                         f"its tree names {len(leaf_paths)}")
    return kind, leaf_paths, buffers, crc_s


# --------------------------------------------------- standalone readers
def list_manifests_kv(kv) -> List[Dict[str, Any]]:
    """Committed checkpoint manifests in a KV's ``__ckpt__`` records
    (any run), newest first: uncommitted steps never appear here by
    construction. ``kv``: see :func:`as_kv` (not None)."""
    kv = as_kv(kv)
    out = []
    for key in kv.list(""):
        if not key.endswith("/MANIFEST"):
            continue
        raw = kv.get(key)
        if not raw:
            continue
        try:
            out.append(json.loads(raw))
        except ValueError:
            continue
    out.sort(key=lambda m: m.get("ts", 0), reverse=True)
    return out


def jax_leaf_paths(param_paths: Sequence[Sequence[str]],
                   n_leaves: int) -> List[Tuple[str, ...]]:
    """Key paths of a step the JAX package wrote (it keeps no tree file)
    for a model whose params have ``param_paths``: a ``TrainState``'s
    (:func:`train_state_paths`) or the bare params' (sorted), told apart
    by the step's number of leaves."""
    params = sorted(tuple(p) for p in param_paths)
    if n_leaves == len(params):
        return params
    paths = train_state_paths(params)
    if n_leaves == len(paths):
        return paths
    raise ValueError(
        f"a step of {n_leaves} leaves is neither these {len(params)} "
        f"params nor their TrainState ({len(paths)} leaves)")


def load_latest(root: str, run: Optional[str] = None,
                step: Optional[int] = None,
                param_paths: Optional[Sequence[Sequence[str]]] = None
                ) -> Any:
    """Filesystem-only restore: the newest committed manifest under
    ``root`` (one run's dir, or a root holding runs) as host tensors. A
    committed step whose shard data fails crc32 verification is skipped
    (logged) for the next-newest. ``param_paths`` (the model's param key
    paths) reads a step the JAX package wrote (:func:`jax_leaf_paths`)."""
    root = os.path.abspath(root)
    if run is not None:
        run_dirs = [os.path.join(root, run)]
    elif any(_STEP_RE.match(n) for n in _safe_ls(root)):
        run_dirs = [root]
    else:
        run_dirs = [os.path.join(root, n) for n in _safe_ls(root)
                    if os.path.isdir(os.path.join(root, n))]
    found: List[Tuple[int, float, str]] = []  # (step, manifest mtime, dir)
    for run_dir in run_dirs:
        for name in _safe_ls(run_dir):
            m = _STEP_RE.match(name)
            mpath = os.path.join(run_dir, name, "MANIFEST.json")
            if not m or not os.path.exists(mpath):
                continue
            s = int(m.group(1))
            if step is not None and s != step:
                continue
            found.append((s, os.path.getmtime(mpath),
                          os.path.join(run_dir, name)))
    if not found:
        raise FileNotFoundError(
            f"no committed checkpoint under {root!r}"
            + (f" for run {run!r}" if run else ""))
    found.sort(reverse=True)
    last_err: Optional[BaseException] = None
    for _s, _ts, d in found:
        try:
            with open(os.path.join(d, "MANIFEST.json")) as f:
                manifest = json.load(f)
            paths = None
            if param_paths is not None and not os.path.exists(
                    os.path.join(d, TREE_FILE)):
                paths = jax_leaf_paths(param_paths,
                                       len(inspect_dir(d)["leaves"]))
            kind, leaf_paths, leaves, _ = _assemble(d, manifest, paths)
            return unflatten_state(kind, leaf_paths, leaves)
        except _CORRUPTION_ERRORS as e:
            last_err = e
            if d != found[-1][2]:
                logger.warning(
                    "checkpoint %s failed integrity verification (%s); "
                    "falling back to the previous committed manifest",
                    d, e)
    if len(found) == 1:
        raise last_err
    raise CheckpointCorruptError(
        f"every committed checkpoint under {root!r} failed integrity "
        f"verification; last error: {last_err}") from last_err


def _safe_ls(path: str) -> List[str]:
    try:
        return sorted(os.listdir(path))
    except OSError:
        return []


def list_checkpoints(root: str) -> List[Dict[str, Any]]:
    """Committed manifests under a checkpoint root (every run), newest
    first."""
    root = os.path.abspath(root)
    run_dirs = [root] if any(_STEP_RE.match(n) for n in _safe_ls(root)) \
        else [os.path.join(root, n) for n in _safe_ls(root)
              if os.path.isdir(os.path.join(root, n))]
    out = []
    for run_dir in run_dirs:
        for name in _safe_ls(run_dir):
            mpath = os.path.join(run_dir, name, "MANIFEST.json")
            if _STEP_RE.match(name) and os.path.exists(mpath):
                try:
                    with open(mpath) as f:
                        out.append(json.load(f))
                except (OSError, ValueError):
                    continue
    out.sort(key=lambda m: m.get("ts", 0), reverse=True)
    return out


def inspect_dir(step_dir: str) -> Dict[str, Any]:
    """Manifest + per-leaf metadata of one step directory."""
    step_dir = os.path.abspath(step_dir)
    mpath = os.path.join(step_dir, "MANIFEST.json")
    manifest: Dict[str, Any] = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    leaves: List[Dict[str, Any]] = []
    nshards = 0
    for fname in _safe_ls(step_dir):
        if not (fname.startswith("shard-") and fname.endswith(".json")):
            continue
        nshards += 1
        with open(os.path.join(step_dir, fname)) as f:
            spec = json.load(f)
        if not leaves:
            leaves = [dict(m, shards=0, bytes=0) for m in spec["leaves"]]
        for entry in spec["entries"]:
            li = entry["leaf"]
            leaves[li]["shards"] += 1
            size = int(np.prod(entry["shape"] or [1]))
            leaves[li]["bytes"] += size * _DTYPES[
                leaves[li]["dtype"]].itemsize
    return {"dir": step_dir, "committed": bool(manifest),
            "manifest": manifest, "num_shard_files": nshards,
            "leaves": leaves}
