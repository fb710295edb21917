"""ray_tpu_torch.data: datasets with a lazy plan and streaming execution
(the port of ``ray_tpu/data/dataset.py``).

Reference: ``python/ray/data`` — a ``Dataset`` is a lazy logical plan over
blocks, compiled to tasks by a streaming executor with bounded in-flight
work (``_internal/execution/streaming_executor.py:48``). The shape is
JAX's: blocks are ``ObjectRef``s of blocks, per-block transforms run as
remote tasks of the core API with a bounded window (backpressure), and
all-to-all operations (shuffle, sort, repartition, groupby, join) run as
two-stage map and reduce tasks.

A block is an ordered dict of numpy columns (:mod:`.block`), where JAX's
is a pyarrow Table. A dataset's handles are refs, or (in a train worker,
which has no runtime of its own) the blocks themselves: every consumer
reads a handle through :func:`_fetch`. The training-ingest path
(``streaming_split``, ``iter_device_batches``) feeds torch batches
through :class:`~ray_tpu_torch.train.ingest.DevicePrefetcher`.
"""

from __future__ import annotations

import builtins
import glob as glob_mod
import contextlib
import itertools
import math
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as B

Batch = Union[Dict[str, np.ndarray], "pandas.DataFrame"]

MAX_IN_FLIGHT = 16  # streaming window hard cap (backpressure bound)
_STATS_ACTOR = "_rtpu_data_stats"
MEMORY_BUDGET_ENV = "RAY_TPU_DATA_MEMORY_BUDGET_BYTES"

_stats_handle = None
_stats_handle_core = None
_stats_lock = threading.Lock()


def reset_stats_cache() -> None:
    """Drop the cached stats-actor handle (a handle of a runtime that was
    shut down)."""
    global _stats_handle, _stats_handle_core
    with _stats_lock:
        _stats_handle = None
        _stats_handle_core = None


def _core_or_none():
    from ray_tpu_torch._private import worker as _worker

    w = _worker.global_worker_or_none()
    return None if w is None else w.core


def _record_stats(stats_key, op: str, rows_in: int, rows_out: int,
                  seconds: float) -> None:
    """Fire-and-forget per-block stats to the session's stats actor
    (reference: ``_StatsActor``, ``data/_internal/stats.py``). The
    actor's id is cached per runtime, and the record goes to that
    runtime directly: a record made after ``shutdown()`` is dropped and
    never starts a runtime again (JAX's goes through ``get_actor`` and
    ``.remote``, which start one)."""
    global _stats_handle, _stats_handle_core
    if not stats_key:
        return
    core = _core_or_none()
    if core is None:
        return
    try:
        with _stats_lock:
            if _stats_handle is None or _stats_handle_core is not core:
                actor_id, _cls, options = core.get_named_actor(
                    _STATS_ACTOR, None)
                _stats_handle = (actor_id, options)
                _stats_handle_core = core
            actor_id, options = _stats_handle
        core.submit_actor_task(actor_id, "record",
                               (stats_key, op, rows_in, rows_out, seconds),
                               {}, options)
    except Exception:  # noqa: BLE001 — stats are best-effort
        reset_stats_cache()


class _StatsActor:
    """Session-wide collector of per-operator execution stats. Bounded:
    only the most recent executions are retained."""

    MAX_KEYS = 256

    def __init__(self):
        self.data: Dict[str, Dict[str, list]] = {}

    def record(self, key, op, rows_in, rows_out, seconds):
        if key not in self.data:
            while len(self.data) >= self.MAX_KEYS:
                self.data.pop(next(iter(self.data)))
        entry = self.data.setdefault(key, {}).setdefault(
            op, [0, 0, 0.0, 0])  # rows_in, rows_out, seconds, blocks
        entry[0] += rows_in
        entry[1] += rows_out
        entry[2] += seconds
        entry[3] += 1

    def get(self, key):
        return self.data.get(key, {})


def _fetch(handle) -> B.Block:
    """A block from its handle: a ref, or the block itself."""
    if isinstance(handle, dict):
        return handle
    return ray_tpu_torch.get(handle)


def _held_bytes(refs: List[Any], sizes: Dict[str, int]) -> int:
    """Bytes of the blocks among ``refs`` that are ready (``B.nbytes``),
    each read once into ``sizes``. A block task that failed counts
    nothing here: its error reaches whoever reads the block."""
    pending = [r for r in refs if r.hex() not in sizes]
    if pending:
        ready, _ = ray_tpu_torch.wait(pending, num_returns=len(pending),
                                      timeout=0)
        for r in ready:
            try:
                sizes[r.hex()] = B.nbytes(ray_tpu_torch.get(r))
            except Exception:  # noqa: BLE001 — the reader raises it
                sizes[r.hex()] = 0
    return sum(sizes.get(r.hex(), 0) for r in refs)


def _input(blk: B.Block) -> B.Block:
    """``blk`` with read-only columns, as Arrow's zero-copy numpy views
    are: a UDF that writes into its batch fails instead of changing the
    stored block other consumers read."""
    out = {}
    for k, col in blk.items():
        v = col.view()
        v.flags.writeable = False
        out[k] = v
    return out


# remote per-block kernels (module-level, as JAX's)
@ray_tpu_torch.remote
def _map_block(blk: B.Block, fn, stats_key=None) -> B.Block:
    t0 = time.perf_counter()
    out = B.from_rows([fn(r) for r in B.rows_of(blk)])
    _record_stats(stats_key, "map", B.num_rows(blk), B.num_rows(out),
                  time.perf_counter() - t0)
    return out


@ray_tpu_torch.remote
def _map_batches_block(blk: B.Block, fn, fmt: str,
                       stats_key=None) -> B.Block:
    t0 = time.perf_counter()
    out = B.from_batch(fn(B.batch_of(_input(blk), fmt)))
    _record_stats(stats_key, "map_batches", B.num_rows(blk),
                  B.num_rows(out), time.perf_counter() - t0)
    return out


@ray_tpu_torch.remote
def _filter_block(blk: B.Block, fn, stats_key=None) -> B.Block:
    t0 = time.perf_counter()
    out = B.from_rows([r for r in B.rows_of(blk) if fn(r)])
    _record_stats(stats_key, "filter", B.num_rows(blk), B.num_rows(out),
                  time.perf_counter() - t0)
    return out


@ray_tpu_torch.remote
def _flat_map_block(blk: B.Block, fn, stats_key=None) -> B.Block:
    t0 = time.perf_counter()
    out: List[Any] = []
    for r in B.rows_of(blk):
        out.extend(fn(r))
    out = B.from_rows(out)
    _record_stats(stats_key, "flat_map", B.num_rows(blk), B.num_rows(out),
                  time.perf_counter() - t0)
    return out


class _MapWorker:
    """Actor hosting a stateful map_batches callable (reference:
    ``ActorPoolMapOperator`` — a class UDF is constructed ONCE per pool
    actor and reused for every batch, amortizing model loads)."""

    def __init__(self, fn_or_cls, ctor_args, ctor_kwargs, card=None):
        # ``card``: the CUDA card the pool reserved for this actor; the
        # UDF is built and called with it as the current device.
        self.card = card
        with self._on_card():
            if isinstance(fn_or_cls, type):
                self.fn = fn_or_cls(*ctor_args, **(ctor_kwargs or {}))
            else:
                self.fn = fn_or_cls

    def _on_card(self):
        if self.card is None:
            return contextlib.nullcontext()
        import torch

        return torch.cuda.device(self.card)

    def map_batch(self, blk: B.Block, fmt: str, stats_key=None) -> B.Block:
        t0 = time.perf_counter()
        with self._on_card():
            out = B.from_batch(self.fn(B.batch_of(_input(blk), fmt)))
        _record_stats(stats_key, "map_batches(actors)", B.num_rows(blk),
                      B.num_rows(out), time.perf_counter() - t0)
        return out

    def ping(self):
        return True


def _pool_cards(size: int, num_gpus: Optional[float]) -> List[Optional[int]]:
    """The CUDA card each of a pool's ``size`` actors is pinned to:
    actor i takes card ``floor(i * num_gpus)`` (a card each at 1, two
    actors a card at 0.5). The in-process runtime charges actors no
    resources, so the pool reserves the cards itself; it raises when
    they are more than the process sees."""
    if not num_gpus:
        return [None] * size
    import torch

    need, have = math.ceil(size * num_gpus), torch.cuda.device_count()
    if need > have:
        raise ValueError(
            f"map_batches: {size} actors at num_gpus={num_gpus} need "
            f"{need} CUDA cards; this process sees {have}")
    return [int(i * num_gpus) for i in builtins.range(size)]


@ray_tpu_torch.remote
def _block_len(blk: B.Block) -> int:
    return B.num_rows(blk)


@ray_tpu_torch.remote
def _slice_block(blk: B.Block, off: int, length: int) -> B.Block:
    return B.slice_block(blk, off, length)


@ray_tpu_torch.remote
def _zip_block(left: B.Block, *right_parts) -> B.Block:
    right = B.concat(right_parts)
    out = dict(left)
    for name, col in right.items():
        out_name = name
        while out_name in out:  # reference: right-side dups get _1
            out_name += "_1"
        out[out_name] = col
    return out


def _key_partition(v, n: int) -> int:
    """Partition index for a join key, copied from JAX's. Must respect
    EQUALITY (0.0 == -0.0 == 0 land together) and be stable ACROSS
    PROCESSES (str hash() is seed-randomized, so strings go through
    crc32; numeric hash() is deterministic)."""
    import zlib

    if isinstance(v, bytes):
        return zlib.crc32(v) % n
    if isinstance(v, str):
        return zlib.crc32(v.encode()) % n
    if isinstance(v, (int, float, np.integer, np.floating)):
        if v != v:
            return 0  # NaN: every NaN in one bucket (Arrow's join
            # matches NaN==NaN).
        return hash(v) % n  # Python numeric hash: equal values, equal hash
    return zlib.crc32(repr(v).encode()) % n


@ray_tpu_torch.remote
def _hash_partition_block(blk: B.Block, key: str, n: int):
    """Split one block into n key-hashed parts (join map stage)."""
    if key not in blk:
        if blk:
            raise KeyError(
                f"join key {key!r} not in columns {list(blk)}")
        col = []  # genuinely schema-less empty block
    else:
        col = B.py_values(blk[key])
    idx = [[] for _ in builtins.range(n)]
    for i, v in enumerate(col):
        idx[_key_partition(v, n)].append(i)
    parts = [B.take(blk, ix) for ix in idx]
    return tuple(parts) if n > 1 else parts[0]


class _NaNKey:
    """One dict key for every NaN (Arrow's join and group_by put NaNs
    together; ``nan != nan`` in a Python dict)."""

    def __hash__(self):
        return 0x7FF8

    def __eq__(self, other):
        return isinstance(other, _NaNKey)


_NAN = _NaNKey()


def _norm_key(v):
    """A join or group key as Arrow compares it: floats by value bits
    (0.0 and -0.0 apart), every NaN one key."""
    if isinstance(v, float):
        return _NAN if v != v else (float, v.hex())
    if isinstance(v, np.ndarray):
        return v.tobytes()
    return v


def _keys(blk: B.Block, on: Sequence[str]) -> List[tuple]:
    cols = [B.py_values(blk[k]) for k in on]
    return [tuple(_norm_key(c[i]) for c in cols)
            for i in builtins.range(B.num_rows(blk))]


def _gather(blk: B.Block, name: str, idx: List[Optional[int]],
            other: Optional[B.Block] = None,
            other_idx: Optional[List[Optional[int]]] = None) -> np.ndarray:
    """Column ``name`` at rows ``idx`` (None: a null, or ``other``'s row
    at ``other_idx`` for a coalesced key)."""
    col = blk[name]
    if all(i is not None for i in idx):
        return col[np.asarray(idx, dtype=np.int64)] if idx else col[:0]
    vals = []
    for j, i in enumerate(idx):
        if i is not None:
            vals.append(col[i])
        elif other is not None and other_idx[j] is not None:
            vals.append(other[name][other_idx[j]])
        else:
            vals.append(None)
    return B.from_rows([{"v": v} for v in vals])["v"]


def _hash_join(lt: B.Block, rt: B.Block, on: List[str],
               join_type: str) -> B.Block:
    """Arrow's join semantics on one partition: the keys once (coalesced
    for the outer joins), then the left side's other columns, then the
    right side's; a missing side's cells are null. Rows: each left row
    with its matches in right order, then the unmatched right rows."""
    right_rows: Dict[tuple, List[int]] = {}
    for j, k in enumerate(_keys(rt, on)):
        right_rows.setdefault(k, []).append(j)
    li: List[Optional[int]] = []
    ri: List[Optional[int]] = []
    matched_right = set()
    semi = join_type in ("left semi", "left anti")
    for i, k in enumerate(_keys(lt, on)):
        hits = right_rows.get(k, [])
        if semi:
            if bool(hits) == (join_type == "left semi"):
                li.append(i)
            continue
        if hits:
            for j in hits:
                li.append(i)
                ri.append(j)
                matched_right.add(j)
        elif join_type in ("left outer", "full outer"):
            li.append(i)
            ri.append(None)
    if semi:
        return B.take(lt, li)
    if join_type in ("right semi", "right anti"):
        keep = [j for j in builtins.range(B.num_rows(rt))
                if (j in matched_right) == (join_type == "right semi")]
        return B.take(rt, keep)
    if join_type in ("right outer", "full outer"):
        for j in builtins.range(B.num_rows(rt)):
            if j not in matched_right:
                li.append(None)
                ri.append(j)
    if join_type not in ("inner", "left outer", "right outer",
                         "full outer"):
        raise ValueError(f"unknown join type {join_type!r}")
    out: B.Block = {}
    for k in on:
        out[k] = _gather(lt, k, li, rt, ri)
    for k in lt:
        if k not in on:
            out[k] = _gather(lt, k, li)
    for k in rt:
        if k in on:
            continue
        if k in out:
            raise ValueError(
                f"join: column {k!r} is on both sides (Arrow refuses the "
                f"collision too)")
        out[k] = _gather(rt, k, ri)
    return out


@ray_tpu_torch.remote
def _join_reduce(join_type: str, on, n_left: int, *parts) -> B.Block:
    # Keep empty partitions: they carry the side's columns, which the
    # outer join variants need to null-fill missing columns.
    lparts = [p for p in parts[:n_left] if p]
    rparts = [p for p in parts[n_left:] if p]
    if not lparts or not rparts:
        return {}  # a schema-less side: nothing to join
    lt = B.concat(lparts)
    rt = B.concat(rparts)
    if not B.num_rows(lt) and join_type in ("inner", "left outer"):
        return {}
    if not B.num_rows(rt) and join_type in ("inner", "right outer"):
        return {}
    return _hash_join(lt, rt, list(on), join_type)


class ActorPoolStrategy:
    """Fixed-size actor pool for stateful map_batches (reference:
    ``ray.data.ActorPoolStrategy`` — min/max autoscaling pool, fixed here)."""

    def __init__(self, size: int = 2):
        self.size = max(int(size), 1)


class Schema:
    """A dataset's columns: ``names``, numpy ``types`` and each column's
    per-row ``shapes`` (``()`` for a scalar column; Arrow's schema has
    ``names`` and ``types``)."""

    def __init__(self, blk: B.Block):
        self.names = list(blk)
        self.types = [col.dtype for col in blk.values()]
        self.shapes = [tuple(col.shape[1:]) for col in blk.values()]

    def __repr__(self):
        return "\n".join(f"{n}: {t}{'' if not s else list(s)}"
                         for n, t, s in zip(self.names, self.types,
                                            self.shapes))


def _teardown_when_done(core, refs: List[Any], actors: List[Any]) -> None:
    """Kill a stage's pool actors once every produced block is ready.
    Callbacks on the blocks, not a thread: nothing waits past
    ``shutdown()``, which ends the actors itself (JAX's teardown thread
    waits up to an hour)."""
    if not refs:
        for a in actors:
            core.kill_actor(a._actor_id, True)
        return
    left = [len(refs)]
    lock = threading.Lock()

    def done(_fut):
        with lock:
            left[0] -= 1
            last = left[0] == 0
        if last:
            for a in actors:
                try:
                    core.kill_actor(a._actor_id, True)
                except Exception:  # noqa: BLE001 — runtime already down
                    pass

    for r in refs:
        core.as_future(r).add_done_callback(done)


class Dataset:
    """Lazy plan: a list of block handles + pending transforms."""

    def __init__(self, block_refs: List[Any], plan: Optional[List] = None):
        self._block_refs = block_refs  # ObjectRefs of blocks, or blocks
        self._plan = plan or []       # [(op, payload), ...] pending stages
        self._last_stats_key: Optional[str] = None

    # -------------------------------------------------------------- plan ops
    def _with(self, op: str, payload) -> "Dataset":
        return Dataset(self._block_refs, self._plan + [(op, payload)])

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return self._with("map", fn)

    def map_batches(self, fn: Union[Callable[[Batch], Batch], type], *,
                    batch_format: str = "numpy",
                    batch_size: Optional[int] = None,
                    compute: Optional["ActorPoolStrategy"] = None,
                    concurrency: Optional[int] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None,
                    num_gpus: Optional[float] = None) -> "Dataset":
        """Per-block batch transform. A class UDF (or an explicit
        ``compute=ActorPoolStrategy(...)`` / ``concurrency=N``) runs on a
        pool of actors that construct the UDF once and reuse it per batch
        (reference: ``ActorPoolMapOperator``). ``num_gpus`` reserves CUDA
        cards for the pool's actors (:func:`_pool_cards`), each built and
        called on its card. ``batch_size`` is accepted and, as in JAX, a
        batch is a whole block."""
        if isinstance(fn, type) or compute is not None or \
                concurrency is not None or num_gpus:
            pool = compute or ActorPoolStrategy(concurrency or 2)
            return self._with("map_batches_actors",
                              (fn, batch_format, pool.size,
                               fn_constructor_args,
                               fn_constructor_kwargs or {}, num_gpus))
        return self._with("map_batches", (fn, batch_format))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        return self._with("filter", fn)

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        return self._with("flat_map", fn)

    def limit(self, n: int) -> "Dataset":
        return self._with("limit", n)

    # ------------------------------------------------------------- execution
    def _execute(self) -> List[Any]:
        """Run pending stages with a streaming window; returns block refs.

        Pipelined: a block flows through all per-block stages without
        waiting for its siblings (the reference's operator fusion);
        ``limit`` cuts the stream short.
        """
        refs = list(self._block_refs)
        limit: Optional[int] = None
        stages = []
        for op, payload in self._plan:
            if op == "limit":
                limit = payload if limit is None else min(limit, payload)
            else:
                stages.append((op, payload))
        if not stages and limit is None:
            return refs

        from ray_tpu_torch._private import worker as _worker

        core = _worker.global_worker().core
        stats_key = uuid.uuid4().hex[:12]
        self._last_stats_key = stats_key
        try:  # session stats actor, shared across datasets
            ray_tpu_torch.remote(_StatsActor).options(
                name=_STATS_ACTOR, get_if_exists=True,
                lifetime="detached").remote()
        except Exception:  # noqa: BLE001
            stats_key = None

        # Actor pools for stateful map_batches stages, one per stage;
        # torn down once every produced block is ready.
        pools: Dict[int, List[Any]] = {}

        def pool_for(stage_idx, payload):
            actors = pools.get(stage_idx)
            if actors is None:
                fn, _, size, ctor_args, ctor_kwargs, num_gpus = payload
                cls = ray_tpu_torch.remote(_MapWorker)
                actors = [cls.remote(fn, ctor_args, ctor_kwargs, card)
                          for card in _pool_cards(size, num_gpus)]
                pools[stage_idx] = actors
            return actors

        rr = itertools.count()

        def apply_stages(ref):
            for i, (op, payload) in enumerate(stages):
                if op == "map":
                    ref = _map_block.remote(ref, payload, stats_key)
                elif op == "map_batches":
                    fn, fmt = payload
                    ref = _map_batches_block.remote(ref, fn, fmt, stats_key)
                elif op == "map_batches_actors":
                    actors = pool_for(i, payload)
                    actor = actors[next(rr) % len(actors)]
                    ref = actor.map_batch.remote(ref, payload[1], stats_key)
                elif op == "filter":
                    ref = _filter_block.remote(ref, payload, stats_key)
                elif op == "flat_map":
                    ref = _flat_map_block.remote(ref, payload, stats_key)
            if isinstance(ref, dict):  # no per-block stage: a local block
                ref = ray_tpu_torch.put(ref)
            return ref

        # Resource-aware window: never hold more in-flight blocks than the
        # runtime can execute (2x CPUs), capped by MAX_IN_FLIGHT.
        try:
            cpus = core.cluster_resources().get("CPU", 4.0)
        except Exception:  # noqa: BLE001
            cpus = 4.0
        window_cap = max(2, min(MAX_IN_FLIGHT, int(cpus * 2)))

        # Memory backpressure (reference: execution/backpressure_policy/):
        # when the output blocks this execution holds outweigh the
        # budget, drain the whole window before launching more block
        # tasks. JAX reads the cluster's memory summary; the port counts
        # the host bytes of its own ready output blocks.
        mem_budget = int(os.environ.get(MEMORY_BUDGET_ENV, 2 << 30))
        mem_check = {"next": 0.0}
        sizes: Dict[str, int] = {}

        def over_memory_budget() -> bool:
            now = time.monotonic()
            if now < mem_check["next"]:
                return False
            mem_check["next"] = now + 0.5  # probe at most 2x/sec
            return _held_bytes(window + out, sizes) > mem_budget

        out = []
        window: List[Any] = []
        produced = 0
        for ref in refs:
            if limit is not None and produced >= limit:
                break
            window.append(apply_stages(ref))
            if len(window) >= window_cap or \
                    (window and over_memory_budget()):
                done = window.pop(0)
                # BLOCK until the oldest in-flight block finishes.
                ray_tpu_torch.wait([done], num_returns=1, timeout=None)
                out.append(done)
                if limit is not None:
                    produced += B.num_rows(ray_tpu_torch.get(done))
        for done in window:
            out.append(done)
            if limit is not None:
                produced += B.num_rows(ray_tpu_torch.get(done))
                if produced >= limit:
                    break
        if limit is not None:
            out = self._apply_limit(out, limit)
        if pools:
            _teardown_when_done(core, list(out),
                                [a for lst in pools.values() for a in lst])
        return out

    @staticmethod
    def _apply_limit(refs: List[Any], n: int) -> List[Any]:
        out, total = [], 0
        for ref in refs:
            t = ray_tpu_torch.get(ref)
            rows = B.num_rows(t)
            if total + rows <= n:
                out.append(ray_tpu_torch.put(t))
                total += rows
            else:
                out.append(ray_tpu_torch.put(B.slice_block(t, 0, n - total)))
                total = n
            if total >= n:
                break
        return out

    def _iter_blocks(self) -> Iterator[B.Block]:
        for handle in self._execute():
            yield _fetch(handle)

    def materialize(self) -> "Dataset":
        return Dataset(self._execute())

    # ------------------------------------------------------------ all-to-all
    # Two-stage task shuffle (reference: push-based shuffle —
    # ``data/_internal/planner/exchange/shuffle_task_spec.py``): each input
    # block is split into per-partition parts by a map task; each output
    # block is assembled by a reduce task. The driver holds only refs and
    # (for sort) a small boundary sample.
    def _two_stage_shuffle(self, refs: List[Any], num_parts: int,
                           map_mode: str, map_arg, reduce_mode: str,
                           reduce_arg) -> "Dataset":
        parts = []
        for i, r in enumerate(refs):
            out = _shuffle_map.options(num_returns=num_parts).remote(
                r, num_parts, map_mode,
                map_arg(i) if callable(map_arg) else map_arg)
            parts.append([out] if num_parts == 1 else out)
        out_refs = [
            _shuffle_reduce.remote(
                reduce_mode,
                reduce_arg(j) if callable(reduce_arg) else reduce_arg,
                *[p[j] for p in parts])
            for j in builtins.range(num_parts)]
        ds = Dataset(out_refs)
        ds._last_shuffle = {"mode": "distributed", "map_tasks": len(refs),
                            "reduce_tasks": num_parts}
        return ds

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise combination of two row-aligned datasets (reference:
        ``Dataset.zip`` — duplicate right-side columns get a ``_1``
        suffix). The right side is sliced remotely to the left side's
        block boundaries."""
        a_refs = self._execute()
        b_refs = other._execute()
        counts = ray_tpu_torch.get(
            [_block_len.remote(r) for r in a_refs + b_refs], timeout=600)
        a_counts, b_counts = counts[:len(a_refs)], counts[len(a_refs):]
        if sum(a_counts) != sum(b_counts):
            raise ValueError(
                f"zip requires equal row counts; "
                f"got {sum(a_counts)} vs {sum(b_counts)}")
        out = []
        bi, b_off = 0, 0
        for a_ref, need in builtins.zip(a_refs, a_counts):
            pieces = []
            while need > 0:
                avail = b_counts[bi] - b_off
                take = min(need, avail)
                pieces.append(_slice_block.remote(b_refs[bi], b_off, take))
                b_off += take
                need -= take
                if b_off >= b_counts[bi]:
                    bi += 1
                    b_off = 0
            out.append(_zip_block.remote(a_ref, *pieces))
        return Dataset(out)

    def join(self, other: "Dataset", on, *, join_type: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join on key column(s) ``on`` (reference:
        ``Dataset.join``): both sides hash-partition by key (map stage),
        then each partition joins on its own (reduce stage, Arrow's
        semantics: :func:`_hash_join`)."""
        if isinstance(on, str):
            on = [on]
        key = on[0]
        a_refs = self._execute()
        b_refs = other._execute()
        n = num_partitions or max(len(a_refs), len(b_refs))
        opts = {"num_returns": n} if n > 1 else {}
        a_parts = [_hash_partition_block.options(**opts).remote(r, key, n)
                   for r in a_refs]
        b_parts = [_hash_partition_block.options(**opts).remote(r, key, n)
                   for r in b_refs]
        if n == 1:
            a_parts = [[p] for p in a_parts]
            b_parts = [[p] for p in b_parts]
        out = [
            _join_reduce.remote(join_type, list(on), len(a_parts),
                                *[p[j] for p in a_parts],
                                *[p[j] for p in b_parts])
            for j in builtins.range(n)]
        return Dataset(out)

    def repartition(self, num_blocks: int) -> "Dataset":
        refs = self._execute()
        if not refs:
            return Dataset([ray_tpu_torch.put({})
                            for _ in builtins.range(num_blocks)])
        # Order-preserving: per-block row counts (the only driver-side
        # data) cut the global row range into num_blocks contiguous
        # spans; each map task slices its block by global offset.
        sizes = ray_tpu_torch.get([_block_len.remote(r) for r in refs],
                                  timeout=600)
        total = sum(sizes)
        cuts = [total * (j + 1) // num_blocks
                for j in builtins.range(num_blocks - 1)]
        starts = list(itertools.accumulate([0] + sizes[:-1]))
        return self._two_stage_shuffle(
            refs, num_blocks, "slice", lambda i: (starts[i], cuts),
            "concat", None)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        refs = self._execute()
        if not refs:
            return Dataset([])
        k = len(refs)
        map_arg = (lambda i: (seed, i)) if seed is not None else \
            (lambda i: None)
        reduce_arg = (lambda j: (seed, 1 << 20, j)) if seed is not None \
            else (lambda j: None)
        return self._two_stage_shuffle(refs, k, "random", map_arg,
                                       "random", reduce_arg)

    SORT_SAMPLES_PER_BLOCK = 64

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        refs = self._execute()
        if not refs:
            return Dataset([])
        k = len(refs)
        order = "descending" if descending else "ascending"
        if k == 1:
            return Dataset([_shuffle_reduce.remote(
                "sort", (key, order), refs[0])])
        # Range partitioning (TeraSort shape): sample keys per block,
        # cut boundaries at sample quantiles, then map-split by range and
        # reduce-sort each range locally.
        samples = ray_tpu_torch.get(
            [_sample_keys.remote(r, key, self.SORT_SAMPLES_PER_BLOCK)
             for r in refs], timeout=600)
        live = [s for s in samples if len(s)]
        if not live:  # every block is empty: nothing to sort
            return self.repartition(k)
        allv = np.sort(np.concatenate(live))
        bounds = [allv[min(int(j * len(allv) / k), len(allv) - 1)]
                  for j in builtins.range(1, k)]
        ds = self._two_stage_shuffle(
            refs, k, "range", (key, bounds), "sort", (key, order))
        if descending:
            # Range partitions are ascending; a descending sort reads
            # the partitions in reverse.
            ds._block_refs = list(reversed(ds._block_refs))
        return ds

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        refs = self._execute()
        for o in others:
            refs = refs + o._execute()
        return Dataset(refs)

    def split(self, n: int) -> List["Dataset"]:
        refs = self.repartition(n)._block_refs
        return [Dataset([r]) for r in refs]

    def streaming_split(self, n: int,
                        name: Optional[str] = None) -> List["DataIterator"]:
        """Per-consumer iterators for Train ingest (reference:
        ``Dataset.streaming_split`` feeding ray.train workers). ``name``
        tags each shard's ingest telemetry (TorchTrainer passes its
        ``datasets=`` key)."""
        parts = self.split(n)
        return [DataIterator(p, name=name) for p in parts]

    def iterator(self) -> "DataIterator":
        return DataIterator(self)

    # ------------------------------------------------------------ consumers
    def count(self) -> int:
        return sum(B.num_rows(b) for b in self._iter_blocks())

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for blk in self._iter_blocks():
            for row in B.rows_of(blk):
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for blk in self._iter_blocks():
            out.extend(B.rows_of(blk))
        return out

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for blk in self._iter_blocks():
            yield from B.rows_of(blk)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Batch]:
        pending: Optional[B.Block] = None
        for t in self._iter_blocks():
            if pending is not None and B.num_rows(pending):
                t = B.concat([pending, t]) if B.num_rows(t) else pending
                pending = None
            n = B.num_rows(t)
            off = 0
            while off + batch_size <= n:
                yield B.batch_of(B.slice_block(t, off, batch_size),
                                 batch_format)
                off += batch_size
            if off < n:
                pending = B.slice_block(t, off, n - off)
        if pending is not None and B.num_rows(pending) and not drop_last:
            yield B.batch_of(pending, batch_format)

    def to_pandas(self):
        live = [b for b in self._iter_blocks() if B.num_rows(b)]
        return B.to_pandas(B.concat(live) if live else {})

    def _local(self) -> "Dataset":
        """This dataset executed, its blocks held in the dataset itself:
        it pickles whole, and reads back with no runtime (a train
        worker's shard)."""
        return Dataset(list(self._iter_blocks()))

    # ------------------------------------------------------------- writers
    # Distributed writes (reference: ``Dataset.write_parquet`` etc. —
    # one output file per block, written by the task that holds it).
    def _write(self, dir_path: str, fmt: str, ext: str) -> List[str]:
        os.makedirs(dir_path, exist_ok=True)
        refs = self._execute()
        out = [
            _write_block.remote(
                r, os.path.join(dir_path, f"block_{i:05d}.{ext}"), fmt)
            for i, r in enumerate(refs)]
        return [p for p in ray_tpu_torch.get(out, timeout=600) if p]

    def write_parquet(self, dir_path: str) -> List[str]:
        """Write one parquet file per block into ``dir_path``; returns
        the written paths (empty blocks are skipped). Needs pyarrow."""
        return self._write(dir_path, "parquet", "parquet")

    def write_csv(self, dir_path: str) -> List[str]:
        return self._write(dir_path, "csv", "csv")

    def write_json(self, dir_path: str) -> List[str]:
        """Newline-delimited JSON, one file per block."""
        return self._write(dir_path, "json", "jsonl")

    def schema(self) -> Optional[Schema]:
        for blk in self._iter_blocks():
            if blk:
                return Schema(blk)
        return None

    def stats(self) -> str:
        """Per-operator execution stats of the last run (reference:
        ``Dataset.stats()`` / ``data/_internal/stats.py``)."""
        key = self._last_stats_key
        if key is None:
            return "(dataset not executed yet)"
        if _core_or_none() is None:
            return "(no stats recorded)"
        try:
            data = ray_tpu_torch.get(
                ray_tpu_torch.get_actor(_STATS_ACTOR).get.remote(key),
                timeout=10)
        except Exception:  # noqa: BLE001
            return "(no stats recorded)"
        if not data:
            return "(no stats recorded)"
        lines = []
        for op, (rin, rout, secs, blocks) in data.items():
            lines.append(
                f"{op}: {blocks} blocks, {rin} rows in -> {rout} rows out, "
                f"{secs * 1000:.1f}ms total wall")
        return "\n".join(lines)

    def num_blocks(self) -> int:
        return len(self._block_refs)

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._block_refs)}, "
                f"plan={len(self._plan)} stages)")


# ------------------------------------------------------- shuffle task bodies
@ray_tpu_torch.remote
def _shuffle_map(blk: B.Block, num_parts: int, mode: str, arg):
    """Map stage: split one block into ``num_parts`` partition blocks
    (reference: shuffle map tasks,
    ``data/_internal/planner/exchange/shuffle_task_spec.py``)."""
    n = B.num_rows(blk)
    if mode == "slice":
        # Contiguous split by global row offset (order-preserving
        # repartition): partition j covers global rows [cuts[j-1], cuts[j]).
        start, cuts = arg
        edges = [0] + [min(max(c - start, 0), n) for c in cuts] + [n]
        parts = tuple(B.slice_block(blk, edges[j], edges[j + 1] - edges[j])
                      for j in builtins.range(num_parts))
        return parts if num_parts > 1 else parts[0]
    if mode == "roundrobin":
        groups = [np.arange(j, n, num_parts)
                  for j in builtins.range(num_parts)]
    elif mode == "random":
        assign = np.random.default_rng(arg).integers(0, num_parts, size=n)
        groups = [np.nonzero(assign == j)[0]
                  for j in builtins.range(num_parts)]
    elif mode == "range":
        key, bounds = arg
        values = blk[key] if n else np.array([])
        part_ids = np.searchsorted(np.asarray(bounds), values,
                                   side="right") if n else values
        groups = [np.nonzero(part_ids == j)[0]
                  for j in builtins.range(num_parts)]
    else:
        raise ValueError(f"unknown shuffle map mode {mode!r}")
    parts = tuple(B.take(blk, g) if len(g) else B.empty_like(blk)
                  for g in groups)
    return parts if num_parts > 1 else parts[0]


def _stable_order(values: np.ndarray, descending: bool) -> np.ndarray:
    """Stable sort order (ties keep their order, as Arrow's sort_by)."""
    if not descending:
        return np.argsort(values, kind="stable")
    n = len(values)
    return (n - 1 - np.argsort(values[::-1], kind="stable"))[::-1]


@ray_tpu_torch.remote
def _shuffle_reduce(mode: str, arg, *parts: B.Block) -> B.Block:
    """Reduce stage: assemble one output block from its per-map parts."""
    live = [t for t in parts if B.num_rows(t)]
    combined = B.concat(live) if live else \
        (B.empty_like(parts[0]) if parts else {})
    n = B.num_rows(combined)
    if mode == "random" and n:
        idx = np.random.default_rng(arg).permutation(n)
        combined = B.take(combined, idx)
    elif mode == "sort" and n:
        key, order = arg
        combined = B.take(combined, _stable_order(
            combined[key], order == "descending"))
    return combined


def _csv_cell(v):
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


@ray_tpu_torch.remote
def _write_block(blk: B.Block, path: str, fmt: str) -> str:
    """Write one block to one file (runs in the task holding it).
    Returns the path, or "" for an empty block (no file emitted)."""
    if not B.num_rows(blk):
        return ""
    if fmt == "parquet":
        from ray_tpu_torch.data.datasource import _require_pyarrow, to_arrow

        pq = _require_pyarrow("write_parquet", "pyarrow.parquet")
        pq.write_table(to_arrow(blk), path)
    elif fmt == "csv":
        import csv

        rows = B.rows_of(blk)
        with open(path, "w", newline="") as f:
            w = csv.writer(f, quoting=csv.QUOTE_NONNUMERIC)
            w.writerow(list(blk))
            for r in rows:
                w.writerow([_csv_cell(r[k]) for k in blk])
    elif fmt == "json":
        import json as _json

        with open(path, "w") as f:
            for row in B.rows_of(blk):
                f.write(_json.dumps(
                    {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in row.items()}) + "\n")
    else:
        raise ValueError(f"unknown write format {fmt!r}")
    return path


def _group_rows(blk: B.Block, key: str) -> Dict[Any, List[int]]:
    """Row indices of each key, keys in order of first appearance."""
    groups: Dict[Any, List[int]] = {}
    keys = B.py_values(blk[key])
    for i, k in enumerate(keys):
        groups.setdefault(_norm_key(k), []).append(i)
    return groups


def _key_column(blk: B.Block, key: str, groups) -> np.ndarray:
    return blk[key][np.asarray([ix[0] for ix in groups.values()],
                               dtype=np.int64)]


def _reduce(values: np.ndarray, how: str):
    if how == "sum":
        return values.sum()
    if how == "min":
        return values.min()
    if how == "max":
        return values.max()
    if how == "count":
        return np.int64(len(values))
    raise ValueError(f"unknown aggregate {how!r}")


def _aggregate(blk: B.Block, key: str, cols: List[tuple]) -> B.Block:
    """Arrow's ``group_by(key).aggregate(cols)`` on one block: the key,
    then ``{col}_{how}`` a (col, how), groups in first-appearance
    order."""
    groups = _group_rows(blk, key)
    out: B.Block = {key: _key_column(blk, key, groups)}
    for col, how in cols:
        vals = [_reduce(blk[col][np.asarray(ix, dtype=np.int64)], how)
                for ix in groups.values()]
        out[f"{col}_{how}"] = B.column_from_values(vals)
    return out


@ray_tpu_torch.remote
def _agg_map(blk: B.Block, key: str, col: str, how: str) -> B.Block:
    """Per-block partial aggregate. ``mean`` ships (sum, count) partials
    so the reduce can re-combine exactly."""
    if not B.num_rows(blk):
        return B.empty_like(blk)
    if how == "mean":
        return _aggregate(blk, key, [(col, "sum"), (col, "count")])
    return _aggregate(blk, key, [(col, how)])


@ray_tpu_torch.remote
def _agg_reduce(key: str, col: str, how: str, *parts: B.Block) -> B.Block:
    """Re-aggregate partials into the final grouped block (column naming
    matches a single-pass ``group_by(key).aggregate([(col, how)])``)."""
    live = [t for t in parts if B.num_rows(t)]
    if not live:
        return {}
    combined = B.concat(live)
    if how == "mean":
        g = _aggregate(combined, key, [(f"{col}_sum", "sum"),
                                       (f"{col}_count", "sum")])
        mean = (g[f"{col}_sum_sum"].astype(np.float64)
                / g[f"{col}_count_sum"].astype(np.float64))
        return {key: g[key], f"{col}_mean": mean}
    recombine = "sum" if how in ("sum", "count") else how
    g = _aggregate(combined, key, [(f"{col}_{how}", recombine)])
    return {key: g[key], f"{col}_{how}": g[f"{col}_{how}_{recombine}"]}


@ray_tpu_torch.remote
def _sample_keys(blk: B.Block, key: str, k: int):
    """Sort-boundary sampling: at most ``k`` key values from one block."""
    if key not in blk:  # schema-less empty block
        return np.array([])
    values = blk[key]
    if len(values) <= k:
        return values
    idx = np.random.default_rng(len(values)).choice(len(values), size=k,
                                                    replace=False)
    return values[idx]


class GroupedData:
    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, col: str, how: str) -> Dataset:
        # Distributed combine: per-block partial aggregates in tasks, one
        # reduce task re-aggregates the partials (reference:
        # ``data/_internal/planner/exchange/aggregate_task_spec.py``).
        refs = self._ds._execute()
        if not refs:
            return Dataset([ray_tpu_torch.put({})])
        partials = [_agg_map.remote(r, self._key, col, how) for r in refs]
        return Dataset([_agg_reduce.remote(self._key, col, how, *partials)])

    def sum(self, col: str) -> Dataset:
        return self._agg(col, "sum")

    def mean(self, col: str) -> Dataset:
        return self._agg(col, "mean")

    def min(self, col: str) -> Dataset:
        return self._agg(col, "min")

    def max(self, col: str) -> Dataset:
        return self._agg(col, "max")

    def count(self) -> Dataset:
        return self._agg(self._key, "count")


class DataIterator:
    """Reference: ``ray.data.DataIterator`` handed to train workers."""

    def __init__(self, ds: Dataset, name: Optional[str] = None):
        self._ds = ds
        # Ingest-telemetry tag (streaming_split passes TorchTrainer's
        # datasets= key).
        self._name = name

    def iter_batches(self, **kw) -> Iterator[Batch]:
        return self._ds.iter_batches(**kw)

    def iter_device_batches(self, device=None, *, prefetch: int = 2,
                            decode_fn=None, name: Optional[str] = None,
                            **kw):
        """Device batches with background prefetch ON BY DEFAULT: host
        decode and the host-to-device copy run on a prefetch thread
        through a ``prefetch``-deep buffer, so batch N+1's copy overlaps
        step N (:class:`ray_tpu_torch.train.ingest.DevicePrefetcher`).
        ``device`` is a ``torch.device``, its name or an object that
        carries one (a ``ShardedTrainer``); None is ``cuda``, where JAX
        takes a sharding. Remaining kwargs go to :meth:`iter_batches`;
        ``drop_last`` defaults to True HERE: a ragged tail batch would
        give the train step another shape."""
        from ray_tpu_torch.train.ingest import DevicePrefetcher

        kw.setdefault("drop_last", True)
        return DevicePrefetcher(self.iter_batches(**kw), device,
                                depth=prefetch, decode_fn=decode_fn,
                                name=name or self._name or "train")

    def iter_rows(self):
        return self._ds.iter_rows()

    def materialize(self):
        return self._ds.materialize()

    def _local(self) -> "DataIterator":
        """This shard with its blocks fetched into it (what crosses to a
        train worker process)."""
        return DataIterator(self._ds._local(), name=self._name)

    def nbytes(self) -> int:
        """Bytes of the blocks this iterator holds itself (a local
        shard's)."""
        return sum(B.nbytes(h) for h in self._ds._block_refs
                   if isinstance(h, dict))


# ----------------------------------------------------------------- creation
def from_items(items: Sequence[Any], *, parallelism: int = 8) -> Dataset:
    items = list(items)
    k = max(1, min(parallelism, len(items) or 1))
    chunk = (len(items) + k - 1) // k
    refs = [ray_tpu_torch.put(B.from_rows(items[i:i + chunk]))
            for i in builtins.range(0, max(len(items), 1), chunk)]
    return Dataset(refs)


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    k = max(1, min(parallelism, n or 1))
    sizes = [n // k + (1 if i < n % k else 0) for i in builtins.range(k)]
    refs, off = [], 0
    for s in sizes:
        refs.append(ray_tpu_torch.put(
            {"id": np.arange(off, off + s, dtype=np.int64)}))
        off += s
    return Dataset(refs)


def from_numpy(arr: np.ndarray, *, parallelism: int = 8,
               column: str = "data") -> Dataset:
    """Multi-dim arrays become tensor columns: ``iter_batches`` yields
    the exact [N, d1, ...] ndarray back."""
    parts = np.array_split(arr, max(1, parallelism))
    refs = [ray_tpu_torch.put(B.from_batch({column: p}))
            for p in parts if len(p)]
    return Dataset(refs)


def from_pandas(df) -> Dataset:
    return Dataset([ray_tpu_torch.put(B.from_pandas(df))])


def from_arrow(table) -> Dataset:
    """A pyarrow Table as one numpy block (needs pyarrow, which the
    card's machine lacks)."""
    from ray_tpu_torch.data.datasource import from_arrow_table

    return Dataset([ray_tpu_torch.put(from_arrow_table(table))])


def _expand_paths(paths) -> List[str]:
    """Files from a path / glob / directory / list thereof."""
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, fnames in os.walk(p):
                dirs.sort()  # deterministic traversal order
                files.extend(os.path.join(root, f) for f in sorted(fnames))
            continue
        matches = sorted(glob_mod.glob(p))
        files.extend(matches if matches else [p])
    return files


# File readers: thin wrappers over the Datasource interface (reference:
# ``python/ray/data/read_api.py`` delegating to datasource classes).
def read_parquet(paths, *, parallelism: int = 8) -> Dataset:
    from ray_tpu_torch.data.datasource import (ParquetDatasource,
                                               read_datasource)

    return read_datasource(ParquetDatasource(paths),
                           parallelism=parallelism)


def read_csv(paths, *, parallelism: int = 8) -> Dataset:
    from ray_tpu_torch.data.datasource import CSVDatasource, read_datasource

    return read_datasource(CSVDatasource(paths), parallelism=parallelism)


def read_json(paths, *, parallelism: int = 8) -> Dataset:
    from ray_tpu_torch.data.datasource import JSONDatasource, read_datasource

    return read_datasource(JSONDatasource(paths), parallelism=parallelism)


def read_binary_files(paths, *, include_paths: bool = True,
                      parallelism: int = 8) -> Dataset:
    """One row per file: ``{"bytes": ..., "path": ...}`` (reference:
    ``ray.data.read_binary_files``)."""
    from ray_tpu_torch.data.datasource import (BinaryFilesDatasource,
                                               read_datasource)

    return read_datasource(BinaryFilesDatasource(paths, include_paths),
                           parallelism=parallelism)


def read_text(paths, *, parallelism: int = 8) -> Dataset:
    """One row per line: ``{"text": ...}`` (reference:
    ``ray.data.read_text``)."""
    from ray_tpu_torch.data.datasource import TextDatasource, read_datasource

    return read_datasource(TextDatasource(paths), parallelism=parallelism)
