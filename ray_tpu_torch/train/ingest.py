"""Training ingest: host→device prefetch with a bounded background buffer
(port of ``ray_tpu/train/ingest.py``).

The train-loop anti-pattern this kills: moving each batch to the card
inside the step loop runs host batch assembly and a synchronous copy
while the card sits idle. :class:`DevicePrefetcher` wraps ANY host batch
iterator (a synthetic generator, a reader) and stages batches onto the
device on a background thread through a bounded double/triple buffer,
so the host→device copy of batch N+1 overlaps the compute of step N
(reference: ``python/ray/train`` ingest over the ``python/ray/data``
streaming executor).

On a card each batch is copied into pinned host memory and then to the
card on a side CUDA stream, behind an event: the consumer's stream waits
on the event before the batch's first use (and the batch's memory is
recorded on the consumer's stream, so the allocator cannot hand it out
while a step still reads it). On the CPU the stage is a plain copy; no
stream stands in for one there.

The target is a ``torch.device`` (or its name) or an object that
carries one (``ShardedTrainer.device``). A trainer on a mesh splits the
batch over its ranks in its own ``train_step`` (``shard_batch``, a
collective every rank calls in the same order): the prefetcher only
places the whole batch on this process's card.

Accounting is first-class: the consumer-side blocked time is the
**input stall** (``ray_tpu_train_input_stall_seconds`` — its sum over
the run divided by wall time is the input-stall fraction), buffer
occupancy is a gauge, and staged bytes feed the data-plane bytes/s
counter.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def _resolve_device(target) -> torch.device:
    """A device, its name, or an object that carries one
    (``ShardedTrainer.device``); None is the port's default (``cuda``,
    which raises without a card)."""
    if target is not None and hasattr(target, "device") and \
            not isinstance(target, (torch.device, str)):
        target = target.device
    if target is None:
        from ray_tpu_torch.models.llama import default_device

        return default_device(None)
    return torch.device(target)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _batch_nbytes(batch) -> int:
    total = 0
    for leaf in _leaves(batch):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif getattr(leaf, "nbytes", None) is not None:
            total += int(leaf.nbytes)
    return total


def _as_tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if not arr.flags.writeable:
        arr = arr.copy()  # torch does not alias a read-only buffer
    return torch.as_tensor(arr)


class DevicePrefetcher:
    """Bounded background host→device staging over a batch iterator.

    One producer thread pulls host batches from ``source``, applies
    ``decode_fn`` (host-side decode/augment), and stages each leaf onto
    ``device`` (pinned memory and a side stream on a card); results
    queue into a ``depth``-bounded buffer (depth=2 is classic double buffering,
    depth=3 absorbs jittery producers). The consumer iterates device
    batches in source order. Exceptions raised by the source or the
    decode propagate to the consumer at the batch position where they
    occurred; ``close()`` (or exhaustion) reclaims the thread — no
    leaked daemon keeps device buffers alive. Tensors the source yields
    are copied, never aliased, so a source may reuse its buffers.
    """

    def __init__(self, source: Iterable[Any], device=None, *,
                 depth: int = 2,
                 decode_fn: Optional[Callable[[Any], Any]] = None,
                 name: str = "train", ledger=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.name = name
        self.depth = depth
        # Goodput attribution: consumer-side stalls land in a ledger —
        # the one passed explicitly (benches/tests), else the ambient
        # training session's (resolved per get; no-op outside one).
        self._ledger = ledger
        self._source = iter(source)
        self._device = _resolve_device(device)
        self._stream = None
        if self._device.type == "cuda":
            # The producer's copies run on this stream; each batch's
            # event orders the consumer's stream after its copy.
            self._stream = torch.cuda.Stream(device=self._device)
        self._decode = decode_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._exhausted = False
        # -- accounting ------------------------------------------------
        self._lock = threading.Lock()
        self._stall_s = 0.0       # consumer blocked on an empty buffer
        self._put_wall_s = 0.0    # producer decode + device_put issue
        self._batches_out = 0
        self._bytes_in = 0
        self._occ_sum = 0.0       # occupancy sampled at each get
        self._started = time.perf_counter()
        self._thread = threading.Thread(
            target=self._produce, daemon=True,
            name=f"rtpu-prefetch-{name}")
        self._thread.start()

    # ----------------------------------------------------------- producer
    def _stage(self, batch):
        """``batch`` on the device: (batch, event or None)."""
        if self._stream is None:
            return _tree_map(lambda x: _as_tensor(x).to(self._device,
                                                        copy=True),
                             batch), None
        with torch.cuda.stream(self._stream):
            out = _tree_map(lambda x: _as_tensor(x).pin_memory().to(
                self._device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _produce(self) -> None:
        from ray_tpu_torch._private import metrics_defs as mdefs

        tags = {"iterator": self.name}
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                if self._decode is not None:
                    batch = self._decode(batch)
                nbytes = _batch_nbytes(batch)
                batch, event = self._stage(batch)
                with self._lock:
                    self._put_wall_s += time.perf_counter() - t0
                mdefs.TRAIN_INGEST_BYTES.inc(nbytes, tags=tags)
                # Bytes ride the queue item and land in stats() at GET
                # time: reset_stats() defines a consumption window, so
                # batches already staged into the warm buffer must count
                # when consumed, not when produced (the monotonic counter
                # above keeps producer-side semantics).
                self._blocking_put(("ok", (batch, event), nbytes))
                mdefs.TRAIN_PREFETCH_OCCUPANCY.set(
                    self._q.qsize() / self.depth, tags=tags)
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            self._blocking_put(("err", e, 0))
            return
        self._blocking_put(("end", _SENTINEL, 0))

    def _blocking_put(self, item) -> None:
        """Bounded put that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # ----------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        from ray_tpu_torch._private import metrics_defs as mdefs

        if self._exhausted or self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        kind, payload, nbytes = self._q.get()
        stall = time.perf_counter() - t0
        tags = {"iterator": self.name}
        mdefs.TRAIN_INPUT_STALL.observe(stall, tags=tags)
        from ray_tpu_torch.train import goodput

        if self._ledger is not None:
            self._ledger.note("input_stall", stall)
        else:
            goodput.note_ambient("input_stall", stall)
        mdefs.TRAIN_PREFETCH_OCCUPANCY.set(
            self._q.qsize() / self.depth, tags=tags)
        with self._lock:
            self._stall_s += stall
            if kind == "ok":
                self._occ_sum += self._q.qsize() / self.depth
                self._batches_out += 1
                self._bytes_in += nbytes
        if kind == "end":
            self._exhausted = True
            self._join()
            raise StopIteration
        if kind == "err":
            self._exhausted = True
            self._join()
            raise payload
        batch, event = payload
        if event is not None:
            # The step's stream waits for the copy; the batch's memory is
            # in use on that stream until the step is done with it.
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for leaf in _leaves(batch):
                leaf.record_stream(current)
        return batch

    # ------------------------------------------------------------ control
    def close(self) -> None:
        """Stop the producer and drop buffered device batches. Safe to
        call mid-stream, twice, or after exhaustion."""
        self._closed = True
        self._stop.set()
        # Drain so a producer blocked on a full buffer can observe stop.
        self._drain()
        self._join()
        # Re-drain after the join: a put already past the stop check may
        # have landed an item between the first drain and thread exit —
        # it would otherwise stay buffered (pinning device memory) since
        # __next__ short-circuits once closed.
        self._drain()
        # Wake a consumer blocked in __next__'s q.get() (close() from
        # another thread): the producer is gone and will never enqueue
        # the end sentinel, so deliver it here. Queue is empty post-
        # drain, so this never blocks; a consumer that checks _closed
        # first simply leaves the sentinel behind — it pins nothing.
        try:
            self._q.put_nowait(("end", _SENTINEL, 0))
        except queue.Full:  # pragma: no cover - post-drain queue is empty
            pass

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def _join(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # Producer wedged inside next(source) (e.g. a slow
                # object-store fetch): it can still land one batch
                # post-drain. Make the leak observable, don't hang.
                import logging

                logging.getLogger(__name__).warning(
                    "prefetcher %r: producer thread still alive after "
                    "5s join — source iterator is blocked; a late "
                    "batch may stay buffered until GC", self.name)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # belt-and-braces: tests assert explicit close
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        """Zero the accounting window (call after warmup so compile-time
        stalls don't pollute the measured stall fraction)."""
        with self._lock:
            self._stall_s = 0.0
            self._put_wall_s = 0.0
            self._batches_out = 0
            self._bytes_in = 0
            self._occ_sum = 0.0
            self._started = time.perf_counter()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            elapsed = max(time.perf_counter() - self._started, 1e-9)
            n = self._batches_out
            return {
                "batches": float(n),
                "input_stall_s": self._stall_s,
                "input_stall_frac": min(self._stall_s / elapsed, 1.0),
                "producer_put_s": self._put_wall_s,
                "bytes_staged": float(self._bytes_in),
                "bytes_per_s": self._bytes_in / elapsed,
                "avg_occupancy": (self._occ_sum / n) if n else 0.0,
                "buffer_depth": float(self.depth),
                "buffered_now": float(self._q.qsize()),
            }


def prefetch_to_device(source: Iterable[Any], device=None, *,
                       depth: int = 2,
                       decode_fn: Optional[Callable[[Any], Any]] = None,
                       name: str = "train") -> DevicePrefetcher:
    """Functional spelling of :class:`DevicePrefetcher` for generator
    pipelines: ``for batch in prefetch_to_device(host_batches,
    trainer): ...``."""
    return DevicePrefetcher(source, device, depth=depth,
                            decode_fn=decode_fn, name=name)


def synthetic_host_batches(batch_size: int, seq_len: int, vocab_size: int,
                           steps: Optional[int] = None, seed: int = 0
                           ) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side (numpy) synthetic LM batches — the prefetcher's input in
    benches and tests (the JAX package's generator: same seed, same
    tokens)."""
    rng = np.random.default_rng(seed)
    produced = 0
    while steps is None or produced < steps:
        tokens = rng.integers(0, vocab_size, (batch_size, seq_len),
                              dtype=np.int32)
        yield {"tokens": tokens, "mask": np.ones_like(tokens)}
        produced += 1
