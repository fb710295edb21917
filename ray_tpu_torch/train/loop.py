"""Async step pipelining: dispatch-ahead training with windowed syncs
(port of ``ray_tpu/train/loop.py``).

The synced loop fetches the loss every step — one device→host copy per
step, and the card's queue drains while the host formats a float. This
loop keeps up to ``sync_every`` steps dispatched and pulls their metrics
off the card in one windowed fetch (one copy of every pending metric,
stacked), so the card runs back-to-back steps while the host stays out
of the hot path (the training-side analog of the buffered serve engine's
``sync_every``).

Each window's measured wall time, over its steps, goes to the trainer's
``train_step`` program (:meth:`~ray_tpu_torch._private.cuda_monitor.
InstrumentedProgram.note_execution`): the achieved FLOP/s and MFU gauges
against the step's counted cost, as the JAX package feeds its compiled
step's.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch


class AsyncStepLoop:
    """Drive ``trainer.train_step`` with at most ``sync_every`` un-synced
    steps; metrics land in ``history`` (host floats) at each window sync.

    Exactly the same kernels run as in a synced loop — only the fetch
    cadence changes, so losses are bit-identical to per-step syncing.
    """

    def __init__(self, trainer, state, *, sync_every: int = 4,
                 name: str = "async_loop", ledger=None):
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self.trainer = trainer
        self.state = state
        self.sync_every = sync_every
        self.name = name
        # Goodput attribution: the windowed fetch's host-blocked wall
        # time is the ledger's "sync" component — explicit ledger wins,
        # else the ambient training session's (resolved per sync).
        self._ledger = ledger
        self.history: List[Dict[str, float]] = []
        self.steps = 0
        self._pending: List[Dict[str, Any]] = []
        self._window_t0: Optional[float] = None
        self._window_wall_s = 0.0
        self._synced_steps = 0

    # ------------------------------------------------------------- steps
    def step(self, batch) -> None:
        """Dispatch one train step; syncs only at window boundaries."""
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        self.state, metrics = self.trainer.train_step(self.state, batch)
        self._pending.append(metrics)
        self.steps += 1
        if len(self._pending) >= self.sync_every:
            self.sync()

    def sync(self) -> None:
        """Fetch every pending metrics dict in one copy (it blocks until
        the dispatched steps complete)."""
        if not self._pending:
            return
        from ray_tpu_torch._private import metrics_defs as mdefs
        from ray_tpu_torch.train import goodput

        n = len(self._pending)
        t_fetch = time.perf_counter()
        keys = list(self._pending[0])
        values = [torch.as_tensor(m[k]).detach().reshape(())
                  for m in self._pending for k in keys]
        device = next((v.device for v in values if v.device.type != "cpu"),
                      torch.device("cpu"))
        flat = torch.stack([v.to(device, torch.float64)
                            for v in values]).cpu()
        now = time.perf_counter()
        # "sync" = host blocked in the windowed fetch. Under sync_every=1
        # this is where device compute drains (the honest reading is
        # "syncing too often"), with steps in flight it is pure overhead.
        ledger = self._ledger or goodput.current_ledger()
        if ledger is not None:
            ledger.note("sync", now - t_fetch)
        wall = now - self._window_t0
        # Windows are CONTIGUOUS: the next one starts here, not at its
        # first step(), so the stall fetching a window's first batch —
        # or any host work between windows — lands inside a window under
        # the direct ``loop.step(batch)`` spelling too.
        self._window_t0 = now
        self._window_wall_s += wall
        self._synced_steps += n
        per_step = wall / n
        step_prog = getattr(self.trainer, "_step", None)
        if hasattr(step_prog, "note_execution"):
            # Dispatch of the window's first step to the fetch, split over
            # its steps: an input stall inside the window inflates it, so
            # MFU errs low, never high.
            step_prog.note_execution(per_step)
        tags = {"trainer": self.name}
        values = flat.tolist()
        for i in range(n):
            mdefs.TRAIN_STEP_SECONDS.observe(per_step, tags=tags)
            row = values[i * len(keys):(i + 1) * len(keys)]
            self.history.append(dict(zip(keys, row)))
        self._pending.clear()

    def run(self, batches: Iterable[Any],
            max_steps: Optional[int] = None) -> Tuple[Any, List[Dict]]:
        """Consume ``batches`` (host iterator or a
        :class:`~ray_tpu_torch.train.ingest.DevicePrefetcher`) to
        exhaustion or ``max_steps``, then drain the window. Returns
        (state, history)."""
        it = iter(batches)
        while True:
            # Stamp the very first window before pulling the first batch
            # so its fetch stall is measured; sync() keeps later windows
            # contiguous from there.
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            self.step(batch)
            if max_steps is not None and self.steps >= max_steps:
                break
        return self.finish()

    def finish(self) -> Tuple[Any, List[Dict]]:
        self.sync()
        return self.state, self.history

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        return {
            "steps": float(self.steps),
            "synced_steps": float(self._synced_steps),
            "window_wall_s": self._window_wall_s,
            "step_s": (self._window_wall_s / self._synced_steps
                       if self._synced_steps else 0.0),
            "pending": float(len(self._pending)),
        }
