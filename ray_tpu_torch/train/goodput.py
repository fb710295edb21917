"""Training-path observability: the goodput ledger and straggler detection
(port of ``ray_tpu/train/goodput.py``).

The serve plane answers "where did this request's latency go"; this
module answers the training twin — "where did the last hour of
card time go, and which rank is dragging the mesh".

**Goodput ledger.** :class:`GoodputLedger` partitions one training
attempt's wall clock into named, mutually exclusive components. The
model is a *host-state* partition: at any instant the training host is
either

* ``step`` — dispatching steps / free-running ahead of the device (the
  device is doing productive compute; with ``sync_every`` steps in
  flight the host's bookkeeping overlaps device work, so this residual
  is the honest "productive" bucket),
* ``input_stall`` — blocked on an empty device-prefetch buffer
  (:class:`~ray_tpu_torch.train.ingest.DevicePrefetcher` notes its measured
  consumer-side stall here),
* ``sync`` — blocked in the windowed metric fetch
  (:class:`~ray_tpu_torch.train.loop.AsyncStepLoop` notes its
  one-copy metric fetch wall time; in a per-step-sync loop this is where
  device compute *drains*, so a large ``sync`` fraction under
  ``sync_every=1`` reads "raise sync_every", not "the device is idle"),
* ``ckpt_block`` — blocked in the checkpoint plane's device→host
  snapshot (the only synchronous leg of ``save_async``; the
  ``ray_tpu_ckpt_block_ms`` histogram existed but was unattributed), or
* ``recovery`` — the worker-side restore leg of an elastic recovery
  (``CheckpointPlane.restore`` wall time). The full
  detection→teardown→re-acquire→re-form→restore→first-step recovery is
  controller-side and lands in ``ray_tpu_train_recovery_seconds`` and
  the ``train.recovery`` trace; the ledger's slice is the part that
  spends *this attempt's* wall clock.

``step`` is computed as the residual (wall − every measured non-step
component), so the components sum to the measured attempt wall time BY
CONSTRUCTION — and the invariant is still a real tripwire: any
double-counted interval (e.g. an input stall also booked as sync)
drives ``step`` negative and fails the 1% acceptance test.

Each worker session owns one ledger (``_Session.ledger``); instrumented
sites attribute through :func:`note_ambient`, which resolves the active
session's ledger (no-op outside a training session, e.g. in benches
that pass an explicit ledger instead). The controller reads snapshots
off the ``poll()`` path and feeds ``ray_tpu_train_goodput_seconds_total
{component}`` / ``ray_tpu_train_goodput_fraction{component}``.

**Straggler detection.** Every ``session.report`` records the step's
per-rank wall time (dispatch→report). The controller merges them into
fixed-size step windows; when every rank has moved past window *w* the
window is scored: a rank whose mean step time exceeds
``RAY_TPU_STRAGGLER_FACTOR`` (default 2.0) times the window median
(``median_low`` — robust down to world size 2) for
``RAY_TPU_STRAGGLER_WINDOWS`` (default 3) CONSECUTIVE windows is
flagged: published to the controller store's ``__train__`` KV, surfaced as
``ray_tpu_train_straggler{rank}``, and logged by the controller. A rank
that drops back under the factor is cleared. Window size is
``RAY_TPU_STRAGGLER_WINDOW_STEPS`` (default 4) steps.
"""

from __future__ import annotations

import os
import statistics
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = ["COMPONENTS", "GoodputLedger", "StragglerDetector",
           "current_ledger", "note_ambient"]

# Badput components a site can note; "step" is always the residual.
COMPONENTS = ("input_stall", "sync", "ckpt_block", "recovery")


class GoodputLedger:
    """Wall-clock partition of one training attempt (see module doc)."""

    def __init__(self, name: str = "train"):
        self.name = name
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._closed_wall: Optional[float] = None
        self._acc: Dict[str, float] = {c: 0.0 for c in COMPONENTS}

    def note(self, component: str, seconds: float) -> None:
        """Attribute ``seconds`` of wall time to a non-step component."""
        if component not in self._acc:
            raise ValueError(
                f"unknown goodput component {component!r} "
                f"(known: {COMPONENTS}; 'step' is the residual)")
        if seconds > 0:
            with self._lock:
                self._acc[component] += seconds

    @contextmanager
    def component(self, name: str):
        """Measure a block and attribute it: ``with ledger.component(
        "input_stall"): batch = next(it)``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note(name, time.perf_counter() - t0)

    def close(self) -> None:
        """Freeze the wall clock (the attempt ended)."""
        with self._lock:
            if self._closed_wall is None:
                self._closed_wall = time.perf_counter() - self._t0

    def wall_s(self) -> float:
        with self._lock:
            return (self._closed_wall
                    if self._closed_wall is not None
                    else time.perf_counter() - self._t0)

    def snapshot(self) -> Dict[str, Any]:
        """``{"wall_s", "components": {step, input_stall, sync,
        ckpt_block, recovery}}`` — components sum to ``wall_s`` exactly
        (``step`` is the residual and may go NEGATIVE if a site
        double-books an interval; tests treat that as corruption)."""
        with self._lock:
            wall = (self._closed_wall
                    if self._closed_wall is not None
                    else time.perf_counter() - self._t0)
            comps = dict(self._acc)
        comps["step"] = wall - sum(comps.values())
        return {"wall_s": wall, "components": comps}

    def fractions(self) -> Dict[str, float]:
        snap = self.snapshot()
        wall = max(snap["wall_s"], 1e-9)
        return {c: v / wall for c, v in snap["components"].items()}


# ------------------------------------------------------- ambient ledger
def current_ledger() -> Optional[GoodputLedger]:
    """The active training session's ledger, if this thread is inside
    one (``TrainWorker.run`` sets the session contextvar)."""
    from ray_tpu_torch.train import session as session_mod

    s = session_mod._get_session(strict=False)
    return None if s is None else getattr(s, "ledger", None)


def note_ambient(component: str, seconds: float) -> None:
    """Attribute time to the ambient session ledger; no-op outside a
    training session. Instrumented sites (ingest prefetcher, checkpoint
    plane) call this so raw/bench usage costs one contextvar read."""
    led = current_ledger()
    if led is not None:
        led.note(component, seconds)


# --------------------------------------------------- straggler detection
def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


class StragglerDetector:
    """Per-window rank-skew scoring over per-rank step times.

    ``observe(rank, step, dur, ts)`` accumulates one rank's step wall
    time; it returns the list of window summaries that COMPLETED with
    this observation (a window completes when every rank has moved past
    it — scoring earlier would compare a finished rank against a
    straggler's partial window). Each summary carries the per-rank
    means, the window median (``median_low``), the max skew, and the
    flag transitions the controller must publish."""

    def __init__(self, world_size: int, *,
                 factor: Optional[float] = None,
                 consecutive: Optional[int] = None,
                 window_steps: Optional[int] = None):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self.world = world_size
        self.factor = (factor if factor is not None
                       else _env_float("RAY_TPU_STRAGGLER_FACTOR", 2.0))
        self.consecutive = (consecutive if consecutive is not None
                            else _env_int("RAY_TPU_STRAGGLER_WINDOWS", 3))
        self.window_steps = (
            window_steps if window_steps is not None
            else _env_int("RAY_TPU_STRAGGLER_WINDOW_STEPS", 4))
        if self.window_steps < 1 or self.consecutive < 1:
            raise ValueError("window_steps and consecutive must be >= 1")
        # window -> rank -> [durs]; wall-ts bounds per window.
        self._durs: Dict[int, Dict[int, List[float]]] = {}
        self._bounds: Dict[int, List[float]] = {}
        self._max_window: Dict[int, int] = {}
        self._streak: Dict[int, int] = {r: 0 for r in range(world_size)}
        self._next_eval: Optional[int] = None
        self.flagged: Dict[int, Dict[str, Any]] = {}
        self.windows_scored = 0

    def observe(self, rank: int, step: int, dur: float,
                ts: Optional[float] = None) -> List[Dict[str, Any]]:
        if rank < 0 or rank >= self.world:
            return []
        w = int(step) // self.window_steps
        self._durs.setdefault(w, {}).setdefault(rank, []).append(
            float(dur))
        if ts is not None:
            start = float(ts) - float(dur)
            b = self._bounds.setdefault(w, [start, float(ts)])
            b[0] = min(b[0], start)
            b[1] = max(b[1], float(ts))
        prev = self._max_window.get(rank)
        self._max_window[rank] = w if prev is None else max(prev, w)
        if self._next_eval is None:
            self._next_eval = w
        out: List[Dict[str, Any]] = []
        # A window is scoreable once EVERY rank has reported from a
        # LATER window (all its steps for the window are in).
        while (len(self._max_window) == self.world
               and min(self._max_window.values()) > self._next_eval):
            summary = self._evaluate(self._next_eval)
            if summary is not None:
                out.append(summary)
            self._next_eval += 1
        return out

    def _evaluate(self, w: int) -> Optional[Dict[str, Any]]:
        per_rank = self._durs.pop(w, {})
        bounds = self._bounds.pop(w, None)
        if len(per_rank) < self.world:
            # A rank skipped the window entirely (restore fast-forwarded
            # its step counter) — nothing comparable to score.
            return None
        means = {r: sum(d) / len(d) for r, d in per_rank.items()}
        med = statistics.median_low(sorted(means.values()))
        newly, cleared = [], []
        for r, m in means.items():
            slow = med > 0 and m > self.factor * med
            if slow:
                self._streak[r] = self._streak.get(r, 0) + 1
                if (self._streak[r] >= self.consecutive
                        and r not in self.flagged):
                    self.flagged[r] = {
                        "rank": r, "window": w, "mean_s": m,
                        "median_s": med, "skew": m / med,
                        "streak": self._streak[r], "ts": time.time()}
                    newly.append(r)
            else:
                self._streak[r] = 0
                if r in self.flagged:
                    del self.flagged[r]
                    cleared.append(r)
        self.windows_scored += 1
        return {
            "window": w,
            "means": means,
            "median_s": med,
            "max_skew": (max(means.values()) / med) if med > 0 else 0.0,
            "start_ts": bounds[0] if bounds else None,
            "end_ts": bounds[1] if bounds else None,
            "newly_flagged": newly,
            "cleared": cleared,
            "flagged": sorted(self.flagged),
        }
