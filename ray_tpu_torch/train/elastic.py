"""Elastic training control: failure taxonomy, resize signals, budgets
(port of ``ray_tpu/train/elastic.py``).

Reference blueprint: Ray Train v2 elastic worker groups + the GCS
fault-tolerance machinery (``train/v2/_internal/execution/controller``):
the controller classifies every attempt-ending exception into a *cause*
and charges the matching budget — infrastructure loss is routine and
retried generously, user bugs are governed by ``FailureConfig`` exactly
as before, and genuinely fatal conditions (repeated NaN, an environment
that cannot bootstrap) never burn a retry.

========================  ==============================================
cause                      budget / behavior
========================  ==============================================
``worker_lost``            worker process/node death — ``RAY_TPU_MAX_RESTARTS``
                           with exponential backoff
``hang``                   step watchdog or lapsed heartbeats — same budget
``preemption``             cooperative ``PreemptedError`` after a JIT save —
                           ``RAY_TPU_MAX_PREEMPTIONS``, no backoff
``resize``                 worker-set grow/shrink request — ``RAY_TPU_MAX_RESIZES``,
                           no backoff
``user``                   worker-surfaced task error (the train loop
                           raised) — ``FailureConfig.max_failures``
                           (unchanged semantics)
``fatal``                  repeated NaN, process-group bootstrap failure,
                           or a controller-side defect — no retry, no
                           budget consumed
========================  ==============================================

Resize signals ride the preemption channel
(``ray_tpu_torch/checkpoint/preempt.py``: notices through the trainer
controller's store): :func:`request_resize` publishes a notice carrying
``world_target``, and a ``kind="capacity"`` notice is a grow hint.
:class:`ResizeGuard` latches both for the controller.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import exceptions

logger = logging.getLogger(__name__)

# Failure causes (the `cause` tag on ray_tpu_train_restarts_total).
WORKER_LOST = "worker_lost"
HANG = "hang"
PREEMPTION = "preemption"
RESIZE = "resize"
USER = "user"
FATAL = "fatal"


class ResizeRequested(exceptions.RayTpuError):
    """Internal control-flow signal: the worker set should be re-formed at
    ``world_target`` workers (raised by the controller's drive loop when a
    resize hint lands or capacity for a grow-back appears)."""

    def __init__(self, world_target: int, reason: str = "resize requested"):
        self.world_target = int(world_target)
        self.reason = reason
        super().__init__(f"{reason}: world_target={world_target}")


def classify_failure(exc: BaseException) -> str:
    """Map an attempt-ending exception to its failure cause."""
    if isinstance(exc, ResizeRequested):
        return RESIZE
    if isinstance(exc, exceptions.PreemptedError):
        return PREEMPTION
    if isinstance(exc, (exceptions.ActorDiedError,
                        exceptions.WorkerCrashedError,
                        exceptions.NodeDiedError,
                        exceptions.ActorUnavailableError)):
        return WORKER_LOST
    if isinstance(exc, exceptions.WorkerHangError):
        return HANG
    if isinstance(exc, (exceptions.NaNLossError,
                        exceptions.DistributedBootstrapError)):
        return FATAL
    if isinstance(exc, exceptions.RayTaskError):
        # The worker wraps the user's train loop failing;
        # FailureConfig.max_failures governs it.
        return USER
    # Anything else reaching the controller is a controller/framework
    # defect or an I/O failure in the drive loop — retrying would replay
    # it, and billing it to the user's budget would mislabel it.
    return FATAL


def request_resize(num_workers: int, reason: str = "operator-resize",
                   store_address: Optional[str] = None) -> Dict[str, Any]:
    """Ask running elastic trainers to re-form at ``num_workers`` workers.

    Publishes on the preemption channel (through the trainer's store
    when this process is attached to one, as its workers are, or
    ``store_address``; synchronously to this process's listeners
    otherwise). Trainers
    latch it through their :class:`ResizeGuard`, tear the group down at a
    step boundary, and restart from the newest committed manifest at the
    new world size."""
    from ray_tpu_torch._private import events as _events
    from ray_tpu_torch.checkpoint.preempt import publish_preempt

    resize_ev = _events.emit("train.resize",
                             world_target=int(num_workers), reason=reason)
    return publish_preempt(reason=reason, store_address=store_address,
                           world_target=int(num_workers), cause=resize_ev)


class RecoveryTrace:
    """Controller-side bookkeeping for ONE elastic recovery, emitted as
    a connected trace when the restarted attempt's first report lands.

    The controller walks the restart path phase by phase — teardown
    (the worker processes killed), backoff sleep, re-acquire (worker
    processes spawned + backend ``on_start`` = the process group
    re-formed) — and :meth:`close` turns them into retrospective
    spans: one ``train.recovery`` parent whose children tile its
    duration exactly, the tail (``restore_first_step``: restore from
    the newest intact manifest through the first post-restore report)
    being the residual. The parent's duration is the SAME value
    observed into ``ray_tpu_train_recovery_seconds``, so the trace and
    the metric can never drift apart."""

    def __init__(self, trace_id: str, parent_span_id: str, run: str,
                 cause: str, attempt: int, cause_event: str = ""):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.run = run
        self.cause = cause
        self.attempt = attempt
        # Flight-recorder id of the event that killed the attempt (a
        # preemption notice id off PreemptedError.notice, or a chaos
        # injection's SimulatedProcessDeath.event_id), linking this
        # recovery into the cluster-wide causal chain.
        self.cause_event = cause_event
        self.t0_wall = time.time()
        self.phases: List[Tuple[str, float]] = []  # ordered (name, dur)

    def phase(self, name: str, dur_s: float) -> None:
        self.phases.append((name, max(float(dur_s), 0.0)))

    @contextmanager
    def timed_phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase(name, time.perf_counter() - t0)

    def close(self, recovery_s: float,
              outcome: str = "recovered") -> str:
        """Emit the recovery span tree; returns the parent span id
        ('' with tracing off). ``outcome="failed"`` marks a recovery
        whose restarted attempt died before its first report (the next
        recovery's trace then covers the follow-up)."""
        from ray_tpu_torch._private import events as _events
        from ray_tpu_torch.util import tracing

        # The flight event goes out unconditionally (BEFORE the tracing
        # gate): recovery cause + outcome must reach the recorder even
        # with span tracing off.
        cause = self.cause_event
        if not cause and self.cause == PREEMPTION:
            cause = _events.latest_event_id(["preempt.notice"])
        _events.emit("train.recovery", cause=cause,
                     subject={"run": self.run},
                     recovery_cause=self.cause, attempt=self.attempt,
                     outcome=outcome, recovery_s=float(recovery_s))
        if not tracing.enabled():
            return ""
        rid = tracing.gen_id()
        tracing.emit_span(
            "train.recovery", trace_id=self.trace_id, ts=self.t0_wall,
            dur=recovery_s, span_id=rid,
            parent_span_id=self.parent_span_id, kind="train",
            run=self.run, cause=self.cause, attempt=self.attempt,
            outcome=outcome)
        cursor, used = self.t0_wall, 0.0
        for name, dur in self.phases:
            dur = min(dur, max(recovery_s - used, 0.0))
            tracing.emit_span(
                f"train.recovery.{name}", trace_id=self.trace_id,
                ts=cursor, dur=dur, parent_span_id=rid, kind="train",
                run=self.run)
            cursor += dur
            used += dur
        tracing.emit_span(
            "train.recovery.restore_first_step", trace_id=self.trace_id,
            ts=cursor, dur=max(recovery_s - used, 0.0),
            parent_span_id=rid, kind="train", run=self.run)
        return rid


class ResizeGuard:
    """Controller-side latch for resize/grow hints on the preempt channel.

    Unlike the training-loop :class:`~ray_tpu_torch.checkpoint.preempt.
    PreemptionGuard` (which drives just-in-time saves), this guard only
    *observes*: ``target`` is the most recent explicit world-target ask,
    ``grow_hint`` flips on a capacity notice (so the controller
    re-evaluates feasibility immediately instead of waiting for its
    periodic grow check)."""

    def __init__(self, store_address: Optional[str] = None):
        from ray_tpu_torch.checkpoint import preempt

        self._lock = threading.Lock()
        self._target: Optional[int] = None
        self._grow_hint = False

        def on_notice(notice: Dict[str, Any]) -> None:
            wt = notice.get("world_target")
            with self._lock:
                if wt is not None:
                    self._target = int(wt)
                elif notice.get("kind") == "capacity":
                    self._grow_hint = True

        self._cb = preempt.register_preempt_callback(on_notice)
        preempt.ensure_listener(store_address)

    @property
    def target(self) -> Optional[int]:
        with self._lock:
            return self._target

    def take_grow_hint(self) -> bool:
        with self._lock:
            hint, self._grow_hint = self._grow_hint, False
            return hint

    def clear_target(self, applied: Optional[int] = None) -> None:
        """Drop the latched target once an attempt runs at it (a *newer*
        ask that raced in stays latched)."""
        with self._lock:
            if applied is None or self._target == applied:
                self._target = None

    def close(self) -> None:
        from ray_tpu_torch.checkpoint import preempt

        preempt.unregister_preempt_callback(self._cb)

    def __enter__(self) -> "ResizeGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
