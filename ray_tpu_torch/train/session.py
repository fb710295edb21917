"""Per-worker training session: ``report`` / ``get_context`` /
``get_checkpoint`` (port of ``ray_tpu/train/session.py``).

Reference: ``python/ray/train/_internal/session.py`` — the session is the
channel between the user's ``train_loop_per_worker`` and the controller:
metrics/checkpoints flow out through a queue the controller polls
(reference ``backend_executor.py:585``), and the restore checkpoint flows
in. Each port worker is a process of its own, so a session lives in its
worker process; the JAX package's registry of in-process sessions (which
the controller flags and joins because a killed in-process actor's
thread survives the kill) has no counterpart: the controller kills the
process.
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.goodput import GoodputLedger

_DATA_ITEM = "item 14 (ray_tpu/data over numpy blocks)"


class TrainContext:
    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 local_world_size: int, node_rank: int = 0,
                 experiment_name: str = "", trial_name: str = ""):
        self._world_rank = world_rank
        self._world_size = world_size
        self._local_rank = local_rank
        self._local_world_size = local_world_size
        self._node_rank = node_rank
        self._experiment_name = experiment_name
        self._trial_name = trial_name

    def get_world_rank(self) -> int:
        return self._world_rank

    def get_world_size(self) -> int:
        return self._world_size

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_local_world_size(self) -> int:
        return self._local_world_size

    def get_node_rank(self) -> int:
        return self._node_rank

    def get_experiment_name(self) -> str:
        return self._experiment_name

    def get_trial_name(self) -> str:
        return self._trial_name


class _Session:
    def __init__(self, context: TrainContext,
                 checkpoint: Optional[Checkpoint] = None,
                 run_dir: Optional[str] = None, group_id: str = "",
                 kv=None):
        self.context = context
        self.restore_checkpoint = checkpoint
        self.run_dir = run_dir
        self.group_id = group_id  # worker-group generation (elastic fence)
        # The controller store's checkpoint KV (the JAX package's GCS KV)
        # for this run's checkpoint plane; None is the file system alone.
        self.kv = kv
        self.checkpoint_plane = None  # lazily built, one per session
        self.reports: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        # Cooperative teardown: the controller flips this when it re-forms
        # the group; report() raises WorkerStoppedError so a loop that
        # outlives the teardown unwinds instead of racing the next
        # attempt.
        self.stop = threading.Event()
        # Liveness surfaced through TrainWorker.poll(): progress_ts moves
        # on every report, last_step mirrors the loop's step counter.
        self.progress_ts: float = time.monotonic()
        self.last_step: int = -1
        self.report_seq: int = 0
        # Training-path observability: one goodput ledger per attempt
        # (instrumented sites attribute through goodput.note_ambient);
        # each report also records the step's dispatch→report wall time
        # for the controller's per-window rank-skew / straggler scoring.
        self.ledger = GoodputLedger()
        self.error: Optional[BaseException] = None
        self.result: Any = None


_session_var: contextvars.ContextVar[Optional[_Session]] = \
    contextvars.ContextVar("ray_tpu_train_session", default=None)


def _set_session(session: Optional[_Session]):
    _session_var.set(session)


def _get_session(strict: bool = True) -> Optional[_Session]:
    s = _session_var.get()
    if s is None and strict:
        raise RuntimeError(
            "No training session active. `ray_tpu_torch.train.report()` "
            "and `get_context()` must be called inside "
            "`train_loop_per_worker`.")
    return s


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) to the trainer.

    Reference semantics (``ray.train.report``): all workers should call it at
    the same cadence; only rank-0's checkpoint is persisted by default.

    This is also the per-step boundary the elastic control loop hooks:
    the cooperative stop flag is honored here, and the chaos harness's
    ``train_step`` injection site fires here (kill/slow faults land at a
    step boundary, like a real mid-step host loss would be observed).
    """
    from ray_tpu_torch import exceptions as _exc
    from ray_tpu_torch._private import chaos

    s = _get_session()
    if s.stop.is_set():
        raise _exc.WorkerStoppedError(
            "worker group torn down (elastic restart in progress)")
    step = metrics.get("step")
    if not isinstance(step, int):
        step = s.report_seq
    chaos.inject("train_step", rank=s.context.get_world_rank(), step=step)
    s.report_seq += 1
    # Per-step timeline record: this step's wall time is the gap since
    # the previous report (its "dispatch"); a chaos slow_step delay
    # above lands inside it, exactly like a genuinely slow rank. The
    # record rides the report queue (one report == one step), so the
    # controller's poll merge sees rank-attributed timings for free.
    # The FIRST report's gap runs from session start — user-fn setup,
    # compile, checkpoint restore — not a dispatch→report gap, so
    # it is marked and excluded from rank-skew scoring.
    now_mono = time.monotonic()
    step_dur = now_mono - s.progress_ts
    s.progress_ts = now_mono
    s.last_step = step
    timing = {"step": step, "ts": time.time(), "dur": step_dur}
    if s.report_seq == 1:
        timing["first"] = True
    s.reports.put({"metrics": dict(metrics), "checkpoint": checkpoint,
                   "step_timing": timing})


def get_context() -> TrainContext:
    s = _get_session()
    return s.context


def get_checkpoint() -> Optional[Checkpoint]:
    """Checkpoint to restore from (set when recovering from failure)."""
    s = _get_session()
    return s.restore_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed as ``datasets=`` (the JAX
    package's ``streaming_split`` shards): not ported."""
    from ray_tpu_torch.models.llama import not_ported

    raise not_ported(f"get_dataset_shard({name!r})", _DATA_ITEM)


def get_checkpoint_plane(run: str = "train"):
    """This run's distributed checkpoint plane
    (:class:`ray_tpu_torch.checkpoint.CheckpointPlane`), rooted inside the
    experiment directory and keyed by this worker's rank — every worker
    of one run participates in the same two-phase-commit manifest stream,
    coordinated through the controller's store. Use it for async sharded
    saves, elastic restores, and preemption-time just-in-time
    checkpoints."""
    s = _get_session()
    if s.checkpoint_plane is None:
        if s.run_dir is None:
            raise RuntimeError(
                "this session has no run directory — "
                "get_checkpoint_plane() needs a TorchTrainer-managed run")
        from ray_tpu_torch.checkpoint import CheckpointPlane

        ctx = s.context
        s.checkpoint_plane = CheckpointPlane(
            os.path.join(s.run_dir, "ckpt_plane"), run=run,
            process_index=ctx.get_world_rank(),
            process_count=ctx.get_world_size(), kv=s.kv,
            # Once the controller flags this session for teardown, saves
            # raise WorkerStoppedError: a loop that outlives the teardown
            # writes to the SAME shard paths / 2PC keys as the next
            # attempt when the world size is unchanged.
            fence=s.stop.is_set)
    return s.checkpoint_plane
