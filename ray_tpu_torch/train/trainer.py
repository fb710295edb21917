"""TorchTrainer: the entry point for distributed training (port of
``ray_tpu/train/trainer.py``'s ``JaxTrainer``).

Reference: ``train/torch/torch_trainer.py:11`` + ``DataParallelTrainer``
(``train/data_parallel_trainer.py``) + the controller loop of
``train/v2/_internal/execution/controller/controller.py:85``. The fit loop:
start worker group → run ``train_loop_per_worker`` on every worker → poll the
session queues for reported metrics/checkpoints → persist checkpoints (top-k)
→ on worker failure, restart the group from the latest checkpoint while
``FailureConfig.max_failures`` allows (reference ``backend_executor.py:705``).

Elastic fault tolerance (reference: Train v2 elastic worker groups): every
attempt-ending exception is classified (``ray_tpu/train/elastic.py``) and
charged to the matching budget —

* **worker_lost / hang** (worker process death, lapsed heartbeats, step-watchdog
  timeout): retried under ``RAY_TPU_MAX_RESTARTS`` with exponential
  backoff (``RAY_TPU_RESTART_BACKOFF_S`` base, doubling per consecutive
  zero-progress attempt, capped at ``RAY_TPU_RESTART_BACKOFF_MAX_S``);
* **preemption**: ``RAY_TPU_MAX_PREEMPTIONS``, immediate restart;
* **resize** (world-target hints on the preemption channel, or a
  grow-back opening detected via the periodic ``RAY_TPU_GROW_CHECK_S``
  feasibility probe / a capacity notice): ``RAY_TPU_MAX_RESIZES``,
  immediate restart at the new world size;
* **user** exceptions: ``FailureConfig.max_failures``, unchanged;
* **fatal** (repeated-NaN loss, process-group bootstrap failure): the
  run errors out without consuming any retry budget.

Each restart re-acquires workers (fewer or more), re-forms the mesh at the
new world size (the loop reads ``get_context().get_world_size()``), and
resumes from the newest committed checkpoint-plane manifest. Every
recovery is appended to ``TorchTrainer.recovery_log`` and mirrored to the
``ray_tpu_train_restarts_total{cause}`` / ``ray_tpu_train_world_size`` /
``ray_tpu_train_recovery_seconds`` metrics.

Training-path observability (the train-side twin of the serve request
plane, ``ray_tpu/train/goodput.py``):

* **goodput ledger** — every attempt's wall clock, partitioned into
  step / input_stall / sync / ckpt_block / recovery worker-side;
  controller differences rank-0 snapshots into
  ``ray_tpu_train_goodput_seconds_total{component}`` and keeps exact
  per-attempt entries in ``TorchTrainer.goodput_log``;
* **per-rank step timelines** — each report carries its step's wall
  time; the controller merges them into fixed-size windows, feeds
  ``ray_tpu_train_rank_step_seconds{rank}``, and flags stragglers
  (``ray_tpu_train_straggler{rank}``, the store's ``__train__`` KV, log);
* **one connected trace per run** (``RAY_TPU_TRACING=1``) —
  ``train.run`` → ``train.attempt`` → ``train.step_window`` spans plus
  a ``train.recovery`` tree per elastic recovery whose duration equals
  the recovery metric.

The controller hosts one ``TCPStore`` a run, on its host's address as
the cluster runtime knows it (loopback without a cluster): the workers'
heartbeats, the checkpoint plane's commit records, the straggler records
and the preemption channel go through it (the JAX package's GCS KV and
pubsub). On a cluster the workers are actors of the cluster runtime and
capacity is the cluster's available resources, as JAX's; otherwise it
is the host's: visible cards over ``gpus_per_worker`` with ``use_gpu``,
else CPUs over ``cpus_per_worker``. The train loop crosses
to the worker processes by reference, so it must be a module-level
function. ``datasets={name: Dataset}`` gives each rank a disjoint
``streaming_split`` shard (``train.get_dataset_shard(name)``): the
controller executes every attempt's shards and ships each rank's blocks
with its run call, where JAX's workers stream theirs from the object
store. Each attempt's formed world goes into the process's
``internal_kv`` (``world/<run>`` under ``__train__``, marked
``run_ended`` when the run ends), where the chip-pool arbiter confirms a
handoff (:class:`~ray_tpu_torch.autoscaler.arbiter.TrainWorkload`). Not
ported: the ``ray-tpu trace train`` CLI (item 18b).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import math
import os
import pickle
import tempfile
import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional

import torch.distributed as dist

from ray_tpu_torch import exceptions
from ray_tpu_torch.checkpoint import preempt
from ray_tpu_torch.train import elastic, goodput
from ray_tpu_torch.train.backend_executor import (
    TRAIN_KV_NS,
    BackendExecutor,
    TorchBackend,
    visible_cards,
)
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.goodput import _env_float, _env_int
from ray_tpu_torch.train.storage import local_path

logger = logging.getLogger(__name__)

# Seconds between the drive loop's polls of the workers (the JAX
# package's ``ray_tpu.wait`` timeout).
POLL_S = 0.02


class ControllerState:
    """Controller lifecycle states (reference: Train v2 controller state
    machine, ``train/v2/_internal/execution/controller/controller.py:85``)."""

    INITIALIZING = "INITIALIZING"
    SCHEDULING = "SCHEDULING"
    RUNNING = "RUNNING"
    RESTARTING = "RESTARTING"
    FINISHED = "FINISHED"
    ERRORED = "ERRORED"


def _available() -> Dict[str, float]:
    """What can be given to workers (JAX's ``available_resources()``): on
    a cluster, the cluster's available resources; else this host's CPUs
    and the cards no serve replica or train worker holds a share of."""
    import torch

    from ray_tpu_torch.runtime.cluster_replica import cluster_core
    from ray_tpu_torch.runtime.controller import CARDS

    core = cluster_core()
    if core is not None:
        return {"CPU": 0.0, "GPU": 0.0, **core.available_resources()}
    gpus = CARDS.free_cards() if torch.cuda.is_available() else 0
    return {"CPU": float(os.cpu_count() or 1), "GPU": float(gpus)}


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend: Optional[TorchBackend] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        try:
            pickle.dumps(train_loop_per_worker)
        except Exception as e:  # noqa: BLE001 — any pickling failure
            raise ValueError(
                f"train_loop_per_worker {train_loop_per_worker!r} cannot "
                f"cross to the worker processes ({e}): define it at "
                f"module level of an importable module") from e
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend = backend
        self.resume_from_checkpoint = resume_from_checkpoint
        # Train ingest (reference: DataParallelTrainer datasets= +
        # get_dataset_shard): {name: Dataset}, split per attempt.
        self.datasets = datasets
        # Bytes of blocks shipped to each rank, the last attempt's.
        self.dataset_bytes: List[int] = []
        self.controller_state = ControllerState.INITIALIZING
        self.state_history: List[str] = [ControllerState.INITIALIZING]
        # One entry per elastic recovery: cause, next world size, planned
        # backoff, budget line, and (once the next attempt reports) the
        # failure→first-report recovery time.
        self.recovery_log: List[Dict[str, Any]] = []
        self._failure_ts: Optional[float] = None
        self._attempt_reported = False
        # Training-path observability state: one goodput entry per
        # attempt ({attempt, world, wall_s, components, per_rank}),
        # currently-flagged straggler ranks, and the run trace ids.
        self.goodput_log: List[Dict[str, Any]] = []
        self.stragglers: set = set()
        self._trace_id = ""
        self._run_span = ""
        self._run_name = ""
        self._detector: Optional[goodput.StragglerDetector] = None
        self._pending_recovery: Optional[elastic.RecoveryTrace] = None
        self._ledger_prev: Dict[str, float] = {}
        self._last_ledgers: List[Dict[str, Any]] = []
        self._kv = None  # the run's store, __train__ namespace

    def _dataset_shards(self, world: int) -> Optional[List[Dict[str, Any]]]:
        """Each rank's ``{name: DataIterator}`` for this attempt: every
        dataset's ``streaming_split(world, name=name)``, executed here and
        held in the iterators (a worker process cannot read this
        process's store). A restarted attempt splits again at its world
        size, as JAX's controller does every attempt."""
        if not self.datasets:
            return None
        shards: List[Dict[str, Any]] = [{} for _ in range(world)]
        for name, ds in self.datasets.items():
            for rank, it in enumerate(ds.streaming_split(world, name=name)):
                shards[rank][name] = it._local()
        self.dataset_bytes = [sum(it.nbytes() for it in s.values())
                              for s in shards]
        logger.info("train controller: dataset shards of %s bytes shipped "
                    "to ranks 0..%d", self.dataset_bytes, world - 1)
        return shards

    def _set_state(self, state: str) -> None:
        if state != self.controller_state:
            logger.info("train controller: %s -> %s",
                        self.controller_state, state)
            self.controller_state = state
            self.state_history.append(state)

    def _elastic_worker_target(self, explicit: Optional[int] = None) -> int:
        """How many workers to (re)start with: an explicit resize target
        when one is latched, else the full ask when rigid, or whatever the
        host can supply down to ``min_workers`` when elastic (reference:
        Train v2 elastic resizing on recovery)."""
        sc = self.scaling_config
        want = max(int(explicit), 1) if explicit else sc.num_workers
        floor = sc.min_workers if sc.min_workers is not None else want
        floor = min(floor, want)
        if floor >= want:
            return want
        avail = _available()
        # Feasibility is the min over EVERY resource the worker asks for.
        feasible = want
        for key, per in sc.worker_resources().items():
            if per > 0:
                feasible = min(feasible,
                               int(avail.get(key, 0.0) // per))
        return max(min(want, feasible), floor)

    def fit(self) -> Result:
        from ray_tpu_torch._private import metrics_defs as mdefs
        from ray_tpu_torch.util import tracing

        from ray_tpu_torch.runtime.cluster_replica import (cluster_core,
                                                           driver_host)

        if self.scaling_config.use_gpu and cluster_core() is None:
            visible_cards()  # raises on a host with no card
        rc = self.run_config
        storage_path = rc.storage_path or os.path.join(
            tempfile.gettempdir(), "ray_tpu_results")
        name = rc.name or f"TorchTrainer_{int(time.time())}"
        # One trace per run: every attempt, step window, and elastic
        # recovery parents (transitively) to this root span, all
        # carrying run=<name>.
        self._run_name = name
        self._trace_id = tracing.gen_id()
        self._run_span = tracing.gen_id()
        run_t0_wall = time.time()
        exp_dir = os.path.join(local_path(storage_path), name)
        os.makedirs(exp_dir, exist_ok=True)

        ckpt_cfg: CheckpointConfig = rc.checkpoint_config
        manager = CheckpointManager(
            os.path.join(exp_dir, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
            async_write=ckpt_cfg.async_write,
        )

        failure_cfg: FailureConfig = rc.failure_config
        # Per-cause budgets (elastic.py taxonomy). Preemptions/resizes are
        # routine, not failures: each gets its own budget instead of
        # consuming max_failures; infrastructure loss gets the restart
        # budget.
        budgets = {
            elastic.USER: failure_cfg.max_failures,
            elastic.WORKER_LOST: _env_int("RAY_TPU_MAX_RESTARTS", 16),
            elastic.HANG: _env_int("RAY_TPU_MAX_RESTARTS", 16),
            elastic.PREEMPTION: _env_int("RAY_TPU_MAX_PREEMPTIONS", 64),
            elastic.RESIZE: _env_int("RAY_TPU_MAX_RESIZES", 64),
        }
        counts = {k: 0 for k in budgets}
        # worker_lost and hang share the restart budget.
        shared_restart = (elastic.WORKER_LOST, elastic.HANG)
        backoff_base = _env_float("RAY_TPU_RESTART_BACKOFF_S", 1.0)
        backoff_cap = _env_float("RAY_TPU_RESTART_BACKOFF_MAX_S", 30.0)
        backoff_streak = 0

        restore: Optional[Checkpoint] = self.resume_from_checkpoint
        latest_metrics: Optional[Dict[str, Any]] = None
        history: List[Dict[str, Any]] = []
        error: Optional[BaseException] = None
        resize_target: Optional[int] = None
        mtags = {"trainer": type(self).__name__}
        # The run's store: the workers' heartbeats, checkpoint commits,
        # straggler records and the preemption channel.
        store = dist.TCPStore(driver_host(), 0, is_master=True,
                              wait_for_workers=False,
                              timeout=timedelta(seconds=60))
        address = f"{store.host}:{store.port}"
        from ray_tpu_torch.checkpoint.plane import StoreKV

        self._kv = StoreKV(store, TRAIN_KV_NS)
        attached = preempt.attached()
        preempt.attach(address)
        guard = elastic.ResizeGuard(address)
        attempt_idx = 0

        try:
            while True:
                self._set_state(ControllerState.SCHEDULING)
                resize_target = guard.target or resize_target
                target = self._elastic_worker_target(resize_target)
                mdefs.TRAIN_WORLD_SIZE.set(float(target), tags=mtags)
                scaling = self.scaling_config
                if target != scaling.num_workers:
                    logger.warning(
                        "elastic training: starting with %d/%d workers "
                        "(min_workers=%s)", target, scaling.num_workers,
                        scaling.min_workers)
                    scaling = dataclasses.replace(scaling,
                                                  num_workers=target)
                executor = BackendExecutor(scaling, self.backend, store)
                self._attempt_reported = False
                attempt_idx += 1
                attempt_span = tracing.gen_id()
                attempt_t0_wall = time.time()
                # Fresh per-attempt observability state: a new straggler
                # detector at this world size, cleared flags (a restart
                # re-forms the group — old rank identities are void), and
                # a zeroed goodput-delta cursor.
                self._detector = goodput.StragglerDetector(
                    scaling.num_workers)
                for r in sorted(self.stragglers):
                    mdefs.TRAIN_STRAGGLER.set(
                        0.0, tags={**mtags, "rank": str(r)})
                    self._publish_straggler(r, None)
                self.stragglers.clear()
                self._ledger_prev = {}
                self._last_ledgers = []
                try:
                    if self._pending_recovery is not None:
                        # Worker re-acquisition + backend on_start (the
                        # process group re-formed) is one recovery phase
                        # of the trace.
                        with self._pending_recovery.timed_phase(
                                "reacquire"):
                            executor.start()
                    else:
                        executor.start()
                    # Clear the ask this attempt serves — at its exact
                    # value, even when capacity only allowed a smaller
                    # world (an unsatisfiable ask must not re-trigger a
                    # zero-backoff resize loop; the periodic grow probe
                    # finishes the job when capacity appears). A newer
                    # ask that raced in stays latched.
                    guard.clear_target(resize_target
                                       if resize_target is not None
                                       else target)
                    # The group formed at this world: the pool arbiter
                    # confirms a handoff against this record.
                    self._publish_world(scaling.num_workers, attempt_idx)
                    run_futs = executor.start_training(
                        self.train_loop, self.train_loop_config,
                        restore.path if restore else None, run_dir=exp_dir,
                        datasets=self._dataset_shards(scaling.num_workers))
                    self._set_state(ControllerState.RUNNING)
                    self._drive(executor, run_futs, manager, history,
                                guard, scaling.num_workers, resize_target,
                                attempt_span)
                    latest_metrics = (history[-1]["metrics"]
                                      if history else None)
                    error = None
                    executor.shutdown(graceful=True)
                    self._record_goodput(attempt_idx, scaling.num_workers)
                    self._emit_attempt_span(
                        attempt_span, attempt_t0_wall, attempt=attempt_idx,
                        world=scaling.num_workers, outcome="finished")
                    self._set_state(ControllerState.FINISHED)
                    break
                except BaseException as e:  # noqa: BLE001 — classified below
                    # Detection stamp BEFORE teardown: recovery time is
                    # documented as covering group teardown, and the
                    # trace's teardown phase must live inside it.
                    t_detect = time.monotonic()
                    detect_wall = time.time()
                    executor.shutdown()
                    teardown_s = time.monotonic() - t_detect
                    if isinstance(e, (KeyboardInterrupt, SystemExit)):
                        raise
                    cause = elastic.classify_failure(e)
                    # A graceful drain raced a resize ask: workers that
                    # preempt-out while a world-target is latched are the
                    # resize happening, not a preemption.
                    if cause == elastic.PREEMPTION and \
                            guard.target is not None:
                        cause = elastic.RESIZE
                    if isinstance(e, elastic.ResizeRequested):
                        resize_target = e.world_target
                    self._record_goodput(attempt_idx, scaling.num_workers)
                    self._emit_attempt_span(
                        attempt_span, attempt_t0_wall, attempt=attempt_idx,
                        world=scaling.num_workers, outcome=cause)
                    if self._attempt_reported:
                        backoff_streak = 0
                    if cause == elastic.FATAL:
                        error = e
                        latest_metrics = (history[-1]["metrics"]
                                          if history else None)
                        self._set_state(ControllerState.ERRORED)
                        break
                    counts[cause] += 1
                    if cause in shared_restart:
                        used = sum(counts[k] for k in shared_restart)
                        budget = budgets[elastic.WORKER_LOST]
                    else:
                        used = counts[cause]
                        budget = budgets[cause]
                    recoverable = budget < 0 or used <= budget
                    if not recoverable:
                        error = e
                        latest_metrics = (history[-1]["metrics"]
                                          if history else None)
                        self._set_state(ControllerState.ERRORED)
                        break
                    self._set_state(ControllerState.RESTARTING)
                    mdefs.TRAIN_RESTARTS.inc(tags={**mtags,
                                                   "cause": cause})
                    try:
                        # Restore only from fully-persisted dirs; a failed
                        # async persist drops its entry and must not abort
                        # the recovery it exists to serve.
                        manager.flush()
                    except Exception as persist_err:  # noqa: BLE001
                        logger.warning("checkpoint persist failed (%s); "
                                       "restoring from the previous one",
                                       persist_err)
                    restore = manager.latest or restore
                    if cause in (elastic.PREEMPTION, elastic.RESIZE):
                        backoff = 0.0  # the host is going / capacity moved
                    else:
                        backoff = min(
                            backoff_base * math.pow(2, backoff_streak),
                            backoff_cap)
                        backoff_streak += 1
                    # Recovery clock starts at DETECTION (so teardown is
                    # inside it, as the recovery metric documents); the
                    # trace phases accumulated here close into one
                    # train.recovery span tree at the restarted
                    # attempt's first report (_drive). A recovery still
                    # pending here means the RESTARTED attempt died
                    # before reporting: close its trace as failed (span
                    # length = detect A -> detect B) instead of
                    # silently dropping it.
                    if self._pending_recovery is not None and \
                            self._failure_ts is not None:
                        self._pending_recovery.close(
                            t_detect - self._failure_ts,
                            outcome="failed")
                        self._pending_recovery = None
                    self._failure_ts = t_detect
                    # Tie the recovery to the flight event that killed
                    # the attempt: a PreemptedError carries the notice
                    # (whose notice_id IS its event id), a chaos kill
                    # carries the injection's event id.
                    cause_event = ""
                    notice = getattr(e, "notice", None)
                    if isinstance(notice, dict):
                        cause_event = str(notice.get("notice_id", ""))
                    if not cause_event:
                        cause_event = str(getattr(e, "event_id", ""))
                    rec = elastic.RecoveryTrace(
                        self._trace_id, self._run_span, self._run_name,
                        cause, attempt_idx + 1, cause_event=cause_event)
                    rec.t0_wall = detect_wall
                    rec.phase("teardown", teardown_s)
                    self.recovery_log.append({
                        "cause": cause, "error": str(e)[:200],
                        "rank": getattr(e, "failed_rank", None),
                        "backoff_s": backoff,
                        "budget": f"{used}/{budget}",
                        "world_target": resize_target, "ts": time.time()})
                    logger.warning(
                        "training attempt ended (%s: %s); restarting from "
                        "%s in %.2fs (budget %d/%s)", cause, e,
                        restore.path if restore else
                        "the newest committed manifest", backoff, used,
                        budget)
                    if backoff:
                        time.sleep(backoff)
                        rec.phase("backoff", backoff)
                    self._pending_recovery = rec
        finally:
            guard.close()
            # The arbiter must not confirm against a run that ended.
            self._publish_world(0, attempt_idx, ended=True)
            preempt.stop_listener(address)
            preempt.attach(attached)
            # The straggler GAUGE must not report an active straggler
            # for a training run that no longer exists. The KV record
            # stays (ts-stamped, marked ended) as the post-mortem
            # surface, like `TorchTrainer.stragglers`.
            for r in sorted(self.stragglers):
                mdefs.TRAIN_STRAGGLER.set(0.0,
                                          tags={**mtags, "rank": str(r)})
                det = self._detector
                info = (det.flagged.get(r, {}) if det else {})
                self._publish_straggler(
                    r, {**info, "run": self._run_name,
                        "run_ended": True})
            if tracing.enabled():
                tracing.emit_span(
                    "train.run", trace_id=self._trace_id,
                    ts=run_t0_wall, dur=time.time() - run_t0_wall,
                    span_id=self._run_span, kind="train",
                    run=self._run_name, attempts=attempt_idx,
                    outcome=self.controller_state)

        try:
            manager.close()
        except Exception as persist_err:  # noqa: BLE001
            logger.warning("final checkpoint persist failed: %s",
                           persist_err)
        return Result(
            metrics=latest_metrics,
            checkpoint=manager.best,
            path=exp_dir,
            error=error,
            metrics_history=history,
        )

    # ------------------------------------- training-path observability
    def _emit_attempt_span(self, span_id: str, t0_wall: float, *,
                           attempt: int, world: int, outcome: str) -> None:
        from ray_tpu_torch.util import tracing

        if not tracing.enabled():
            return
        tracing.emit_span(
            "train.attempt", trace_id=self._trace_id, ts=t0_wall,
            dur=time.time() - t0_wall, span_id=span_id,
            parent_span_id=self._run_span, kind="train",
            run=self._run_name, attempt=attempt, world=world,
            outcome=outcome)

    def _record_goodput(self, attempt: int, world: int) -> None:
        """Freeze the attempt's goodput entry from the last ledger
        snapshots the poll loop saw (rank 0 is the headline; per-rank
        snapshots ride along)."""
        if not self._last_ledgers:
            return
        lead = next((led for led in self._last_ledgers
                     if led.get("rank") == 0), self._last_ledgers[0])
        self.goodput_log.append({
            "attempt": attempt, "world": world,
            "wall_s": lead["wall_s"],
            "components": dict(lead["components"]),
            "per_rank": list(self._last_ledgers)})

    def goodput_summary(self) -> Dict[str, Any]:
        """Run-level goodput rollup: per-component seconds summed over
        every attempt's ledger (exact per-attempt partitions), plus the
        controller-side recovery total (detection→first report; it
        overlaps each young attempt's restore/first-step wall, so it is
        reported beside the components, not inside them)."""
        comps: Dict[str, float] = {}
        wall = 0.0
        for e in self.goodput_log:
            wall += e["wall_s"]
            for c, v in e["components"].items():
                comps[c] = comps.get(c, 0.0) + v
        rec = sum(r.get("recovery_s", 0.0) for r in self.recovery_log)
        return {
            "attempts": len(self.goodput_log),
            "wall_s": wall,
            "components": comps,
            "controller_recovery_s": rec,
            "fractions": ({c: v / wall for c, v in comps.items()}
                          if wall > 0 else {}),
        }

    def _publish_world(self, world: int, attempt: int,
                       ended: bool = False) -> None:
        """Write the attempt's formed world size to ``world/<run>`` in the
        process's ``internal_kv`` (namespace ``__train__``), as JAX writes
        it to the GCS KV."""
        from ray_tpu_torch.experimental import internal_kv as kv

        rec = {"world": int(world), "attempt": int(attempt),
               "ts": time.time()}
        if ended:
            rec["run_ended"] = True
        kv.internal_kv_put(f"world/{self._run_name}",
                           json.dumps(rec).encode(), overwrite=True,
                           namespace=TRAIN_KV_NS)

    def _publish_straggler(self, rank: int,
                           info: Optional[Dict[str, Any]]) -> None:
        """Mirror a straggler flag into the run store's ``__train__`` KV
        (``straggler/<run>/<rank>``); ``info=None`` clears it.
        Best-effort like the worker heartbeat mirror."""
        if self._kv is None:
            return
        try:
            key = f"straggler/{self._run_name}/{rank:05d}"
            if info is None:
                self._kv.delete(key)
            else:
                self._kv.put(key, json.dumps(info).encode())
        except Exception:  # noqa: BLE001 — KV mirror is best-effort
            pass

    def _handle_window(self, win: Dict[str, Any], attempt_span: str,
                       world: int, mtags: Dict[str, str]) -> None:
        """One scored step window: emit its trace span and apply
        straggler flag transitions (gauge + KV + controller log)."""
        from ray_tpu_torch._private import metrics_defs as mdefs
        from ray_tpu_torch.util import tracing

        if tracing.enabled() and win.get("start_ts") is not None:
            tracing.emit_span(
                "train.step_window", trace_id=self._trace_id,
                ts=win["start_ts"],
                dur=max(win["end_ts"] - win["start_ts"], 0.0),
                parent_span_id=attempt_span, kind="train",
                run=self._run_name, window=win["window"], world=world,
                median_s=round(win["median_s"], 6),
                max_skew=round(win["max_skew"], 3),
                stragglers=",".join(map(str, win["flagged"])))
        det = self._detector
        for r in win["newly_flagged"]:
            self.stragglers.add(r)
            info = det.flagged.get(r, {}) if det else {}
            mdefs.TRAIN_STRAGGLER.set(1.0, tags={**mtags,
                                                 "rank": str(r)})
            self._publish_straggler(r, {**info, "run": self._run_name})
            logger.warning(
                "straggler: rank %d mean step %.4fs is %.1fx the window "
                "median %.4fs for %d consecutive windows (run %s, "
                "window %d)", r, info.get("mean_s", 0.0),
                info.get("skew", 0.0), win["median_s"],
                info.get("streak", 0), self._run_name, win["window"])
        for r in win["cleared"]:
            self.stragglers.discard(r)
            mdefs.TRAIN_STRAGGLER.set(0.0, tags={**mtags,
                                                 "rank": str(r)})
            self._publish_straggler(r, None)
            logger.info("straggler cleared: rank %d back under the "
                        "skew threshold (run %s, window %d)",
                        r, self._run_name, win["window"])

    def _feed_step_timings(self, polls: List[Dict[str, Any]],
                           mtags: Dict[str, str], attempt_span: str,
                           current_world: int) -> None:
        """Per-rank step timelines off one poll round: rank histogram +
        straggler detector, then act on windows that completed. Shared
        by the live poll loop and the end-of-run drain (windows that
        complete only in the final reports must still score, or a rank
        that recovered at the end would finish the run flagged)."""
        from ray_tpu_torch._private import metrics_defs as mdefs

        completed = []
        for rank, p in enumerate(polls):
            for r in p["reports"]:
                t = r.get("step_timing")
                if not t or self._detector is None:
                    continue
                if t.get("first"):
                    # Session-start → first report: setup/compile/
                    # restore, not a step — would pollute window means.
                    continue
                mdefs.TRAIN_RANK_STEP_SECONDS.observe(
                    t["dur"], tags={**mtags, "rank": str(rank)})
                completed += self._detector.observe(
                    rank, t["step"], t["dur"], ts=t.get("ts"))
        for win in completed:
            self._handle_window(win, attempt_span, current_world, mtags)

    def _account_goodput(self, polls: List[Dict[str, Any]],
                         mtags: Dict[str, str]) -> None:
        """Difference rank-0's ledger snapshot into the goodput counter
        family and refresh the fraction gauges. The counters are
        monotone (a shrinking step residual between two snapshots is
        skipped), so they approximate the exact per-attempt partition
        kept in ``goodput_log``."""
        from ray_tpu_torch._private import metrics_defs as mdefs

        ledgers = [p.get("ledger") for p in polls]
        self._last_ledgers = [dict(led, rank=rank)
                              for rank, led in enumerate(ledgers) if led]
        lead = ledgers[0] if ledgers else None
        if not lead:
            return
        wall = max(lead["wall_s"], 1e-9)
        for comp, val in lead["components"].items():
            delta = val - self._ledger_prev.get(comp, 0.0)
            if delta > 0:
                mdefs.TRAIN_GOODPUT_SECONDS.inc(
                    delta, tags={**mtags, "component": comp})
                self._ledger_prev[comp] = val
            mdefs.TRAIN_GOODPUT_FRACTION.set(
                val / wall, tags={**mtags, "component": comp})

    # ------------------------------------------------------------------
    def _watchdog_s(self) -> float:
        w = self.run_config.failure_config.watchdog_s
        if w is None:
            w = _env_float("RAY_TPU_STEP_WATCHDOG_S", 0.0)
        return float(w)

    def _nan_fatal_reports(self) -> int:
        n = self.run_config.failure_config.nan_fatal_reports
        if n is None:
            n = _env_int("RAY_TPU_NAN_FATAL_REPORTS", 0)
        return int(n)

    def _drive(self, executor: BackendExecutor, run_futs,
               manager: CheckpointManager, history: List[Dict[str, Any]],
               guard: elastic.ResizeGuard, current_world: int,
               explicit_world: Optional[int] = None,
               attempt_span: str = ""):
        """Poll session queues until every worker's run() completes.

        Also the detection loop: the per-step watchdog, the fatal-NaN
        guard, and resize triggers (explicit world-target hints; periodic
        grow-back feasibility probes) all run off this poll cadence —
        ``executor.poll()`` itself raises on process death and heartbeat
        lapses. A run that fails in one worker ends the attempt at once,
        whatever the others are doing."""
        from ray_tpu_torch._private import metrics_defs as mdefs

        mtags = {"trainer": type(self).__name__}
        last_report_ts = 0.0
        watchdog_s = self._watchdog_s()
        nan_fatal = self._nan_fatal_reports()
        nan_streak = 0
        grow_check_s = _env_float("RAY_TPU_GROW_CHECK_S", 30.0)
        started = time.monotonic()
        last_progress = started
        next_grow_check = started + grow_check_s
        first_report_seen = False

        def observe_round(metrics, nreports):
            """Per-step observability: report cadence is the step cadence
            (reference: workers report once per step), so the wall time
            since the previous poll round, split across the ``nreports``
            steps merged this round, is the per-step time — recording the
            raw inter-call gap would log ~0s for every buffered report
            when steps back up. A tokens_per_s metric key feeds the
            throughput gauge."""
            nonlocal last_report_ts
            now = time.monotonic()
            mdefs.TRAIN_REPORTS.inc(nreports, tags=mtags)
            if last_report_ts:
                per_step = (now - last_report_ts) / nreports
                for _ in range(nreports):
                    mdefs.TRAIN_STEP_SECONDS.observe(per_step, tags=mtags)
            last_report_ts = now
            tps = (metrics or {}).get("tokens_per_s")
            if isinstance(tps, (int, float)):
                mdefs.TRAIN_TOKENS_PER_S.set(float(tps), tags=mtags)

        while True:
            polls = executor.poll()
            # Per-rank step timelines: every report carries its step's
            # wall time; feed the rank histogram and the straggler
            # detector, then act on any windows that completed.
            self._feed_step_timings(polls, mtags, attempt_span,
                                    current_world)
            # Merge this round's reports: workers report at the same cadence;
            # rank 0's metrics win, any rank's checkpoint is persisted
            # (reference keeps rank-0 checkpoints by default).
            max_reports = max((len(p["reports"]) for p in polls), default=0)
            for i in range(max_reports):
                metrics = None
                ckpt_path = None
                for rank, p in enumerate(polls):
                    if i < len(p["reports"]):
                        r = p["reports"][i]
                        if metrics is None:
                            metrics = r["metrics"]
                        if ckpt_path is None and r.get("checkpoint_path"):
                            ckpt_path = r["checkpoint_path"]
                entry: Dict[str, Any] = {"metrics": metrics}
                if ckpt_path:
                    persisted = manager.register(
                        Checkpoint(ckpt_path), metrics or {})
                    entry["checkpoint"] = persisted
                history.append(entry)
                # Fatal-NaN guard: consecutive non-finite losses mean a
                # restart would replay the same divergence.
                loss = (metrics or {}).get("loss")
                if isinstance(loss, (int, float)):
                    if not math.isfinite(float(loss)):
                        nan_streak += 1
                        if nan_fatal and nan_streak >= nan_fatal:
                            raise exceptions.NaNLossError(
                                reports=nan_streak)
                    else:
                        nan_streak = 0
            if max_reports:
                observe_round(metrics, max_reports)
                self._account_goodput(polls, mtags)
                now = time.monotonic()
                last_progress = now
                self._attempt_reported = True
                if not first_report_seen:
                    first_report_seen = True
                    if self._failure_ts is not None:
                        recovery_s = now - self._failure_ts
                        mdefs.TRAIN_RECOVERY_SECONDS.observe(
                            recovery_s, tags=mtags)
                        # The goodput counter family gets only the
                        # INTER-session dead time (detection → the new
                        # session's start): the tail of the recovery
                        # (restore + first step) already flows in
                        # through the young attempt's own ledger, and
                        # the counters must not book it twice.
                        lead = polls[0].get("ledger") if polls else None
                        dead_s = recovery_s - (lead["wall_s"] if lead
                                               else 0.0)
                        if dead_s > 0:
                            mdefs.TRAIN_GOODPUT_SECONDS.inc(
                                dead_s,
                                tags={**mtags, "component": "recovery"})
                        if self.recovery_log:
                            self.recovery_log[-1]["recovery_s"] = \
                                recovery_s
                        if self._pending_recovery is not None:
                            # Same recovery_s closes the trace: the
                            # train.recovery span and the metric can
                            # never disagree.
                            self._pending_recovery.close(recovery_s)
                            self._pending_recovery = None
                        self._failure_ts = None
            # Per-step watchdog: a hung collective stalls every worker's
            # report stream while heartbeats keep flowing. Before the
            # first report the deadline is 10x (compile headroom).
            if watchdog_s > 0:
                deadline = watchdog_s if first_report_seen \
                    else watchdog_s * 10.0
                stalled = time.monotonic() - last_progress
                if stalled > deadline:
                    raise exceptions.WorkerHangError(
                        f"step watchdog: no report for {stalled:.1f}s "
                        f"(deadline {deadline:.1f}s)", kind="watchdog")
            # Resize triggers: explicit world-target hints win; otherwise
            # a periodic feasibility probe grows a shrunk group back when
            # capacity returns (a capacity notice makes
            # the probe immediate).
            wt = guard.target
            if wt is not None:
                if wt != current_world:
                    # An ask that came with a lost worker (a node lost,
                    # as a chaos kill's ``resize=``) is that loss.
                    dead = executor.worker_group.first_dead(0.0)
                    if dead is not None:
                        raise dead
                    raise elastic.ResizeRequested(
                        wt, reason="world-target hint")
                # A no-op ask (already at this world) must unlatch, or a
                # later genuine preemption would be reclassified as a
                # resize by fit()'s latched-target check.
                guard.clear_target(wt)
            now = time.monotonic()
            if guard.take_grow_hint():
                next_grow_check = now
            if grow_check_s > 0 and now >= next_grow_check:
                next_grow_check = now + grow_check_s
                # Grow back toward the full ask when capacity returns —
                # but never undo an operator's explicit shrink: a world
                # size the operator asked for by name is not a
                # capacity-driven degradation.
                if current_world < self.scaling_config.num_workers and \
                        current_world != explicit_world:
                    feasible = self._elastic_worker_target(None)
                    if feasible > current_world:
                        raise elastic.ResizeRequested(
                            feasible, reason="capacity returned")

            done, _ = concurrent.futures.wait(
                run_futs, timeout=POLL_S,
                return_when=concurrent.futures.FIRST_EXCEPTION)
            if any(f.exception() is not None for f in done):
                executor.run_results(run_futs)  # raises, attributed
            if len(done) == len(run_futs):
                # Final drain: reports AND step timings (windows that
                # complete only here must still score — a straggler
                # that recovered in the last windows gets its cleared
                # transition, not a stale flag).
                final = executor.poll()
                self._feed_step_timings(final, mtags, attempt_span,
                                        current_world)
                for rank, p in enumerate(final):
                    for r in p["reports"]:
                        entry = {"metrics": r["metrics"]}
                        if r.get("checkpoint_path"):
                            entry["checkpoint"] = manager.register(
                                Checkpoint(r["checkpoint_path"]),
                                r["metrics"] or {})
                        history.append(entry)
                # Closing ledger snapshots (wall frozen at session end)
                # become the attempt's goodput_log entry.
                self._account_goodput(final, mtags)
                # A world-target ask that landed while the final steps
                # were completing must NOT be silently dropped: re-form
                # at the asked world (the restarted attempt restores
                # past the last step and finishes immediately when no
                # work remains, but the ask is honored and the world
                # gauge/budget reflect it).
                wt = guard.target
                if wt is not None and wt != current_world:
                    raise elastic.ResizeRequested(
                        wt, reason="world-target hint")
                return
