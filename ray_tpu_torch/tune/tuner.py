"""Tuner + TuneController: trial orchestration over actors (the port of
``ray_tpu/tune/tuner.py``).

Reference: ``python/ray/tune/tuner.py:44`` (Tuner) and
``tune/execution/tune_controller.py:68`` — the event loop that launches trial
actors up to the concurrency budget, consumes their reported results,
feeds the scheduler (early stopping, PBT forks), and assembles a
ResultGrid. Trials are actors of the port's core API running the user
function with a report queue; the trainable crosses by reference (the
in-process runtime has no wire).

Two differences from JAX's, both recorded in ROADMAP.md §C:

* a trial the scheduler stops (or PBT forks) is told so before its actor
  is killed, and its function unwinds at its next ``report`` (a killed
  in-process actor's thread would run on, and on the card it would keep
  the trial's memory and steps going);
* the experiment snapshot is written with ``pickle`` (the card's machine
  has no cloudpickle): an entry pickle refuses (a lambda in
  ``sample_from``, a class defined in a function) is left out of the
  snapshot and named in its ``"dropped"`` list, and ``Tuner.restore``
  takes the trainable again, as JAX's does.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.search import BasicVariantGenerator

_report_queue_var = threading.local()


def report(metrics: Dict[str, Any], checkpoint=None) -> None:
    """Report intermediate metrics from inside a trainable
    (reference: ``ray.tune.report`` / ``session.report``). ``checkpoint``
    is any picklable trial state; PBT forks trials from the donor's last
    reported checkpoint. Raises ``WorkerStoppedError`` once the
    controller has stopped the trial (the function unwinds here)."""
    q = getattr(_report_queue_var, "queue", None)
    if q is None:
        raise RuntimeError("tune.report() called outside a trial")
    stop = getattr(_report_queue_var, "stop", None)
    if stop is not None and stop.is_set():
        from ray_tpu_torch.exceptions import WorkerStoppedError

        raise WorkerStoppedError("trial stopped by the tune controller")
    q.put({"metrics": dict(metrics), "checkpoint": checkpoint})


def get_checkpoint():
    """Checkpoint the trial was started from (None for a fresh start;
    reference: ``ray.tune.get_checkpoint``). PBT-forked trials resume from
    their donor's state through this."""
    return getattr(_report_queue_var, "checkpoint", None)


class _TrialActor:
    """Runs one trial function; polled for reports (max_concurrency=2:
    ``run`` holds one thread, ``poll`` and ``stop`` take the other)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._stop = threading.Event()
        self._final: Any = None

    def run(self, fn: Callable, config: Dict[str, Any], checkpoint=None):
        _report_queue_var.queue = self._q
        _report_queue_var.checkpoint = checkpoint
        _report_queue_var.stop = self._stop
        try:
            self._final = fn(config)
            if isinstance(self._final, dict):
                self._q.put({"metrics": dict(self._final),
                             "checkpoint": None})
            return self._final
        finally:
            _report_queue_var.queue = None
            _report_queue_var.stop = None
            self._done.set()

    def poll(self):
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        return {"reports": out, "finished": self._done.is_set()}

    def stop(self) -> bool:
        """Flag the trial: its next ``report`` raises and it unwinds."""
        self._stop.set()
        return True


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    search_seed: Optional[int] = None
    # Model-based searcher (e.g. search.TPESearch): proposes configs
    # sequentially from completed-trial scores instead of the upfront
    # random/grid expansion (reference: tune/search/ search algorithms).
    search_alg: Any = None


@dataclasses.dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Optional[Dict[str, Any]]
    metrics_history: List[Dict[str, Any]]
    error: Optional[str] = None
    stopped_early: bool = False

    @property
    def last_result(self):
        return self.metrics


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self):
        return [r for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        pick = max if mode == "max" else min
        return pick(scored, key=lambda r: r.metrics[metric])


@dataclasses.dataclass
class _RunDir:
    """Where a restored experiment lives, when its own run config did not
    pickle (``storage_path`` / ``name``, as a RunConfig gives them)."""

    storage_path: str
    name: str


def _picklable(value) -> bool:
    try:
        pickle.dumps(value)
        return True
    except Exception:  # noqa: BLE001 — any refusal
        return False


def _snapshot_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """``state`` with what pickle refuses left out: a ``param_space``
    entry at a time, the tune config's searcher and scheduler, then any
    whole top-level entry; the ``"dropped"`` list names each."""
    out, dropped = {}, []
    for key, value in state.items():
        if key == "param_space" and isinstance(value, dict):
            kept = {}
            for k, v in value.items():
                if _picklable(v):
                    kept[k] = v
                else:
                    dropped.append(f"param_space[{k!r}]")
            value = kept
        elif key == "tune_config" and not _picklable(value):
            repl = {}
            for field in ("search_alg", "scheduler"):
                if not _picklable(getattr(value, field)):
                    repl[field] = None
                    dropped.append(f"tune_config.{field}")
            value = dataclasses.replace(value, **repl)
        if _picklable(value):
            out[key] = value
        else:
            dropped.append(key)
    out["dropped"] = dropped
    return out


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None, _restore_state: Optional[dict] = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config
        self._restore_state = _restore_state

    # -------------------------------------------------- experiment state
    # Reference: the experiment-state snapshot Tune writes to the run dir
    # (tune/execution/tune_controller.py checkpointing + Tuner.restore).
    STATE_FILE = "tuner_state.pkl"
    STATE_SNAPSHOT_PERIOD_S = 1.0

    def _experiment_dir(self) -> str:
        import tempfile

        storage = getattr(self.run_config, "storage_path", None) or \
            os.path.join(tempfile.gettempdir(), "ray_tpu_results")
        name = getattr(self.run_config, "name", None) or "tune_experiment"
        path = os.path.join(storage, name)
        os.makedirs(path, exist_ok=True)
        return path

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                resume_errored: bool = False) -> "Tuner":
        """Resume an interrupted/failed experiment from its state snapshot
        (reference: ``Tuner.restore(path, trainable)``). Unfinished trials
        continue from their last reported checkpoint; errored trials rerun
        from theirs when ``resume_errored``."""
        with open(os.path.join(path, cls.STATE_FILE), "rb") as f:
            state = pickle.load(f)
        state["resume_errored"] = resume_errored
        run_config = state.get("run_config")
        if run_config is None:
            path = os.path.abspath(path)
            run_config = _RunDir(os.path.dirname(path),
                                 os.path.basename(path))
        return cls(trainable, param_space=state.get("param_space"),
                   tune_config=state.get("tune_config"),
                   run_config=run_config, _restore_state=state)

    def fit(self) -> ResultGrid:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        tc = self.tune_config
        scheduler = tc.scheduler or sched_mod.FIFOScheduler()

        results: List[TrialResult] = []
        if self._restore_state is not None:
            state = self._restore_state
            resume_errored = state.get("resume_errored", False)
            pending = []
            for t in state["unfinished"]:
                pending.append((t["trial_id"], t["config"],
                                t.get("checkpoint")))
            for r in state["results"]:
                if r.error and resume_errored:
                    ckpt = state["checkpoints"].get(r.trial_id)
                    pending.append((r.trial_id, r.config, ckpt))
                else:
                    results.append(r)
            checkpoints: Dict[str, Any] = dict(state["checkpoints"])
            # A restored search_alg (pickled inside tune_config with its
            # observation history) keeps proposing the not-yet-run samples;
            # trials already proposed (finished or snapshotted as pending)
            # count toward num_samples.
            search_alg = tc.search_alg
            proposed = len(results) + len(pending)
        elif tc.search_alg is not None:
            search_alg = tc.search_alg
            pending = []  # proposed one at a time in the loop below
            checkpoints = {}
            proposed = 0
        else:
            generator = BasicVariantGenerator(tc.num_samples, tc.search_seed)
            configs = list(generator.variants(self.param_space))
            pending = [(f"trial_{i:05d}_{uuid.uuid4().hex[:6]}", cfg, None)
                       for i, cfg in enumerate(configs)]
            checkpoints = {}
            search_alg = None
            proposed = 0
        if search_alg is not None:
            # A restored run never reseeds: the pre-crash RNG stream
            # already produced the snapshotted pending configs.
            search_alg.configure(
                self.param_space, tc.metric, tc.mode,
                tc.search_seed if self._restore_state is None else None)
        limit = tc.max_concurrent_trials or max(len(pending), 1,
                                                4 if search_alg else 1)

        trial_cls = ray_tpu_torch.remote(_TrialActor)
        running: Dict[str, Dict[str, Any]] = {}
        # checkpoints: last reported checkpoint per trial — PBT forks
        # bottom-quantile trials from a top-quantile donor's entry, and the
        # experiment-state snapshot persists them for Tuner.restore.
        is_pbt = getattr(scheduler, "requires_checkpoints", False)
        exp_dir = self._experiment_dir()
        last_snapshot = 0.0

        def snapshot_state(force=False):
            nonlocal last_snapshot
            if not force and \
                    time.monotonic() - last_snapshot < \
                    self.STATE_SNAPSHOT_PERIOD_S:
                return
            last_snapshot = time.monotonic()
            state = _snapshot_state({
                "param_space": self.param_space,
                "tune_config": tc,
                "run_config": self.run_config,
                "results": list(results),
                "unfinished": [
                    {"trial_id": tid, "config": st["config"],
                     "checkpoint": checkpoints.get(tid)}
                    for tid, st in running.items()
                ] + [{"trial_id": tid, "config": cfg, "checkpoint": ckpt}
                     for tid, cfg, ckpt in pending],
                "checkpoints": dict(checkpoints),
            })
            tmp = os.path.join(exp_dir, f".{self.STATE_FILE}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(state, f)
            os.replace(tmp, os.path.join(exp_dir, self.STATE_FILE))

        def launch(trial_id, cfg, checkpoint=None, st=None):
            actor = trial_cls.options(max_concurrency=2).remote()
            run_ref = actor.run.remote(self.trainable, cfg, checkpoint)
            if is_pbt:
                scheduler.on_trial_config(trial_id, cfg)
            if st is None:
                st = {"history": [], "steps": 0, "stopped": False}
            st.update(actor=actor, config=cfg, run_ref=run_ref)
            running[trial_id] = st

        def end(actor):
            """Stop the trial's function at its next report, then kill
            its actor."""
            try:
                ray_tpu_torch.get(actor.stop.remote(), timeout=30)
            except Exception:  # noqa: BLE001 — the actor is already gone
                pass
            ray_tpu_torch.kill(actor)

        def finish(tr: TrialResult):
            results.append(tr)
            if search_alg is not None and tr.metrics and tc.metric and \
                    tc.metric in tr.metrics:
                search_alg.on_trial_complete(tr.config,
                                             float(tr.metrics[tc.metric]))

        while pending or running or \
                (search_alg is not None and proposed < tc.num_samples):
            # Launch up to the concurrency limit.
            while pending and len(running) < limit:
                trial_id, cfg, ckpt = pending.pop(0)
                launch(trial_id, cfg, checkpoint=ckpt)
            while search_alg is not None and proposed < tc.num_samples \
                    and len(running) < limit:
                cfg = search_alg.suggest()
                launch(f"trial_{proposed:05d}_{uuid.uuid4().hex[:6]}", cfg)
                proposed += 1
            snapshot_state()
            # Poll every running trial.
            for trial_id, st in list(running.items()):
                try:
                    poll = ray_tpu_torch.get(st["actor"].poll.remote(),
                                             timeout=30)
                except Exception as e:  # actor died
                    finish(TrialResult(
                        trial_id, st["config"],
                        st["history"][-1] if st["history"] else None,
                        st["history"], error=str(e)))
                    del running[trial_id]
                    continue
                stop = False
                exploit = False
                for r in poll["reports"]:
                    st["steps"] += 1
                    st["history"].append(r["metrics"])
                    if r.get("checkpoint") is not None:
                        checkpoints[trial_id] = r["checkpoint"]
                    if tc.metric and tc.metric in r["metrics"]:
                        verdict = scheduler.on_result(
                            trial_id, st["steps"],
                            float(r["metrics"][tc.metric]))
                        if verdict == sched_mod.STOP:
                            stop = True
                        elif verdict == sched_mod.EXPLOIT:
                            exploit = True
                if exploit and not poll["finished"]:
                    donor, new_cfg = scheduler.exploit(trial_id)
                    if donor is not None and donor in checkpoints:
                        # Exploit+explore: replace this trial's actor with
                        # a clone of the donor's checkpoint under the
                        # perturbed config; history/steps continue.
                        end(st["actor"])
                        launch(trial_id, new_cfg,
                               checkpoint=checkpoints[donor], st=st)
                        scheduler.commit_exploit(trial_id, new_cfg)
                        continue
                if stop and not poll["finished"]:
                    end(st["actor"])
                    finish(TrialResult(
                        trial_id, st["config"],
                        st["history"][-1] if st["history"] else None,
                        st["history"], stopped_early=True))
                    del running[trial_id]
                    continue
                if poll["finished"]:
                    error = None
                    try:
                        ray_tpu_torch.get(st["run_ref"], timeout=30)
                    except Exception as e:  # noqa: BLE001
                        error = str(e)
                    finish(TrialResult(
                        trial_id, st["config"],
                        st["history"][-1] if st["history"] else None,
                        st["history"], error=error))
                    ray_tpu_torch.kill(st["actor"])
                    del running[trial_id]
            time.sleep(0.02)

        snapshot_state(force=True)
        return ResultGrid(results, tc.metric, tc.mode)


def run(trainable: Callable, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, metric: Optional[str] = None, mode: str = "max",
        scheduler=None, **_) -> ResultGrid:
    """``tune.run`` compatibility wrapper."""
    return Tuner(
        trainable, param_space=config,
        tune_config=TuneConfig(metric=metric, mode=mode,
                               num_samples=num_samples, scheduler=scheduler),
    ).fit()
