"""The port's elastic trainer against the JAX package's, driven by the
same injected faults.

Each case runs one deterministic train loop through ``JaxTrainer`` (the
JAX package's in-process runtime) and through ``TorchTrainer`` (worker
processes on gloo, ``torch_train_loops.py``) under the same chaos plan,
and holds the port to JAX's recovery causes, backoffs, budgets, restore
points ``(world, start)`` and final value. The loop's state is a pure
function of the completed step count (the closed form ``triangle``), so
every restore is checked bit for bit inside the loop, and the values are
compared exactly (no tolerance: the arithmetic is float64 sums of
integers). The report histories are compared where they are
deterministic: each entry fits the closed form in both, the worlds pass
in the same order, and the last attempt reports the same steps (how many
reports an attempt drains before it is torn down, and how many ranks'
last reports the final drain lists, depend on timing in either
runtime).
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu
import torch_train_loops as loops
from ray_tpu import exceptions as jexc
from ray_tpu import train as jt
from ray_tpu._private import chaos as jchaos
from ray_tpu.train import session as jsession
from ray_tpu_torch import train as tt
from ray_tpu_torch._private import chaos as tchaos
from ray_tpu_torch._private import metrics_defs as tdefs
from ray_tpu_torch.checkpoint import CheckpointPlane
from ray_tpu_torch.exceptions import CheckpointCorruptError, NaNLossError
from ray_tpu_torch.train.trainer import ControllerState

pytestmark = pytest.mark.chaos

triangle = loops.triangle


@pytest.fixture(autouse=True)
def _chaos_reset():
    yield
    jchaos.reset()
    tchaos.reset()


@pytest.fixture
def elastic_env(monkeypatch):
    """Both runtimes with tight backoff so recoveries take ~ms; the JAX
    package's in-process runtime with 8 CPUs."""
    monkeypatch.setenv("RAY_TPU_RESTART_BACKOFF_S", "0.05")
    monkeypatch.setenv("RAY_TPU_RESTART_BACKOFF_MAX_S", "0.2")
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8)
    yield
    ray_tpu.shutdown()


def _jax_loop(total, width=4, restores=None, resize_at=(), step_sleep=0.0,
              stall_s=60.0):
    """The port's ``elastic_loop`` for ``JaxTrainer`` (a closure: the
    JAX runtime runs its workers as threads of this process). As there,
    rank 0 holds a resize step unsaved until the teardown, and the ranks
    meet between save and report, so the restore points do not depend on
    how the threads are scheduled."""
    resize_at = {(a, b): c for a, b, c in resize_at}
    arrived, lock = {}, threading.Lock()

    def barrier(key, world, stop):
        with lock:
            arrived[key] = arrived.get(key, 0) + 1
        deadline = time.monotonic() + stall_s
        while arrived[key] < world:
            if stop.is_set():
                raise jexc.WorkerStoppedError("torn down at the barrier")
            if time.monotonic() > deadline:
                raise AssertionError(f"barrier {key} not met in {stall_s} s")
            time.sleep(0.002)

    def loop(config):
        ctx = jt.get_context()
        stop = jsession._get_session().stop
        plane = jt.get_checkpoint_plane()
        w = np.zeros(width, np.float64)
        start = 0
        if plane.latest_step() is not None:
            st = plane.restore()
            w, start = st["w"], int(st["step"]) + 1
            assert np.array_equal(w, np.full(width, triangle(start)))
            if restores is not None and ctx.get_world_rank() == 0:
                restores.append((ctx.get_world_size(), start))
        for step in range(start, total):
            target = (resize_at.get((ctx.get_world_size(), step))
                      if ctx.get_world_rank() == 0 else None)
            if target:
                jt.request_resize(target)
                loops.await_teardown(stop, stall_s)
            time.sleep(step_sleep)
            w = w + (step + 1)
            plane.save(step, {"w": w, "step": np.asarray(step)})
            barrier((ctx.get_world_size(), start, step),
                    ctx.get_world_size(), stop)
            jt.report({"step": step, "loss": float(w.sum()),
                       "world": ctx.get_world_size()})
        return float(w.sum())

    return loop


def _fit_jax(loop, tmp_path, name, num_workers=4, min_workers=1,
             **failure_kw):
    trainer = jt.JaxTrainer(
        loop, train_loop_config={},
        scaling_config=jt.ScalingConfig(num_workers=num_workers,
                                        min_workers=min_workers),
        run_config=jt.RunConfig(
            name=name, storage_path=str(tmp_path / "jax"),
            failure_config=jt.FailureConfig(**failure_kw)))
    return trainer, trainer.fit()


def _fit_torch(loop, config, tmp_path, name, num_workers=4, min_workers=1,
               **failure_kw):
    trainer = tt.TorchTrainer(
        loop, train_loop_config=config,
        scaling_config=tt.ScalingConfig(num_workers=num_workers,
                                        min_workers=min_workers,
                                        use_gpu=False),
        run_config=tt.RunConfig(
            name=name, storage_path=str(tmp_path / "torch"),
            failure_config=tt.FailureConfig(**failure_kw)))
    return trainer, trainer.fit()


def _both(spec, jloop, tloop, config, tmp_path, name, seed=7,
          jax_causes=None, **kw):
    """The same chaos plan through each trainer.

    ``jax_causes``: JAX's controller classifies a kill that also publishes
    a world-target hint by whichever of the two it sees first (the hint
    check in ``JaxTrainer._drive`` against the failed run), so under load
    it can read the kill as a resize. A JAX run whose recovery causes are
    not ``jax_causes`` is then made again on a fresh storage path, up to
    three runs in all, and ``jloop`` is a function that makes the loop
    afresh for each run. The port's run is made once."""
    for attempt in range(3 if jax_causes else 1):
        jchaos.configure(spec, seed=seed)
        jtrainer, jres = _fit_jax(jloop() if jax_causes else jloop,
                                  tmp_path, f"{name}-{attempt}"
                                  if attempt else name, **kw)
        if [r["cause"] for r in jtrainer.recovery_log] == \
                (jax_causes or [r["cause"] for r in jtrainer.recovery_log]):
            break
    jlog = jchaos.injection_log()
    tchaos.configure(spec, seed=seed)
    ttrainer, tres = _fit_torch(tloop, config, tmp_path, name, **kw)
    tlog = tchaos.injection_log()
    return (jtrainer, jres, jlog), (ttrainer, tres, tlog)


def _restart_count(cause):
    return sum(v for _n, key, v in tdefs.TRAIN_RESTARTS.samples()
               if ("cause", cause) in key)


def _worlds(history):
    out = []
    for h in history:
        w = h["metrics"].get("world")
        if w is not None and (not out or out[-1] != w):
            out.append(w)
    return out


def _check_histories(jres, tres, width, last_start):
    for res in (jres, tres):
        for h in res.metrics_history:
            m = h["metrics"]
            assert m["loss"] == width * triangle(m["step"] + 1), m
    assert _worlds(tres.metrics_history) == _worlds(jres.metrics_history)

    def tail(res):
        # The last attempt's steps (its final drain lists every rank's
        # last reports, as JAX's does).
        return sorted({(m["step"], m["loss"], m["world"])
                       for m in (h["metrics"] for h in res.metrics_history)
                       if m["step"] >= last_start and m["world"] == 4})

    assert tail(tres) == tail(jres)
    assert [s for s, _, _ in tail(tres)] == list(range(last_start, 10))


# ---------------------------------------------------------------- e2e
@pytest.mark.parametrize("case", ["kill", "resize"])
def test_shrink_restore_grow_matches_jax(elastic_env, tmp_path, case):
    """kill: a chaos-killed worker whose node cannot be replaced (the kill
    publishes a world_target=2 hint) -> worker_lost, re-formed at 2 from
    the newest committed manifest -> a grow-back resize to 4 at step 6.
    resize: operator resizes 4 -> 2 at step 2 and 2 -> 4 at step 6, no
    failure. Both: world 4 -> 2 -> 4 over gloo process groups re-formed
    at each attempt, every restore bit-identical, the same restores,
    causes and final value as JAX's."""
    total, width = 10, 4
    if case == "kill":
        spec, resize_at = "kill_worker:rank=1,step=3,resize=2", [[2, 6, 4]]
        causes, want = ["worker_lost", "resize"], [(2, 4), (4, 6)]
    else:
        spec, resize_at = "", [[4, 2, 2], [2, 6, 4]]
        causes, want = ["resize", "resize"], [(2, 2), (4, 6)]
    before = _restart_count("worker_lost")
    jrestores = []
    path = str(tmp_path / "restores.jsonl")

    def jax_loop():
        jrestores.clear()
        return _jax_loop(total, width, jrestores, resize_at, 0.03)

    (jtr, jres, jlog), (ttr, tres, tlog) = _both(
        spec, jax_loop, loops.elastic_loop,
        {"total": total, "width": width, "resize_at": resize_at,
         "step_sleep": 0.03, "restores": path}, tmp_path, case,
        jax_causes=causes)
    for trainer, res in ((jtr, jres), (ttr, tres)):
        assert res.error is None, res.error
        assert trainer.controller_state == ControllerState.FINISHED
        assert [r["cause"] for r in trainer.recovery_log] == causes
        assert all(r["backoff_s"] == 0.0 for r in trainer.recovery_log
                   if r["cause"] == "resize")
        assert res.metrics["loss"] == width * triangle(total)
        assert res.metrics["world"] == 4
    assert jrestores == want
    assert loops.read_rows(path) == want
    assert [e["action"] for e in tlog] == [e["action"] for e in jlog]
    assert ttr.recovery_log[-1]["world_target"] == \
        jtr.recovery_log[-1]["world_target"] == 4
    _check_histories(jres, tres, width, want[-1][1])
    # Telemetry: the restart counted under its cause, the recovery time
    # recorded, the world-size gauge ends at the grown-back size.
    assert _restart_count("worker_lost") == before + (case == "kill")
    assert all(r.get("recovery_s", 0) > 0 for r in ttr.recovery_log)
    assert [v for _n, k, v in tdefs.TRAIN_WORLD_SIZE.samples()
            if dict(k).get("trainer") == "TorchTrainer"][-1] == 4.0


# ------------------------------------------------------- detection paths
def test_hung_step_watchdog_fires_and_recovers(elastic_env, tmp_path):
    """A chaos-wedged step stalls the report stream while heartbeats keep
    flowing; the per-step watchdog turns the stall into a retryable hang
    and the run resumes from the newest committed manifest."""
    spec = "slow_step:rank=0,step=2,secs=1.6"
    (jtr, jres, _), (ttr, tres, _) = _both(
        spec, _jax_loop(5), loops.elastic_loop, {"total": 5}, tmp_path,
        "hang", num_workers=1, watchdog_s=0.5)
    for trainer, res in ((jtr, jres), (ttr, tres)):
        assert res.error is None
        assert [r["cause"] for r in trainer.recovery_log] == ["hang"]
        assert "watchdog" in trainer.recovery_log[0]["error"]
    assert tres.metrics == jres.metrics == {"step": 4, "loss": 60.0,
                                            "world": 1}


def test_heartbeat_lapse_detected(elastic_env, tmp_path, monkeypatch):
    """Chaos-dropped heartbeats (worker alive but silent) trip the
    heartbeat TTL even though the pipe still answers polls."""
    monkeypatch.setenv("RAY_TPU_TRAIN_HEARTBEAT_S", "0.1")
    monkeypatch.setenv("RAY_TPU_TRAIN_HEARTBEAT_TTL_S", "0.5")
    spec = "drop_heartbeat:rank=0,times=12"
    (jtr, jres, _), (ttr, tres, _) = _both(
        spec, _jax_loop(16, step_sleep=0.12), loops.elastic_loop,
        {"total": 16, "step_sleep": 0.12}, tmp_path, "hb", num_workers=1)
    for trainer, res in ((jtr, jres), (ttr, tres)):
        assert res.error is None
        assert trainer.recovery_log[0]["cause"] == "hang"
        assert "heartbeat" in trainer.recovery_log[0]["error"]
    assert tres.metrics == jres.metrics
    assert tres.metrics["step"] == 15


def test_backoff_schedule_and_budget_lines_match(elastic_env, tmp_path):
    """Consecutive zero-progress worker losses back off exponentially
    from RAY_TPU_RESTART_BACKOFF_S up to the cap (0.05 -> 0.1 -> 0.2),
    each charged to the restart budget."""
    (jtr, jres, _), (ttr, tres, _) = _both(
        "kill_worker:rank=0,times=3", _jax_loop(4), loops.elastic_loop,
        {"total": 4}, tmp_path, "backoff", num_workers=1)
    for trainer, res in ((jtr, jres), (ttr, tres)):
        assert res.error is None
        assert [r["backoff_s"] for r in trainer.recovery_log] == [
            0.05, 0.1, 0.2]
        assert [r["budget"] for r in trainer.recovery_log] == [
            "1/16", "2/16", "3/16"]
    assert tres.metrics == jres.metrics


def test_restart_budget_exhausts(elastic_env, tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_MAX_RESTARTS", "2")
    (jtr, jres, _), (ttr, tres, _) = _both(
        "kill_worker:rank=0,times=100", _jax_loop(4), loops.elastic_loop,
        {"total": 4}, tmp_path, "exhaust", num_workers=1)
    for trainer, res in ((jtr, jres), (ttr, tres)):
        assert res.error is not None
        assert trainer.controller_state == ControllerState.ERRORED
        assert len(trainer.recovery_log) == 2  # the third loss ended it


def test_user_failure_charges_max_failures_not_restart_budget(
        elastic_env, tmp_path, monkeypatch):
    """A user exception is governed by FailureConfig.max_failures: with
    the restart budget pinned to ZERO the run still retries (and
    succeeds) in both packages."""
    monkeypatch.setenv("RAY_TPU_MAX_RESTARTS", "0")
    jmarker = tmp_path / "jax_failed_once"
    inner = _jax_loop(3, width=2)

    def jloop(config):
        if not jmarker.exists():
            jmarker.write_text("x")
            jt.report({"step": -1, "loss": 0.0, "world": 1})
            raise RuntimeError("user train loop bug")
        return inner(config)

    (jtr, jres, _), (ttr, tres, _) = _both(
        "", jloop, loops.user_fail_loop,
        {"total": 3, "width": 2, "marker": str(tmp_path / "failed_once")},
        tmp_path, "userfail", num_workers=1, max_failures=1)
    for trainer, res in ((jtr, jres), (ttr, tres)):
        assert res.error is None
        assert [r["cause"] for r in trainer.recovery_log] == ["user"]
        assert trainer.recovery_log[0]["budget"] == "1/1"
    assert "user_fail_loop" in ttr.recovery_log[0]["error"]
    assert tres.metrics == jres.metrics


def test_fatal_nan_does_not_consume_any_budget(elastic_env, tmp_path):
    """Repeated non-finite loss is FATAL in both packages: the run errors
    out with zero recoveries and no restart counted."""
    before = sum(v for _n, _k, v in tdefs.TRAIN_RESTARTS.samples())

    def jloop(config):
        for step in range(10):
            time.sleep(0.01)
            jt.report({"step": step, "loss": float("nan")})

    (jtr, jres, _), (ttr, tres, _) = _both(
        "", jloop, loops.nan_loop, {}, tmp_path, "nan", num_workers=1,
        nan_fatal_reports=3)
    assert isinstance(tres.error, NaNLossError)
    assert type(jres.error).__name__ == "NaNLossError"
    for trainer in (jtr, ttr):
        assert trainer.controller_state == ControllerState.ERRORED
        assert trainer.recovery_log == []
    assert sum(v for _n, _k, v in tdefs.TRAIN_RESTARTS.samples()) == before


# ------------------------------------------- checkpoint shard integrity
def test_shard_chaos_matches_jax_plane(tmp_path):
    """corrupt_shard and fail_shard_write at the plane's two sites: the
    same specs leave the same visible steps and restores in both
    packages' planes, and a corrupt newest manifest falls back."""
    from ray_tpu.checkpoint import CheckpointPlane as JPlane
    from ray_tpu.exceptions import CheckpointCorruptError as JCorrupt

    out = {}
    for name, plane_cls, chaos, corrupt in (
            ("jax", JPlane, jchaos, JCorrupt),
            ("torch", CheckpointPlane, tchaos, CheckpointCorruptError)):
        root = str(tmp_path / name)
        plane = plane_cls(root, run="integrity", process_index=0,
                          process_count=1)
        plane.save(0, {"w": np.arange(4.0)})
        chaos.configure("corrupt_shard:step=1")
        plane.save(1, {"w": np.arange(4.0) * 2})  # commits, then rots
        steps = plane.steps()
        restored = np.asarray(plane.restore()["w"])
        with pytest.raises(corrupt):
            plane.restore(step=1)
        chaos.configure("fail_shard_write:step=2")
        with pytest.raises(OSError):
            plane.save(2, {"w": np.ones(4)})
        out[name] = (steps, restored, plane.latest_step(),
                     [e["action"] for e in chaos.injection_log()])
    assert out["torch"][0] == out["jax"][0] == [0, 1]
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    np.testing.assert_array_equal(out["torch"][1], np.arange(4.0))
    assert out["torch"][2:] == out["jax"][2:] == (1, ["fail_shard_write"])


def test_trainer_falls_back_past_corrupt_newest_manifest(elastic_env,
                                                         tmp_path):
    """Recovery restores from the newest *intact* committed manifest: the
    shard saved right before the kill is chaos-corrupted, so the restart
    falls back one step further and recomputes, in both packages."""
    spec = "corrupt_shard:step=4;kill_worker:rank=0,step=4"
    jrestores = []
    path = str(tmp_path / "restores.jsonl")
    (jtr, jres, _), (ttr, tres, _) = _both(
        spec, _jax_loop(6, restores=jrestores), loops.elastic_loop,
        {"total": 6, "restores": path}, tmp_path, "rotten", num_workers=1)
    for trainer, res in ((jtr, jres), (ttr, tres)):
        assert res.error is None
        assert [r["cause"] for r in trainer.recovery_log] == ["worker_lost"]
        assert res.metrics["loss"] == 4 * triangle(6)
    # Step 4 committed but rotted -> resumed from step 3 (start == 4).
    assert jrestores == loops.read_rows(path) == [(1, 4)]


def test_preempted_worker_resumes_from_its_jit_save(elastic_env, tmp_path):
    """A preemption notice through the controller's store reaches the
    workers' PreemptionGuard; the loop saves just in time and raises
    PreemptedError, which the controller charges to the preemption
    budget (no backoff) and resumes from that save."""
    path = str(tmp_path / "restores.jsonl")
    trainer, res = _fit_torch(
        loops.preempt_loop, {"total": 6, "preempt_at": 3,
                             "restores": path}, tmp_path, "preempt",
        num_workers=2)
    assert res.error is None
    assert [r["cause"] for r in trainer.recovery_log] == ["preemption"]
    assert trainer.recovery_log[0]["backoff_s"] == 0.0
    assert loops.read_rows(path) == [(2, 4)]
    assert res.metrics == {"step": 5, "loss": 4 * triangle(6)}
