"""The port's training-path observability against the JAX package's:
the goodput ledger, the straggler detector, the chaos slow-step fault,
and, through ``TorchTrainer`` worker processes, straggler flags, the
ledger's partition of each attempt and one connected recovery trace
whose duration equals the recovery metric.

The ledger and detector are fed the same inputs on both sides and must
agree exactly (their arithmetic is the same float ops in the same
order); the ledgers' clocks are compared within 1%, JAX's own bar."""

import time

import numpy as np
import pytest

import torch_train_loops as loops
from ray_tpu._private import chaos as jchaos
from ray_tpu.train.goodput import GoodputLedger as JLedger
from ray_tpu.train.goodput import StragglerDetector as JDetector
from ray_tpu_torch import train as tt
from ray_tpu_torch._private import chaos as tchaos
from ray_tpu_torch._private import metrics_defs as tdefs
from ray_tpu_torch.train.goodput import GoodputLedger as TLedger
from ray_tpu_torch.train.goodput import StragglerDetector as TDetector
from ray_tpu_torch.util import tracing

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _chaos_reset():
    yield
    jchaos.reset()
    tchaos.reset()


@pytest.fixture
def goodput_env(monkeypatch):
    """Tight knobs so windows score in ~seconds (JAX's fixture)."""
    monkeypatch.setenv("RAY_TPU_RESTART_BACKOFF_S", "0.05")
    monkeypatch.setenv("RAY_TPU_RESTART_BACKOFF_MAX_S", "0.2")
    monkeypatch.setenv("RAY_TPU_STRAGGLER_WINDOW_STEPS", "2")
    monkeypatch.setenv("RAY_TPU_STRAGGLER_WINDOWS", "2")


class _FakeReporter:
    """Captures span records in process (the serve tracing suite's
    pattern): worker spans arrive over their pipes into the ring."""

    def __init__(self):
        self.records = []

    def add(self, record):
        self.records.append(record)


@pytest.fixture()
def span_capture(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACING", "1")
    rep = _FakeReporter()
    monkeypatch.setattr(tracing, "_reporter", rep)
    yield rep


def _fit(tmp_path, name, total, step_sleep, num_workers=2, min_workers=1):
    trainer = tt.TorchTrainer(
        loops.goodput_loop,
        train_loop_config={"total": total, "step_sleep": step_sleep},
        scaling_config=tt.ScalingConfig(num_workers=num_workers,
                                        min_workers=min_workers,
                                        use_gpu=False),
        run_config=tt.RunConfig(name=name, storage_path=str(tmp_path)))
    return trainer, trainer.fit()


# ------------------------------------------------------------- ledger
def test_ledger_invariants_match_jax(monkeypatch):
    # Both ledgers read time.perf_counter; one clock that only the test
    # moves makes their snapshots comparable exactly, whatever the load.
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])

    def sleep(dt):
        clock[0] += dt

    snaps = []
    for cls in (JLedger, TLedger):
        led = cls()
        led.note("input_stall", 0.02)
        with led.component("sync"):
            sleep(0.01)
        sleep(0.03)
        led.close()
        snap = led.snapshot()
        comps = snap["components"]
        assert set(comps) == {"step", "input_stall", "sync", "ckpt_block",
                              "recovery"}
        assert sum(comps.values()) == pytest.approx(snap["wall_s"],
                                                    abs=1e-9)
        assert comps["input_stall"] == 0.02
        assert comps["sync"] >= 0.01 and comps["step"] > 0
        assert led.snapshot()["wall_s"] == snap["wall_s"]  # frozen
        assert sum(led.fractions().values()) == pytest.approx(1.0)
        with pytest.raises(ValueError, match="step.*residual"):
            led.note("step", 1.0)
        with pytest.raises(ValueError):
            led.note("coffee", 1.0)
        snaps.append(snap)
    # The same clock readings give the same snapshot in both.
    assert snaps[1] == snaps[0]
    for cls in (JLedger, TLedger):
        led = cls()
        sleep(0.01)
        led.note("input_stall", 5.0)  # double-booked: step goes negative
        led.close()
        assert led.snapshot()["components"]["step"] < 0


# -------------------------------------------------- straggler detector
def _strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


@pytest.mark.parametrize("world,kw,durs", [
    (4, dict(factor=2.0, consecutive=3, window_steps=2),
     lambda rank, step, rng: 0.5 if (rank == 2 and step < 10) else 0.01),
    (3, dict(factor=2.0, consecutive=2, window_steps=2),
     lambda rank, step, rng: 0.02 + rng.uniform(0, 0.005)),
], ids=["flag-and-clear", "uniform"])
def test_straggler_detector_matches_jax(world, kw, durs):
    out = {}
    for name, cls in (("jax", JDetector), ("torch", TDetector)):
        det = cls(world, **kw)
        rng = np.random.default_rng(0)
        events = []
        for step in range(14):
            for rank in range(world):
                events += det.observe(rank, step, durs(rank, step, rng),
                                      ts=float(step))
        out[name] = (_strip_ts(events), det.windows_scored,
                     {r: {k: v for k, v in f.items() if k != "ts"}
                      for r, f in det.flagged.items()})
    assert out["torch"] == out["jax"]
    if world == 4:
        events = out["torch"][0]
        assert [e["window"] for e in events if e["newly_flagged"]] == [2]
        assert [e["window"] for e in events if e["cleared"]] == [5]


def test_straggler_windows_score_only_when_every_rank_passed():
    out = {}
    for name, cls in (("jax", JDetector), ("torch", TDetector)):
        det = cls(2, factor=2.0, consecutive=1, window_steps=2)
        got = []
        for step in range(6):
            got += det.observe(0, step, 0.01, ts=float(step))
        assert got == []  # rank 1 has not reported at all
        for step in range(4):
            got += det.observe(1, step, 0.3, ts=float(step))
        assert [w["window"] for w in got] == [0]
        got += det.observe(1, 4, 0.3, ts=4.0)
        out[name] = _strip_ts(got)
    assert [w["window"] for w in out["torch"]] == [0, 1]
    assert out["torch"] == out["jax"]


def test_chaos_slow_step_jitter_replays_jax_delays():
    """times=-1 fires on every matching step, and jitter draws a
    seed-deterministic delay: the port's draws are JAX's, seed for
    seed."""

    def run(chaos, seed):
        chaos.configure(
            "slow_step:rank=1,times=-1,secs=0.001,jitter=1.0", seed=seed)
        out = []
        for step in range(6):
            assert chaos.inject("train_step", rank=0, step=step) is None
            out.append(chaos.inject("train_step", rank=1,
                                    step=step)["slept_s"])
        return out

    a, b, c = run(tchaos, 7), run(tchaos, 7), run(tchaos, 11)
    assert len(set(a)) > 1 and a == b and a != c
    assert all(0.001 <= x < 0.002 for x in a)
    assert a == run(jchaos, 7) and c == run(jchaos, 11)


# ------------------------------------------------------------- e2e
def test_chaos_slow_rank_is_flagged_and_healthy_run_is_not(goodput_env,
                                                           tmp_path):
    """A chaos-injected persistently slow worker is flagged within K
    scored windows (controller state, gauge, the store's record), while
    an uninjected run never flags."""
    trainer, result = _fit(tmp_path, "healthy", 8, 0.04)
    assert result.error is None
    assert trainer.stragglers == set()
    assert trainer._detector.windows_scored >= 2
    assert trainer._detector.flagged == {}

    tchaos.configure("slow_step:rank=1,times=-1,secs=0.3", seed=5)
    trainer, result = _fit(tmp_path, "dragged", 8, 0.04)
    assert result.error is None
    assert trainer.stragglers == {1}
    info = trainer._detector.flagged[1]
    assert info["streak"] == 2 and info["window"] <= 2
    assert info["skew"] > 2.0
    by_rank = {dict(k).get("rank"): v
               for _n, k, v in tdefs.TRAIN_STRAGGLER.samples()
               if dict(k).get("trainer") == "TorchTrainer"}
    assert by_rank.get("1") == 0.0  # set during the run, cleared at end
    assert by_rank.get("0", 0.0) == 0.0
    ranks = {dict(k).get("rank")
             for _n, k, _v in tdefs.TRAIN_RANK_STEP_SECONDS.samples()}
    assert {"0", "1"} <= ranks


def test_goodput_ledger_through_trainer_sums_and_feeds_metrics(
        goodput_env, tmp_path):
    """Every attempt's goodput_log entry partitions its session wall
    exactly (step stays non-negative), the ckpt_block component is
    attributed from the checkpoint plane inside the worker processes,
    and the counter family advanced."""
    before = {dict(k).get("component"): v for _n, k, v
              in tdefs.TRAIN_GOODPUT_SECONDS.samples()}
    trainer, result = _fit(tmp_path, "ledger", 6, 0.02)
    assert result.error is None
    assert len(trainer.goodput_log) == 1
    entry = trainer.goodput_log[0]
    comps = entry["components"]
    assert sum(comps.values()) == pytest.approx(entry["wall_s"], rel=0.01)
    assert comps["step"] >= 0
    assert comps["ckpt_block"] > 0
    assert len(entry["per_rank"]) == entry["world"] == 2
    for snap in entry["per_rank"]:
        assert sum(snap["components"].values()) == pytest.approx(
            snap["wall_s"], rel=0.01)
    summary = trainer.goodput_summary()
    assert summary["attempts"] == 1
    assert sum(summary["fractions"].values()) == pytest.approx(1.0)
    assert summary["fractions"]["step"] > 0.5  # mostly productive
    after = {dict(k).get("component"): v for _n, k, v
             in tdefs.TRAIN_GOODPUT_SECONDS.samples()}
    assert after.get("step", 0.0) > before.get("step", 0.0)
    assert after.get("ckpt_block", 0.0) > before.get("ckpt_block", 0.0)


def test_recovery_yields_one_connected_trace_matching_the_metric(
        goodput_env, tmp_path, span_capture):
    """A chaos kill -> shrink -> restore run emits ONE trace: train.run at
    the root, both attempts and their step windows under it, and a
    train.recovery tree whose children tile the parent and whose
    duration equals ray_tpu_train_recovery_seconds' observation; the
    recovery's flight event cites the chaos firing that killed the
    worker."""
    from ray_tpu_torch._private import events

    sums = [v for n, k, v in tdefs.TRAIN_RECOVERY_SECONDS.samples()
            if dict(k).get("trainer") == "TorchTrainer"
            and n.endswith("_sum")]
    sum_before = sums[0] if sums else 0.0
    tchaos.configure("kill_worker:rank=1,step=3,resize=1", seed=7)
    trainer, result = _fit(tmp_path, "traced", 8, 0.03)
    assert result.error is None
    assert [r["cause"] for r in trainer.recovery_log][:1] == ["worker_lost"]
    recovery_s = trainer.recovery_log[0]["recovery_s"]
    assert recovery_s > 0
    spans = [s for s in span_capture.records
             if s["name"].startswith("train.")]
    assert {s["trace_id"] for s in spans} == {trainer._trace_id}
    assert all(s["run"] == "traced" for s in spans)
    assert tracing.connected(spans, root="train.run")
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    (run_span,) = by_name["train.run"]
    attempts = by_name["train.attempt"]
    assert {a["outcome"] for a in attempts} == {"worker_lost", "finished"}
    assert all(a["parent_span_id"] == run_span["span_id"]
               for a in attempts)
    attempt_ids = {a["span_id"] for a in attempts}
    assert all(w["parent_span_id"] in attempt_ids
               for w in by_name.get("train.step_window", []))
    (rec,) = by_name["train.recovery"]
    assert rec["parent_span_id"] == run_span["span_id"]
    assert rec["cause"] == "worker_lost"
    assert rec["dur"] == recovery_s  # the SAME value, not approximately
    kids = [s for s in spans if s["parent_span_id"] == rec["span_id"]]
    assert [k["name"] for k in kids] == [
        "train.recovery.teardown", "train.recovery.backoff",
        "train.recovery.reacquire", "train.recovery.restore_first_step"]
    assert sum(k["dur"] for k in kids) == pytest.approx(rec["dur"],
                                                        abs=1e-6)
    for prev, nxt in zip(kids, kids[1:]):
        assert nxt["ts"] == pytest.approx(prev["ts"] + prev["dur"],
                                          abs=1e-6)
    sums = [v for n, k, v in tdefs.TRAIN_RECOVERY_SECONDS.samples()
            if dict(k).get("trainer") == "TorchTrainer"
            and n.endswith("_sum")]
    assert sums[0] - sum_before == pytest.approx(recovery_s, abs=1e-6)
    kill = [e for e in tchaos.injection_log()
            if e["action"] == "kill_worker"]
    (rec_ev,) = [e for e in events.local_events(types=["train.recovery"])
                 if e.get("subject", {}).get("run") == "traced"]
    assert rec_ev["cause"] == kill[0]["event_id"]
