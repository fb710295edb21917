"""The port's preemption plane against the JAX package's: callbacks and
their counts, the guards' filtering of resize and capacity notices, the
watcher's sentinel, notices through the trainer controller's store (the
port's stand-in for the GCS pubsub), and a preemption mid-run that the
loop answers with a just-in-time save and the controller with a resume
from it, charged to the preemption budget."""

import os
import time
from datetime import timedelta

import numpy as np
import pytest
import torch.distributed as dist

import ray_tpu
import torch_train_loops as loops
from ray_tpu import exceptions as jexc
from ray_tpu import train as jt
from ray_tpu._private import metrics_defs as jdefs
from ray_tpu.checkpoint import CheckpointPlane as JPlane
from ray_tpu.checkpoint import preempt as jpre
from ray_tpu.train.elastic import ResizeGuard as JResizeGuard
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch import train as tt
from ray_tpu_torch._private import events
from ray_tpu_torch._private import metrics_defs as tdefs
from ray_tpu_torch.checkpoint import CheckpointPlane as TPlane
from ray_tpu_torch.checkpoint import preempt as tpre
from ray_tpu_torch.train.elastic import ResizeGuard as TResizeGuard

PLANES = [("jax", jpre, jdefs, JResizeGuard),
          ("torch", tpre, tdefs, TResizeGuard)]


@pytest.fixture
def ray8():
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8)
    yield
    ray_tpu.shutdown()


def _notices(defs, source):
    return sum(v for _n, k, v in defs.CKPT_PREEMPT_NOTICES.samples()
               if ("source", source) in k)


@pytest.mark.parametrize("name,pre,defs,resize_guard", PLANES,
                         ids=[p[0] for p in PLANES])
def test_guards_filter_resize_and_capacity_notices(name, pre, defs,
                                                   resize_guard):
    """Capacity hints and world-target asks ride the preemption channel
    but are ResizeGuard's to latch: a PreemptionGuard (the JIT-save path
    inside every running train loop) ignores them."""
    with pre.PreemptionGuard() as pguard, resize_guard() as rguard:
        pre.notify_preemption({"reason": "capacity-grew",
                               "kind": "capacity", "node": "*"})
        pre.notify_preemption({"reason": "operator-resize",
                               "world_target": 6, "node": "*"})
        assert not pguard.triggered
        assert rguard.target == 6
        assert rguard.take_grow_hint() and not rguard.take_grow_hint()
        rguard.clear_target(6)
        assert rguard.target is None
        pre.notify_preemption({"reason": "host-preempted", "node": "*"})
        assert pguard.triggered
        assert pguard.notice["reason"] == "host-preempted"


@pytest.mark.parametrize("name,pre,defs,resize_guard", PLANES,
                         ids=[p[0] for p in PLANES])
def test_callbacks_isolated_counted_and_local_publish(name, pre, defs,
                                                      resize_guard):
    """A bad callback does not stop the others; each delivery counts
    under its source; a publish with no store (no GCS) fires locally
    with the notice's flight-event id."""
    got = []

    def bad(notice):
        raise RuntimeError("bad callback")

    before = _notices(defs, "publish")
    h1 = pre.register_preempt_callback(bad)
    h2 = pre.register_preempt_callback(got.append)
    try:
        notice = pre.publish_preempt(reason="maint", node="n1",
                                     deadline_s=30, cause="")
    finally:
        pre.unregister_preempt_callback(h1)
        pre.unregister_preempt_callback(h2)
    assert len(got) == 1 and got[0]["reason"] == "maint"
    assert got[0]["node"] == "n1" and got[0]["deadline_s"] == 30.0
    assert got[0]["notice_id"] == notice["notice_id"] != ""
    assert _notices(defs, "publish") == before + 1


def test_notice_fields_match_jax():
    seen = {}
    for name, pre, _, _ in PLANES:
        got = []
        h = pre.register_preempt_callback(got.append)
        try:
            pre.publish_preempt(reason="r", node="*", deadline_s=5.0,
                                world_target=3, kind="capacity")
        finally:
            pre.unregister_preempt_callback(h)
        (notice,) = got
        seen[name] = {k: v for k, v in notice.items()
                      if k not in ("ts", "notice_id")}
    assert seen["torch"] == seen["jax"]


def test_notices_through_the_store_reach_listeners_by_node():
    """The port's channel: publish through a TCPStore; every listener on
    it fires its callbacks for each notice published after it
    subscribed, and one scoped to another node ignores it."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=30))
    address = f"{store.host}:{store.port}"
    got = []
    h = tpre.register_preempt_callback(got.append)
    try:
        tpre.publish_preempt(reason="before", store_address=address)
        tpre.start_preempt_listener(address, node_id="node-a")
        tpre.publish_preempt(reason="other", node="node-b",
                             store_address=address)
        tpre.publish_preempt(reason="mine", node="node-a",
                             store_address=address)
        tpre.publish_preempt(reason="all", store_address=address)
        deadline = time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(3 * tpre.POLL_S)
    finally:
        tpre.stop_listener(address)
        tpre.unregister_preempt_callback(h)
    assert [n["reason"] for n in got] == ["mine", "all"]
    assert all(n["source"] == "pubsub" for n in got)
    ids = {e["event_id"]
           for e in events.local_events(types=["preempt.notice"])}
    assert {n["notice_id"] for n in got} <= ids


@pytest.mark.parametrize("name,pre,defs,resize_guard", PLANES,
                         ids=[p[0] for p in PLANES])
def test_watcher_sentinel_publishes_once(name, pre, defs, resize_guard,
                                         tmp_path):
    got = []
    h = pre.register_preempt_callback(got.append)
    sentinel = tmp_path / "maintenance"
    watcher = pre.PreemptionWatcher(node_id="host-1",
                                    sentinel_path=str(sentinel),
                                    poll_s=0.02)
    try:
        time.sleep(0.1)
        assert not got and not watcher.fired
        sentinel.write_text("now")
        deadline = time.monotonic() + 5
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        watcher.trigger("SIGTERM")  # already fired: no second notice
    finally:
        watcher.stop()
        pre.unregister_preempt_callback(h)
    assert watcher.fired
    assert [(n["reason"], n["node"]) for n in got] == [
        ("maintenance-event", "host-1")]


def test_preemption_jit_save_and_resume_matches_jax(ray8, tmp_path):
    """A preemption notice mid-run makes the loop checkpoint just in time
    and die with PreemptedError; both controllers treat it as retryable
    (with max_failures=0), and the restarted loop resumes from that
    manifest: steps 4 and 5 run once more after it."""

    def jloop(config):
        plane = jt.get_checkpoint_plane()
        start = 0
        if plane.latest_step() is not None:
            start = int(np.asarray(plane.restore(None)["step"])) + 1
        with jpre.PreemptionGuard() as guard:
            for step in range(start, 6):
                state = {"step": np.asarray(step),
                         "w": np.full((4,), float(step), np.float32)}
                if step == 3 and start == 0:
                    jpre.publish_preempt(reason="maintenance-event")
                if guard.triggered:
                    plane.save(step, state)
                    jt.report({"step": step, "preempted": True})
                    raise jexc.PreemptedError(
                        guard.notice.get("reason", "preempted"))
                jt.report({"step": step})

    out = {}
    for name, pkg, loop, plane_cls, cpu in (
            ("jax", jt, jloop, JPlane, {}),
            ("torch", tt, loops.jit_preempt_loop, TPlane,
             {"use_gpu": False})):
        cls = getattr(pkg, "JaxTrainer", None) or pkg.TorchTrainer
        trainer = cls(loop, train_loop_config={},
                      scaling_config=pkg.ScalingConfig(
                          num_workers=1, **cpu),
                      run_config=pkg.RunConfig(
                          storage_path=str(tmp_path / name),
                          name="preempt"))
        result = trainer.fit()
        assert result.error is None
        assert trainer.controller_state == "FINISHED"
        assert "RESTARTING" in trainer.state_history
        plane = plane_cls(os.path.join(str(tmp_path / name), "preempt",
                                       "ckpt_plane"), run="train")
        out[name] = (result.metrics, plane.latest_step(),
                     [h["metrics"]["step"] for h in
                      result.metrics_history][-2:],
                     [r["cause"] for r in trainer.recovery_log],
                     [r["backoff_s"] for r in trainer.recovery_log])
    assert out["torch"] == out["jax"] == (
        {"step": 5}, 3, [4, 5], ["preemption"], [0.0])


def test_preemption_budget_exhausts_like_jax(ray8, tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_MAX_PREEMPTIONS", "1")

    def jloop(config):
        raise jexc.PreemptedError("always preempted")

    jtrainer = jt.JaxTrainer(jloop, train_loop_config={},
                             scaling_config=jt.ScalingConfig(num_workers=1),
                             run_config=jt.RunConfig(
                                 storage_path=str(tmp_path / "jax")))
    jres = jtrainer.fit()
    ttrainer = tt.TorchTrainer(loops.always_preempted_loop,
                               train_loop_config={},
                               scaling_config=tt.ScalingConfig(
                                   num_workers=1, use_gpu=False),
                               run_config=tt.RunConfig(
                                   storage_path=str(tmp_path / "torch")))
    tres = ttrainer.fit()
    assert isinstance(jres.error, jexc.PreemptedError)
    assert isinstance(tres.error, texc.PreemptedError)
    assert jtrainer.controller_state == ttrainer.controller_state == \
        "ERRORED"
    assert len(ttrainer.recovery_log) == len(jtrainer.recovery_log) == 1


@pytest.mark.parametrize("name,pre,defs,resize_guard", PLANES,
                         ids=[p[0] for p in PLANES])
def test_chaos_resize_and_preempt_node_publish_notices(name, pre, defs,
                                                       resize_guard):
    """The chaos ``resize`` action (at a train step) asks a world target
    and ``preempt_node`` publishes a real notice scoped to its target,
    caused by the firing, in both packages."""
    from ray_tpu._private import chaos as jchaos
    from ray_tpu_torch._private import chaos as tchaos

    chaos = jchaos if name == "jax" else tchaos
    got = []
    h = pre.register_preempt_callback(got.append)
    try:
        with resize_guard() as rguard:
            chaos.configure("resize:rank=0,step=2,world=3;"
                            "preempt_node:target=host-7")
            assert chaos.inject("train_step", rank=0, step=1) is None
            chaos.inject("train_step", rank=0, step=2)
            assert rguard.target == 3
            fired = chaos.inject("pool_handoff", stage="FREEING")
    finally:
        chaos.reset()
        pre.unregister_preempt_callback(h)
    assert [n.get("world_target") for n in got] == [3, None]
    assert got[1]["node"] == "host-7"
    assert fired["preempted_node"] == "host-7"
    assert fired["notice_id"] == got[1]["notice_id"]
