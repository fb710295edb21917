"""The port's serve autoscaler on the CPU (ROADMAP item 19a): a deployment
with an ``autoscaling_config`` or ``num_replicas="auto"`` serves, scales
up on its replicas' pressure, down through the drain path, and holds the
pool arbiter's cap.

The counterparts of ``tests/test_pool_arbiter.py``'s pressure-policy case
(``test_pressure_policy_scales_on_queue_and_respects_pool_cap``: its
``FakeEngine`` reads a module global shared with in-process replicas; the
port's replicas are processes, so the queue depth crosses in a file under
``tmp_path``), and a parity check of ``_pressure_desired`` against JAX's
``ServeController._pressure_desired`` on one table of pressure snapshots.
The replica processes import this module by name, so it imports neither
JAX nor the JAX package at the top.
"""

import json
import os
import time

import pytest

from ray_tpu_torch import serve
from ray_tpu_torch._private import events as flight
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.runtime import controller as ctl_mod
from ray_tpu_torch.serve import api as serve_api


@pytest.fixture(autouse=True)
def serve_local():
    yield
    serve.shutdown()


def _counter_value(metric, **want):
    return sum(v for _, tags, v in metric.samples()
               if all(dict(tags).get(k) == v2 for k, v2 in want.items()))


# ------------------------------------------------------------ deployments
class FakeEngine:
    """A replica whose ``pressure()`` reports the queue depth written in
    the file at ``path`` (one file every replica process reads)."""

    def __init__(self, path):
        self.path = path

    def pressure(self):
        with open(self.path) as f:
            return {"queue_depth": float(f.read() or 0)}

    def __call__(self, x):
        return x

    def pid(self, _=None):
        return os.getpid()


class SlowStart:
    """A replica whose constructor waits while the file at ``hold``
    exists (a replica held in its start)."""

    def __init__(self, hold):
        while os.path.exists(hold):
            time.sleep(0.02)

    def __call__(self, x):
        return os.getpid()


def double(x):
    return 2 * x


# What a config document's import path names.
CONFIG_ENGINE = serve.deployment(FakeEngine, name="ConfigEngine")


def _set_depth(path, depth):
    with open(path, "w") as f:
        f.write(str(depth))


def _wait(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


# ---------------------------------- the pressure policy and the pool cap
def test_pressure_policy_scales_on_queue_and_respects_pool_cap(tmp_path):
    """JAX's case: the engines' queue depth scales the fleet to its
    maximum; ``pool_set_replicas(cap=1)`` drains it to one and holds it
    there under pressure; lifting the cap lets it grow again; no pressure
    takes it back to ``min_replicas`` through drains whose cause is the
    autoscaler's decision."""
    depth = str(tmp_path / "depth")
    _set_depth(depth, 0)
    dep = serve.deployment(
        FakeEngine, name="QueueScaled",
        autoscaling_config={
            "min_replicas": 1, "max_replicas": 3,
            # Ongoing never decides; the engines' queue does.
            "target_ongoing_requests": 1000.0,
            "target_queue_depth": 4.0,
            "upscale_delay_s": 0.1, "downscale_delay_s": 0.1,
        })
    handle = serve.run(dep.bind(depth))
    assert handle.remote(1).result(timeout_s=30) == 1
    controller = serve_api._get_controller()

    def replicas():
        return len(controller.get_replicas("QueueScaled"))

    assert replicas() == 1
    _set_depth(depth, 12)            # ceil(12 / 4) = 3 replicas
    assert _wait(lambda: replicas() == 3), "queue pressure never scaled up"
    assert _counter_value(mdefs.SERVE_AUTOSCALE_DECISIONS,
                          deployment="QueueScaled", direction="up",
                          signal="queue") >= 1
    # The pool cap: cards leased away clamp the autoscaler below demand.
    prev = controller.pool_set_replicas("QueueScaled", 1, cap=1,
                                        cause="test-lease")
    assert prev == {"target": 3, "cap": None}
    assert _wait(lambda: replicas() == 1), "pool shrink never drained"
    time.sleep(1.0)                  # pressure still high: the cap holds
    assert replicas() == 1
    assert _wait(lambda: controller.pool_state("QueueScaled")["draining"]
                 == 0)
    assert controller.pool_state("QueueScaled") == {
        "routed": 1, "target": 1, "draining": 0, "cap": 1}
    # The cap lifted: pressure grows the fleet again.
    controller.pool_set_replicas("QueueScaled", 1, cap=None,
                                 cause="test-return")
    assert _wait(lambda: replicas() == 3), "never re-grew after the cap"
    _set_depth(depth, 0)
    assert _wait(lambda: replicas() == 1, 40), "never scaled back down"
    downs = [e for e in flight.local_events(types=["serve.autoscale"])
             if e["subject"].get("deployment") == "QueueScaled"
             and e["attrs"]["direction"] == "down"]
    assert downs, "no scale-down decision was recorded"
    down_ids = {e["event_id"] for e in downs}
    drains = [e for e in flight.local_events(types=["serve.drain_begin"])
              if e["subject"].get("deployment") == "QueueScaled"
              and e["cause"] in down_ids]
    assert len(drains) == 2, "the scale-down did not go through drains"
    # Every handle call still answers on the one replica left.
    assert {handle.remote(i).result(timeout_s=30) for i in range(5)} == \
        set(range(5))


@pytest.mark.parametrize("opts", [
    {"autoscaling_config": {"min_replicas": 2, "max_replicas": 3}},
    {"num_replicas": "auto"}])
def test_autoscaled_deployment_starts_at_min_replicas(opts):
    """A deployment handed to the autoscaler starts at ``min_replicas``
    (JAX's default 1 for ``"auto"``) and serves."""
    handle = serve.run(serve.deployment(double, name="auto2", **opts).bind())
    assert handle.remote(4).result(timeout_s=30) == 8
    controller = serve_api._get_controller()
    want = opts.get("autoscaling_config", {}).get("min_replicas", 1)
    assert len(controller.get_replicas("auto2")) == want
    spec = controller.deployments["auto2"]
    assert spec["autoscaling"] == {**ctl_mod.DEFAULT_AUTOSCALING,
                                   **opts.get("autoscaling_config", {})}
    assert controller.pool_state("auto2") == {
        "routed": want, "target": want, "draining": 0, "cap": None}


def test_shrink_retires_a_starting_replica_before_draining(tmp_path):
    """Scale-down takes a replica still starting before it drains a routed
    one: the routed replica keeps serving, and no drain begins."""
    hold = str(tmp_path / "hold")
    handle = serve.run(serve.deployment(SlowStart, name="slow").bind(hold))
    pid = handle.remote(0).result(timeout_s=30)
    controller = serve_api._get_controller()
    with open(hold, "w") as f:
        f.write("x")
    controller.pool_set_replicas("slow", 2, cause="test-grow")
    assert len(controller._starting["slow"]) == 1
    drains_before = len(flight.local_events(types=["serve.drain_begin"]))
    controller.pool_set_replicas("slow", 1, cap=1, cause="test-shrink")
    assert controller._starting["slow"] == []
    assert len(flight.local_events(types=["serve.drain_begin"])) == \
        drains_before
    assert controller.pool_state("slow") == {
        "routed": 1, "target": 1, "draining": 0, "cap": 1}
    assert handle.remote(0).result(timeout_s=30) == pid


def test_config_document_deploys_an_autoscaled_deployment():
    """``autoscaling_config`` passes through a config document's
    per-deployment overrides to the autoscaler."""
    doc = {"applications": [{
        "import_path": f"{__name__}:CONFIG_ENGINE",
        "args": {"path": os.devnull},
        "deployments": [{"name": "ConfigEngine", "autoscaling_config": {
            "min_replicas": 2, "max_replicas": 4}}]}]}
    assert serve.deploy_config_data(json.dumps(doc)) == ["ConfigEngine"]
    controller = serve_api._get_controller()
    assert len(controller.get_replicas("ConfigEngine")) == 2
    assert controller.deployments["ConfigEngine"]["autoscaling"][
        "max_replicas"] == 4
    assert serve.get_deployment_handle("ConfigEngine").remote(3).result(
        timeout_s=30) == 3


# ------------------------------------------- parity of the pressure policy
def _snap(**kw):
    return dict(kw)


PRESSURE_TABLE = [
    # (snapshots, config overrides, current, new sheds)
    ([_snap(ongoing=3), _snap(ongoing=2)], {}, 1, 0),
    ([_snap(ongoing=1, queue_depth=9), _snap(queue_depth=4)], {}, 2, 0),
    ([_snap(ongoing=1, queue_depth=9)], {"target_queue_depth": 0}, 2, 0),
    ([_snap(kv_blocks_total=16, kv_blocks_free=0, kv_blocks_cached=0),
      _snap(kv_blocks_total=16, kv_blocks_free=0)], {}, 2, 0),
    ([_snap(kv_blocks_total=16, kv_blocks_free=0),
      _snap(kv_blocks_total=16, kv_blocks_free=3)], {}, 2, 0),
    ([_snap(kv_blocks_total=16, kv_blocks_free=0)],
     {"kv_starvation_upscale": False}, 1, 0),
    ([_snap(prefill_queue_tokens=3000), _snap(prefill_queue_tokens=1100)],
     {"target_prefill_queue_tokens": 1024}, 1, 0),
    ([_snap(kv_blocks_total=8, kv_blocks_importable=1, kv_blocks_free=2),
      _snap(kv_blocks_total=8, kv_blocks_importable=2, kv_blocks_free=2)],
     {"importable_floor": 4}, 2, 0),
    ([_snap(ongoing=1)], {}, 3, 2),
    ([_snap(ongoing=1)], {"shed_upscale": False}, 3, 2),
    ([_snap(ongoing=8, unreachable=True), None, _snap(queue_depth=1)],
     {}, 1, 0),
]


class _StubController:
    """The state ``_pressure_desired`` reads, for both packages' methods:
    the replicas' pressure snapshots and the sheds seen so far."""

    def __init__(self, snaps, shed_total):
        self._snaps = snaps
        self._shed_seen = {}
        self.shed_total = shed_total

    def get_replica_pressure(self, name):
        return list(self._snaps)

    def _shed_total(self, name):          # JAX's method reads this
        return self.shed_total(name)


@pytest.mark.parametrize("case", range(len(PRESSURE_TABLE)))
def test_pressure_desired_matches_jax(case):
    """The same snapshots, config and shed counts give the same
    ``(desired, signal)`` through JAX's ``_pressure_desired`` and the
    port's; each package's sheds are read from its own registry."""
    from ray_tpu._private import metrics_defs as jdefs
    from ray_tpu.serve import api as jax_api

    snaps, over, current, new_sheds = PRESSURE_TABLE[case]
    name = f"pressure-parity-{case}"
    cfg = {**jax_api.DEFAULT_AUTOSCALING, **over}
    assert {**ctl_mod.DEFAULT_AUTOSCALING, **over} == cfg
    jstub = _StubController(snaps, jdefs.serve_shed_total)
    tstub = _StubController(snaps, mdefs.serve_shed_total)
    got = []
    for _ in range(2):          # the first call primes the shed cursor
        want = jax_api.ServeController._pressure_desired(
            jstub, name, cfg, current)
        mine = ctl_mod.ServeController._pressure_desired(
            tstub, name, cfg, current)
        assert mine == want, (case, mine, want)
        got.append(mine)
        tags = {"deployment": name, "tenant": "", "engine": "ingress",
                "outcome": "shed_pressure"}
        if new_sheds:
            jdefs.SERVE_REQ_OUTCOMES.inc(new_sheds, tags=tags)
            mdefs.SERVE_REQ_OUTCOMES.inc(new_sheds, tags=tags)
    assert mdefs.serve_shed_total(name) == jdefs.serve_shed_total(name)
    if new_sheds and over.get("shed_upscale", True):
        # The second call saw nothing new; a third sees the sheds.
        assert ctl_mod.ServeController._pressure_desired(
            tstub, name, cfg, current) == (current + 1, "shed") == \
            jax_api.ServeController._pressure_desired(
                jstub, name, cfg, current)
