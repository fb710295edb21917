"""The port's card-pool arbiter on the CPU (ROADMAP item 19a), against
``tests/test_pool_arbiter.py`` and the JAX package's arbiter.

The ports of JAX's cases: the journaled lease ledger (validated
transitions, derived allocation, the conservation invariant, pruning,
journal replay truncated at every write), the chaos pool rules, the SLO
guard, the arbiter over deterministic fake workloads, ``read_pool_state``
and the diurnal e2e (a real serve fleet of three CPU replica processes
sheds two at night, a real elastic ``TorchTrainer`` of gloo CPU workers
grows from world 1 to 3, ``preempt_node`` fires mid-handoff, the arbiter
is killed and a fresh one resumes from the journal, then morning load
trips the SLO guard and the lease returns; no violation on any tick, no
dropped request, the loss bit for bit equal to an uninterrupted run, and
the flight recorder's chain from the injection to the reversal). The
pressure-policy case is in ``tests/test_torch_serve_autoscale.py``.

Then parity in one process: the same lease scripts through both
packages' ``PoolLedger`` (equal stage histories and allocations), a
journal JAX's ledger wrote read back by the port's, ``SloGuard`` on the
same observations in each package's registry, ``_publish_world`` and the
learner phase's lease; the journal lint (the counterpart of
``tests/test_metrics_lint.py::test_arbiter_ledger_transitions_are_journaled``);
and fault C8, one card book for serve replicas and ``use_gpu`` train
workers. Tolerance: exact (no float math is compared).

The replica and worker processes import this module by name, so it
imports neither JAX nor the JAX package at the top.
"""

import json
import os
import pathlib
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as flight
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.autoscaler import arbiter as arb
from ray_tpu_torch.experimental import internal_kv as tkv
from ray_tpu_torch.runtime import controller as ctl_mod
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.train import backend_executor as bexec

import torch_train_loops as loops


@pytest.fixture(autouse=True)
def _chaos_clean():
    yield
    chaos.reset()


def _counter_value(metric, **want):
    total = 0.0
    for _, tags, v in metric.samples():
        td = dict(tags)
        if all(td.get(k) == v2 for k, v2 in want.items()):
            total += v
    return total


def _clear_pool_kv():
    """The process's KV dict outlives every test: tests that journal into
    ``__pool__`` start from a clean namespace."""
    for key in tkv.internal_kv_list("", namespace=arb.POOL_KV_NS):
        tkv.internal_kv_del(key, namespace=arb.POOL_KV_NS)


# ------------------------------------------------------------ unit: ledger
def test_ledger_transitions_and_allocation():
    led = arb.PoolLedger(arb.DictKv())
    assert led.bootstrap(3, 1)["total"] == 4
    # A second bootstrap must not re-baseline over live state.
    assert led.bootstrap(7, 7)["base"] == {"serve": 3, "train": 1}

    lease = led.create_lease("serve", "train", 2, lease_s=60)
    assert led.allocation() == {"serve": 3, "train": 1, "in_flight": 0,
                                "total": 4}
    lease = led.advance(lease, arb.FREEING, donor_target=1)
    assert led.allocation() == {"serve": 1, "train": 1, "in_flight": 2,
                                "total": 4}
    lease = led.advance(lease, arb.FREED)
    lease = led.advance(lease, arb.GRANTING, recipient_target=3)
    lease = led.advance(lease, arb.COMMITTED,
                        deadline_ts=time.time() + 60)
    assert led.allocation() == {"serve": 1, "train": 3, "in_flight": 0,
                                "total": 4}
    assert led.verify() == []
    with pytest.raises(arb.InvalidLeaseTransition):
        led.advance(lease, arb.FREEING)
    stages = [h[0] for h in led.get_lease(lease["lease_id"])["history"]]
    assert stages == [arb.PENDING, arb.FREEING, arb.FREED, arb.GRANTING,
                      arb.COMMITTED]
    lease = led.advance(lease, arb.RETURN_FREEING,
                        return_recipient_target=1)
    lease = led.advance(lease, arb.RETURN_GRANTING,
                        return_donor_target=3)
    lease = led.advance(lease, arb.RETURNED)
    assert led.allocation() == {"serve": 3, "train": 1, "in_flight": 0,
                                "total": 4}
    assert led.verify() == []


def test_ledger_verify_catches_double_owner_and_orphans():
    led = arb.PoolLedger(arb.DictKv())
    led.bootstrap(2, 2)
    l1 = led.create_lease("serve", "train", 2, 60)
    l2 = led.create_lease("serve", "train", 2, 60)
    led.advance(l1, arb.FREEING, donor_target=0)
    led.advance(l2, arb.FREEING, donor_target=0)
    assert any("negative_share" in v for v in led.verify())
    bad = dict(led.config(), total=9)
    led._journal_put("config", bad)
    assert any("total_mismatch" in v for v in led.verify())


def test_ledger_prunes_terminal_leases():
    led = arb.PoolLedger(arb.DictKv())
    led.bootstrap(4, 0)
    led.MAX_TERMINAL_KEPT = 3
    for _ in range(6):
        lease = led.create_lease("serve", "train", 1, 60)
        led.advance(lease, arb.ABORTED, "test")
    assert len(led.leases(arb.TERMINAL)) == 3
    assert led.verify() == []


def test_ledger_counts_fractions_of_a_card():
    """Replicas at a quarter card each: the pool keeps the fractions, and
    whole counts stay ints as JAX journals them."""
    led = arb.PoolLedger(arb.DictKv())
    cfg = led.bootstrap(0.75, 1)
    assert cfg["total"] == 1.75 and cfg["base"]["train"] == 1
    assert isinstance(cfg["base"]["train"], int)
    lease = led.create_lease("serve", "train", 0.5, 60)
    led.advance(lease, arb.FREEING, donor_target=0.25)
    assert led.allocation() == {"serve": 0.25, "train": 1,
                                "in_flight": 0.5, "total": 1.75}
    assert led.verify() == []


# ----------------------------------------------- unit: chaos action surface
def test_chaos_pool_rules_parse_and_act():
    plan = chaos.configure(
        "preempt_node:stage=FREEING,target=nodeX;"
        "fail_create_node:times=1;delay_drain:secs=0.001;"
        "kill_arbiter:tick=3", seed=5)
    assert [r.site for r in plan.rules] == [
        "pool_handoff", "provider_create", "serve_drain", "pool_tick"]
    assert chaos.inject("pool_handoff", stage="GRANTING") is None
    d = chaos.inject("pool_handoff", stage="FREEING")
    assert d and d["preempted_node"] == "nodeX"
    with pytest.raises(RuntimeError, match="fail_create_node"):
        chaos.inject("provider_create", provider="FakeNodeProvider")
    d = chaos.inject("serve_drain")
    assert d and d["slept_s"] == pytest.approx(0.001)
    assert chaos.inject("pool_tick", tick=2) is None
    with pytest.raises(chaos.SimulatedProcessDeath):
        chaos.inject("pool_tick", tick=3)
    actions = [e["action"] for e in chaos.injection_log()]
    assert actions == ["preempt_node", "fail_create_node", "delay_drain",
                       "kill_arbiter"]


# -------------------------------------------------------- unit: SLO guard
def test_slo_guard_shed_rate_and_ttft_windows():
    dep = "slo_unit_dep"
    guard = arb.SloGuard(dep, shed_rate=0.2, ttft_p95_s=0,
                         latency_p95_s=0, min_samples=1)
    mdefs.SERVE_REQUESTS.inc(10, tags={"deployment": dep})
    assert guard.check() is None          # the first call only primes
    assert guard.check() is None          # no movement
    mdefs.SERVE_REQ_OUTCOMES.inc(5, tags={
        "deployment": dep, "tenant": "", "engine": "ingress",
        "outcome": "shed_pressure"})
    mdefs.SERVE_REQUESTS.inc(5, tags={"deployment": dep})
    breach = guard.check()
    assert breach and breach["signal"] == "shed_rate"
    assert breach["value"] == pytest.approx(0.5)
    assert guard.check() is None

    dep2 = "slo_unit_dep2"
    g2 = arb.SloGuard(dep2, shed_rate=0, ttft_p95_s=0.1,
                      latency_p95_s=0, min_samples=3)
    assert g2.check() is None
    for _ in range(6):
        mdefs.SERVE_REQ_TTFT.observe(0.4, tags={
            "deployment": dep2, "tenant": "", "engine": "e"})
    breach = g2.check()
    assert breach and breach["signal"] == "ttft_p95"
    assert breach["value"] >= 0.4
    assert g2.check() is None


# ------------------------------------------------- unit: arbiter + fakes
class FakeWorkload:
    """Deterministic workload: set_chips applies at once."""

    def __init__(self, kind, chips, min_chips=1, settle=True):
        self.kind = kind
        self.deployment = f"fake-{kind}"
        self.run = f"fake-{kind}"
        self._chips = chips
        self.min_chips = min_chips
        self.settle = settle
        self.calls = []

    def chips(self):
        return self._chips

    def target_chips(self):
        return self._chips

    def set_chips(self, chips, cause, capped=True):
        self.calls.append((max(int(chips), 0), cause))
        self._chips = max(int(chips), 0)

    def clear_cap(self):
        self.calls.append(("uncap", None))

    def settled(self, chips):
        return self.settle and self._chips == max(int(chips), 0)

    def pressure(self):
        return {"ongoing": 0.0, "queue": 0.0, "replicas": self._chips}


def _quiet_slo(mod=arb):
    return mod.SloGuard("nobody", shed_rate=0, ttft_p95_s=0,
                        latency_p95_s=0)


def _make_arbiter(kv=None, serve_chips=3, train_chips=1, lease_s=60.0,
                  settle=True, stage_timeout_s=60.0):
    serve_w = FakeWorkload("serve", serve_chips)
    train_w = FakeWorkload("train", train_chips, settle=settle)
    a = arb.ChipPoolArbiter(serve_w, train_w, kv=kv, slo=_quiet_slo(),
                            policy="manual")
    a.lease_s = lease_s
    a.stage_timeout_s = stage_timeout_s
    return a, serve_w, train_w


def test_arbiter_drives_handoff_and_deadline_return():
    a, serve_w, train_w = _make_arbiter(lease_s=0.15)
    lease_id = a.request_handoff("serve", 2)
    deadline = time.monotonic() + 10
    seen = set()
    while time.monotonic() < deadline:
        st = a.tick()
        assert st["violations"] == []
        lease = a.ledger.get_lease(lease_id)
        seen.add(lease["stage"])
        if lease["stage"] == arb.RETURNED:
            break
        time.sleep(0.02)
    lease = a.ledger.get_lease(lease_id)
    assert lease["stage"] == arb.RETURNED
    assert arb.COMMITTED in seen
    assert (serve_w.chips(), train_w.chips()) == (3, 1)
    assert a.ledger.allocation()["serve"] == 3
    assert ("uncap", None) in serve_w.calls


def test_arbiter_rolls_back_when_recipient_never_settles():
    a, serve_w, train_w = _make_arbiter(settle=False, stage_timeout_s=0.05)
    lease_id = a.request_handoff("serve", 2)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        st = a.tick()
        assert st["violations"] == []
        if a.ledger.get_lease(lease_id)["stage"] == arb.ABORTED:
            break
        time.sleep(0.06)
    lease = a.ledger.get_lease(lease_id)
    assert lease["stage"] == arb.ABORTED
    assert serve_w.chips() == 3
    assert _counter_value(mdefs.POOL_HANDOFFS,
                          direction="serve_to_train",
                          outcome="aborted") >= 1


def test_slo_breach_refuses_pending_serve_take():
    serve_w = FakeWorkload("serve", 3)
    train_w = FakeWorkload("train", 1)

    class Breaching(arb.SloGuard):
        def check(self):
            return {"signal": "shed_rate", "value": 1.0,
                    "threshold": 0.05}

    a = arb.ChipPoolArbiter(serve_w, train_w, kv=arb.DictKv(),
                            slo=Breaching("x"), policy="manual")
    lease_id = a.request_handoff("serve", 2)
    a.tick()
    lease = a.ledger.get_lease(lease_id)
    assert lease["stage"] == arb.ABORTED
    assert serve_w.chips() == 3
    assert a.ledger.last_reversal()["action"] == "refused"
    assert a.ledger.verify() == []


# --------------------------------- unit: journal replay (crash recovery)
class RecordingKv(arb.DictKv):
    """Snapshots (journal, workload state) after every journaled write:
    each is a crash point a fresh arbiter must recover from."""

    def __init__(self):
        super().__init__()
        self.workloads = []
        self.snapshots = []

    def put(self, key, value):
        super().put(key, value)
        self.snapshots.append((dict(self.data),
                               [w.chips() for w in self.workloads]))


@pytest.mark.parametrize("scenario", ["commit_return", "abort"])
def test_journal_truncated_at_every_transition_recovers(scenario):
    kv = RecordingKv()
    serve_w = FakeWorkload("serve", 3)
    train_w = FakeWorkload("train", 1, settle=scenario == "commit_return")
    kv.workloads = [serve_w, train_w]
    a = arb.ChipPoolArbiter(serve_w, train_w, kv=kv, slo=_quiet_slo(),
                            policy="manual")
    a.lease_s = 0.05
    a.stage_timeout_s = 0.03
    a.request_handoff("serve", 2)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        assert a.tick()["violations"] == []
        if all(rec["stage"] in arb.TERMINAL for rec in a.ledger.leases()):
            break
        time.sleep(0.04)
    assert all(rec["stage"] in arb.TERMINAL for rec in a.ledger.leases())
    assert len(kv.snapshots) >= 6

    for i, (data, (serve_chips, train_chips)) in enumerate(kv.snapshots):
        serve2 = FakeWorkload("serve", serve_chips)
        train2 = FakeWorkload("train", train_chips,
                              settle=scenario == "commit_return")
        a2 = arb.ChipPoolArbiter(serve2, train2, kv=arb.DictKv(data),
                                 slo=_quiet_slo(), policy="manual")
        a2.lease_s = 0.05
        a2.stage_timeout_s = 0.03
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            st = a2.tick()
            assert st["violations"] == [], (i, st)
            if all(rec["stage"] in arb.TERMINAL
                   for rec in a2.ledger.leases()):
                break
            time.sleep(0.04)
        assert all(rec["stage"] in arb.TERMINAL
                   for rec in a2.ledger.leases()), (i, a2.ledger.leases())
        alloc = a2.ledger.allocation()
        assert alloc["in_flight"] == 0, (i, alloc)
        assert alloc["serve"] + alloc["train"] == alloc["total"], (i, alloc)
        assert serve2.chips() == alloc["serve"], (i, alloc)
        assert train2.chips() == alloc["train"], (i, alloc)


def test_read_pool_state_matches_ledger():
    """``read_pool_state`` over the process's KV mirrors the live ledger
    (JAX's CLI rendering of it is item 18b), and so do ``GrpcKv`` and
    ``read_pool_state(gcs_address=...)`` against a port cluster's GCS: a
    ledger journaling through ``GrpcKv`` reads back the same state."""
    _clear_pool_kv()
    try:
        led = arb.PoolLedger()            # InternalKv by default
        led.bootstrap(2, 2)
        lease = led.create_lease("train", "serve", 1, 60)
        led.advance(lease, arb.FREEING, donor_target=1)
        state = arb.read_pool_state()
        assert state["allocation"] == {"serve": 2, "train": 1,
                                       "in_flight": 1, "total": 4}
        assert [r["lease_id"] for r in state["in_flight"]] == [
            lease["lease_id"]]
        assert state["config"] == led.config()
        from ray_tpu_torch.cluster_utils import Cluster

        cluster = Cluster(head_node_args={"num_cpus": 1})
        try:
            remote = arb.PoolLedger(arb.GrpcKv(cluster.address))
            remote.bootstrap(2, 2)
            rlease = remote.create_lease("train", "serve", 1, 60)
            remote.advance(rlease, arb.FREEING, donor_target=1)
            got = arb.read_pool_state(gcs_address=cluster.address)
            assert got["allocation"] == state["allocation"]
            assert got["config"] == remote.config()
            assert {k: v for k, v in got["config"].items() if k != "ts"} \
                == {k: v for k, v in state["config"].items() if k != "ts"}
            assert [r["lease_id"] for r in got["in_flight"]] == [
                rlease["lease_id"]]
            assert arb.GrpcKv(cluster.address).keys("lease/") == [
                f"lease/{rlease['lease_id']}"]
        finally:
            cluster.shutdown()
    finally:
        _clear_pool_kv()


def test_cluster_autoscaler_names_raise_item_19b():
    import ray_tpu_torch.autoscaler as autoscaler

    assert set(autoscaler.__all__) == set(arb.__all__) - {"GrpcKv"}
    for name in ("Autoscaler", "NodeProvider", "FakeNodeProvider",
                 "request_resources"):
        with pytest.raises(NotImplementedError, match="item 19b"):
            getattr(autoscaler, name)


# ------------------------------------------------------- diurnal e2e (chaos)
E2E_TOTAL = 400
E2E_HOLD_AT = 40
E2E_WIDTH = 4


@serve.deployment(name="PoolEcho", num_replicas=3, max_ongoing_requests=2)
class PoolEcho:
    def __call__(self, x, delay=0.02):
        time.sleep(delay)
        return x


def _pool_trainer(tmp_path, name, hold):
    from ray_tpu_torch import train as tt

    return tt.TorchTrainer(
        loops.pool_loop,
        train_loop_config={"total": E2E_TOTAL, "hold_at": E2E_HOLD_AT,
                           "width": E2E_WIDTH, "hold": hold},
        scaling_config=tt.ScalingConfig(num_workers=1, min_workers=1,
                                        use_gpu=False),
        run_config=tt.RunConfig(name=name, storage_path=str(tmp_path),
                                failure_config=tt.FailureConfig()))


def _wait_for(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.01)
    return None


def test_diurnal_chip_handoff_e2e(tmp_path, monkeypatch):
    """The night/morning cycle end to end: serve sheds replicas (graceful
    drains, no dropped request), training absorbs the units (the group
    re-forms at world 3), ``preempt_node`` fires mid-handoff and the
    arbiter is killed and restarted mid-lease, then morning load trips
    the SLO guard and the committed handoff reverses; the conservation
    invariant holds on every tick and the trainer's final loss equals an
    uninterrupted run's bit for bit."""
    monkeypatch.setenv("RAY_TPU_RESTART_BACKOFF_S", "0.05")
    monkeypatch.setenv("RAY_TPU_RESTART_BACKOFF_MAX_S", "0.2")
    _clear_pool_kv()
    hold = str(tmp_path / "hold")
    dropped, served = [], []
    traffic_stop = threading.Event()
    morning, threads = [], []
    fit_thread = None
    try:
        baseline = _pool_trainer(tmp_path / "base", "pool-base", "").fit()
        assert baseline.error is None
        pathlib.Path(hold).write_text("x")

        handle = serve.run(PoolEcho.bind())
        assert handle.remote(0).result(timeout_s=30) == 0
        controller = serve_api._get_controller()

        trainer = _pool_trainer(tmp_path / "chaotic", "pool-chaos", hold)
        result_box = {}
        fit_thread = threading.Thread(
            target=lambda: result_box.update(result=trainer.fit()),
            daemon=True)
        fit_thread.start()

        def night_traffic():
            # A trickle below the idle threshold: requests stay in flight
            # through the drains.
            i = 0
            while not traffic_stop.is_set():
                i += 1
                try:
                    out = handle.remote(i).result(timeout_s=60)
                    (served if out == i else dropped).append(i)
                except Exception:  # noqa: BLE001 — any loss fails it
                    dropped.append(i)
                time.sleep(0.03)

        threads.append(threading.Thread(target=night_traffic, daemon=True))
        threads[-1].start()

        serve_w = arb.ServeWorkload("PoolEcho", chips_per_replica=1,
                                    min_chips=1)
        train_w = arb.TrainWorkload("pool-chaos", chips_per_worker=1)
        assert _wait_for(lambda: train_w.world() == 1, 60), \
            "trainer never published its world"
        guard = arb.SloGuard("PoolEcho", shed_rate=0, ttft_p95_s=0,
                             latency_p95_s=2.0, min_samples=4)
        monkeypatch.setenv("RAY_TPU_POOL_IDLE_TICKS", "2")
        monkeypatch.setenv("RAY_TPU_POOL_STEP_CHIPS", "2")
        monkeypatch.setenv("RAY_TPU_POOL_LEASE_S", "600")
        monkeypatch.setenv("RAY_TPU_POOL_IDLE_PER_CHIP", "1.0")
        arbiter = arb.ChipPoolArbiter(serve_w, train_w, slo=guard)
        assert arbiter.ledger.config()["base"] == {"serve": 3, "train": 1}

        # A node preempted while the drain frees serve units, and the
        # arbiter killed at tick 5: after the lease exists (tick 2) and
        # before the earliest commit.
        chaos.configure("preempt_node:stage=FREEING,target=*;"
                        "kill_arbiter:tick=5", seed=7)

        def committed():
            leases = arbiter.ledger.leases()
            return bool(leases) and leases[0]["stage"] == arb.COMMITTED

        killed = False
        forced_request_id = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            try:
                st = arbiter.tick()
            except chaos.SimulatedProcessDeath:
                killed = True
                # A fresh arbiter over the same journal.
                arbiter = arb.ChipPoolArbiter(serve_w, train_w, slo=guard)
                continue
            assert st["violations"] == [], st
            injected = [e for e in chaos.injection_log()
                        if e["action"] == "preempt_node"]
            if forced_request_id is None and injected:
                # The notice reaches the serve controller through the
                # trainer's store. Dispatch onto the replicas it drains:
                # the reject forces a journaled re-route whose resume
                # the chain below walks back to the injection.
                notice = _wait_for(lambda: [
                    e for e in flight.local_events(types=["preempt.notice"])
                    if e["cause"] == injected[0]["event_id"]], 10)
                assert notice, "no notice caused by the injection"
                forced_request_id = ""
                for _ in range(20):
                    victims = _wait_for(lambda: [
                        e["replica"]
                        for e in controller._draining.get("PoolEcho", [])
                        if e["cause"] == "preemption"
                        and e["replica"].alive], 5)
                    if not victims:
                        break
                    with handle._router.lock:
                        handle._router.replicas = list(victims)
                        handle._router.dirty = False
                        handle._router.inflight = {}
                    resp = handle.remote(424242)
                    assert resp.result(timeout_s=60) == 424242
                    if resp._request_id:
                        forced_request_id = resp._request_id
                        break
                assert forced_request_id, (
                    "no dispatch onto a draining replica was rejected")
            if committed():
                break
            time.sleep(0.25)
        assert forced_request_id, "preempt_node never fired"
        leases = arbiter.ledger.leases()
        assert leases and leases[0]["stage"] == arb.COMMITTED, leases
        assert killed, "kill_arbiter never fired"
        preempts = [e for e in chaos.injection_log()
                    if e["action"] == "preempt_node"]
        assert preempts[0]["coords"]["stage"] == arb.FREEING
        assert train_w.world() == 3
        # The notice reaches the controller through the trainer's store
        # (JAX fans it out in process): FREEING can settle just before it
        # drains the replica the lease left serve, whose replacement may
        # still be starting here.
        assert _wait_for(lambda: serve_w.chips() == 1, 60)
        assert arbiter.ledger.allocation() == {
            "serve": 1, "train": 3, "in_flight": 0, "total": 4}

        # MORNING: saturate the one replica until the guard reverses.
        def morning_call():
            while not traffic_stop.is_set():
                try:
                    handle.remote(1, delay=0.4).result(timeout_s=120)
                except Exception:  # noqa: BLE001 — counted by the trickle
                    pass

        morning = [threading.Thread(target=morning_call, daemon=True)
                   for _ in range(24)]
        for t in morning:
            t.start()
        lease_id = leases[0]["lease_id"]
        deadline = time.monotonic() + 150
        ok = False
        while time.monotonic() < deadline:
            st = arbiter.tick()
            assert st["violations"] == [], st
            stage = arbiter.ledger.get_lease(lease_id)["stage"]
            if stage == arb.RETURNED:
                ok = True
                break
            time.sleep(1.0 if stage == arb.COMMITTED else 0.25)
        assert ok, arbiter.ledger.leases()
        reversal = arbiter.ledger.last_reversal()
        assert reversal["action"] == "reversed"
        assert reversal["signal"] == "latency_p95"
        assert _counter_value(mdefs.POOL_SLO_REVERSALS,
                              action="reversed") >= 1
        assert serve_w.chips() == 3
        assert _wait_for(lambda: train_w.world() == 1, 60)
        assert arbiter.ledger.allocation() == {
            "serve": 3, "train": 1, "in_flight": 0, "total": 4}

        # The flight recorder connects the night-to-morning story by
        # event id: the injection, the notice, the drains, the resumed
        # request, the mid-handoff record and the reversal.
        inject_id = preempts[0]["event_id"]
        recs = flight.local_events(limit=100000)
        by_id = {r["event_id"]: r for r in recs}
        notices = [r for r in recs if r["type"] == "preempt.notice"
                   and r["cause"] == inject_id]
        assert notices
        notice_id = notices[0]["event_id"]
        drains = [r for r in recs if r["type"] == "serve.drain_begin"
                  and r["cause"] == notice_id]
        assert drains, "no replica drain links back to the notice"
        mid = [r for r in recs if r["type"] == "pool.handoff_preempted"
               and r["subject"].get("lease_id") == lease_id]
        assert mid and mid[0]["cause"] in (notice_id, inject_id), mid
        rev_evs = [r for r in recs if r["type"] == "pool.reversal"
                   and r["subject"].get("lease_id") == lease_id]
        assert rev_evs

        def ancestor_ids(eid):
            seen = set()
            while eid and eid in by_id and eid not in seen:
                seen.add(eid)
                eid = by_id[eid].get("cause", "")
            return seen

        resumed = next(
            (r for r in recs if r["type"] == "serve.resume"
             and r["subject"].get("request_id") == forced_request_id
             and inject_id in ancestor_ids(r["event_id"])), None)
        assert resumed is not None, (
            "no resumed request chains back to the chaos injection")
        chain_ids = {r["event_id"]
                     for r in flight.causal_chain(recs, [inject_id])}
        for eid in (notice_id, mid[0]["event_id"],
                    rev_evs[0]["event_id"], resumed["event_id"],
                    *(d["event_id"] for d in drains)):
            assert eid in chain_ids, by_id.get(eid, eid)

        # Wind down: stop the traffic, release the held steps.
        traffic_stop.set()
        os.unlink(hold)
        for t in threads + morning:
            t.join(timeout=120)
        fit_thread.join(timeout=300)
        assert "result" in result_box, "trainer never finished"
        result = result_box["result"]
        assert result.error is None
        assert dropped == []
        assert len(served) > 20
        assert result.metrics["loss"] == baseline.metrics["loss"]
        assert result.metrics["loss"] == E2E_WIDTH * loops.triangle(
            E2E_TOTAL)
        worlds = {m["metrics"]["world"] for m in result.metrics_history}
        assert 3 in worlds and 1 in worlds
        assert _counter_value(mdefs.POOL_HANDOFFS,
                              direction="serve_to_train",
                              outcome="committed") >= 1
        assert _counter_value(mdefs.POOL_HANDOFFS,
                              direction="serve_to_train",
                              outcome="returned") >= 1
        assert _counter_value(mdefs.POOL_INVARIANT_VIOLATIONS) == 0
        # The run's end is in its world record: the arbiter reads 0.
        assert train_w.world() == 0
    finally:
        traffic_stop.set()
        if os.path.exists(hold):
            os.unlink(hold)
        chaos.reset()
        if fit_thread is not None:
            fit_thread.join(timeout=300)
        serve.shutdown()
        _clear_pool_kv()


# ----------------------------------------------------- parity against JAX
def _ledger_script(mod, script):
    """Run ``script`` through ``mod``'s ``PoolLedger`` over a ``DictKv``;
    returns, after each op, the allocation, the violations and every
    lease's (donor, recipient, chips, stage, history stages and details),
    plus the journal."""
    led = mod.PoolLedger(mod.DictKv())
    leases = []
    out = []
    for op in script:
        kind = op[0]
        if kind == "bootstrap":
            led.bootstrap(*op[1:])
        elif kind == "create":
            leases.append(led.create_lease(*op[1:]))
        elif kind == "advance":
            _, i, stage, fields = op
            try:
                leases[i] = led.advance(leases[i], stage,
                                        f"to {stage}", **fields)
            except mod.InvalidLeaseTransition:
                out.append(("invalid", i, stage))
                continue
        elif kind == "reversal":
            led.record_reversal(leases[op[1]], op[2], op[3])
        elif kind == "keep":
            led.MAX_TERMINAL_KEPT = op[1]
        view = sorted(
            (json.dumps([r["donor"], r["recipient"], r["chips"],
                         r["stage"], r.get("donor_target"),
                         r.get("recipient_target")]),
             tuple((h[0], h[2]) for h in r["history"]))
            for r in led.leases())
        out.append((led.allocation(), led.verify(), view))
    rev = led.last_reversal()
    return out, ({k: v for k, v in rev.items() if k not in ("lease_id",
                                                             "ts")}
                 if rev else None), led.kv.data


LEDGER_SCRIPTS = {
    "commit_return": [
        ("bootstrap", 3, 1), ("create", "serve", "train", 2, 60),
        ("advance", 0, "FREEING", {"donor_target": 1}),
        ("advance", 0, "FREED", {}),
        ("advance", 0, "GRANTING", {"recipient_target": 3}),
        ("advance", 0, "COMMITTED", {"deadline_ts": 5.0}),
        ("advance", 0, "FREEING", {}),
        ("reversal", 0, "reversed", "latency_p95"),
        ("advance", 0, "RETURN_FREEING", {"return_recipient_target": 1}),
        ("advance", 0, "RETURN_GRANTING", {"return_donor_target": 3}),
        ("advance", 0, "RETURNED", {})],
    "abort_and_double_owner": [
        ("bootstrap", 2, 2), ("create", "serve", "train", 2, 60),
        ("create", "serve", "train", 2, 60),
        ("advance", 0, "FREEING", {"donor_target": 0}),
        ("advance", 1, "FREEING", {"donor_target": 0}),
        ("advance", 1, "ABORTING", {"abort_donor_target": 2}),
        ("advance", 1, "ABORTED", {}),
        ("advance", 0, "ABORTED", {})],
    "train_to_serve_and_prune": [
        ("bootstrap", 1, 3), ("keep", 2),
        ("create", "train", "serve", 1, 30),
        ("create", "train", "serve", 1, 30),
        ("create", "train", "serve", 1, 30),
        ("advance", 0, "ABORTED", {}), ("advance", 1, "ABORTED", {}),
        ("advance", 2, "FREEING", {"donor_target": 2}),
        ("advance", 2, "FREED", {}),
        ("advance", 2, "ABORTING", {"abort_donor_target": 3}),
        ("reversal", 2, "refused", "shed_rate"),
        ("advance", 2, "ABORTED", {})],
}


@pytest.mark.parametrize("script", sorted(LEDGER_SCRIPTS))
def test_ledger_scripts_match_jax(script):
    """The same lease script through both packages' ledgers: equal
    allocations, violations, stage histories and reversals after every
    op (ids and timestamps left out)."""
    from ray_tpu.autoscaler import arbiter as jarb

    want, jrev, _ = _ledger_script(jarb, LEDGER_SCRIPTS[script])
    got, trev, _ = _ledger_script(arb, LEDGER_SCRIPTS[script])
    assert got == want
    assert trev == jrev


def test_jax_journal_reads_back_the_same_in_the_port():
    """A journal JAX's ledger wrote into a ``DictKv``, read by the port's
    ledger (and the port's by JAX's): the same config, leases,
    allocation, violations and last reversal."""
    from ray_tpu.autoscaler import arbiter as jarb

    for script in LEDGER_SCRIPTS.values():
        for writer, reader in ((jarb, arb), (arb, jarb)):
            _, _, data = _ledger_script(writer, script)
            src = writer.PoolLedger(writer.DictKv(data))
            dst = reader.PoolLedger(reader.DictKv(data))
            assert dst.config() == src.config()
            assert dst.leases() == src.leases()
            assert dst.allocation() == src.allocation()
            assert dst.verify() == src.verify()
            assert dst.last_reversal() == src.last_reversal()


SLO_SCRIPT = [
    # (requests routed, sheds, ttft observations, latency observations)
    (10, 0, [], []),
    (0, 0, [], []),
    (5, 5, [], []),
    (20, 1, [0.02] * 6, [0.05] * 6),
    (8, 0, [0.4] * 6, [0.1] * 6),
    (8, 0, [0.01] * 2, [3.0] * 8),
    (8, 0, [], [0.01] * 8),
]


@pytest.mark.parametrize("thresholds", [
    dict(shed_rate=0.2, ttft_p95_s=0.1, latency_p95_s=1.0, min_samples=4),
    dict(shed_rate=0, ttft_p95_s=0, latency_p95_s=0.5, min_samples=8)])
def test_slo_guard_matches_jax(thresholds):
    """``SloGuard`` gives the same breach (or none) on the same windowed
    observations, each guard over its own package's registry."""
    from ray_tpu._private import metrics_defs as jdefs
    from ray_tpu.autoscaler import arbiter as jarb

    dep = f"slo-parity-{thresholds['min_samples']}"
    jg = jarb.SloGuard(dep, **thresholds)
    tg = arb.SloGuard(dep, **thresholds)
    req_tags = {"deployment": dep, "tenant": "", "engine": "e"}
    for routed, sheds, ttfts, lats in SLO_SCRIPT:
        for defs in (jdefs, mdefs):
            if routed:
                defs.SERVE_REQUESTS.inc(routed, tags={"deployment": dep})
            if sheds:
                defs.SERVE_REQ_OUTCOMES.inc(sheds, tags={
                    **req_tags, "outcome": "shed_tenant"})
            for v in ttfts:
                defs.SERVE_REQ_TTFT.observe(v, tags=req_tags)
            for v in lats:
                defs.SERVE_LATENCY.observe(v, tags={"deployment": dep})
        assert tg.check() == jg.check()


def test_publish_world_matches_jax(tmp_path):
    """``_publish_world`` writes JAX's record (``world/<run>`` under
    ``__train__``), which ``TrainWorkload.world()`` reads the same in
    both packages; a real run's record ends marked ``run_ended``."""
    import ray_tpu
    from ray_tpu.autoscaler import arbiter as jarb
    from ray_tpu.experimental import internal_kv as jkv
    from ray_tpu.train.trainer import JaxTrainer

    from ray_tpu_torch import train as tt

    class Stub:
        _run_name = "world-parity"

    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=1)
    try:
        for world, attempt, ended in ((3, 2, False), (0, 2, True)):
            JaxTrainer._publish_world(Stub(), world, attempt, ended=ended)
            tt.TorchTrainer._publish_world(Stub(), world, attempt,
                                           ended=ended)
            want = json.loads(jkv.internal_kv_get(
                "world/world-parity", namespace="__train__"))
            got = json.loads(tkv.internal_kv_get(
                "world/world-parity", namespace=bexec.TRAIN_KV_NS))
            want.pop("ts"), got.pop("ts")
            assert got == want
            assert arb.TrainWorkload("world-parity").world() == \
                jarb.TrainWorkload("world-parity").world() == \
                (0 if ended else world)
    finally:
        ray_tpu.shutdown()
    trainer = tt.TorchTrainer(
        loops.elastic_loop, train_loop_config={"total": 2},
        scaling_config=tt.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=tt.RunConfig(name="world-run",
                                storage_path=str(tmp_path)))
    assert trainer.fit().error is None
    rec = json.loads(tkv.internal_kv_get("world/world-run",
                                         namespace=bexec.TRAIN_KV_NS))
    assert (rec["world"], rec["attempt"], rec["run_ended"]) == (0, 1, True)


def test_learner_phase_lease_matches_jax():
    """Under an arbiter each learner phase journals the same serve-to-train
    lease in both packages and emits the same phase events."""
    from ray_tpu._private import events as jflight
    from ray_tpu.autoscaler import arbiter as jarb
    from ray_tpu.rl.rollout import RolloutScheduler as JaxScheduler

    from ray_tpu_torch.rl.rollout import RolloutScheduler

    def gen(prompt, max_new):
        return [1] * max_new, np.zeros(max_new, np.float32), 0

    views = []
    for mod, sched_cls, events in ((jarb, JaxScheduler, jflight),
                                   (arb, RolloutScheduler, flight)):
        pool = mod.ChipPoolArbiter(FakeWorkload("serve", 3),
                                   FakeWorkload("train", 1),
                                   kv=mod.DictKv(), slo=_quiet_slo(mod),
                                   policy="manual")
        sched = sched_cls(gen, lambda: 0, run="lease-parity", arbiter=pool,
                          learner_chips=2, lease_s=4.0)
        assert sched.learner_phase(lambda: 7, cause="") == 7
        (lease,) = pool.ledger.leases()
        evs = [e for e in events.local_events(
            types=["rl.learner_phase", "rl.learner_phase_done"])
            if e["subject"].get("lease_id") == lease["lease_id"]]
        views.append((
            {k: lease[k] for k in ("donor", "recipient", "chips", "lease_s",
                                   "stage", "deadline_ts")},
            [e["type"] for e in evs], evs[-1]["cause"] == evs[0]["event_id"],
            pool.tick()["allocation"]))
    assert views[0] == views[1]


# ------------------------------------------------------- the journal lint
def test_arbiter_ledger_transitions_are_journaled():
    """Every KV write in the port's arbiter goes through the ledger's
    journaled helpers (``_journal_put``/``_journal_del``) or the KV store
    adapters they call: a bare write could move cards without a journal
    record."""
    path = pathlib.Path(arb.__file__)
    allowed = {"_journal_put", "_journal_del", "put", "delete"}
    current_def = "<module>"
    for i, line in enumerate(path.read_text().splitlines()):
        stripped = line.strip()
        if stripped.startswith(("def ", "async def ")):
            current_def = stripped.split("def ", 1)[1].split("(")[0]
        code = stripped.split("#", 1)[0]
        if "internal_kv_put(" in code or "internal_kv_del(" in code or \
                ".kv.put(" in code or ".kv.delete(" in code or \
                "KvPut(" in code:
            assert current_def in allowed, (
                f"arbiter.py:{i + 1} writes the KV in {current_def!r} "
                f"outside the journaled helpers")
    assert callable(arb.PoolLedger._journal_put)
    assert callable(arb.PoolLedger._journal_del)
    src = path.read_text()
    for marker in ("_LEASE_TRANSITIONS", "InvalidLeaseTransition",
                   "def verify", "def advance"):
        assert marker in src, marker
    assert "self._journal_put(f\"lease/" in src


# ---------------------------------------- C8: one card book for the host
class _CardHolder:
    """A replica or worker process that is never spawned: it records its
    environment and answers every control call (a drain at once)."""

    def __init__(self, name, cls_or_fn, init_args, init_kwargs,
                 is_function, sync_workers=1, env=None, num_threads=1):
        self.env = dict(env or {})
        self.replica_id = f"{name}-holder"
        self.pid, self.dead, self.alive, self.ready = None, False, True, True

    def wait_ready(self, timeout_s):
        return {}

    def push_chaos(self, shared):
        pass

    def kill(self):
        self.alive = False

    stop = kill

    def control(self, op, *args):
        fut = Future()
        fut.set_result({"drained": True} if op == "drain" else {})
        return fut


def echo(x):
    return x


def test_replicas_and_train_workers_share_one_card_book(monkeypatch):
    """Fault C8: three whole-card replicas, then a one-worker ``use_gpu``
    group, get disjoint cards of four (the group used to take card 0
    beside a replica); no card is booked beyond 1.0. A group that does
    not fit waits for shares to come back, up to its start timeout, and
    then raises; a replica drained away gives it its card."""
    from ray_tpu_torch.train import trainer as trainer_mod
    from ray_tpu_torch.train.config import ScalingConfig

    ids = ["0", "1", "2", "3"]
    monkeypatch.setattr(ctl_mod, "_visible_gpus", lambda: list(ids))
    monkeypatch.setattr(bexec, "visible_cards", lambda: list(ids))
    monkeypatch.setattr(ctl_mod, "ReplicaProcess", _CardHolder)
    monkeypatch.setattr(bexec, "ReplicaProcess", _CardHolder)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    ctl = ctl_mod.ServeController()
    monkeypatch.setattr(serve_api, "_controller", ctl)
    one = ScalingConfig(num_workers=1, use_gpu=True)
    groups = []
    try:
        serve.run(serve.deployment(echo, name="c8", num_replicas=3,
                                   ray_actor_options={"num_gpus": 1})
                  .bind())
        rep_cards = sorted(r.env["CUDA_VISIBLE_DEVICES"]
                           for r in ctl.get_replicas("c8"))
        assert rep_cards == ["0", "1", "2"]
        assert trainer_mod._available()["GPU"] == 1.0
        groups.append(bexec.WorkerGroup(one))
        assert [w.env["CUDA_VISIBLE_DEVICES"]
                for w in groups[0].workers] == ["3"]
        assert ctl_mod.CARDS.use() == {c: 1.0 for c in ids}
        assert trainer_mod._available()["GPU"] == 0.0
        # A second group does not fit: it waits its start timeout.
        monkeypatch.setattr(bexec, "WORKER_START_S", 0.3)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="do not fit"):
            bexec.WorkerGroup(one)
        assert time.monotonic() - t0 >= 0.3
        # More than the host has raises at once.
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="do not fit"):
            bexec.WorkerGroup(ScalingConfig(num_workers=5, use_gpu=True))
        assert time.monotonic() - t0 < 0.3
        # A replica drained away (the arbiter's shrink) frees a card the
        # waiting group takes; the serve side cannot take it back.
        monkeypatch.setattr(bexec, "WORKER_START_S", 30.0)
        timer = threading.Timer(
            0.2, lambda: ctl.pool_set_replicas("c8", 2, cap=2))
        timer.start()
        groups.append(bexec.WorkerGroup(one))
        timer.join()
        got = groups[1].workers[0].env["CUDA_VISIBLE_DEVICES"]
        assert got in rep_cards
        assert sorted([r.env["CUDA_VISIBLE_DEVICES"]
                       for r in ctl.get_replicas("c8")] + ["3", got]) == ids
        assert all(v <= 1.0 for v in ctl_mod.CARDS.use().values())
        # A group gives its shares back when it stops; the serve side
        # grows onto them.
        groups.pop().shutdown()
        ctl.pool_set_replicas("c8", 3, cap=None)
        assert _wait_for(lambda: len(ctl.get_replicas("c8")) == 3, 10)
        assert sorted(r.env["CUDA_VISIBLE_DEVICES"]
                      for r in ctl.get_replicas("c8")) == ["0", "1", "2"]
        assert ctl_mod.CARDS.use() == {c: 1.0 for c in ids}
    finally:
        for g in groups:
            g.shutdown()
        ctl.shutdown()
    assert all(v == 0.0 for v in ctl_mod.CARDS.use().values())
