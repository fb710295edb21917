"""The port's chaos harness (:mod:`ray_tpu_torch._private.chaos`) against
the JAX package's (``ray_tpu._private.chaos``) on the CPU: the same spec
and seed fire at the same coordinates over one sequence of ``inject``
calls, with the same directives and injection-log entries; the parse
and its errors are JAX's; and the serving process's side of a plan
shared with replica processes (``state``, ``install``, ``arbitrate``,
the listeners).
"""

import pytest

from ray_tpu._private import chaos as jchaos
from ray_tpu_torch._private import chaos as tchaos

SPEC = ("kill_transfer:stage=import;delay_transfer:stage=export,secs=0.001;"
        "delay_tick:secs=0.001,times=-1,p=0.5;drop_pressure:times=3;"
        "slow_step:rank=1,secs=0.001,jitter=0.5,times=-1;"
        "kill_replica:phase=decode,token=2,times=2;"
        "fail_shard_write:step=4,times=2;perturb_learner:rank=0,eps=0.01")

# One sequence of injection sites and coordinates.
CALLS = ([("kv_transfer", dict(stage="export", rid=i)) for i in range(2)]
         + [("serve_tick", dict(engine="slots8-0", tick=t))
            for t in range(12)]
         + [("serve_pressure", dict(deployment="llm"))] * 5
         + [("train_step", dict(rank=r, step=s)) for r in (0, 1)
            for s in range(6)]
         + [("serve_replica", dict(phase="decode", token=t))
            for t in (0, 1, 2, 2, 2, 3)]
         + [("kv_transfer", dict(stage="import", rid=3))] * 2
         + [("ckpt_shard_write", dict(step=4))] * 3
         + [("learner_weights", dict(rank=0)), ("learner_weights",
                                                dict(rank=1))])


@pytest.fixture(autouse=True)
def _clean():
    yield
    tchaos.configure(None)
    jchaos.configure(None)


def _drive(mod, spec, seed):
    """Configure ``mod`` and run CALLS: (outcome per call, log)."""
    mod.configure(spec, seed=seed)
    out = []
    for site, coords in CALLS:
        try:
            d = mod.inject(site, **coords)
            out.append(None if d is None else
                       {k: v for k, v in d.items() if k != "event_id"})
        except mod.SimulatedProcessDeath as e:
            out.append(("died", type(e).__name__))
            mod._clear_dying()
        except OSError as e:
            out.append(("oserror", str(e)))
    log = [{k: e[k] for k in ("seq", "action", "site", "rule", "coords")}
           for e in mod.injection_log()]
    return out, log


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_same_spec_and_seed_fire_alike(seed, monkeypatch):
    monkeypatch.delenv("RAY_TPU_CHAOS_HARD_EXIT", raising=False)
    got = _drive(tchaos, SPEC, seed)
    want = _drive(jchaos, SPEC, seed)
    assert got == want
    assert any(o is not None for o in got[0])
    assert any(e["action"] == "kill_transfer" for e in got[1])


def test_parse_and_unknown_actions_as_jax():
    tp = tchaos.ChaosPlan.parse(SPEC, seed=3)
    jp = jchaos.ChaosPlan.parse(SPEC, seed=3)
    assert [(r.action, r.site, r.id, r.params, r.match, r.times, r.p)
            for r in tp.rules] == \
        [(r.action, r.site, r.id, r.params, r.match, r.times, r.p)
         for r in jp.rules]
    assert tchaos._ACTION_SITES == jchaos._ACTION_SITES
    for bad in ("explode:rank=1", "kill_transfer:stage=import;nope"):
        with pytest.raises(ValueError) as te:
            tchaos.ChaosPlan.parse(bad)
        with pytest.raises(ValueError) as je:
            jchaos.ChaosPlan.parse(bad)
        assert str(te.value) == str(je.value)


def test_env_plan_and_no_plan(monkeypatch):
    tchaos.reset()
    assert not tchaos.enabled() and tchaos.inject("serve_tick") is None
    monkeypatch.setenv("RAY_TPU_CHAOS", "drop_pressure:times=1")
    monkeypatch.setenv("RAY_TPU_CHAOS_SEED", "5")
    tchaos.reset()                       # the env is read again lazily
    assert tchaos.current_plan().seed == 5
    assert tchaos.inject("serve_pressure")["drop"] is True
    assert tchaos.inject("serve_pressure") is None     # times=1 spent
    tchaos.configure(None)               # programmatic wins over the env
    assert not tchaos.enabled()


def test_shared_state_and_arbitration():
    """The serving process's side of a plan shared with replicas: the
    state a replica installs, the arbiter's grants (each counted and
    logged once; a spent rule or a stale plan refused) and the
    listeners told of every capped firing."""
    calls = []

    def listener():
        calls.append(1)

    tchaos.subscribe(listener)
    try:
        plan = tchaos.configure("kill_transfer:stage=export;"
                                "delay_tick:secs=0.01,times=-1", seed=2)
        gen, shared_plan, fired = tchaos.state()
        assert shared_plan is plan and fired == {}
        assert len(calls) == 1                          # configure
        entry = {"action": "kill_transfer", "site": "kv_transfer",
                 "rule": "kill_transfer#0", "coords": {"stage": "export"}}
        assert tchaos.arbitrate(gen, "kill_transfer#0", entry)
        assert not tchaos.arbitrate(gen, "kill_transfer#0", entry)
        assert len(calls) == 2                          # the capped firing
        assert tchaos.arbitrate(gen, "delay_tick#1", entry)
        assert tchaos.arbitrate(gen, "delay_tick#1", entry)
        assert len(calls) == 2                          # unlimited: quiet
        assert not tchaos.arbitrate(gen - 1, "delay_tick#1", entry)
        assert not tchaos.arbitrate(gen, "no_such#9", entry)
        assert tchaos.state()[2] == {"kill_transfer#0": 1,
                                     "delay_tick#1": 2}
        assert [e["seq"] for e in tchaos.injection_log()] == [0, 1, 2]
        # A replica installing the state has the kill spent: its own
        # inject does not fire it again.
        shared = tchaos.state()
        tchaos.configure(None)
        tchaos.install(shared)
        assert tchaos.inject("kv_transfer", stage="export") is None
        # A later push of the same plan keeps the larger counts.
        tchaos.install((shared[0], shared[1], {"kill_transfer#0": 0}))
        assert tchaos.state()[2]["kill_transfer#0"] == 1
        assert tchaos.state()[2]["delay_tick#1"] == 2
    finally:
        tchaos.unsubscribe(listener)


def test_arbiter_decides_a_replica_firing(monkeypatch):
    """In a replica (an arbiter installed) a refused firing does not
    act; a granted one does, and is counted there too."""
    monkeypatch.delenv("RAY_TPU_CHAOS_HARD_EXIT", raising=False)
    asked = []

    def arbiter(generation, rule, entry):
        asked.append((rule.id, entry["coords"]))
        return len(asked) > 1

    tchaos.configure("drop_pressure:times=2", seed=0)
    tchaos.set_arbiter(arbiter)
    try:
        assert tchaos.inject("serve_pressure", deployment="a") is None
        assert tchaos.inject("serve_pressure", deployment="b")["drop"]
        assert tchaos.inject("serve_pressure", deployment="c")["drop"]
        assert tchaos.inject("serve_pressure", deployment="d") is None
        assert [c["deployment"] for _, c in asked] == ["a", "b", "c"]
        assert [e["coords"]["deployment"]
                for e in tchaos.injection_log()] == ["b", "c"]
    finally:
        tchaos.set_arbiter(None)
