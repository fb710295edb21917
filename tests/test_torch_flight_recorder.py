"""The port's flight recorder against the JAX package's: the analogs of
``tests/test_flight_recorder.py``'s ring cases (emit shape and filters,
an emit that never raises, causal closure with the subject join,
overflow counted as loss, the chrome rendering, a kill's injection id
riding the death), with ``match_events``, ``causal_chain`` and
``flight_span_records`` of both packages held to the same answer on the
same records. The cross-process case (a chaos kill in a replica process
rooting the chain to its ``serve.resume`` in the serving process) is in
``tests/test_torch_serve_request_tracing.py``.
"""

import pytest

from ray_tpu._private import events as jflight
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as flight
from ray_tpu_torch.util import tracing


@pytest.fixture(autouse=True)
def _clean_ring():
    flight.clear_flight()
    yield
    flight.clear_flight()
    flight.set_local_sink(None)


def _seed_chain():
    """One preemption story: injection -> notice -> {mid-handoff abort,
    drain} -> resume, plus a reversal that shares only the lease subject,
    and one unrelated event that must stay out of the chain."""
    a = flight.emit("chaos.inject", subject={"node": "n1"},
                    action="preempt_node")
    b = flight.emit("preempt.notice", cause=a, subject={"node": "n1"})
    m = flight.emit("pool.handoff_preempted", cause=b,
                    subject={"lease_id": "L1", "node": "n1"})
    d = flight.emit("serve.drain_begin", cause=b,
                    subject={"deployment": "dep", "replica": "r0"})
    r = flight.emit("serve.resume", cause=d,
                    subject={"deployment": "dep", "request_id": "req-1"})
    e = flight.emit("pool.reversal", subject={"lease_id": "L1"},
                    winner="serve")
    noise = flight.emit("serve.autoscale", subject={"deployment": "other"})
    return a, b, m, d, r, e, noise


def test_emit_shape_and_ring_filters():
    a = flight.emit("chaos.inject", subject={"node": "n1", "blank": ""},
                    action="kill_worker")
    b = flight.emit("preempt.notice", cause=a, subject={"node": "n1"})
    c = flight.emit("serve.drain_begin", cause=b,
                    subject={"deployment": "d"})
    recs = flight.local_events()
    assert [r["event_id"] for r in recs] == [a, b, c]
    assert all(len(r["event_id"]) == 16 for r in recs)
    first = recs[0]
    assert first["subject"] == {"node": "n1"}
    assert first["attrs"] == {"action": "kill_worker"}
    assert first["cause"] == "" and recs[1]["cause"] == a
    assert first["worker_id"] == "serving" and first["node_id"] == ""

    assert [r["event_id"] for r in
            flight.local_events(types=["preempt.notice"])] == [b]
    assert [r["event_id"] for r in
            flight.local_events(subject={"node": "n1"})] == [a, b]
    assert len(flight.local_events(limit=2)) == 2
    assert len(flight.local_events(since=60)) == 3
    assert flight.local_events(until=60) == []

    assert flight.latest_event_id(["preempt.notice"]) == b
    assert flight.latest_event_id(
        ["serve.drain_begin"], subject={"deployment": "d"}) == c
    assert flight.latest_event_id(["no.such.type"]) == ""


@pytest.mark.parametrize("query", [
    {}, {"types": ["preempt.notice", "serve.resume"]},
    {"subject": {"node": "n1"}}, {"subject": {"lease_id": "L1"}},
    {"limit": 2}, {"types": ["chaos.inject"], "subject": {"node": "n2"}},
], ids=["all", "types", "node", "lease", "limit", "none"])
def test_match_events_equals_jax(query):
    _seed_chain()
    recs = flight.local_events(limit=100)
    assert flight.match_events(recs, **query) == \
        jflight.match_events(recs, **query)


def test_emit_never_raises_and_always_returns_an_id():
    def boom(batch):
        raise RuntimeError("sink down")

    flight.set_local_sink(boom)
    eid = flight.emit("pool.lease", subject={"lease_id": "L"})
    assert len(eid) == 16
    assert flight.local_events(types=["pool.lease"])[0]["event_id"] == eid
    # A record the transport cannot even build still yields an id.
    flight.set_local_sink(None)
    assert len(flight.emit("t.bad", subject=42)) == 16
    assert flight.local_events(types=["t.bad"]) == []


def test_sink_sees_each_record_and_ingest_keeps_it_once():
    got = []
    flight.set_local_sink(got.extend)
    eid = flight.emit("serve.drain_begin", subject={"deployment": "d"})
    flight.set_local_sink(None)
    assert [r["event_id"] for r in got] == [eid]
    # What a replica's sink sends lands in the serving process's ring.
    remote = dict(got[0], event_id="feedbeeffeedbeef", worker_id="llm-3")
    flight._ingest([remote])
    assert [r["event_id"] for r in flight.local_events()] == \
        [eid, "feedbeeffeedbeef"]


def test_causal_chain_closure_and_subject_join():
    a, b, m, d, r, e, noise = _seed_chain()
    recs = flight.local_events()
    chain = flight.causal_chain(recs, [r])
    ids = [x["event_id"] for x in chain]
    assert set(ids) == {a, b, m, d, r, e}
    assert noise not in ids
    assert ids == sorted(ids, key=lambda i: next(
        x["ts"] for x in chain if x["event_id"] == i))
    assert {x["event_id"] for x in flight.causal_chain(recs, [a])} \
        == {a, b, m, d, r, e}
    assert e not in {x["event_id"] for x in
                     flight.causal_chain(recs, [r], subject_rounds=0)}
    assert flight.causal_chain(recs, ["feedfacefeedface"]) == []


@pytest.mark.parametrize("seed,rounds", [("r", 1), ("a", 1), ("r", 0),
                                         ("noise", 2), ("m", 3)])
def test_causal_chain_equals_jax(seed, rounds):
    a, b, m, d, r, e, noise = _seed_chain()
    ids = dict(a=a, m=m, r=r, noise=noise)
    recs = flight.local_events(limit=100)
    assert flight.causal_chain(recs, [ids[seed]], rounds) == \
        jflight.causal_chain(recs, [ids[seed]], rounds)


def test_ring_overflow_is_counted_loss(monkeypatch):
    monkeypatch.setattr(flight, "FLIGHT_RING_MAX", 10)
    before = flight.dropped_counts().get("flight", 0.0)
    ids = [flight.emit("t.tick", seq=i) for i in range(25)]
    recs = flight.local_events(limit=100)
    assert [r["event_id"] for r in recs] == ids[-10:]
    assert flight.dropped_counts().get("flight", 0.0) - before == 15


def test_events_total_counts_each_type():
    from ray_tpu_torch._private import metrics_defs as mdefs

    def count(t):
        return sum(v for _, key, v in mdefs.EVENTS_TOTAL.samples()
                   if dict(key).get("type") == t)

    before = count("t.counted")
    for _ in range(3):
        flight.emit("t.counted")
    # Another process's records are counted in its own registry.
    flight._ingest([{"event_id": "x" * 16, "type": "t.counted"}])
    assert count("t.counted") - before == 3


def test_flight_events_render_in_chrome_timeline():
    a = flight.emit("chaos.inject", subject={"node": "n1"})
    flight.emit("preempt.notice", cause=a, subject={"node": "n1"})
    recs = flight.local_events()
    spans = flight.flight_span_records(recs)
    assert spans == jflight.flight_span_records(recs)
    evs = tracing.spans_to_chrome_events(spans)
    assert evs == jtracing.spans_to_chrome_events(spans)
    assert {"chaos.inject", "preempt.notice"} <= {e["name"] for e in evs}
    assert {"s", "f"} <= {e["ph"] for e in evs}


def test_kill_injection_id_rides_the_death(monkeypatch):
    monkeypatch.delenv("RAY_TPU_CHAOS_HARD_EXIT", raising=False)
    chaos.configure("kill_worker:rank=1,step=3", seed=7)
    try:
        assert chaos.inject("train_step", rank=1, step=2) is None
        with pytest.raises(chaos.SimulatedProcessDeath) as ei:
            chaos.inject("train_step", rank=1, step=3)
        assert ei.value.event_id
        assert chaos.injection_log()[0]["event_id"] == ei.value.event_id
        inj = flight.local_events(types=["chaos.inject"])[-1]
        assert inj["event_id"] == ei.value.event_id
        assert inj["attrs"] == {"action": "kill_worker",
                                "site": "train_step",
                                "rule": "kill_worker#0"}
    finally:
        chaos._clear_dying()
        chaos.reset()


def test_arbitrated_firing_is_recorded_in_the_serving_process():
    """A replica's capped firing: the serving process's arbitrate emits
    its chaos.inject and answers with that id, logged under it; a
    reported unlimited firing keeps the id the replica emitted."""
    chaos.configure("kill_replica:phase=decode;delay_tick:secs=0,times=-1",
                    seed=1)
    try:
        gen = chaos.state()[0]
        entry = {"action": "kill_replica", "site": "serve_replica",
                 "rule": "kill_replica#0",
                 "coords": {"phase": "decode", "deployment": "llm"}}
        eid = chaos.arbitrate(gen, "kill_replica#0", entry)
        assert len(eid) == 16
        assert chaos.arbitrate(gen, "kill_replica#0", entry) == ""
        (inj,) = flight.local_events(types=["chaos.inject"])
        assert inj["event_id"] == eid
        assert inj["subject"] == {"deployment": "llm"}
        reported = {"action": "delay_tick", "site": "serve_tick",
                    "rule": "delay_tick#1", "coords": {},
                    "event_id": "feedbeeffeedbeef"}
        assert chaos.arbitrate(gen, "delay_tick#1", reported) == \
            "feedbeeffeedbeef"
        assert [e["event_id"] for e in chaos.injection_log()] == \
            [eid, "feedbeeffeedbeef"]
        assert len(flight.local_events(types=["chaos.inject"])) == 1
    finally:
        chaos.reset()
