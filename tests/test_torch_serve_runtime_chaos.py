"""The port's serve runtime under the chaos sites it shares with the JAX
package (``kill_replica`` mid-prefill, mid-decode and while draining,
``delay_tick``, ``drop_pressure``: the cases of
``tests/test_serve_drain.py``), whose plan the controller carries into
the replica processes. Split from ``tests/test_torch_serve_runtime.py``,
whose deployment (:class:`Svc`, two replica processes, module-scoped
here too), fixtures and helpers it uses, so the test runner can spread
the file's minutes over its workers. Like that module it imports neither
JAX nor the JAX package at the top.
"""

import http.client
import threading
import time

import pytest

from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch.exceptions import ResumeExhaustedError
from ray_tpu_torch.serve.proxy import _Router
from test_torch_serve_runtime import (NAME, PAYLOAD, Pressy, _lines,
                                      _post, _stream, _wait_replicas, app,
                                      store)


# ------------------------------------------------------------ chaos sites
def _kills(action="kill_replica"):
    return [e for e in chaos.injection_log() if e["action"] == action]


def test_chaos_kill_mid_decode_greedy_resume_equals_uninterrupted(app):
    """kill_replica:phase=decode,token=3: a replica process ends itself
    with 3 tokens streamed; the resumed stream equals the uninterrupted
    one, and the firing is in the serving process's log."""
    _wait_replicas()
    baseline = list(_stream(PAYLOAD))
    assert len(baseline) == PAYLOAD["max_tokens"]
    chaos.configure("kill_replica:phase=decode,token=3", seed=7)
    try:
        s = _stream(PAYLOAD)
        out = list(s)
        kills = _kills()
    finally:
        chaos.configure(None)
    assert out == baseline
    assert s.journal.resumes == 1 and s.journal.resumed_midstream
    assert not s.journal.needs_marker
    assert len(kills) == 1 and kills[0]["coords"]["token"] == 3
    assert kills[0]["event_id"]
    _wait_replicas()


def test_chaos_kill_mid_prefill_resubmits(app):
    _wait_replicas()
    baseline = list(_stream(PAYLOAD))
    chaos.configure("kill_replica:phase=prefill", seed=7)
    try:
        s = _stream(PAYLOAD)
        assert list(s) == baseline
        assert len(_kills()) == 1
    finally:
        chaos.configure(None)
    assert s.journal.resumes == 1 and not s.journal.resumed_midstream
    _wait_replicas()


def test_chaos_spent_resume_budget_is_typed(app, monkeypatch):
    """times=2 across both replicas: the first kill takes the budget's
    one resume, the resumed attempt is killed again (its token count
    restarts, so the same coordinates match) and the caller sees the
    typed error."""
    _wait_replicas()
    monkeypatch.setenv("RAY_TPU_SERVE_MAX_RESUMES", "1")
    chaos.configure("kill_replica:phase=decode,token=2,times=2", seed=7)
    try:
        with pytest.raises(ResumeExhaustedError):
            list(_stream(PAYLOAD))
        assert len(_kills()) == 2
    finally:
        chaos.configure(None)
    _wait_replicas()


def test_chaos_spent_rule_stays_spent_after_a_respawn(app):
    """A times=1 kill fires once: the respawned replica gets the plan
    with its firing spent and serves the same request unharmed."""
    reps = _wait_replicas()
    baseline = list(_stream(PAYLOAD))
    chaos.configure("kill_replica:phase=prefill", seed=3)
    try:
        s = _stream(PAYLOAD)
        assert list(s) == baseline and s.journal.resumes == 1
        fresh = _wait_replicas()
        (respawned,) = [r for r in fresh
                        if r.pid not in {old.pid for old in reps}]
        assert respawned.call("chaos_fired", (), {}).result(timeout=30) \
            == {"kill_replica#0": 1}
        st = respawned.stream("generate", (PAYLOAD,), {})
        toks = []
        while True:
            try:
                toks.append(st.next(60))
            except StopIteration:
                break
        assert toks == baseline
        assert len(_kills()) == 1
    finally:
        chaos.configure(None)


def test_chaos_sampled_resume_sends_the_marker_over_http(app):
    _, port = app
    _wait_replicas()
    chaos.configure("kill_replica:phase=decode,token=2", seed=7)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        resp, body = _post(conn, f"/{NAME}/stream/generate",
                           {**PAYLOAD, "temperature": 0.7})
        conn.close()
    finally:
        chaos.configure(None)
    assert resp.status == 200
    items = _lines(body)
    assert len([i for i in items if isinstance(i, int)]) == \
        PAYLOAD["max_tokens"]
    assert [i for i in items if isinstance(i, dict)] == \
        [{"x-ray-tpu-resumed": 1}]
    _wait_replicas()


def test_chaos_drain_under_delayed_ticks_drops_nothing(app):
    """delay_tick stutters every engine tick (an unlimited rule, reported
    by each replica) while a drain takes a replica out under 4 streams:
    every stream completes."""
    _wait_replicas()
    chaos.configure("delay_tick:secs=0.05,times=-1", seed=3)
    results, errors = {}, []

    def run_one(i):
        try:
            p = {"prompt_token_ids": list(range(1 + i, 9 + i)),
                 "max_tokens": 16}
            results[i] = list(_stream(p))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=run_one, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.4)                   # streams mid-decode
        assert serve.drain(NAME, 1) == 1
        for t in threads:
            t.join(timeout=90)
        delays = _kills("delay_tick")
    finally:
        chaos.configure(None)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(len(v) for v in results.values()) == [16] * 4
    assert delays and {e["site"] for e in delays} == {"serve_tick"}
    _wait_replicas()


def test_chaos_death_while_draining_falls_back_to_resume(app):
    """kill_replica:phase=drain: the draining replica that still serves
    the stream ends itself in its drain wait; the stream resumes on a
    replacement with the uninterrupted tokens."""
    _wait_replicas()
    payload = {"prompt_token_ids": list(range(1, 9)), "max_tokens": 24}
    baseline = list(_stream(payload))
    chaos.configure(
        "delay_tick:secs=0.08,times=-1;kill_replica:phase=drain,times=1",
        seed=5)
    box = {}
    try:
        t = threading.Thread(target=lambda: box.update(
            out=list(_stream(payload))))
        t.start()
        time.sleep(0.3)
        assert serve.drain(NAME, 2) == 2
        t.join(timeout=120)
        kills = _kills()
    finally:
        chaos.configure(None)
    assert not t.is_alive()
    assert box["out"] == baseline
    assert len(kills) == 1 and kills[0]["coords"]["phase"] == "drain"
    _wait_replicas()


def test_chaos_unary_budget_exhaustion_is_typed(app, monkeypatch):
    handle, _ = app
    _wait_replicas()
    monkeypatch.setenv("RAY_TPU_SERVE_MAX_RESUMES", "0")
    chaos.configure("kill_replica:phase=prefill,times=1", seed=9)
    try:
        with pytest.raises(ResumeExhaustedError):
            handle.remote(PAYLOAD).result(timeout_s=60)
    finally:
        chaos.configure(None)
    _wait_replicas()


def test_chaos_dropped_pressure_never_sheds_on_a_drained_replica(
        monkeypatch):
    """The gate sheds on a saturated replica; once it drains, the route
    change clears its snapshot, and with every later pressure fetch
    dropped (drop_pressure, in the serving process) the gate admits
    instead of shedding on the stale entry."""
    monkeypatch.setenv("RAY_TPU_SHED_QUEUE_DEPTH", "5")
    serve.run(serve.deployment(Pressy, name="PressyDrain").bind())
    try:
        gate = _Router().gate
        deadline = time.monotonic() + 20
        shed = None
        while time.monotonic() < deadline and shed is None:
            shed = gate.check("PressyDrain")
            time.sleep(0.1)
        assert shed is not None and shed[1] == "pressure"
        chaos.configure("drop_pressure:times=-1", seed=2)
        assert serve.drain("PressyDrain", 1) == 1
        deadline = time.monotonic() + 20
        admitted = False
        while time.monotonic() < deadline and not admitted:
            admitted = gate.check("PressyDrain") is None
            time.sleep(0.1)
        assert admitted
        assert _kills("drop_pressure")
    finally:
        chaos.configure(None)
        serve.delete("PressyDrain")
