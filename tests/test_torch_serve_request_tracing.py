"""Request-path observability of the port: the analogs of
``tests/test_serve_request_tracing.py``'s engine cases on the port's CPU
engine at ``LlamaConfig.tiny`` (TTFT = queue + arena wait + prefill
within JAX's tolerance, one trace of engine spans a request in the sync
and buffered engines, the eviction path's spans and outcome, arena wait
apart from queue wait, tracing off keeps the metrics), the engine's
``CB_*`` and ``SERVE_REQ_OUTCOMES`` counts held to the JAX engine's on
the same converted weights and requests, and the serve path across a
replica process: an HTTP request leaves one connected trace in the
serving process (ingress, route and the replica's engine spans), the
replica's series show in the ingress's ``GET /metrics`` under
``replica=``, and a ``kill_replica`` firing's id is the ``cause`` of the
``serve.resume`` that follows.

The replica process imports this module by name (its deployment class
lives here), so JAX and the JAX package are imported inside the one test
that compares with them.
"""

import http.client
import json
import re
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as flight
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.llm import ContinuousLlamaDeployment
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve.proxy import _Router, ingress_request_context
from ray_tpu_torch.util import tracing

TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
TINY = dict(num_slots=2, max_len=64)
NAME = "traced"
PAYLOAD = {"prompt_token_ids": list(range(1, 9)), "max_tokens": 8}


def _params():
    return tl.init_params(TCFG, torch.Generator().manual_seed(3), "cpu")


class _Reporter:
    def __init__(self):
        self.records = []

    def add(self, record):
        self.records.append(record)


@pytest.fixture()
def span_capture(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACING", "1")
    rep = _Reporter()
    monkeypatch.setattr(tracing, "_reporter", rep)
    yield rep


@pytest.fixture(scope="module")
def tp():
    return _params()


def _engine(tp, **kw):
    return tcb.ContinuousBatcher(TCFG, params=tp, device="cpu",
                                 **{**TINY, **kw})


def _trace(request_id="req-1", trace_id="t" * 16, parent="p" * 16,
           deployment="llm", tenant=""):
    return {"request_id": request_id, "trace_id": trace_id,
            "parent_span_id": parent, "deployment": deployment,
            "tenant": tenant}


# ------------------------------------------------------------ the engine
def test_ttft_components_sum_to_measured_ttft(span_capture, tp):
    eng = _engine(tp)
    rid = eng.submit([1, 2, 3, 4], max_new_tokens=6, trace=_trace())
    out = eng.run_to_completion()
    assert len(out[rid]) == 6
    (bd,) = [b for b in eng.request_breakdowns if b["rid"] == rid]
    assert bd["outcome"] == "finished" and bd["tokens"] == 6
    comp = bd["queue_s"] + bd["arena_wait_s"] + bd["prefill_s"]
    assert comp == pytest.approx(bd["ttft_s"], rel=0.10, abs=5e-3), bd
    assert bd["tpot_s"] is not None and bd["tpot_s"] >= 0


@pytest.mark.parametrize("sync_every", [1, 4])
def test_engine_spans_share_trace_id(span_capture, tp, sync_every):
    """One submit yields queue + prefill + >= 1 decode-window span, all
    on the caller's trace id, the buffered engine's windows covering
    whole buffers."""
    eng = _engine(tp, sync_every=sync_every)
    t = _trace(request_id=f"req-s{sync_every}",
               trace_id=f"{sync_every}" * 16)
    rid = eng.submit([1, 2, 3], max_new_tokens=8, trace=t)
    assert len(eng.run_to_completion()[rid]) == 8
    spans = span_capture.records
    assert spans and all(s["trace_id"] == t["trace_id"] for s in spans)
    assert all(s["parent_span_id"] == t["parent_span_id"] for s in spans)
    assert all(s["request_id"] == t["request_id"] for s in spans)
    names = [s["name"] for s in spans]
    assert "engine.queue" in names and "engine.prefill" in names
    windows = [s for s in spans if s["name"] == "engine.decode_window"]
    assert windows, names
    # Every token after the first is in exactly one window.
    assert sum(s["tokens"] for s in windows) == 8 - 1
    if sync_every > 1:
        assert len(windows) < 8 - 1
    assert names[-1] == "engine.finished"
    assert eng._traced_live == 0


def test_window_spans_cap_into_a_tail(span_capture, tp):
    eng = _engine(tp)
    eng._MAX_WINDOWS = 3
    rid = eng.submit([1, 2, 3], max_new_tokens=10, trace=_trace())
    eng.run_to_completion()
    names = [s["name"] for s in span_capture.records]
    assert names.count("engine.decode_window") == 3
    (tail,) = [s for s in span_capture.records
               if s["name"] == "engine.decode_tail"]
    assert tail["tokens"] == 10 - 1 - 3 and tail["windows"] == 6
    assert rid not in eng._req_meta


def test_eviction_path_emits_trace_and_outcome(span_capture, tp):
    eng = _engine(tp)
    rid = eng.submit([1, 2, 3], max_new_tokens=30,
                     trace=_trace(request_id="req-evict",
                                  trace_id="e" * 16))
    eng.step()                       # admits + the first decode tick
    assert eng.cancel(rid)
    names = {s["name"] for s in span_capture.records
             if s["request_id"] == "req-evict"}
    assert {"engine.queue", "engine.prefill", "engine.evicted"} <= names
    (bd,) = [b for b in eng.request_breakdowns if b["rid"] == rid]
    assert bd["outcome"] == "evicted"

    eng2 = _engine(tp)
    rid2 = eng2.submit([1, 2], max_new_tokens=4,
                       trace=_trace(request_id="req-waiting",
                                    trace_id="f" * 16))
    assert eng2.cancel(rid2)
    spans = [s for s in span_capture.records
             if s["request_id"] == "req-waiting"]
    assert [s for s in spans if s["name"] == "engine.queue"]
    assert any(s.get("outcome") == "evicted" for s in spans)


def test_arena_wait_is_attributed_separately(span_capture, tp):
    eng = _engine(tp, paged=True, block_size=16, num_blocks=3)
    r1 = eng.submit([1, 2, 3], max_new_tokens=20,
                    trace=_trace(request_id="req-a", trace_id="a" * 16))
    r2 = eng.submit([4, 5, 6], max_new_tokens=20,
                    trace=_trace(request_id="req-b", trace_id="b" * 16))
    out = eng.run_to_completion()
    assert len(out[r1]) == 20 and len(out[r2]) == 20
    (bd2,) = [b for b in eng.request_breakdowns if b["rid"] == r2]
    assert bd2["arena_wait_s"] > 0, bd2
    assert any(s["name"] == "engine.arena_wait"
               for s in span_capture.records if s["request_id"] == "req-b")
    comp = bd2["queue_s"] + bd2["arena_wait_s"] + bd2["prefill_s"]
    assert comp == pytest.approx(bd2["ttft_s"], rel=0.10, abs=5e-3)


def test_tracing_disabled_records_no_windows_but_keeps_metrics(
        monkeypatch, tp):
    monkeypatch.delenv("RAY_TPU_TRACING", raising=False)
    rep = _Reporter()
    monkeypatch.setattr(tracing, "_reporter", rep)
    eng = _engine(tp)
    tag = eng._mtags["engine"]
    rid = eng.submit([1, 2, 3], max_new_tokens=5, trace=_trace())
    eng.run_to_completion()
    assert not rep.records and eng._traced_live == 0
    (bd,) = [b for b in eng.request_breakdowns if b["rid"] == rid]
    assert bd["ttft_s"] is not None and bd["outcome"] == "finished"
    counts = {name: v for name, key, v in mdefs.SERVE_REQ_TTFT.samples()
              if dict(key)["engine"] == tag}
    assert counts["ray_tpu_serve_request_ttft_seconds_count"] == 1
    assert dict(next(key for _, key, _ in mdefs.SERVE_REQ_TTFT.samples()
                     if dict(key)["engine"] == tag)) == {
        "deployment": "llm", "tenant": "", "engine": tag, "role": "both"}


def test_pressure_snapshot_and_replica_probe(tp):
    eng = _engine(tp, num_slots=1, paged=True, block_size=16)
    eng.submit([1, 2, 3], max_new_tokens=4)
    eng.submit([1, 2, 3], max_new_tokens=4)   # waits: one slot
    eng.step()
    snap = eng.pressure_snapshot()
    assert snap["queue_depth"] == 1 and snap["active_slots"] == 1
    assert snap["inflight_prefill_tokens"] == 3
    assert 0 <= snap["kv_blocks_free"] < snap["kv_blocks_total"]

    from ray_tpu_torch.runtime.replica import Replica

    class Engineish:
        def pressure(self):
            return {"queue_depth": 7, "kv_blocks_free": 9}

    rep = Replica(Engineish, (), {}, is_function=False, sync_workers=1)
    probe = rep.pressure()
    assert probe["queue_depth"] == 7 and probe["kv_blocks_free"] == 9
    assert probe["ongoing"] == 0 and "total" in probe
    assert isinstance(rep.samples(), list) and rep.samples()


_COUNTERS = ["CB_DECODE_TOKENS", "CB_PREFILL_REQUESTS", "CB_PREFILL_TOKENS",
             "CB_PREFIX_HIT_TOKENS", "CB_PREFIX_MISS_TOKENS",
             "CB_SPEC_DRAFT_TOKENS", "CB_SPEC_ACCEPTED_TOKENS",
             "SERVE_REQ_OUTCOMES"]
_GAUGES = ["CB_ACTIVE_SLOTS", "CB_WAITING_REQUESTS", "CB_SLOT_OCCUPANCY",
           "CB_KV_BLOCKS_USED", "CB_KV_BLOCKS_TOTAL", "CB_KV_FRAG_RATIO",
           "CB_KV_BLOCKS_CACHED", "CB_KV_BLOCKS_SHARED",
           "CB_SPEC_ACCEPT_RATE", "CB_SPEC_K"]
_COUNTED = ["CB_TICK_MS", "SERVE_REQ_TTFT", "SERVE_REQ_QUEUE",
            "SERVE_REQ_ARENA_WAIT", "SERVE_REQ_PREFILL", "SERVE_REQ_TPOT"]


def _engine_series(defs, tag):
    """The engine's series by (sample name, tags but the engine's): the
    counters and gauges, and each histogram's count."""
    out = {}
    for name in _COUNTERS + _GAUGES + _COUNTED:
        for sname, key, v in getattr(defs, name).samples():
            tags = dict(key)
            if tags.pop("engine", None) != tag or sname.endswith("_sum"):
                continue
            out[(sname,) + tuple(sorted(tags.items()))] = v
    return out


@pytest.mark.parametrize("case", [
    dict(paged=True, block_size=16),
    dict(paged=True, block_size=16, sync_every=4),
    dict(paged=False),
    dict(paged=True, block_size=16, spec_k=2, spec_draft_layers=1,
         spec_adaptive=False),
], ids=["paged-prefix", "buffered", "dense", "spec"])
def test_engine_counts_equal_jax(tp, case):
    """The same converted weights and request script through both
    engines: every CB_* counter and gauge, the outcome counts and each
    histogram's count are equal."""
    import jax
    import jax.numpy as jnp

    from ray_tpu._private import metrics_defs as jdefs
    from ray_tpu.models import continuous_batching as jcb
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.interop import params_to_numpy

    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    rng = np.random.default_rng(16)
    shared = list(map(int, rng.integers(1, 250, size=32)))
    prompts = [shared + list(map(int, rng.integers(1, 250, size=n)))
               for n in (3, 9, 17)] + [list(range(5, 12))]
    kw = dict(num_slots=3, max_len=128, **case)

    def drive(eng):
        rids = [eng.submit(p, max_new_tokens=6,
                           trace=_trace(request_id=f"r{i}"))
                for i, p in enumerate(prompts)]
        eng.step()
        assert eng.cancel(rids[-1])            # still queued: evicted
        out = eng.run_to_completion()
        return [out[r] for r in rids[:-1]]

    teng = tcb.ContinuousBatcher(TCFG, params=tp, device="cpu", **kw)
    jeng = jcb.ContinuousBatcher(jl.LlamaConfig.tiny(dtype=jnp.float32),
                                 params=jp, **kw)
    assert drive(teng) == drive(jeng)
    got = _engine_series(mdefs, teng._mtags["engine"])
    want = _engine_series(jdefs, jeng._mtags["engine"])
    assert got == want
    assert got[("ray_tpu_cb_decode_tokens_total",)] == 3 * 5
    outcomes = {dict(k[1:])["outcome"]: v for k, v in got.items()
                if k[0] == "ray_tpu_serve_request_outcomes_total"}
    assert outcomes == {"finished": 3, "evicted": 1}


def test_handoff_legs_are_observed(tp):
    """The transfer series of an in-process handoff: export and import
    each the payload's bytes and blocks, tagged with the deployment; a
    payload failing its crc counts SERVE_HANDOFFS ``crc_mismatch``."""
    from ray_tpu_torch.serve import kv_transfer

    def count(metric, **tags):
        return sum(v for name, key, v in metric.samples()
                   if not name.endswith("_sum")
                   and all(dict(key).get(k) == x for k, x in tags.items()))

    geo = dict(num_slots=2, max_len=64, paged=True, block_size=16)
    pre, dec = (_engine(tp, role=r, **geo) for r in ("prefill", "decode"))
    rid = pre.submit(list(range(1, 40)), max_new_tokens=4)
    pre.run_to_completion()
    payload = kv_transfer.export_kv(pre, rid, deployment="xfer")
    before = {d: count(mdefs.SERVE_KV_TRANSFER_BYTES, deployment="xfer",
                       direction=d) for d in ("export", "import")}
    kv_transfer.import_kv(dec, payload, deployment="xfer")
    for d in ("export", "import"):
        assert count(mdefs.SERVE_KV_TRANSFER_BYTES, deployment="xfer",
                     direction=d) == payload["nbytes"]
        assert count(mdefs.SERVE_KV_TRANSFER_BLOCKS, deployment="xfer",
                     direction=d) == payload["num_blocks"]
        assert count(mdefs.SERVE_KV_TRANSFER_SECONDS, deployment="xfer",
                     direction=d) == 1
    assert before == {"export": payload["nbytes"], "import": 0}
    bad = dict(payload, crc32=payload["crc32"] ^ 1)
    with pytest.raises(ValueError, match="crc"):
        kv_transfer.import_kv(dec, bad, deployment="xfer")
    assert count(mdefs.SERVE_HANDOFFS, deployment="xfer",
                 outcome="crc_mismatch") == 1


def test_weight_swap_emits_its_event_and_counts(tp):
    """``swap_weights``: the ``rl.weight_swap`` flight event, caused by
    the publish event a manifest names, RL_SWAPS by cause and RL_VERSION
    (JAX ``ray_tpu/llm/__init__.py:243-258``)."""
    dep = ContinuousLlamaDeployment._cls_or_fn(
        config=TCFG, params=tp, device="cpu", num_slots=2, max_len=64)
    try:
        flight.clear_flight()
        publish = flight.emit("rl.publish", subject={"run": "swap-test"})
        v = dep.swap_weights(tp, version=5, cause="publish",
                             manifest={"run": "swap-test",
                                       "event_id": publish,
                                       "ts": time.time()})
        assert v == 5
        (ev,) = flight.local_events(types=["rl.weight_swap"])
        assert ev["cause"] == publish
        assert ev["subject"] == {"run": "swap-test"}
        assert ev["attrs"]["version"] == 5 and \
            ev["attrs"]["swap_cause"] == "publish"
        assert ev["attrs"]["e2e_seconds"] >= 0
        swaps = {dict(k)["cause"]: x for _, k, x in mdefs.RL_SWAPS.samples()
                 if dict(k)["run"] == "swap-test"}
        assert swaps == {"publish": 1}
        assert [x for _, k, x in mdefs.RL_VERSION.samples()
                if dict(k) == {"run": "swap-test", "role": "generator"}] \
            == [5]
    finally:
        dep.close()
        flight.clear_flight()


# ------------------------------------------- across the replica process
class Traced(ContinuousLlamaDeployment._cls_or_fn):
    """The port's LLM deployment on the CPU with fixed tiny weights."""

    def __init__(self, **engine):
        super().__init__(config=TCFG, params=_params(), device="cpu",
                         **engine)


@pytest.fixture(scope="module")
def traced_app():
    mp = pytest.MonkeyPatch()
    mp.setenv("RAY_TPU_TRACING", "1")   # inherited by the replica
    serve.shutdown()
    handle = serve.run(serve.deployment(Traced, name=NAME, num_replicas=1)
                       .bind(num_slots=4, max_len=128))
    port = serve.start_http(port=0)
    yield handle, port
    serve.shutdown()
    mp.undo()


def _replica(timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    controller = serve_api._get_controller()
    while time.monotonic() < deadline:
        reps = controller.get_replicas(NAME)
        if reps and all(r.alive for r in reps):
            try:
                if reps[0].control("health").result(timeout=10):
                    return reps[0]
            except Exception:  # noqa: BLE001 — dying: keep waiting
                pass
        time.sleep(0.1)
    raise AssertionError(f"no routed replica of {NAME}")


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp, body


def _series(text, name, **labels):
    """Sum of ``name``'s sample values whose labels include ``labels``."""
    total = 0.0
    for line in text.splitlines():
        m = re.match(r"^(\w+)\{(.*)\} (\S+)$", line)
        if not m or m.group(1) != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2)))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(m.group(3))
    return total


def _stream_http(port, payload, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", f"/{NAME}/stream/generate",
                 body=json.dumps(payload),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    assert resp.status == 200
    items = [json.loads(line) for line in resp.read().splitlines() if line]
    conn.close()
    return items


def _request_spans(request_id, want, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    trace = []
    while time.monotonic() < deadline:
        trace = tracing.local_spans(request_id=request_id)
        if want <= {s["name"] for s in trace}:
            return trace
        time.sleep(0.05)
    return trace


def test_http_request_yields_one_connected_trace_and_metrics(traced_app):
    _, port = traced_app
    replica = _replica()
    tag = {"replica": replica.replica_id, "deployment": NAME}
    _, before = _get(port, "/metrics")
    req_id = "req-http-0123456789abcdef"
    tokens = _stream_http(port, PAYLOAD, {"x-request-id": req_id,
                                          "serve_multiplexed_model_id":
                                          "lora-7"})
    assert len(tokens) == PAYLOAD["max_tokens"]
    want = {"serve.ingress", "serve.route", "engine.queue",
            "engine.prefill", "engine.decode_window", "engine.finished"}
    trace = _request_spans(req_id, want)
    assert want <= {s["name"] for s in trace}, trace
    assert len({s["trace_id"] for s in trace}) == 1
    assert tracing.connected(trace)
    by_id = {s["span_id"]: s for s in trace}
    ingress = next(s for s in trace if s["name"] == "serve.ingress")
    route = next(s for s in trace if s["name"] == "serve.route")
    assert ingress["parent_span_id"] == "" and route["parent_span_id"] == \
        ingress["span_id"]
    assert ingress["worker_id"] == route["worker_id"] == "serving"
    engine = [s for s in trace if s["name"].startswith("engine.")]
    assert all(by_id[s["parent_span_id"]]["name"] == "serve.route"
               and s["worker_id"] == replica.replica_id for s in engine)
    q, p = (next(s for s in engine if s["name"] == n)
            for n in ("engine.queue", "engine.prefill"))
    wait = sum(s["dur"] for s in engine if s["name"] == "engine.arena_wait")
    ttft = p["ts"] + p["dur"] - q["ts"]
    assert q["dur"] + wait + p["dur"] == pytest.approx(ttft, rel=0.10,
                                                       abs=5e-3)
    windows = [s for s in engine if s["name"] == "engine.decode_window"]
    assert sum(s["tokens"] for s in windows) == len(tokens) - 1

    resp, after = _get(port, "/metrics")
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith("text/plain")
    ttft_n = "ray_tpu_serve_request_ttft_seconds_count"
    assert _series(after, ttft_n, tenant="lora-7", **tag) - \
        _series(before, ttft_n, tenant="lora-7", **tag) == 1
    decoded = "ray_tpu_cb_decode_tokens_total"
    assert _series(after, decoded, replica=replica.replica_id) - \
        _series(before, decoded, replica=replica.replica_id) == \
        len(tokens) - 1
    prefilled = "ray_tpu_cb_prefill_tokens_total"
    assert _series(after, prefilled, replica=replica.replica_id) - \
        _series(before, prefilled, replica=replica.replica_id) == \
        len(PAYLOAD["prompt_token_ids"])
    # The serving process's own series, unlabelled by replica.
    assert _series(after, "ray_tpu_serve_requests_total",
                   deployment=NAME) > _series(
        before, "ray_tpu_serve_requests_total", deployment=NAME)


def test_chaos_kill_id_is_the_cause_of_the_resume(traced_app):
    _, port = traced_app
    replica = _replica()
    baseline = list(_Router().stream(NAME, "generate", PAYLOAD))
    flight.clear_flight()
    resumes0 = sum(v for _, key, v in mdefs.SERVE_REPLICA_RESUMES.samples()
                   if dict(key) == {"deployment": NAME, "cause": "resume"})
    rctx = ingress_request_context(NAME, request_id="req-kill")
    chaos.configure("kill_replica:phase=decode,token=3", seed=7)
    try:
        s = _Router().stream(NAME, "generate", PAYLOAD, request_ctx=rctx)
        out = list(s)
        (kill,) = [e for e in chaos.injection_log()
                   if e["action"] == "kill_replica"]
    finally:
        chaos.configure(None)
    assert out == baseline
    assert s.journal.resumes == 1 and s.journal.resumed_midstream
    eid = kill["event_id"]
    (inj,) = flight.local_events(types=["chaos.inject"])
    assert inj["event_id"] == eid and inj["cause"] == ""
    (resume,) = flight.local_events(types=["serve.resume"])
    assert resume["cause"] == eid
    assert resume["subject"] == {"deployment": NAME,
                                 "request_id": "req-kill"}
    chain = flight.causal_chain(flight.local_events(limit=100000), [eid])
    assert resume["event_id"] in {r["event_id"] for r in chain}
    assert sum(v for _, key, v in mdefs.SERVE_REPLICA_RESUMES.samples()
               if dict(key) == {"deployment": NAME,
                                "cause": "resume"}) - resumes0 == 1
    # One trace across both replicas, the resume marked in it.
    spans = tracing.local_spans(request_id="req-kill")
    assert "serve.resume" in {x["name"] for x in spans}
    assert len({x["worker_id"] for x in spans
                if x["name"] == "engine.prefill"}) == 2
    # The dead replica's samples left /metrics; its respawn has its own.
    fresh = _replica()
    assert fresh.replica_id != replica.replica_id
    _, text = _get(port, "/metrics")
    assert f'replica="{replica.replica_id}"' not in text
    assert f'replica="{fresh.replica_id}"' in text
