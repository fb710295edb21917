"""The port's request tracing against ``ray_tpu/util/tracing.py``:
``spans_to_chrome_events`` gives JAX's events on the same records, span
records keep JAX's shape, context managers nest as JAX's do, and tracing
off adds no span (the counterpart of ``tests/test_tracing.py``'s
``test_tracing_disabled_adds_no_spans``; its cluster cases carry a trace
across task specs, which the port has no counterpart of: a serve
request's context rides its payload, held by
``tests/test_torch_serve_request_tracing.py``)."""

import pytest

from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.util import tracing


class _Reporter:
    def __init__(self):
        self.records = []

    def add(self, record):
        self.records.append(record)


@pytest.fixture
def capture(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACING", "1")
    rep = _Reporter()
    monkeypatch.setattr(tracing, "_reporter", rep)
    return rep


def _story():
    """An ingress span, a route span under it (chosen id), engine spans
    under the route, a nested pair, and a span whose parent is missing."""
    t = tracing.gen_id()
    ingress = tracing.gen_id()
    with tracing.explicit_span("serve.route", trace_id=t,
                               parent_span_id=ingress, kind="route",
                               request_id="r1") as route:
        tracing.emit_span("engine.queue", trace_id=t, ts=100.0, dur=0.25,
                          parent_span_id=route, kind="engine",
                          request_id="r1")
        tracing.emit_span("engine.prefill", trace_id=t, ts=100.25,
                          dur=0.0, parent_span_id=route, kind="engine")
    tracing.emit_span("serve.ingress", trace_id=t, span_id=ingress,
                      ts=99.0, dur=2.0, kind="ingress", request_id="r1")
    with tracing.span("outer", trace_id=t, parent_span_id=ingress):
        with tracing.span("inner"):
            pass
    tracing.emit_span("orphan", trace_id=t, ts=1.0, dur=1.0,
                      parent_span_id="feedfacefeedface")
    return t, ingress, route


def test_chrome_events_equal_jax(capture):
    _story()
    recs = capture.records
    assert tracing.spans_to_chrome_events(recs) == \
        jtracing.spans_to_chrome_events(recs)
    evs = tracing.spans_to_chrome_events(recs)
    flows = [e for e in evs if e["cat"] == "flow"]
    # One arrow pair per span whose parent is in the records.
    assert len(flows) == 2 * 5


def test_records_keep_jax_shape_and_nesting(capture):
    t, ingress, route = _story()
    by_name = {r["name"]: r for r in capture.records}
    keys = {"state", "name", "kind", "task_id", "trace_id", "span_id",
            "parent_span_id", "ts", "dur", "worker_id", "node_id"}
    assert all(keys <= set(r) for r in capture.records)
    assert by_name["serve.route"]["span_id"] == route
    assert by_name["serve.route"]["parent_span_id"] == ingress
    assert by_name["engine.queue"]["parent_span_id"] == route
    assert by_name["engine.queue"]["request_id"] == "r1"
    assert by_name["inner"]["parent_span_id"] == \
        by_name["outer"]["span_id"]
    assert by_name["inner"]["trace_id"] == t
    assert tracing.current() is None      # every context restored


def test_connected_trace_rule(capture):
    _story()
    recs = [r for r in capture.records if r["name"] != "orphan"]
    assert tracing.connected(recs)
    assert not tracing.connected(capture.records)     # the orphan
    assert not tracing.connected(
        recs + [dict(recs[0], trace_id="other", span_id="x")])
    assert not tracing.connected(
        [r for r in recs if r["name"] != "serve.ingress"])


@pytest.mark.parametrize("fn", ["emit_span", "explicit_span", "span"])
def test_tracing_disabled_adds_no_span(fn, monkeypatch):
    monkeypatch.delenv("RAY_TPU_TRACING", raising=False)
    before = len(tracing.local_spans())
    rep = _Reporter()
    monkeypatch.setattr(tracing, "_reporter", rep)
    if fn == "emit_span":
        assert tracing.emit_span("x", trace_id="t", ts=0.0, dur=1.0) == ""
    elif fn == "explicit_span":
        with tracing.explicit_span("x", trace_id="t") as sid:
            assert sid is None
    else:
        with tracing.span("x") as sid:
            assert sid is None
    assert rep.records == [] and len(tracing.local_spans()) == before
    assert tracing.current() is None


def test_ring_sink_ingest_and_query(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACING", "1")
    tracing.clear_spans()
    sent = []
    tracing.set_local_sink(sent.extend)
    try:
        sid = tracing.emit_span("engine.queue", trace_id="t1", ts=1.0,
                                dur=0.5, request_id="req-a")
    finally:
        tracing.set_local_sink(None)
    assert [r["span_id"] for r in sent] == [sid]
    # A replica's record, as the serving process receives it.
    tracing._ingest([dict(sent[0], span_id="s2", worker_id="llm-0")])
    tracing.emit_span("other", trace_id="t2", ts=1.0, dur=0.0)
    assert [r["span_id"] for r in tracing.local_spans(
        request_id="req-a")] == [sid, "s2"]
    assert len(tracing.local_spans(trace_id="t2")) == 1
    tracing.clear_spans()
    assert tracing.local_spans() == []


def test_span_ring_overflow_is_counted(monkeypatch):
    from ray_tpu_torch._private import events

    monkeypatch.setenv("RAY_TPU_TRACING", "1")
    monkeypatch.setattr(tracing, "SPAN_RING_MAX", 5)
    tracing.clear_spans()
    before = events.dropped_counts().get("spans", 0.0)
    for i in range(8):
        tracing.emit_span("t", trace_id="t", ts=float(i), dur=0.0)
    assert [r["ts"] for r in tracing.local_spans()] == [3.0, 4.0, 5.0,
                                                         6.0, 7.0]
    assert events.dropped_counts().get("spans", 0.0) - before == 3
    tracing.clear_spans()
