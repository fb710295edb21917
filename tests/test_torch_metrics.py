"""The port's metrics registry and catalog against the JAX package's.

The counterpart of the rows of ``tests/test_metrics_lint.py`` for the
series the port emits: the same calls to JAX's and the port's
``Counter``, ``Gauge`` and ``Histogram`` render the same Prometheus
text, byte for byte; every series of the port's catalog has JAX's name,
kind, description, tag keys and boundaries; every ``mdefs.<NAME>`` the
port's sources use is in the port's catalog, and every series there is
used. Then the serving process's ``GET /metrics`` merge: this process's
registry with each live replica's samples, labelled by replica.
"""

import inspect
import os
import re
from concurrent.futures import Future

import pytest

from ray_tpu._private import metrics_defs as jdefs
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch._private import metrics_defs as tdefs
from ray_tpu_torch.util import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ray_tpu_torch")


def _catalog(mod, metric_cls):
    return {name: m for name, m in inspect.getmembers(mod)
            if isinstance(m, metric_cls)}


TCAT = _catalog(tdefs, tmetrics.Metric)
JCAT = _catalog(jdefs, jmetrics.Metric)


# --------------------------------------------------- the same rendering
def _script_counters(mod):
    c = mod.Counter("t_requests_total", "Requests by route", ("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2.5, tags={"route": "/b"})
    c.inc(tags={"route": "/a"})
    c.set_default_tags({"route": "/d"}).inc(4)
    bare = mod.Counter("t_bare_total", "No tags")
    bare.inc()


def _script_gauges(mod):
    g = mod.Gauge("t_depth", "Queue depth", ("deployment", "role"))
    g.set(3, tags={"deployment": "llm", "role": "decode"})
    g.set(1.25, tags={"role": "prefill", "deployment": "llm"})
    g.set(7, tags={"deployment": "llm", "role": "decode"})
    mod.Gauge("t_unset", "Never set", ("x",))


def _script_histograms(mod):
    h = mod.Histogram("t_latency_seconds", "Latency",
                      boundaries=(0.005, 0.1, 1.0), tag_keys=("engine",))
    for v in (0.001, 0.005, 0.05, 0.5, 5.0, 0.1):
        h.observe(v, tags={"engine": "slots8-0"})
    h.observe(2.0, tags={"engine": "slots4-1"})
    d = mod.Histogram("t_default_buckets", "Default buckets",
                      tag_keys=("k",))
    d.observe(0.3, tags={"k": "v"})
    d.observe(30.0, tags={"k": "v"})


def _script_mixed(mod):
    _script_counters(mod)
    _script_histograms(mod)
    _script_gauges(mod)


@pytest.mark.parametrize("script", [_script_counters, _script_gauges,
                                    _script_histograms, _script_mixed],
                         ids=lambda f: f.__name__[8:])
def test_same_calls_render_the_same_text(script, monkeypatch):
    for mod in (jmetrics, tmetrics):
        monkeypatch.setattr(mod, "_registry", [])
        script(mod)
    text = tmetrics.prometheus_text()
    assert text == jmetrics.prometheus_text()
    assert text.endswith("\n") and "# TYPE" in text
    assert tmetrics.collect_samples() == jmetrics.collect_samples()


def test_bucket_snapshot_and_percentile_match(monkeypatch):
    out = []
    for mod in (jmetrics, tmetrics):
        monkeypatch.setattr(mod, "_registry", [])
        _script_histograms(mod)
        (h,) = [m for m in mod.all_metrics()
                if m.name == "t_latency_seconds"]
        snap = h.bucket_snapshot({"engine": "slots8-0"})
        out.append((snap, mod.Histogram.percentile_from(snap[0], snap[1],
                                                        0.5)))
    assert out[0] == out[1]


# ---------------------------------------------------------- the catalog
@pytest.mark.parametrize("name", sorted(TCAT))
def test_series_matches_jax(name):
    port, jax_m = TCAT[name], JCAT.get(name)
    assert jax_m is not None, f"{name} is not in the JAX catalog"
    assert type(port).__name__ == type(jax_m).__name__
    assert port.name == jax_m.name
    assert port.description == jax_m.description
    assert port.tag_keys == jax_m.tag_keys
    assert getattr(port, "_bounds", None) == getattr(jax_m, "_bounds", None)


def test_catalog_lint_rows():
    """JAX's lint rows for the port's catalog: described, tagged,
    registered, counters named ``_total``."""
    registered = set(map(id, tmetrics.all_metrics()))
    assert len(TCAT) >= 40
    for m in TCAT.values():
        assert id(m) in registered
        assert m.name.startswith("ray_tpu_")
        assert m.description.strip() and m.tag_keys, m.name
        if isinstance(m, tmetrics.Counter):
            assert m.name.endswith("_total"), m.name
    assert tdefs._REQ_TAGS == jdefs._REQ_TAGS
    assert tdefs._KV_TRANSFER_TAGS == jdefs._KV_TRANSFER_TAGS


def _port_sources():
    for root, _, names in os.walk(PORT):
        for n in names:
            if n.endswith(".py"):
                path = os.path.join(root, n)
                with open(path) as f:
                    yield path, f.read()


def test_every_used_series_is_cataloged_and_every_series_used():
    used = set()
    for path, text in _port_sources():
        for name in re.findall(r"\bmdefs\.([A-Z][A-Z0-9_]*)\b", text):
            assert name in TCAT, f"{path} uses mdefs.{name}: not cataloged"
            used.add(name)
    assert set(TCAT) == used, f"cataloged, never emitted: {set(TCAT) - used}"


# -------------------------------------------------- the /metrics merge
class _SampledReplica:
    """A replica process that is never spawned: it answers ``samples``
    with the samples the test gives it."""

    made = []

    def __init__(self, name, cls_or_fn, init_args, init_kwargs,
                 is_function, sync_workers=1, env=None, num_threads=1):
        self.replica_id = f"{name}-{len(self.made)}"
        self.pid, self.dead, self.alive, self.ready = None, False, True, True
        self.samples = []
        self.made.append(self)

    def wait_ready(self, timeout_s):
        return {}

    def push_chaos(self, shared):
        pass

    def kill(self):
        self.alive = False

    stop = kill

    def control(self, op, *args):
        fut = Future()
        fut.set_result(self.samples if op == "samples" else
                       {"drained": True} if op == "drain" else {})
        return fut


def test_metrics_text_labels_each_live_replicas_samples(monkeypatch):
    from ray_tpu_torch.runtime import controller as ctl_mod

    monkeypatch.setattr(ctl_mod, "ReplicaProcess", _SampledReplica)
    _SampledReplica.made = []
    ctl = ctl_mod.ServeController()
    try:
        ctl.deploy("m", _SampledReplica, (), {}, 2, False)
        a, b = _SampledReplica.made
        tags = (("deployment", "m"), ("engine", "slots8-0"),
                ("role", "both"), ("tenant", ""))
        a.samples = [("ray_tpu_serve_request_ttft_seconds_count", tags, 12.0),
                     ("ray_tpu_serve_request_ttft_seconds_sum", tags, 1.5),
                     ("ray_tpu_cb_decode_tokens_total",
                      (("engine", "slots8-0"),), 372.0),
                     ("user_only_total", (), 1.0)]
        b.samples = [("ray_tpu_cb_decode_tokens_total",
                      (("engine", "slots8-0"),), 5.0)]
        text = ctl.metrics_text()
        lines = text.splitlines()
        assert text.endswith("\n")
        assert ('ray_tpu_serve_request_ttft_seconds_count{deployment="m",'
                'engine="slots8-0",role="both",tenant="",replica="m-0"} '
                '12.0') in lines
        decode = [ln for ln in lines
                  if ln.startswith("ray_tpu_cb_decode_tokens_total{")]
        assert decode == [
            'ray_tpu_cb_decode_tokens_total{engine="slots8-0",'
            'replica="m-0"} 372.0',
            'ray_tpu_cb_decode_tokens_total{engine="slots8-0",'
            'replica="m-1"} 5.0']
        # Under its family's TYPE line, which appears once.
        i = lines.index("# TYPE ray_tpu_cb_decode_tokens_total counter")
        assert lines[i + 1].startswith("ray_tpu_cb_decode_tokens_total{")
        assert text.count("# TYPE ray_tpu_cb_decode_tokens_total ") == 1
        assert "# TYPE user_only_total untyped" in lines
        # This process's own registry renders as prometheus_text does.
        assert set(tmetrics.prometheus_text().splitlines()) <= set(lines)
        # A dead replica's samples leave with it; no label is reused.
        b.alive = False
        assert 'replica="m-1"' not in ctl.metrics_text()
    finally:
        ctl.shutdown()


def _total(metric, **tags):
    return sum(v for name, key, v in metric.samples()
               if not name.endswith("_sum")
               and all(dict(key).get(k) == v2 for k, v2 in tags.items()))


def test_drain_and_death_record_events_and_series(monkeypatch):
    """A drain: ``serve.drain_begin`` and its ``serve.drain_end`` (caused
    by it), SERVE_REPLICA_DRAINS and SERVE_DRAIN_SECONDS; a replica found
    dead: SERVE_REPLICA_DEATHS (JAX ``serve/api.py:631-698, 1059``)."""
    import time

    from ray_tpu_torch._private import events
    from ray_tpu_torch.runtime import controller as ctl_mod

    monkeypatch.setattr(ctl_mod, "ReplicaProcess", _SampledReplica)
    _SampledReplica.made = []
    events.clear_flight()
    drains0 = _total(tdefs.SERVE_REPLICA_DRAINS, deployment="d",
                     cause="operator")
    secs0 = _total(tdefs.SERVE_DRAIN_SECONDS, deployment="d",
                   outcome="drained")
    deaths0 = _total(tdefs.SERVE_REPLICA_DEATHS, deployment="d",
                     cause="died")
    ctl = ctl_mod.ServeController()
    try:
        ctl.deploy("d", _SampledReplica, (), {}, 2, False)
        victim = _SampledReplica.made[-1]
        assert ctl.drain_replicas("d", 1) == 1
        deadline = time.monotonic() + 30
        while not events.local_events(types=["serve.drain_end"]) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        (begin,) = events.local_events(types=["serve.drain_begin"])
        (end,) = events.local_events(types=["serve.drain_end"])
        assert begin["subject"] == {"deployment": "d",
                                    "replica": victim.replica_id}
        assert end["cause"] == begin["event_id"]
        assert end["attrs"]["outcome"] == "drained"
        assert _total(tdefs.SERVE_REPLICA_DRAINS, deployment="d",
                      cause="operator") - drains0 == 1
        assert _total(tdefs.SERVE_DRAIN_SECONDS, deployment="d",
                      outcome="drained") - secs0 == 1
        _SampledReplica.made[0].alive = False
        while _total(tdefs.SERVE_REPLICA_DEATHS, deployment="d",
                     cause="died") == deaths0 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert _total(tdefs.SERVE_REPLICA_DEATHS, deployment="d",
                      cause="died") - deaths0 == 1
    finally:
        ctl.shutdown()
        events.clear_flight()


def test_checkpoint_plane_records_its_series(tmp_path, monkeypatch):
    """CKPT_BLOCK_MS, CKPT_SAVE_SECONDS, CKPT_BYTES and CKPT_SAVES on a
    save, CKPT_RESTORE_SECONDS and CKPT_BYTES on a restore, a failed
    persist counted (JAX ``checkpoint/plane.py:260, 365-376, 555-556``)."""
    import numpy as np
    import torch

    from ray_tpu_torch.checkpoint.plane import CheckpointPlane

    run = f"m{tmp_path.name}"
    plane = CheckpointPlane(str(tmp_path), run=run)
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": np.ones(5, np.float32)}
    rec = plane.save(1, state)
    assert rec["committed"] and rec["bytes"] == 68
    got = plane.restore()
    assert torch.equal(got["w"], state["w"])
    assert _total(tdefs.CKPT_BLOCK_MS, run=run) == 1
    assert _total(tdefs.CKPT_SAVE_SECONDS, run=run) == 1
    assert _total(tdefs.CKPT_RESTORE_SECONDS, run=run) == 1
    assert _total(tdefs.CKPT_BYTES, run=run, direction="save") == 68
    assert _total(tdefs.CKPT_BYTES, run=run, direction="restore") == 68
    assert _total(tdefs.CKPT_SAVES, run=run, outcome="committed") == 1

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(plane, "_write_shard_files", fail)
    with pytest.raises(OSError):
        plane.save(2, state)
    assert _total(tdefs.CKPT_SAVES, run=run, outcome="failed") == 1
    with pytest.raises(OSError):      # the failed persist, joined again
        plane.close()
