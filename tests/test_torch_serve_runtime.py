"""The port's serve runtime on the CPU: replica processes spawned by the
controller, the handle, the recovery journal and the HTTP ingress.

The counterparts of ``tests/test_serve.py`` (class and function
deployments, balance over replicas, method calls, streaming, batching, a
dead replica respawned), ``tests/test_serve_drain.py`` (a drain stops
admitting and reports; a drain under load drops nothing; a kill
mid-decode resumes to the uninterrupted stream's greedy tokens; a kill
while queued resubmits; a spent budget is typed; the sampled marker over
HTTP) and ``tests/test_serve_ingress.py`` (keep-alive, healthz and
routes, NDJSON streaming, an error that leaves the connection up, private
methods and chunked bodies refused, the multiplex header), and an HTTP
e2e whose greedy tokens equal the in-process engine's and the JAX
package's engine's on the same weights.

Recovery is driven two ways: by a SIGKILL of the replica process, and by
the chaos sites the port shares with the JAX package (``kill_replica``
mid-prefill, mid-decode and while draining, ``delay_tick``,
``drop_pressure``: the cases of ``tests/test_serve_drain.py``), whose
plan the controller carries into the replica processes. One
module-scoped deployment of two replicas serves every case; it is
:class:`Svc`, the port's LLM deployment (tiny fp32 Llama, the same
seeded weights in every process) with the plain methods the runtime
cases call. The replica processes import this module by
name, so it imports neither JAX nor the JAX package at the top: the JAX
reference is imported inside its test.
"""

import asyncio
import datetime
import http.client
import json
import os
import signal
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch.exceptions import (ReplicaDrainingError,
                                      ResumeExhaustedError)
from ray_tpu_torch.llm import ContinuousLlamaDeployment
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve import multiplex
from ray_tpu_torch.serve.proxy import _Router

TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
NAME = "llm"
ENGINE = dict(num_slots=4, max_len=128)
PAYLOAD = {"prompt_token_ids": list(range(1, 9)), "max_tokens": 10}
# Seconds between streamed tokens in the cases that kill or drain a
# replica mid-stream (user code in Svc.slow_generate).
DELAY = {"delay_s": 0.05}


def _params():
    return tl.init_params(TCFG, torch.Generator().manual_seed(5), "cpu")


class Svc(ContinuousLlamaDeployment._cls_or_fn):
    """The port's LLM deployment plus plain methods for the runtime."""

    def __init__(self, **engine):
        super().__init__(config=TCFG, params=_params(), device="cpu",
                         **engine)

    def echo(self, x):
        return {"echo": x}

    def double(self, payload):
        return {"x2": payload.get("n", 0) * 2}

    def counts(self, payload):
        for i in range(payload.get("n", 3)):
            yield {"i": i}

    async def aecho(self, x):
        await asyncio.sleep(0)
        return x

    def pid(self, _=None):
        return os.getpid()

    def sleepy(self, seconds):
        time.sleep(seconds)
        return os.getpid()

    def model_id(self, _=None):
        return serve.get_multiplexed_model_id()

    def imported(self, _=None):
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "ray_tpu", "ml_dtypes"))

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
    def batched(self, xs):
        return [(x, len(xs)) for x in xs]

    def slow_generate(self, payload):
        gen = self.generate(payload)
        try:
            for token in gen:
                time.sleep(payload.get("delay_s", 0))
                yield token
        finally:
            gen.close()

    def chaos_fired(self, _=None):
        """The chaos firings this replica process holds as spent."""
        return chaos.state()[2]


class Pressy:
    """A replica whose pressure snapshot the test sets."""

    def __init__(self):
        self._p = {"queue_depth": 50}

    def set_pressure(self, p):
        self._p = dict(p)
        return self._p

    def pressure(self):
        return self._p

    def __call__(self, payload):
        return {"ok": True}


def double(x):
    return x * 2


@pytest.fixture(scope="module")
def store():
    import torch.distributed as dist

    return dist.TCPStore("127.0.0.1", 0, 1, True,
                         timeout=datetime.timedelta(seconds=30))


@pytest.fixture(scope="module")
def app(store):
    serve.shutdown()
    serve.start(kv=store)
    handle = serve.run(serve.deployment(Svc, name=NAME, num_replicas=2)
                       .bind(**ENGINE))
    port = serve.start_http(port=0)
    yield handle, port
    serve.shutdown()


def _controller():
    return serve_api._get_controller()


def _wait_replicas(n=2, timeout_s=60.0):
    """Until the controller routes n live replicas that answer a health
    probe and no drain is in flight (the clean start after a kill or a
    drain)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        reps = _controller().get_replicas(NAME)
        if len(reps) == n and not _controller().draining_count(NAME):
            try:
                if all(r.control("health").result(timeout=10)
                       for r in reps):
                    return reps
            except Exception:  # noqa: BLE001 — dying: keep waiting
                pass
        time.sleep(0.1)
    raise AssertionError(f"never reached {n} routed replicas of {NAME}")


def _stream(payload, method="generate"):
    return _Router().stream(NAME, method, payload)


def _take(it, n):
    return [next(it) for _ in range(n)]


def _kill(replica):
    os.kill(replica.pid, signal.SIGKILL)


# ----------------------------------------------------------------- basics
def test_class_deployment_and_method_calls(app):
    handle, _ = app
    _wait_replicas()
    assert handle.echo.remote("w").result() == {"echo": "w"}
    assert handle.double.remote({"n": 5}).result() == {"x2": 10}
    assert handle.aecho.remote(7).result() == 7        # an async method
    assert list(handle.options("counts", stream=True).remote(
        {"n": 4})) == [{"i": i} for i in range(4)]


def test_function_deployment():
    h = serve.run(serve.deployment(double).bind())
    try:
        assert h.remote(21).result() == 42
    finally:
        serve.delete("double")


def test_more_replicas_on_cards_than_the_host_has_raises(app):
    many = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="GPU"):
        serve.run(serve.deployment(double, name="gpu_double",
                                   ray_actor_options={"num_gpus": many})
                  .bind())


class _CardRecorder:
    """A replica process that is never spawned: it records the
    environment the controller gives it and answers every control call."""

    def __init__(self, name, cls_or_fn, init_args, init_kwargs,
                 is_function, sync_workers=1, env=None, num_threads=1):
        self.env = dict(env or {})
        self.pid, self.dead, self.alive, self.ready = None, False, True, True

    def wait_ready(self, timeout_s):
        return {}

    def push_chaos(self, shared):
        pass

    def kill(self):
        self.alive = False

    stop = kill

    def control(self, op, *args):
        from concurrent.futures import Future

        fut = Future()
        fut.set_result({})
        return fut


def test_builders_ask_one_card_per_replica(app, monkeypatch):
    """A colocated builder's replica asks a card of its own; a
    disaggregated pair's replicas half a card each, and pack two to a
    card; a deployment that does not fit raises before it stops
    anything."""
    from ray_tpu_torch.llm import (build_continuous_llama_app,
                                   build_disagg_llama_apps, build_llama_app)
    from ray_tpu_torch.runtime import controller as ctl_mod

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(ctl_mod, "ReplicaProcess", _CardRecorder)
    ctl = ctl_mod.ServeController()
    monkeypatch.setattr(serve_api, "_controller", ctl)

    def cards(name):
        return sorted(r.env["CUDA_VISIBLE_DEVICES"]
                      for r in ctl.get_replicas(name))

    try:
        cont = build_continuous_llama_app(TCFG, num_replicas=2)
        static = build_llama_app(TCFG, num_replicas=2)
        assert all(a.deployment.ray_actor_options == {"num_gpus": 1}
                   for a in (cont, static))
        pre, dec = build_disagg_llama_apps(config=TCFG)
        assert all(a.deployment.ray_actor_options == {"num_gpus": 0.5}
                   for a in (pre, dec))
        serve.run(cont)
        assert cards(cont.deployment.name) == ["0", "1"]
        # No card is left for another deployment; the refusal stops
        # nothing that serves.
        with pytest.raises(ValueError, match="GPU"):
            serve.run(static)
        # A redeploy counts the cards it frees, and one that does not
        # fit leaves the running deployment serving.
        serve.run(build_continuous_llama_app(TCFG, num_replicas=2))
        assert cards(cont.deployment.name) == ["0", "1"]
        with pytest.raises(ValueError, match="GPU"):
            serve.run(build_continuous_llama_app(TCFG, num_replicas=3))
        assert cards(cont.deployment.name) == ["0", "1"]
        serve.delete(cont.deployment.name)
        serve.run(static)
        assert cards(static.deployment.name) == ["0", "1"]
        serve.delete(static.deployment.name)
        # The pair shares one card; a whole-card replica takes the other.
        serve.run(pre)
        serve.run(dec)
        assert cards("llm-prefill") == cards("llm-decode") == ["0"]
        serve.run(build_continuous_llama_app(TCFG, num_replicas=1))
        assert cards(cont.deployment.name) == ["1"]
        third = serve.deployment(double, name="third",
                                 ray_actor_options={"num_gpus": 0.3})
        with pytest.raises(ValueError, match="GPU"):
            serve.run(third.bind())         # no card has 0.3 left
        serve.delete(cont.deployment.name)
        serve.run(third.options(num_replicas=3).bind())
        assert cards("third") == ["1", "1", "1"]
        # A redeploy of the pair counts the share it frees.
        serve.run(dec)
        assert cards("llm-decode") == ["0"]
        with pytest.raises(ValueError, match="GPU"):
            serve.run(serve.deployment(double, name="big",
                                       ray_actor_options={"num_gpus": 1.5})
                      .bind())
    finally:
        ctl.shutdown()


@pytest.mark.parametrize("opts", [{"placement_strategy": "STRICT_PACK"},
                                  {"autoscaling_config": {"min_replicas": 1}},
                                  {"num_replicas": "auto"}])
def test_run_refuses_what_is_not_ported(opts):
    """What JAX serves the port serves: a deployment with an
    ``autoscaling_config`` or ``num_replicas="auto"`` starts at its
    ``min_replicas`` under the autoscaler (item 19a), and a placement
    strategy other than COMPACT and SPREAD is kept and changes nothing, as
    in JAX (no placement group). ``options`` still refuses what it does
    not take."""
    dep = serve.deployment(double, name="refused", **opts)
    try:
        assert serve.run(dep.bind()).remote(4).result() == 8
        controller = serve_api._get_controller()
        assert "refused" not in controller._groups
        autoscaled = "placement_strategy" not in opts
        assert (controller.deployments["refused"]["autoscaling"]
                is not None) == autoscaled
        assert controller.pool_state("refused")["routed"] == 1
    finally:
        serve.delete("refused")
    with pytest.raises(TypeError):
        dep.options(user_config={})


def test_replicas_balance_and_import_no_jax(app):
    handle, _ = app
    reps = _wait_replicas()
    pids = {handle.pid.remote().result() for _ in range(30)}
    assert pids == {r.pid for r in reps}
    for r in reps:
        assert r.call("imported", (), {}).result(timeout=30) == []


def test_controller_kv_holds_the_routes(app, store):
    reps = _wait_replicas()
    record = json.loads(store.get("__serve__/deployments"))
    assert record[NAME]["num_replicas"] == 2
    assert sorted(r["pid"] for r in record[NAME]["replicas"]) == \
        sorted(r.pid for r in reps)


def test_batching_merges_concurrent_calls(app):
    handle, _ = app
    _wait_replicas()
    # One multiplexed model id: every call lands on the same replica.
    h = handle.options("batched", multiplexed_model_id="m")
    responses = [h.remote(i) for i in range(8)]
    results = [r.result() for r in responses]
    assert sorted(x for x, _ in results) == list(range(8))
    assert max(n for _, n in results) >= 2
    assert all(n <= 8 for _, n in results)


def test_dead_replica_is_respawned(app):
    handle, _ = app
    reps = _wait_replicas()
    _kill(reps[0])
    for i in range(5):                  # calls keep succeeding meanwhile
        assert handle.echo.remote(i).result(timeout_s=30) == {"echo": i}
    fresh = _wait_replicas()
    assert reps[0].pid not in {r.pid for r in fresh}


def test_unary_call_resubmits_after_its_replica_dies(app):
    handle, _ = app
    _wait_replicas()
    resp = handle.sleepy.remote(1.0)
    time.sleep(0.2)
    dead = resp._replica.pid
    _kill(resp._replica)
    assert resp.result(timeout_s=30) != dead
    _wait_replicas()


# ------------------------------------------------------------------ drain
def test_replica_drain_stops_admitting_and_reports():
    from ray_tpu_torch.runtime.replica import Replica

    class Slow:
        def __call__(self, payload):
            time.sleep(0.15)
            return payload

    r = Replica(Slow, (), {}, is_function=False, sync_workers=2)

    async def drive():
        inflight = asyncio.ensure_future(
            r.handle_request(None, ({"x": 1},), {}))
        await asyncio.sleep(0.02)          # let it admit
        drain = asyncio.ensure_future(r.drain(5.0))
        await asyncio.sleep(0.02)          # drain flag latched
        with pytest.raises(ReplicaDrainingError):
            await r.handle_request(None, ({"x": 2},), {})
        res = await drain                   # waits for the in-flight one
        assert (await inflight) == {"x": 1}
        return res

    res = asyncio.new_event_loop().run_until_complete(drive())
    assert res["drained"] and res["remaining"] == 0
    r2 = Replica(Slow, (), {}, is_function=False, sync_workers=2)

    async def drive_deadline():
        inflight = asyncio.ensure_future(
            r2.handle_request(None, ({"x": 3},), {}))
        await asyncio.sleep(0.02)
        res = await r2.drain(0.05)          # far shorter than the call
        await inflight
        return res

    res2 = asyncio.new_event_loop().run_until_complete(drive_deadline())
    assert not res2["drained"] and res2["remaining"] == 1


def test_drain_under_load_drops_nothing(app):
    _wait_replicas()
    results, errors = {}, []

    def run_one(i):
        try:
            p = {"prompt_token_ids": list(range(1 + i, 9 + i)),
                 "max_tokens": 16, **DELAY}
            results[i] = list(_stream(p, "slow_generate"))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run_one, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.4)                       # streams mid-decode
    assert serve.drain(NAME, 1) == 1
    assert _controller().draining_count(NAME) == 1
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(len(v) for v in results.values()) == [16] * 4
    _wait_replicas()                      # retired and replaced


# --------------------------------------------------------- kill + resume
def test_kill_mid_decode_greedy_resume_equals_uninterrupted(app):
    _wait_replicas()
    payload = {**PAYLOAD, **DELAY}
    baseline = list(_stream(payload, "slow_generate"))
    assert len(baseline) == PAYLOAD["max_tokens"]
    s = _stream(payload, "slow_generate")
    head = _take(s, 3)
    _kill(s._replica)
    out = head + list(s)
    assert out == baseline
    assert s.journal.resumes == 1 and s.journal.resumed_midstream
    assert not s.journal.needs_marker       # greedy: exactly-once
    _wait_replicas()


def test_kill_while_queued_resubmits(app):
    reps = _wait_replicas()
    baseline = list(_stream(PAYLOAD))
    for r in reps:
        os.kill(r.pid, signal.SIGSTOP)
    try:
        s = _stream(PAYLOAD)
        s._dispatch(PAYLOAD)               # queued on a stopped replica
        victim = s._replica
        _kill(victim)
    finally:
        for r in reps:
            os.kill(r.pid, signal.SIGCONT)
    assert list(s) == baseline
    assert s.journal.resumes == 1 and not s.journal.resumed_midstream
    _wait_replicas()


def test_spent_resume_budget_is_typed(app, monkeypatch):
    _wait_replicas()
    monkeypatch.setenv("RAY_TPU_SERVE_MAX_RESUMES", "1")
    s = _stream({**PAYLOAD, **DELAY}, "slow_generate")
    _take(s, 2)
    _kill(s._replica)
    _take(s, 2)                            # resumed on the other replica
    _kill(s._replica)
    with pytest.raises(ResumeExhaustedError):
        list(s)
    assert s.journal.resumes == 1
    _wait_replicas()


# ------------------------------------------------------------------ HTTP
def _post(conn, path, payload, headers=None):
    conn.request("POST", path, body=json.dumps(payload),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    return resp, resp.read()


def _lines(body):
    return [json.loads(line) for line in body.splitlines() if line]


def test_http_keep_alive_healthz_routes(app):
    _, port = app
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    for i in range(5):
        resp, body = _post(conn, f"/{NAME}/double", {"n": i})
        assert resp.status == 200 and json.loads(body) == {"x2": i * 2}
        assert resp.getheader("Connection") == "keep-alive"
    conn.request("GET", "/-/healthz")
    assert json.loads(conn.getresponse().read()) == {"status": "ok"}
    conn.request("GET", "/-/routes")
    assert f"/{NAME}" in json.loads(conn.getresponse().read())
    conn.request("PUT", "/-/deploy", body="{}")
    resp = conn.getresponse()
    assert resp.status == 200 and json.loads(resp.read()) == \
        {"deployed": []}
    conn.close()


def test_http_streaming_errors_and_refusals(app):
    _, port = app
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    resp, body = _post(conn, f"/{NAME}/stream/counts", {"n": 4})
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "application/x-ndjson"
    assert _lines(body) == [{"i": i} for i in range(4)]
    resp, body = _post(conn, f"/{NAME}/_private", {})
    assert resp.status == 404
    resp, body = _post(conn, f"/{NAME}/no_such_method", {})
    assert resp.status == 500
    resp, body = _post(conn, f"/{NAME}/double", {"n": 5})   # still up
    assert json.loads(body) == {"x2": 10}
    resp, body = _post(conn, f"/{NAME}/model_id", {},
                       headers={"serve_multiplexed_model_id": "lora-7"})
    assert json.loads(body) == "lora-7"
    conn.close()
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    s.sendall(f"POST /{NAME} HTTP/1.1\r\nTransfer-Encoding: chunked"
              f"\r\n\r\n".encode())
    assert b"501" in s.recv(4096).split(b"\r\n")[0]
    s.close()


def test_http_tenant_limit_answers_429(app):
    _, port = app
    limiter = multiplex.tenant_rate_limiter()
    limiter.set_limit("blocked", 0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        resp, body = _post(conn, f"/{NAME}/double", {"n": 1},
                           headers={"serve_multiplexed_model_id":
                                    "blocked"})
        assert resp.status == 429
        assert float(resp.getheader("Retry-After")) > 0
        assert "tenant_rate_limit" in json.loads(body)["error"]
        conn.close()
    finally:
        limiter.clear_limit("blocked")


def test_http_sampled_resume_sends_the_marker(app):
    _, port = app
    _wait_replicas()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", f"/{NAME}/stream/slow_generate",
                 body=json.dumps({**PAYLOAD, **DELAY, "temperature": 0.7}))
    resp = conn.getresponse()
    assert resp.status == 200
    items = [json.loads(resp.readline()) for _ in range(2)]
    router = serve_api._router().handle(NAME)._router
    (serving,) = [router.replicas[i] for i, n in router.inflight.items()
                  if n]
    _kill(serving)
    items += _lines(resp.read())
    conn.close()
    tokens = [i for i in items if isinstance(i, int)]
    assert len(tokens) == PAYLOAD["max_tokens"]
    assert [i for i in items if isinstance(i, dict)] == \
        [{"x-ray-tpu-resumed": 1}]
    _wait_replicas()


def test_http_greedy_tokens_equal_the_engine_and_jax(app):
    """Streamed and unary tokens over HTTP through the replicas equal the
    in-process engine's and the JAX package's engine's on the same
    weights."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import continuous_batching as jcb
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.interop import params_to_numpy
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    _, port = app
    _wait_replicas()
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, 250, size=n)))
               for n in (5, 17, 40)]
    eng = ContinuousBatcher(TCFG, params=_params(), device="cpu", **ENGINE)
    rids = [eng.submit(p, 12) for p in prompts]
    got = eng.run_to_completion()
    want = [got[r] for r in rids]
    jeng = jcb.ContinuousBatcher(
        jl.LlamaConfig.tiny(dtype=jnp.float32),
        params=jax.tree.map(jnp.asarray, params_to_numpy(_params())),
        **ENGINE)
    jrids = [jeng.submit(p, 12) for p in prompts]
    jgot = jeng.run_to_completion()
    assert [list(map(int, jgot[r])) for r in jrids] == want
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    for p, w in zip(prompts, want):
        payload = {"prompt_token_ids": p, "max_tokens": 12}
        resp, body = _post(conn, f"/{NAME}/stream/generate", payload)
        assert resp.status == 200 and _lines(body) == w
        resp, body = _post(conn, f"/{NAME}", payload)
        assert json.loads(body) == {"token_ids": w}
    conn.close()
