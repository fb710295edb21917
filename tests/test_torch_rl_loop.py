"""PPO through the port's serve replicas with live weight sync and a chaos
kill: the analog of ``tests/test_rl_loop.py::
test_ppo_loop_through_real_serve_engine_with_chaos`` on CPU replica
processes.

Two replicas of the port's LLM deployment (``torch_rl_helpers.RLSvc``:
a tiny fp32 Llama on the CPU, cold-started from seed 0) generate over
the router's journaled streams; the behavior logprobs come from a
replica's ``score_logprobs``; one ``LearnerGroup`` learner (a CPU
``TokenPPOLearner`` from seed 0, the same cold start) updates; a
``WeightPublisher`` with a checkpoint plane pushes each version to both
replicas' weight sync. Round 1 arms ``kill_replica:phase=decode,token=2``:
the killed replica's stream resumes through the journal and the
respawned replica is brought current through the slow path
(``restore_weights`` from the publish's checkpoint). The same
assertions as JAX's: versions reach [3, 3], losses finite, the kill fired
and a resume was counted, ``rl.weight_swap`` chains to
``rl.manifest_publish``, ``RL_SWAPS`` and ``RL_SYNC_BYTES`` moved. Then
a greedy request to each replica equals an in-process engine holding the
learner's weights, and the fast-path params equal the checkpoint's bit
for bit.
"""

import time

import numpy as np
import pytest

import torch_rl_helpers as h
from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as flight
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.checkpoint import CheckpointPlane, load_latest
from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
from ray_tpu_torch.rl import RolloutScheduler, WeightPublisher
from ray_tpu_torch.rl.weight_sync import _flat, _raw
from ray_tpu_torch.rllib import LearnerGroup
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve.proxy import _Router

LLM = "ContinuousLlamaDeployment"
RUN = "ppo-e2e"
ENGINE = dict(num_slots=4, max_len=64)


def _counter_value(metric, **want):
    total = 0.0
    for _, tags, v in metric.samples():
        td = dict(tags)
        if all(td.get(k) == v2 for k, v2 in want.items()):
            total += v
    return total


def _replicas():
    return serve_api._get_controller().get_replicas(LLM)


def _call(r, method, *args, **kwargs):
    return r.call(method, args, kwargs).result(timeout=120)


def _wait_replicas(n=2, timeout_s=90):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        reps = _replicas()
        if len(reps) == n:
            try:
                if all(r.control("health").result(timeout=10)
                       for r in reps):
                    return reps
            except Exception:  # noqa: BLE001 - dead/starting: keep waiting
                pass
        time.sleep(0.1)
    raise AssertionError(f"never reached {n} routed replicas of {LLM}")


def _stream(payload):
    s = _Router().stream(LLM, "generate", payload)
    s._timeout = 120.0
    return s


def _replica_versions():
    out = []
    for r in _replicas():
        try:
            out.append(int(_call(r, "weight_version")))
        except Exception:  # noqa: BLE001 - mid-respawn
            out.append(-1)
    return out


def _checkpoint_bytes(plane, version):
    cold = load_latest(plane.root, run=RUN, step=version)
    return {".".join(p): bytes(_raw(t)) for p, t in _flat(
        getattr(cold, "params", cold))}


def _target_token_reward(prompt, tokens):
    # A learnable scalar: fraction of generated tokens in the low band.
    return float(sum(1 for t in tokens if t < 16)) / max(len(tokens), 1)


@pytest.fixture
def loop_app(tmp_path):
    serve.shutdown()
    serve.run(serve.deployment(h.RLSvc, name=LLM, num_replicas=2)
              .bind(**ENGINE))
    plane = CheckpointPlane(str(tmp_path), run=RUN, process_index=0,
                            process_count=1)
    pub = WeightPublisher(run=RUN, n_subscribers=2, ckpt_plane=plane,
                          publish_timeout_s=2.0)
    learner = LearnerGroup(h.build_ppo_learner, num_learners=1,
                           use_gpu=False)
    yield pub, plane, learner
    chaos.configure(None)
    learner.shutdown()
    serve.shutdown()
    pub.destroy()
    plane.close()


def test_ppo_loop_through_serve_replicas_with_chaos(loop_app):
    pub, plane, learner = loop_app
    reps = _wait_replicas(2)
    synced = set()
    for i, r in enumerate(reps):
        _call(r, "enable_weight_sync", pub.subscriber_spec(i), run=RUN,
              poll_s=0.02)
        synced.add(r.replica_id)

    def generate(prompt, max_new):
        payload = {"prompt_token_ids": list(prompt), "max_tokens": max_new}
        tokens = [int(t) for t in _stream(payload)]
        last = None
        for r in _replicas():
            try:
                lp = np.asarray(_call(r, "score_logprobs", list(prompt),
                                      tokens), np.float32)
                return tokens, lp, int(_call(r, "weight_version"))
            except Exception as e:  # noqa: BLE001 - mid-respawn
                last = e
        raise last

    fallbacks = []

    def converge(manifest):
        """Every replica at the manifest's version: by its weight sync,
        or, when it has none (respawned after a kill) or the publish was
        shed (it reached no subscriber), through the slow path."""
        version = int(manifest["version"])
        deadline = time.monotonic() + 60
        for r in _wait_replicas(2):
            if "shed" in manifest or r.replica_id not in synced:
                _call(r, "restore_weights", manifest)
                fallbacks.append((r.replica_id, version))
                continue
            while int(_call(r, "weight_version")) < version and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
        vs = _replica_versions()
        assert all(v == version for v in vs), \
            f"replicas stuck at {vs}, want {version}"

    sched = RolloutScheduler(generate, lambda: pub.version, run=RUN)
    prompts = [[1, 2, 3], [4, 5, 6], [7, 8], [9, 10, 11, 12]]
    losses, kills = [], []
    resumes_before = _counter_value(mdefs.SERVE_REPLICA_RESUMES,
                                    deployment=LLM)
    for rnd in range(3):
        if rnd == 1:
            # Mid-loop fault: a replica dies 2 tokens into a stream.
            chaos.configure("kill_replica:phase=decode,token=2", seed=11)
        admitted = sched.collect(prompts, 6, _target_token_reward,
                                 cause=f"round-{rnd}")
        kills += [e for e in chaos.injection_log()
                  if e["action"] == "kill_replica"]
        chaos.configure(None)
        assert admitted == len(prompts), \
            "a stream dropped out of the learner feed"
        batch = sched.drain_batch()
        metrics = sched.learner_phase(lambda b=batch: learner.update(b),
                                      cause=f"round-{rnd}")
        assert np.isfinite(metrics["total_loss"])
        losses.append(metrics["total_loss"])
        manifest = pub.publish(learner.get_weights(), step=rnd,
                               cause=f"round-{rnd}")
        if rnd == 0:
            assert "shed" not in manifest, manifest.get("shed")
        converge(manifest)
        if rnd == 0:
            # Fast path only, and its params are the same version's
            # checkpoint, bit for bit.
            assert not fallbacks, "round 0 must take the fast path"
            cold = _checkpoint_bytes(plane, 1)
            for r in _replicas():
                assert _call(r, "params_bytes") == cold

    assert pub.version == 3
    assert _replica_versions() == [3, 3]
    assert len(losses) == 3 and all(np.isfinite(x) for x in losses)
    assert kills, "the chaos kill never fired"
    assert _counter_value(mdefs.SERVE_REPLICA_RESUMES,
                          deployment=LLM) > resumes_before
    assert fallbacks, "the respawned replica never took the slow path"

    # Every applied version emitted rl.weight_swap on subject run=RUN,
    # fast-path ones caused by their publish event.
    swaps = [e for e in flight.local_events(types=["rl.weight_swap"])
             if e["subject"].get("run") == RUN]
    assert {e["attrs"]["version"] for e in swaps} >= {1, 2, 3}
    assert any(e["attrs"]["swap_cause"] == "publish" for e in swaps)
    assert any(e["attrs"]["swap_cause"] == "fallback" for e in swaps)
    pubs = [e for e in flight.local_events(types=["rl.manifest_publish"])
            if e["subject"].get("run") == RUN]
    pub_ids = {e["event_id"] for e in pubs}
    chained = [e for e in swaps if e["cause"] in pub_ids]
    assert chained, "no weight_swap chained to its publish event"
    chain_ids = {rec["event_id"] for rec in flight.causal_chain(
        flight.local_events(limit=100000), [chained[0]["cause"]])}
    assert chained[0]["event_id"] in chain_ids
    # The counters moved: swaps in the replicas' registries (the live
    # ones: a killed replica's samples die with it), publish bytes here.
    swaps_counted = 0.0
    for r in _replicas():
        for name, key, value in r.control("samples").result(timeout=30):
            if name == "ray_tpu_rl_weight_swaps_total" and \
                    dict(key).get("run") == RUN:
                swaps_counted += value
    assert swaps_counted >= 3
    assert _counter_value(mdefs.RL_SYNC_BYTES, run=RUN, path="publish") > 0

    # A greedy request to each replica equals an in-process engine that
    # holds the learner's weights.
    weights = learner.get_weights()
    local = ContinuousBatcher(h.CFG, params=weights, device="cpu", **ENGINE)
    prompt = [3, 1, 4, 1, 5]
    rid = local.submit(prompt, max_new_tokens=8)
    want = local.run_to_completion()[rid]
    for r in _replicas():
        got = _call(r, "__call__", {"prompt_token_ids": prompt,
                                    "max_tokens": 8})["token_ids"]
        assert got == want
    # Every replica holds version 3 (by either path): the checkpoint's
    # bits, which are the learner's.
    cold = _checkpoint_bytes(plane, 3)
    for r in _replicas():
        assert _call(r, "params_bytes") == cold
    learned = {".".join(p): bytes(_raw(t.contiguous()))
               for p, t in _flat(weights)}
    assert learned == cold

    for r in _replicas():
        _call(r, "disable_weight_sync")
