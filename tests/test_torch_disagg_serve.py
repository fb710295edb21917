"""The port's prefill/decode split over its serve runtime on the CPU: the
counterpart of ``tests/test_disagg_serve.py``'s serve e2e (the chaos
handoffs).

One module-scoped role group, ``deploy_disagg_llama("dllm", ...)`` with
two prefill and two decode replica processes (so a chaos-killed
replica's retry lands on the survivor while the controller respawns it),
half a card each on two stand-in card ids (the replicas run on the CPU),
behind the HTTP ingress with the classifier splitting every LLM request
(``RAY_TPU_DISAGG_PREFILL_THRESHOLD=0``), as JAX's fixture has. The
deployment's class is :class:`CpuLlm`, the port's LLM deployment on the
CPU with seeded weights, so every replica and respawn serves the same
weights. Chaos plans configured here reach the replica processes through
the controller (:mod:`ray_tpu_torch._private.chaos`).

The replica processes import this module by name, so it imports neither
JAX nor the JAX package at the top.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from ray_tpu_torch import llm as tllm
from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import api as serve_api
from ray_tpu_torch.serve.proxy import _Router

TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
ENGINE = dict(num_slots=4, max_len=128, paged=True, block_size=16,
              num_blocks=64, prefix_cache=True)
PROMPT = list(range(1, 41))
PAYLOAD = {"prompt_token_ids": PROMPT, "max_tokens": 8}
GROUP = "dllm"


def _params():
    return tl.init_params(TCFG, torch.Generator().manual_seed(7), "cpu")


class CpuLlm(tllm.ContinuousLlamaDeployment._cls_or_fn):
    """The port's LLM deployment on the CPU with seed-7 weights."""

    def __init__(self, config=None, **engine):
        super().__init__(config=TCFG, params=_params(), device="cpu",
                         **engine)


@pytest.fixture(scope="module")
def disagg_app():
    serve.shutdown()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_DISAGG_PREFILL_THRESHOLD", "0")
        # Two card ids for four half-card replicas (none touches a card).
        mp.setenv("CUDA_VISIBLE_DEVICES", "0,1")
        mp.setattr(tllm, "ContinuousLlamaDeployment",
                   serve.deployment(CpuLlm))
        group = tllm.deploy_disagg_llama(GROUP, config=TCFG, num_prefill=2,
                                         num_decode=2, **ENGINE)
        port = serve.start_http(port=0)
        try:
            yield group, port
        finally:
            chaos.configure(None)
            serve.shutdown()


@pytest.fixture(autouse=True)
def _chaos_clean():
    yield
    chaos.configure(None)


def _wait_group(n=2, timeout_s=90.0):
    """Until both role deployments route n live replicas that answer a
    health probe (the clean start after a chaos kill)."""
    controller = serve_api._get_controller()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            ok = True
            for name in (f"{GROUP}-prefill", f"{GROUP}-decode"):
                reps = controller.get_replicas(name)
                if len(reps) != n or not all(
                        r.control("health").result(timeout=10)
                        for r in reps):
                    ok = False
            if ok:
                return
        except Exception:  # noqa: BLE001 — dying or starting: keep waiting
            pass
        time.sleep(0.1)
    raise AssertionError("the role group never reached full health")


def _http_stream(port, payload, timeout_s=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{GROUP}/stream/generate",
        data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as r:
        marker = r.headers.get("x-ray-tpu-resumed")
        items = [json.loads(line) for line in r.read().splitlines()
                 if line.strip()]
    return items, marker


def _stream(payload):
    s = _Router().stream(GROUP, "generate", dict(payload))
    s._timeout = 120.0
    return s


@pytest.fixture(scope="module")
def references():
    """PROMPT's 8 greedy tokens from the JAX package's split (a prefill
    and a decode engine, the handoff in process) and generator, and from
    the port's colocated engine, on the same weights."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import continuous_batching as jcb
    from ray_tpu.models import inference as jinf
    from ray_tpu.models import llama as jl
    from ray_tpu.serve import kv_transfer as jkv
    from ray_tpu_torch.interop import params_to_numpy
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(_params()))
    pre = jcb.ContinuousBatcher(jcfg, params=jp, role="prefill", **ENGINE)
    dec = jcb.ContinuousBatcher(jcfg, params=jp, role="decode", **ENGINE)
    rid = pre.submit(PROMPT, max_new_tokens=8)
    pre.run_to_completion()
    drid = jkv.transfer_inproc(pre, dec, rid)
    jax_split = [int(t) for t in dec.run_to_completion()[drid]]
    gen = jinf.LlamaGenerator(jcfg, params=jp, max_len=128)
    jax_gen = [int(t) for t in np.asarray(gen.generate(
        np.asarray([PROMPT], np.int32), max_new_tokens=8))[0]]
    eng = ContinuousBatcher(TCFG, params=_params(), device="cpu", **ENGINE)
    crid = eng.submit(PROMPT, 8)
    colocated = [int(t) for t in eng.run_to_completion()[crid]]
    return jax_split, jax_gen, colocated


def test_split_over_http_equals_jax_split_and_colocated(disagg_app,
                                                        references):
    """A classified request crosses prefill -> channel -> decode through
    the HTTP ingress and streams the greedy tokens of JAX's split, JAX's
    generator and the port's colocated engine; a unary call to the group
    runs colocated on the decode group with the same tokens."""
    group, port = disagg_app
    assert group == {"prefill": f"{GROUP}-prefill",
                     "decode": f"{GROUP}-decode"}
    assert serve.get_role_group(GROUP) == group
    jax_split, jax_gen, colocated = references
    assert jax_split == jax_gen == colocated
    _wait_group()
    toks, marker = _http_stream(port, PAYLOAD)
    assert toks == colocated
    assert marker is None             # a clean greedy run: no marker
    assert _Router().call(GROUP, None, dict(PAYLOAD)) == \
        {"token_ids": colocated}


def test_half_card_replicas_pair_up_on_cards(disagg_app):
    """The four half-card replicas pack two to a card on the two card
    ids (first fit, shared cards first)."""
    controller = serve_api._get_controller()
    _wait_group()
    cards = [r.env["CUDA_VISIBLE_DEVICES"]
             for name in (f"{GROUP}-prefill", f"{GROUP}-decode")
             for r in controller.get_replicas(name)]
    assert sorted(cards) == ["0", "0", "1", "1"]


def test_chaos_kill_export_resubmits_exactly_once(disagg_app, references):
    """kill_transfer:stage=export is a real prefill replica death while
    it exports the KV payload: nothing was journaled, so the submission
    resubmits to the other prefill replica and the stream completes
    with the same tokens, with no marker."""
    _, port = disagg_app
    _wait_group()
    chaos.configure("kill_transfer:stage=export", seed=7)
    s = _stream(PAYLOAD)
    toks = list(s)
    kills = [e for e in chaos.injection_log()
             if e["action"] == "kill_transfer"]
    chaos.configure(None)
    assert toks == references[2]
    assert len(kills) == 1 and kills[0]["coords"]["stage"] == "export"
    j = s.journal
    assert j.resumes == 1 and not j.resumed_midstream
    assert not j.needs_marker
    assert j.handoff_outcomes == {"prefill_died": 1, "ok": 1}
    assert [e["attempt"] for e in j.handoffs] == [1]


def test_chaos_kill_import_resumes_exactly_once_journal(disagg_app,
                                                        references):
    """kill_transfer:stage=import kills the decode replica after the
    handoff was journaled: the request replays as a fresh prefill (a
    resume: the first token crossed replicas), the tokens stay the same,
    and the journal bills each attempt's handoff exactly once."""
    _wait_group()
    chaos.configure("kill_transfer:stage=import", seed=11)
    s = _stream(PAYLOAD)
    toks = list(s)
    kills = [e for e in chaos.injection_log()
             if e["action"] == "kill_transfer"]
    chaos.configure(None)
    assert toks == references[2]
    assert len(kills) == 1 and kills[0]["coords"]["stage"] == "import"
    j = s.journal
    assert j.resumes == 1 and j.resumed_midstream
    assert [e["attempt"] for e in j.handoffs] == [0, 1]
    assert j.handoff_outcomes == {"ok": 2, "decode_died": 1}


def test_clean_split_journals_exactly_one_handoff(disagg_app):
    _wait_group()
    s = _stream(PAYLOAD)
    assert len(list(s)) == 8
    assert len(s.journal.handoffs) == 1
    assert s.journal.handoffs[0]["attempt"] == 0
    assert s.journal.handoffs[0]["nbytes"] > 0
    assert s.journal.resumes == 0


def test_resumed_marker_surfaces_on_sampled_split_death(disagg_app):
    """A sampled split request whose decode replica dies after the
    journaled handoff tells the client: the x-ray-tpu-resumed header
    rides the HTTP response."""
    _, port = disagg_app
    _wait_group()
    chaos.configure("kill_transfer:stage=import", seed=13)
    toks, marker = _http_stream(port, {
        **PAYLOAD, "sampling": {"temperature": 0.7}})
    chaos.configure(None)
    assert len(toks) == 8
    assert marker == "1"


def test_no_channel_segment_left_behind(disagg_app, monkeypatch):
    """Every handoff's shm segment is unlinked by its reader, a killed
    decode replica's included (it read before the kill)."""
    from ray_tpu_torch.serve import recovery

    names = []
    real = recovery.DisaggRecoverableStream._prefill_attempt

    def spy(self, *args, **kw):
        manifest = real(self, *args, **kw)
        if isinstance(manifest, dict) and "channel" in manifest:
            names.append(manifest["channel"].name)
        return manifest

    monkeypatch.setattr(recovery.DisaggRecoverableStream,
                        "_prefill_attempt", spy)
    _wait_group()
    chaos.configure("kill_transfer:stage=import", seed=17)
    assert len(list(_stream(PAYLOAD))) == 8
    chaos.configure(None)
    assert len(list(_stream(PAYLOAD))) == 8
    assert len(names) == 3          # the killed import, its resume, one more
    assert not [n for n in names if os.path.exists(f"/dev/shm{n}")]
    _wait_group()


def test_classify_disagg_decides_as_jax(monkeypatch):
    """The port's classifier and JAX's decide alike over one payload
    sequence: the size threshold, a seen fingerprint's covered prefix
    and the decode group's queue floor."""
    from ray_tpu.serve import api as japi
    from ray_tpu.serve import proxy as jproxy
    from ray_tpu_torch.serve import proxy as tproxy

    snaps = [[{"prefill_queue_tokens": 300}, {"prefill_queue_tokens": 90}],
             [{"prefill_queue_tokens": 300}, {"prefill_queue_tokens": 200},
              {"unreachable": True}]]
    state = {"i": 0}

    def fake_pressure(self):
        return snaps[state["i"] % 2]

    monkeypatch.setattr(japi.DeploymentHandle, "_fetch_shared_pressure",
                        fake_pressure)
    monkeypatch.setattr(serve_api.DeploymentHandle,
                        "_fetch_shared_pressure", fake_pressure)
    group = {"prefill": "p", "decode": "d"}
    rng = np.random.default_rng(3)
    head = [int(t) for t in rng.integers(1, 250, size=256)]
    payloads = [{"prompt_token_ids": head[:n] + [7] * k}
                for n, k in ((0, 5), (64, 10), (64, 200), (128, 3),
                             (256, 40), (256, 300), (256, 0), (40, 0))]
    payloads.append({"prompt_token_ids": []})
    settings = [dict(), dict(RAY_TPU_DISAGG_PREFILL_THRESHOLD="0"),
                dict(RAY_TPU_DISAGG_PREFILL_THRESHOLD="64",
                     RAY_TPU_PREFIX_FP_CHUNK="32",
                     RAY_TPU_PREFIX_FP_CHUNKS="2"),
                dict(RAY_TPU_DISAGG_PREFILL_THRESHOLD="100000",
                     RAY_TPU_DISAGG_QUEUE_TOKENS="150")]
    for env in settings:
        for key in ("RAY_TPU_DISAGG_PREFILL_THRESHOLD",
                    "RAY_TPU_PREFIX_FP_CHUNK", "RAY_TPU_PREFIX_FP_CHUNKS",
                    "RAY_TPU_DISAGG_QUEUE_TOKENS"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        jr, tr = jproxy._Router(), tproxy._Router()
        for rounds in range(2):
            for i, p in enumerate(payloads):
                state["i"] = i
                assert tr._classify_disagg(group, p) == \
                    jr._classify_disagg(group, p), (env, rounds, i)
        assert list(tr._fp_seen) == list(jr._fp_seen)
