"""Port parity: the LLM deployments in process (``ray_tpu_torch.llm``)
against the JAX package's (``ray_tpu.llm``), on the tiny fp32 config with
the same weights on both sides (``ray_tpu_torch.interop``).

Both packages' deployment classes are built through
``Deployment._cls_or_fn``, with no runtime: every public method of
``ContinuousLlamaDeployment`` (streamed and unary greedy tokens, the
resumed-EOS rule, ``score_logprobs``, ``swap_weights`` and
``weight_version``, ``pressure``, the ``reserve_kv``/``cancel_reserve``
nonce), ``LlamaDeployment``'s left-padded batches, ``LLMBatchWorker`` and
``batch_generate``, a cold start from a checkpoint the JAX package wrote,
and the entry points that still raise naming their ROADMAP item.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import llm as jllm
from ray_tpu.models import llama as jl
from ray_tpu_torch import llm as tllm
from ray_tpu_torch import serve
from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.models import llama as tl

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
ENGINE = dict(num_slots=4, max_len=128)


def _params(seed):
    tp = tl.init_params(TCFG, torch.Generator().manual_seed(seed), "cpu")
    return tp, jax.tree.map(jnp.asarray, params_to_numpy(tp))


@pytest.fixture(scope="module")
def params():
    return _params(5)


@pytest.fixture(scope="module")
def pair(params):
    """(JAX, port) ContinuousLlamaDeployment on the same weights."""
    tp, jp = params
    jdep = jllm.ContinuousLlamaDeployment._cls_or_fn(
        config=JCFG, params=jp, **ENGINE)
    tdep = tllm.ContinuousLlamaDeployment._cls_or_fn(
        config=TCFG, params=tp, device="cpu", **ENGINE)
    yield jdep, tdep
    tdep.close()


def _prompts(seed, lens=(5, 17, 40)):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 250, size=n))) for n in lens]


def test_streamed_and_unary_tokens_equal_jax(pair):
    jdep, tdep = pair
    for p in _prompts(0):
        want = [int(t) for t in jdep.generate(p, 12)]
        assert len(want) == 12
        assert list(tdep.generate(p, 12)) == want
        payload = {"prompt_token_ids": p, "max_tokens": 12}
        assert list(tdep.generate(payload)) == want
        assert tdep(payload) == {"token_ids": want}
        assert [int(t) for t in jdep(payload)["token_ids"]] == want


def test_concurrent_streams_equal_jax(pair):
    """Requests that join the port's tick mid-flight from caller threads
    stream the tokens each gets alone in JAX's deployment."""
    jdep, tdep = pair
    prompts = _prompts(1, (3, 9, 22, 31, 12, 6))
    want = [[int(t) for t in jdep.generate(p, 10)] for p in prompts]
    got = {}

    def run(i):
        got[i] = list(tdep.generate(prompts[i], 10))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert [got[i] for i in range(len(prompts))] == want


def test_engine_lock_serves_callers_in_arrival_order():
    """The tick thread re-takes the engine lock right after each step: it
    must queue behind the callers already waiting (a plain Lock lets it
    barge back in, and a request arriving mid-generation then waited a
    whole generation for its submit)."""
    lock = tllm._FairLock()
    order = []
    lock.__enter__()

    def waiter(i):
        with lock:
            order.append(i)

    threads = []
    for i in range(3):
        threads.append(threading.Thread(target=waiter, args=(i,)))
        threads[-1].start()
        for _ in range(200):            # until it holds its ticket
            if lock._next == i + 2:
                break
            time.sleep(0.005)
    lock.__exit__(None, None, None)
    with lock:                          # the releasing thread, at once
        order.append("again")
    for t in threads:
        t.join(timeout=10)
    assert order == [0, 1, 2, "again"]


def test_abandoned_stream_frees_its_slot(pair):
    _, tdep = pair
    gen = tdep.generate(_prompts(2)[2], 30)
    assert len([next(gen) for _ in range(3)]) == 3
    gen.close()
    snap = tdep.pressure()
    assert snap["active_slots"] == 0 and snap["queue_depth"] == 0


def test_resumed_eos_rule_matches_jax(params):
    tp, jp = params
    jdep = jllm.ContinuousLlamaDeployment._cls_or_fn(
        config=JCFG, params=jp, eos_token=99, **ENGINE)
    tdep = tllm.ContinuousLlamaDeployment._cls_or_fn(
        config=TCFG, params=tp, eos_token=99, device="cpu", **ENGINE)
    try:
        resumed = {"prompt_token_ids": [1, 2, 3, 99], "max_tokens": 5,
                   "resumed_tokens": 2}
        assert list(tdep.generate(resumed)) == \
            list(jdep.generate(resumed)) == []
        fresh = {"prompt_token_ids": [1, 2, 3, 99], "max_tokens": 5}
        out = list(tdep.generate(fresh))
        assert len(out) >= 1
        assert out == [int(t) for t in jdep.generate(fresh)]
        assert tdep.prefill(resumed) == jdep.prefill(resumed) == \
            {"done": []}
    finally:
        tdep.close()


def test_score_logprobs_match_jax(pair):
    jdep, tdep = pair
    p, out = _prompts(3, (11, 6))
    np.testing.assert_allclose(tdep.score_logprobs(p, out),
                               jdep.score_logprobs(p, out), atol=1e-5)


def test_swap_weights_and_version_count_as_jax(pair):
    jdep, tdep = pair
    tp6, jp6 = _params(6)
    tp5, jp5 = tdep.batcher.params, jdep.batcher.params
    assert tdep.weight_version() == jdep.weight_version() == 0
    prompt = _prompts(4)[1]
    for version in (None, 7, None):
        jv = jdep.swap_weights(jp6, version=version)
        tv = tdep.swap_weights(tp6, version=version)
        assert tv == jv == tdep.weight_version() == jdep.weight_version()
    assert tdep.weight_version() == 8
    assert list(tdep.generate(prompt, 8)) == \
        [int(t) for t in jdep.generate(prompt, 8)]
    jdep.swap_weights(jp5, version=0)
    assert tdep.swap_weights(tp5, version=0) == 0


def test_pressure_has_jax_keys(pair):
    jdep, tdep = pair
    assert set(tdep.pressure()) == set(jdep.pressure())


def test_reserve_kv_nonce_rules_match_jax(params):
    tp, jp = params
    geometry = dict(num_slots=2, max_len=64, block_size=16, num_blocks=5,
                    role="decode")
    jdep = jllm.ContinuousLlamaDeployment._cls_or_fn(
        config=JCFG, params=jp, **geometry)
    tdep = tllm.ContinuousLlamaDeployment._cls_or_fn(
        config=TCFG, params=tp, device="cpu", **geometry)
    try:
        for dep in (jdep, tdep):
            ticket = dep.reserve_kv(20, 10)
            assert set(ticket) == {"res_id", "nonce"}
            assert dep.reserve_kv(40, 20) is None    # the arena is short
            assert not dep.cancel_reserve({**ticket, "nonce": "other"})
            assert not dep.cancel_reserve(ticket["res_id"])
            assert dep.cancel_reserve(ticket)
            assert not dep.cancel_reserve(ticket)
        assert tdep._nonce != jdep._nonce
    finally:
        tdep.close()


def test_unported_entry_points_raise_naming_their_item(pair, params):
    """enable_weight_sync (item 10, ported) refuses to start with nothing
    to sync from; decode_from refuses an unjournaled manifest, and past
    that gate a prefill replica's handoff lands through the shm channel
    with JAX's tokens; deploy_disagg_llama asks half a card a replica
    (none here)."""
    jdep, tdep = pair
    with pytest.raises(ValueError, match="channel spec"):
        tdep.enable_weight_sync(None)
    with pytest.raises(RuntimeError, match="journal"):
        list(tdep.decode_from({"manifest": {"first_token": 1}}))
    tp, _ = params
    geometry = dict(config=TCFG, params=tp, device="cpu", num_slots=2,
                    max_len=64, block_size=16, prefix_cache=False)
    pre = tllm.ContinuousLlamaDeployment._cls_or_fn(role="prefill",
                                                    **geometry)
    dec = tllm.ContinuousLlamaDeployment._cls_or_fn(role="decode",
                                                    **geometry)
    try:                 # the prefix cache off: released blocks free
        free = pre.batcher.allocator.free_count
        prompt = _prompts(5)[1]
        manifest = pre.prefill({"prompt_token_ids": prompt,
                                "max_tokens": 4})
        assert "staging" not in manifest and manifest["nbytes"] > 0
        assert pre.batcher.handoff_ready() == []
        assert pre.batcher.allocator.free_count == free
        with pytest.raises(RuntimeError, match="journal"):
            list(dec.decode_from({"manifest": manifest}))
        ticket = dec.reserve_kv(len(prompt), 4)
        got = list(dec.decode_from({"manifest": {**manifest,
                                                 "journaled": True},
                                    "reservation": ticket}))
        assert got == [int(t) for t in jdep.generate(prompt, 4)]
        assert not dec.cancel_reserve(ticket)        # spent by the import
    finally:
        pre.close()
        dec.close()
    try:
        with pytest.raises(ValueError, match="GPU"):
            tllm.deploy_disagg_llama(config=TCFG)
    finally:
        serve.shutdown()
    prefill_app, decode_app = tllm.build_disagg_llama_apps(config=TCFG)
    assert prefill_app.deployment.name == "llm-prefill"
    assert decode_app.kwargs["role"] == "decode"
    assert prefill_app.deployment.ray_actor_options == {"num_gpus": 0.5}


def test_device_defaults_to_cuda(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tllm.ContinuousLlamaDeployment._cls_or_fn(config=TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        tllm.LlamaDeployment._cls_or_fn(config=TCFG)


# ------------------------------------------------------ LlamaDeployment
def test_llama_deployment_batches_match_jax(params):
    tp, jp = params
    jdep = jllm.LlamaDeployment._cls_or_fn(config=JCFG, params=jp,
                                           max_len=64)
    tdep = tllm.LlamaDeployment._cls_or_fn(config=TCFG, params=tp,
                                           max_len=64, device="cpu")
    requests = [{"prompt_token_ids": p, "max_tokens": n}
                for p, n in zip(_prompts(6, (3, 11, 7)), (4, 6, 5))]
    # The batched function itself: one left-padded batch, as JAX pads.
    want = type(jdep).__call__.__wrapped__(jdep, requests)
    got = type(tdep).__call__.__wrapped__(tdep, requests)
    assert got == [{"token_ids": [int(t) for t in w["token_ids"]]}
                   for w in want]
    assert [len(g["token_ids"]) for g in got] == [4, 6, 5]
    # One caller alone is a batch of one on either side.
    assert tdep(requests[1]) == {"token_ids": [
        int(t) for t in jdep(requests[1])["token_ids"]]}


def test_llama_deployment_merges_concurrent_calls(params):
    tp, _ = params
    dep = tllm.LlamaDeployment._cls_or_fn(config=TCFG, params=tp,
                                          max_len=64, device="cpu")
    sizes = []
    inner = dep.generator.generate

    def recording(batch, **kw):
        sizes.append(len(batch))
        return inner(batch, **kw)

    dep.generator.generate = recording
    out = {}
    barrier = threading.Barrier(12)

    def call(i):
        barrier.wait()
        out[i] = dep({"prompt_token_ids": list(range(1, 3 + i)),
                      "max_tokens": 3})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert sorted(out) == list(range(12))
    assert all(len(o["token_ids"]) == 3 for o in out.values())
    assert sum(sizes) == 12 and max(sizes) <= 8 and max(sizes) >= 2


# ---------------------------------------------------------- batch inference
def test_batch_worker_and_batch_generate_match_jax(params):
    tp, jp = params
    prompts = _prompts(7, (5, 9, 3, 12, 7, 4))
    kw = dict(max_new_tokens=8, num_slots=4, max_len=64)
    jworker = jllm.LLMBatchWorker(JCFG, params=jp, **kw)
    want = jworker({"prompt_ids": prompts, "id": list(range(6))})
    want = [list(map(int, g)) for g in want["generated_ids"]]
    tworker = tllm.LLMBatchWorker(TCFG, params=tp, device="cpu", **kw)
    got = tworker({"prompt_ids": prompts, "id": list(range(6))})
    assert got["id"] == list(range(6))
    assert got["generated_ids"] == want
    batches = [{"prompt_ids": prompts[i:i + 2]} for i in range(0, 6, 2)]
    outs = list(tllm.batch_generate(batches, TCFG, params=tp,
                                    device="cpu", **kw))
    assert [g for b in outs for g in b["generated_ids"]] == want


def test_batch_generate_on_replica_processes(params):
    from ray_tpu_torch import serve

    tp, _ = params
    prompts = _prompts(8, (5, 9, 3, 12, 7, 4, 6, 10))
    kw = dict(max_new_tokens=6, num_slots=4, max_len=64)
    want = tllm.LLMBatchWorker(TCFG, params=tp, device="cpu", **kw)(
        {"prompt_ids": prompts})["generated_ids"]
    batches = [{"prompt_ids": [p], "i": i} for i, p in enumerate(prompts)]
    try:
        outs = list(tllm.batch_generate(batches, TCFG, params=tp,
                                        concurrency=2, device="cpu", **kw))
        controller = serve.api._get_controller()
        assert controller.list_deployments() == {}   # deleted after use
    finally:
        serve.shutdown()
    assert [b["i"] for b in outs] == list(range(8))
    assert [b["generated_ids"][0] for b in outs] == want


def test_cold_start_from_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX trainer wrote cold-starts both packages'
    deployments to the same tokens."""
    from ray_tpu.checkpoint import CheckpointPlane as JaxPlane
    from ray_tpu.models import training as jt
    from ray_tpu.parallel import MeshConfig, make_mesh

    trainer = jt.ShardedTrainer(JCFG, make_mesh(
        MeshConfig(fsdp=1), devices=jax.devices()[:1]),
        optimizer=jt.default_optimizer(warmup_steps=2, total_steps=50,
                                       learning_rate=1e-2))
    tokens = np.random.default_rng(3).integers(0, JCFG.vocab_size, (4, 32))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "mask": jnp.ones((4, 32), jnp.int32)}
    state, _ = trainer.train_step(trainer.init_state(0), batch)
    plane = JaxPlane(str(tmp_path), run="jax", process_index=0,
                     process_count=1)
    assert trainer.save_state(plane, state).result()["committed"]
    plane.close()
    jdep = jllm.ContinuousLlamaDeployment._cls_or_fn(
        config=JCFG, checkpoint_path=str(tmp_path), **ENGINE)
    tdep = tllm.ContinuousLlamaDeployment._cls_or_fn(
        config=TCFG, checkpoint_path=str(tmp_path), device="cpu", **ENGINE)
    try:
        for p in _prompts(9, (6, 19)):
            assert list(tdep.generate(p, 10)) == \
                [int(t) for t in jdep.generate(p, 10)]
    finally:
        tdep.close()
    gen = tllm.LlamaDeployment._cls_or_fn(
        config=TCFG, checkpoint_path=str(tmp_path), max_len=64,
        device="cpu").generator
    assert torch.equal(gen.params["embed"],
                       torch.from_numpy(np.array(state.params["embed"])))
