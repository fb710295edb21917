"""The slice as a whole on the CPU: the port's ``ContinuousLlamaDeployment``
as an actor of its in-process runtime, against the JAX package's as a
``ray_tpu`` actor, on the tiny fp32 Llama with the same weights on both
sides (``ray_tpu_torch.interop``).

Both deployment classes are wrapped by ``@serve.deployment``, so the
actors take the class underneath (``._cls_or_fn``). Streamed greedy
tokens (``num_returns="streaming"``) must be equal across the two actors
and the port's in-process deployment; scores through a compiled DAG
(``InputNode -> Requests.make -> <actor>.score``) must equal the actor's
``.remote`` scores exactly, and JAX's within ``tests/test_torch_llm.py``'s
fp32 tolerance. Both runtimes live for the module (``num_cpus=4``, no
accelerator); every ``get`` has a timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import llm as jllm
from ray_tpu.models import llama as jl
from ray_tpu_torch import llm as tllm
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.models import llama as tl

T = 120
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
ENGINE = dict(num_slots=4, max_len=128)
SCORE_ATOL = 1e-5               # tests/test_torch_llm.py's fp32 tolerance


class ScoringLlm(tllm.ContinuousLlamaDeployment._cls_or_fn):
    """The port's deployment with a one-argument ``score`` for a DAG
    stage (a request ``(prompt, tokens)`` in, its logprobs out)."""

    def score(self, request):
        prompt, tokens = request
        return self.score_logprobs(prompt, tokens)


class Requests:
    """The DAG's first stage: request ``i`` from a fixed list."""

    def __init__(self, requests):
        self.requests = requests

    def make(self, i):
        return self.requests[i]


def _prompts(seed, lens=(5, 17, 40, 9, 23, 3)):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 250, size=n))) for n in lens]


@pytest.fixture(scope="module")
def setup():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    ray_tpu.init(num_cpus=4, num_gpus=0, num_tpus=0)
    rt.init(num_cpus=4, num_gpus=0)
    tp = tl.init_params(TCFG, torch.Generator().manual_seed(5), "cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    tact = rt.remote(max_concurrency=8)(ScoringLlm).remote(
        config=TCFG, params=tp, device="cpu", **ENGINE)
    jact = ray_tpu.remote(max_concurrency=8)(
        jllm.ContinuousLlamaDeployment._cls_or_fn).remote(
        config=JCFG, params=jp, **ENGINE)
    local = tllm.ContinuousLlamaDeployment._cls_or_fn(
        config=TCFG, params=tp, device="cpu", **ENGINE)
    yield tact, jact, local
    local.close()
    rt.get(tact.close.remote(), timeout=T)
    rt.kill(tact)
    rt.shutdown()
    ray_tpu.shutdown()


def _stream(pkg, actor, prompt, n):
    gen = actor.generate.options(num_returns="streaming").remote(prompt, n)
    return [int(pkg.get(r, timeout=T)) for r in gen]


def test_actor_streams_equal_jax_and_in_process(setup):
    tact, jact, local = setup
    prompts = _prompts(0)
    # All the port's streams are in flight together (one engine tick
    # serves them), as the card phase sends them.
    gens = [tact.generate.options(num_returns="streaming").remote(p, 12)
            for p in prompts]
    got = [[int(rt.get(r, timeout=T)) for r in g] for g in gens]
    for p, toks in zip(prompts, got):
        assert len(toks) == 12
        assert toks == _stream(ray_tpu, jact, p, 12)
        assert toks == [int(t) for t in local.generate(p, 12)]


def test_compiled_dag_scores_equal_remote_and_jax(setup):
    tact, jact, local = setup
    prompts = _prompts(1, (7, 30, 12))
    requests = [(p, [int(t) for t in local.generate(p, 8)])
                for p in prompts]
    source = rt.remote(Requests).remote(requests)
    with InputNode() as i:
        dag = tact.score.bind(source.make.bind(i))
    compiled = dag.experimental_compile()
    try:
        assert compiled._channel_mode
        for i, (p, toks) in enumerate(requests):
            through_dag = rt.get(compiled.execute(i), timeout=T)
            direct = rt.get(tact.score.remote((p, toks)), timeout=T)
            assert through_dag == direct
            assert len(direct) == len(toks) and all(x <= 0 for x in direct)
            want = ray_tpu.get(jact.score_logprobs.remote(p, toks),
                               timeout=T)
            np.testing.assert_allclose(through_dag, want, atol=SCORE_ATOL)
    finally:
        compiled.teardown()
    rt.kill(source)


def test_killed_actor_raises_actor_died_after_close(setup):
    """The card phase's teardown: ``close`` through the actor ends the
    engine's tick thread, then ``kill``; a later call raises
    ``ActorDiedError``."""
    import threading

    tp = tl.init_params(TCFG, torch.Generator().manual_seed(6), "cpu")
    a = rt.remote(max_concurrency=4)(ScoringLlm).remote(
        config=TCFG, params=tp, device="cpu", **ENGINE)
    assert len(_stream(rt, a, [1, 2, 3], 4)) == 4
    ticks = [t for t in threading.enumerate() if t.name == "llm-ticks"]
    rt.get(a.close.remote(), timeout=T)
    rt.kill(a)
    with pytest.raises(rt.exceptions.ActorDiedError):
        rt.get(a.score.remote(([1], [2])), timeout=T)
    live = [t for t in threading.enumerate() if t.name == "llm-ticks"]
    assert len(live) == len(ticks) - 1
