"""The slice as a whole on the CPU, small: the port's
``ContinuousLlamaDeployment`` (the tiny 2-layer fp32 Llama at narrow
widths) as an actor that a node manager placed on a worker process it
forked, on the port's CPU cluster, against JAX's engine in process on
the same params (numpy through ``ray_tpu_torch.interop``).

Four prompts streamed through ``num_returns="streaming"`` must give JAX's
greedy tokens; ``score`` must give JAX's logprobs within 1e-5 (the fp32
tolerance of ``tests/test_torch_llm.py``). On the CPU the wrappers run
their kernels' plain versions. The worker imports no JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
import torch_cluster_llm_cases as llm_cases
from ray_tpu import llm as jllm
from ray_tpu.models import llama as jl
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.models import llama as tl

T = 120
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
ENGINE = dict(num_slots=4, max_len=128)
SCORE_ATOL = 1e-5


def _prompts(seed, lens=(5, 17, 40, 9)):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 250, size=n))) for n in lens]


@pytest.fixture(scope="module")
def setup():
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2})
    c.add_node(num_cpus=2)
    c.wait_for_nodes()
    rt.init(address=c.address)
    tp = tl.init_params(TCFG, torch.Generator().manual_seed(5), "cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    actor = rt.remote(max_concurrency=8, num_cpus=1)(
        llm_cases.ScoringLlm).remote(config=TCFG, params=tp, device="cpu",
                                     **ENGINE)
    jeng = jllm.ContinuousLlamaDeployment._cls_or_fn(
        config=JCFG, params=jp, **ENGINE)
    yield c, actor, jeng
    rt.get(actor.close.remote(), timeout=T)
    rt.kill(actor)
    rt.shutdown()
    c.shutdown()


def test_streams_equal_jax_greedy_tokens(setup):
    c, actor, jeng = setup
    prompts = _prompts(0)
    gens = [actor.generate.options(num_returns="streaming").remote(p, 12)
            for p in prompts]
    got = [[int(rt.get(r, timeout=T)) for r in g] for g in gens]
    for p, toks in zip(prompts, got):
        assert len(toks) == 12
        assert toks == [int(t) for t in jeng.generate(p, 12)]


def test_score_matches_jax_logprobs(setup):
    c, actor, jeng = setup
    for p in _prompts(1, (7, 30, 12)):
        toks = [int(t) for t in jeng.generate(p, 8)]
        got = rt.get(actor.score.remote((p, toks)), timeout=T)
        want = jeng.score_logprobs(p, toks)
        assert len(got) == len(toks) and all(x <= 0 for x in got)
        np.testing.assert_allclose(got, want, atol=SCORE_ATOL)


def test_actor_runs_in_a_forked_worker_without_jax(setup):
    c, actor, jeng = setup
    pid = rt.get(actor.pid.remote(), timeout=T)
    assert pid != os.getpid()
    assert pid in [p for n in c.nodes for p in n.worker_pids()]
    assert rt.get(actor.modules.remote(), timeout=T) == []
