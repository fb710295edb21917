"""The port's core API on the card: a ``num_gpus=1`` actor of the
in-process runtime holds a 2-layer bf16 ``ContinuousLlamaDeployment``
on the card; its compiled-DAG score equals its ``.remote`` score bit for
bit, each through the flash forward kernel once a layer, and its streams
run the paged decode kernel. Marked ``gpu``; skips without a CUDA device.
It imports neither JAX nor ``ray_tpu``:

    python -m pytest --noconftest -m gpu tests/test_torch_core_gpu.py
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.llm import ContinuousLlamaDeployment
from ray_tpu_torch.models import llama

T = 300
CFG = llama.LlamaConfig.tiny(dtype=torch.bfloat16, num_layers=2,
                             head_dim=128, max_seq_len=256)
ENGINE = dict(num_slots=4, max_len=256)


class CardLlm(ContinuousLlamaDeployment._cls_or_fn):
    """The deployment on seeded card weights, with a one-argument
    ``score`` for a DAG stage and the kernels' launch counts."""

    def __init__(self):
        super().__init__(config=CFG, params=llama.init_params(
            CFG, torch.Generator(device="cuda").manual_seed(3),
            device="cuda"), **ENGINE)

    def score(self, request):
        return self.score_logprobs(*request)

    def launches(self):
        from ray_tpu_torch.ops.attention import flash_attention
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        return (flash_attention.launches["fwd"],
                paged_decode_attention.launches)


class Requests:
    def __init__(self, requests):
        self.requests = requests

    def make(self, i):
        return self.requests[i]


@pytest.fixture
def card_runtime():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the actor's engine runs the "
                    "flash and paged kernels (run `pytest -m gpu` on the "
                    "card)")
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


@pytest.mark.gpu
def test_card_actor_dag_score_equals_remote_score(card_runtime):
    assert rt.cluster_resources()["GPU"] == torch.cuda.device_count()
    actor = rt.remote(num_gpus=1, max_concurrency=4)(CardLlm).remote()
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, CFG.vocab_size, size=n)))
               for n in (9, 40)]
    requests = []
    for p in prompts:
        gen = actor.generate.options(num_returns="streaming").remote(p, 8)
        requests.append((p, [int(rt.get(r, timeout=T)) for r in gen]))
    source = rt.remote(num_gpus=0)(Requests).remote(requests)
    with InputNode() as i:
        dag = actor.score.bind(source.make.bind(i))
    compiled = dag.experimental_compile()
    try:
        assert compiled._channel_mode
        for i, req in enumerate(requests):
            fwd0, _ = rt.get(actor.launches.remote(), timeout=T)
            through_dag = rt.get(compiled.execute(i), timeout=T)
            fwd1, paged = rt.get(actor.launches.remote(), timeout=T)
            assert fwd1 - fwd0 == CFG.num_layers
            assert through_dag == rt.get(actor.score.remote(req), timeout=T)
            assert paged > 0
            assert len(through_dag) == 8 and np.all(np.isfinite(through_dag))
    finally:
        compiled.teardown()
    rt.get(actor.close.remote(), timeout=T)
    rt.kill(actor)
    with pytest.raises(rt.exceptions.ActorDiedError):
        rt.get(actor.launches.remote(), timeout=T)
