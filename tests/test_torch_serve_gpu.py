"""The port's serve runtime on the card: a replica process on a GPU of its
own (``num_gpus: 1``) streams the tokens an in-process engine on the same
card gives, and the paged decode kernel carried its ticks. Marked ``gpu``;
skips without a CUDA device. The replica process imports this module by
name, so it imports neither JAX nor ``ray_tpu``:

    python -m pytest --noconftest -m gpu tests/test_torch_serve_gpu.py
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch import serve
from ray_tpu_torch.llm import ContinuousLlamaDeployment
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

CFG = llama.LlamaConfig.tiny(dtype=torch.float32, num_layers=2,
                             head_dim=128, max_seq_len=256)
ENGINE = dict(num_slots=4, max_len=256)


def _params():
    return llama.init_params(
        CFG, torch.Generator(device="cuda").manual_seed(3), device="cuda")


class CardLlm(ContinuousLlamaDeployment._cls_or_fn):
    """The port's deployment on this module's seeded weights, with the
    replica's paged-kernel launch count readable."""

    def __init__(self):
        super().__init__(config=CFG, params=_params(), **ENGINE)

    def launches(self, _=None):
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        with self._lock:
            return (paged_decode_attention.launches,
                    self.batcher.base_tick_count)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the replica runs the paged "
                    "kernel (run `pytest -m gpu` on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_replica_on_the_card_streams_the_engines_tokens(cuda_device):
    rng = np.random.default_rng(11)
    prompts = [list(map(int, rng.integers(1, CFG.vocab_size, size=n)))
               for n in (7, 30, 65)]
    eng = ContinuousBatcher(CFG, params=_params(), **ENGINE)
    rids = [eng.submit(p, 12) for p in prompts]
    done = eng.run_to_completion()
    want = [done[r] for r in rids]
    assert eng.use_decode_kernel
    handle = serve.run(serve.deployment(
        CardLlm, name="card_llm", ray_actor_options={"num_gpus": 1})
        .bind())
    try:
        (replica,) = serve.api._get_controller().get_replicas("card_llm")
        assert replica.info["cuda_visible_devices"] not in (None, "")
        stream = handle.options("generate", stream=True)
        got = [list(stream.remote({"prompt_token_ids": p,
                                   "max_tokens": 12})) for p in prompts]
        launches, ticks = handle.launches.remote().result()
    finally:
        serve.shutdown()
    assert got == want
    assert ticks > 0 and launches == CFG.num_layers * ticks
