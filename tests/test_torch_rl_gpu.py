"""The RL learner and the profiling plane on the card. Every test here is
marked ``gpu`` and skips without a CUDA device. The file imports neither
JAX nor ``ray_tpu``:

    python -m pytest --noconftest -m gpu tests/test_torch_rl_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import cuda_monitor
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.rl import ExperienceBuffer, SequenceRecord, \
    TokenPPOLearner


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernels run only on a "
                    "card (run `pytest -m gpu` on the card)")
    return torch.device("cuda")


def _batch(vocab, seed=0, n=4, t=24, plen=104):
    rng = np.random.default_rng(seed)
    buf = ExperienceBuffer()
    for _ in range(n):
        buf.add(SequenceRecord(
            prompt=[int(x) for x in rng.integers(1, vocab, size=plen)],
            tokens=[int(x) for x in rng.integers(1, vocab, size=t)],
            logprobs=(-rng.uniform(4.0, 8.0, size=t)).astype(np.float32),
            reward=float(rng.uniform()), weight_version=0, staleness=0))
    return buf.to_batch()


@pytest.mark.gpu
def test_ppo_step_with_flash_kernels_matches_plain(cuda_device):
    """A bf16 PPO update (head dim 128, a 128-token sequence: the flash
    path) with the flash kernels against the plain attention: loss within
    bf16 tolerance, grads close, and the kernels launched (B1 forward,
    B2/B3 backward)."""
    cfg = tl.LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                              num_heads=4, num_kv_heads=2, head_dim=128,
                              max_seq_len=256, dtype=torch.bfloat16)
    batch = _batch(cfg.vocab_size)
    out = {}
    for kernel in (None, False):
        c = dataclasses.replace(cfg, attention_kernel=kernel)
        learner = TokenPPOLearner(c, lr=1e-4, rho_clip=2.0)
        assert learner.device.type == "cuda"
        before = dict(flash_attention.launches)
        grads, metrics = learner.compute_gradients(batch)
        torch.cuda.synchronize()
        launched = {k: flash_attention.launches[k] - before[k]
                    for k in before}
        out[kernel] = (grads, metrics, launched)
    (kg, km, kl), (pg, pm, pl) = out[None], out[False]
    assert all(kl[k] > 0 for k in ("fwd", "dq", "dkv")), kl
    assert pl == {"fwd": 0, "dq": 0, "dkv": 0}
    np.testing.assert_allclose(km["total_loss"], pm["total_loss"],
                               rtol=2e-2, atol=2e-3)
    from ray_tpu_torch.rl.weight_sync import _flat

    for (path, a), (_, b) in zip(_flat(kg), _flat(pg)):
        a, b = a.float(), b.float()
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 5e-2 * scale, path
    # The step's counted FLOPs include the kernels' analytic share.
    stats = cuda_monitor.program_stats("rl_ppo_grad")
    assert stats and stats["flops"] > 0
