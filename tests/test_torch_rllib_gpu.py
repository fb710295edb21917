"""The RL library's learners on the card against the same learners on the
CPU. Every test here is marked ``gpu`` and skips without a CUDA device.
The file imports neither JAX nor ``ray_tpu``:

    python -m pytest --noconftest -m gpu tests/test_torch_rllib_gpu.py

From the same params (drawn from one CPU generator on both devices) and
batch: the loss and every grad leaf within rtol 1e-5 / atol 1e-6, then
the CPU's grads applied on both and the params (and SAC's and DQN's
targets) held to the same tolerance. TF32 matmuls are off (torch's
default for fp32 matmuls, checked)."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rl.weight_sync import _flat, _nest
from ray_tpu_torch.rllib import core as rc

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the learners' card step runs only "
                    "on a card (run `pytest -m gpu` on the card)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _batches(rng):
    f32 = np.float32
    T, N, n = 64, 4, 128
    traj = dict(obs=rng.normal(size=(T, N, 4)).astype(f32),
                actions=rng.integers(0, 2, size=(T, N)),
                behavior_logp=np.log(rng.uniform(0.2, 0.8, (T, N))).astype(
                    f32),
                rewards=np.ones((T, N), f32),
                dones=(rng.random((T, N)) < 0.05).astype(f32),
                bootstrap_obs=rng.normal(size=(N, 4)).astype(f32))
    mb = dict(obs=rng.normal(size=(256, 4)).astype(f32),
              actions=rng.integers(0, 2, 256),
              logprobs=np.log(rng.uniform(0.2, 0.8, 256)).astype(f32),
              advantages=rng.normal(size=256).astype(f32),
              returns=rng.normal(size=256).astype(f32))

    def trans(obs_dim, acts):
        return rc.Transition(rng.normal(size=(n, obs_dim)).astype(f32), acts,
                             rng.normal(size=n).astype(f32),
                             rng.normal(size=(n, obs_dim)).astype(f32),
                             (rng.random(n) < 0.1).astype(f32))

    return dict(ppo=mb, impala=traj, appo=traj,
                dqn=trans(4, rng.integers(0, 2, n)),
                sac=trans(3, rng.uniform(-1, 1, (n, 1)).astype(f32)))


LEARNERS = {
    "ppo": lambda d: rc.PPOLearner(rc.PPOModule(4, 2), lr=3e-3, device=d),
    "impala": lambda d: rc.ImpalaLearner(rc.PPOModule(4, 2), lr=3e-3,
                                         device=d),
    "appo": lambda d: rc.ImpalaLearner(rc.PPOModule(4, 2), lr=3e-3,
                                       clip_param=0.3, device=d),
    "dqn": lambda d: rc.DQNLearner(rc.DQNModule(4, 2), lr=1e-3,
                                   target_update_freq=1, device=d),
    "sac": lambda d: rc.SACLearner(rc.SACModule(3, 1), lr=1e-3, device=d),
}


def _step(learner, batch, noise):
    if isinstance(learner, rc.PPOLearner):
        loss, _, grads = learner._value_and_grad(learner._loss,
                                                 learner._tensors(batch))
        return float(loss), grads
    if isinstance(learner, rc.SACLearner):
        learner._noise = lambda n: tuple(
            torch.from_numpy(e).to(learner.device) for e in noise)
    grads, metrics = learner.compute_gradients(batch)
    return metrics.get("total_loss", metrics.get("loss")), grads


def _state(learner):
    trees = [learner.params, getattr(learner, "target_params", {})]
    return [t.detach().cpu() for tree in trees for _, t in _flat(tree)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_learner_step_on_card_matches_cpu(cuda_device, name):
    rng = np.random.default_rng(36)
    batch = _batches(rng)[name]
    noise = [rng.normal(size=(128, 1)).astype(np.float32) for _ in range(2)]
    got, want = LEARNERS[name]("cuda"), LEARNERS[name]("cpu")
    assert all(t.is_cuda for t in got._leaves())
    loss_g, grads_g = _step(got, batch, noise)
    loss_w, grads_w = _step(want, batch, noise)
    np.testing.assert_allclose(loss_g, loss_w, rtol=RTOL, atol=ATOL)
    for (pa, a), (pb, b) in zip(_flat(grads_g), _flat(grads_w)):
        assert pa == pb and a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=RTOL, atol=ATOL)
    got.apply_gradients(_nest([(p, g.to(cuda_device))
                               for p, g in _flat(grads_w)]))
    want.apply_gradients(grads_w)
    for a, b in zip(_state(got), _state(want)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
