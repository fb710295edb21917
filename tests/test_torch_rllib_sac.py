"""SAC on CPU processes (``use_gpu=False``): the SAC half of
``tests/test_rllib.py`` (the learner's critics and Polyak targets move;
SAC improves Pendulum by 250 within 30 iterations with JAX's
settings). A file of its own: the Pendulum run takes about 50 s here."""

import numpy as np

from ray_tpu_torch.rl.weight_sync import _flat
from ray_tpu_torch.rllib import SACConfig, SACLearner, SACModule, Transition


def test_sac_learner_updates_and_targets_track():
    learner = SACLearner(SACModule(obs_dim=3, action_dim=1), lr=1e-3,
                         tau=0.5, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    t = Transition(
        obs=rng.normal(size=(64, 3)).astype(np.float32),
        actions=rng.uniform(-1, 1, size=(64, 1)).astype(np.float32),
        rewards=rng.normal(size=(64,)).astype(np.float32),
        next_obs=rng.normal(size=(64, 3)).astype(np.float32),
        dones=np.zeros((64,), np.float32))

    def first(tree):
        return _flat(tree)[0][1].detach().clone().numpy()

    before_target = first(learner.target_params)
    before_q = first(learner.params["q1"])
    metrics = learner.update_from_batch(t)
    assert np.isfinite(metrics["total_loss"])
    assert metrics["alpha"] > 0
    after_q = first(learner.params["q1"])
    assert np.abs(after_q - before_q).max() > 0          # critics learned
    after_target = first(learner.target_params)
    assert np.abs(after_target - before_target).max() > 0  # polyak moved
    # The target tracks the params, not equals them (tau < 1).
    assert not np.allclose(after_target, after_q)


def test_sac_improves_on_pendulum():
    """SAC must clearly improve Pendulum's return over its random-policy
    start (full solves need more steps than a test's budget)."""
    algo = (SACConfig()
            .environment("Pendulum-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(lr=1e-3, train_batch_size=128,
                      num_updates_per_iteration=256, learning_starts=256)
            .learners(use_gpu=False).build())
    first, best = None, -np.inf
    try:
        for _ in range(30):
            result = algo.train()
            r = result["episode_return_mean"]
            if np.isfinite(r):
                first = first if first is not None else r
                best = max(best, r)
            if first is not None and best >= first + 250:
                break
    finally:
        algo.stop()
    assert first is not None
    assert best >= first + 250, f"SAC failed to improve: {first} {best}"
