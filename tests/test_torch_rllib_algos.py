"""The RL library's algorithms on CPU processes (``use_gpu=False``): the
analogs of ``tests/test_rllib.py`` with JAX's settings and bars (PPO,
IMPALA and APPO learn CartPole to 120; multi-agent PPO reaches 13 with
both policies' metrics; a killed runner is replaced and its shard
re-sampled), the refusals at ``build()`` (a lambda that would have to
cross to a runner; a card asked for on a host without one) and PPO's
checkpoint. Runners and learners fork from the runtime's fork server and
import ``tests/torch_rllib_helpers.py`` (no JAX) by name."""

import numpy as np
import pytest
import torch

import torch_rllib_helpers as h
from ray_tpu_torch._private import events as flight
from ray_tpu_torch.rl.weight_sync import _flat
from ray_tpu_torch.rllib import (APPOConfig, DQNConfig, IMPALAConfig,
                                 MultiAgentPPOConfig, PPOConfig, SACConfig)


def _learn(algo, iters, bar):
    best = -np.inf
    try:
        for _ in range(iters):
            r = algo.train()["episode_return_mean"]
            if np.isfinite(r):
                best = max(best, r)
            if best >= bar:
                break
    finally:
        algo.stop()
    return best


def _cartpole(cfg, runners, envs, frag):
    return (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=runners,
                         num_envs_per_env_runner=envs,
                         rollout_fragment_length=frag)
            .learners(use_gpu=False))


def test_ppo_iteration_runs_on_cpu_runners():
    algo = (_cartpole(PPOConfig(), 2, 2, 32).training(minibatch_size=64)
            .build())
    try:
        result = algo.train()
        assert result["training_iteration"] == 1
        assert result["num_env_steps_sampled"] == 2 * 2 * 32
        assert np.isfinite(result["learner/total_loss"])
        assert algo.learner.device.type == "cpu"
        assert [r.info["cuda_visible_devices"]
                for r in algo.runner_group.runners] == ["", ""]
        assert algo.runner_group.weights_version == 1
    finally:
        algo.stop()
    assert not any(r.alive for r in algo.runner_group.runners)


def test_ppo_learns_cartpole():
    algo = (_cartpole(PPOConfig(), 4, 4, 64)
            .training(lr=3e-3, num_epochs=6, minibatch_size=256,
                      entropy_coeff=0.01).build())
    best = _learn(algo, 25, 120)
    assert best >= 120, f"PPO failed to learn: best={best}"


@pytest.mark.parametrize("cfg,extra", [(IMPALAConfig, {}),
                                       (APPOConfig, {"clip_param": 0.3})])
def test_impala_and_appo_learn_cartpole_with_two_learners(cfg, extra):
    algo = (_cartpole(cfg(), 2, 4, 64)
            .training(lr=3e-3, entropy_coeff=0.01, updates_per_iteration=8,
                      **extra)
            .learners(num_learners=2).build())
    assert [w.info["cuda_visible_devices"]
            for w in algo.learner_group.learners] == ["", ""]
    best = _learn(algo, 30, 120)
    assert best >= 120, f"{cfg.__name__} failed to learn: best={best}"


def test_impala_respawns_a_dead_runner():
    algo = (_cartpole(IMPALAConfig(), 2, 2, 16)
            .training(updates_per_iteration=4).build())
    try:
        algo.train()
        dead = algo.runners[0].pid
        algo.runners[0].kill()
        for _ in range(2):
            result = algo.train()
        assert algo.runners[0].pid != dead and algo.runners[0].alive
        assert np.isfinite(result["total_loss"])
    finally:
        algo.stop()


def _match(**training):
    spec = {"obs_dim": h.MatchGame.N_CTX, "num_actions": h.MatchGame.N_CTX,
            "hidden": training.pop("hidden")}
    return (MultiAgentPPOConfig()
            .environment(env_creator=h.MatchGame)
            .multi_agent(policies={"p0": spec, "p1": spec},
                         policy_mapping_fn=h.policy_for)
            .env_runners(2).training(**training).learners(use_gpu=False))


def test_multi_agent_ppo_two_policies_learn():
    algo = _match(hidden=(32,), rollout_fragment_length=128, lr=5e-3,
                  minibatch_size=64, num_epochs=4).build()
    try:
        result = None
        for _ in range(25):
            result = algo.train()
            # Perfect play: 2 agents x EP_LEN steps x 1.0 = 16.
            if result["episode_return_mean"] >= 13.0:
                break
        assert result["episode_return_mean"] >= 13.0, result
        assert any(k.startswith("learner/p0/") for k in result)
        assert any(k.startswith("learner/p1/") for k in result)
    finally:
        algo.stop()


def test_env_runner_killed_mid_iteration_recovers():
    """A killed runner must not shrink the iteration: the manager
    replaces it, re-syncs weights and re-samples the shard."""
    algo = _match(hidden=(16,), rollout_fragment_length=32,
                  minibatch_size=32).build()
    try:
        first = algo.train()
        assert first["num_env_steps_sampled"] > 0
        algo.runners.actors[0].kill()
        result = algo.train()
        assert result["num_runner_replacements"] >= 1
        assert result["num_env_steps_sampled"] >= \
            first["num_env_steps_sampled"]
        assert algo.train()["num_env_steps_sampled"] > 0
    finally:
        algo.stop()


def test_ppo_replacement_is_resynced_with_the_broadcast_version():
    algo = _cartpole(PPOConfig(), 2, 2, 16).training(
        minibatch_size=32, num_epochs=1).build()
    try:
        algo.train()
        algo.runner_group.runners[1].kill()
        before = len(flight.local_events(types=["rl.runner_resync"]))
        result = algo.train()
        assert result["num_runner_replacements"] == 1
        assert result["num_env_steps_sampled"] == 2 * 2 * 16
        versions = algo.runner_group._mgr.foreach("get_weights_version")
        assert [v for _, v in versions] == [2, 2]
        resyncs = flight.local_events(types=["rl.runner_resync"])
        assert len(resyncs) == before + 1
        assert resyncs[-1]["attrs"]["version"] == 2
    finally:
        algo.stop()


def test_ppo_checkpoint_round_trip(tmp_path):
    algo = _cartpole(PPOConfig(), 1, 1, 16).training(minibatch_size=16,
                                                     num_epochs=1).build()
    try:
        algo.train()
        saved = algo.get_policy_weights()
        algo.save_checkpoint(str(tmp_path))
        algo.train()
        algo.restore_checkpoint(str(tmp_path))
        for (_, a), (_, b) in zip(_flat(algo.get_policy_weights()),
                                  _flat(saved)):
            assert np.array_equal(a, b)
    finally:
        algo.stop()


@pytest.mark.parametrize("make", [
    lambda: PPOConfig().environment(env_creator=lambda: None),
    lambda: IMPALAConfig().environment(env_creator=lambda: None),
    lambda: _match(hidden=(4,)).multi_agent(
        policies={"p0": {"obs_dim": 3, "num_actions": 3}},
        policy_mapping_fn=lambda aid: "p0")])
def test_build_refuses_a_lambda_that_must_cross_to_runners(make):
    with pytest.raises(ValueError, match="module-level callable"):
        make().learners(use_gpu=False).build()


@pytest.mark.parametrize("cfg", [PPOConfig, IMPALAConfig, APPOConfig,
                                 DQNConfig])
def test_use_gpu_default_builds_on_the_card_or_raises(cfg):
    """``use_gpu`` left at its default asks the card: on a host without
    one ``build()`` raises; nothing falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default builds there")
    config = cfg().environment("CartPole-v1")
    assert config.use_gpu is True
    with pytest.raises(RuntimeError, match="CUDA"):
        config.build()


def test_use_gpu_default_raises_for_sac_and_multi_agent():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default builds there")
    with pytest.raises(RuntimeError, match="CUDA"):
        SACConfig().environment("Pendulum-v1").build()
    config = _match(hidden=(4,))
    config.use_gpu = True
    with pytest.raises(RuntimeError, match="CUDA"):
        config.build()
