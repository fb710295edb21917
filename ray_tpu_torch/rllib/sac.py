"""SAC: soft actor-critic for continuous action spaces (the port of
``ray_tpu/rllib/sac.py``).

Reference: ``rllib/algorithms/sac``: off-policy replay, twin critics
with Polyak target networks, a reparameterized squashed-Gaussian actor,
automatic temperature tuning. The loop mirrors
:mod:`ray_tpu_torch.rllib.dqn`: continuous runners fill a uniform replay
buffer, a :class:`~ray_tpu_torch.rllib.learner_group.LearnerGroup` of SAC
learners (on cards unless ``.learners(use_gpu=False)``) applies
allreduced updates, and the policy's weights go back to the runners each
iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.core import ReplayBuffer, SACLearner, SACModule
from ray_tpu_torch.rllib.env_runner import (ContinuousEnvRunner, call_all,
                                            resolve_env, start_runner,
                                            wait_started)
from ray_tpu_torch.rllib.impala import learner_group, stop_all


@dataclasses.dataclass
class SACConfig:
    env: Optional[str] = None
    env_creator: Optional[Callable] = None
    num_env_runners: int = 1
    num_envs_per_env_runner: int = 1
    rollout_fragment_length: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    buffer_size: int = 100_000
    train_batch_size: int = 128
    num_updates_per_iteration: int = 32
    learning_starts: int = 500
    num_learners: int = 1
    hidden_sizes: tuple = (128, 128)
    seed: int = 0
    use_gpu: bool = True

    # -- fluent builder (reference AlgorithmConfig style) ------------------
    def environment(self, env: Optional[str] = None, *,
                    env_creator: Optional[Callable] = None) -> "SACConfig":
        self.env = env
        self.env_creator = env_creator
        return self

    def env_runners(self, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "SACConfig":
        for k, v in dict(num_env_runners=num_env_runners,
                         num_envs_per_env_runner=num_envs_per_env_runner,
                         rollout_fragment_length=rollout_fragment_length
                         ).items():
            if v is not None:
                setattr(self, k, v)
        return self

    def training(self, **kwargs) -> "SACConfig":
        known = {f.name for f in dataclasses.fields(self)}
        bad = set(kwargs) - known
        if bad:
            raise ValueError(f"Unknown SAC training options: {sorted(bad)}")
        for k, v in kwargs.items():
            if v is not None:
                setattr(self, k, v)
        return self

    def learners(self, num_learners: Optional[int] = None, *,
                 use_gpu: Optional[bool] = None) -> "SACConfig":
        """``use_gpu`` (default True): a card a learner, raising on a
        host without one; False learns in CPU processes."""
        if num_learners is not None:
            self.num_learners = num_learners
        if use_gpu is not None:
            self.use_gpu = use_gpu
        return self

    def build(self) -> "SAC":
        return SAC(self)


class SAC:
    def __init__(self, config: SACConfig):
        self.config = config
        creator = resolve_env(config)
        probe = creator()
        obs_dim = int(np.prod(probe.observation_space.shape))
        action_dim = int(np.prod(probe.action_space.shape))
        probe.close()
        module_spec = {"obs_dim": obs_dim, "action_dim": action_dim,
                       "hidden": tuple(config.hidden_sizes)}
        self.learner_group = learner_group(
            config, SACLearner, SACModule(**module_spec), lr=config.lr,
            gamma=config.gamma, tau=config.tau)
        self.runners = [
            start_runner(ContinuousEnvRunner, creator, module_spec,
                         config.num_envs_per_env_runner, seed)
            for seed in range(config.num_env_runners)]
        try:
            wait_started(self.runners)
        except BaseException:
            self.stop()
            raise
        self.buffer = ReplayBuffer(config.buffer_size, obs_dim,
                                   seed=config.seed, action_dim=action_dim)
        self.iteration = 0
        self._returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        """One iteration: sample -> replay -> N learner updates -> sync."""
        c = self.config
        t0 = time.monotonic()
        # Runners only sample the policy: shipping the twin critics and
        # the temperature too would ~3x the broadcast for nothing.
        weights = {"pi": self.learner_group.get_weights()["pi"]}
        call_all(self.runners, "set_weights", weights, timeout=120)
        sampled = call_all(self.runners, "sample",
                           c.rollout_fragment_length)
        episode_returns: List[float] = []
        for transitions, finished in sampled:
            self.buffer.add(transitions)
            episode_returns.extend(finished)
        self._returns.extend(episode_returns)
        self._returns = self._returns[-100:]
        metrics: Dict[str, float] = {}
        if self.buffer.size >= max(c.learning_starts, c.train_batch_size):
            batches = [self.buffer.sample(c.train_batch_size)
                       for _ in range(c.num_updates_per_iteration)]
            metrics = self.learner_group.update_many(batches)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "buffer_size": self.buffer.size,
            "episode_return_mean": (float(np.mean(self._returns))
                                    if self._returns else float("nan")),
            "episodes_this_iter": len(episode_returns),
            "time_this_iter_s": time.monotonic() - t0,
            **metrics,
        }

    def get_weights(self):
        return self.learner_group.get_weights()

    def stop(self):
        """Kill and reap every runner and learner."""
        stop_all(self.runners, self.learner_group)
