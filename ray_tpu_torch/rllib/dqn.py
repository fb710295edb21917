"""DQN algorithm (the port of ``ray_tpu/rllib/dqn.py``; reference:
``rllib/algorithms/dqn/dqn.py``).

The loop's value-based variant: epsilon-greedy runners feed a uniform
replay buffer; a :class:`~ray_tpu_torch.rllib.learner_group.LearnerGroup`
of one or more learners (on cards unless ``.learners(use_gpu=False)``)
performs double-DQN updates, grads allreduced across learners; weights
broadcast back to the runners each iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.core import DQNLearner, DQNModule, ReplayBuffer
from ray_tpu_torch.rllib.env_runner import (TransitionEnvRunner, call_all,
                                            resolve_env, start_runner,
                                            wait_started)
from ray_tpu_torch.rllib.impala import learner_group, stop_all


@dataclasses.dataclass
class DQNConfig:
    env: Optional[str] = None
    env_creator: Optional[Callable] = None
    num_env_runners: int = 2
    num_envs_per_env_runner: int = 2
    rollout_fragment_length: int = 32
    lr: float = 5e-4
    gamma: float = 0.99
    buffer_size: int = 50_000
    train_batch_size: int = 64
    num_updates_per_iteration: int = 16
    learning_starts: int = 500
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_iterations: int = 30
    target_update_freq: int = 100
    num_learners: int = 1
    hidden_sizes: tuple = (64, 64)
    seed: int = 0
    use_gpu: bool = True

    # -- fluent builder (reference AlgorithmConfig style) ------------------
    def environment(self, env: Optional[str] = None, *,
                    env_creator: Optional[Callable] = None) -> "DQNConfig":
        self.env = env
        self.env_creator = env_creator
        return self

    def env_runners(self, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "DQNConfig":
        for k, v in dict(num_env_runners=num_env_runners,
                         num_envs_per_env_runner=num_envs_per_env_runner,
                         rollout_fragment_length=rollout_fragment_length
                         ).items():
            if v is not None:
                setattr(self, k, v)
        return self

    def training(self, **kwargs) -> "DQNConfig":
        known = {f.name for f in dataclasses.fields(self)}
        bad = set(kwargs) - known
        if bad:
            raise ValueError(f"Unknown DQN training options: {sorted(bad)}")
        for k, v in kwargs.items():
            if v is not None:
                setattr(self, k, v)
        return self

    def learners(self, num_learners: Optional[int] = None, *,
                 use_gpu: Optional[bool] = None) -> "DQNConfig":
        """``use_gpu`` (default True): a card a learner, raising on a
        host without one; False learns in CPU processes."""
        if num_learners is not None:
            self.num_learners = num_learners
        if use_gpu is not None:
            self.use_gpu = use_gpu
        return self

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    def __init__(self, config: DQNConfig):
        self.config = config
        creator = resolve_env(config)
        probe = creator()
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        probe.close()
        module_spec = {"obs_dim": obs_dim, "num_actions": num_actions,
                       "hidden": tuple(config.hidden_sizes)}
        self.learner_group = learner_group(
            config, DQNLearner, DQNModule(**module_spec), lr=config.lr,
            gamma=config.gamma, target_update_freq=config.target_update_freq)
        self.runners = [
            start_runner(TransitionEnvRunner, creator, module_spec,
                         config.num_envs_per_env_runner, seed)
            for seed in range(config.num_env_runners)]
        try:
            wait_started(self.runners)
        except BaseException:
            self.stop()
            raise
        self.buffer = ReplayBuffer(config.buffer_size, obs_dim,
                                   seed=config.seed)
        self.iteration = 0
        self._returns: List[float] = []

    def _epsilon(self) -> float:
        c = self.config
        frac = min(self.iteration / max(c.epsilon_decay_iterations, 1), 1.0)
        return c.epsilon_initial + frac * (c.epsilon_final
                                           - c.epsilon_initial)

    def train(self) -> Dict[str, Any]:
        """One iteration: sample -> replay -> N learner updates -> sync."""
        c = self.config
        t0 = time.monotonic()
        eps = self._epsilon()
        weights = self.learner_group.get_weights()
        call_all(self.runners, "set_weights", weights, timeout=120)
        call_all(self.runners, "set_epsilon", eps, timeout=120)
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
            "epsilon": eps,
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
