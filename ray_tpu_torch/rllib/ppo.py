"""PPO algorithm (the port of ``ray_tpu/rllib/ppo.py``; reference:
``rllib/algorithms/ppo/ppo.py:362``).

``PPOConfig`` is the AlgorithmConfig-style builder (environment /
env_runners / training / learners fluent methods); ``PPO.train()`` is one
iteration of the loop: EnvRunnerGroup.sample -> GAE (in the runners) ->
the learner's minibatch update -> weight broadcast -> metrics. The
learner runs in this process, on the card unless
``.learners(use_gpu=False)``; the runners are CPU processes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.core import PPOLearner, PPOModule, SampleBatch
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup, resolve_env


def learner_device(use_gpu: bool) -> Optional[str]:
    """A learner's ``device``: None (the card, raising on a host without
    one) with ``use_gpu``, else ``"cpu"``."""
    return None if use_gpu else "cpu"


@dataclasses.dataclass
class PPOConfig:
    env: Optional[str] = None
    env_creator: Optional[Callable] = None
    num_env_runners: int = 2
    num_envs_per_env_runner: int = 4
    rollout_fragment_length: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.0
    num_epochs: int = 4
    minibatch_size: int = 128
    hidden_sizes: tuple = (64, 64)
    seed: int = 0
    use_gpu: bool = True

    # -- fluent builder (reference AlgorithmConfig style) ------------------
    def environment(self, env: Optional[str] = None, *,
                    env_creator: Optional[Callable] = None) -> "PPOConfig":
        self.env = env
        self.env_creator = env_creator
        return self

    def env_runners(self, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "PPOConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr: Optional[float] = None,
                 gamma: Optional[float] = None,
                 clip_param: Optional[float] = None,
                 entropy_coeff: Optional[float] = None,
                 num_epochs: Optional[int] = None,
                 minibatch_size: Optional[int] = None,
                 hidden_sizes: Optional[tuple] = None) -> "PPOConfig":
        for k, v in dict(lr=lr, gamma=gamma, clip_param=clip_param,
                         entropy_coeff=entropy_coeff, num_epochs=num_epochs,
                         minibatch_size=minibatch_size,
                         hidden_sizes=hidden_sizes).items():
            if v is not None:
                setattr(self, k, v)
        return self

    def learners(self, *, use_gpu: Optional[bool] = None) -> "PPOConfig":
        """``use_gpu`` (default True): the learner on the card, raising
        on a host without one; False learns on the CPU."""
        if use_gpu is not None:
            self.use_gpu = use_gpu
        return self

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    def __init__(self, config: PPOConfig):
        self.config = config
        creator = resolve_env(config)
        probe = creator()
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        probe.close()
        module_spec = {"obs_dim": obs_dim, "num_actions": num_actions,
                       "hidden": tuple(config.hidden_sizes)}
        self.learner = PPOLearner(
            PPOModule(**module_spec), lr=config.lr, clip=config.clip_param,
            vf_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff,
            num_epochs=config.num_epochs,
            minibatch_size=config.minibatch_size, seed=config.seed,
            device=learner_device(config.use_gpu))
        self.runner_group = EnvRunnerGroup(
            creator, module_spec, config.num_env_runners,
            config.num_envs_per_env_runner, config.gamma, config.lambda_)
        self.iteration = 0
        self._recent_returns: List[float] = []

    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: PPO.training_step :388)."""
        t0 = time.perf_counter()
        self.runner_group.sync_weights(self.learner.get_weights())
        batches, episode_returns = self.runner_group.sample(
            self.config.rollout_fragment_length)
        if not batches:
            return {"training_iteration": self.iteration}
        merged = SampleBatch(*[
            np.concatenate([getattr(b, f) for b in batches])
            for f in SampleBatch._fields])
        learner_metrics = self.learner.update_from_batch(merged)
        self.iteration += 1
        self._recent_returns.extend(episode_returns)
        self._recent_returns = self._recent_returns[-100:]
        mean_return = (float(np.mean(self._recent_returns))
                       if self._recent_returns else float("nan"))
        steps = len(merged.obs)
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": mean_return,
            "num_env_steps_sampled": steps,
            "env_steps_per_sec": steps / (time.perf_counter() - t0),
            "num_runner_replacements": self.runner_group.num_replacements,
            **{f"learner/{k}": v for k, v in learner_metrics.items()},
        }

    def get_policy_weights(self):
        return self.learner.get_weights()

    def save_checkpoint(self, path: str):
        from ray_tpu_torch.train.checkpoint import save_pytree

        st = self.learner.opt_state
        save_pytree({"params": self.learner.params,
                     "opt_state": {"count": np.asarray(st.count),
                                   "mu": st.mu, "nu": st.nu}}, path)

    def restore_checkpoint(self, path: str):
        from ray_tpu_torch.train.checkpoint import load_pytree

        state = load_pytree(path)
        self.learner.set_weights(state["params"])

    def stop(self):
        """Kill and reap every runner."""
        self.runner_group.stop()
