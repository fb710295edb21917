"""IMPALA: decoupled actor/learner RL with V-trace correction (the port
of ``ray_tpu/rllib/impala.py``).

Reference: ``rllib/algorithms/impala``: runners sample with a stale
behavior policy and never block on the learner; the learner consumes
trajectories as they arrive and corrects the off-policyness with
V-trace (``core.vtrace``). Rollouts stay in flight continuously: each
update waits for whichever runner finishes first
(``concurrent.futures.wait(..., FIRST_COMPLETED)`` over the runners'
call futures, where JAX waits on object refs), updates the
:class:`~ray_tpu_torch.rllib.learner_group.LearnerGroup`, pushes fresh
weights to that runner only and resubmits its next rollout; the others
keep sampling under their older policies, the staleness V-trace exists
to correct. The learners run on cards unless ``.learners(use_gpu=False)``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.core import ImpalaLearner, PPOModule
from ray_tpu_torch.rllib.env_runner import (TrajectoryEnvRunner,
                                            resolve_env, start_runner,
                                            wait_started)
from ray_tpu_torch.rllib.learner_group import LearnerGroup


@dataclasses.dataclass
class IMPALAConfig:
    env: Optional[str] = None
    env_creator: Optional[Callable] = None
    num_env_runners: int = 2
    num_envs_per_env_runner: int = 4
    rollout_fragment_length: int = 32
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_bar: float = 1.0
    c_bar: float = 1.0
    updates_per_iteration: int = 8
    num_learners: int = 1
    hidden_sizes: tuple = (64, 64)
    seed: int = 0
    use_gpu: bool = True

    # -- fluent builder (reference AlgorithmConfig style) ------------------
    def environment(self, env: Optional[str] = None, *,
                    env_creator: Optional[Callable] = None
                    ) -> "IMPALAConfig":
        self.env = env
        self.env_creator = env_creator
        return self

    def env_runners(self, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "IMPALAConfig":
        for k, v in dict(num_env_runners=num_env_runners,
                         num_envs_per_env_runner=num_envs_per_env_runner,
                         rollout_fragment_length=rollout_fragment_length
                         ).items():
            if v is not None:
                setattr(self, k, v)
        return self

    def training(self, **kwargs) -> "IMPALAConfig":
        known = {f.name for f in dataclasses.fields(self)}
        bad = set(kwargs) - known
        if bad:
            raise ValueError(f"Unknown IMPALA training options: "
                             f"{sorted(bad)}")
        for k, v in kwargs.items():
            if v is not None:
                setattr(self, k, v)
        return self

    def learners(self, num_learners: Optional[int] = None, *,
                 use_gpu: Optional[bool] = None) -> "IMPALAConfig":
        """``use_gpu`` (default True): a card a learner, raising on a
        host without one; False learns in CPU processes."""
        if num_learners is not None:
            self.num_learners = num_learners
        if use_gpu is not None:
            self.use_gpu = use_gpu
        return self

    def build(self) -> "IMPALA":
        return IMPALA(self)


def learner_group(config, learner_cls, module, **kwargs) -> LearnerGroup:
    """``config.num_learners`` learners of ``learner_cls(module,
    seed=config.seed, device=..., **kwargs)``, on a card each with
    ``config.use_gpu``."""
    return LearnerGroup(
        learner_cls, num_learners=config.num_learners,
        use_gpu=config.use_gpu, builder_args=(module,),
        builder_kwargs=dict(kwargs, seed=config.seed,
                            device="cuda" if config.use_gpu else "cpu"))


def stop_all(runners, group: LearnerGroup) -> None:
    """Kill and reap the runners and the learner processes."""
    for r in runners:
        r.kill()
    group.shutdown()


class IMPALA:
    def __init__(self, config: IMPALAConfig):
        self.config = config
        creator = resolve_env(config)
        probe = creator()
        obs_dim = int(np.prod(probe.observation_space.shape))
        num_actions = int(probe.action_space.n)
        probe.close()
        module_spec = {"obs_dim": obs_dim, "num_actions": num_actions,
                       "hidden": tuple(config.hidden_sizes)}
        self._spec = module_spec
        self._creator = creator
        self.learner_group = learner_group(
            config, ImpalaLearner, PPOModule(**module_spec),
            **self._learner_kwargs(config))
        self.runners = [self._runner(seed)
                        for seed in range(config.num_env_runners)]
        try:
            wait_started(self.runners)
            weights = self.learner_group.get_weights()
            for f in [r.call("set_weights", (weights,), {})
                      for r in self.runners]:
                f.result(timeout=120)
        except BaseException:
            self.stop()
            raise
        # Continuous in-flight rollouts: future -> runner index.
        self._inflight: Dict[concurrent.futures.Future, int] = {
            self._sample(r): i for i, r in enumerate(self.runners)}
        self.iteration = 0
        self._returns: List[float] = []

    def _runner(self, seed: int):
        return start_runner(TrajectoryEnvRunner, self._creator, self._spec,
                            self.config.num_envs_per_env_runner, seed)

    def _sample(self, runner):
        return runner.call("sample", (self.config.rollout_fragment_length,),
                           {})

    @staticmethod
    def _learner_kwargs(cfg) -> Dict[str, Any]:
        """The learners' options; APPO adds its ``clip_param``."""
        return dict(lr=cfg.lr, gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
                    entropy_coeff=cfg.entropy_coeff, rho_bar=cfg.rho_bar,
                    c_bar=cfg.c_bar)

    def train(self) -> Dict[str, Any]:
        """One iteration = ``updates_per_iteration`` learner updates, each
        on the first trajectory to arrive (runners stay decoupled)."""
        c = self.config
        t0 = time.monotonic()
        metrics: Dict[str, float] = {}
        episodes = 0
        for _ in range(c.updates_per_iteration):
            done, _ = concurrent.futures.wait(
                list(self._inflight), timeout=300,
                return_when=concurrent.futures.FIRST_COMPLETED)
            if not done:
                break
            fut = next(f for f in self._inflight if f in done)
            idx = self._inflight.pop(fut)
            try:
                traj, finished = fut.result()
            except Exception:  # noqa: BLE001 - the runner died: respawn
                self.runners[idx].kill()
                self.runners[idx] = self._runner(c.seed + 1000 + idx)
                self.runners[idx].call(
                    "set_weights", (self.learner_group.get_weights(),),
                    {}).result(timeout=120)
                self._inflight[self._sample(self.runners[idx])] = idx
                continue
            self._returns.extend(finished)
            episodes += len(finished)
            metrics = self.learner_group.update(traj)
            # Fresh weights to the runner that just delivered; resubmit.
            runner = self.runners[idx]
            runner.call("set_weights", (self.learner_group.get_weights(),),
                        {})
            self._inflight[self._sample(runner)] = idx
        self._returns = self._returns[-100:]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (float(np.mean(self._returns))
                                    if self._returns else float("nan")),
            "episodes_this_iter": episodes,
            "time_this_iter_s": time.monotonic() - t0,
            **metrics,
        }

    def get_weights(self):
        return self.learner_group.get_weights()

    def stop(self):
        """Kill and reap every runner and learner."""
        stop_all(self.runners, self.learner_group)
