"""Multi-agent RL: env API, rollout runner and multi-policy PPO (the port
of ``ray_tpu/rllib/multi_agent.py``).

Reference: ``rllib/env/multi_agent_env.py`` (the dict-keyed env API),
``rllib/env/multi_agent_env_runner.py`` (per-agent episode collection)
and the multi-policy training loop of ``algorithms/ppo`` with
``policy_mapping_fn`` routing agents to policies. One PPOLearner per
policy, in this process on the card unless ``.learners(use_gpu=False)``;
rollouts gathered through the fault-tolerant manager from CPU runner
processes, so a dead runner is replaced, re-synced and re-sampled within
the same iteration. The env creator and ``policy_mapping_fn`` cross to
the runners by pickle: a lambda is refused at ``build()``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.rllib.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rllib.core import (PPOLearner, PPOModule, SampleBatch,
                                      compute_gae)
from ray_tpu_torch.rllib.env_runner import (portable, start_runner,
                                            wait_started)
from ray_tpu_torch.rllib.ppo import learner_device


class MultiAgentEnv:
    """Dict-keyed multi-agent env (reference: multi_agent_env.py).

    ``reset() -> (obs_dict, info)``; ``step(action_dict) -> (obs_dict,
    reward_dict, terminated_dict, truncated_dict, info)``. The
    ``terminated``/``truncated`` dicts carry the ``"__all__"`` key ending
    the episode for every agent. Agents may appear in any subset of
    steps; only agents present in ``obs_dict`` act next step.
    """

    possible_agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def close(self):
        pass


class _AgentTrajectory:
    """Per-agent rollout buffer: GAE runs over each agent's OWN timeline
    (agents may act on different subsets of env steps)."""

    __slots__ = ("obs", "actions", "logp", "values", "rewards", "dones")

    def __init__(self):
        self.obs: List[np.ndarray] = []
        self.actions: List[int] = []
        self.logp: List[float] = []
        self.values: List[float] = []
        self.rewards: List[float] = []
        self.dones: List[float] = []


class MultiAgentEnvRunner:
    """Steps one multi-agent env, routing each agent through its policy's
    module (reference: multi_agent_env_runner.py sample()); forwards are
    plain torch on the CPU."""

    def __init__(self, env_creator: Callable[[], MultiAgentEnv],
                 module_specs: Dict[str, Dict[str, Any]],
                 policy_mapping: Callable[[str], str],
                 seed: int = 0, gamma: float = 0.99, lam: float = 0.95):
        self.env = env_creator()
        self.gamma = gamma
        self.lam = lam
        self.policy_mapping = policy_mapping
        self.modules = {pid: PPOModule(**spec)
                        for pid, spec in module_specs.items()}
        self.params: Dict[str, Any] = {}
        self.rng = np.random.default_rng(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0

    def set_weights(self, weights_by_policy: Dict[str, Any]) -> bool:
        self.params = {pid: params_from_numpy(w, "cpu")
                       for pid, w in weights_by_policy.items()}
        return True

    @torch.no_grad()
    def _act(self, agent_id: str, obs) -> Tuple[int, float, float]:
        pid = self.policy_mapping(agent_id)
        m, p = self.modules[pid], self.params[pid]
        o = torch.from_numpy(np.asarray(obs, np.float32)[None])
        logp_all = torch.log_softmax(m.logits(p, o), dim=-1).numpy()[0]
        value = m.value(p, o).numpy()
        probs = np.exp(logp_all)
        probs /= probs.sum()
        action = int(self.rng.choice(len(probs), p=probs))
        return action, float(logp_all[action]), float(value[0])

    def sample(self, num_steps: int):
        """Collect ``num_steps`` env steps. Returns
        ``(per_policy_batches, episode_returns)`` where each batch is a
        dict of SampleBatch fields."""
        trajs: Dict[str, _AgentTrajectory] = {}
        finished: Dict[str, List[_AgentTrajectory]] = {}
        episode_returns: List[float] = []

        def finish_episode():
            for aid, traj in trajs.items():
                if traj.dones:
                    traj.dones[-1] = 1.0
                finished.setdefault(aid, []).append(traj)
            trajs.clear()

        for _ in range(num_steps):
            actions: Dict[str, Any] = {}
            for aid, obs in self._obs.items():
                a, logp, v = self._act(aid, obs)
                actions[aid] = a
                traj = trajs.setdefault(aid, _AgentTrajectory())
                traj.obs.append(np.asarray(obs, np.float32))
                traj.actions.append(a)
                traj.logp.append(logp)
                traj.values.append(v)
            obs, rewards, terms, truncs, _ = self.env.step(actions)
            for aid in actions:
                traj = trajs[aid]
                traj.rewards.append(float(rewards.get(aid, 0.0)))
                done = bool(terms.get(aid) or truncs.get(aid))
                traj.dones.append(1.0 if done else 0.0)
                self._episode_return += float(rewards.get(aid, 0.0))
            if terms.get("__all__") or truncs.get("__all__"):
                finish_episode()
                episode_returns.append(self._episode_return)
                self._episode_return = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = obs
        # Rollout ended mid-episode: bootstrap each live trajectory with
        # the agent's current value estimate.
        bootstraps: Dict[str, float] = {}
        for aid, obs in self._obs.items():
            if aid in trajs:
                _, _, v = self._act(aid, obs)
                bootstraps[aid] = v
        for aid, traj in trajs.items():
            finished.setdefault(aid, []).append(traj)
        per_policy: Dict[str, Dict[str, np.ndarray]] = {}
        for aid, traj_list in finished.items():
            pid = self.policy_mapping(aid)
            for traj in traj_list:
                if not traj.rewards:
                    continue
                T = len(traj.rewards)
                rew = np.asarray(traj.rewards, np.float32).reshape(T, 1)
                val = np.asarray(traj.values, np.float32).reshape(T, 1)
                don = np.asarray(traj.dones, np.float32).reshape(T, 1)
                last_v = np.asarray(
                    [0.0 if don[-1, 0] else bootstraps.get(aid, 0.0)],
                    np.float32)
                adv, ret = compute_gae(rew, val, don, last_v, self.gamma,
                                       self.lam)
                out = per_policy.setdefault(pid, {
                    f: [] for f in SampleBatch._fields})
                out["obs"].append(np.stack(traj.obs))
                out["actions"].append(np.asarray(traj.actions, np.int64))
                out["logprobs"].append(np.asarray(traj.logp, np.float32))
                out["values"].append(val[:, 0])
                out["advantages"].append(adv[:, 0].astype(np.float32))
                out["returns"].append(ret[:, 0].astype(np.float32))
        batches = {
            pid: {f: np.concatenate(v) for f, v in fields.items()}
            for pid, fields in per_policy.items()}
        return batches, episode_returns

    def ping(self):
        return True


@dataclasses.dataclass
class MultiAgentPPOConfig:
    env_creator: Optional[Callable] = None
    policies: Optional[Dict[str, Dict[str, Any]]] = None  # pid->module_spec
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    num_env_runners: int = 2
    rollout_fragment_length: int = 128
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    entropy_coeff: float = 0.0
    num_epochs: int = 4
    minibatch_size: int = 128
    seed: int = 0
    use_gpu: bool = True

    def environment(self, *, env_creator: Callable) -> "MultiAgentPPOConfig":
        self.env_creator = env_creator
        return self

    def multi_agent(self, *, policies: Dict[str, Dict[str, Any]],
                    policy_mapping_fn: Callable[[str], str]
                    ) -> "MultiAgentPPOConfig":
        self.policies = policies
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def env_runners(self, num_env_runners: int) -> "MultiAgentPPOConfig":
        self.num_env_runners = num_env_runners
        return self

    def training(self, **kw) -> "MultiAgentPPOConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(k)
            setattr(self, k, v)
        return self

    def learners(self, *, use_gpu: Optional[bool] = None
                 ) -> "MultiAgentPPOConfig":
        """``use_gpu`` (default True): the policies' learners on the
        card, raising on a host without one; False learns on the CPU."""
        if use_gpu is not None:
            self.use_gpu = use_gpu
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """Multi-policy PPO: one learner per policy, shared rollouts."""

    def __init__(self, config: MultiAgentPPOConfig):
        if not config.policies or config.policy_mapping_fn is None:
            raise ValueError("multi_agent(policies=..., policy_mapping_fn"
                             "=...) is required")
        creator = portable(config.env_creator, "env_creator")
        mapping = portable(config.policy_mapping_fn, "policy_mapping_fn")
        self.config = config
        self.learners = {
            pid: PPOLearner(
                PPOModule(**spec), lr=config.lr, clip=config.clip_param,
                entropy_coeff=config.entropy_coeff,
                num_epochs=config.num_epochs,
                minibatch_size=config.minibatch_size,
                seed=config.seed + i, device=learner_device(config.use_gpu))
            for i, (pid, spec) in enumerate(config.policies.items())}
        specs = config.policies

        def factory(index: int):
            return start_runner(MultiAgentEnvRunner, creator, specs,
                                mapping, config.seed + index, config.gamma,
                                config.lambda_)

        self._last_weights = self.get_weights()
        self.runners = FaultTolerantActorManager(
            factory, config.num_env_runners,
            on_replace=lambda r: r.call(
                "set_weights", (self._last_weights,), {}).result(
                    timeout=120))
        try:
            wait_started(self.runners.actors)
        except BaseException:
            self.stop()
            raise
        self.iteration = 0
        self._recent_returns: List[float] = []

    def get_weights(self) -> Dict[str, Any]:
        return {pid: ln.get_weights() for pid, ln in self.learners.items()}

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        self._last_weights = self.get_weights()
        self.runners.foreach("set_weights", self._last_weights,
                             timeout_s=120)
        results = self.runners.foreach(
            "sample", self.config.rollout_fragment_length)
        merged: Dict[str, Dict[str, List[np.ndarray]]] = {}
        episode_returns: List[float] = []
        for _, (batches, returns) in results:
            episode_returns.extend(returns)
            for pid, fields in batches.items():
                out = merged.setdefault(
                    pid, {f: [] for f in SampleBatch._fields})
                for f, arr in fields.items():
                    out[f].append(arr)
        metrics: Dict[str, Any] = {}
        steps = 0
        for pid, fields in merged.items():
            batch = SampleBatch(**{
                f: np.concatenate(v) for f, v in fields.items()})
            steps += len(batch.obs)
            for k, v in self.learners[pid].update_from_batch(batch).items():
                metrics[f"learner/{pid}/{k}"] = v
        self.iteration += 1
        self._recent_returns.extend(episode_returns)
        self._recent_returns = self._recent_returns[-100:]
        return {
            "training_iteration": self.iteration,
            "episode_return_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns else float("nan")),
            "num_env_steps_sampled": steps,
            "env_steps_per_sec": steps / (time.perf_counter() - t0),
            "num_runner_replacements": self.runners.num_replacements,
            **metrics,
        }

    def stop(self):
        """Kill and reap every runner."""
        self.runners.kill_all()


__all__ = ["MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
           "MultiAgentPPOConfig"]
