"""Env runners: distributed rollout collection (the port of
``ray_tpu/rllib/env_runner.py``).

Reference: ``rllib/env/single_agent_env_runner.py:65`` (``sample`` :140:
vectorized envs stepped with the current policy) and ``EnvRunnerGroup``
(env_runner_group.py:71) over the fault-tolerant actor manager
(utils/actor_manager.py:198): a dead runner is replaced, re-synced and
re-sampled within the round.

A runner lives in a CPU process of the port's runtime
(:func:`start_runner`: forked from the fork server, no card, one torch
thread), as RLlib's runners default to no GPU; its forwards are plain
torch on the CPU. The learners run on the card. The runners' env and
callables cross to that process by pickle, so they must be module-level
(or ``functools.partial``s of module-level callables).

The vector env is :class:`SyncVectorEnv`, the port's own copy of what
the runners rely on from ``gymnasium.vector.SyncVectorEnv`` 1.x (the port
does not depend on gymnasium); an env is anything with gymnasium's
``reset(seed=)`` / ``step`` and ``observation_space`` / ``action_space``.
"""

from __future__ import annotations

import functools
import pickle
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.rllib.core import (DQNModule, PPOModule, SACModule,
                                      SampleBatch, Transition, compute_gae)

#: Seconds a runner process may take to build its envs.
RUNNER_START_S = 300.0


def make_gym_env(name: str):
    """``gymnasium.make(name)``: the string env resolver (gymnasium is
    imported here only)."""
    import gymnasium as gym

    return gym.make(name)


def portable(fn: Callable, what: str) -> Callable:
    """``fn`` if it can cross to a runner process (pickled by reference:
    a module-level callable or a ``functools.partial`` of one), else a
    ValueError naming ``what``."""
    try:
        pickle.dumps(fn)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise ValueError(
            f"{what} {fn!r} cannot cross to the runner processes, which "
            f"receive it by pickle: pass a module-level callable or a "
            f"functools.partial of one, not a lambda or a local function "
            f"({e})") from e
    return fn


def resolve_env(config) -> Callable:
    """The config's env creator: its ``env_creator``, or for an ``env``
    name ``functools.partial(make_gym_env, name)``."""
    if config.env_creator is not None:
        return portable(config.env_creator, "env_creator")
    if config.env is None:
        raise ValueError(f"{type(config).__name__} needs "
                         f".environment(env=...) or env_creator")
    return functools.partial(make_gym_env, config.env)


def start_runner(cls, *args):
    """A process hosting ``cls(*args)``: forked from the runtime's fork
    server, with no card (``CUDA_VISIBLE_DEVICES=""``), one intra-op
    thread (four runners' default thread counts would fight over the
    cores for matmuls of a few rows), and one call at a time, in order
    (JAX's actors are serial too). Not waited for: a call queues until
    the runner is built, and fails if it could not be."""
    from ray_tpu_torch.runtime.replica import ReplicaProcess

    return ReplicaProcess("env_runner", cls, args, {}, False,
                          sync_workers=1, env={"CUDA_VISIBLE_DEVICES": ""},
                          num_threads=1)


def wait_started(runners) -> None:
    """Wait until every runner is built (raising a constructor's error)."""
    for r in runners:
        r.wait_ready(RUNNER_START_S)


def call_all(runners, method: str, *args, timeout: float = 300):
    """``method(*args)`` on every runner at once; their results."""
    futures = [r.call(method, args, {}) for r in runners]
    return [f.result(timeout=timeout) for f in futures]


class SyncVectorEnv:
    """``gymnasium.vector.SyncVectorEnv`` (1.x) as the runners use it:
    ``reset(seed=s)`` seeds sub-env ``i`` with ``s + i``; next-step
    autoreset (the step after a sub-env's done resets it, returns its
    reset obs with reward 0 and no done, and ignores its action); obs
    stacked in the observation space's dtype, float64 rewards, bool
    terminations and truncations."""

    def __init__(self, env_fns):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._autoreset = np.zeros(self.num_envs, dtype=np.bool_)

    def _stack(self, obs):
        return np.stack(obs).astype(self.single_observation_space.dtype,
                                    copy=False)

    def reset(self, *, seed=None):
        seeds = ([None] * self.num_envs if seed is None
                 else [seed + i for i in range(self.num_envs)])
        obs = [env.reset(seed=s)[0] for env, s in zip(self.envs, seeds)]
        self._autoreset[:] = False
        return self._stack(obs), {}

    def step(self, actions):
        n = self.num_envs
        obs = []
        rewards = np.zeros((n,), dtype=np.float64)
        terms = np.zeros((n,), dtype=np.bool_)
        truncs = np.zeros((n,), dtype=np.bool_)
        for i, (env, action) in enumerate(zip(self.envs, actions)):
            if self._autoreset[i]:
                o, _ = env.reset()
            else:
                o, rewards[i], terms[i], truncs[i], _ = env.step(action)
            obs.append(o)
        self._autoreset = np.logical_or(terms, truncs)
        return self._stack(obs), rewards, terms, truncs, {}

    def close(self):
        for env in self.envs:
            env.close()


class _Runner:
    """What every runner shares: torch params on the CPU and the version
    of the weights it last received."""

    params: Any = None
    weights_version = 0

    def set_weights(self, weights, version=None) -> int:
        """Take ``weights`` (a numpy tree), stamped with ``version``;
        ``None`` auto-increments (a caller that does not version its
        broadcasts still gets a monotone counter), and an explicit one
        comes from EnvRunnerGroup, so a respawned runner reports the
        version it was re-synced with."""
        self.params = params_from_numpy(weights, "cpu")
        self.weights_version = (self.weights_version + 1 if version is None
                                else int(version))
        return self.weights_version

    def get_weights_version(self) -> int:
        return self.weights_version

    def ping(self):
        return True


class _DiscreteRolloutRunner(_Runner):
    """The categorical-policy rollout loop of SingleAgentEnvRunner and
    TrajectoryEnvRunner: vectorized envs stepped with the current
    policy, episode returns tracked."""

    def __init__(self, env_creator: Callable, module_spec: Dict[str, Any],
                 num_envs: int = 1, seed: int = 0):
        self.envs = SyncVectorEnv([env_creator] * num_envs)
        self.num_envs = num_envs
        self.module = PPOModule(**module_spec)
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.envs.reset(seed=seed)
        self._episode_returns = np.zeros(num_envs, dtype=np.float64)
        self._finished_returns: List[float] = []

    @torch.no_grad()
    def _forward(self, obs):
        """(log-softmax of the logits, values) as numpy."""
        o = torch.from_numpy(obs.astype(np.float32))
        return (torch.log_softmax(self.module.logits(self.params, o),
                                  dim=-1).numpy(),
                self.module.value(self.params, o).numpy())

    def _rollout(self, num_steps: int):
        T, N = num_steps, self.num_envs
        buf = {
            "obs": np.zeros((T, N) + self.obs.shape[1:], np.float32),
            "actions": np.zeros((T, N), np.int64),
            "logp": np.zeros((T, N), np.float32),
            "values": np.zeros((T, N), np.float32),
            "rewards": np.zeros((T, N), np.float32),
            "dones": np.zeros((T, N), np.float32),
        }
        for t in range(T):
            logp_all, values = self._forward(self.obs)
            probs = np.exp(logp_all)
            probs /= probs.sum(-1, keepdims=True)
            actions = np.array([self.rng.choice(len(p), p=p)
                                for p in probs])
            buf["obs"][t] = self.obs
            buf["actions"][t] = actions
            buf["logp"][t] = logp_all[np.arange(N), actions]
            buf["values"][t] = values
            self.obs, rewards, terms, truncs, _ = self.envs.step(actions)
            dones = np.logical_or(terms, truncs)
            buf["rewards"][t] = rewards
            buf["dones"][t] = dones
            self._episode_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._finished_returns.append(self._episode_returns[i])
                    self._episode_returns[i] = 0.0
        finished, self._finished_returns = self._finished_returns, []
        return buf, finished


class SingleAgentEnvRunner(_DiscreteRolloutRunner):
    """On-policy runner: [T, N] rollouts with GAE, flattened into a
    :class:`SampleBatch`."""

    def __init__(self, env_creator: Callable, module_spec: Dict[str, Any],
                 num_envs: int = 1, seed: int = 0,
                 gamma: float = 0.99, lam: float = 0.95):
        super().__init__(env_creator, module_spec, num_envs, seed)
        self.gamma = gamma
        self.lam = lam

    def sample(self, num_steps: int) -> Tuple[SampleBatch, List[float]]:
        """Collect ``num_steps`` per env; returns batch + episode returns."""
        buf, finished = self._rollout(num_steps)
        _, last_values = self._forward(self.obs)
        adv, ret = compute_gae(buf["rewards"], buf["values"], buf["dones"],
                               last_values, self.gamma, self.lam)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        batch = SampleBatch(
            obs=flat(buf["obs"]), actions=flat(buf["actions"]),
            logprobs=flat(buf["logp"]), values=flat(buf["values"]),
            advantages=flat(adv).astype(np.float32),
            returns=flat(ret).astype(np.float32))
        return batch, finished


class EnvRunnerGroup:
    """Fault-tolerant group of runner processes over
    :class:`~ray_tpu_torch.rllib.actor_manager.FaultTolerantActorManager`
    (reference: EnvRunnerGroup over ``utils/actor_manager.py:198``): a
    runner dying mid-iteration is replaced, re-synced with the last
    broadcast weights and their version, and re-sampled, so the
    iteration keeps its full shard count."""

    def __init__(self, env_creator, module_spec, num_runners: int,
                 num_envs_per_runner: int, gamma: float, lam: float):
        from ray_tpu_torch.rllib.actor_manager import (
            FaultTolerantActorManager)

        self._weights = None
        self._weights_version = 0

        def factory(seed: int):
            return start_runner(SingleAgentEnvRunner, env_creator,
                                module_spec, num_envs_per_runner, seed,
                                gamma, lam)

        def on_replace(runner):
            # A fresh replacement starts from version 0: re-push the last
            # broadcast WITH its version, so the respawned runner reports
            # its peers' weights generation, and journal the resync.
            if self._weights is not None:
                from ray_tpu_torch._private import events as _events

                got = runner.call("set_weights", (self._weights,
                                                  self._weights_version),
                                  {}).result(timeout=120)
                _events.emit("rl.runner_resync",
                             subject={"group": "env_runners"},
                             version=int(got))

        self._mgr = FaultTolerantActorManager(factory, num_runners,
                                              on_replace=on_replace)
        try:
            wait_started(self._mgr.actors)
        except BaseException:
            self._mgr.kill_all()
            raise

    @property
    def runners(self):
        return self._mgr.actors

    @property
    def num_replacements(self) -> int:
        return self._mgr.num_replacements

    @property
    def weights_version(self) -> int:
        return self._weights_version

    def sync_weights(self, weights, version=None) -> int:
        """Broadcast ``weights`` to every runner, stamped with a version
        (auto-incremented when the caller supplies none). The stored
        (weights, version) pair is what ``on_replace`` re-pushes, so a
        runner respawned mid-iteration never samples under stale weights
        while claiming to be current."""
        from ray_tpu_torch._private import events as _events

        self._weights = weights
        self._weights_version = (int(version) if version is not None
                                 else self._weights_version + 1)
        self._mgr.foreach("set_weights", weights, self._weights_version,
                          timeout_s=120)
        _events.emit("rl.weights_broadcast",
                     subject={"group": "env_runners"},
                     version=self._weights_version,
                     runners=len(self._mgr.actors))
        return self._weights_version

    def sample(self, num_steps: int):
        results = self._mgr.foreach("sample", num_steps)
        batches, episode_returns = [], []
        for _, (batch, finished) in results:
            batches.append(batch)
            episode_returns.extend(finished)
        return batches, episode_returns

    def stop(self) -> None:
        """Kill and reap every runner."""
        self._mgr.kill_all()


class TrajectoryEnvRunner(_DiscreteRolloutRunner):
    """Decoupled IMPALA-style rollout collector: steps its (stale)
    behavior policy and returns raw [T, N] trajectories with behavior
    log-probs for V-trace correction (reference: the actor half of
    ``rllib/algorithms/impala``: runners never wait for the learner)."""

    def sample(self, num_steps: int):
        buf, finished = self._rollout(num_steps)
        traj = {
            "obs": buf["obs"], "actions": buf["actions"],
            "behavior_logp": buf["logp"], "rewards": buf["rewards"],
            "dones": buf["dones"],
            "bootstrap_obs": self.obs.astype(np.float32),
        }
        return traj, finished


class _TransitionCollector(_Runner):
    """The transition-collection loop of value-based and off-policy
    runners. Owns the subtle invariants once: next-step autoreset (the
    step after a done is the reset; its action is ignored and must not
    be recorded), termination-versus-truncation bootstrapping
    (time-limit truncations keep their value), and episode returns.
    Subclasses supply ``_select(obs) -> (env_actions, stored_actions)``."""

    def __init__(self, env_creator: Callable, num_envs: int, seed: int):
        self.envs = SyncVectorEnv([env_creator] * num_envs)
        self.num_envs = num_envs
        self.obs, _ = self.envs.reset(seed=seed)
        self._episode_returns = np.zeros(num_envs, dtype=np.float64)
        self._finished_returns: List[float] = []
        self._resetting = np.zeros(num_envs, dtype=bool)

    def _select(self, obs):
        raise NotImplementedError

    def sample(self, num_steps: int):
        rows = {k: [] for k in Transition._fields}
        for _ in range(num_steps):
            env_actions, stored = self._select(self.obs)
            nxt, rewards, terms, truncs, _ = self.envs.step(env_actions)
            valid = ~self._resetting
            rows["obs"].append(self.obs[valid].astype(np.float32))
            rows["actions"].append(stored[valid])
            rows["rewards"].append(rewards[valid].astype(np.float32))
            rows["next_obs"].append(nxt[valid].astype(np.float32))
            # Bootstrapping cuts only at true terminations; time-limit
            # truncations keep their value (partial-episode bootstrap,
            # and `nxt` at the done step is the episode's true final obs).
            rows["dones"].append(terms[valid].astype(np.float32))
            dones = np.logical_or(terms, truncs)
            self._episode_returns[valid] += rewards[valid]
            for i in np.nonzero(dones & valid)[0]:
                self._finished_returns.append(self._episode_returns[i])
                self._episode_returns[i] = 0.0
            self._resetting = dones
            self.obs = nxt
        finished, self._finished_returns = self._finished_returns, []
        return Transition(*[np.concatenate(rows[k]) for k in
                            Transition._fields]), finished


class ContinuousEnvRunner(_TransitionCollector):
    """Transition collector for continuous action spaces (the SAC runner
    side): samples squashed-Gaussian actions from the current policy
    (noise from a CPU generator seeded ``seed``) and rescales them into
    the env's bounds; replay stores the UNIT action, the policy's own
    space."""

    def __init__(self, env_creator: Callable, module_spec: Dict[str, Any],
                 num_envs: int = 1, seed: int = 0):
        super().__init__(env_creator, num_envs, seed)
        self.module = SACModule(**module_spec)
        space = self.envs.single_action_space
        self._low = np.asarray(space.low, np.float32)
        self._high = np.asarray(space.high, np.float32)
        if not (np.all(np.isfinite(self._low))
                and np.all(np.isfinite(self._high))):
            raise ValueError(
                "ContinuousEnvRunner needs a bounded Box action space "
                f"(got low={space.low}, high={space.high}): the tanh "
                "policy rescales unit actions into [low, high]")
        self._gen = torch.Generator().manual_seed(seed)

    @torch.no_grad()
    def _select(self, obs):
        unit, _ = self.module.sample_action(
            self.params, torch.from_numpy(obs.astype(np.float32)), self._gen)
        unit = unit.numpy()  # in (-1, 1)
        env_actions = self._low + (unit + 1.0) * 0.5 * (self._high
                                                        - self._low)
        return env_actions, unit


class TransitionEnvRunner(_TransitionCollector):
    """Epsilon-greedy transition collector for value-based algorithms
    (reference: the DQN rollout path of ``single_agent_env_runner.py``:
    transitions, not GAE trajectories)."""

    def __init__(self, env_creator: Callable, module_spec: Dict[str, Any],
                 num_envs: int = 1, seed: int = 0):
        super().__init__(env_creator, num_envs, seed)
        self.module = DQNModule(**module_spec)
        self.epsilon = 1.0
        self.rng = np.random.default_rng(seed)

    def set_epsilon(self, epsilon: float):
        self.epsilon = float(epsilon)
        return True

    @torch.no_grad()
    def _select(self, obs):
        q = self.module.q_values(
            self.params, torch.from_numpy(obs.astype(np.float32))).numpy()
        greedy = q.argmax(axis=-1)
        explore = self.rng.random(self.num_envs) < self.epsilon
        random_a = self.rng.integers(0, q.shape[-1], size=self.num_envs)
        actions = np.where(explore, random_a, greedy)
        return actions, actions
