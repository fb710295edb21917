"""RL core: policy and value networks and the learners' updates (the port
of ``ray_tpu/rllib/core.py``).

Reference: ``rllib/core``: ``RLModule`` (rl_module.py:260) holds the
networks, ``Learner`` / ``TorchLearner`` (learner.py:111,
torch_learner.py:62) owns the optimized update. A module is a param tree
in JAX's layout (a dict of lists of ``{"w": [din, dout], "b": [dout]}``
layers) with pure apply functions. A learner holds its tree on its
device, the card unless the caller asks for the CPU, takes its grads
with autograd and steps ``optax.adam``'s arithmetic in place
(:func:`ray_tpu_torch.rl.experience._adam`). ``compute_gradients`` and
``apply_gradients`` are split, as in JAX, so a
:class:`~ray_tpu_torch.rllib.learner_group.LearnerGroup` can allreduce
between them.

JAX draws its init from threefry keys, the port from a CPU
``torch.Generator`` (the same values whatever the learner's device), so
the two packages' random inits differ: ``set_weights`` carries a JAX tree
across. :class:`SampleBatch`, :func:`compute_gae`, :class:`Transition`
and :class:`ReplayBuffer` are JAX's numpy code unchanged, so the same
seeds give the same samples bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.rl.weight_sync import _flat, _nest


def mlp_init(gen: torch.Generator, sizes, scale=None):
    """Layers ``sizes[i] -> sizes[i+1]``: normal weights scaled by
    ``sqrt(2 / din)``, the last layer's by ``scale`` when given, zero
    biases (fp32, on the CPU)."""
    params = []
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        s = scale if (scale is not None and i == len(sizes) - 2) \
            else float(np.sqrt(2.0 / din))
        params.append({
            "w": torch.randn((din, dout), generator=gen) * s,
            "b": torch.zeros((dout,)),
        })
    return params


def mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.tanh(x)
    return x


class PPOModule:
    """Actor-critic module for discrete action spaces."""

    def __init__(self, obs_dim: int, num_actions: int, hidden=(64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        return {
            "pi": mlp_init(gen, (self.obs_dim, *self.hidden,
                                 self.num_actions), scale=0.01),
            "vf": mlp_init(gen, (self.obs_dim, *self.hidden, 1), scale=1.0),
        }

    @staticmethod
    def logits(params, obs):
        return mlp_apply(params["pi"], obs)

    @staticmethod
    def value(params, obs):
        return mlp_apply(params["vf"], obs)[..., 0]


class SampleBatch(NamedTuple):
    obs: np.ndarray
    actions: np.ndarray
    logprobs: np.ndarray
    values: np.ndarray
    advantages: np.ndarray
    returns: np.ndarray


def compute_gae(rewards, values, dones, last_values, gamma, lam):
    """Generalized advantage estimation over [T, N] rollouts."""
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    lastgaelam = np.zeros(rewards.shape[1], dtype=np.float32)
    for t in reversed(range(T)):
        nextvalue = last_values if t == T - 1 else values[t + 1]
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * nextvalue * nonterminal - values[t]
        lastgaelam = delta + gamma * lam * nonterminal * lastgaelam
        adv[t] = lastgaelam
    returns = adv + values
    return adv, returns


def _entropy(logp_all):
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


def _floats(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


class _Learner:
    """What the learners share: ``params`` on ``device`` (None: the card,
    which raises on a host without one), ``optax.adam(lr)``'s step in
    place over the leaves in ``jax.tree.leaves`` order, and JAX's
    ``get_weights`` (a numpy tree, a copy) / ``set_weights`` (a numpy or
    tensor tree)."""

    def __init__(self, params, lr: float, device):
        from ray_tpu_torch.models.llama import default_device
        from ray_tpu_torch.rl.experience import _adam

        self.device = default_device(device)
        self.optimizer = _adam(lr)
        self.set_weights(params)
        self.opt_state = self.optimizer.init(self._leaves())

    def _leaves(self):
        return [t for _, t in _flat(self.params)]

    def _value_and_grad(self, loss_fn, *args):
        """(loss, metrics, grads): grads in the params' nesting."""
        paths = [p for p, _ in _flat(self.params)]
        loss, metrics = loss_fn(self.params, *args)
        grads = torch.autograd.grad(loss, self._leaves())
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _nest(list(zip(paths, grads))))

    def _tensors(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def apply_gradients(self, grads) -> None:
        """One Adam step on ``grads`` (a tree of the params' nesting),
        in place."""
        self.opt_state = self.optimizer.apply_(
            [g for _, g in _flat(grads)], self.opt_state, self._leaves())

    def get_weights(self):
        return _nest([(p, t.detach().to("cpu", copy=True).numpy())
                      for p, t in _flat(self.params)])

    def set_weights(self, weights) -> None:
        self.params = params_from_numpy(weights, self.device)
        for t in self._leaves():
            t.requires_grad_(True)


class PPOLearner(_Learner):
    """PPO's clipped-surrogate update over minibatches (reference:
    torch_learner.py's update loop)."""

    def __init__(self, module: PPOModule, lr: float = 3e-4,
                 clip: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.0, num_epochs: int = 4,
                 minibatch_size: int = 128, seed: int = 0, device=None):
        self.module = module
        self.clip = clip
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.num_epochs = num_epochs
        self.minibatch_size = minibatch_size
        super().__init__(module.init(torch.Generator().manual_seed(seed)),
                         lr, device)
        self._rng = np.random.default_rng(seed)

    def _loss(self, params, b):
        clip, module = self.clip, self.module
        logits = module.logits(params, b["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, b["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - b["logprobs"])
        adv = b["advantages"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
        vf = torch.mean((module.value(params, b["obs"]) - b["returns"]) ** 2)
        entropy = _entropy(logp_all)
        total = pg + self.vf_coeff * vf - self.entropy_coeff * entropy
        return total, {"policy_loss": pg, "vf_loss": vf, "entropy": entropy}

    def update(self, mb: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One Adam step on minibatch ``mb``; its metrics as tensors."""
        loss, metrics, grads = self._value_and_grad(self._loss,
                                                    self._tensors(mb))
        self.apply_gradients(grads)
        return {**metrics, "total_loss": loss}

    def update_from_batch(self, batch: SampleBatch) -> Dict[str, float]:
        n = len(batch.obs)
        metrics = {}
        for _ in range(self.num_epochs):
            perm = self._rng.permutation(n)
            for start in range(0, n, self.minibatch_size):
                idx = perm[start:start + self.minibatch_size]
                metrics = self.update({
                    "obs": batch.obs[idx], "actions": batch.actions[idx],
                    "logprobs": batch.logprobs[idx],
                    "advantages": batch.advantages[idx],
                    "returns": batch.returns[idx]})
        return _floats(metrics)


def vtrace(target_logp, behavior_logp, rewards, dones, values,
           bootstrap_value, gamma, rho_bar=1.0, c_bar=1.0):
    """V-trace off-policy corrected value targets and policy-gradient
    advantages (reference: IMPALA, ``rllib/algorithms/impala``; Espeholt
    et al. 2018): JAX's reversed ``lax.scan`` as a reversed loop over T.

    All inputs are [T, N] tensors; ``bootstrap_value`` is [N]. Returns
    ``(vs, pg_advantages)``, both [T, N], detached (JAX stops their
    gradients)."""
    target_logp, values = target_logp.detach(), values.detach()
    bootstrap_value = bootstrap_value.detach()
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=rho_bar)
    cs = torch.clamp(rhos, max=c_bar)
    discounts = gamma * (1.0 - dones)
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [acc] * values.shape[0]
    for t in reversed(range(values.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = values + torch.stack(vs_minus_v)
    next_vs = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = clipped_rhos * (rewards + discounts * next_vs - values)
    return vs, pg_adv


class ImpalaLearner(_Learner):
    """IMPALA's actor-critic update on V-trace-corrected trajectories
    from decoupled (stale-policy) env runners (reference:
    ``rllib/algorithms/impala``). ``clip_param`` switches the policy loss
    to APPO's clipped surrogate over the V-trace advantages, the ratio
    taken against the behavior policy (``rllib/algorithms/appo``)."""

    def __init__(self, module: PPOModule, lr: float = 5e-4,
                 gamma: float = 0.99, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, rho_bar: float = 1.0,
                 c_bar: float = 1.0, seed: int = 0,
                 clip_param: Optional[float] = None, device=None):
        self.module = module
        self.gamma, self.vf_coeff = gamma, vf_coeff
        self.entropy_coeff = entropy_coeff
        self.rho_bar, self.c_bar = rho_bar, c_bar
        self.clip_param = clip_param
        super().__init__(module.init(torch.Generator().manual_seed(seed)),
                         lr, device)

    def _loss(self, params, b):
        mod, clip = self.module, self.clip_param
        T, N = b["actions"].shape
        flat_obs = b["obs"].reshape((T * N,) + tuple(b["obs"].shape[2:]))
        logits = mod.logits(params, flat_obs).reshape(T, N, -1)
        values = mod.value(params, flat_obs).reshape(T, N)
        bootstrap = mod.value(params, b["bootstrap_obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, b["actions"][..., None])[..., 0]
        vs, pg_adv = vtrace(logp, b["behavior_logp"], b["rewards"],
                            b["dones"], values, bootstrap, self.gamma,
                            self.rho_bar, self.c_bar)
        if clip is None:
            pg_loss = -torch.mean(logp * pg_adv)
        else:
            # APPO: clipped surrogate against the BEHAVIOR policy (the
            # async analog of PPO's old policy).
            ratio = torch.exp(logp - b["behavior_logp"])
            surr = torch.minimum(
                ratio * pg_adv,
                torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * pg_adv)
            pg_loss = -torch.mean(surr)
        vf_loss = 0.5 * torch.mean((vs - values) ** 2)
        entropy = _entropy(logp_all)
        total = (pg_loss + self.vf_coeff * vf_loss
                 - self.entropy_coeff * entropy)
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "mean_rho": torch.mean(torch.exp(
                           logp.detach() - b["behavior_logp"]))}

    def compute_gradients(self, traj: Dict[str, np.ndarray]):
        loss, metrics, grads = self._value_and_grad(self._loss,
                                                    self._tensors(traj))
        return grads, {**_floats(metrics), "total_loss": float(loss)}

    def update_from_batch(self, traj) -> Dict[str, float]:
        grads, metrics = self.compute_gradients(traj)
        self.apply_gradients(grads)
        return metrics


class DQNModule:
    """Q-network module for discrete action spaces (reference:
    ``rllib/algorithms/dqn`` default RLModule)."""

    def __init__(self, obs_dim: int, num_actions: int, hidden=(64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        return {"q": mlp_init(gen, (self.obs_dim, *self.hidden,
                                    self.num_actions), scale=0.01)}

    @staticmethod
    def q_values(params, obs):
        return mlp_apply(params["q"], obs)


class Transition(NamedTuple):
    obs: np.ndarray
    actions: np.ndarray
    rewards: np.ndarray
    next_obs: np.ndarray
    dones: np.ndarray


class ReplayBuffer:
    """Uniform ring-buffer replay (reference:
    ``rllib/utils/replay_buffers/replay_buffer.py``). ``action_dim=None``
    stores discrete int actions (DQN); an int stores float action vectors
    (SAC/continuous control)."""

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 action_dim: Optional[int] = None):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        if action_dim is None:
            self.actions = np.zeros((capacity,), np.int64)
        else:
            self.actions = np.zeros((capacity, action_dim), np.float32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self.idx = 0
        self.size = 0
        self._rng = np.random.default_rng(seed)

    def add(self, batch: Transition) -> None:
        n = len(batch.obs)
        ix = (self.idx + np.arange(n)) % self.capacity
        self.obs[ix] = batch.obs
        self.actions[ix] = batch.actions
        self.rewards[ix] = batch.rewards
        self.next_obs[ix] = batch.next_obs
        self.dones[ix] = batch.dones
        self.idx = int((self.idx + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, batch_size: int) -> Transition:
        ix = self._rng.integers(0, self.size, size=batch_size)
        return Transition(self.obs[ix], self.actions[ix], self.rewards[ix],
                          self.next_obs[ix], self.dones[ix])


class SACModule:
    """Squashed-Gaussian actor + twin Q critics for continuous action
    spaces (reference: ``rllib/algorithms/sac`` default RLModule)."""

    LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0

    def __init__(self, obs_dim: int, action_dim: int, hidden=(128, 128)):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        return {
            "pi": mlp_init(gen, (self.obs_dim, *self.hidden,
                                 2 * self.action_dim), scale=0.01),
            "q1": mlp_init(gen, (self.obs_dim + self.action_dim,
                                 *self.hidden, 1), scale=1.0),
            "q2": mlp_init(gen, (self.obs_dim + self.action_dim,
                                 *self.hidden, 1), scale=1.0),
        }

    def pi_dist(self, params, obs):
        out = mlp_apply(params["pi"], obs)
        mean, log_std = out.chunk(2, dim=-1)
        log_std = torch.clamp(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)
        return mean, log_std

    def sample_action(self, params, obs, gen: Optional[torch.Generator] = None,
                      eps=None):
        """Reparameterized tanh-squashed sample: (action in (-1,1), logp).
        The standard-normal noise is ``eps`` when given, else drawn from
        ``gen`` (a generator on ``obs``'s device)."""
        mean, log_std = self.pi_dist(params, obs)
        std = torch.exp(log_std)
        if eps is None:
            eps = torch.randn(mean.shape, generator=gen, device=mean.device)
        pre = mean + std * eps
        action = torch.tanh(pre)
        # logp with tanh change-of-variables (SAC appendix C).
        logp = torch.sum(
            -0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
            - torch.log(1 - action ** 2 + 1e-6), dim=-1)
        return action, logp

    @staticmethod
    def q_value(params, name, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return mlp_apply(params[name], x)[..., 0]


class SACLearner(_Learner):
    """Soft actor-critic update (reference: ``rllib/algorithms/sac``
    losses): twin-critic TD with Polyak-averaged targets, the
    reparameterized actor loss, and the temperature tuned toward -|A|
    entropy. Grads over {pi, q1, q2, log_alpha} are applied in one
    optimizer, so the LearnerGroup's flattened allreduce works unchanged.
    The noise comes from a generator on the learner's device seeded
    ``seed + 1`` (:meth:`_noise`)."""

    def __init__(self, module: SACModule, lr: float = 3e-4,
                 gamma: float = 0.99, tau: float = 0.005, seed: int = 0,
                 device=None):
        self.module = module
        self.gamma = gamma
        self.tau = tau
        net = module.init(torch.Generator().manual_seed(seed))
        super().__init__({**net, "log_alpha": torch.zeros(())}, lr, device)
        self.target_params = {k: [{n: t.detach().clone() for n, t in
                                   layer.items()} for layer in self.params[k]]
                              for k in ("q1", "q2")}
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.target_entropy = -float(module.action_dim)

    def _noise(self, n: int):
        """(the next-state sample's noise, the actor sample's noise), each
        [n, action_dim]."""
        shape = (n, self.module.action_dim)
        return tuple(torch.randn(shape, generator=self._gen,
                                 device=self.device) for _ in range(2))

    def _loss(self, params, b, noise):
        mod, g = self.module, self.gamma
        eps_next, eps_pi = noise
        alpha = torch.exp(params["log_alpha"])
        with torch.no_grad():
            # Critic target: r + γ(1-d)(min target-Q(s',ã') - α logπ(ã'|s'))
            next_a, next_logp = mod.sample_action(params, b["next_obs"],
                                                  eps=eps_next)
            next_q = torch.minimum(
                mod.q_value(self.target_params, "q1", b["next_obs"], next_a),
                mod.q_value(self.target_params, "q2", b["next_obs"], next_a))
            y = b["rewards"] + g * (1.0 - b["dones"]) * (
                next_q - alpha * next_logp)
        q1 = mod.q_value(params, "q1", b["obs"], b["actions"])
        q2 = mod.q_value(params, "q2", b["obs"], b["actions"])
        critic_loss = torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)
        # Actor: α logπ(ã|s) - min Q(s,ã) with the critics frozen.
        a_new, logp = mod.sample_action(params, b["obs"], eps=eps_pi)
        frozen = {k: [{n: t.detach() for n, t in layer.items()}
                      for layer in params[k]] for k in ("q1", "q2")}
        q_pi = torch.minimum(mod.q_value(frozen, "q1", b["obs"], a_new),
                             mod.q_value(frozen, "q2", b["obs"], a_new))
        actor_loss = torch.mean(alpha.detach() * logp - q_pi)
        # Temperature: drive entropy toward -|A|.
        alpha_loss = -torch.mean(
            params["log_alpha"] * (logp.detach() + self.target_entropy))
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha": alpha, "entropy": -torch.mean(logp)}

    def compute_gradients(self, t: Transition):
        loss, metrics, grads = self._value_and_grad(
            self._loss, self._tensors(t._asdict()), self._noise(len(t.obs)))
        return grads, {**_floats(metrics), "total_loss": float(loss)}

    @torch.no_grad()
    def apply_gradients(self, grads) -> None:
        super().apply_gradients(grads)
        tau = self.tau
        for k in ("q1", "q2"):
            for (_, tgt), (_, p) in zip(_flat(self.target_params[k]),
                                        _flat(self.params[k])):
                tgt.copy_((1 - tau) * tgt + tau * p)

    def update_from_batch(self, t: Transition) -> Dict[str, float]:
        grads, metrics = self.compute_gradients(t)
        self.apply_gradients(grads)
        return metrics


def _huber(x, delta: float = 1.0):
    """``optax.huber_loss``."""
    abs_x = torch.abs(x)
    quadratic = torch.clamp(abs_x, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_x - quadratic)


class DQNLearner(_Learner):
    """Double-DQN learner (reference:
    ``rllib/algorithms/dqn/torch/dqn_torch_learner.py`` loss): Huber TD
    loss, the target copied from the params every ``target_update_freq``
    applies."""

    def __init__(self, module: DQNModule, lr: float = 5e-4,
                 gamma: float = 0.99, target_update_freq: int = 200,
                 seed: int = 0, device=None):
        self.module = module
        self.gamma = gamma
        self.target_update_freq = target_update_freq
        super().__init__(module.init(torch.Generator().manual_seed(seed)),
                         lr, device)
        self._copy_target()
        self.steps = 0

    def _copy_target(self):
        self.target_params = _nest([(p, t.detach().clone())
                                    for p, t in _flat(self.params)])

    def _loss(self, params, b):
        q_values = self.module.q_values
        q = q_values(params, b["obs"])
        q_taken = q.gather(1, b["actions"][:, None])[:, 0]
        with torch.no_grad():
            # Double DQN: the online net picks the action, the target
            # net scores it.
            next_a = torch.argmax(q_values(params, b["next_obs"]), dim=-1)
            next_q = q_values(self.target_params, b["next_obs"]).gather(
                1, next_a[:, None])[:, 0]
            y = b["rewards"] + self.gamma * (1.0 - b["dones"]) * next_q
        td = q_taken - y
        return torch.mean(_huber(td)), {
            "td_error_mean": torch.mean(torch.abs(td.detach()))}

    def compute_gradients(self, t: Transition):
        loss, metrics, grads = self._value_and_grad(
            self._loss, self._tensors(t._asdict()))
        return grads, {**_floats(metrics), "loss": float(loss)}

    def apply_gradients(self, grads) -> None:
        super().apply_gradients(grads)
        self.steps += 1
        if self.steps % self.target_update_freq == 0:
            self._copy_target()

    def update_from_batch(self, t: Transition) -> Dict[str, float]:
        grads, metrics = self.compute_gradients(t)
        self.apply_gradients(grads)
        return metrics
