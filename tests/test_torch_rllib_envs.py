"""The RL library's envs and runners on the CPU: the port's
``SyncVectorEnv`` and ``chip_smoke.py``'s numpy CartPole-v1 / Pendulum-v1
step for step against gymnasium's; the runners
(``ray_tpu_torch/rllib/env_runner.py``) against the JAX package's runner
classes, built in process with no actors, from the same weights and
seeds; ``FaultTolerantActorManager`` over runtime processes (members
from ``tests/torch_rllib_helpers.py``, no JAX).

Tolerances: obs, actions, rewards and dones equal exactly; logp,
values and GAE rtol 1e-5 / atol 1e-5 (fp32 forwards through three
layers of 16-32-wide dot products of O(1) terms, summed in another order
by XLA and by torch: measured worst 1.5e-6 on a value; GAE carries the
values' last bits over up to T steps)."""

import functools

import gymnasium as gym
import jax
import numpy as np
import pytest

import chip_smoke
import torch_rllib_helpers as h
from ray_tpu.rllib import core as jc
from ray_tpu.rllib import env_runner as jr
from ray_tpu_torch.rllib import env_runner as tr
from ray_tpu_torch.rllib.actor_manager import FaultTolerantActorManager

RTOL, ATOL = 1e-5, 1e-5


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), np.abs(
        got.astype(np.float64) - want).max()


# ----------------------------------------------------------- vector env
@pytest.mark.parametrize("name,kw,n", [
    ("CartPole-v1", {}, 3),
    ("CartPole-v1", {"max_episode_steps": 20}, 2),
    ("Pendulum-v1", {}, 3)])
def test_sync_vector_env_steps_as_gymnasium(name, kw, n):
    """The same seeds and actions give equal arrays over 600 steps, across
    next-step autoresets (terminations) and truncations."""
    make = functools.partial(gym.make, name, **kw)
    ours = tr.SyncVectorEnv([make] * n)
    theirs = gym.vector.SyncVectorEnv([make] * n)
    assert ours.single_observation_space == theirs.single_observation_space
    assert ours.single_action_space == theirs.single_action_space
    for got, want in zip(ours.reset(seed=5)[0], theirs.reset(seed=5)[0]):
        _same(got, want)
    rng = np.random.default_rng(0)
    box = name.startswith("Pendulum")
    ends = np.zeros(2, int)
    for _ in range(600):
        a = (rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32) if box
             else rng.integers(0, 2, n))
        got, want = ours.step(a), theirs.step(a)
        for g, w in zip(got[:4], want[:4]):
            _same(g, w)
        ends += [got[2].sum(), got[3].sum()]
    # Random play ends CartPole-v1 by termination, the 20-step one and
    # Pendulum by truncation.
    assert ends[1] > 0 if (box or kw) else ends[0] > 0
    ours.close()
    theirs.close()


# ---------------------------------------- chip_smoke's numpy envs
def _balance(obs):
    return int(obs[2] + 0.5 * obs[3] > 0)


@pytest.mark.parametrize("which", ["random", "balanced"])
def test_chip_smoke_cartpole_steps_as_gymnasium(which):
    """``chip_smoke.CartPole`` against ``CartPole-v1``: reset obs, every
    step's obs, reward, terminated and truncated equal from the same
    seeds; the balancing policy runs into the 500-step truncation."""
    ours, theirs = chip_smoke.CartPole(), gym.make("CartPole-v1")
    assert ours.action_space.n == theirs.action_space.n
    np.testing.assert_array_equal(ours.observation_space.high,
                                  theirs.observation_space.high)
    assert ours.observation_space.dtype == theirs.observation_space.dtype
    rng = np.random.default_rng(1)
    o1, _ = ours.reset(seed=3)
    o2, _ = theirs.reset(seed=3)
    _same(o1, o2)
    truncs = 0
    for _ in range(1200):
        a = _balance(o1) if which == "balanced" else int(rng.integers(2))
        r1, r2 = ours.step(a), theirs.step(a)
        _same(r1[0], r2[0])
        assert r1[1:4] == r2[1:4] and type(r1[1]) is type(r2[1])
        o1 = r1[0]
        if r1[2] or r1[3]:
            truncs += r1[3]
            o1, _ = ours.reset()
            _same(o1, theirs.reset()[0])
    assert truncs >= (2 if which == "balanced" else 0)


def test_chip_smoke_pendulum_steps_as_gymnasium():
    ours, theirs = chip_smoke.Pendulum(), gym.make("Pendulum-v1")
    np.testing.assert_array_equal(ours.action_space.low,
                                  theirs.action_space.low)
    np.testing.assert_array_equal(ours.action_space.high,
                                  theirs.action_space.high)
    assert ours.action_space.shape == theirs.action_space.shape
    rng = np.random.default_rng(2)
    _same(ours.reset(seed=4)[0], theirs.reset(seed=4)[0])
    truncs = 0
    for _ in range(650):
        a = rng.uniform(-2.5, 2.5, (1,)).astype(np.float32)
        r1, r2 = ours.step(a), theirs.step(a)
        _same(r1[0], r2[0])
        assert r1[1] == r2[1] and type(r1[1]) is type(r2[1])
        assert r1[2:4] == r2[2:4]
        if r1[3]:
            truncs += 1
            _same(ours.reset()[0], theirs.reset()[0])
    assert truncs == 3


def test_chip_smoke_envs_run_in_the_vector_env():
    """The runners' vector env over the numpy envs equals it over
    gymnasium's (so phase 36's runners step what CPU tests step)."""
    for ours_fn, name in ((chip_smoke.CartPole, "CartPole-v1"),
                          (chip_smoke.Pendulum, "Pendulum-v1")):
        a = tr.SyncVectorEnv([ours_fn] * 2)
        b = tr.SyncVectorEnv([functools.partial(gym.make, name)] * 2)
        _same(a.reset(seed=9)[0], b.reset(seed=9)[0])
        rng = np.random.default_rng(3)
        for _ in range(300):
            act = (rng.integers(0, 2, 2) if name.startswith("Cart") else
                   rng.uniform(-2, 2, (2, 1)).astype(np.float32))
            for g, w in zip(a.step(act)[:4], b.step(act)[:4]):
                _same(g, w)


# -------------------------------------------------------------- runners
CART = functools.partial(tr.make_gym_env, "CartPole-v1")
PEND = functools.partial(tr.make_gym_env, "Pendulum-v1")


def _jax_weights(module, seed):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed)))


def test_single_agent_runner_matches_jax_runner():
    spec = {"obs_dim": 4, "num_actions": 2, "hidden": (32, 32)}
    w = _jax_weights(jc.PPOModule(**spec), 0)
    ours = tr.SingleAgentEnvRunner(CART, spec, num_envs=3, seed=7)
    theirs = jr.SingleAgentEnvRunner(lambda: gym.make("CartPole-v1"), spec,
                                     num_envs=3, seed=7)
    assert ours.set_weights(w) == theirs.set_weights(w) == 1
    assert ours.set_weights(w, 5) == theirs.set_weights(w, 5) == 5
    for _ in range(2):
        (got, gf), (want, wf) = ours.sample(48), theirs.sample(48)
        for f in ("obs", "actions"):
            _same(getattr(got, f), getattr(want, f))
        for f in ("logprobs", "values"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=RTOL, atol=ATOL)
        for f in ("advantages", "returns"):
            assert getattr(got, f).dtype == np.float32
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=RTOL, atol=ATOL)
        assert gf == wf and len(gf) > 0


def test_trajectory_runner_matches_jax_runner():
    spec = {"obs_dim": 4, "num_actions": 2, "hidden": (16,)}
    w = _jax_weights(jc.PPOModule(**spec), 1)
    ours = tr.TrajectoryEnvRunner(CART, spec, num_envs=4, seed=2)
    theirs = jr.TrajectoryEnvRunner(lambda: gym.make("CartPole-v1"), spec,
                                    num_envs=4, seed=2)
    ours.set_weights(w)
    theirs.set_weights(w)
    for _ in range(2):
        (got, gf), (want, wf) = ours.sample(40), theirs.sample(40)
        assert set(got) == set(want)
        for k in ("obs", "actions", "rewards", "dones", "bootstrap_obs"):
            _same(got[k], want[k])
        np.testing.assert_allclose(got["behavior_logp"],
                                   want["behavior_logp"], rtol=RTOL,
                                   atol=ATOL)
        assert gf == wf


def test_transition_runner_matches_jax_runner():
    """Epsilon-greedy transitions: the reset step after each done left
    out, truncations not cut (CartPole at 20 steps truncates)."""
    spec = {"obs_dim": 4, "num_actions": 2, "hidden": (16,)}
    w = _jax_weights(jc.DQNModule(**spec), 2)
    short = functools.partial(gym.make, "CartPole-v1", max_episode_steps=20)
    ours = tr.TransitionEnvRunner(short, spec, num_envs=3, seed=4)
    theirs = jr.TransitionEnvRunner(short, spec, num_envs=3, seed=4)
    for r in (ours, theirs):
        r.set_weights(w)
        r.set_epsilon(0.3)
    for _ in range(2):
        (got, gf), (want, wf) = ours.sample(50), theirs.sample(50)
        for g, x in zip(got, want):
            _same(g, x)
        assert gf == wf
    assert len(got.obs) < 150 and float(got.dones.sum()) <= len(gf)


def test_continuous_runner_acts_inside_the_box():
    spec = {"obs_dim": 3, "action_dim": 1, "hidden": (16, 16)}
    runner = tr.ContinuousEnvRunner(PEND, spec, num_envs=2, seed=0)
    runner.set_weights(jax.tree.map(np.asarray, {
        "pi": _jax_weights(jc.SACModule(**spec), 3)["pi"]}))
    seen = []
    step = runner.envs.step

    def record(actions):
        seen.append(np.array(actions))
        return step(actions)

    runner.envs.step = record
    t, finished = runner.sample(250)
    acts = np.concatenate(seen)
    assert np.all(acts >= -2.0) and np.all(acts <= 2.0)
    assert t.actions.dtype == np.float32 and t.actions.shape[1] == 1
    assert np.all(np.abs(t.actions) < 1.0)
    # Pendulum only truncates: two 200-step episodes end, none cut.
    assert len(finished) == 2 and float(t.dones.sum()) == 0.0

    class Unbounded(chip_smoke.Pendulum):
        def __init__(self):
            super().__init__()
            self.action_space = chip_smoke.Box([-np.inf], [np.inf])

    with pytest.raises(ValueError, match="bounded Box"):
        tr.ContinuousEnvRunner(Unbounded, spec, seed=0)


def test_portable_refuses_a_lambda_and_takes_a_partial():
    with pytest.raises(ValueError, match="module-level callable"):
        tr.portable(lambda: None, "env_creator")
    assert tr.portable(CART, "env_creator") is CART
    assert tr.portable(h.policy_for, "policy_mapping_fn") is h.policy_for


# ---------------------------------------------------------- the manager
@pytest.fixture
def fleet():
    mgr = FaultTolerantActorManager(
        lambda i: tr.start_runner(h.Member, i), 2)
    tr.wait_started(mgr.actors)
    yield mgr
    mgr.kill_all()


def test_manager_replaces_a_dead_member_and_reruns_its_call(fleet):
    first = fleet.foreach("value", 1)
    assert [(s, r[:2]) for s, r in first] == [(0, (0, 1)), (1, (1, 1))]
    dead = fleet.actors[0].pid
    fleet.actors[0].kill()
    again = fleet.foreach("value", 2)
    assert [s for s, _ in again] == [0, 1]
    assert again[0][1][:2] == (3, 2) and again[0][1][2] != dead
    assert fleet.num_replacements == 1
    assert not fleet.actors[0].dead


def test_manager_drops_a_slot_whose_replacement_fails(fleet):
    got = fleet.foreach("no_such_method")
    assert got == [] and fleet.num_replacements == 4


def test_healthy_count_counts_a_busy_member_and_replaces_a_dead_one(fleet):
    busy = fleet.actors[0].call("sleep", (3.0,), {})
    fleet.actors[1].kill()
    assert fleet.healthy_count(timeout_s=0.5) == 1
    assert fleet.num_replacements == 1
    assert busy.result(timeout=30) is True
    assert fleet.healthy_count(timeout_s=10) == 2


def test_runner_calls_run_with_one_torch_thread(fleet):
    """A runner process's calls run on its call thread with the one
    OpenMP thread the process was started with. OpenMP keeps the count
    per thread: without it the call thread's first elementwise op (a
    ``tanh``) ran on a team of the host's count, and two runners'
    spinning teams took a 64-step sample from ~20 ms to ~1.2 s."""
    counts = [n for _, n in fleet.foreach("threads")]
    assert len(counts) == 2 and all(n and set(n) == {1} for n in counts)
