"""The port's RL core (``ray_tpu_torch/rllib/core.py``) against the JAX
package's (``ray_tpu/rllib/core.py``) on the CPU: the modules' forwards
on the same converted params, ``compute_gae`` and ``ReplayBuffer`` bit
for bit, ``vtrace``, and each learner's step from JAX's initial params
on the same batch (random inits differ: threefry against a torch
generator, so JAX's params are copied in).

Tolerances: fp32 forwards, losses and grads rtol 1e-5 / atol 1e-6;
numpy-identical code bit for bit. An Adam step is held on the SAME grads
(JAX's, fed to the port) at rtol 1e-5 / atol 1e-6: Adam's first step is
lr g / (|g| + 1e-8), so two grads that agree at rtol 1e-5 step visibly
apart where |g| is near 1e-8. PPO's whole epoch of Adam steps, each on
its own grads, is held at atol = lr (one step's largest move; measured
worst 3.0e-8 at lr 3e-4) with the minibatch order the same bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import core as jc
from ray_tpu_torch.interop import params_from_numpy, params_to_numpy
from ray_tpu_torch.rl.weight_sync import _flat, _nest
from ray_tpu_torch.rllib import core as tc

RTOL, ATOL = 1e-5, 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    """Two trees (torch or numpy leaves) leaf by leaf, in
    ``jax.tree.leaves`` order."""
    g = [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
         for _, x in _flat(got)]
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ the tree
def test_flat_orders_an_rllib_tree_as_jax_tree_leaves():
    """A SAC tree (dicts of lists of layers and a 0-d leaf) flattens in
    ``jax.tree.leaves`` order with JAX's key paths, and nests back."""
    params = _np({**jc.SACModule(3, 2, hidden=(5,)).init(
        jax.random.PRNGKey(0)), "log_alpha": jnp.zeros(())})
    pairs = _flat(params)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in pairs] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in want]
    for (_, a), (_, b) in zip(pairs, want):
        assert a is b
    back = _nest(pairs)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    # A dict-only tree keeps its sorted-key order.
    flat = {"b": {"y": 1, "x": 2}, "a": 3}
    assert [p for p, _ in _flat(flat)] == [("a",), ("b", "x"), ("b", "y")]


def test_interop_carries_lists_and_a_0d_leaf():
    tree = _np({**jc.SACModule(3, 1, hidden=(4,)).init(
        jax.random.PRNGKey(1)), "log_alpha": jnp.full((), 0.5)})
    t = params_from_numpy(tree, "cpu")
    assert isinstance(t["q1"], list) and t["log_alpha"].shape == ()
    back = params_to_numpy(t)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --------------------------------------------------------- the modules
def test_mlp_and_module_forwards_match_jax():
    rng = _rng(1)
    obs = rng.normal(size=(7, 4)).astype(np.float32)
    jp = _np(jc.PPOModule(4, 3, hidden=(16, 8)).init(jax.random.PRNGKey(2)))
    tp = params_from_numpy(jp, "cpu")
    m = tc.PPOModule(4, 3, hidden=(16, 8))
    np.testing.assert_allclose(
        tc.mlp_apply(tp["pi"], _t(obs)).numpy(),
        np.asarray(jc.mlp_apply(jp["pi"], obs)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.logits(tp, _t(obs)).numpy(),
                               np.asarray(jc.PPOModule.logits(jp, obs)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(m.value(tp, _t(obs)).numpy(),
                               np.asarray(jc.PPOModule.value(jp, obs)),
                               rtol=RTOL, atol=ATOL)
    jq = _np(jc.DQNModule(4, 2).init(jax.random.PRNGKey(3)))
    np.testing.assert_allclose(
        tc.DQNModule.q_values(params_from_numpy(jq, "cpu"), _t(obs)).numpy(),
        np.asarray(jc.DQNModule.q_values(jq, obs)), rtol=RTOL, atol=ATOL)


def test_init_layout_scales_and_seeds():
    """JAX's layout and scales: w [din, dout], the last layer's std
    ``scale``, the others' sqrt(2/din), zero biases; one seed, one
    draw."""
    p = tc.PPOModule(4, 2, hidden=(512,)).init(
        torch.Generator().manual_seed(0))
    assert [tuple(l["w"].shape) for l in p["pi"]] == [(4, 512), (512, 2)]
    assert all(not l["b"].any() for l in p["pi"] + p["vf"])
    assert abs(float(p["pi"][0]["w"].std()) - np.sqrt(2 / 4)) < 0.05
    assert abs(float(p["pi"][1]["w"].std()) - 0.01) < 0.002
    assert abs(float(p["vf"][1]["w"].std()) - 1.0) < 0.2
    q = tc.PPOModule(4, 2, hidden=(512,)).init(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_flat(p), _flat(q)))


def test_sac_pi_dist_and_logp_match_jax_on_the_same_noise():
    rng = _rng(4)
    obs = rng.normal(size=(9, 3)).astype(np.float32)
    jm, tm = jc.SACModule(3, 2, hidden=(8,)), tc.SACModule(3, 2, hidden=(8,))
    jp = _np(jm.init(jax.random.PRNGKey(5)))
    # Push some log_stds past the clip on both ends.
    wide = _np(jax.tree.map(lambda x: x, jp))
    wide["pi"][-1]["w"] = wide["pi"][-1]["w"] * 400.0
    for got, want in zip(tm.pi_dist(params_from_numpy(wide, "cpu"), _t(obs)),
                         jm.pi_dist(wide, obs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    log_std = tm.pi_dist(params_from_numpy(wide, "cpu"), _t(obs))[1]
    assert float(log_std.max()) == 2.0 and float(log_std.min()) == -10.0
    tp = params_from_numpy(jp, "cpu")
    key = jax.random.PRNGKey(6)
    eps = np.asarray(jax.random.normal(key, (9, 2)))
    ja, jl = jm.sample_action(jp, obs, key)
    ta, tl = tm.sample_action(tp, _t(obs), eps=_t(eps))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    q = tm.q_value(tp, "q1", _t(obs), ta)
    np.testing.assert_allclose(
        q.numpy(), np.asarray(jm.q_value(jp, "q1", obs, ja)), rtol=RTOL,
        atol=ATOL)


def test_sac_sampled_actions_stay_in_bounds_with_finite_logp():
    m = tc.SACModule(obs_dim=3, action_dim=2)
    params = m.init(torch.Generator().manual_seed(0))
    obs = _t(_rng(0).normal(size=(4096, 3)).astype(np.float32))
    a, logp = m.sample_action(params, obs, torch.Generator().manual_seed(1))
    assert a.shape == (4096, 2) and bool((a.abs() < 1.0).all())
    assert bool(torch.isfinite(logp).all())
    # The pre-squash sample is N(mean, std): its standardized noise has
    # mean 0 and std 1.
    mean, log_std = m.pi_dist(params, obs)
    z = (torch.atanh(a.clamp(-1 + 1e-6, 1 - 1e-6)) - mean) / log_std.exp()
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1) < 0.05


# -------------------------------------------------- numpy, bit for bit
def test_compute_gae_is_jax_bit_for_bit():
    rng = _rng(7)
    T, N = 33, 5
    args = (rng.normal(size=(T, N)).astype(np.float32),
            rng.normal(size=(T, N)).astype(np.float32),
            (rng.random((T, N)) < 0.2).astype(np.float32),
            rng.normal(size=N).astype(np.float32), 0.99, 0.95)
    for got, want in zip(tc.compute_gae(*args), jc.compute_gae(*args)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    ones = (np.ones((4, 2), np.float32), np.zeros((4, 2), np.float32),
            np.zeros((4, 2), np.float32), np.zeros(2, np.float32), 1.0, 1.0)
    adv, ret = tc.compute_gae(*ones)
    np.testing.assert_allclose(adv[:, 0], [4, 3, 2, 1])
    np.testing.assert_allclose(ret, adv)


@pytest.mark.parametrize("action_dim", [None, 2])
def test_replay_buffer_samples_are_jax_bit_for_bit(action_dim):
    rng = _rng(8)
    bufs = [m.ReplayBuffer(50, 3, seed=9, action_dim=action_dim)
            for m in (tc, jc)]
    for i in range(4):
        n = 17
        acts = (rng.integers(0, 4, n) if action_dim is None else
                rng.uniform(-1, 1, (n, action_dim)).astype(np.float32))
        t = tc.Transition(rng.normal(size=(n, 3)).astype(np.float32), acts,
                          rng.normal(size=n).astype(np.float32),
                          rng.normal(size=(n, 3)).astype(np.float32),
                          (rng.random(n) < 0.1).astype(np.float32))
        for b in bufs:
            b.add(t)
        got, want = (b.sample(32) for b in bufs)
        assert bufs[0].size == bufs[1].size and bufs[0].idx == bufs[1].idx
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# --------------------------------------------------------------- vtrace
@pytest.mark.parametrize("T,N", [(1, 1), (5, 3), (32, 4), (64, 8)])
@pytest.mark.parametrize("offpolicy", [False, True])
def test_vtrace_matches_jax(T, N, offpolicy):
    rng = _rng(T * 100 + N)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    target, rewards, values = f(T, N), f(T, N), f(T, N)
    behavior = target - 3.0 * np.abs(f(T, N)) if offpolicy else target
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    bootstrap = f(N)
    for rho_bar, c_bar in ((1.0, 1.0), (2.0, 0.5)):
        got = tc.vtrace(_t(target).requires_grad_(), _t(behavior),
                        _t(rewards), _t(dones), _t(values).requires_grad_(),
                        _t(bootstrap), 0.97, rho_bar, c_bar)
        want = jc.vtrace(*map(jnp.asarray, (target, behavior, rewards,
                                            dones, values, bootstrap)),
                         0.97, rho_bar, c_bar)
        for g, w in zip(got, want):
            assert not g.requires_grad
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=RTOL, atol=ATOL)


def test_vtrace_clipped_rhos_equal_on_policy_targets():
    T, N = 4, 2
    z = torch.zeros((T, N))
    vs_clip, _ = tc.vtrace(z, z - 3.0, torch.ones((T, N)), z, z,
                           torch.zeros(N), 1.0)
    vs_on, _ = tc.vtrace(z, z, torch.ones((T, N)), z, z, torch.zeros(N), 1.0)
    torch.testing.assert_close(vs_clip, vs_on, rtol=1e-5, atol=0)


# ------------------------------------------------------------- learners
def _jax_grads_by_sgd(learner, batch):
    """JAX's ``PPOLearner`` grads on one minibatch: its own update with
    ``optax.sgd(1.0)`` in place of Adam, read off as p - p'."""
    before = learner.params
    learner.optimizer = optax.sgd(1.0)
    update = jax.jit(learner._make_update())
    after, _, metrics = update(before, learner.optimizer.init(before),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(lambda a, b: a - b, before, after), metrics


def _ppo_batch(n, seed):
    rng = _rng(seed)
    return tc.SampleBatch(
        obs=rng.normal(size=(n, 4)).astype(np.float32),
        actions=rng.integers(0, 2, n),
        logprobs=np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
        values=rng.normal(size=n).astype(np.float32),
        advantages=rng.normal(size=n).astype(np.float32),
        returns=rng.normal(size=n).astype(np.float32))


def test_ppo_minibatch_loss_and_grads_match_jax():
    module = jc.PPOModule(4, 2)
    jl = jc.PPOLearner(module, lr=3e-4, entropy_coeff=0.01, seed=0)
    tl = tc.PPOLearner(tc.PPOModule(4, 2), lr=3e-4, entropy_coeff=0.01,
                       device="cpu")
    tl.set_weights(_np(jl.params))
    b = _ppo_batch(128, 10)._asdict()
    del b["values"]
    loss, metrics, grads = tl._value_and_grad(tl._loss, tl._tensors(b))
    jgrads, jm = _jax_grads_by_sgd(jl, b)
    np.testing.assert_allclose(float(loss), float(jm["total_loss"]),
                               rtol=RTOL, atol=ATOL)
    for k in ("policy_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=RTOL, atol=ATOL)
    _close(grads, jgrads, atol=1e-6)


def test_ppo_update_from_batch_matches_jax_over_an_epoch():
    """A whole epoch of minibatches in ``default_rng(seed).permutation``
    order: the port's update_from_batch against JAX's from the same
    params, Adam on each side's own grads."""
    lr = 3e-4
    jl = jc.PPOLearner(jc.PPOModule(4, 2), lr=lr, num_epochs=2,
                       minibatch_size=64, seed=3)
    tl = tc.PPOLearner(tc.PPOModule(4, 2), lr=lr, num_epochs=2,
                       minibatch_size=64, seed=3, device="cpu")
    tl.set_weights(_np(jl.params))
    batch = _ppo_batch(256, 11)
    got, want = tl.update_from_batch(batch), jl.update_from_batch(batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)
    _close(tl.get_weights(), jl.get_weights(), rtol=0, atol=lr)
    assert tl.opt_state.count == 8
    assert np.array_equal(tl._rng.permutation(5), jl._rng.permutation(5))


def _traj(T, N, seed):
    rng = _rng(seed)
    return dict(obs=rng.normal(size=(T, N, 4)).astype(np.float32),
                actions=rng.integers(0, 2, size=(T, N)),
                behavior_logp=np.log(rng.uniform(0.2, 0.8, (T, N))).astype(
                    np.float32),
                rewards=np.ones((T, N), np.float32),
                dones=(rng.random((T, N)) < 0.1).astype(np.float32),
                bootstrap_obs=rng.normal(size=(N, 4)).astype(np.float32))


def _adam_on_jax_grads(tl, jl, jgrads):
    """Both learners step on JAX's grads; the params must agree."""
    jl.apply_gradients(jgrads)
    tl.apply_gradients(params_from_numpy(_np(jgrads), "cpu"))
    _close(tl.params, jl.params)


@pytest.mark.parametrize("clip_param", [None, 0.3])
def test_impala_and_appo_learner_match_jax(clip_param):
    kw = dict(lr=5e-3, entropy_coeff=0.01, clip_param=clip_param)
    jl = jc.ImpalaLearner(jc.PPOModule(4, 2, hidden=(32, 32)), **kw)
    tl = tc.ImpalaLearner(tc.PPOModule(4, 2, hidden=(32, 32)),
                          device="cpu", **kw)
    tl.set_weights(_np(jl.params))
    for seed in (12, 13):
        traj = _traj(16, 3, seed)
        grads, metrics = tl.compute_gradients(traj)
        jgrads, jm = jl.compute_gradients(traj)
        assert set(metrics) == set(jm)
        for k in jm:
            np.testing.assert_allclose(metrics[k], jm[k], rtol=RTOL,
                                       atol=ATOL)
        _close(grads, jgrads)
        _adam_on_jax_grads(tl, jl, jgrads)


def _transitions(n, obs_dim, seed, action_dim=None):
    rng = _rng(seed)
    acts = (rng.integers(0, 2, n) if action_dim is None else
            rng.uniform(-1, 1, (n, action_dim)).astype(np.float32))
    return tc.Transition(rng.normal(size=(n, obs_dim)).astype(np.float32),
                         acts, rng.normal(size=n).astype(np.float32),
                         rng.normal(size=(n, obs_dim)).astype(np.float32),
                         (rng.random(n) < 0.1).astype(np.float32))


def test_dqn_learner_matches_jax_through_a_target_copy():
    kw = dict(lr=1e-3, target_update_freq=2)
    jl = jc.DQNLearner(jc.DQNModule(4, 2, hidden=(16,)), **kw)
    tl = tc.DQNLearner(tc.DQNModule(4, 2, hidden=(16,)), device="cpu", **kw)
    tl.set_weights(_np(jl.params))
    tl.target_params = params_from_numpy(_np(jl.target_params), "cpu")
    for step, seed in enumerate((14, 15, 16), start=1):
        t = _transitions(64, 4, seed)
        grads, metrics = tl.compute_gradients(t)
        jgrads, jm = jl.compute_gradients(t)
        assert set(metrics) == set(jm)
        for k in jm:
            np.testing.assert_allclose(metrics[k], jm[k], rtol=RTOL,
                                       atol=ATOL)
        _close(grads, jgrads)
        _adam_on_jax_grads(tl, jl, jgrads)
        assert tl.steps == jl.steps == step
        _close(tl.target_params, jl.target_params)
    # The copy at step 2 took the params of then; step 3 moved on.
    assert not np.allclose(np.asarray(tl.target_params["q"][0]["w"]),
                           tl.params["q"][0]["w"].detach().numpy())


def _jax_sac_noise(learner, n):
    """The draws JAX's next ``compute_gradients`` makes: its key split
    into (ka, kn); the next action's noise from kn, the actor's from ka."""
    _, sub = jax.random.split(learner._key)
    ka, kn = jax.random.split(sub)
    shape = (n, learner.module.action_dim)
    return (_t(np.asarray(jax.random.normal(kn, shape))),
            _t(np.asarray(jax.random.normal(ka, shape))))


def test_sac_learner_matches_jax_on_jax_noise():
    kw = dict(lr=1e-3, tau=0.5)
    jl = jc.SACLearner(jc.SACModule(3, 1, hidden=(16, 16)), **kw)
    tl = tc.SACLearner(tc.SACModule(3, 1, hidden=(16, 16)), device="cpu",
                       **kw)
    tl.set_weights(_np(jl.params))
    tl.target_params = params_from_numpy(_np(jl.target_params), "cpu")
    for seed in (17, 18):
        t = _transitions(64, 3, seed, action_dim=1)
        noise = _jax_sac_noise(jl, 64)
        tl._noise = lambda n, noise=noise: noise
        grads, metrics = tl.compute_gradients(t)
        jgrads, jm = jl.compute_gradients(t)
        assert set(metrics) == set(jm)
        for k in jm:
            np.testing.assert_allclose(metrics[k], jm[k], rtol=RTOL,
                                       atol=1e-5)
        _close(grads, jgrads, atol=1e-5)
        _adam_on_jax_grads(tl, jl, jgrads)
        _close(tl.target_params, jl.target_params)
    assert metrics["alpha"] > 0
    assert tl.get_weights()["log_alpha"].shape == ()


def test_sac_noise_comes_from_the_seeded_generator():
    a = tc.SACLearner(tc.SACModule(3, 1), seed=4, device="cpu")
    b = tc.SACLearner(tc.SACModule(3, 1), seed=4, device="cpu")
    c = tc.SACLearner(tc.SACModule(3, 1), seed=5, device="cpu")
    na, nb, nc = a._noise(8), b._noise(8), c._noise(8)
    assert all(torch.equal(x, y) for x, y in zip(na, nb))
    assert not torch.equal(na[0], nc[0]) and not torch.equal(*na)


@pytest.mark.parametrize("cls,module", [
    (tc.PPOLearner, tc.PPOModule(4, 2)),
    (tc.ImpalaLearner, tc.PPOModule(4, 2)),
    (tc.DQNLearner, tc.DQNModule(4, 2)),
    (tc.SACLearner, tc.SACModule(3, 1))])
def test_learners_default_to_the_card_and_raise_without_one(cls, module):
    """``device`` left at its default is the card: on a host without one
    the learner raises; nothing falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(module)
    learner = cls(module, device="cpu")
    assert all(t.device.type == "cpu" and t.requires_grad
               for t in learner._leaves())


def test_get_weights_is_a_copy_and_set_weights_takes_it_back():
    tl = tc.DQNLearner(tc.DQNModule(4, 2), device="cpu")
    w = tl.get_weights()
    tl.update_from_batch(_transitions(32, 4, 19))
    moved = tl.get_weights()
    assert not np.array_equal(w["q"][0]["w"], moved["q"][0]["w"])
    tl.set_weights(w)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in
               zip(_flat(tl.get_weights()), _flat(w)))
