"""Port parity: PBT (``ray_tpu_torch.tune``) and PBT over the port's DQN
learners on the CPU, against ``tests/test_pbt_dqn.py``.

PBT's forks depend on the order reports reach the controller, so every
call the port's controller made to its scheduler is recorded and
replayed into JAX's ``PopulationBasedTraining`` with the same seed: on
the same reported metrics it must make the same exploit decisions (the
same verdicts, donors and explored configs). The DQN half of
``tests/test_pbt_dqn.py`` (two learners kept bit-identical, CartPole to
60) is ``tests/test_torch_rllib_dqn.py``; here PBT tunes the
learning rate of in-process ``DQNLearner``s whose trials fork from each
other's weights.
"""

import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.rllib import DQNLearner, DQNModule, Transition


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    rt.init(num_cpus=8, num_gpus=0)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


class Recording:
    """A scheduler that logs each decision call of the controller (and
    its answer) before passing it on."""

    def __init__(self, inner):
        self.inner = inner
        self.log = []

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name not in ("on_trial_config", "on_result", "exploit",
                        "commit_exploit"):
            return attr

        def call(*args):
            out = attr(*args)
            self.log.append((name, args, out))
            return out

        return call


def same_decisions(log, jax_scheduler):
    for name, args, out in log:
        got = getattr(jax_scheduler, name)(*args)
        assert got == out, (name, args, got, out)
    exploits = [a[0] for n, a, _ in log if n == "commit_exploit"]
    assert jax_scheduler.exploit_count == len(exploits)
    return exploits


def test_pbt_exploits_and_converges_to_good_hyperparam():
    """Low-lr trials clone a high-lr trial's checkpoint and perturbed
    config; the whole population ends near the good hyperparameter."""

    def trainable(config):
        ckpt = ttune.get_checkpoint() or {"score": 0.0, "step": 0}
        score, step = ckpt["score"], ckpt["step"]
        for _ in range(8 - step):
            step += 1
            score += config["lr"]  # higher lr -> strictly faster progress
            ttune.report({"score": score, "lr": config["lr"]},
                         checkpoint={"score": score, "step": step})
            time.sleep(0.15)  # keep trials in flight so polls interleave

    settings = dict(metric="score", mode="max", perturbation_interval=2,
                    hyperparam_mutations={"lr": [0.01, 0.1, 1.0]}, seed=0)
    pbt = Recording(ttune.PopulationBasedTraining(**settings))
    grid = ttune.Tuner(
        trainable,
        param_space={"lr": ttune.grid_search([0.01, 0.02, 1.0, 1.0])},
        tune_config=ttune.TuneConfig(metric="score", mode="max",
                                     scheduler=pbt),
    ).fit()
    assert len(grid) == 4 and not grid.errors
    assert pbt.exploit_count >= 1, "PBT never exploited"
    best = grid.get_best_result()
    assert best.metrics["score"] >= 8 * 1.0 * 0.8  # a high-lr lineage won
    final_lrs = [r.metrics["lr"] for r in grid if r.metrics]
    assert max(final_lrs) >= 0.8
    same_decisions(pbt.log, jtune.PopulationBasedTraining(**settings))


def test_pbt_forked_trial_resumes_from_donor_checkpoint():
    """The forked trial continues from the donor's step/score, not from
    zero (checkpoint forking, not a restart)."""

    def trainable(config):
        ckpt = ttune.get_checkpoint()
        if ckpt is not None:
            ttune.report({"score": 1000 + ckpt["score"],
                          "forked_from_step": ckpt["step"]},
                         checkpoint=ckpt)
            return
        score, step = 0.0, 0
        for _ in range(8):
            step += 1
            score += config["lr"]
            ttune.report({"score": score, "forked_from_step": -1},
                         checkpoint={"score": score, "step": step})
            time.sleep(0.15)

    settings = dict(metric="score", mode="max", perturbation_interval=2,
                    hyperparam_mutations={"lr": [1.0]}, seed=1)
    pbt = Recording(ttune.PopulationBasedTraining(**settings))
    grid = ttune.Tuner(
        trainable,
        param_space={"lr": ttune.grid_search([0.001, 1.0])},
        tune_config=ttune.TuneConfig(metric="score", mode="max",
                                     scheduler=pbt),
    ).fit()
    assert not grid.errors
    forked = [r for r in grid if r.metrics
              and r.metrics.get("forked_from_step", -1) > 0]
    assert forked, "no trial resumed from a donor checkpoint"
    assert all(r.metrics["score"] >= 1000 for r in forked)
    same_decisions(pbt.log, jtune.PopulationBasedTraining(**settings))


def _transitions(n, seed):
    rng = np.random.default_rng(seed)
    return Transition(
        obs=rng.normal(size=(n, 4)).astype(np.float32),
        actions=rng.integers(0, 2, size=n),
        rewards=rng.normal(size=n).astype(np.float32),
        next_obs=rng.normal(size=(n, 4)).astype(np.float32),
        dones=(rng.random(n) < 0.1).astype(np.float32))


def dqn_trainable(config):
    """A DQN learner on fixed synthetic transitions, its score the
    negated TD loss; the checkpoint is its weights and step, which a
    forked trial loads before going on under its new learning rate."""
    learner = DQNLearner(DQNModule(4, 2, hidden=(16,)), lr=config["lr"],
                         seed=3, device="cpu")
    ckpt = ttune.get_checkpoint()
    step = 0
    if ckpt is not None:
        learner.set_weights(ckpt["weights"])
        step = ckpt["step"]
    batch = _transitions(64, 0)
    while step < 8:
        step += 1
        loss = learner.update_from_batch(batch)["loss"]
        ttune.report({"score": -loss, "lr": config["lr"], "step": step},
                     checkpoint={"weights": learner.get_weights(),
                                 "step": step})
        time.sleep(0.1)


def test_pbt_tunes_dqn_learners():
    settings = dict(metric="score", mode="max", perturbation_interval=2,
                    hyperparam_mutations={"lr": [1e-4, 3e-3, 1e-2]},
                    seed=2)
    pbt = Recording(ttune.PopulationBasedTraining(**settings))
    grid = ttune.Tuner(
        dqn_trainable,
        param_space={"lr": ttune.grid_search([1e-5, 1e-4, 1e-2, 1e-2])},
        tune_config=ttune.TuneConfig(metric="score", mode="max",
                                     scheduler=pbt),
    ).fit()
    assert len(grid) == 4 and not grid.errors
    assert all(np.isfinite(r.metrics["score"]) for r in grid)
    assert all(r.metrics["step"] == 8 for r in grid)
    exploited = same_decisions(pbt.log,
                               jtune.PopulationBasedTraining(**settings))
    assert exploited, "PBT never forked a DQN trial"
    # A forked trial ends on the config of its last fork, and every
    # trial runs to step 8 (a fork goes on from its donor's step).
    # Every report after the last fork ran under that fork's config; a
    # fork from a donor checkpoint already at step 8 makes none.
    last = {a[0]: a[1] for n, a, _ in pbt.log if n == "commit_exploit"}
    for r in grid:
        assert r.metrics_history[-1]["step"] == 8
        if r.trial_id in last:
            assert r.config == last[r.trial_id]
            fork = max(i for i, (n, a, _) in enumerate(pbt.log)
                       if n == "commit_exploit" and a[0] == r.trial_id)
            reported = [a[1] for n, a, _ in pbt.log[:fork]
                        if n == "on_result" and a[0] == r.trial_id][-1]
            assert len(r.metrics_history) >= reported
            assert all(m["lr"] == last[r.trial_id]["lr"]
                       for m in r.metrics_history[reported:])
