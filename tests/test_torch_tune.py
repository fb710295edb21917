"""Port parity: ``ray_tpu_torch.tune`` against ``ray_tpu.tune``, the 11
cases of ``tests/test_tune.py``.

Each case runs on the port with JAX's assertions. Where JAX's outcome is
deterministic the same experiment runs on the JAX package and the two
are compared exactly: grid and seeded random variants (the same
``random.Random`` streams), TPE proposals with one trial at a time, and
results. Where it hangs on timing (ASHA's rungs, PBT and PB2 forks,
which depend on the order reports arrive in), every call the port's
controller made to its scheduler is recorded and replayed into a fresh
JAX scheduler of the same settings, which must decide the same: the same
verdicts, donors and explored configs. Both runtimes live side by side
for the module (``num_cpus=8``, no accelerator).
"""

import os
import pickle
import time

import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune


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


def replay(log, scheduler):
    """Feed ``log``'s calls to ``scheduler``; each answer must equal the
    recorded one."""
    for name, args, out in log:
        got = getattr(scheduler, name)(*args)
        assert got == out, (name, args, got, out)
    return scheduler


def by_trial(grid):
    return sorted(grid, key=lambda r: r.trial_id[:11])


def summary(grid):
    return [(r.config, r.metrics, bool(r.error), r.stopped_early)
            for r in by_trial(grid)]


def test_grid_search_runs_all_variants():
    def trainable(config):
        return {"score": config["x"] * config["y"]}

    def case(tune):
        return tune.Tuner(
            trainable,
            param_space={"x": tune.grid_search([1, 2, 3]),
                         "y": tune.grid_search([10, 100])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
        ).fit()

    results, jresults = case(ttune), case(jtune)
    assert len(results) == 6
    best = results.get_best_result()
    assert best.metrics["score"] == 300
    assert best.config == {"x": 3, "y": 100}
    assert summary(results) == summary(jresults)


def test_random_sampling():
    def trainable(config):
        return {"score": config["lr"]}

    def case(tune):
        return tune.Tuner(
            trainable,
            param_space={"lr": tune.loguniform(1e-5, 1e-1)},
            tune_config=tune.TuneConfig(metric="score", mode="min",
                                        num_samples=8, search_seed=0),
        ).fit()

    results, jresults = case(ttune), case(jtune)
    assert len(results) == 8
    assert all(1e-5 <= r.metrics["score"] <= 1e-1 for r in results)
    # The seed's variants, in order, bit for bit.
    assert summary(results) == summary(jresults)
    gen = ttune.search.BasicVariantGenerator(3, seed=11)
    jgen = jtune.search.BasicVariantGenerator(3, seed=11)
    space = {"a": ttune.choice([1, 2, 3]), "b": ttune.uniform(0, 1),
             "c": ttune.randint(0, 9), "g": ttune.grid_search(["p", "q"]),
             "d": ttune.sample_from(lambda c: c["c"] * 2)}
    jspace = {"a": jtune.choice([1, 2, 3]), "b": jtune.uniform(0, 1),
              "c": jtune.randint(0, 9), "g": jtune.grid_search(["p", "q"]),
              "d": jtune.sample_from(lambda c: c["c"] * 2)}
    assert list(gen.variants(space)) == list(jgen.variants(jspace))


def test_intermediate_reports_and_asha():
    def trainable(config):
        # Weaker configs are slower, so they reach each ASHA rung after
        # the strong peers have recorded it (JAX's deterministic setup).
        for step in range(8):
            time.sleep(0.05 * (5 - config["q"]))
            ttune.report({"score": config["q"] * (step + 1)})

    asha = dict(metric="score", mode="max", max_t=8, grace_period=2,
                reduction_factor=2)
    scheduler = Recording(ttune.AsyncHyperBandScheduler(**asha))
    results = ttune.Tuner(
        trainable,
        param_space={"q": ttune.grid_search([1, 2, 3, 4])},
        tune_config=ttune.TuneConfig(metric="score", mode="max",
                                     scheduler=scheduler),
    ).fit()
    assert len(results) == 4
    best = results.get_best_result()
    assert best.config["q"] == 4
    assert any(r.stopped_early for r in results)
    # JAX's ASHA on the same reports stops the same trials.
    replay(scheduler.log, jtune.AsyncHyperBandScheduler(**asha))
    stops = {a[0] for n, a, out in scheduler.log if out == "STOP"}
    assert stops == {r.trial_id for r in results if r.stopped_early}


def test_trial_errors_are_captured():
    def trainable(config):
        if config["x"] == 1:
            raise RuntimeError("boom")
        return {"score": config["x"]}

    def case(tune):
        return tune.Tuner(
            trainable,
            param_space={"x": tune.grid_search([0, 1, 2])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
        ).fit()

    results, jresults = case(ttune), case(jtune)
    assert len(results.errors) == 1
    assert "boom" in results.errors[0].error
    assert results.get_best_result().metrics["score"] == 2
    assert summary(results) == summary(jresults)


def test_tune_run_wrapper():
    def trainable(config):
        return {"v": config["a"] + 1}

    port, jax_ = (tune.run(trainable, config={"a": tune.grid_search([5, 7])},
                           metric="v", mode="max") for tune in (ttune, jtune))
    assert port.get_best_result().metrics["v"] == 8
    assert summary(port) == summary(jax_)


# ------------------------------------------------- experiment-state restore
def _restore_trainable(tune):
    def trainable(config):
        ckpt = tune.get_checkpoint()
        start = (ckpt or {"step": 0})["step"]
        for step in range(start + 1, 6):
            tune.report({"score": step}, checkpoint={"step": step})
            if step == 3 and ckpt is None:
                raise RuntimeError("boom at step 3")

    return trainable


def test_tuner_restore_resumes_errored_trial(tmp_path):
    """The experiment-state snapshot lets Tuner.restore rerun a failed
    trial from its last checkpoint instead of from scratch. The run
    config here is a class defined in the test, which pickle refuses: the
    snapshot leaves it out and the restore runs in the snapshot's own
    directory."""
    out = {}
    for pkg, tune in (("port", ttune), ("jax", jtune)):
        class RC:
            storage_path = str(tmp_path / pkg)
            name = "restore_exp"

        trainable = _restore_trainable(tune)
        grid = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([1])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=RC(),
        ).fit()
        assert grid.errors and "boom" in grid.errors[0].error
        path = str(tmp_path / pkg / "restore_exp")
        if tune is ttune:
            with open(os.path.join(path, "tuner_state.pkl"), "rb") as f:
                assert pickle.load(f)["dropped"] == ["run_config"]
        grid2 = tune.Tuner.restore(path, trainable,
                                   resume_errored=True).fit()
        assert not grid2.errors
        # Resumed from the step-3 checkpoint: reached 5 without raising.
        assert grid2.get_best_result().metrics["score"] == 5
        out[pkg] = [r.metrics_history for r in grid2]
    assert out["port"] == out["jax"]


def test_tuner_restore_keeps_completed_results(tmp_path):
    for tune in (ttune, jtune):
        root = tmp_path / tune.__name__

        class RC:
            storage_path = str(root)
            name = "restore_done"

        def trainable(config, tune=tune):
            tune.report({"score": config["x"]})

        grid = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([1, 2, 3])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=RC(),
        ).fit()
        assert len(grid) == 3 and not grid.errors
        grid2 = tune.Tuner.restore(str(root / "restore_done"),
                                   trainable).fit()
        # Nothing to rerun: completed results round-trip through the
        # snapshot.
        assert len(grid2) == 3 and not grid2.errors
        assert grid2.get_best_result().metrics["score"] == 3
        assert summary(grid2) == summary(grid)


# ------------------------------------------------------------ TPE search
def test_tpe_search_concentrates_on_optimum():
    """Model-based search (TPESearch) concentrates samples near the
    optimum; with one trial at a time the proposals are JAX's, in
    order, bit for bit."""
    def objective(config):
        x, y = config["x"], config["y"]
        return {"loss": (x - 0.3) ** 2 + (y + 0.2) ** 2}

    def case(tune):
        return tune.Tuner(
            objective,
            param_space={"x": tune.uniform(-1, 1), "y": tune.uniform(-1, 1)},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", num_samples=40,
                max_concurrent_trials=1,
                search_alg=tune.TPESearch(n_startup=10, seed=7)),
        ).fit()

    results, jresults = case(ttune), case(jtune)
    assert len(results) == 40
    losses = [r.metrics["loss"] for r in results]
    assert min(losses) < 0.05
    assert sum(losses[-10:]) / 10 < sum(losses[:10]) / 10
    assert [r.config for r in results] == [r.config for r in jresults]
    assert losses == [r.metrics["loss"] for r in jresults]


def test_tpe_mixed_space_types():
    """TPE handles categorical / randint / loguniform dimensions."""
    def objective(config):
        bonus = 1.0 if config["act"] == "gelu" else 0.0
        return {"score": bonus - abs(config["layers"] - 6) * 0.1
                - abs(config["lr"] - 1e-3)}

    def case(tune):
        return tune.Tuner(
            objective,
            param_space={"act": tune.choice(["relu", "gelu", "silu"]),
                         "layers": tune.randint(2, 12),
                         "lr": tune.loguniform(1e-5, 1e-1)},
            tune_config=tune.TuneConfig(
                metric="score", mode="max", num_samples=25,
                max_concurrent_trials=1,
                search_alg=tune.TPESearch(n_startup=8, seed=3)),
        ).fit()

    results, jresults = case(ttune), case(jtune)
    assert len(results) == 25
    best = results.get_best_result()
    assert best.config["act"] in ("relu", "gelu", "silu")
    assert isinstance(best.config["layers"], int)
    assert 2 <= best.config["layers"] < 12
    assert 1e-5 <= best.config["lr"] <= 1e-1
    last = [r.config["act"] for r in list(results)[-8:]]
    assert last.count("gelu") >= 4
    assert [r.config for r in results] == [r.config for r in jresults]


def test_searcher_abc_custom_plugin(tmp_path):
    """A user-defined Searcher plugs into TuneConfig.search_alg. It is a
    class of this test, which pickle refuses: the snapshot leaves it
    out, and names it."""
    out = {}
    for tune in (ttune, jtune):
        class FixedSearcher(tune.Searcher):
            def __init__(self):
                self.completed = []
                self._i = 0

            def configure(self, param_space, metric, mode, seed=None):
                self.space = param_space

            def suggest(self):
                self._i += 1
                return {"x": self._i}

            def on_trial_complete(self, config, score):
                self.completed.append((config["x"], score))

        class RC:
            storage_path = str(tmp_path / tune.__name__)
            name = "plugin"

        searcher = FixedSearcher()
        grid = tune.Tuner(
            lambda cfg, tune=tune: tune.report({"score": cfg["x"] * 10}),
            param_space={"x": tune.uniform(0, 1)},
            tune_config=tune.TuneConfig(metric="score", mode="max",
                                        num_samples=4, search_alg=searcher),
            run_config=RC(),
        ).fit()
        assert len(grid) == 4 and not grid.errors
        assert sorted(x for x, _ in searcher.completed) == [1, 2, 3, 4]
        assert grid.get_best_result().metrics["score"] == 40
        out[tune.__name__] = sorted(searcher.completed)
    assert out["ray_tpu_torch.tune"] == out["ray_tpu.tune"]
    with open(tmp_path / "ray_tpu_torch.tune" / "plugin" /
              "tuner_state.pkl", "rb") as f:
        state = pickle.load(f)
    assert state["dropped"] == ["tune_config.search_alg", "run_config"]


def test_pb2_steers_population_within_bounds():
    """PB2's GP-bandit explore keeps chosen hyperparams inside the
    declared bounds and moves the population toward the productive
    region; JAX's PB2 on the same reports decides the same."""
    def trainable(config):
        ckpt = ttune.get_checkpoint() or {"score": 0.0, "step": 0}
        score, step = ckpt["score"], ckpt["step"]
        for _ in range(8 - step):
            step += 1
            score += config["lr"]
            ttune.report({"score": score, "lr": config["lr"]},
                         checkpoint={"score": score, "step": step})
            time.sleep(0.15)

    settings = dict(metric="score", mode="max", perturbation_interval=2,
                    hyperparam_bounds={"lr": (0.01, 1.0)}, seed=0)
    pb2 = Recording(ttune.PB2(**settings))
    grid = ttune.Tuner(
        trainable,
        param_space={"lr": ttune.grid_search([0.01, 0.02, 0.9, 0.9])},
        tune_config=ttune.TuneConfig(metric="score", mode="max",
                                     scheduler=pb2),
    ).fit()
    assert len(grid) == 4 and not grid.errors
    assert pb2.exploit_count >= 1, "PB2 never exploited"
    final_lrs = [r.metrics["lr"] for r in grid if r.metrics]
    assert all(0.01 <= lr <= 1.0 for lr in final_lrs)
    assert max(final_lrs) >= 0.5  # a high-lr lineage survived/was chosen
    jpb2 = replay(pb2.log, jtune.PB2(**settings))
    assert jpb2.exploit_count == pb2.exploit_count


# ----------------------------------------------- the port's own guarantees
def test_a_stopped_trial_unwinds_at_its_next_report():
    """A trial ASHA stops is told before its actor is killed: its
    function leaves at its next report instead of running on (JAX's
    killed in-process actor thread runs to its end)."""
    steps = {}

    def trainable(config):
        for step in range(50):
            steps[config["q"]] = step
            time.sleep(0.01 if config["q"] > 1 else 0.03)
            ttune.report({"score": config["q"] * (step + 1)})

    grid = ttune.Tuner(
        trainable, param_space={"q": ttune.grid_search([1, 2, 3, 4])},
        tune_config=ttune.TuneConfig(
            metric="score", mode="max",
            scheduler=ttune.AsyncHyperBandScheduler(
                metric="score", mode="max", max_t=50, grace_period=2,
                reduction_factor=2)),
    ).fit()
    stopped = [r for r in grid if r.stopped_early]
    assert stopped
    time.sleep(0.5)
    for r in stopped:
        q = r.config["q"]
        # It reported len(history) steps; at most a few more ran before
        # the stop reached it, far from the 50 it would run.
        assert steps[q] < len(r.metrics_history) + 5 < 50


def test_sample_from_lambda_is_left_out_of_the_snapshot(tmp_path):
    class RC:
        storage_path = str(tmp_path)
        name = "lam"

    grid = ttune.Tuner(
        lambda cfg: {"score": cfg["b"]},
        param_space={"a": ttune.grid_search([1, 2]),
                     "b": ttune.sample_from(lambda c: c["a"] * 3)},
        tune_config=ttune.TuneConfig(metric="score", mode="max"),
        run_config=RC(),
    ).fit()
    assert sorted(r.metrics["score"] for r in grid) == [3, 6]
    with open(os.path.join(tmp_path, "lam", "tuner_state.pkl"), "rb") as f:
        state = pickle.load(f)
    assert state["dropped"] == ["param_space['b']", "run_config"]
    assert list(state["param_space"]) == ["a"]
    assert [r.config for r in state["results"]] == \
        [r.config for r in grid]


def test_exports_match_jax():
    assert set(ttune.__all__) == set(jtune.__all__)
