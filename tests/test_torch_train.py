"""``TorchTrainer.fit`` end to end against ``JaxTrainer.fit``, and the
trainer's configuration, checkpoint and storage modules against the JAX
package's.

Worker processes run the loops of ``torch_train_loops.py`` (they import
the port only) on gloo; JAX's trainer runs the same loops in its
in-process runtime. Results are compared exactly where the loops are
exact (reports, checkpoints, restore points) and, for the tiny fp32
Llama, losses within rtol 1e-5 and grad norms within rtol 1e-4 (the
same math in another summation order; the trainer parity tests' bars).
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import torch_train_loops as loops
from ray_tpu import train as jt
from ray_tpu.models import llama as jl
from ray_tpu.models import training as jtr
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu.train.ingest import synthetic_host_batches
from ray_tpu_torch import exceptions as texc
from ray_tpu_torch import train as tt
from ray_tpu_torch.train import trainer as trainer_mod
from ray_tpu_torch.train.trainer import ControllerState


@pytest.fixture
def ray8():
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8)
    yield
    ray_tpu.shutdown()


# ----------------------------------------------------------- the surface
def test_exports_are_jax_names_with_torch_for_jax():
    want = {n.replace("Jax", "Torch") for n in jt.__all__}
    assert set(tt.__all__) == want
    for name in tt.__all__:
        assert getattr(tt, name) is not None
    from ray_tpu.checkpoint import preempt as jpre
    from ray_tpu_torch.checkpoint import preempt as tpre

    public = {n for n in dir(jpre) if not n.startswith("_")
              and callable(getattr(jpre, n))
              and getattr(getattr(jpre, n), "__module__", "") == jpre.__name__}
    assert public <= set(dir(tpre)), public - set(dir(tpre))


def test_not_ported_parts_raise_naming_their_item(tmp_path):
    with pytest.raises(NotImplementedError, match="ray_tpu/data"):
        tt.TorchTrainer(loops.report_loop, datasets={"train": [1]})
    with pytest.raises(NotImplementedError, match="placement groups"):
        tt.ScalingConfig(placement_strategy="SPREAD")
    with pytest.raises(NotImplementedError, match="'s3'"):
        tt.StorageContext("s3://bucket/x", "exp")
    with pytest.raises(ValueError, match="module level"):
        tt.TorchTrainer(lambda config: None)


def test_use_gpu_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    # The card is the default: a trainer that does not ask for the CPU
    # raises on a host without one, as one that asks for the card does.
    for scaling in (tt.ScalingConfig(num_workers=1),
                    tt.ScalingConfig(num_workers=1, use_gpu=True)):
        trainer = tt.TorchTrainer(
            loops.report_loop, train_loop_config={},
            scaling_config=scaling,
            run_config=tt.RunConfig(storage_path=str(tmp_path)))
        with pytest.raises(RuntimeError, match="no CUDA card"):
            trainer.fit()


def test_nothing_outlives_a_script_that_ran_fit(tmp_path):
    """A script that ran ``fit`` leaves no process behind: at exit the
    runtime kills and reaps its workers and the fork server
    (``runtime.replica.stop_all``). Asked to exit, the fork server would
    finalize the torch it preloaded and outlive the script by about a
    second. The script runs in a session of its own, listed when it
    ends."""
    here = os.path.dirname(os.path.abspath(__file__))
    script = tmp_path / "fit_once.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{os.path.dirname(here)!r}, {here!r}]
        import torch_train_loops as loops
        from ray_tpu_torch import train as tt

        if __name__ == "__main__":
            res = tt.TorchTrainer(
                loops.report_loop, train_loop_config={{"steps": 2}},
                scaling_config=tt.ScalingConfig(num_workers=1,
                                                use_gpu=False),
                run_config=tt.RunConfig(storage_path={str(tmp_path)!r},
                                        name="once")).fit()
            assert res.error is None, res.error
    """))
    # Its output goes to a file: a pipe would be read to its end, which
    # waits for every process that holds it.
    with open(tmp_path / "out.txt", "wb") as out:
        proc = subprocess.Popen([sys.executable, str(script)],
                                start_new_session=True, stdout=out,
                                stderr=subprocess.STDOUT)
        proc.wait(timeout=120)
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[3] == str(proc.pid) and fields[0] != "Z":
            left.append(pid)
    assert proc.returncode == 0, (tmp_path / "out.txt").read_text()[-2000:]
    assert left == [], f"processes of the script's session still run: {left}"


def test_configs_match_jax_fields():
    skip = {"use_tpu", "tpus_per_worker", "topology", "jax_distributed"}
    added = {"use_gpu", "gpus_per_worker", "torch_distributed"}
    jf = {f.name for f in dataclasses.fields(jt.ScalingConfig)} - skip
    tf = {f.name for f in dataclasses.fields(tt.ScalingConfig)} - added
    assert jf == tf
    for cls in ("FailureConfig", "CheckpointConfig", "RunConfig", "Result"):
        assert ([(f.name, f.default) for f in dataclasses.fields(
            getattr(tt, cls))] == [(f.name, f.default) for f in
                                   dataclasses.fields(getattr(jt, cls))])
    assert tt.ScalingConfig(use_gpu=True).worker_resources() == \
        {"CPU": 1.0, "GPU": 1.0}


# ------------------------------------------------- checkpoint and storage
def test_pytree_round_trip_matches_jax(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": [np.int32(3), (np.ones(2, np.int64), np.zeros(1))],
            "c": {"d": np.float64(2.5)}}
    jt.save_pytree(tree, str(tmp_path / "j"))
    tt.save_pytree(tree, str(tmp_path / "t"))
    jback, tback = (jt.load_pytree(str(tmp_path / "j")),
                    tt.load_pytree(str(tmp_path / "t")))
    jl_, tl_ = jax.tree.leaves(jback), jax.tree.leaves(tback)
    assert len(jl_) == len(tl_) == 5
    for a, b in zip(jl_, tl_):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert isinstance(tback["b"][1], tuple)
    bf = torch.randn(4, 3).to(torch.bfloat16)
    tt.save_pytree({"w": bf, "n": torch.arange(3)}, str(tmp_path / "bf"))
    back = tt.load_pytree(str(tmp_path / "bf"))
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], bf)
    assert torch.equal(back["n"], torch.arange(3))


def test_storage_and_async_checkpointer_match_jax(tmp_path):
    local = tmp_path / "work"
    (local / "sub").mkdir(parents=True)
    (local / "a.txt").write_text("A")
    (local / "sub" / "b.bin").write_bytes(b"\x00\x01")
    ctx = tt.StorageContext(f"file://{tmp_path / 'bucket'}", "exp1")
    dest = ctx.upload_dir(str(local), "checkpoint_0")
    assert ctx.exists(dest)
    ctx.download_dir(dest, str(tmp_path / "restored"))
    assert (tmp_path / "restored" / "sub" / "b.bin").read_bytes() == \
        b"\x00\x01"
    plain = tt.StorageContext(str(tmp_path / "plain"), "exp2")
    assert plain.experiment_dir == str(tmp_path / "plain" / "exp2")
    # Snapshot isolation: the saved state is the state at save() time.
    ck = tt.AsyncCheckpointer(storage=ctx)
    tree = {"w": torch.ones(4, 4), "step": torch.tensor(3)}
    fut = ck.save(tree, str(tmp_path / "c0"), upload_rel="ck_0")
    tree["w"].mul_(100.0)  # in place, after the snapshot
    assert fut.result() == ctx.join("ck_0")
    ck.close()
    back = tt.load_pytree(ctx.join("ck_0"))
    jck = jt.AsyncCheckpointer()
    jck.save({"w": jnp.ones((4, 4)), "step": jnp.asarray(3)},
             str(tmp_path / "j0")).result()
    jck.close()
    jback = jt.load_pytree(str(tmp_path / "j0"))
    np.testing.assert_array_equal(back["w"].numpy(), np.asarray(jback["w"]))
    assert int(back["step"]) == int(jback["step"]) == 3


def test_checkpoint_manager_topk_matches_jax(tmp_path):
    out = {}
    for name, pkg in (("jax", jt), ("torch", tt)):
        mgr = pkg.CheckpointManager(str(tmp_path / name / "root"),
                                    num_to_keep=2,
                                    score_attribute="score",
                                    score_order="max", async_write=True)
        for step, score in enumerate([0.3, 0.9, 0.1, 0.5]):
            d = tempfile.mkdtemp(dir=tmp_path)
            with open(os.path.join(d, "step"), "w") as f:
                f.write(str(step))
            mgr.register(pkg.Checkpoint.from_directory(d),
                         {"score": score})
        mgr.flush()

        def step_of(c):
            with open(os.path.join(c.path, "step")) as f:
                return int(f.read())

        out[name] = (step_of(mgr.best), step_of(mgr.latest),
                     len(os.listdir(mgr.root)))
        mgr.close()
    assert out["torch"] == out["jax"] == (1, 3, 2)


# ------------------------------------------------------- the controller
def test_reports_ranks_and_state_machine_match_jax(ray8, tmp_path):
    def jloop(config):
        ctx = jt.get_context()
        for step in range(config.get("steps", 1)):
            jt.report({"step": step, "rank": ctx.get_world_rank(),
                       "world": ctx.get_world_size(),
                       "loss": 1.0 / (step + 1)})
        return ctx.get_world_rank()

    out = {}
    for name, trainer in (
            ("jax", jt.JaxTrainer(
                jloop, train_loop_config={"steps": 3},
                scaling_config=jt.ScalingConfig(num_workers=4),
                run_config=jt.RunConfig(storage_path=str(tmp_path / "j")))),
            ("torch", tt.TorchTrainer(
                loops.report_loop, train_loop_config={"steps": 3},
                scaling_config=tt.ScalingConfig(num_workers=4, use_gpu=False),
                run_config=tt.RunConfig(
                    storage_path=str(tmp_path / "t"))))):
        assert trainer.controller_state == ControllerState.INITIALIZING
        result = trainer.fit()
        assert result.error is None
        assert ControllerState.RUNNING in trainer.state_history
        # Which rank's report comes last depends on the final drain (it
        # lists every rank's last reports, in JAX's as in the port's).
        out[name] = ({k: v for k, v in result.metrics.items()
                      if k != "rank"}, trainer.state_history,
                     sorted({h["metrics"]["step"]
                             for h in result.metrics_history}))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {"step": 2, "world": 4, "loss": 1.0 / 3}
    assert out["torch"][2] == [0, 1, 2]


def test_checkpoint_topk_through_the_trainer(tmp_path):
    trainer = tt.TorchTrainer(
        loops.topk_loop, train_loop_config={"scratch": str(tmp_path / "s")},
        scaling_config=tt.ScalingConfig(num_workers=1, use_gpu=False),
        run_config=tt.RunConfig(
            storage_path=str(tmp_path),
            checkpoint_config=tt.CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="score")))
    result = trainer.fit()
    assert result.error is None
    best = tt.load_pytree(result.checkpoint.path)
    assert int(best["step"]) == 4 and best["w"][0] == 4.0
    assert len(os.listdir(os.path.join(result.path, "checkpoints"))) == 2


def test_failure_recovery_and_exhaustion_match_jax(ray8, tmp_path):
    """A loop that fails once resumes from its last reported Checkpoint
    under max_failures=1; one that always fails ends the run."""
    jmarker = tmp_path / "jcrashed"

    def jloop(config):
        ckpt = jt.get_checkpoint()
        start = (int(jt.load_pytree(ckpt.path)["step"]) + 1
                 if ckpt else 0)
        for step in range(start, 4):
            if step == 2 and not jmarker.exists():
                jmarker.write_text("x")
                raise RuntimeError("simulated worker failure")
            d = tempfile.mkdtemp(dir=tmp_path)
            jt.save_pytree({"step": np.asarray(step)}, d)
            jt.report({"step": step},
                      checkpoint=jt.Checkpoint.from_directory(d))

    def jfail(config):
        raise RuntimeError("always fails")

    (tmp_path / "s").mkdir()
    failure = dict(max_failures=1)
    cases = {
        "jax": [jt.JaxTrainer(jloop, train_loop_config={},
                              run_config=jt.RunConfig(
                                  storage_path=str(tmp_path / "j"),
                                  failure_config=jt.FailureConfig(
                                      **failure))),
                jt.JaxTrainer(jfail, train_loop_config={},
                              run_config=jt.RunConfig(
                                  storage_path=str(tmp_path / "j2"),
                                  failure_config=jt.FailureConfig(
                                      **failure)))],
        "torch": [tt.TorchTrainer(
            loops.crash_once_loop,
            train_loop_config={"marker": str(tmp_path / "tcrashed"),
                               "scratch": str(tmp_path / "s")},
            scaling_config=tt.ScalingConfig(use_gpu=False),
            run_config=tt.RunConfig(storage_path=str(tmp_path / "t"),
                                    failure_config=tt.FailureConfig(
                                        **failure))),
            tt.TorchTrainer(loops.always_fails_loop, train_loop_config={},
                            scaling_config=tt.ScalingConfig(use_gpu=False),
                            run_config=tt.RunConfig(
                                storage_path=str(tmp_path / "t2"),
                                failure_config=tt.FailureConfig(
                                    **failure)))]}
    out, errors = {}, {}
    for name, (ok, bad) in cases.items():
        r1, r2 = ok.fit(), bad.fit()
        assert r1.error is None and r2.error is not None
        errors[name] = r2.error
        out[name] = (r1.metrics, [h["metrics"]["step"]
                                  for h in r1.metrics_history],
                     [r["cause"] for r in ok.recovery_log],
                     [r["cause"] for r in bad.recovery_log],
                     bad.controller_state)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {"step": 3}
    assert isinstance(errors["torch"], texc.RayTaskError)


def test_elastic_downscale_to_available(tmp_path, monkeypatch):
    """num_workers beyond the host's CPUs starts elastically with what
    fits (>= min_workers), as JAX's does on a 3-CPU cluster."""
    monkeypatch.setattr(trainer_mod, "_available",
                        lambda: {"CPU": 3.0, "GPU": 0.0})
    trainer = tt.TorchTrainer(
        loops.report_loop, train_loop_config={},
        scaling_config=tt.ScalingConfig(num_workers=8, min_workers=1,
                                        use_gpu=False),
        run_config=tt.RunConfig(storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["world"] == 3


def test_failed_group_bootstrap_is_fatal(tmp_path, monkeypatch):
    """A process group that cannot form (NCCL asked of CPU workers) is
    retried on fresh ports, then raised as DistributedBootstrapError and
    classified fatal: no restart budget is drawn."""
    monkeypatch.setenv("RAY_TPU_TORCH_COORD_ATTEMPTS", "2")

    class NcclBackend(tt.TorchBackend):
        COORD_BACKOFF_S = 0.05

        def _bootstrap_torch_distributed(self, group, scaling):
            super()._bootstrap_torch_distributed(
                group, dataclasses.replace(scaling, use_gpu=True))

    trainer = tt.TorchTrainer(
        loops.report_loop, train_loop_config={},
        scaling_config=tt.ScalingConfig(num_workers=2, use_gpu=False),
        run_config=tt.RunConfig(storage_path=str(tmp_path)),
        backend=NcclBackend())
    result = trainer.fit()
    assert isinstance(result.error, texc.DistributedBootstrapError)
    assert trainer.controller_state == ControllerState.ERRORED
    assert trainer.recovery_log == []


# ------------------------------------------------- Llama through both
LLAMA = dict(batch=4, seq=32, steps=6, sync_every=2, seed=3)


@pytest.fixture(scope="module")
def jax_llama_losses():
    """JaxTrainer running JAX's ShardedTrainer over the same batches (one
    run serves both worker counts)."""
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8)
    try:
        yield _jax_llama_losses()
    finally:
        ray_tpu.shutdown()


def _jax_llama_losses():
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32)

    def loop(config):
        mesh = jmake_mesh(JMeshConfig(fsdp=-1), devices=jax.devices()[:1])
        trainer = jtr.ShardedTrainer(jc, mesh, optimizer=jtr.default_optimizer(
            warmup_steps=2, total_steps=50, learning_rate=1e-2))
        state = trainer.init_state(0)  # the params the port starts from
        with jax.default_matmul_precision("highest"):
            for step, b in enumerate(synthetic_host_batches(
                    LLAMA["batch"], LLAMA["seq"], jc.vocab_size,
                    steps=LLAMA["steps"], seed=LLAMA["seed"])):
                state, m = trainer.train_step(state, trainer.shard_batch(
                    {k: jnp.asarray(v) for k, v in b.items()}))
                jt.report({"step": step, "loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"])})

    trainer = jt.JaxTrainer(loop, train_loop_config={},
                            scaling_config=jt.ScalingConfig(num_workers=1))
    result = trainer.fit()
    assert result.error is None
    return [(h["metrics"]["loss"], h["metrics"]["grad_norm"])
            for h in result.metrics_history]


@pytest.mark.parametrize("workers", [1, 2])
def test_llama_losses_through_torch_trainer_match_jax_trainer(
        jax_llama_losses, tmp_path, workers):
    """A 2-layer fp32 Llama (LlamaConfig.tiny) from JAX's init params:
    TorchTrainer with one worker on one device, and with two workers on
    an fsdp=2 mesh over their gloo group, each step fed by the
    prefetcher and driven by AsyncStepLoop(sync_every=2), against
    JaxTrainer running JAX's trainer on the same batches."""
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32)
    mesh = jmake_mesh(JMeshConfig(fsdp=-1), devices=jax.devices()[:1])
    params = jax.device_get(jtr.ShardedTrainer(jc, mesh).init_state(0)
                            .params)
    want = jax_llama_losses
    trainer = tt.TorchTrainer(
        loops.llama_loop,
        train_loop_config={**LLAMA, "params": params},
        scaling_config=tt.ScalingConfig(num_workers=workers,
                                        use_gpu=False),
        run_config=tt.RunConfig(storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None, result.error
    got = [(h["metrics"]["loss"], h["metrics"]["grad_norm"])
           for h in result.metrics_history][:LLAMA["steps"]]
    assert len(got) == len(want) == LLAMA["steps"]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-5)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-4)
    assert all(np.isfinite(g[0]) for g in got)
