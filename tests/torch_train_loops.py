"""Train loops the port's trainer tests run in worker processes.

A worker process imports its train loop by module and name, and must not
import JAX, so the loops live here, apart from the test files (which
import JAX for the reference). Each takes its parameters from the
``train_loop_config`` dict."""

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import train as rt_train
from ray_tpu_torch.train import session as session_mod


def triangle(k: int) -> float:
    """Every element of the state vector after completing step ``k-1``:
    the loop adds ``step+1`` each step, so this is 1+2+...+k."""
    return k * (k + 1) / 2.0


def await_teardown(stop, limit_s):
    """Hold the step until the controller flags the session's ``stop``
    event (the teardown that a resize ask starts)."""
    if not stop.wait(limit_s):
        raise AssertionError(
            f"the controller did not tear the group down within "
            f"{limit_s} s of the resize ask")


def _record(path, row):
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")


def read_rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [tuple(json.loads(line)) for line in f]


def elastic_loop(config):
    """The JAX suite's deterministic elastic loop
    (``tests/test_train_elastic.py::_make_loop``): restore from the newest
    committed manifest (checked bit-identical against the closed form),
    add ``step+1`` to every element each step, save and report each step.

    ``resize_at``: ``[[world, step, target], ...]``; rank 0 asks the
    resize at that step and holds the step unsaved until the controller
    flags the teardown (the step never commits, so the restore point is
    the step before; no teardown within ``stall_s`` fails the loop). Ranks
    meet at a barrier between save and report when they form a group, so
    a kill at a step's report lands after every rank saved that step.
    Rank 0 appends each restore's ``(world, start)`` to
    ``config["restores"]``."""
    ctx = rt_train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    width = config.get("width", 4)
    plane = rt_train.get_checkpoint_plane()
    w = np.zeros(width, np.float64)
    start = 0
    if plane.latest_step() is not None:
        st = plane.restore()
        w, start = st["w"].numpy(), int(st["step"]) + 1
        if not np.array_equal(w, np.full(width, triangle(start))):
            raise AssertionError(f"restored {w} at start {start}")
        if rank == 0:
            _record(config.get("restores"), [world, start])
    resize_at = {(a, b): c for a, b, c in config.get("resize_at", [])}
    grouped = dist.is_available() and dist.is_initialized()
    for step in range(start, config["total"]):
        target = resize_at.get((world, step)) if rank == 0 else None
        if target:
            rt_train.request_resize(target)
            await_teardown(session_mod._get_session().stop,
                           config.get("stall_s", 60.0))
        time.sleep(config.get("step_sleep", 0.0))
        w = w + (step + 1)
        plane.save(step, {"w": w, "step": np.asarray(step)})
        if grouped:
            dist.barrier()
        rt_train.report({"step": step, "loss": float(w.sum()),
                         "world": world})
    return float(w.sum())


def user_fail_loop(config):
    """Fails once (a marker file remembers it), then runs the elastic
    loop."""
    marker = config["marker"]
    if not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("x")
        rt_train.report({"step": -1, "loss": 0.0, "world": 1})
        raise RuntimeError("user train loop bug")
    return elastic_loop(config)


def nan_loop(config):
    for step in range(10):
        time.sleep(0.01)
        rt_train.report({"step": step, "loss": float("nan")})


def goodput_loop(config):
    """The JAX goodput suite's loop: a sleep a step, a save, a report."""
    plane = rt_train.get_checkpoint_plane()
    w = np.zeros(4)
    start = 0
    if plane.latest_step() is not None:
        st = plane.restore()
        w, start = st["w"].numpy(), int(st["step"]) + 1
    for step in range(start, config["total"]):
        time.sleep(config.get("step_sleep", 0.03))
        w = w + (step + 1)
        plane.save(step, {"w": w, "step": np.asarray(step)})
        rt_train.report({"step": step, "loss": float(w.sum())})
    return float(w.sum())


def preempt_loop(config):
    """A loop under a PreemptionGuard: rank 0 publishes a notice at step
    ``preempt_at`` (the first attempt only) and waits for it to arrive;
    after each step's save the ranks agree (an all-reduce of their
    guards' flags) whether a notice came, and if so the save just made
    is the just-in-time one: every rank raises PreemptedError and the
    controller resumes from that manifest."""
    from ray_tpu_torch.checkpoint.preempt import (PreemptionGuard,
                                                  publish_preempt)
    from ray_tpu_torch.exceptions import PreemptedError

    ctx = rt_train.get_context()
    plane = rt_train.get_checkpoint_plane()
    w = np.zeros(4)
    start = 0
    if plane.latest_step() is not None:
        st = plane.restore()
        w, start = st["w"].numpy(), int(st["step"]) + 1
        if ctx.get_world_rank() == 0:
            _record(config.get("restores"), [ctx.get_world_size(), start])
    with PreemptionGuard() as guard:
        for step in range(start, config["total"]):
            if step == config.get("preempt_at") and start == 0 and \
                    ctx.get_world_rank() == 0:
                publish_preempt(reason="test-maintenance")
                guard.wait(30.0)
            w = w + (step + 1)
            plane.save(step, {"w": w, "step": np.asarray(step)})
            flag = torch.tensor([float(guard.triggered)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            if flag.item():
                raise PreemptedError("host preempted", notice=guard.notice)
            rt_train.report({"step": step, "loss": float(w.sum())})
    return float(w.sum())


def llama_loop(config):
    """A tiny fp32 Llama from the JAX params in ``config["params"]``
    (numpy), trained through ``ShardedTrainer`` on the CPU, fed by
    :class:`DevicePrefetcher` and driven by :class:`AsyncStepLoop`. With
    more than one worker the trainer runs on an fsdp mesh over the
    workers' gloo group. Reports each step's loss and grad norm."""
    import dataclasses

    from ray_tpu_torch.interop import params_from_numpy
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models import training as tt
    from ray_tpu_torch.parallel import DEFAULT_RULES, MeshConfig, make_mesh
    from ray_tpu_torch.train.ingest import synthetic_host_batches

    world = rt_train.get_context().get_world_size()
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32),
                              **config.get("cfg", {}))
    opt = tt.default_optimizer(warmup_steps=2, total_steps=50,
                               learning_rate=1e-2)
    if world > 1:
        mesh = make_mesh(MeshConfig(fsdp=world), device_type="cpu")
        trainer = tt.ShardedTrainer(cfg, mesh, optimizer=opt,
                                    rules=DEFAULT_RULES)
    else:
        trainer = tt.ShardedTrainer(cfg, optimizer=opt, device="cpu")
    state = trainer.state_from_params(params_from_numpy(config["params"],
                                                        "cpu"))
    batches = synthetic_host_batches(config["batch"], config["seq"],
                                     cfg.vocab_size, steps=config["steps"],
                                     seed=config.get("seed", 0))
    with rt_train.DevicePrefetcher(batches, trainer, depth=2) as pf:
        loop = rt_train.AsyncStepLoop(trainer, state,
                                      sync_every=config["sync_every"])
        _, history = loop.run(pf)
    for step, h in enumerate(history):
        rt_train.report({"step": step, "loss": h["loss"],
                         "grad_norm": h["grad_norm"]})
    return [h["loss"] for h in history]


def jit_preempt_loop(config):
    """The JAX suite's preemption loop
    (``tests/test_checkpoint_plane.py``): a notice at step 3 of the first
    attempt makes the loop save just in time, report and raise
    PreemptedError; the restart resumes after that save. The notice
    goes through the controller's store, so the loop waits for it."""
    from ray_tpu_torch.checkpoint.preempt import (PreemptionGuard,
                                                  publish_preempt)
    from ray_tpu_torch.exceptions import PreemptedError

    plane = rt_train.get_checkpoint_plane()
    start = 0
    if plane.latest_step() is not None:
        start = int(plane.restore(None)["step"]) + 1
    with PreemptionGuard() as guard:
        for step in range(start, 6):
            state = {"step": np.asarray(step),
                     "w": np.full((4,), float(step), np.float32)}
            if step == 3 and start == 0:
                publish_preempt(reason="maintenance-event")
                guard.wait(30.0)
            if guard.triggered:
                plane.save(step, state)  # just-in-time checkpoint
                rt_train.report({"step": step, "preempted": True})
                raise PreemptedError(guard.notice.get("reason",
                                                      "preempted"),
                                     notice=guard.notice)
            rt_train.report({"step": step})


def always_preempted_loop(config):
    from ray_tpu_torch.exceptions import PreemptedError

    raise PreemptedError("always preempted")


def report_loop(config):
    """Reports its rank and world ``config["steps"]`` times."""
    ctx = rt_train.get_context()
    for step in range(config.get("steps", 1)):
        rt_train.report({"step": step, "rank": ctx.get_world_rank(),
                         "world": ctx.get_world_size(),
                         "loss": 1.0 / (step + 1)})
    return ctx.get_world_rank()


def topk_loop(config):
    """Reports a scored Checkpoint each step (save_pytree of a torch
    tensor and a numpy array) into ``config["scratch"]``."""
    for step in range(5):
        d = os.path.join(config["scratch"], f"c{step}")
        rt_train.save_pytree({"step": torch.tensor(step),
                              "w": np.full(3, float(step))}, d)
        rt_train.report({"score": float(step)},
                        checkpoint=rt_train.Checkpoint.from_directory(d))


def crash_once_loop(config):
    """Checkpoints each step; raises once at step 2 (a marker file
    remembers it); the retry resumes from ``get_checkpoint()``."""
    ckpt = rt_train.get_checkpoint()
    start = (int(rt_train.load_pytree(ckpt.path)["step"]) + 1
             if ckpt else 0)
    for step in range(start, 4):
        if step == 2 and not os.path.exists(config["marker"]):
            with open(config["marker"], "w") as f:
                f.write("x")
            raise RuntimeError("simulated worker failure")
        d = os.path.join(config["scratch"], f"s{step}")
        rt_train.save_pytree({"step": np.asarray(step)}, d)
        rt_train.report({"step": step},
                        checkpoint=rt_train.Checkpoint.from_directory(d))


def always_fails_loop(config):
    raise RuntimeError("always fails")


def dataset_shard_loop(config):
    """``tests/test_train_ingest.py``'s shard loop: this rank's ids from
    ``get_dataset_shard("train")`` through the device-batch path (the
    CPU here), written to ``ids_<rank>.json`` under ``config["out"]``."""
    ctx = rt_train.get_context()
    it = rt_train.get_dataset_shard("train")
    ids = []
    with it.iter_device_batches("cpu", batch_size=8) as batches:
        for b in batches:
            assert isinstance(b["id"], torch.Tensor)
            ids.extend(int(x) for x in b["id"])
    with open(os.path.join(config["out"],
                           f"ids_{ctx.get_world_rank()}.json"), "w") as f:
        json.dump(ids, f)
    rt_train.report({"count": len(ids)})


def unknown_shard_loop(config):
    """Asks for a shard the trainer was not given: ``KeyError`` naming
    it, then a report that says so."""
    try:
        rt_train.get_dataset_shard("eval")
    except KeyError as e:
        rt_train.report({"ok": int("no dataset shard" in str(e)
                                   and "'train'" in str(e))})
        return
    rt_train.report({"ok": 0})


# The gpu test's model: 2 layers at a small width whose head dim (128)
# takes the flash kernels, bf16.
GPU_DATA_CONFIG = dict(vocab_size=1024, hidden_size=256,
                       intermediate_size=512, num_layers=2, num_heads=2,
                       num_kv_heads=1, head_dim=128, max_seq_len=512)


def gpu_data_trainer():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (ShardedTrainer,
                                               default_optimizer)

    cfg = llama.LlamaConfig(**GPU_DATA_CONFIG)
    return ShardedTrainer(cfg, optimizer=default_optimizer(
        warmup_steps=1, total_steps=100), device="cuda")


def gpu_data_steps(trainer, batches, report):
    """One synchronous train step a batch: its loss, where its tokens
    lay and its flash launches."""
    from ray_tpu_torch.ops.attention import flash_attention

    state = trainer.init_state(0)
    for i, batch in enumerate(batches):
        before = dict(flash_attention.launches)
        on = batch["tokens"].device.type
        state, metrics = trainer.train_step(state, batch)
        report({"step": i, "loss": float(metrics["loss"]), "device": on,
                "launches": {k: flash_attention.launches[k] - before[k]
                             for k in before}})


def gpu_data_loop(config):
    """[data-train] at the gpu test's width: the shard's device batches
    through the train step on the worker's card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = gpu_data_trainer()
    it = rt_train.get_dataset_shard("train")
    with it.iter_device_batches(trainer, batch_size=config["batch"]) as pf:
        gpu_data_steps(trainer, pf, rt_train.report)


def pool_loop(config):
    """The JAX suite's card-pool loop (``tests/test_pool_arbiter.py::
    _e2e_loop``): restore from the newest committed manifest (checked
    against the closed form), add ``step+1`` to every element each step,
    save and report each step with the world size. Past ``hold_at`` each
    attempt reports 5 steps and then holds while the file ``hold``
    exists, so the trainer lives through every handoff; the holding is
    not training state, so the loss is a pure function of the steps
    done."""
    ctx = rt_train.get_context()
    plane = rt_train.get_checkpoint_plane()
    width = config.get("width", 4)
    w = np.zeros(width, np.float64)
    start = 0
    if plane.latest_step() is not None:
        st = plane.restore()
        w, start = st["w"].numpy(), int(st["step"]) + 1
        if not np.array_equal(w, np.full(width, triangle(start))):
            raise AssertionError(f"restored {w} at start {start}")
    hold = config.get("hold", "")
    steps_this_attempt = 0
    for step in range(start, config["total"]):
        while steps_this_attempt >= 5 and step >= config["hold_at"] and \
                hold and os.path.exists(hold):
            time.sleep(0.02)
        w = w + (step + 1)
        plane.save(step, {"w": w, "step": np.asarray(step)})
        rt_train.report({"step": step, "loss": float(w.sum()),
                         "world": ctx.get_world_size()})
        steps_this_attempt += 1
    return float(w.sum())


def where_loop(config):
    """Reports, ``config["steps"]`` times, the cluster node its worker
    runs on (empty outside a cluster worker), the worker's pid and its
    ``CUDA_VISIBLE_DEVICES``, holding each step ``config["hold_s"]``."""
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker_or_none()
    node = w.core.node_id.hex() if w is not None and w.mode == "worker" \
        else ""
    ctx = rt_train.get_context()
    for step in range(config.get("steps", 1)):
        time.sleep(config.get("hold_s", 0.0))
        rt_train.report({"step": step, "rank": ctx.get_world_rank(),
                         "node_id": node, "pid": os.getpid(),
                         "cuda_visible_devices":
                             os.environ.get("CUDA_VISIBLE_DEVICES")})
    return ctx.get_world_rank()


def card_loop(config):
    """One step on the worker's card: reports the card's name and a sum
    computed there."""
    ctx = rt_train.get_context()
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    rt_train.report({"step": 0, "rank": ctx.get_world_rank(),
                     "sum": float(x.sum()), "pid": os.getpid(),
                     "device": torch.cuda.get_device_name(0),
                     "cuda_visible_devices":
                         os.environ.get("CUDA_VISIBLE_DEVICES")})
    return ctx.get_world_rank()
