"""Port parity of the sharded trainer: ``ShardedTrainer`` on a gloo CPU
mesh of 2 and of 4 processes against the one-process port trainer and
against the JAX package's ``ShardedTrainer`` on the same mesh shape of
CPU devices.

One module-scoped spawn per world size runs every case of that size in
its processes (this module's world-2 cases;
``tests/test_torch_sharded_training_world4.py`` runs world 4's) (``init_method="file://"`` under a temp dir, one torch
thread each, spawn and join under a timeout); the JAX references run in
the pytest process meanwhile. Both sides start from the same weights (a
JAX init carried across through numpy) and the same seeded numpy
tokens, in fp32 with JAX's matmul precision at "highest".

The workers import torch and the port only: JAX is imported inside the
tests and fixtures, never at the top of this module, which the spawned
processes import.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import training as tt

STEPS = 3
SPAWN_TIMEOUT_S = 300
# default_optimizer's AdamW (warmup 2 of 50 steps to lr 1e-2, as in
# tests/test_torch_training.py) with eps 1e-6 in place of 1e-8: an element
# whose grad is near eps, ~1e-8 here, gets the update g / (|g| + eps),
# which reads the grad's last fp32 bits (~5e-10 apart between reduction
# orders) and moved such an element by up to 1.9e-4 at eps 1e-8, 8.6
# times the params' tolerance. At 1e-6 the update of so small a grad is
# about g / eps, which those bits move a hundred times less.
OPTIMIZER = dict(learning_rate=1e-2, weight_decay=0.1, b1=0.9, b2=0.95,
                 grad_clip=1.0, warmup_steps=2, decay_steps=50, eps=1e-6)


def _port_optimizer():
    return tt.AdamW(**OPTIMIZER)


def _jax_optimizer():
    import optax

    o = OPTIMIZER
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, o["learning_rate"], o["warmup_steps"], o["decay_steps"])
    return optax.chain(
        optax.clip_by_global_norm(o["grad_clip"]),
        optax.adamw(schedule, b1=o["b1"], b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"]))

# name -> (world size, mesh sizes, tiny-config overrides, microbatches).
# The layouts of tests/test_model_training.py at 2 and 4 ranks, plus GQA
# with the kv heads replicated (2 kv heads on tensor=4), microbatching,
# remat and a head dim the flash path takes; on a seq axis, ring
# attention ("auto"; "flash" attends the gathered sequence): tensor=2 x
# seq=2 is __graft_entry__.py's layout at 4 devices. The 63 loss
# positions cut into 7 chunks of 9, which seq=2 and seq=4 do not divide:
# the chunks run replicated over seq.
CASES = {
    "dp": (2, dict(data=2, fsdp=1), {}, 1),
    "fsdp2": (2, dict(fsdp=2), {}, 1),
    "tp2": (2, dict(fsdp=1, tensor=2), {}, 1),
    "fsdp4": (4, dict(fsdp=4), {}, 1),
    "fsdp_tp": (4, dict(fsdp=2, tensor=2), {}, 1),
    "tp4_kv2": (4, dict(fsdp=1, tensor=4), dict(num_kv_heads=2), 1),
    "micro2": (4, dict(data=2, fsdp=2), {}, 2),
    "remat_full": (4, dict(fsdp=2, tensor=2),
                   dict(remat=True, remat_policy="full"), 1),
    "flash_d128": (4, dict(fsdp=2, tensor=2), dict(head_dim=128), 1),
    "tp2_sp2": (4, dict(fsdp=1, tensor=2, seq=2), {}, 1),
    "fsdp2_sp2": (4, dict(fsdp=2, seq=2), {}, 1),
    "sp4": (4, dict(fsdp=1, seq=4), {}, 1),
    "sp2_remat_full": (2, dict(fsdp=1, seq=2),
                       dict(remat=True, remat_policy="full"), 1),
    "sp2_flash": (2, dict(fsdp=1, seq=2), dict(attention="flash"), 1),
    "tp2_sp2_micro2": (4, dict(fsdp=1, tensor=2, seq=2), {}, 2),
}


def _tokens_and_mask(vocab, microbatches):
    tokens = np.random.default_rng(3).integers(0, vocab, (8, 64)).astype(
        np.int32)
    mask = np.ones_like(tokens)
    if microbatches > 1:
        mask[:2, 10:] = 0                  # imbalance across microbatches
    return tokens, mask


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


# -- the workers (torch and the port only) -----------------------------------

def _run_case(rank, case, root):
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    inputs = torch.load(os.path.join(root, f"{case}.in.pt"))
    _, sizes, overrides, microbatches = CASES[case]
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, **overrides)
    mesh = make_mesh(MeshConfig(**sizes), device_type="cpu")
    trainer = tt.ShardedTrainer(
        cfg, mesh, optimizer=_port_optimizer(),
        microbatches=microbatches)
    state = trainer.state_from_params(inputs["params"])
    batch = trainer.shard_batch({"tokens": inputs["tokens"],
                                 "mask": inputs["mask"]})
    metrics = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, batch)
        assert not any(isinstance(v, DTensor) for v in m.values())
        metrics.append({k: float(v) for k, v in m.items()})
    # Sharded for real: each rank holds its share of w_gate [L, E, M]
    # (embed on fsdp, mlp on tensor) and of its moments, and the grads
    # reach the optimizer in their params' placements.
    w = state.params["layers"]["w_gate"]
    i = list(state.params["layers"]).index("w_gate") + 1
    held = [t.to_local().numel() for t in (w, state.opt_state.mu[i],
                                            state.opt_state.nu[i])]
    _, _, grads = trainer.grads(state.params, batch)
    placed = all(tuple(g.placements) == tuple(p.placements)
                 for g, p in zip(grads, tt._leaves(state.params)))
    params = {name: p.full_tensor().detach()
              for name, p in _leaves(state.params)}
    if rank == 0:
        torch.save(dict(metrics=metrics, params=params, held=held,
                        numel=w.numel(), placed=placed,
                        shape=tl.mesh_shape(mesh)),
                   os.path.join(root, f"{case}.out.pt"))


def _worker(rank, world, root, cases):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=world)
    try:
        for case in cases:
            _run_case(rank, case, root)
    finally:
        dist.destroy_process_group()


class _Spawned:
    """The cases of one world size, running in ``world`` processes."""

    def __init__(self, world, root):
        self.world, self.root = world, root
        self.cases = [c for c, spec in CASES.items() if spec[0] == world]
        self.ctx = mp.start_processes(_worker, args=(world, root,
                                                     self.cases),
                                      nprocs=world, join=False,
                                      start_method="spawn")
        self.deadline = time.monotonic() + SPAWN_TIMEOUT_S
        self.joined = False

    def result(self, case):
        if not self.joined:
            while not self.ctx.join(timeout=max(
                    self.deadline - time.monotonic(), 0.1)):
                if time.monotonic() > self.deadline:
                    self.kill()
                    pytest.fail(f"gloo workers of world size {self.world} "
                                f"did not finish in {SPAWN_TIMEOUT_S} s")
            self.joined = True
        return torch.load(os.path.join(self.root, f"{case}.out.pt"))

    def kill(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def _case_inputs(case):
    """(jax config, torch config, jax params as numpy, tokens, mask)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    _, _, overrides, microbatches = CASES[case]
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **overrides)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **overrides)
    jp = jax.device_get(jl.init_params(jc, jax.random.PRNGKey(0)))
    tokens, mask = _tokens_and_mask(jc.vocab_size, microbatches)
    return jc, tc, jp, tokens, mask


# The world sizes this module's cases run at (world 4's cases are in
# tests/test_torch_sharded_training_world4.py, so the test runner can
# spread the two process groups over its workers).
WORLDS = (2,)


def _cases(worlds):
    return [c for c, spec in CASES.items() if spec[0] in worlds]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, request):
    """World size -> its running workers, the inputs of every case of the
    requesting module's ``WORLDS`` written before the spawn."""
    worlds = request.module.WORLDS
    out, inputs = {}, {}
    for case in _cases(worlds):
        jc, tc, jp, tokens, mask = inputs[case] = _case_inputs(case)
        root = str(tmp_path_factory.getbasetemp() / f"world{CASES[case][0]}")
        os.makedirs(root, exist_ok=True)
        torch.save(dict(params=params_from_numpy(jp, "cpu"),
                        tokens=torch.from_numpy(tokens),
                        mask=torch.from_numpy(mask)),
                   os.path.join(root, f"{case}.in.pt"))
    try:
        for world in worlds:
            root = str(tmp_path_factory.getbasetemp() / f"world{world}")
            out[world] = _Spawned(world, root)
        yield out, inputs
    finally:
        for s in out.values():
            s.kill()


def _jax_run(case, jc, jp, tokens, mask):
    """JAX's ShardedTrainer on the case's mesh shape of CPU devices:
    per-step metrics and the final params."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import training as jt
    from ray_tpu.parallel import MeshConfig, make_mesh

    world, sizes, _, microbatches = CASES[case]
    mesh = make_mesh(MeshConfig(**sizes), devices=jax.devices()[:world])
    trainer = jt.ShardedTrainer(
        jc, mesh, optimizer=_jax_optimizer(),
        microbatches=microbatches)
    with jax.default_matmul_precision("highest"):
        params = jax.device_put(jp, trainer.param_shardings)
        state = jax.device_put(
            jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=trainer.optimizer.init(params)),
            trainer.state_shardings)
        batch = trainer.shard_batch({"tokens": jnp.asarray(tokens),
                                     "mask": jnp.asarray(mask)})
        metrics = []
        for _ in range(STEPS):
            state, m = trainer.train_step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.params)


def _port_one_process(case, tc, jp, tokens, mask):
    trainer = tt.ShardedTrainer(
        tc, optimizer=_port_optimizer(), device="cpu",
        microbatches=CASES[case][3])
    state = trainer.state_from_params(params_from_numpy(jp, "cpu"))
    batch = {"tokens": torch.from_numpy(tokens),
             "mask": torch.from_numpy(mask)}
    metrics = []
    for _ in range(STEPS):
        state, m = trainer.train_step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, dict(_leaves(state.params))


def _assert_close_to(name, got, want_metrics, want_params):
    for step, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5,
                                   err_msg=f"{name} loss, step {step + 1}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4,
                                   err_msg=f"{name} grad_norm, step "
                                           f"{step + 1}")
        assert g["tokens"] == w["tokens"], name
    want = dict(_leaves(want_params))
    for leaf, p in got["params"].items():
        w = want[leaf]
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else \
            np.asarray(w, np.float32)
        np.testing.assert_allclose(
            p.numpy(), w, atol=1e-4 * float(np.abs(w).max()), rtol=0,
            err_msg=f"{name} params {leaf}")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", _cases(WORLDS))
def test_sharded_steps_match_one_process_and_jax(spawned, case):
    _check_steps(spawned, case)


def _check_steps(spawned, case):
    workers, inputs = spawned
    jc, tc, jp, tokens, mask = inputs[case]
    jax_metrics, jax_params = _jax_run(case, jc, jp, tokens, mask)
    one_metrics, one_params = _port_one_process(case, tc, jp, tokens, mask)
    got = workers[CASES[case][0]].result(case)
    _assert_close_to("vs one process", got, one_metrics, one_params)
    _assert_close_to("vs JAX", got, jax_metrics, jax_params)
    assert got["shape"] == {a: CASES[case][1].get(a, 1) for a in got[
        "shape"]}
    assert got["placed"], "grads reach the optimizer in their placements"


SHARDED_CASES = ["fsdp2", "fsdp4", "fsdp_tp", "dp"]


@pytest.mark.parametrize("case", [c for c in SHARDED_CASES
                                  if CASES[c][0] in WORLDS])
def test_params_and_moments_actually_sharded(spawned, case):
    _check_sharded(spawned, case)


def _check_sharded(spawned, case):
    # w_gate [L, E, M] is embed-sharded on fsdp and mlp-sharded on
    # tensor: each rank holds 1/(fsdp*tensor) of it and of its moments.
    workers, _ = spawned
    got = workers[CASES[case][0]].result(case)
    sizes = CASES[case][1]
    share = got["numel"] // (sizes.get("fsdp", 1) * sizes.get("tensor", 1))
    assert got["held"] == [share] * 3, got["held"]
