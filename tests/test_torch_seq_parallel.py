"""Port parity of the seq and stage axes: the named-axis collectives
(``ray_tpu_torch.parallel.axis``), ``ring_attention`` and
``ulysses_attention`` (``ray_tpu_torch.ops.ring_attention``) and
``pipelined`` (``ray_tpu_torch.parallel.pipeline``) on a gloo CPU mesh of
4 processes, against the JAX package's ops under ``shard_map`` on the
same mesh shape of CPU devices, and against the one-process result
(``mha_reference``, the sequential stages).

One module-scoped spawn runs every case in its processes
(``init_method="file://"`` under a temp dir, one torch thread each,
spawn and join under a timeout); JAX runs in the pytest process
meanwhile. Inputs are seeded numpy arrays, fp32, JAX's matmul precision
"highest". The workers import torch and the port only: JAX is imported
inside the tests, never at the top of this module, which the spawned
processes import.
"""

import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ray_tpu_torch.ops.attention import mha_reference

WORLD = 4
SPAWN_TIMEOUT_S = 300
# (b, s, hq, hkv, d) of tests/test_ops.py's sequence-parallel test.
ATTN_SHAPE = (2, 512, 8, 4, 64)
# name -> (impl, causal, mesh sizes); the batch is split over fsdp and the
# sequence over seq.
ATTN_CASES = {
    "ring-causal": ("ring", True, dict(fsdp=1, seq=4)),
    "ring-full": ("ring", False, dict(fsdp=1, seq=4)),
    "ulysses-causal": ("ulysses", True, dict(fsdp=1, seq=4)),
    "ulysses-full": ("ulysses", False, dict(fsdp=1, seq=4)),
    "ring-fsdp2-seq2": ("ring", True, dict(fsdp=2, seq=2)),
    "ulysses-fsdp2-seq2": ("ulysses", True, dict(fsdp=2, seq=2)),
}
# name -> (mesh sizes, stages, width, microbatches, batch rows, bias):
# tests/test_moe_pipeline.py's two pipelines on four devices.
PIPE_CASES = {
    "stage4": (dict(stage=4, fsdp=1), 4, 16, 8, 32, True),
    "stage2-fsdp2": (dict(stage=2, fsdp=2), 2, 8, 4, 8, False),
}
# Collective checks: a ring and a partial permutation on the seq axis.
RING_PERM = [(0, 1), (1, 2), (2, 3), (3, 0)]
PARTIAL_PERM = [(0, 2), (1, 0)]


def _attn_inputs():
    b, s, hq, hkv, d = ATTN_SHAPE
    rng = np.random.default_rng(0)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _pipe_inputs(case):
    _, stages, width, _, rows, bias = PIPE_CASES[case]
    rng = np.random.default_rng(1)
    params = {"w": (rng.standard_normal((stages, width, width)) * 0.5)
              .astype(np.float32)}
    if bias:
        params["b"] = (rng.standard_normal((stages, width)) * 0.1).astype(
            np.float32)
    x = rng.standard_normal((rows, width)).astype(np.float32)
    return params, x


def _stage_fn(p, x):
    y = x @ p["w"]
    return (y + p["b"]) if "b" in p else y


# -- the workers (torch and the port only) -----------------------------------

def _mesh(sizes):
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(**sizes), device_type="cpu")


def _attn_case(case, q, k, v):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    from ray_tpu_torch.ops import ring_attention, ulysses_attention
    from ray_tpu_torch.parallel.sharding import spec_placements

    impl, causal, sizes = ATTN_CASES[case]
    mesh = _mesh(sizes)
    pl = spec_placements(("fsdp", "seq"), mesh)
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[impl]
    args = [distribute_tensor(t, mesh, pl).requires_grad_() for t in
            (q, k, v)]
    out = local_map(functools.partial(fn, mesh=mesh, axis_name="seq",
                                      causal=causal),
                    out_placements=list(pl), in_placements=(pl,) * 3,
                    device_mesh=mesh)(*args)
    (out ** 2).sum().backward()
    return dict(out=out.full_tensor().detach(),
                grads=[a.grad.full_tensor() for a in args],
                local_seq=out.to_local().shape[1])


def _pipe_case(case, params, x):
    from ray_tpu_torch.parallel.pipeline import pipelined

    sizes, _, _, micro, _, _ = PIPE_CASES[case]
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    run = pipelined(lambda p, h: torch.tanh(_stage_fn(p, h)), _mesh(sizes),
                    num_microbatches=micro)
    out = run(params, x)
    (out ** 2).sum().backward()
    return dict(out=out.detach(), grads={k: v.grad for k, v in
                                         params.items()})


def _collectives(rank):
    """Values and grads of each collective on the seq axis of a seq=4
    mesh (rank r holds row r of the inputs), and of each on an axis the
    mesh dropped."""
    from ray_tpu_torch.ops import ulysses_attention
    from ray_tpu_torch.parallel import axis

    mesh = _mesh(dict(fsdp=1, seq=4))
    out = {"index": axis.axis_index(mesh, "seq"),
           "size": axis.axis_size(mesh, "seq"),
           "dropped": (axis.axis_index(mesh, "tensor"),
                       axis.axis_size(mesh, "tensor"))}
    rng = np.random.default_rng(2)
    x_all = torch.from_numpy(rng.standard_normal((WORLD, 8, 4)).astype(
        np.float32))
    w_all = torch.from_numpy(rng.standard_normal((WORLD, 8, 4)).astype(
        np.float32))
    w = w_all[rank]
    for name, perm in (("ring", RING_PERM), ("partial", PARTIAL_PERM)):
        x = x_all[rank].clone().requires_grad_()
        y = axis.ppermute(x, mesh, "seq", perm)
        (y * w).sum().backward()
        out[f"ppermute-{name}"] = (y.detach(), x.grad)
    x = x_all[rank].clone().requires_grad_()
    y = axis.all_to_all(x, mesh, "seq", split_axis=0, concat_axis=1)
    (y * y).sum().backward()
    out["all_to_all"] = (y.detach(), x.grad)
    x = x_all[rank].clone().requires_grad_()
    y = axis.psum(x, mesh, "seq")
    (y * y).sum().backward()
    out["psum"] = (y.detach(), x.grad)
    # An axis the mesh does not hold is of size 1: no collective, and
    # each op is the identity (ppermute with no pair gives zeros).
    x = x_all[rank]
    out["dropped-ops"] = all((
        axis.ppermute(x, mesh, "tensor", [(0, 0)]) is x,
        bool((axis.ppermute(x, mesh, "tensor", []) == 0).all()),
        axis.all_to_all(x, mesh, "tensor", 0, 1) is x,
        axis.psum(x, mesh, "stage") is x))
    with pytest.raises(ValueError, match="partial permutation"):
        axis.ppermute(x, mesh, "seq", [(0, 1), (1, 1)])
    out["ulysses-refuses"] = all(
        _refuses(lambda hq=hq, hkv=hkv: ulysses_attention(
            torch.zeros((1, 8, hq, 64)), torch.zeros((1, 8, hkv, 64)),
            torch.zeros((1, 8, hkv, 64)), mesh=mesh))
        for hq, hkv in ((6, 4), (8, 2)))
    return out


def _refuses(fn):
    try:
        fn()
    except ValueError as e:
        return "divisible" in str(e)
    return False


def _kv_whole_grads(mesh=None):
    """Loss and grads of a tiny fp32 Llama whose one kv head the tensor
    axis cannot split (JAX's shard_map refuses it; the port keeps the kv
    heads whole and each rank's ring takes its q heads' kv head)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import ShardedTrainer, synthetic_batch

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, num_kv_heads=1,
                                 attention="ring" if mesh else "flash")
    trainer = ShardedTrainer(cfg, mesh, device=None if mesh else "cpu")
    params = trainer.state_from_params(llama.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")).params
    batch = trainer.shard_batch(synthetic_batch(2, 32, cfg.vocab_size,
                                                seed=1, device="cpu"))
    loss, _, grads = trainer.grads(params, batch)
    return float(loss), [g.full_tensor() if mesh else g for g in grads]


def _worker(rank, root):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=WORLD)
    try:
        inputs = torch.load(os.path.join(root, "in.pt"))
        res = {"collectives": _collectives(rank)}
        for case in ATTN_CASES:
            res[case] = _attn_case(case, *inputs["attn"])
        for case in PIPE_CASES:
            res[case] = _pipe_case(case, *inputs[case])
        res["kv-whole"] = _kv_whole_grads(_mesh(dict(fsdp=1, tensor=2,
                                                     seq=2)))
        torch.save(res, os.path.join(root, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


class _Spawned:
    """Every case, running in WORLD processes."""

    def __init__(self, root):
        self.root = root
        self.ctx = mp.start_processes(_worker, args=(root,), nprocs=WORLD,
                                      join=False, start_method="spawn")
        self.deadline = time.monotonic() + SPAWN_TIMEOUT_S
        self.joined = False

    def result(self, rank=0):
        if not self.joined:
            while not self.ctx.join(timeout=max(
                    self.deadline - time.monotonic(), 0.1)):
                if time.monotonic() > self.deadline:
                    self.kill()
                    pytest.fail(f"gloo workers did not finish in "
                                f"{SPAWN_TIMEOUT_S} s")
            self.joined = True
        return torch.load(os.path.join(self.root, f"out{rank}.pt"))

    def kill(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq_parallel"))
    inputs = {"attn": [torch.from_numpy(a) for a in _attn_inputs()]}
    for case in PIPE_CASES:
        params, x = _pipe_inputs(case)
        inputs[case] = ({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x))
    torch.save(inputs, os.path.join(root, "in.pt"))
    s = _Spawned(root)
    try:
        yield s
    finally:
        s.kill()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the JAX side (pytest process) -------------------------------------------

def _jax_mesh(sizes):
    import jax

    from ray_tpu.parallel import MeshConfig, make_mesh

    return make_mesh(MeshConfig(**sizes), devices=jax.devices()[:WORLD])


def _jax_attention(case, q, k, v):
    """JAX's shard_map'd op: the output and the grads of sum(out**2)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from ray_tpu.ops.ring_attention import ring_attention, ulysses_attention
    from ray_tpu.util.jax_compat import shard_map

    impl, causal, sizes = ATTN_CASES[case]
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[impl]
    spec = P("fsdp", "seq")
    op = shard_map(functools.partial(fn, axis_name="seq", causal=causal),
                   mesh=_jax_mesh(sizes), in_specs=(spec,) * 3,
                   out_specs=spec, check_vma=False)
    with jax.default_matmul_precision("highest"):
        # The grads of sum(out**2): the vjp of 2 * out, one trace.
        out, vjp = jax.vjp(op, q, k, v)
        grads = vjp(2 * out)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_sequence_parallel_attention_matches_jax(spawned, case):
    got = spawned.result()[case]
    q, k, v = _attn_inputs()
    want_out, want_grads = _jax_attention(case, q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ref = mha_reference(tq, tk, tv, causal=ATTN_CASES[case][1])
    (ref ** 2).sum().backward()
    sizes = ATTN_CASES[case][2]
    assert got["local_seq"] == ATTN_SHAPE[1] // sizes["seq"]
    np.testing.assert_allclose(got["out"].numpy(), want_out, atol=1e-5,
                               rtol=0, err_msg=f"{case} out vs JAX")
    np.testing.assert_allclose(got["out"].numpy(), ref.detach().numpy(),
                               atol=1e-5, rtol=0,
                               err_msg=f"{case} out vs mha_reference")
    for name, g, w, r in zip("qkv", got["grads"], want_grads,
                             (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=f"{case} d{name} vs JAX")
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-4, rtol=0,
                                   err_msg=f"{case} d{name} vs one process")


def _jax_pipeline(case, params, x):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel.pipeline import pipelined

    sizes, _, _, micro, _, _ = PIPE_CASES[case]
    run = pipelined(lambda p, h: jnp.tanh(_stage_fn(p, h)),
                    _jax_mesh(sizes), num_microbatches=micro)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(lambda p: run(p, x), params)
        grads, = vjp(2 * out)
    return np.asarray(out), {k: np.asarray(g) for k, g in grads.items()}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_matches_sequential_and_jax(spawned, case):
    params, x = _pipe_inputs(case)
    want_out, want_grads = _jax_pipeline(case, params, x)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in
          params.items()}
    h = torch.from_numpy(x)
    for s in range(PIPE_CASES[case][1]):
        h = torch.tanh(_stage_fn({k: v[s] for k, v in tp.items()}, h))
    (h ** 2).sum().backward()
    for rank in range(WORLD):          # the output and grads on every rank
        got = spawned.result(rank)[case]
        np.testing.assert_allclose(got["out"].numpy(), h.detach().numpy(),
                                   atol=1e-5, rtol=0,
                                   err_msg=f"{case} out vs sequential")
        np.testing.assert_allclose(got["out"].numpy(), want_out, atol=1e-5,
                                   rtol=0, err_msg=f"{case} out vs JAX")
        for k in params:
            np.testing.assert_allclose(
                got["grads"][k].numpy(), tp[k].grad.numpy(), atol=1e-4,
                rtol=0, err_msg=f"{case} d{k} vs sequential")
            np.testing.assert_allclose(
                got["grads"][k].numpy(), want_grads[k], atol=1e-4, rtol=0,
                err_msg=f"{case} d{k} vs JAX")


def _jax_collectives():
    """Each collective under JAX's shard_map over seq=4 (row r on device
    r): the outputs and the grads, as [rank] arrays."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ray_tpu.util.jax_compat import shard_map

    mesh = _jax_mesh(dict(fsdp=1, seq=4))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((WORLD, 8, 4)).astype(np.float32)
    w = rng.standard_normal((WORLD, 8, 4)).astype(np.float32)

    def per_rank(fn):
        return shard_map(lambda a: fn(a[0])[None], mesh=mesh,
                         in_specs=P("seq"), out_specs=P("seq"),
                         check_vma=False)

    out = {}
    for name, perm in (("ring", RING_PERM), ("partial", PARTIAL_PERM)):
        op = per_rank(lambda a, perm=perm: jax.lax.ppermute(a, "seq", perm))
        out[f"ppermute-{name}"] = (op(x), jax.grad(
            lambda a, op=op: jnp.sum(op(a) * w))(x))
    op = per_rank(lambda a: jax.lax.all_to_all(a, "seq", 0, 1, tiled=True))
    out["all_to_all"] = (op(x), jax.grad(lambda a: jnp.sum(op(a) ** 2))(x))
    # psum to a value the same on every rank: one loss, counted once.
    total = shard_map(lambda a: jax.lax.psum(a[0], "seq"), mesh=mesh,
                      in_specs=P("seq"), out_specs=P())
    out["psum"] = (np.broadcast_to(total(x), x.shape), jax.grad(
        lambda a: jnp.sum(total(a) ** 2))(x))
    return {k: (np.asarray(a), np.asarray(b)) for k, (a, b) in out.items()}


def test_collectives_match_jax(spawned):
    want = _jax_collectives()
    for rank in range(WORLD):
        got = spawned.result(rank)["collectives"]
        assert (got["index"], got["size"]) == (rank, WORLD)
        assert got["dropped"] == (0, 1)
        assert got["dropped-ops"]
        for name, (w_val, w_grad) in want.items():
            val, grad = got[name]
            np.testing.assert_allclose(val.numpy(), w_val[rank], rtol=0,
                                       atol=1e-6, err_msg=f"{name} rank "
                                                          f"{rank}")
            np.testing.assert_allclose(grad.numpy(), w_grad[rank], rtol=0,
                                       atol=1e-5, err_msg=f"{name} grad, "
                                                          f"rank {rank}")


def test_ring_with_kv_heads_whole_matches_one_process(spawned):
    loss, grads = spawned.result()["kv-whole"]
    want_loss, want_grads = _kv_whole_grads()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


def test_ulysses_heads_must_divide_the_axis(spawned):
    # Ulysses splits Hq and Hkv over the axis (seq=4 here): 6 q heads or
    # 2 kv heads raise, as JAX's all_to_all would.
    assert spawned.result()["collectives"]["ulysses-refuses"]
