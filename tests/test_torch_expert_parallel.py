"""Port parity of expert parallelism: the tiny fp32 Mixtral's loss and
grads on gloo CPU meshes with an ``expert`` axis
(``ray_tpu_torch.ops.moe.moe_layer`` through ``mixtral.loss_fn``)
against the one-process port and the JAX package's sharded run on the
same mesh shape of CPU devices. ``graft`` is ``__graft_entry__.py``'s
expert-parallel dry run as written (X=2, k=1, ``MeshConfig(expert=2,
fsdp=-1)``, tokens (2, 32), capacity 1.25); every other case runs at a
capacity factor of 0.5, so pairs drop on every layer.

One module-scoped spawn of 4 gloo processes runs every case
(``init_method="file://"`` under a temp dir, one torch thread each);
JAX and the one-process port run in the pytest process meanwhile. The
weights are a JAX init carried across, the tokens seeded numpy; JAX's
matmul precision is "highest". The workers import torch and the port
only.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 4
SPAWN_TIMEOUT_S = 300
TOKENS = (2, 32)
# name -> (mesh sizes, MixtralConfig.tiny overrides). "expert2" is a
# two-rank mesh: the world's pairs of ranks each run it.
CASES = {
    "graft": (dict(expert=2, fsdp=-1), dict(num_experts=2, top_k=1)),
    "graft-drop": (dict(expert=2, fsdp=-1),
                   dict(num_experts=2, top_k=1, capacity_factor=0.5)),
    "expert2": (dict(expert=2, fsdp=1), dict(capacity_factor=0.5)),
    "expert4-remat": (dict(expert=4, fsdp=1),
                      dict(capacity_factor=0.5, remat=True)),
    "expert2-tensor2": (dict(expert=2, tensor=2, fsdp=1),
                        dict(capacity_factor=0.5)),
    "expert2-seq2-ring": (dict(expert=2, seq=2, fsdp=1),
                          dict(capacity_factor=0.5)),
}
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5     # of each grad leaf's largest entry


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _tokens():
    return np.random.default_rng(3).integers(0, 256, TOKENS).astype(
        np.int32)


def _port_config(case):
    from ray_tpu_torch.models import mixtral

    return mixtral.MixtralConfig.tiny(dtype=torch.float32, **CASES[case][1])


class _Recorder:
    """Each MoE layer's (dropped fraction, aux loss), and each expert
    product's (experts in the buffer, experts in w_gate), patched into
    the port's modules."""

    def __init__(self):
        from ray_tpu_torch.models import mixtral
        from ray_tpu_torch.ops import moe

        self.layers, self.products = [], []
        self._saved = [(mixtral, "moe_layer", mixtral.moe_layer),
                       (moe, "_experts", moe._experts)]
        layer, experts = mixtral.moe_layer, moe._experts

        def local(t):
            t = t.detach()
            return float(t.to_local() if hasattr(t, "to_local") else t)

        def moe_layer(*a, **kw):
            out, aux = layer(*a, **kw)
            self.layers.append((local(aux["dropped_fraction"]),
                                local(aux["aux_loss"])))
            return out, aux

        def products(buf, w_gate, *rest):
            self.products.append((buf.shape[0], w_gate.shape[0]))
            return experts(buf, w_gate, *rest)

        mixtral.moe_layer, moe._experts = moe_layer, products

    def restore(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


# -- the workers (torch and the port only) -----------------------------------

def _case_mesh(case):
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    sizes = CASES[case][0]
    if case == "expert2":
        return init_device_mesh("cpu", (WORLD // 2, 2), mesh_dim_names=(
            "pair", "expert"))["expert"]
    return make_mesh(MeshConfig(**sizes), device_type="cpu")


def _mesh_case(case, params, tokens):
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel import shard_tree, tree_shardings
    from ray_tpu_torch.parallel.sharding import placements_for

    cfg = _port_config(case)
    mesh = _case_mesh(case)
    placed = shard_tree(params, tree_shardings(
        mesh, mixtral.logical_axes(cfg)), mesh)
    names = [n for n, _ in _named_leaves(placed)]
    leaves = [p.requires_grad_(True) for _, p in _named_leaves(placed)]
    toks = distribute_tensor(tokens, mesh, placements_for(
        mesh, tokens.shape, "batch", "seq"))
    rec = _Recorder()
    try:
        loss, metrics = mixtral.loss_fn(placed, {"tokens": toks}, cfg,
                                        mesh)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        rec.restore()
    return dict(loss=float(loss.full_tensor()),
                aux=float(metrics["aux_loss"].full_tensor()),
                grads={n: g.full_tensor() for n, g in zip(names, grads)},
                layers=rec.layers, products=rec.products,
                mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)))


def _worker(rank, root):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=WORLD)
    try:
        inputs = torch.load(os.path.join(root, "in.pt"))
        res = {case: _mesh_case(case, *inputs[case]) for case in CASES}
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


# -- the pytest process: inputs, JAX, the one-process port -------------------

def _jax_config(case):
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jmx

    return jmx.MixtralConfig.tiny(dtype=jnp.float32, **CASES[case][1])


def _jax_params(case):
    import jax

    from ray_tpu.models import mixtral as jmx

    return jax.device_get(jax.jit(jmx.init_params, static_argnums=0)(
        _jax_config(case), jax.random.PRNGKey(2)))


@pytest.fixture(scope="module")
def inputs():
    from ray_tpu_torch.models import mixtral

    tokens = torch.from_numpy(_tokens())
    return {case: (mixtral.params_from_numpy(_jax_params(case), "cpu"),
                   tokens) for case in CASES}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    root = str(tmp_path_factory.mktemp("expert_parallel"))
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


def _one_process(case, inputs):
    from ray_tpu_torch.models import mixtral

    params, tokens = inputs[case]
    params = {k: ({n: t.clone() for n, t in v.items()}
                  if isinstance(v, dict) else v.clone())
              for k, v in params.items()}
    names = [n for n, _ in _named_leaves(params)]
    leaves = [p.requires_grad_(True) for _, p in _named_leaves(params)]
    rec = _Recorder()
    try:
        loss, _ = mixtral.loss_fn(params, {"tokens": tokens},
                                  _port_config(case))
        grads = torch.autograd.grad(loss, leaves)
    finally:
        rec.restore()
    return float(loss), dict(zip(names, grads)), rec.layers


def _jax_sharded(case):
    """JAX's loss and grads with the params placed by the rules on the
    case's mesh shape of CPU devices (``__graft_entry__.py``'s way)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import mixtral as jmx
    from ray_tpu.parallel import MeshConfig, make_mesh, tree_shardings

    sizes = CASES[case][0]
    n = WORLD if -1 in sizes.values() else int(np.prod(list(
        sizes.values())))
    mesh = make_mesh(MeshConfig(**sizes), devices=jax.devices()[:n])
    jc = _jax_config(case)
    params = jax.device_put(_jax_params(case),
                            tree_shardings(mesh, jmx.logical_axes(jc)))
    toks = jnp.asarray(_tokens())

    def loss(p):
        return jmx.loss_fn(p, {"tokens": toks}, jc, mesh)[0]

    with mesh, jax.default_matmul_precision("highest"):
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    grads = jax.device_get(grads)
    return float(value), {n: np.asarray(g) for n, g in
                          _named_leaves(grads)}


def _close_grads(got, want, what):
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        gap = np.abs(np.asarray(g) - w).max() / max(np.abs(w).max(), 1e-30)
        assert gap <= GRAD_TOL, f"{what}: grad {name} off by {gap:.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_one_process_and_jax(spawned, inputs, case):
    got = spawned.result()[case]
    want_loss, want_grads, _ = _one_process(case, inputs)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=LOSS_RTOL,
                               atol=0)
    _close_grads(got["grads"], {n: g.numpy() for n, g in
                                want_grads.items()}, f"{case} vs one process")
    jax_loss, jax_grads = _jax_sharded(case)
    np.testing.assert_allclose(got["loss"], jax_loss, rtol=LOSS_RTOL,
                               atol=0)
    _close_grads(got["grads"], jax_grads, f"{case} vs JAX sharded")
    sizes = {k: v for k, v in CASES[case][0].items() if v > 1}
    assert all(got["mesh"][k] == v for k, v in sizes.items())


@pytest.mark.parametrize("case", list(CASES))
def test_drops_and_aux_match_one_device_per_layer(spawned, inputs, case):
    """Each layer's dropped fraction equals one device's (the same pairs
    drop: the slots run over the global token order), its aux loss
    agrees, and below a capacity factor of 1 pairs do drop."""
    _, _, want = _one_process(case, inputs)
    cfg = _port_config(case)
    # Under remat the backward's replay of a layer stops once it has
    # what the backward needs, before the layer returns: no record.
    assert len(want) == cfg.num_layers
    for rank in range(WORLD):
        got = spawned.result(rank)[case]["layers"]
        assert len(got) == len(want)
        for (d, a), (wd, wa) in zip(got, want):
            assert d == wd
            np.testing.assert_allclose(a, wa, rtol=LOSS_RTOL, atol=0)
    if cfg.capacity_factor < 1:
        assert all(d > 0 for d, _ in want)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_runs_only_its_experts(spawned, case):
    """Every expert product on every rank takes X / expert experts,
    those the rank holds."""
    cfg = _port_config(case)
    ep = CASES[case][0]["expert"]
    for rank in range(WORLD):
        products = spawned.result(rank)[case]["products"]
        assert products
        assert all(p == (cfg.num_experts // ep,) * 2 for p in products)


def test_mapping_of_sizes_and_other_meshes_raise():
    """Mixtral refuses a mapping of sizes with an axis > 1 and a mesh
    argument that is neither None nor a DeviceMesh."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.ops import moe

    cfg = _port_config("expert2")
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="make_mesh"):
        mixtral.loss_fn(params, {"tokens": tokens}, cfg, mesh={"expert": 2})
    layer = {k: params["layers"][f"moe_{k[2:]}" if k != "w_router" else k][0]
             for k in ("w_router", "w_gate", "w_up", "w_down")}
    with pytest.raises(TypeError, match="DeviceMesh"):
        moe.moe_layer(torch.zeros((1, 4, cfg.hidden_size)), layer,
                      num_experts=cfg.num_experts, mesh={"expert": 1})
