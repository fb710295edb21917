"""Port parity of the mesh and sharding rules (``ray_tpu_torch.parallel``)
against ``ray_tpu.parallel``: ``MeshConfig.resolve``, the rule table,
``logical_to_spec`` / ``tree_specs`` over the Llama params and the
trainer's ``_divisible_spec``; and the port's own mapping of a spec to
DTensor placements. No process is spawned: the mesh tests open a one-rank
gloo group in this process and close it again.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu import parallel as jpar
from ray_tpu.models import llama as jl
from ray_tpu.models import training as jt
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import mixtral as tmx
from ray_tpu_torch.models import training as tt
from ray_tpu_torch.parallel import sharding as tshd

CUSTOM_RULES = (("embed", None), ("mlp", ("fsdp", "tensor")),
                ("heads", "tensor"), ("kv_heads", None), ("vocab", "fsdp"),
                ("batch", "data"))


def _both(fn):
    """(result, None) or (None, error message) of ``fn()``."""
    try:
        return fn(), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("sizes,n", [
    ({}, 8), ({"data": 2}, 8), ({"data": 2, "fsdp": 2, "tensor": 2}, 8),
    ({"fsdp": -1, "tensor": 2}, 4), ({"data": -1, "fsdp": 2}, 4),
    ({"stage": 2, "expert": 2, "seq": 2, "fsdp": 1}, 8),
    ({"data": -1, "fsdp": -1}, 4),            # two wildcards
    ({"tensor": 3}, 4),                       # wildcard does not divide
    ({"data": 2, "fsdp": 2}, 8),              # fixed product != devices
])
def test_mesh_config_resolve_matches_jax(sizes, n):
    got = _both(lambda: tpar.MeshConfig(**sizes).resolve(n))
    want = _both(lambda: jpar.MeshConfig(**sizes).resolve(n))
    assert got == want
    assert list(tpar.MESH_AXES) == list(jpar.MESH_AXES)


def test_default_rules_are_jax_entry_for_entry():
    assert tpar.DEFAULT_RULES == jpar.DEFAULT_RULES


@pytest.mark.parametrize("rules", [None, CUSTOM_RULES, dict(CUSTOM_RULES)],
                         ids=["default", "custom", "custom-dict"])
def test_tree_specs_match_jax(rules):
    cfg = dict(num_kv_heads=2)
    got = tpar.tree_specs(tl.logical_axes(tl.LlamaConfig.tiny(**cfg)), rules)
    jrules = tuple(rules.items()) if isinstance(rules, dict) else rules
    want = jpar.tree_specs(jl.logical_axes(jl.LlamaConfig.tiny(**cfg)),
                           jrules)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    flat_got = {path: spec for path, spec in _paths(got)}
    assert len(flat_got) == len(flat_want) == 12
    for path, spec in flat_want.items():
        key = tuple(p.key for p in path)
        assert flat_got[key] == tuple(spec), key
    assert tpar.logical_to_spec(("batch", "seq", "act_heads", None)) == \
        tuple(jpar.logical_to_spec(("batch", "seq", "act_heads", None)))


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("sizes", [dict(fsdp=1, tensor=4),
                                   dict(fsdp=2, tensor=4),
                                   dict(fsdp=8)])
def test_divisible_spec_matches_jax(sizes):
    # 2 kv heads on tensor=4: wk/wv keep their kv-head dim replicated
    # while wq stays split; embed 64 splits 8 ways.
    cfg = dict(num_kv_heads=2)
    jmesh = jpar.make_mesh(jpar.MeshConfig(**sizes),
                           devices=jax.devices()[:int(np.prod(
                               list(sizes.values())))])
    jc, tc = jl.LlamaConfig.tiny(**cfg), tl.LlamaConfig.tiny(**cfg)
    shapes = dict(_paths(tl.param_shapes(tc)))
    jshapes = jax.eval_shape(lambda: jl.init_params(
        jc, jax.random.PRNGKey(0)))
    specs = dict(_paths(tpar.tree_specs(tl.logical_axes(tc))))
    for path, spec in specs.items():
        jshape = jshapes
        for k in path:
            jshape = jshape[k]
        assert shapes[path] == jshape.shape, path
        got = tt._divisible_spec(spec, shapes[path], sizes)
        want = jt._divisible_spec(jax.sharding.PartitionSpec(*spec),
                                  shapes[path], jmesh)
        assert got == tuple(want) + (None,) * (len(got) - len(want)), path
    if sizes.get("tensor") == 4:
        assert tt._divisible_spec(specs[("layers", "wk")],
                                  shapes[("layers", "wk")], sizes) == \
            (None, "fsdp", None, None)
        assert tt._divisible_spec(specs[("layers", "wq")],
                                  shapes[("layers", "wq")], sizes)[2] == \
            "tensor"


def test_spec_placements_one_per_mesh_dim():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "fsdp", "tensor"))
    place = tshd.spec_placements
    # A dim on two axes is Shard(d) on both, in MESH_AXES order.
    assert place((("data", "fsdp"), None), mesh) == (Shard(0), Shard(0),
                                                      Replicate())
    assert place(("tensor", "fsdp"), mesh) == (Replicate(), Shard(1),
                                               Shard(0))
    # Axes the mesh does not hold (size 1) drop out.
    assert place(("seq", "expert"), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="MESH_AXES order"):
        place((("fsdp", "data"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        place(("fsdp", "fsdp"), mesh)


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tpar.make_mesh(tpar.MeshConfig(), device_type="cpu")


def test_make_mesh_with_size_one_axes(one_rank_group):
    # Every axis of size 1: the mesh keeps one axis and still reports six.
    for cfg in (tpar.MeshConfig(), tpar.MeshConfig(
            data=1, fsdp=1, tensor=1, seq=1, expert=1, stage=1),
            tpar.MeshConfig(fsdp=1, tensor=-1)):
        mesh = tpar.make_mesh(cfg, device_type="cpu")
        assert mesh.size() == 1
        assert tpar.mesh_shape(mesh) == dict.fromkeys(tpar.MESH_AXES, 1)
        assert tl.mesh_shape(mesh) == tpar.mesh_shape(mesh)
        assert tpar.batch_axes(mesh) == []
        assert tpar.num_model_replicas(mesh) == 1
    assert tpar.mesh_shape(tpar.single_device_mesh("cpu")) == \
        dict.fromkeys(tpar.MESH_AXES, 1)
    # Mixtral runs on the mesh itself; a mapping of ones is one device.
    assert tmx._mesh(mesh) is mesh
    assert tmx._mesh(tpar.mesh_shape(mesh)) is None
    with pytest.raises(ValueError, match="needs 2 devices"):
        tpar.make_mesh(tpar.MeshConfig(data=2, fsdp=1), device_type="cpu")


def test_constrain_and_shard_tree(one_rank_group):
    mesh = tpar.make_mesh(device_type="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    assert tpar.constrain(x, None, "batch", "act_embed") is x
    with pytest.raises(TypeError, match="DTensor"):
        tpar.constrain(x, mesh, "batch", "act_embed")
    tree = tpar.shard_tree({"a": {"b": x}},
                           tpar.tree_shardings(mesh, {"a": {"b": (
                               "embed", None)}}), mesh)
    d = tree["a"]["b"]
    assert isinstance(d, DTensor) and tuple(d.placements) == (Shard(0),)
    assert torch.equal(d.full_tensor(), x)
    y = tpar.constrain(d, mesh, None, None)
    assert tuple(y.placements) == (Replicate(),)
    assert torch.equal(y.full_tensor(), x)


@pytest.mark.parametrize("remat", [None, "full", "mlp_only"])
def test_one_rank_mesh_step_equals_one_device_step(one_rank_group, remat):
    # The mesh path on a one-rank mesh: DTensor params, moments and batch,
    # attention and the LM head through local_map, the same loss, grad
    # norm and params as the one-device step; under each kind of remat
    # policy ("mlp_only" saves checkpoint_name's outputs, a custom op
    # DTensor takes through its registered sharding).
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, remat=remat is not None,
                             remat_policy=remat or "full")
    mesh = tpar.make_mesh(device_type="cpu")
    one = tt.ShardedTrainer(tc, device="cpu")
    sharded = tt.ShardedTrainer(tc, mesh, rules=tpar.DEFAULT_RULES)
    s1, s2 = one.init_state(0), sharded.init_state(0)
    assert isinstance(s2.params["layers"]["wq"], DTensor)
    batch = tt.synthetic_batch(4, 16, tc.vocab_size, device="cpu")
    for _ in range(2):
        s1, m1 = one.train_step(s1, batch)
        s2, m2 = sharded.train_step(s2, batch)
        assert not isinstance(m2["loss"], DTensor)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m2["grad_norm"]),
                                   float(m1["grad_norm"]), rtol=1e-6)
    for (name, a), b in zip(_paths(s1.params), tt._leaves(s2.params)):
        torch.testing.assert_close(b.full_tensor(), a, rtol=1e-6, atol=1e-7,
                                   msg=str(name))
    # Ring attention on a mesh without a seq axis is a ring of one: the
    # flash path's logits.
    tokens = sharded.shard_batch(batch)["tokens"]
    torch.testing.assert_close(
        tl.forward(s2.params, tokens, dataclasses.replace(
            tc, attention="ring"), mesh).full_tensor(),
        tl.forward(s2.params, tokens, tc, mesh).full_tensor(),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="DTensor"):
        tl.forward(s1.params, batch["tokens"], tc, mesh)
