"""The port's checkpoint plane (``ray_tpu_torch.checkpoint``): the
runtime-free cases of ``tests/test_checkpoint_plane.py`` (roundtrip, an
async save that does not block, a crash mid-write that stays invisible,
the two-phase commit's last arrival, retention, list and inspect), the
fallback past a corrupt shard, a checkpoint the JAX package's plane
wrote (``ray_tpu.models.training.ShardedTrainer.save_state``) restored
bit for bit and stepped on, and a save on 2 gloo ranks restored on 1
and on 4 with a ``TCPStore`` KV.

The gloo cases run in one module-scoped spawn of 4 processes
(``init_method="file://"`` under a temp dir, one torch thread each),
which import torch and the port only.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ray_tpu_torch.checkpoint import (CheckpointPlane, DictKV, inspect_dir,
                                      list_checkpoints, list_manifests_kv,
                                      load_latest, train_state_paths)
from ray_tpu_torch.checkpoint import plane as plane_mod
from ray_tpu_torch.exceptions import CheckpointCorruptError

WORLD = 4
SPAWN_TIMEOUT_S = 300


def _state(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 8), generator=gen),
            "b": torch.ones((8,), dtype=torch.bfloat16),
            "step": np.int32(seed)}


def _assert_tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.fixture(params=["filesystem", "dict"])
def kv(request):
    return None if request.param == "filesystem" else {}


# ------------------------------------------------------------ core plane

def test_save_restore_roundtrip(tmp_path, kv):
    plane = CheckpointPlane(str(tmp_path), run="r1", process_index=0,
                            process_count=1, kv=kv)
    state = _state(3)
    res = plane.save_async(3, state).result()
    assert res["committed"] is True and res["bytes"] == 16 * 8 * 4 + 16 + 4
    assert plane.steps() == [3]
    _assert_tree_equal(state, plane.restore())
    assert plane.last_restore["step"] == 3
    # Standalone filesystem readers see it too.
    _assert_tree_equal(state, load_latest(str(tmp_path)))
    assert [m["step"] for m in list_checkpoints(str(tmp_path))] == [3]
    if kv is not None:
        assert [m["step"] for m in list_manifests_kv(kv)] == [3]
    plane.close()


def test_async_save_does_not_block_step_loop(tmp_path, monkeypatch):
    """The step loop only pays the host snapshot: a slow write (the
    background leg) must not delay save_async's return."""
    orig = CheckpointPlane._write_shard_files

    def slow_write(self, *a, **kw):
        time.sleep(0.6)
        return orig(self, *a, **kw)

    monkeypatch.setattr(CheckpointPlane, "_write_shard_files", slow_write)
    plane = CheckpointPlane(str(tmp_path), run="async", process_index=0,
                            process_count=1)
    state = _state()
    t0 = time.perf_counter()
    handle = plane.save_async(1, state)
    handoff_s = time.perf_counter() - t0
    assert handoff_s < 0.4, "save_async blocked on the background write"
    assert not handle.done()
    assert plane.steps() == []  # not yet committed: invisible
    # The snapshot is a copy: the state changing now is not saved.
    state["w"].add_(1.0)
    res = handle.result()
    assert res["committed"] is True and res["save_s"] >= 0.6
    assert handle.blocked_ms / 1000.0 < 0.4
    _assert_tree_equal(_state(), plane.restore())
    plane.close()


def test_crash_mid_write_leaves_no_visible_checkpoint(tmp_path,
                                                      monkeypatch):
    def broken_write(self, *a, **kw):
        raise OSError("disk died mid-checkpoint")

    monkeypatch.setattr(CheckpointPlane, "_write_shard_files",
                        broken_write)
    plane = CheckpointPlane(str(tmp_path), run="crash", process_index=0,
                            process_count=1)
    handle = plane.save_async(5, _state())
    with pytest.raises(OSError):
        handle.result()
    assert plane.steps() == []
    with pytest.raises(FileNotFoundError):
        plane.restore()
    # The invisible half-written dir is garbage-collected.
    removed = plane.gc(grace_s=-1.0)
    assert any("step-0000000005" in d for d in removed)
    assert not os.path.exists(plane.step_dir(5))


def test_two_phase_commit_last_arrival_flips_manifest(tmp_path, kv):
    """A step is invisible until every participant registered; the last
    arrival commits the manifest once."""
    state = _state()
    p0 = CheckpointPlane(str(tmp_path), run="2pc", process_index=0,
                         process_count=2, kv=kv)
    p1 = CheckpointPlane(str(tmp_path), run="2pc", process_index=1,
                         process_count=2, kv=kv)
    assert p0.save(7, state)["committed"] is False
    assert p0.steps() == [] and p1.steps() == []  # half-written
    assert p1.save(7, state)["committed"] is True
    assert p0.steps() == [7] and p1.steps() == [7]
    manifest = p0.manifest(7)
    assert manifest["nprocs"] == 2 and manifest["committed_by"] == 1
    assert manifest["shards"] == ["shard-00000-of-00002.npz",
                                  "shard-00001-of-00002.npz"]
    _assert_tree_equal(state, p0.restore())
    p0.close()
    p1.close()


def test_retention_gc_drops_oldest_committed(tmp_path, kv):
    plane = CheckpointPlane(str(tmp_path), run="keep", keep=2,
                            process_index=0, process_count=1, kv=kv)
    for step in (1, 2, 3):
        plane.save(step, _state(step))
    plane.gc()
    assert plane.steps() == [2, 3]
    if kv is not None:
        assert not any("/0000000001/" in k for k in kv)
    plane.close()


def test_list_and_inspect(tmp_path):
    plane = CheckpointPlane(str(tmp_path), run="cli", process_index=0,
                            process_count=1)
    plane.save(9, _state())
    plane.close()
    (m,) = list_checkpoints(str(tmp_path))
    assert m["run"] == "cli" and m["step"] == 9 and m["nprocs"] == 1
    info = inspect_dir(plane.step_dir(9))
    assert info["committed"] and info["num_shard_files"] == 1
    by_dtype = {leaf["dtype"]: leaf for leaf in info["leaves"]}
    assert by_dtype["bfloat16"] == dict(shape=[8], dtype="bfloat16",
                                        shards=1, bytes=16)
    assert by_dtype["int32"]["shape"] == []
    # The tree file names each leaf's key path in the files' order.
    with open(os.path.join(plane.step_dir(9), plane_mod.TREE_FILE)) as f:
        assert json.load(f) == {"kind": "tree",
                                "paths": [["b"], ["step"], ["w"]]}


def test_corrupt_shard_falls_back_and_explicit_step_raises(tmp_path):
    plane = CheckpointPlane(str(tmp_path), run="rot", process_index=0,
                            process_count=1)
    plane.save(1, _state(1))
    plane.save(2, _state(2))
    shard = os.path.join(plane.step_dir(2), "shard-00000-of-00001.npz")
    with open(shard, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    _assert_tree_equal(_state(1), plane.restore())
    assert plane.last_restore["step"] == 1
    _assert_tree_equal(_state(1), load_latest(str(tmp_path), run="rot"))
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        plane.restore(step=2)
    plane.close()


def test_dict_kv_put_without_overwrite_has_one_winner():
    kv = DictKV()
    assert kv.put("a/MANIFEST", b"1", overwrite=False)
    assert not kv.put("a/MANIFEST", b"2", overwrite=False)
    assert kv.get("a/MANIFEST") == b"1" and kv.list("a/") == ["a/MANIFEST"]
    kv.delete("a/MANIFEST")
    assert kv.get("a/MANIFEST") is None and kv.list("") == []


def test_train_state_paths_match_jax_flatten():
    """The leaf-order table against ``tree_flatten_with_path`` of a real
    JAX ``TrainState`` from ``default_optimizer``."""
    import jax

    from ray_tpu.models import llama as jl
    from ray_tpu.models import training as jt
    from ray_tpu.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.models import llama as tl

    jc = jl.LlamaConfig.tiny(num_layers=1)
    trainer = jt.ShardedTrainer(jc, make_mesh(MeshConfig(fsdp=1),
                                              devices=jax.devices()[:1]))
    state = jax.eval_shape(lambda: trainer.init_state(0))
    def part(k):    # a dict key, a sequence index or a field name
        return getattr(k, "key", getattr(k, "idx", getattr(k, "name",
                                                           None)))

    got = []
    for path, _ in jax.tree_util.tree_flatten_with_path(state)[0]:
        parts = [part(k) for k in path]
        top = ("step", "params", "opt_state")[parts[0]]
        if top != "opt_state":
            got.append((top,) + tuple(parts[1:]))
        elif parts[1:3] == [1, 2]:
            # opt_state is (clip's EmptyState, (Adam's state, the weight
            # decay's EmptyState, the schedule's state)).
            got.append(("opt_state", "schedule_count"))
        else:
            assert parts[1:3] == [1, 0]
            got.append(("opt_state",) + tuple(parts[3:]))
    want = train_state_paths(plane_mod.key_paths(tl.param_shapes(
        tl.LlamaConfig.tiny(num_layers=1))))
    assert got == want


# ------------------------------------------- a checkpoint JAX wrote

def _jax_saved(tmp_path, dtype_name):
    """A JAX trainer's state after one step, saved by the JAX plane:
    (JAX state, its next step's loss, the batch, the config pair)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.checkpoint import CheckpointPlane as JaxPlane
    from ray_tpu.models import llama as jl
    from ray_tpu.models import training as jt
    from ray_tpu.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.models import llama as tl

    jc = jl.LlamaConfig.tiny(dtype=getattr(jnp, dtype_name))
    tc = tl.LlamaConfig.tiny(dtype=getattr(torch, dtype_name))
    opt = dict(warmup_steps=2, total_steps=50, learning_rate=1e-2)
    trainer = jt.ShardedTrainer(jc, make_mesh(
        MeshConfig(fsdp=1), devices=jax.devices()[:1]),
        optimizer=jt.default_optimizer(**opt))
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (4, 32))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "mask": jnp.ones((4, 32), jnp.int32)}
    with jax.default_matmul_precision("highest"):
        state = trainer.init_state(0)
        state, _ = trainer.train_step(state, batch)
        plane = JaxPlane(str(tmp_path), run="jax", process_index=0,
                         process_count=1)
        assert trainer.save_state(plane, state).result()["committed"]
        plane.close()
        saved = jax.device_get(state)
        _, metrics = trainer.train_step(state, batch)
    return saved, float(metrics["loss"]), tokens, tc, opt


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_restores_a_jax_checkpoint_bit_for_bit(tmp_path, dtype_name):
    from ray_tpu_torch.models import training as tt

    saved, next_loss, tokens, tc, opt = _jax_saved(tmp_path, dtype_name)
    assert not os.path.exists(os.path.join(
        tmp_path, "jax", "step-0000000001", plane_mod.TREE_FILE))
    trainer = tt.ShardedTrainer(tc, device="cpu",
                                optimizer=tt.default_optimizer(**opt))
    got = trainer.restore_state(CheckpointPlane(str(tmp_path), run="jax"))
    adam = saved.opt_state[1][0]
    assert got.step == int(saved.step) == 1
    assert got.opt_state.count == int(adam.count) == 1
    names = plane_mod.key_paths(got.params)

    def bits(t):    # bf16 compared as its int16 bits
        if isinstance(t, torch.Tensor):
            t = t.detach()
            return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        t = np.asarray(t)
        return torch.from_numpy((t.view(np.int16) if t.dtype.itemsize == 2
                                 else t).copy())

    for path, p, mu, nu in zip(names, tt._leaves(got.params),
                               got.opt_state.mu, got.opt_state.nu):
        for mine, theirs in ((p, saved.params), (mu, adam.mu),
                             (nu, adam.nu)):
            want = plane_mod.at_path(theirs, path)
            assert mine.dtype == getattr(torch, dtype_name)
            assert torch.equal(bits(mine), bits(want)), path
    if dtype_name == "float32":
        # One port step from the restored state: JAX's next loss.
        batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)),
                 "mask": torch.ones((4, 32), dtype=torch.int32)}
        _, metrics = trainer.train_step(got, batch)
        np.testing.assert_allclose(float(metrics["loss"]), next_loss,
                                   rtol=1e-5)


def test_jax_leaf_paths_tell_a_state_from_bare_params():
    from ray_tpu_torch.models import llama as tl

    params = plane_mod.key_paths(tl.param_shapes(
        tl.LlamaConfig.tiny(num_layers=1)))
    n = len(params)
    assert plane_mod.jax_leaf_paths(params, n) == sorted(params)
    assert plane_mod.jax_leaf_paths(params, 3 * n + 3) == \
        train_state_paths(params)
    with pytest.raises(ValueError, match="neither"):
        plane_mod.jax_leaf_paths(params, n + 1)


def test_jax_checkpoint_needs_its_leaf_paths(tmp_path):
    _jax_saved(tmp_path, "float32")
    plane = CheckpointPlane(str(tmp_path), run="jax")
    with pytest.raises(ValueError, match="paths="):
        plane.restore(step=1)


# ------------------------------------------- 2 gloo ranks, then 4

RESTORE_LAYOUTS = {"fsdp4": dict(fsdp=4), "fsdp2_tp2": dict(fsdp=2,
                                                           tensor=2)}


def _tiny():
    from ray_tpu_torch.models import llama as tl

    return tl.LlamaConfig.tiny(dtype=torch.float32)


def _trainer(mesh=None):
    from ray_tpu_torch.models import training as tt

    return tt.ShardedTrainer(
        _tiny(), mesh, device=None if mesh is not None else "cpu",
        optimizer=tt.default_optimizer(warmup_steps=2, total_steps=50,
                                       learning_rate=1e-2))


def _batch():
    from ray_tpu_torch.models.training import synthetic_batch

    return synthetic_batch(8, 32, 256, seed=1, device="cpu")


def _full_leaves(state):
    from ray_tpu_torch.models.training import _leaves

    # Copies: a step updates the state in place.
    return [(t.full_tensor() if hasattr(t, "full_tensor") else t)
            .detach().clone() for t in _leaves(state.params) + state.opt_state.mu
            + state.opt_state.nu]


def _store(rank):
    import torch.distributed as dist

    port = [None]
    if rank == 0:
        store = dist.TCPStore("localhost", 0, WORLD, True,
                              wait_for_workers=False)
        port = [store.port]
    dist.broadcast_object_list(port, src=0)
    if rank:
        store = dist.TCPStore("localhost", port[0], WORLD, False)
    return store


def _worker(rank, root):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.checkpoint import StoreKV
    from ray_tpu_torch.models import training as tt
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=WORLD)
    try:
        store = _store(rank)
        kv = StoreKV(store)
        res = {}
        # Every rank races one commit: exactly one wins.
        won = kv.put("race@0/0000000001/MANIFEST", f"{rank}".encode(),
                     overwrite=False)
        wins = [None] * WORLD
        dist.all_gather_object(wins, won)
        res["winners"] = sum(wins)
        # One step on one device (the same on every rank), its state
        # placed on a two-rank mesh and saved there by ranks 0 and 1.
        one = _trainer()
        state, _ = one.train_step(one.init_state(0), _batch())
        res["want"] = _full_leaves(state)
        _, m = one.train_step(_copy(state), _batch())
        res["next_loss"] = float(m["loss"])
        pair = init_device_mesh("cpu", (WORLD // 2, 2),
                                mesh_dim_names=("pair", "fsdp"))
        two = _trainer(pair["fsdp"])

        def place(t, pl):
            return distribute_tensor(t, two.mesh, pl)

        from ray_tpu_torch.parallel.sharding import tree_map

        params = tree_map(place, state.params, two.param_placements)
        pls = [plane_mod.at_path(two.param_placements, p)
               for p in plane_mod.key_paths(state.params)]
        sharded = tt.TrainState(step=state.step, params=params,
                                opt_state=tt.OptState(
            count=state.opt_state.count,
            mu=[place(t, pl) for t, pl in zip(state.opt_state.mu, pls)],
            nu=[place(t, pl) for t, pl in zip(state.opt_state.nu, pls)]))
        if pair.get_local_rank("pair") == 0:
            plane = CheckpointPlane(
                os.path.join(root, "ckpt"), run="two", kv=kv,
                process_index=pair.get_local_rank("fsdp"), process_count=2)
            res["saved"] = two.save_state(plane, sharded).result()
            plane.close()
        dist.barrier()
        # Restored on four ranks, on two layouts, and stepped there.
        for name, sizes in RESTORE_LAYOUTS.items():
            four = _trainer(make_mesh(MeshConfig(**sizes),
                                      device_type="cpu"))
            plane = _plane(root, kv)
            got = four.restore_state(plane)
            plane.close()
            local = got.params["layers"]["wq"]
            res[name] = dict(
                leaves=_full_leaves(got), step=got.step,
                count=got.opt_state.count,
                local_wq=tuple(local.to_local().shape),
                placements=[str(p) for p in local.placements])
            _, m = four.train_step(got, _batch())
            res[name]["next_loss"] = float(m["loss"])
        torch.save(res, os.path.join(root, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _plane(root, kv=None):
    return CheckpointPlane(os.path.join(root, "ckpt"), run="two", kv=kv)


def _copy(state):
    from ray_tpu_torch.models import training as tt

    return tt.TrainState(step=state.step, params=tt._unflatten(
        state.params, [p.detach().clone().requires_grad_(True)
                       for p in tt._leaves(state.params)]),
        opt_state=tt.OptState(state.opt_state.count,
                              [t.clone() for t in state.opt_state.mu],
                              [t.clone() for t in state.opt_state.nu]))


class _Spawned:
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
    s = _Spawned(str(tmp_path_factory.mktemp("checkpoint")))
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


def test_store_kv_commit_has_exactly_one_winner(spawned):
    assert all(spawned.result(r)["winners"] == 1 for r in range(WORLD))
    saved = [spawned.result(r).get("saved") for r in range(WORLD)]
    assert [s is not None for s in saved] == [True, True, False, False]
    # The two-phase commit over the TCPStore: one of the two savers
    # arrived last and committed; each wrote its own shard.
    assert sorted(s["committed"] for s in saved[:2]) in ([False, True],
                                                         [True, True])
    assert {s["shard"] for s in saved[:2]} == {"shard-00000-of-00002",
                                               "shard-00001-of-00002"}


@pytest.mark.parametrize("layout", ["one"] + list(RESTORE_LAYOUTS))
def test_two_rank_save_restores_on_one_and_four(spawned, layout):
    out = spawned.result(0)
    want = out["want"]
    if layout == "one":
        trainer = _trainer()
        got = trainer.restore_state(_plane(spawned.root))
        leaves, step, count = _full_leaves(got), got.step, \
            got.opt_state.count
        _, m = trainer.train_step(got, _batch())
        next_loss = float(m["loss"])
        manifest = _plane(spawned.root).manifest(1)
        assert manifest["nprocs"] == 2 and len(manifest["shards"]) == 2
    else:
        res = [spawned.result(r)[layout] for r in range(WORLD)]
        leaves, step, count = res[0]["leaves"], res[0]["step"], \
            res[0]["count"]
        next_loss = res[0]["next_loss"]
        # Each rank holds its shard of the new layout.
        sizes = RESTORE_LAYOUTS[layout]
        assert res[0]["local_wq"][1] == 64 // sizes["fsdp"]
        assert all(r["next_loss"] == next_loss for r in res)
    assert step == 1 and count == 1
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_allclose(next_loss, out["next_loss"], rtol=1e-6)
