"""Port parity: ``ray_tpu_torch.models.mixtral`` against
``ray_tpu.models.mixtral``.

Both packages get the same weights (a JAX init carried across through
``mixtral.params_from_numpy``, each leaf in its own dtype) and the same
tokens (numpy, seeded). fp32 runs with JAX's matmul precision at
"highest". ``MixtralConfig.tiny`` (head_dim 16) takes the plain
attention in both packages; the head_dim-128 config takes the flash
path, JAX's Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import mixtral as jmx
from ray_tpu.models import training as jt
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import mixtral as tmx
from ray_tpu_torch.models import training as tt
from ray_tpu_torch.ops import attention as ta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


FLASH = dict(vocab_size=256, hidden_size=128, intermediate_size=96,
             num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
             max_seq_len=128)
CONFIGS = {"tiny": {}, "flash": FLASH}


def _configs(name="tiny", **kw):
    kw = dict(CONFIGS[name], **kw)
    return (jmx.MixtralConfig.tiny(dtype=jnp.float32, **kw),
            tmx.MixtralConfig.tiny(dtype=torch.float32, **kw))


def _jax_init(jc, seed):
    # jit: one compile, where eager JAX compiles op by op.
    return jax.device_get(jax.jit(jmx.init_params, static_argnums=0)(
        jc, jax.random.PRNGKey(seed)))


def _params(jc, seed=0):
    jp = _jax_init(jc, seed)
    return jp, tmx.params_from_numpy(jp, "cpu")


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _torch_grads(tp, tokens, tc):
    names = [n for n, _ in _named_leaves(tp)]
    leaves = [p.requires_grad_(True) for _, p in _named_leaves(tp)]
    loss, metrics = tmx.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, tc)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, dict(zip(names, grads))


# -- configuration and layout ----------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "mixtral_8x7b"])
def test_configs_layout_and_counts_match_jax(preset):
    jc = getattr(jmx.MixtralConfig, preset)()
    tc = getattr(tmx.MixtralConfig, preset)()
    for f in dataclasses.fields(jc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.dtype == torch.bfloat16
    assert tmx.logical_axes(tc) == jmx.logical_axes(jc)
    assert tmx.num_params(tc) == jmx.num_params(jc)
    assert tmx.active_params(tc) == jmx.active_params(jc)
    assert tmx.active_params(tc) < tmx.num_params(tc)
    bb = dataclasses.replace(tc, attention_kernel=False).backbone()
    assert isinstance(bb, tl.LlamaConfig) and bb.attention_kernel is False
    assert (bb.rope_theta, bb.rms_eps, bb.remat) == (jc.rope_theta,
                                                     jc.rms_eps, jc.remat)


def test_init_params_layout_and_leaf_count():
    jc, tc = _configs()
    tp = tmx.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    want = dict(_named_leaves(jax.eval_shape(
        lambda: jmx.init_params(jc, jax.random.PRNGKey(0)))))
    got = dict(_named_leaves(tp))
    assert list(got) == list(_named_leaves_order(jc))
    for name, a in got.items():
        assert tuple(a.shape) == tuple(want[name].shape), name
        assert str(a.dtype).split(".")[-1] == str(want[name].dtype), name
    assert sum(t.numel() for t in got.values()) == tmx.num_params(tc)
    bf = tmx.init_params(tmx.MixtralConfig.tiny(),
                         torch.Generator().manual_seed(0), "cpu")
    assert bf["layers"]["w_router"].dtype == torch.float32
    assert bf["layers"]["moe_gate"].dtype == torch.bfloat16
    # normal * fan_in^-0.5: moe_down's fan-in is the expert width 96.
    assert abs(float(bf["layers"]["moe_down"].float().std())
               - 96 ** -0.5) < 5e-3
    if not torch.cuda.is_available():
        # Entry points run on cuda unless asked: no silent CPU fallback.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmx.init_params(tc)


def _named_leaves_order(jc):
    # JAX's init builds the layer dict as the backbone's less the dense
    # MLP, then the router and the experts: the port keeps that order.
    layer = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_router",
             "moe_gate", "moe_up", "moe_down"]
    return (["embed"] + [f"layers.{k}" for k in layer]
            + ["final_norm", "lm_head"])


def test_bf16_jax_tree_converts_leaf_for_leaf():
    jp = _jax_init(jmx.MixtralConfig.tiny(), 3)
    tp = tmx.params_from_numpy(jp, "cpu")
    for (name, a), (_, b) in zip(_named_leaves(jp), _named_leaves(tp)):
        if name == "layers.w_router":
            assert a.dtype == np.float32 and b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            assert a.dtype.name == "bfloat16" and b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                b.view(torch.uint16).numpy(), np.asarray(a).view(np.uint16),
                err_msg=name)
    # A tree whose router was cast to the model dtype is another model.
    cast = dict(jp, layers=dict(jp["layers"], w_router=np.asarray(
        jp["layers"]["w_router"]).astype(jnp.bfloat16)))
    with pytest.raises(ValueError, match="w_router must be float32"):
        tmx.params_from_numpy(cast, "cpu")


# -- forward and loss ------------------------------------------------------

# fp32: the same math in another summation order (the routing is equal).
@pytest.mark.parametrize("name", ["tiny", "flash"])
def test_forward_logits_match_jax(pallas_interpret, name):
    jc, tc = _configs(name)
    jp, tp = _params(jc)
    tokens = _tokens(2, 64, jc.vocab_size)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmx.forward, static_argnums=2)(
            jp, jnp.asarray(tokens), jc))
    got = tmx.forward(tp, torch.from_numpy(tokens), tc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name", ["tiny", "flash"])
def test_loss_aux_and_grads_match_jax(pallas_interpret, name):
    jc, tc = _configs(name)
    jp, tp = _params(jc, seed=1)
    tokens = _tokens(2, 65, jc.vocab_size, seed=1)
    with jax.default_matmul_precision("highest"):
        (jloss, jm), jg = jax.jit(jax.value_and_grad(
            lambda p: jmx.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jc),
            has_aux=True))(jp)
    loss, m, grads = _torch_grads(tp, tokens, tc)
    assert float(jm["aux_loss"]) > 0
    for key, got, want in (("total", loss, jloss),
                           ("loss", m["loss"], jm["loss"]),
                           ("aux_loss", m["aux_loss"], jm["aux_loss"]),
                           ("total_loss", m["total_loss"],
                            jm["total_loss"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, err_msg=key)
    want = dict(_named_leaves(jg))
    for leaf, g in grads.items():
        w = np.asarray(want[leaf], np.float32)
        assert np.abs(w).max() > 0, leaf
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=leaf)


def test_single_expert_matches_dense_llama():
    # One expert, top-1, room for every token: routing is the identity
    # (weight 1.0, nothing dropped), so the MoE block is the dense SwiGLU
    # with expert 0's weights (tests/test_mixtral.py's check, in fp32:
    # the same products as a batched and a plain matmul).
    mc = tmx.MixtralConfig.tiny(dtype=torch.float32, num_experts=1,
                                top_k=1, capacity_factor=2.0)
    mp = tmx.init_params(mc, torch.Generator().manual_seed(0), "cpu")
    lp = {k: v for k, v in mp.items() if k != "layers"}
    lp["layers"] = {k: v for k, v in mp["layers"].items()
                    if not k.startswith(("moe_", "w_router"))}
    for dense, moe in (("w_gate", "moe_gate"), ("w_up", "moe_up"),
                       ("w_down", "moe_down")):
        lp["layers"][dense] = mp["layers"][moe][:, 0]
    tokens = torch.from_numpy(_tokens(2, 16, mc.vocab_size, seed=2))
    torch.testing.assert_close(tmx.forward(mp, tokens, mc),
                               tl.forward(lp, tokens, mc.backbone()),
                               atol=1e-5, rtol=0)


def test_remat_changes_no_value(monkeypatch):
    # "full" saves the 2-D products (the router's among them) and
    # recomputes the batched expert products and the attention forward.
    calls = []
    real = ta.flash_fwd_reference
    monkeypatch.setattr(ta, "flash_fwd_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, tc = _configs("flash")
    _, tp = _params(jc, seed=4)
    tokens = _tokens(2, 65, jc.vocab_size, seed=4)
    loss0, m0, g0 = _torch_grads(tp, tokens, tc)
    assert len(calls) == tc.num_layers
    calls.clear()
    loss1, m1, g1 = _torch_grads(tp, tokens, dataclasses.replace(
        tc, remat=True, remat_policy="full"))
    assert len(calls) == 2 * tc.num_layers
    assert float(loss1) == float(loss0)
    assert float(m1["aux_loss"].detach()) == float(m0["aux_loss"].detach())
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6, rtol=1e-6)


def test_four_optimizer_steps_match_optax():
    # default_optimizer over mixtral.loss_fn from the same weights: the
    # fp32 losses of each step within 1e-5.
    jc, tc = _configs()
    jp, tp = _params(jc, seed=5)
    tokens = _tokens(4, 33, jc.vocab_size, seed=5)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20)
    jopt, topt = jt.default_optimizer(**kw), tt.default_optimizer(**kw)
    jstate = jopt.init(jp)
    leaves = [p.requires_grad_(True) for _, p in _named_leaves(tp)]
    tstate = topt.init(tp)
    batch = {"tokens": torch.from_numpy(tokens)}

    @jax.jit
    def jstep(p, s):
        (loss, _), g = jax.value_and_grad(
            lambda q: jmx.loss_fn(q, {"tokens": jnp.asarray(tokens)}, jc),
            has_aux=True)(p)
        upd, s = jopt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    jl, tls = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(4):
            jp, jstate, loss = jstep(jp, jstate)
            jl.append(float(loss))
            tloss, _ = tmx.loss_fn(tp, batch, tc)
            grads = torch.autograd.grad(tloss, leaves)
            tstate = topt.apply_(grads, tstate, tp)
            tls.append(float(tloss.detach()))
    np.testing.assert_allclose(tls, jl, rtol=1e-5)
    assert jl[-1] < jl[0]
    assert tstate.count == 4


def test_mesh_with_expert_axis_raises_naming_item_7(tmp_path):
    """Expert parallelism is ported (ROADMAP item 7d): on a one-rank
    DeviceMesh the Mixtral loss and grads go through the expert-parallel
    layer and equal one device's, drops included. A mapping of sizes is
    one device: an axis of it larger than 1 has no mesh to run on and
    raises (the multi-rank cases: tests/test_torch_expert_parallel.py)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from ray_tpu_torch.parallel import (MeshConfig, make_mesh, shard_tree,
                                        tree_shardings)

    _, tc = _configs(capacity_factor=0.5)
    tp = tmx.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens(2, 16, tc.vocab_size))
    for mesh in ({"expert": 2}, {"expert": 1, "fsdp": 2}):
        with pytest.raises(ValueError, match="make_mesh"):
            tmx.forward(tp, tokens, tc, mesh=mesh)
        with pytest.raises(ValueError, match="make_mesh"):
            tmx.loss_fn(tp, {"tokens": tokens}, tc, mesh=mesh)
    out = tmx.forward(tp, tokens, tc, mesh={"expert": 1, "fsdp": 1})
    assert out.shape == (2, 16, tc.vocab_size)
    want_loss, _, want = _torch_grads(tp, tokens.numpy(), tc)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(expert=1, fsdp=1), device_type="cpu")
        # The same seed's params, placed by the rules.
        placed = shard_tree(
            tmx.init_params(tc, torch.Generator().manual_seed(0), "cpu"),
            tree_shardings(mesh, tmx.logical_axes(tc)), mesh)
        names = [n for n, _ in _named_leaves(placed)]
        leaves = [p.requires_grad_(True) for _, p in _named_leaves(placed)]
        toks = distribute_tensor(tokens, mesh, (Replicate(),))
        loss, _ = tmx.loss_fn(placed, {"tokens": toks}, tc, mesh)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_allclose(float(loss.full_tensor()), float(want_loss),
                               rtol=1e-6)
    for n, g in zip(names, grads):
        w = want[n]
        gap = float((g.full_tensor() - w).abs().max() / w.abs().max())
        assert gap <= 1e-5, (n, gap)
