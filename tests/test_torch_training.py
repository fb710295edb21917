"""Port parity: the ray_tpu_torch training path (forward, loss_fn,
default_optimizer, ShardedTrainer) against the JAX package.

Both packages get the same weights (a JAX init carried across through
numpy) and the same tokens (numpy, seeded). fp32 runs with JAX's
matmul precision at "highest"; bf16 comparisons state their tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import training as jt
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import training as tt
from ray_tpu_torch.ops import attention as ta

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # These shapes are small: one intra-op thread is faster here, and it
    # keeps parallel test workers from oversubscribing the cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# __graft_entry__.py's config: head_dim 64, so both packages take
# mha_reference; and a head_dim 128 config that takes the flash path.
GRAFT = dict(vocab_size=2048, hidden_size=512, intermediate_size=1408,
             num_layers=4, num_heads=8, num_kv_heads=4, head_dim=64,
             max_seq_len=512)
FLASH = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
             max_seq_len=256)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _configs(kind, **kw):
    jdt, tdt = DTYPES[kind]
    return jl.LlamaConfig.tiny(dtype=jdt, **kw), \
        tl.LlamaConfig.tiny(dtype=tdt, **kw)


def _params(jc, seed=0):
    jp = jax.device_get(jl.init_params(jc, jax.random.PRNGKey(seed)))
    return jp, params_from_numpy(jp, "cpu")


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def _f32(x):
    return np.asarray(x.float().detach() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _assert_trees_close(got, want, atol, rtol_of_max):
    """Each leaf within ``atol + rtol_of_max * max|want leaf|``."""
    want = dict(_named_leaves(want))
    for name, g in _named_leaves(got):
        w = _f32(want[name])
        tol = atol + rtol_of_max * float(np.abs(w).max())
        np.testing.assert_allclose(_f32(g), w, atol=tol, rtol=0,
                                   err_msg=name)


def _torch_grads(tp, batch, tc):
    leaves = [p.requires_grad_(True) for _, p in _named_leaves(tp)]
    loss, metrics = tl.loss_fn(tp, batch, tc)
    grads = torch.autograd.grad(loss, leaves)
    names = [n for n, _ in _named_leaves(tp)]
    return loss.detach(), metrics, dict(zip(names, grads))


def _jax_loss_and_grads(jp, tokens, jc):
    with jax.default_matmul_precision("highest"):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jl.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jc),
            has_aux=True)(jp)
    return loss, metrics, grads


# -- forward ---------------------------------------------------------------

# (config, dtype, atol): fp32 is the same math in another order (~4e-6
# measured on logits of magnitude ~4.5); bf16 rounds activations at
# other places in the two frameworks (~3e-2 measured).
@pytest.mark.parametrize("cfg,kind,atol", [
    ("graft", "fp32", 5e-5), ("graft", "bf16", 1e-1),
    ("flash", "fp32", 5e-5), ("flash", "bf16", 1e-1)])
def test_forward_logits_match_jax(pallas_interpret, cfg, kind, atol):
    kw, seq = (GRAFT, 256) if cfg == "graft" else (FLASH, 128)
    jc, tc = _configs(kind, **kw)
    jp, tp = _params(jc)
    tokens = _tokens(2, seq, jc.vocab_size)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jl.forward(jp, jnp.asarray(tokens), jc))
    got = tl.forward(tp, torch.from_numpy(tokens), tc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol,
                               rtol=0)


def test_forward_takes_flash_path_at_head_dim_128(monkeypatch):
    calls = []
    real = ta.flash_fwd_reference
    monkeypatch.setattr(ta, "flash_fwd_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, tc = _configs("fp32", **FLASH)
    _, tp = _params(jc)
    tl.forward(tp, torch.from_numpy(_tokens(1, 64, jc.vocab_size)), tc)
    assert len(calls) == FLASH["num_layers"]
    calls.clear()
    gc, gtc = _configs("fp32", **dict(GRAFT, num_layers=1))
    _, gp = _params(gc)
    tl.forward(gp, torch.from_numpy(_tokens(1, 64, gc.vocab_size)), gtc)
    assert calls == []                      # head_dim 64: mha_reference


def test_forward_shapes():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits = tl.forward(params, torch.zeros((2, 32), dtype=torch.int32),
                        cfg)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert logits.dtype == torch.float32
    hidden, aux = tl.hidden_states(params, torch.zeros((2, 32),
                                                       dtype=torch.int32),
                                   cfg)
    assert hidden.shape == (2, 32, cfg.hidden_size) and float(aux) == 0.0


# -- loss ------------------------------------------------------------------

# fp32 grads agree to ~2e-6 of each leaf's largest entry (measured);
# bf16 to ~1.3e-2 (bf16 roundings at other places).
@pytest.mark.parametrize("kind,loss_tol,grad_tol", [
    ("fp32", 1e-5, 2e-5), ("bf16", 5e-3, 5e-2)])
def test_loss_fn_value_and_grads_match_jax(pallas_interpret, kind,
                                           loss_tol, grad_tol):
    jc, tc = _configs(kind, **FLASH)
    jp, tp = _params(jc)
    tokens = _tokens(2, 129, jc.vocab_size, seed=1)   # 128 targets, 8 chunks
    jloss, jm, jg = _jax_loss_and_grads(jp, tokens, jc)
    loss, metrics, grads = _torch_grads(tp, {"tokens": torch.from_numpy(
        tokens)}, tc)
    assert abs(float(loss) - float(jloss)) <= loss_tol * float(jloss)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 256
    assert float(metrics["accuracy"]) == pytest.approx(
        float(jm["accuracy"]), abs=1 / 256)
    _assert_trees_close(grads, dict(_named_leaves(jg)), 0.0, grad_tol)


def test_loss_fn_mask_and_aux_match_jax():
    jc, tc = _configs("fp32", **dict(GRAFT, num_layers=2))
    jp, tp = _params(jc)
    tokens = _tokens(2, 64, jc.vocab_size, seed=2)
    mask = np.ones_like(tokens)
    mask[0, 40:] = 0
    mask[1, :5] = 0
    with jax.default_matmul_precision("highest"):
        jloss, jm = jl.loss_fn(jp, {"tokens": jnp.asarray(tokens),
                                    "mask": jnp.asarray(mask)}, jc,
                               vocab_chunks=3)
    loss, m = tl.loss_fn(tp, {"tokens": torch.from_numpy(tokens),
                              "mask": torch.from_numpy(mask)}, tc,
                         vocab_chunks=3)
    assert float(m["tokens"]) == float(jm["tokens"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    def aux_mlp(h, layer):
        return h * 0.5, (h.float() ** 2).mean()

    def jaux_mlp(h, layer):
        return h * 0.5, jnp.mean(h.astype(jnp.float32) ** 2)

    with jax.default_matmul_precision("highest"):
        jloss, jm = jl.loss_fn(jp, {"tokens": jnp.asarray(tokens)}, jc,
                               mlp_fn=jaux_mlp, aux_coeff=0.01)
    loss, m = tl.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, tc,
                         mlp_fn=aux_mlp, aux_coeff=0.01)
    np.testing.assert_allclose(float(m["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


# -- remat -----------------------------------------------------------------

@pytest.mark.parametrize("policy", ["full", "attn_out", "mlp_only"])
def test_remat_policies_change_no_value(monkeypatch, policy):
    calls = []
    real = ta.flash_fwd_reference
    monkeypatch.setattr(ta, "flash_fwd_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, tc = _configs("fp32", **FLASH)
    _, tp = _params(jc)
    batch = {"tokens": torch.from_numpy(_tokens(2, 65, jc.vocab_size))}
    loss0, _, g0 = _torch_grads(tp, batch, tc)
    assert len(calls) == FLASH["num_layers"]
    calls.clear()
    rc = dataclasses.replace(tc, remat=True, remat_policy=policy)
    loss1, _, g1 = _torch_grads(tp, batch, rc)
    # The backward replays each layer's attention forward, as JAX's.
    assert len(calls) == 2 * FLASH["num_layers"]
    assert float(loss1) == float(loss0)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], atol=1e-6, rtol=1e-6)


def test_unknown_remat_policy_raises():
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, remat=True,
                             remat_policy="none")
    params = tl.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        tl.forward(params, torch.zeros((1, 8), dtype=torch.int32), tc)


# -- optimizer -------------------------------------------------------------

def _opt_tree(rng, dtype):
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5, 2)}}

    def draw(node, scale):
        if isinstance(node, dict):
            return {k: draw(v, scale) for k, v in node.items()}
        return (rng.standard_normal(node) * scale).astype(np.float32)
    return draw(shapes, 1.0), [draw(shapes, s) for s in
                               (0.05, 0.3, 0.02, 2.0, 0.01, 0.5)]


# (kind, tolerance relative to each leaf's max): fp32 is optax's
# arithmetic in the same order (updates agree to a few ulp); bf16 rounds
# after each op in PyTorch where XLA may keep fp32 between fused ops.
@pytest.mark.parametrize("kind,tol", [("fp32", 1e-6), ("bf16", 2e-2)])
@pytest.mark.parametrize("mu_dtype", [None, "fp32"])
def test_default_optimizer_matches_optax(kind, tol, mu_dtype):
    jdt, tdt = DTYPES[kind]
    rng = np.random.default_rng(5)
    params, grads_seq = _opt_tree(rng, jdt)
    jopt = jt.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                total_steps=5,
                                mu_dtype=jnp.float32 if mu_dtype else None)
    topt = tt.default_optimizer(learning_rate=1e-2, warmup_steps=2,
                                total_steps=5,
                                mu_dtype=torch.float32 if mu_dtype else None)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tparams = params_from_numpy(params, "cpu", dtype=tdt)
    jstate = jopt.init(jparams)
    tstate = topt.init(tparams)
    assert tstate.mu[0].dtype == (torch.float32 if mu_dtype else tdt)
    assert tstate.nu[0].dtype == tdt
    for i, g in enumerate(grads_seq):       # clipped at steps 1, 3, 5
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        tg = params_from_numpy(g, "cpu", dtype=tdt)
        jup, jstate = jopt.update(jg, jstate, jparams)
        tup, tstate = topt.update(tg, tstate, tparams)
        if i == 0:     # the schedule is read before its increment: lr 0
            assert all(float(u.abs().max()) == 0 for _, u in
                       _named_leaves(tup))
        _assert_trees_close(tup, jup, 1e-12, tol)
        jparams = optax.apply_updates(jparams, jup)
        tparams = tt.apply_updates(tparams, tup)
        _assert_trees_close(tparams, jparams, 0.0, tol)
    adam = jstate[1][0]
    assert tstate.count == int(adam.count) == len(grads_seq)
    for got, want in zip(tstate.mu + tstate.nu,
                         jax.tree.leaves(adam.mu) + jax.tree.leaves(adam.nu)):
        np.testing.assert_allclose(_f32(got), _f32(want),
                                   atol=tol * float(np.abs(_f32(want)).max()))


def test_schedule_matches_optax():
    opt = tt.default_optimizer(learning_rate=3e-4, warmup_steps=10,
                               total_steps=100)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 100)
    for count in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert float(opt.schedule(count)) == pytest.approx(
            float(sched(jnp.asarray(count, jnp.int32))), rel=1e-6, abs=0)


# -- trainer ---------------------------------------------------------------

def _jax_trainer(jc, **kw):
    mesh = make_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
    return jt.ShardedTrainer(jc, mesh, optimizer=jt.default_optimizer(
        warmup_steps=2, total_steps=50, learning_rate=1e-2), **kw)


def _torch_trainer(tc, **kw):
    return tt.ShardedTrainer(tc, optimizer=tt.default_optimizer(
        warmup_steps=2, total_steps=50, learning_rate=1e-2), device="cpu",
        **kw)


def test_train_steps_match_jax_trainer():
    jc, tc = _configs("fp32")
    jtr, ttr = _jax_trainer(jc), _torch_trainer(tc)
    with jax.default_matmul_precision("highest"):
        jstate = jtr.init_state(0)
        tstate = ttr.state_from_params(
            params_from_numpy(jax.device_get(jstate.params), "cpu"))
        tokens = _tokens(8, 64, jc.vocab_size, seed=3)
        jbatch = {"tokens": jnp.asarray(tokens),
                  "mask": jnp.ones_like(jnp.asarray(tokens))}
        tbatch = tt.synthetic_batch(8, 64, tc.vocab_size, device="cpu")
        tbatch["tokens"] = torch.from_numpy(tokens)
        for _ in range(4):
            jstate, jm = jtr.train_step(jstate, jbatch)
            tstate, tm = ttr.train_step(tstate, tbatch)
            # The fp32 losses of the same step from the same weights.
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-4)
            assert float(tm["tokens"]) == float(jm["tokens"])
    assert tstate.step == int(jstate.step) == 4
    _assert_trees_close(tstate.params, jax.device_get(jstate.params), 0.0,
                        1e-4)


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_microbatched_grads_match_single_batch(microbatches):
    # Token-weighted accumulation: the summed grads are JAX's one-batch
    # grads up to fp32 reduction order (~1e-6 of each leaf's max).
    jc, tc = _configs("fp32")
    jp, tp = _params(jc, seed=1)
    tokens = _tokens(8, 32, jc.vocab_size, seed=4)
    mask = np.ones_like(tokens)
    mask[:2, 10:] = 0                      # imbalance across microbatches
    with jax.default_matmul_precision("highest"):
        (jloss, _), jg = jax.value_and_grad(
            lambda p: jl.loss_fn(p, {"tokens": jnp.asarray(tokens),
                                     "mask": jnp.asarray(mask)}, jc),
            has_aux=True)(jp)
    tr = _torch_trainer(tc, microbatches=microbatches)
    state = tr.state_from_params(tp)
    loss, metrics, grads = tr.grads(state.params, {
        "tokens": torch.from_numpy(tokens), "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    names = [n for n, _ in _named_leaves(state.params)]
    _assert_trees_close(dict(zip(names, grads)), dict(_named_leaves(jg)),
                        0.0, 1e-5)
    assert float(metrics["tokens"]) == float(mask[:, 1:].sum())


def test_loss_decreases_under_training():
    # Analog of tests/test_model_training.py's
    # test_loss_decreases_under_training on one device (bf16 tiny config,
    # 20 steps on one batch).
    tc = tl.LlamaConfig.tiny()
    trainer = _torch_trainer(tc)
    state = trainer.init_state(0)
    batch = tt.synthetic_batch(8, 64, tc.vocab_size, device="cpu")
    first = None
    for _ in range(20):
        state, metrics = trainer.train_step(state, batch)
        first = first if first is not None else float(metrics["loss"])
    last = float(metrics["loss"])
    assert last < first * 0.7, (first, last)
    assert state.step == 20 and state.opt_state.count == 20


def test_synthetic_batch_is_seeded():
    a = tt.synthetic_batch(4, 16, 100, seed=3, device="cpu")
    b = tt.synthetic_batch(4, 16, 100, seed=3, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert int(a["tokens"].max()) < 100 and torch.equal(
        a["mask"], torch.ones_like(a["tokens"]))


def test_unported_hooks_raise():
    tc = tl.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="item 7"):
        tt.ShardedTrainer(tc, rules={"embed": "fsdp"}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        tt.ShardedTrainer(tc, mesh={"data": 1, "fsdp": 2}, device="cpu")
    trainer = tt.ShardedTrainer(tc, mesh={"data": 1, "fsdp": 1},
                                device="cpu", microbatches=3)
    state = trainer.init_state(0)
    batch = tt.synthetic_batch(4, 16, tc.vocab_size, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        trainer.shard_batch(batch)
    with pytest.raises(NotImplementedError, match="item 8"):
        trainer.save_state(None, state)
    with pytest.raises(NotImplementedError, match="item 8"):
        trainer.restore_state(None)
    with pytest.raises(ValueError, match="not divisible"):
        trainer.train_step(state, batch)
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 7"):
        tl.forward(state.params, tokens,
                   dataclasses.replace(tc, attention="ring"))
    with pytest.raises(NotImplementedError, match="item 7"):
        tl.forward(state.params, tokens, tc, mesh={"seq": 2})
    if not torch.cuda.is_available():
        # Entry points run on cuda unless asked: no silent CPU fallback.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.ShardedTrainer(tc)
