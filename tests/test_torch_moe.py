"""Port parity: ``ray_tpu_torch.ops.moe`` against ``ray_tpu.ops.moe``.

The same numpy-seeded inputs go through both. fp32 runs with JAX's
matmul precision at "highest"; each tolerance is stated where it is
used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import moe as jm
from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops import moe as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


D, M, X = 32, 48, 4


def _params(kind="fp32", seed=0, d=D, m=M, x=X):
    """The same numpy draw for both packages: ``w_router`` fp32, the
    experts in ``kind``."""
    rng = np.random.default_rng(seed)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[kind]

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    p = {"w_router": draw((d, x), d ** -0.5),
         "w_gate": draw((x, d, m), d ** -0.5),
         "w_up": draw((x, d, m), d ** -0.5),
         "w_down": draw((x, m, d), m ** -0.5)}
    jp = {k: jnp.asarray(v, jnp.float32 if k == "w_router" else jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "w_router"
                                    else tdt) for k, v in p.items()}
    return jp, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- routing ---------------------------------------------------------------

def _logits(kind, t=64, x=8, seed=2):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((t, x)).astype(np.float32)
    if kind == "all-tied":          # a router at zero
        return np.zeros((t, x), np.float32)
    # partly tied: a few distinct values, so most rows hold ties
    return rng.integers(-2, 3, (t, x)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "all-tied", "partly-tied"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_topk_matches_jax_tie_order(kind, k):
    logits = _logits(kind)
    jw, ji = jm.router_topk(jnp.asarray(logits), k)
    tw, ti = tm.router_topk(torch.from_numpy(logits), k)
    # Ties go to the lower expert index, as jax.lax.top_k sends them.
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=0)
    if kind == "all-tied":
        np.testing.assert_array_equal(ti.numpy(), np.tile(np.arange(k),
                                                          (64, 1)))


def test_dispatch_mask_capacity_case_matches_jax():
    # tests/test_moe_pipeline.py's four tokens: expert 0 takes tokens 0
    # and 1, token 2 drops, token 3 goes to expert 1.
    idx = np.array([[0], [0], [0], [1]])
    got = tm.dispatch_mask(torch.from_numpy(idx), num_experts=2, capacity=2)
    want = np.asarray(jm.dispatch_mask(jnp.asarray(idx), 2, 2))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[2].sum()) == 0 and float(got[3, 1].sum()) == 1


def _routed(t, x, k, cf, seed=3):
    logits = _logits("random", t, x, seed)
    _, idx = jm.router_topk(jnp.asarray(logits), k)
    cap = max(int(cf * t * k / x), k)
    return np.array(idx), cap


@pytest.mark.parametrize("t,x,k,cf", [(64, 4, 2, 0.5), (64, 8, 2, 1.25),
                                      (48, 8, 3, 0.75), (64, 4, 1, 8.0)])
def test_dispatch_mask_with_drops_matches_jax(t, x, k, cf):
    idx, cap = _routed(t, x, k, cf)
    got = tm.dispatch_mask(torch.from_numpy(idx), x, cap).numpy()
    want = np.asarray(jm.dispatch_mask(jnp.asarray(idx), x, cap))
    np.testing.assert_array_equal(got, want)
    if cf < 1:
        assert want.sum() < t * k           # the case drops pairs


@pytest.mark.parametrize("t,x,k,cf", [(64, 4, 2, 0.5), (64, 8, 2, 1.25),
                                      (48, 8, 3, 0.75)])
def test_index_dispatch_places_tokens_where_the_mask_does(t, x, k, cf):
    idx, cap = _routed(t, x, k, cf)
    disp = tm.dispatch_mask(torch.from_numpy(idx), x, cap)      # [T, X, C]
    dest, keep = tm.dispatch_index(torch.from_numpy(idx), x, cap)
    assert dest.shape == keep.shape == (t * k,)
    # Every kept pair's row holds the mask's 1 for that token; dropped
    # pairs sit on the dummy row past the buffers.
    flat = disp.reshape(t, x * cap)
    tok = torch.arange(t).repeat_interleave(k)
    assert bool((dest[~keep] == x * cap).all())
    assert bool((flat[tok[keep], dest[keep]] == 1).all())
    # ... and the mask holds nothing else: one 1 per kept pair.
    assert int(flat.sum()) == int(keep.sum())
    # The rows the layer builds by index equal JAX's einsum over the mask.
    tokens = _x((t, 16), seed=4)
    want = np.einsum("tec,td->ecd", disp.numpy(), tokens)
    rows = torch.zeros((x * cap + 1, 16)).index_copy(
        0, dest, torch.from_numpy(tokens).repeat_interleave(k, 0))[:-1]
    np.testing.assert_array_equal(rows.view(x, cap, 16).numpy(), want)


# -- the layer -------------------------------------------------------------

def _both(x, jp, tp, **kw):
    with jax.default_matmul_precision("highest"):
        jo, ja = jax.jit(lambda xx, pp: jm.moe_layer(xx, pp, **kw))(
            jnp.asarray(x), jp)
    to, ta = tm.moe_layer(torch.from_numpy(x), tp, **kw)
    return (np.asarray(jo, np.float32), ja), (to.float().numpy(), ta)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0])
def test_moe_layer_fp32_matches_jax(cf):
    jp, tp = _params()
    (jo, ja), (to, ta) = _both(_x((2, 32, D)), jp, tp, num_experts=X,
                               top_k=2, capacity_factor=cf)
    assert _rel(to, jo) <= 1e-6
    np.testing.assert_allclose(float(ta["aux_loss"]), float(ja["aux_loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ta["dropped_fraction"]),
                               float(ja["dropped_fraction"]), rtol=1e-6,
                               atol=0)
    if cf == 0.5:
        assert float(ja["dropped_fraction"]) > 0


def test_moe_layer_all_tied_router_matches_jax():
    jp, tp = _params()
    jp["w_router"] = jnp.zeros_like(jp["w_router"])
    tp["w_router"] = torch.zeros_like(tp["w_router"])
    (jo, ja), (to, ta) = _both(_x((2, 32, D)), jp, tp, num_experts=X,
                               top_k=2, capacity_factor=1.25)
    # Every token picks experts 0 and 1, which overflow and drop.
    assert float(ja["dropped_fraction"]) > 0
    assert _rel(to, jo) <= 1e-6
    assert float(ta["dropped_fraction"]) == float(ja["dropped_fraction"])


def test_moe_layer_bf16_matches_jax():
    # bf16 expert products round at other places in the two frameworks:
    # within 2e-2 of the largest entry.
    jp, tp = _params("bf16")
    x = _x((2, 32, D))
    with jax.default_matmul_precision("highest"):
        jo, ja = jm.moe_layer(jnp.asarray(x, jnp.bfloat16), jp,
                              num_experts=X, top_k=2)
    to, ta = tm.moe_layer(torch.from_numpy(x).bfloat16(), tp,
                          num_experts=X, top_k=2)
    assert to.dtype == torch.bfloat16
    assert _rel(to.float().numpy(), np.asarray(jo, np.float32)) <= 2e-2
    np.testing.assert_allclose(float(ta["aux_loss"]), float(ja["aux_loss"]),
                               rtol=1e-5)
    assert float(ta["dropped_fraction"]) == float(ja["dropped_fraction"])


def test_moe_layer_top3_matches_jax():
    # k=3: JAX's combine sums the three weighted rows in expert order,
    # the port in choice order; fp32 rounding of a three-term sum in two
    # orders: within 2e-6 of the largest entry.
    jp, tp = _params(x=6)
    (jo, ja), (to, ta) = _both(_x((2, 24, D)), jp, tp, num_experts=6,
                               top_k=3, capacity_factor=0.75)
    assert float(ja["dropped_fraction"]) > 0
    assert _rel(to, jo) <= 2e-6
    np.testing.assert_allclose(float(ta["aux_loss"]), float(ja["aux_loss"]),
                               rtol=1e-6)
    assert float(ta["dropped_fraction"]) == float(ja["dropped_fraction"])


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_layer_grads_match_jax(cf):
    # fp32 grads of sum(out * cot) + aux_loss with respect to x and every
    # weight, each within 1e-5 of the leaf's largest entry.
    jp, tp = _params(seed=5)
    x = _x((2, 32, D), seed=6)
    cot = _x((2, 32, D), seed=7)
    kw = dict(num_experts=X, top_k=2, capacity_factor=cf)

    def jloss(xx, pp):
        out, aux = jm.moe_layer(xx, pp, **kw)
        return jnp.sum(out * cot) + aux["aux_loss"]

    with jax.default_matmul_precision("highest"):
        jgx, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    out, aux = tm.moe_layer(tx, leaves, **kw)
    loss = (out * torch.from_numpy(cot)).sum() + aux["aux_loss"]
    grads = torch.autograd.grad(loss, [tx] + list(leaves.values()))
    want = [jgx] + [jgp[k] for k in leaves]
    for name, g, w in zip(["x"] + list(leaves), grads, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_moe_layer_backward_is_deterministic():
    jp, tp = _params(seed=8)
    x = torch.from_numpy(_x((2, 32, D), seed=9))
    runs = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        w = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        out, aux = tm.moe_layer(xx, w, num_experts=X, top_k=2,
                                capacity_factor=0.5)
        runs.append(torch.autograd.grad(out.square().sum() + aux["aux_loss"],
                                        [xx] + list(w.values())))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# -- init and exports ------------------------------------------------------

def test_init_moe_params_matches_jax_layout():
    want = jax.eval_shape(lambda: jm.init_moe_params(
        jax.random.PRNGKey(0), 64, 96, 4))
    got = tm.init_moe_params(64, 96, 4, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k
    # normal * fan_in^-0.5 (64 in, 96 out)
    assert abs(float(got["w_router"].std()) - 64 ** -0.5) < 2e-2
    assert abs(float(got["w_down"].float().std()) - 96 ** -0.5) < 5e-3
    assert tm.MOE_LOGICAL_AXES == jm.MOE_LOGICAL_AXES
    assert tops.moe_layer is tm.moe_layer
    assert tops.router_topk is tm.router_topk
    assert tops.init_moe_params is tm.init_moe_params
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init_moe_params(64, 96, 4)
