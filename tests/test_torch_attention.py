"""Port parity: ray_tpu_torch flash attention against the JAX package.

The plain flash versions (the CPU path, and the yardstick of the CUDA
kernels) are held to the Pallas kernels ``_fwd``/``_bwd`` in interpret
mode and to ``jax.grad``; ``flash_attention`` and its gate to JAX's.
Inputs are numpy arrays drawn from a seed, fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as ja
from ray_tpu_torch.ops import attention as ta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # These shapes are small: one intra-op thread is faster here, and it
    # keeps parallel test workers from oversubscribing the cores.
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# fp32, the same math in another summation order: out/lse agree to a few
# ulp of their magnitude (~5e-7 measured), grads to ~5e-6 (sums over up
# to 512 keys of terms up to ~6).
FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _inputs(b, sq, sk, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _bhsd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# (causal, b, sq, sk, hq, hkv): GQA groups 1, 2 and 8, cross-length
# causal (bottom-right mask) and non-causal.
CASES = {
    "causal-g1": (True, 2, 256, 256, 4, 4),
    "causal-g2": (True, 2, 256, 256, 4, 2),
    "causal-g8": (True, 1, 128, 128, 8, 1),
    "noncausal-g2": (False, 2, 256, 256, 4, 2),
    "cross-128-256": (True, 1, 128, 256, 4, 2),
    "cross-64-256": (True, 1, 64, 256, 4, 2),
    "noncausal-256-128": (False, 1, 256, 128, 4, 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_fwd_matches_pallas_kernel(pallas_interpret, name):
    causal, b, sq, sk, hq, hkv = CASES[name]
    q, k, v, _ = _inputs(b, sq, sk, hq, hkv, 128)
    scale = 128 ** -0.5
    with jax.default_matmul_precision("highest"):
        out, lse = ja._fwd(_bhsd(q), _bhsd(k), _bhsd(v), scale=scale,
                           causal=causal, block_q=64, block_k=64,
                           interpret=True)
    got_out, got_lse = ta.flash_fwd_reference(*_t(q, k, v), scale=scale,
                                              causal=causal)
    assert got_lse.shape == (b, hq, sq) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(),
                               np.asarray(out).transpose(0, 2, 1, 3),
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bwd_matches_pallas_kernels(pallas_interpret, name):
    causal, b, sq, sk, hq, hkv = CASES[name]
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, 128, seed=1)
    scale = 128 ** -0.5
    with jax.default_matmul_precision("highest"):
        res = ja._fwd(_bhsd(q), _bhsd(k), _bhsd(v), scale=scale,
                      causal=causal, block_q=64, block_k=64, interpret=True)
        want = ja._bwd((_bhsd(q), _bhsd(k), _bhsd(v)) + tuple(res),
                       _bhsd(do), scale=scale, causal=causal, block_q=64,
                       block_k=64, interpret=True)
    out, lse = ta.flash_fwd_reference(*_t(q, k, v), scale=scale,
                                      causal=causal)
    got = ta.flash_bwd_reference(*_t(q, k, v), out, lse, *_t(do),
                                 scale=scale, causal=causal)
    for name_, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(w).transpose(0, 2, 1, 3),
                                   atol=GRAD_TOL, rtol=0, err_msg=name_)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bwd_matches_jax_grad(causal):
    q, k, v, do = _inputs(2, 256, 256, 4, 2, 128, seed=2)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(
            lambda *a: jnp.sum(ja.flash_attention(
                *a, causal=causal, block_q=128, block_k=128) * do),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    scale = 128 ** -0.5
    out, lse = ta.flash_fwd_reference(*_t(q, k, v), scale=scale,
                                      causal=causal)
    got = ta.flash_bwd_reference(*_t(q, k, v), out, lse, *_t(do),
                                 scale=scale, causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL)


@pytest.mark.parametrize("name", ["causal-g2", "cross-128-256",
                                  "noncausal-256-128"])
def test_torch_autograd_matches_jax_grads(name):
    causal, b, sq, sk, hq, hkv = CASES[name]
    q, k, v, do = _inputs(b, sq, sk, hq, hkv, 128, seed=3)
    with jax.default_matmul_precision("highest"):
        jout, jgrads = jax.vjp(
            lambda *a: ja.flash_attention(*a, causal=causal, block_q=64,
                                          block_k=64),
            *map(jnp.asarray, (q, k, v)))
        jgrads = jgrads(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = ta.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                             block_k=64)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=FWD_TOL)
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL)


# -- analogs of tests/test_ops.py:26-80, on the port alone ------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(causal):
    q, k, v = _t(*_inputs(2, 256, 256, 4, 2, 128)[:3])
    ref = ta.mha_reference(q, k, v, causal=causal)
    out = ta.flash_attention(q, k, v, causal=causal, block_q=128,
                             block_k=128)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grads(causal):
    q, k, v = (t.requires_grad_() for t in
               _t(*_inputs(2, 256, 256, 4, 2, 128)[:3]))

    def grads(fn):
        return torch.autograd.grad((fn(q, k, v) ** 2).sum(), (q, k, v))

    g1 = grads(lambda *a: ta.flash_attention(*a, causal=causal,
                                             block_q=128, block_k=128))
    g2 = grads(lambda *a: ta.mha_reference(*a, causal=causal))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=0)


@pytest.mark.parametrize("sq,sk", [(128, 256), (64, 256), (256, 128)])
def test_flash_attention_cross_length_causal(sq, sk):
    q = _t(_inputs(2, sq, sq, 4, 2, 128)[0])[0].requires_grad_()
    k, v = (t.requires_grad_() for t in
            _t(*_inputs(2, sk, sk, 4, 2, 128, seed=1)[1:3]))
    out = ta.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    ref = ta.mha_reference(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    g1 = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    g2 = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=0)


def test_flash_attention_small_fallback():
    # Below one block, or D % 128, both packages take mha_reference.
    q, k, v, _ = _inputs(2, 32, 32, 4, 2, 64)
    out = ta.flash_attention(*_t(q, k, v), causal=True)
    assert torch.equal(out, ta.mha_reference(*_t(q, k, v), causal=True))
    want = ja.mha_reference(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_mha_reference_matches_jax_bf16():
    q, k, v, _ = _inputs(1, 64, 64, 4, 2, 64, seed=4)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = ta.mha_reference(tq, tk, tv, causal=True)
    want = ja.mha_reference(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                              for t in (tq, tk, tv)), causal=True)
    assert got.dtype == torch.bfloat16
    # One bf16 rounding of the same fp32 result.
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_flash_applicable_matches_jax():
    for sq in (1, 7, 8, 64, 100, 128, 1024, 1536, 2048, 4096):
        for sk in (8, 64, 128, 1024, 2048, 3072):
            for d in (64, 128, 192, 256):
                for causal in (True, False):
                    for blocks in ((1024, 1024), (128, 256)):
                        kw = dict(causal=causal, block_q=blocks[0],
                                  block_k=blocks[1])
                        assert ta.flash_applicable(sq, sk, d, **kw) == \
                            ja.flash_applicable(sq, sk, d, **kw), \
                            (sq, sk, d, kw)


def test_flash_dispatch_and_launch_counts():
    q, k, v, _ = _t(*_inputs(1, 128, 128, 4, 2, 128))
    before = dict(ta.flash_attention.launches)
    ta.flash_attention(q, k, v)                 # CPU: the plain versions
    assert ta.flash_attention.launches == before
    with pytest.raises(RuntimeError, match="needs CUDA"):
        ta.flash_attention(q, k, v, use_kernel=True)
    _, k3, v3, _ = _t(*_inputs(1, 128, 128, 4, 3, 128))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ta.flash_attention(q, k3, v3)
