"""The rounding points of the bf16 tensor-core flash kernels, emulated on
the CPU.

``ray_tpu_torch/ops/csrc/flash_attention_sm90.cu`` computes the scores as
bf16 q times bf16 k summed in fp32, then times ``scale``; an online
softmax over 64-key tiles whose p is rounded to bf16 before P V while the
sum l is taken over the fp32 p; and in the backward dS rounded to bf16
before dS K, and P^T and dS^T rounded to bf16 before P^T dO and dS^T Q,
with dq and dk multiplied by ``scale`` once at the end. Here plain PyTorch
repeats those steps (fp32 math, a bf16 cast wherever the kernel rounds) on
small bf16 cases drawn from a seed, and the emulation is held at the bf16
tolerances the card holds the kernels to (``chip_smoke.py`` FLASH_CASES,
``tests/test_torch_kernels_gpu.py``) to the plain fp32 versions
(``flash_fwd_reference``/``flash_bwd_reference``) and to the JAX package's
``mha_reference`` and ``jax.grad`` of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as ja
from ray_tpu_torch.ops import attention as ta

# bf16 outputs: one bf16 rounding of the result plus the bf16 rounding of
# p and ds inside the products (2^-9 relative a term, fp32 sums).
ATOL, RTOL = 2e-2, 2e-2
# lse is fp32 and sees no bf16 product: the card's limit.
LSE_ATOL = 1e-4
TILE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (causal, b, sq, sk, hq, hkv, d): causal, non-causal, cross-length causal
# (bottom-right mask), D=64, and lengths that are not a multiple of the
# 64-key tile.
CASES = {
    "causal": (True, 2, 128, 128, 4, 2, 128),
    "noncausal": (False, 1, 128, 192, 4, 2, 128),
    "cross": (True, 1, 64, 192, 4, 2, 128),
    "d64": (True, 2, 128, 128, 4, 1, 64),
    "ragged": (True, 1, 100, 150, 4, 2, 64),
}


def _inputs(b, sq, sk, hq, hkv, d, seed=0):
    """bf16 q, k, v, dO from a numpy seed."""
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]


def _grouped_scores(q, k, scale, causal, k0=0, k1=None):
    """Masked fp32 scores [B, KVH, G, Sq, k1 - k0] of bf16 q times bf16 k
    summed in fp32, then times ``scale`` (the kernels' order)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    k1 = sk if k1 is None else k1
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, k0:k1].float()) * scale
    if causal:
        rows = torch.arange(sq)[:, None] + (sk - sq)
        s = torch.where(rows >= torch.arange(k0, k1)[None, :], s,
                        ta.DEFAULT_MASK_VALUE)
    return s


def emulated_fwd(q, k, v, *, scale, causal):
    """(out bf16, lse fp32 [B, Hq, Sq]) with the forward kernel's rounding
    points: 64-key tiles, online softmax, p rounded to bf16 before P V, l
    from the fp32 p."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    m = torch.full((b, hkv, g, sq), -torch.inf)
    l = torch.zeros((b, hkv, g, sq))
    acc = torch.zeros((b, hkv, g, sq, d))
    for k0 in range(0, sk, TILE):
        k1 = min(k0 + TILE, sk)
        s = _grouped_scores(q, k, scale, causal, k0, k1)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(torch.bfloat16).float(),
            v[:, k0:k1].float())
        m = m_new
    safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / safe[..., None]).permute(0, 3, 1, 2, 4)
    return (out.reshape(b, sq, hq, d).to(torch.bfloat16),
            (m + torch.log(safe)).reshape(b, hq, sq))


def emulated_dq(q, k, v, out, lse, do, *, scale, causal):
    """dq in bf16 with the dq kernel's rounding points: dS rounded to bf16
    before dS K (fp32 sums), dq scaled at the end."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    s = _grouped_scores(q, k, scale, causal)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1))
    dog = do.float().reshape(b, sq, hkv, g, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - ta._delta(out, do).reshape(b, hkv, g, sq, 1))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(torch.bfloat16).float(),
                      k.float()) * scale
    return dq.reshape(b, sq, hq, d).to(torch.bfloat16)


def emulated_dkv(q, k, v, out, lse, do, *, scale, causal):
    """(dk, dv) in bf16 with the dk/dv kernel's rounding points: P^T and
    dS^T rounded to bf16 before their products, dk scaled at the end."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    s = _grouped_scores(q, k, scale, causal)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq, 1))
    dog = do.float().reshape(b, sq, hkv, g, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - ta._delta(out, do).reshape(b, hkv, g, sq, 1))
    qg = q.float().reshape(b, sq, hkv, g, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(torch.bfloat16).float(), dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(torch.bfloat16).float(),
                      qg) * scale
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy()
                               if isinstance(want, torch.Tensor) else want,
                               atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_fwd_within_bf16_tolerance_of_plain(name):
    causal, *shape = CASES[name]
    q, k, v, _ = _inputs(*shape)
    scale = shape[-1] ** -0.5
    out, lse = emulated_fwd(q, k, v, scale=scale, causal=causal)
    ref_out, ref_lse = ta.flash_fwd_reference(q, k, v, scale=scale,
                                              causal=causal)
    assert out.dtype == ref_out.dtype == torch.bfloat16
    _close(out, ref_out, what="out")
    _close(lse, ref_lse, atol=LSE_ATOL, rtol=0, what="lse")


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_dq_within_bf16_tolerance_of_plain(name):
    causal, *shape = CASES[name]
    q, k, v, do = _inputs(*shape, seed=3)
    kw = dict(scale=shape[-1] ** -0.5, causal=causal)
    out, lse = emulated_fwd(q, k, v, **kw)
    dq = emulated_dq(q, k, v, out, lse, do, **kw)
    ref_out, ref_lse = ta.flash_fwd_reference(q, k, v, **kw)
    ref_dq, _, _ = ta.flash_bwd_reference(q, k, v, ref_out, ref_lse, do,
                                          **kw)
    assert dq.dtype == ref_dq.dtype == torch.bfloat16
    _close(dq, ref_dq, what="dq")


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_dkv_within_bf16_tolerance_of_plain(name):
    causal, *shape = CASES[name]
    q, k, v, do = _inputs(*shape, seed=1)
    kw = dict(scale=shape[-1] ** -0.5, causal=causal)
    out, lse = emulated_fwd(q, k, v, **kw)
    dk, dv = emulated_dkv(q, k, v, out, lse, do, **kw)
    ref_out, ref_lse = ta.flash_fwd_reference(q, k, v, **kw)
    _, ref_dk, ref_dv = ta.flash_bwd_reference(q, k, v, ref_out, ref_lse, do,
                                               **kw)
    _close(dk, ref_dk, what="dk")
    _close(dv, ref_dv, what="dv")


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernels_match_jax_reference_and_grad(name):
    causal, *shape = CASES[name]
    q, k, v, do = _inputs(*shape, seed=2)
    kw = dict(scale=shape[-1] ** -0.5, causal=causal)
    out, lse = emulated_fwd(q, k, v, **kw)
    dk, dv = emulated_dkv(q, k, v, out, lse, do, **kw)
    dq = emulated_dq(q, k, v, out, lse, do, **kw)
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    with jax.default_matmul_precision("highest"):
        want = ja.mha_reference(jq, jk, jv, causal=causal)
        grads = jax.grad(
            lambda *a: jnp.sum(ja.mha_reference(*a, causal=causal) * jdo),
            argnums=(0, 1, 2))(jq, jk, jv)
    _close(out, np.asarray(want), what="out")
    for label, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        _close(got, np.asarray(w), what=label)


@pytest.mark.parametrize("which,dtype,source", [
    ("fwd", torch.bfloat16, "flash_attention_sm90"),
    ("dq", torch.bfloat16, "flash_attention_sm90"),
    ("dkv", torch.bfloat16, "flash_attention_sm90"),
    ("fwd", torch.float32, "flash_attention"),
    ("dq", torch.float32, "flash_attention"),
    ("dkv", torch.float32, "flash_attention"),
])
def test_kernel_route_by_dtype(which, dtype, source):
    # bf16 runs all three kernels on the tensor cores, fp32 all three on
    # the CUDA cores. Each route names a source that exists.
    from ray_tpu_torch.ops import _build

    got_source, fn = ta.kernel_route(which, dtype)
    assert got_source == source and got_source in _build.sources()
    assert fn.endswith("_sm90") == (source == "flash_attention_sm90")
