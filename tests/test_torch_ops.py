"""Port parity: ray_tpu_torch norms and RoPE against the JAX package.

Same inputs (numpy, seeded) through both; fp32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import continuous_batching as jcb
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rope as trope

ATOL = 1e-6


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 128)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, *shape, scale=3.0), _rand(rng, shape[-1])
    ref = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=1e-6)


def test_rms_norm_bf16_keeps_dtype():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_rand(rng, 4, 32)).to(torch.bfloat16)
    w = torch.ones(32, dtype=torch.bfloat16)
    out = tnorms.rms_norm(x, w)
    assert out.dtype == torch.bfloat16
    ref = jnorms.rms_norm(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          jnp.ones(32, jnp.bfloat16))
    # One bf16 rounding of the same fp32 result.
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    x, w, b = _rand(rng, 4, 48, scale=2.0), _rand(rng, 48), _rand(rng, 48)
    ref = np.asarray(jnorms.layer_norm(*map(jnp.asarray, (x, w, b))))
    got = tnorms.layer_norm(*map(torch.from_numpy, (x, w, b))).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_frequencies_positions_match_jax(theta):
    # Positions up to the engine's max_len at Llama-3's theta: both sides
    # compute the fp32 angles the same way; cos/sin agree to an ulp.
    pos = np.array([0, 1, 17, 511, 1024, 2047], np.int32)
    jc, js = jrope.rope_frequencies(128, 0, theta, positions=jnp.asarray(pos))
    tc, ts = trope.rope_frequencies(128, 0, theta,
                                    positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    small_j = jrope.rope_frequencies(16, 64, theta)
    small_t = trope.rope_frequencies(16, 64, theta)
    for a, b in zip(small_t, small_j):
        assert a.shape == (64, 8)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 10, 4, 16)
    cos, sin = trope.rope_frequencies(16, 10, 10000.0)
    got = trope.apply_rope(torch.from_numpy(x), cos, sin).numpy()
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos.numpy()),
                           jnp.asarray(sin.numpy()))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def test_apply_rope_batched_matches_jax():
    rng = np.random.default_rng(4)
    x = _rand(rng, 3, 1, 4, 16)
    cos, sin = trope.rope_frequencies(
        16, 0, 500000.0, positions=torch.tensor([0, 9, 77]))
    got = tcb._apply_rope_batched(torch.from_numpy(x), cos, sin).numpy()
    ref = jcb._apply_rope_batched(jnp.asarray(x), jnp.asarray(cos.numpy()),
                                  jnp.asarray(sin.numpy()))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
