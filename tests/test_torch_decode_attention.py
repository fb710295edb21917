"""Port parity: dense decode attention of ray_tpu_torch against the JAX
package.

The plain version (``decode_attention_reference``, and
``decode_attention`` on CPU tensors) runs here against JAX's reference
and against JAX's Pallas ``_decode_kernel`` in interpret mode (the
``pallas_interpret`` fixture). The CUDA kernel itself runs only on the
card: ``tests/test_torch_kernels_gpu.py`` (``pytest -m gpu``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import decode_attention as tda

# ``ray_tpu.ops`` re-exports the function under the module's name.
jda = importlib.import_module("ray_tpu.ops.decode_attention")

# fp32: the same math in another summation order. bf16: the same bf16
# inputs and fp32 math; the outputs differ by at most one bf16 rounding.
TOL = {"fp32": 2e-6, "bf16": 2e-2}


def _inputs(b=3, hq=4, hkv=2, d=16, s_max=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    ck = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    cv = rng.standard_normal((b, s_max, hkv, d)).astype(np.float32)
    return q, ck, cv


def _j(arrays, dtype="fp32"):
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return [jnp.asarray(a, jt) for a in arrays]


def _t(arrays, dtype="fp32"):
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return [torch.from_numpy(a).to(tt) for a in arrays]


def _close(got, ref, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype] / 2)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_plain_matches_jax_reference_gqa(hq, hkv):
    q, ck, cv = _inputs(hq=hq, hkv=hkv)
    pos = np.array([0, 17, 127], np.int32)       # one live entry ... full
    ref = jda.decode_attention_reference(*_j((q, ck, cv)), jnp.asarray(pos))
    got = tda.decode_attention_reference(*_t((q, ck, cv)),
                                         torch.from_numpy(pos))
    _close(got, ref, "fp32")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
def test_plain_matches_jax_pallas_kernel_interpret(pallas_interpret, hq,
                                                   hkv, dtype):
    q, ck, cv = _inputs(hq=hq, hkv=hkv, seed=1)
    pos = np.array([0, 63, 127], np.int32)
    ref = jda.decode_attention(*_j((q, ck, cv), dtype), jnp.asarray(pos),
                               use_kernel=True)
    got = tda.decode_attention(*_t((q, ck, cv), dtype),
                               torch.from_numpy(pos))
    assert got.dtype == (torch.bfloat16 if dtype == "bf16"
                         else torch.float32)
    _close(got, ref, dtype)


@pytest.mark.parametrize("block_k", [32, 64])
def test_plain_matches_multi_block_kernel(pallas_interpret, block_k):
    # block_k < s_max runs the TPU kernel's running max/sum rescale
    # across k-blocks; the port's answer does not depend on block_k.
    q, ck, cv = _inputs(seed=2)
    pos = np.array([5, 63, 127], np.int32)
    ref = jda.decode_attention(*_j((q, ck, cv)), jnp.asarray(pos),
                               use_kernel=True, block_k=block_k)
    got = tda.decode_attention(*_t((q, ck, cv)), torch.from_numpy(pos),
                               block_k=block_k)
    _close(got, ref, "fp32")


def test_plain_ragged_s_max_and_scale(pallas_interpret):
    # S_max = 100 is no multiple of 64 (the CUDA kernel's last tile is
    # ragged); a given scale reaches the softmax.
    q, ck, cv = _inputs(b=4, s_max=100, seed=3)
    pos = np.array([0, 63, 64, 99], np.int32)
    ref = jda.decode_attention(*_j((q, ck, cv)), jnp.asarray(pos), 0.3,
                               use_kernel=True, block_k=100)
    got = tda.decode_attention(*_t((q, ck, cv)), torch.from_numpy(pos), 0.3)
    _close(got, ref, "fp32")


def test_positions_past_cache_attend_everything():
    q, ck, cv = _inputs(s_max=32, seed=4)
    pos = np.array([31, 40, 1000], np.int32)
    ref = jda.decode_attention_reference(*_j((q, ck, cv)), jnp.asarray(pos))
    got = tda.decode_attention(*_t((q, ck, cv)), torch.from_numpy(pos))
    _close(got, ref, "fp32")
    full = tda.decode_attention(*_t((q, ck, cv)),
                                torch.full((3,), 31, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), full.numpy())


def test_strided_layer_view_matches_contiguous():
    # The engine passes cache.k[li], a view of an [L, B, S, KVH, D]
    # tensor: the answer is the same as for a contiguous copy.
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 3, 48, 2, 16)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 3, 48, 2, 16)).astype(
        np.float32))
    pos = torch.tensor([3, 30, 47])
    view = tda.decode_attention(q, k[1], v[1], pos)
    copy = tda.decode_attention(q, k[1].contiguous(), v[1].contiguous(), pos)
    np.testing.assert_array_equal(view.numpy(), copy.numpy())


def test_unfilled_tail_is_masked():
    # Whatever sits past a slot's position never reaches its output.
    q, ck, cv = _inputs(seed=6)
    pos = torch.tensor([4, 50, 90])
    a = tda.decode_attention(*_t((q, ck, cv)), pos)
    ck2, cv2 = ck.copy(), cv.copy()
    for i, p in enumerate(pos.tolist()):
        ck2[i, p + 1:] = 1e3
        cv2[i, p + 1:] = -1e3
    b = tda.decode_attention(*_t((q, ck2, cv2)), pos)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("s_max,d,hq,hkv,block_k", [
    (512, 128, 16, 16, 512), (1024, 128, 32, 8, 512),
    (2048, 128, 32, 8, 512), (512, 96, 16, 16, 512),
    (512, 128, 16, 3, 512), (1000, 128, 32, 8, 512),
    (1000, 128, 32, 8, 1000), (100, 128, 8, 2, 512),
    (768, 256, 8, 8, 256), (768, 64, 8, 8, 256)])
def test_decode_applicable_matches_jax(s_max, d, hq, hkv, block_k):
    assert tda.decode_applicable(s_max, d, hq, hkv, block_k=block_k) == \
        jda.decode_applicable(s_max, d, hq, hkv, block_k=block_k)


def test_use_kernel_on_cpu_raises():
    q, ck, cv = _inputs()
    pos = torch.tensor([1, 2, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        tda.decode_attention(*_t((q, ck, cv)), pos, use_kernel=True)
    before = tda.decode_attention.launches
    tda.decode_attention(*_t((q, ck, cv)), pos)
    tda.decode_attention(*_t((q, ck, cv)), pos, use_kernel=False)
    assert tda.decode_attention.launches == before   # plain: no count


def test_dispatcher_argument_checks():
    _, ck, cv = _inputs()
    with pytest.raises(ValueError, match="multiple"):
        tda.decode_attention(torch.zeros(3, 3, 16), *_t((ck, cv)),
                             torch.tensor([1, 2, 3]))
