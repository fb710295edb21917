"""Port parity: paged decode attention, int8 KV quantization and the
block allocator of ray_tpu_torch against the JAX package.

The plain version (``paged_attention_reference``) runs here on the CPU
against JAX's reference and against JAX's Pallas kernel in interpret
mode (the ``pallas_interpret`` fixture). The CUDA kernel itself runs only
on the card: ``tests/test_torch_kernels_gpu.py`` (``pytest -m gpu``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import paged_kv as jkv
from ray_tpu.ops import paged_decode_attention as jpda
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.paged_kv import (GARBAGE_BLOCK, BlockAllocator,
                                           PagedKVCache, quantize_kv,
                                           resolve_kv_dtype)
from ray_tpu_torch.ops import paged_decode_attention as tpda


def _paged_inputs(b=3, hq=4, hkv=2, d=16, bs=32, nb_slot=4, seed=0,
                  positions=(0, 37, 127)):
    """q, a scattered arena (each slot's logical blocks at permuted
    physical ids, so only a real TABLE gather passes) and tables whose
    dead tail entries repeat the last live block. numpy fp32."""
    rng = np.random.default_rng(seed)
    nb_total = b * nb_slot + 1                    # + garbage block 0
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    ak = rng.standard_normal((nb_total, bs, hkv, d)).astype(np.float32)
    av = rng.standard_normal((nb_total, bs, hkv, d)).astype(np.float32)
    ids = rng.permutation(np.arange(1, nb_total)).reshape(b, nb_slot)
    tables = ids.astype(np.int32)
    for i, p in enumerate(positions):
        live = min(p // bs + 1, nb_slot)
        tables[i, live:] = tables[i, live - 1]
    return q, ak, av, tables, np.asarray(positions, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_plain_matches_jax_reference_gqa(hq, hkv):
    q, ak, av, tables, pos = _paged_inputs(hq=hq, hkv=hkv)
    ref = jpda.paged_attention_reference(*_j(q, ak, av, tables, pos))
    got = tpda.paged_attention_reference(*_t(q, ak, av, tables, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_plain_matches_jax_pallas_kernel_interpret(pallas_interpret, hq,
                                                   hkv):
    q, ak, av, tables, pos = _paged_inputs(hq=hq, hkv=hkv, d=128, seed=1)
    ref = jpda.paged_decode_attention(*_j(q, ak, av, tables, pos),
                                      use_kernel=True)
    got = tpda.paged_decode_attention(*_t(q, ak, av, tables, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_ragged_positions_straddle_blocks(pallas_interpret):
    # last-in-block, first-in-next-block, mid-block, one full block, and
    # the final position.
    q, ak, av, tables, pos = _paged_inputs(
        b=5, d=128, seed=3, positions=(31, 32, 45, 63, 127))
    ref = jpda.paged_decode_attention(*_j(q, ak, av, tables, pos),
                                      use_kernel=True)
    got = tpda.paged_decode_attention(*_t(q, ak, av, tables, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_dead_tail_entries_are_masked():
    """Dead tail entries are masked whatever block they name: a table
    whose tail points at the garbage block gives the same output."""
    q, ak, av, tables, pos = _paged_inputs(positions=(5, 40, 70))
    other = tables.copy()
    for i, p in enumerate(pos):
        other[i, p // 32 + 1:] = GARBAGE_BLOCK
    a = tpda.paged_attention_reference(*_t(q, ak, av, tables, pos))
    b = tpda.paged_attention_reference(*_t(q, ak, av, other, pos))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_bf16_arena_matches_jax():
    q, ak, av, tables, pos = _paged_inputs(seed=4, positions=(3, 50, 100))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, ak, av))
    ref = jpda.paged_attention_reference(jq, jk, jv, *_j(tables, pos))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, ak, av))
    got = tpda.paged_attention_reference(tq, tk, tv, *_t(tables, pos))
    assert got.dtype == torch.bfloat16
    # Same bf16 inputs, fp32 math: outputs differ by at most one bf16
    # rounding.
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_plain_int8_arena_matches_jax(pallas_interpret, use_kernel):
    q, ak, av, tables, pos = _paged_inputs(seed=5, d=128,
                                           positions=(9, 33, 120))
    jkq, jks = jkv.quantize_kv(jnp.asarray(ak))
    jvq, jvs = jkv.quantize_kv(jnp.asarray(av))
    ref = jpda.paged_decode_attention(
        *_j(q), jkq, jvq, *_j(tables, pos), k_scale=jks, v_scale=jvs,
        use_kernel=use_kernel)
    kq, ks = quantize_kv(torch.from_numpy(ak))
    vq, vs = quantize_kv(torch.from_numpy(av))
    got = tpda.paged_decode_attention(*_t(q), kq, vq, *_t(tables, pos),
                                      k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 3.0, 1e-3])
def test_quantize_kv_bit_equal_to_jax(scale):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((5, 7, 4, 32)) * scale).astype(np.float32)
    x[1, 2] = 0.0                                  # zero-scale guard
    x[2, 0, 0, :4] = [0.5, -0.5, 1.5, 127.0]       # ties + the max
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_gather_and_dequantize_match_jax():
    rng = np.random.default_rng(7)
    arena = rng.standard_normal((6, 8, 2, 16)).astype(np.float32)
    tables = np.array([[3, 1], [5, 5]], np.int32)
    np.testing.assert_array_equal(
        tpda.gather_kv(*_t(arena, tables)).numpy(),
        np.asarray(jpda.gather_kv(*_j(arena, tables))))
    q8 = rng.integers(-127, 128, (6, 8, 2, 16)).astype(np.int8)
    sc = rng.random((6, 8, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tpda.dequantize_block(*_t(q8, sc)).numpy(),
        np.asarray(jpda.dequantize_block(*_j(q8, sc))))


def test_paged_cache_create_dtypes():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    dense = PagedKVCache.create(cfg, num_blocks=9, block_size=16,
                                device="cpu")
    assert not dense.quantized and dense.k_scale is None
    assert dense.k.shape[1:3] == (9, 16) and dense.block_size == 16
    assert dense.num_blocks == 9
    q8 = PagedKVCache.create(cfg, num_blocks=9, block_size=16,
                             kv_dtype="int8", device="cpu")
    assert q8.quantized and q8.k.dtype == torch.int8
    assert q8.k_scale.shape == q8.k.shape[:-1]
    assert q8.token_bytes() < dense.token_bytes()
    from ray_tpu.models import llama as jl
    jdense = jkv.PagedKVCache.create(
        jl.LlamaConfig.tiny(dtype=jnp.float32), 9, 16)
    assert dense.token_bytes() == jdense.token_bytes()
    with pytest.raises(ValueError):
        resolve_kv_dtype("fp4")


def test_paged_applicable():
    assert tpda.paged_applicable(64, 128, 32, 8)
    assert tpda.paged_applicable(16, 16, 4, 2)
    assert not tpda.paged_applicable(64, 100, 32, 8)    # d % 8
    assert not tpda.paged_applicable(64, 512, 32, 8)    # d > 256
    assert not tpda.paged_applicable(64, 128, 16, 3)    # hq % hkv
    assert tpda.paged_applicable(64, 128, 64, 1)        # any group
    assert not tpda.paged_applicable(0, 128, 32, 8)     # empty blocks


# ------------------------------------------------------- block allocator

def test_allocator_reuse_after_release():
    a = BlockAllocator(num_blocks=8)            # 7 usable (0 reserved)
    first = a.alloc(4)
    assert len(first) == 4 and GARBAGE_BLOCK not in first
    second = a.alloc(3)
    assert a.free_count == 0 and a.used_count == 7
    assert a.alloc(1) is None                    # exhausted: no partial
    a.free(first)
    assert a.free_count == 4
    again = a.alloc(4)
    assert sorted(again) == sorted(first), "freed blocks not reused"
    assert a.alloc(1) is None
    a.free(second)
    a.free(again)
    assert a.free_count == 7 and a.used_count == 0


def test_allocator_same_order_as_jax():
    ours, theirs = BlockAllocator(10), jkv.BlockAllocator(10)
    for n, free_idx in [(3, None), (2, 0), (4, None), (1, 1)]:
        got = [ours.alloc(n), theirs.alloc(n)]
        assert got[0] == got[1]
        if free_idx is not None:
            ours.free(got[0][free_idx:free_idx + 1])
            theirs.free(got[1][free_idx:free_idx + 1])
    assert ours.free_count == theirs.free_count


def test_allocator_zero_and_param_validation():
    a = BlockAllocator(num_blocks=4)
    assert a.alloc(0) == []            # must NOT drain the free list
    assert a.free_count == 3
    from ray_tpu_torch.models.sampling import SamplingParams
    with pytest.raises(ValueError, match="top_p"):
        SamplingParams(temperature=0.7, top_p=0.0)
    with pytest.raises(ValueError, match="temperature"):
        SamplingParams(temperature=-1.0)


def test_allocator_rejects_bad_frees():
    a = BlockAllocator(num_blocks=4)
    got = a.alloc(2)
    with pytest.raises(ValueError):
        a.free([GARBAGE_BLOCK])
    with pytest.raises(ValueError):
        a.free([99])
    a.free(got)
    with pytest.raises(ValueError):
        a.free(got)                              # double free
    with pytest.raises(ValueError):
        BlockAllocator(1)


# ------------------------------------------------------------ dispatch

def test_use_kernel_on_cpu_raises():
    q, ak, av, tables, pos = _paged_inputs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpda.paged_decode_attention(*_t(q, ak, av, tables, pos),
                                    use_kernel=True)
    before = tpda.paged_decode_attention.launches
    tpda.paged_decode_attention(*_t(q, ak, av, tables, pos))
    assert tpda.paged_decode_attention.launches == before  # plain: no count


def test_engine_without_gpu_or_device_raises(monkeypatch):
    from ray_tpu_torch.models.continuous_batching import ContinuousBatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(cfg, num_slots=2, max_len=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(cfg, num_slots=2, max_len=64, device="cpu",
                          use_decode_kernel=True)


def test_dispatcher_argument_checks():
    q, ak, av, tables, pos = _paged_inputs()
    with pytest.raises(ValueError, match="multiple"):
        tpda.paged_decode_attention(torch.zeros(3, 3, 16),
                                    *_t(ak, av, tables, pos))
    with pytest.raises(ValueError, match="together"):
        tpda.paged_decode_attention(*_t(q, ak, av, tables, pos),
                                    k_scale=torch.ones(13, 32, 2))
