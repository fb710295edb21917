"""Port parity of the prefix cache under block pressure (cached blocks
reclaimed before admission blocks, the admission probe, a sibling's
eviction mid-decode, reset) and one request sequence held to the JAX
engine (prefix prefill, greedy tokens, prefix counters and
``kv_block_stats``). Split from ``tests/test_torch_prefix_cache.py``,
whose fixtures and helpers it uses, so the test runner can spread the
file's minutes over its workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import continuous_batching as jcb
from ray_tpu.models import paged_kv as jkv
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import paged_kv as tkv
from test_torch_prefix_cache import (BS, JCFG, TCFG, _engine, _ints,
                                     _reference, setup)


def test_cached_blocks_reclaimed_before_admission_blocks(setup):
    """A finished prompt's blocks park in the LRU; a request needing the
    whole arena evicts them and admits on its first step."""
    _, tp, gen = setup
    eng = _engine(tp, num_blocks=7, prefix_cache=True)
    p1 = list(range(1, 1 + 2 * BS + 2))
    r1 = eng.submit(p1, max_new_tokens=4)
    assert eng.run_to_completion()[r1] == _reference(gen, p1, 4)
    assert eng.kv_block_stats()["cached"] == 2
    p2 = list(range(150, 150 + 4 * BS))
    r2 = eng.submit(p2, max_new_tokens=2 * BS - 3)      # 6 blocks: all
    eng.step()
    assert eng.active_count == 1, "cached blocks blocked admission"
    assert eng.kv_block_stats()["cached"] == 0
    assert eng.run_to_completion()[r2] == _reference(gen, p2, 2 * BS - 3)


def test_admission_probe_agrees_with_admission_under_shared_pressure(setup):
    """_can_admit_head counts a parked matched block once: pinning the
    match revives it from the LRU without freeing anything."""
    _, tp, gen = setup
    eng = _engine(tp, num_blocks=7, prefix_cache=True)
    p1 = list(range(1, 1 + 2 * BS + 2))
    eng.submit(p1, max_new_tokens=BS - 4)               # 3 blocks
    eng.run_to_completion()
    assert eng.kv_block_stats()["cached"] == 2
    assert eng.allocator.free_count == 4
    filler = list(range(100, 100 + 2 * BS + 2))
    rf = eng.submit(filler, max_new_tokens=2 * BS - 4)  # 4 blocks
    eng.step()
    assert eng.active_count == 1 and eng.allocator.free_count == 0
    r2 = eng.submit(list(p1), max_new_tokens=2 * BS - 4)
    assert eng._can_admit_head() is False
    eng.step()
    assert eng.active_count == 1, "admission should be arena-blocked"
    out = eng.run_to_completion()
    assert len(out[rf]) == 2 * BS - 4
    assert out[r2] == _reference(gen, p1, 2 * BS - 4)


def test_sibling_eviction_mid_decode_leaves_survivor_exact(setup):
    """Cancel one of two prefix-sharing requests mid-decode: the shared
    blocks stay pinned by the survivor, whose output equals an
    undisturbed run's."""
    _, tp, gen = setup
    shared = _ints(np.random.default_rng(11), 2 * BS + 1)
    pa, pb = shared + [3, 4], shared + [5]
    eng = _engine(tp, prefix_cache=True)
    eng.submit(list(pa), max_new_tokens=4)
    eng.run_to_completion()
    rb = eng.submit(list(pb), max_new_tokens=20)
    baseline = eng.run_to_completion()[rb]

    eng = _engine(tp, prefix_cache=True)
    eng.submit(list(pa), max_new_tokens=4)
    eng.run_to_completion()                       # pa indexed its prefix
    ra = eng.submit(list(pa), max_new_tokens=40)  # sharer A (long)
    rb = eng.submit(list(pb), max_new_tokens=20)  # sharer B (survivor)
    for _ in range(5):
        eng.step()
    assert eng.active_count == 2
    assert eng.kv_block_stats()["shared"] == 2
    assert eng.cancel(ra)
    out = eng.run_to_completion()
    assert ra not in out
    assert out[rb] == baseline == _reference(gen, pb, 20)


def test_reset_clears_index_and_reuses_cleanly(setup):
    """reset() rebuilds the arena, so the index restarts cold: stale
    entries would alias zeroed blocks."""
    _, tp, gen = setup
    p = list(range(1, 1 + 2 * BS + 2))
    eng = _engine(tp, prefix_cache=True)
    eng.submit(list(p), max_new_tokens=4)
    eng.run_to_completion()
    assert eng.kv_block_stats()["cached"] > 0
    eng.reset()
    assert eng.kv_block_stats()["cached"] == 0
    assert eng._prefix.indexed_count == 0
    hit0 = eng.prefix_hit_tokens
    rid = eng.submit(list(p), max_new_tokens=4)
    out = eng.run_to_completion()
    assert eng.prefix_hit_tokens == hit0, "matched a cleared index"
    assert out[rid] == _reference(gen, p, 4)


# ------------------------------------------------------ against JAX

@pytest.mark.parametrize("quantized", [False, True])
def test_prefix_prefill_matches_jax(setup, quantized):
    """The prefix gathered from the arena a layer at a time, then the
    suffix prefill over it, against JAX's gather and forward."""
    jp, tp, _ = setup
    rng = np.random.default_rng(12)
    kv_dtype = "int8" if quantized else "bf16"
    jc = jkv.PagedKVCache.create(JCFG, 6, BS, kv_dtype)
    fill = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        arr = getattr(jc, name)
        if arr is None:
            continue
        fill[name] = (rng.integers(-127, 128, arr.shape).astype(np.int8)
                      if arr.dtype == jnp.int8 else
                      rng.random(arr.shape).astype(np.float32) * 0.05
                      if "scale" in name else
                      rng.standard_normal(arr.shape).astype(np.float32))
    tc = tkv.PagedKVCache(**{n: torch.from_numpy(a.copy())
                             for n, a in fill.items()})
    ptables = np.array([[3, 1], [5, 2]], np.int64)        # N=2, m=2
    flat = ptables.reshape(-1)
    pk = tcb._ArenaPrefix(tc.k, tc.k_scale, torch.from_numpy(flat), 2,
                          torch.float32)
    pv = tcb._ArenaPrefix(tc.v, tc.v_scale, torch.from_numpy(flat), 2,
                          torch.float32)

    def jgather(name):
        a = jnp.asarray(fill[name])[:, flat]
        if quantized:
            a = (a.astype(jnp.float32)
                 * jnp.asarray(fill[name + "_scale"])[:, flat][..., None])
        return a.reshape(a.shape[0], 2, 2 * BS, *a.shape[3:])
    jpk, jpv = jgather("k"), jgather("v")
    for li in range(JCFG.num_layers):
        np.testing.assert_array_equal(pk[li].numpy(), np.asarray(jpk[li]))
        np.testing.assert_array_equal(pv[li].numpy(), np.asarray(jpv[li]))
    tokens = rng.integers(0, JCFG.vocab_size, size=(2, 16)).astype(np.int32)
    pos = 2 * BS + np.arange(16, dtype=np.int32)
    jlog, _ = jax.jit(jcb._prefill_forward_paged, static_argnums=(5, 6))(
        jp, jnp.asarray(tokens), jnp.asarray(pos), jpk, jpv, JCFG, quantized)
    tlog, _ = tcb._prefill_forward_paged(
        tp, torch.from_numpy(tokens), torch.from_numpy(pos), pk, pv, TCFG,
        quantized)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)


def _run_sequence(eng, reqs):
    """Submit in waves (a later wave reuses the earlier waves' prefixes)
    and record every step's finished set and the counters."""
    log = []
    for wave in reqs:
        for p, m in wave:
            eng.submit(list(p), max_new_tokens=m)
        while eng.has_work():
            log.append(sorted(eng.step().items()))
    return log, (eng.prefix_hit_tokens, eng.prefix_miss_tokens,
                 eng.prefix_hit_requests, eng.prefill_tokens,
                 eng.prefill_batches, eng.kv_block_stats())


@pytest.mark.parametrize("kv_dtype,sync_every", [("bf16", 1), ("int8", 4)])
def test_engine_matches_jax_with_prefix_cache(setup, kv_dtype, sync_every):
    """One request sequence with shared prefixes, bucketed-down matches,
    same-round twins and arena pressure through the JAX engine and the
    port: identical greedy tokens step by step, equal prefix counters,
    prefill tokens and kv_block_stats."""
    jp, tp, _ = setup
    rng = np.random.default_rng(13)
    sys_a, sys_b = _ints(rng, 3 * BS + 2), _ints(rng, BS + 1)
    reqs = [[(sys_a + _ints(rng, 3), 6), (sys_b + [9], 5),
             (sys_a + _ints(rng, 3), 4)],
            [(sys_a + _ints(rng, 7), 7), (sys_b + _ints(rng, 20), 3),
             (_ints(rng, 40), 5)],
            [(sys_a + _ints(rng, 1), 9)]]
    kw = dict(num_slots=3, max_len=128, block_size=BS, num_blocks=14,
              kv_dtype=kv_dtype, prefix_cache=True, sync_every=sync_every)
    je = jcb.ContinuousBatcher(JCFG, params=jp, use_decode_kernel=False,
                               **kw)
    te = tcb.ContinuousBatcher(TCFG, params=tp, device="cpu", **kw)
    jrun, trun = _run_sequence(je, reqs), _run_sequence(te, reqs)
    assert trun[0] == jrun[0]
    assert trun[1] == jrun[1]
    # Waves 2-3: sys_a's 3 matchable blocks bucket down to 2, twice, and
    # sys_b's 1 block once.
    assert te.prefix_hit_tokens == 5 * BS
