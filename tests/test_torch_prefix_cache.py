"""Port parity: the paged engine's prefix cache (radix block index,
suffix-only prefill over a prefix gathered from the arena, LRU eviction)
in ray_tpu_torch against the JAX package's, on the tiny fp32 config with
the same weights on both sides.

Mirrors every case of ``tests/test_prefix_cache.py`` on the port (the
plain attention route: the CUDA kernel's case is the ``gpu`` test in
``tests/test_torch_kernels_gpu.py``), with the port's own
``LlamaGenerator`` as the sequential reference, and holds one request
sequence to the JAX engine: the same greedy tokens and the same prefix
counters, prefill tokens and ``kv_block_stats``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import continuous_batching as jcb
from ray_tpu.models import llama as jl
from ray_tpu.models import paged_kv as jkv
from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import inference as tinf
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import paged_kv as tkv

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
BS = 16  # block size used throughout: small enough for tiny prompts


@pytest.fixture(scope="module")
def setup():
    # The port draws the weights and JAX gets the same numbers through
    # numpy (JAX's eager init costs seconds of per-op compiles).
    tp = tl.init_params(TCFG, torch.Generator().manual_seed(3), "cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    gen = tinf.LlamaGenerator(TCFG, params=tp, max_len=128, device="cpu")
    return jp, tp, gen


def _reference(gen, prompt, n):
    return gen.generate([list(prompt)], max_new_tokens=n)[0].tolist()


def _engine(tp, **kwargs):
    kwargs.setdefault("num_slots", 3)
    kwargs.setdefault("max_len", 128)
    kwargs.setdefault("block_size", BS)
    return tcb.ContinuousBatcher(TCFG, params=tp, device="cpu", **kwargs)


def _ints(rng, n):
    return list(map(int, rng.integers(1, 250, size=n)))


# ------------------------------------------------------- radix index unit

def test_radix_index_match_insert_release_evict():
    idx = tkv.RadixBlockIndex()
    prompt = list(range(100, 100 + 3 * BS + 5))
    chunks = tkv.prompt_chunks(prompt, BS)
    assert len(chunks) == 3

    created = idx.insert(chunks, [5, 6, 7])
    assert [n.block for n in created] == [5, 6, 7]
    assert idx.shared_count == 3 and idx.cached_count == 0

    # A second reader pins the same nodes; a divergent tail stops the walk.
    matched = idx.match(chunks[:2])
    assert [n.block for n in matched] == [5, 6]
    other = idx.insert(chunks[:2] + [tuple(range(7000, 7000 + BS))],
                       [5, 6, 9], start=2)
    assert [n.block for n in other] == [9]

    # Conflicting insert (same chunk, different block) indexes nothing.
    assert idx.insert([chunks[0]], [42]) == []

    # Release to refcount 0 parks in the LRU; nothing pinned is evicted.
    idx.release(created)          # root chain now held only by `matched`
    assert idx.evict(10) == [7]   # leaf-first: only the unpinned tail
    idx.release(matched)
    idx.release(other)
    assert idx.shared_count == 0 and idx.cached_count == 3
    got = idx.evict(10)
    assert set(got) == {5, 6, 9}
    assert got.index(5) == len(got) - 1, "root evicted before its leaves"
    assert idx.cached_count == 0 and idx.indexed_count == 0
    assert idx.match(chunks) == []


def test_radix_index_matches_jax_under_random_ops():
    """The same random stream of insert / match / release / evict on the
    port's index and the JAX package's gives the same answers and
    counts at every step."""
    rng = np.random.default_rng(0)
    vocab = [tuple([t] * 4) for t in range(3)]      # 3 chunk values
    idxs = (tkv.RadixBlockIndex(), jkv.RadixBlockIndex())
    held = ([], [])                                 # pinned node lists
    next_block = 1
    for _ in range(400):
        op = rng.integers(0, 4)
        chunks = [vocab[int(c)] for c in rng.integers(0, 3, size=rng.integers(
            1, 5))]
        if op == 0:
            start = idxs[0].match_len(chunks)
            assert start == idxs[1].match_len(chunks)
            outs = []
            for i, (idx, h) in enumerate(zip(idxs, held)):
                matched = idx.match(chunks[:start])
                blocks = [n.block for n in matched] + list(
                    range(next_block, next_block + len(chunks) - start))
                created = idx.insert(chunks, blocks, start=start)
                h.append(matched + created)
                outs.append([n.block for n in matched + created])
            next_block += len(chunks)
            assert outs[0] == outs[1]
        elif op == 1 and held[0]:
            k = int(rng.integers(0, len(held[0])))
            for idx, h in zip(idxs, held):
                idx.release(h.pop(k))
        elif op == 2:
            want = int(rng.integers(0, 4))
            assert idxs[0].evict(want) == idxs[1].evict(want)
        else:
            assert ([n.block for n in idxs[0].match_nodes(chunks)]
                    == [n.block for n in idxs[1].match_nodes(chunks)])
        for name in ("cached_count", "shared_count", "indexed_count"):
            assert getattr(idxs[0], name) == getattr(idxs[1], name), name


def test_match_is_capped_so_one_prompt_token_remains(setup):
    """A prompt of exactly k full blocks may match at most k-1 (the first
    generated token samples from the last prompt position's logits), and
    the chunking equals JAX's."""
    _, tp, _ = setup
    prompt = list(range(1, 1 + 2 * BS))     # exactly 2 blocks
    assert tkv.prompt_chunks(prompt, BS) == jkv.prompt_chunks(prompt, BS)
    assert tkv.prompt_chunks(prompt + [7], BS) == jkv.prompt_chunks(
        prompt + [7], BS)
    eng = _engine(tp, prefix_cache=True)
    assert eng._match_cap({"prompt": prompt}) == 1
    assert eng._match_cap({"prompt": prompt + [7]}) == 2


# ------------------------------------------------- reuse skips prefill

def test_prefix_reuse_skips_prefill_and_stays_exact(setup):
    _, tp, gen = setup
    rng = np.random.default_rng(5)
    shared = _ints(rng, 2 * BS + 3)
    tails = [_ints(rng, 4) for _ in range(3)]
    eng = _engine(tp, prefix_cache=True)
    outs = []
    for t in tails:
        rid = eng.submit(shared + t, max_new_tokens=5)
        outs.append(eng.run_to_completion()[rid])
    # First request is cold; the two followers each reuse 2 full blocks.
    assert eng.prefix_hit_tokens == 2 * 2 * BS
    assert eng.prefix_hit_requests == 2
    assert 0 < eng.prefix_hit_rate < 1
    first_len = len(shared) + 4
    assert eng.prefill_tokens == first_len + 2 * (first_len - 2 * BS)
    for t, toks in zip(tails, outs):
        assert toks == _reference(gen, shared + t, 5)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefix_cache_on_off_identical(setup, kv_dtype):
    """Greedy outputs are identical with the prefix cache on and off, on
    model-dtype and int8 arenas (int8 prefill attends the dequantized
    values the arena holds, so a sharer reads back what the first
    prefill attended); model-dtype outputs equal the generator's."""
    _, tp, gen = setup
    rng = np.random.default_rng(6)
    shared = _ints(rng, 35)
    reqs = [(shared + _ints(rng, n), m) for n, m in [(5, 6), (2, 4), (9, 7)]]
    reqs.append((_ints(rng, 20), 5))
    results = {}
    for on in (True, False):
        eng = _engine(tp, prefix_cache=on, kv_dtype=kv_dtype)
        outs = []
        for p, m in reqs:              # sequential: real reuse
            rid = eng.submit(list(p), max_new_tokens=m)
            outs.append(eng.run_to_completion()[rid])
        results[on] = outs
        assert (eng.prefix_hit_tokens > 0) is on
    assert results[True] == results[False]
    if kv_dtype == "bf16":
        for (p, m), toks in zip(reqs, results[True]):
            assert toks == _reference(gen, p, m)


def test_prefix_cache_buffered_parity(setup):
    """Buffered decode (sync_every > 1) with prefix reuse equals per-tick
    sync."""
    _, tp, gen = setup
    rng = np.random.default_rng(7)
    shared = _ints(rng, 2 * BS + 1)
    reqs = [(shared + [7, 8], 9), (shared + [9], 6)]
    results = {}
    for k in (1, 4):
        eng = _engine(tp, prefix_cache=True, sync_every=k)
        outs = []
        for p, m in reqs:
            rid = eng.submit(list(p), max_new_tokens=m)
            outs.append(eng.run_to_completion()[rid])
        results[k] = outs
        assert eng.prefix_hit_tokens > 0
    assert results[1] == results[4]
    for (p, m), toks in zip(reqs, results[1]):
        assert toks == _reference(gen, p, m)


def test_same_round_cold_twins_are_safe(setup):
    """Two identical prompts admitted in ONE round are both cold (matching
    sees only blocks already prefilled): outputs exact, and the loser of
    the insert race keeps exclusive blocks that free cleanly."""
    _, tp, gen = setup
    p = _ints(np.random.default_rng(8), 2 * BS + 2)
    eng = _engine(tp, prefix_cache=True)
    r1 = eng.submit(list(p), max_new_tokens=5)
    r2 = eng.submit(list(p), max_new_tokens=5)
    out = eng.run_to_completion()
    assert eng.prefix_hit_tokens == 0
    assert out[r1] == out[r2] == _reference(gen, p, 5)
    # The loser's 3 blocks are free again; the winner's 2 full blocks
    # are parked.
    assert eng.kv_block_stats()["cached"] == 2
    assert eng.allocator.free_count == eng.num_blocks - 1 - 2
    r3 = eng.submit(list(p), max_new_tokens=5)
    out3 = eng.run_to_completion()
    assert eng.prefix_hit_tokens == 2 * BS
    assert out3[r3] == out[r1]


# --------------------------------------------- eviction under pressure

def test_live_shared_blocks_never_reclaimed(setup):
    """Arena pressure must not steal blocks a live slot references: the
    blocked request waits, admits after the sharer finishes, and every
    output is exact."""
    _, tp, gen = setup
    eng = _engine(tp, num_blocks=7, prefix_cache=True)
    p1 = list(range(1, 1 + BS + 4))                      # 2 blocks
    r1 = eng.submit(p1, max_new_tokens=8)
    eng.step()                                           # r1 live
    p2 = list(range(100, 100 + 3 * BS + 1))
    r2 = eng.submit(p2, max_new_tokens=BS + 8)           # 5 blocks
    eng.step()
    assert eng.active_count == 1 and len(eng._waiting) == 1
    stats = eng.kv_block_stats()
    assert stats["shared"] == 1            # r1's prompt block is pinned
    out = eng.run_to_completion()
    assert out[r1] == _reference(gen, p1, 8)
    assert out[r2] == _reference(gen, p2, BS + 8)


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
