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
