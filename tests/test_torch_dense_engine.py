"""Port parity: the dense serving plane of ray_tpu_torch (``KVCache``,
``_forward_cached``, ``LlamaGenerator`` and ``ContinuousBatcher(paged=
False)``) against the JAX package's, on the tiny fp32 config with the
JAX init carried across.

The forward over a cache, one dense decode tick and whole engine runs
with slot churn are held to JAX token for token (and logits and caches
within 1e-5); the dense engine is also held to the port's own paged
engine and to the generator. Sampled generation cannot match
``jax.random.categorical``'s bits, so it is held to determinism.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import continuous_batching as jcb
from ray_tpu.models import inference as jinf
from ray_tpu.models import llama as jl
from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import inference as tinf
from ray_tpu_torch.models import llama as tl

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(3))
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


def _prompt(rng, n):
    return [int(t) for t in rng.integers(1, JCFG.vocab_size, size=n)]


def _random_caches(rng, b, s_max):
    shape = (JCFG.num_layers, b, s_max, JCFG.num_kv_heads, JCFG.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return (jinf.KVCache(k=jnp.asarray(k), v=jnp.asarray(v)),
            tinf.KVCache(k=torch.from_numpy(k.copy()),
                         v=torch.from_numpy(v.copy())))


# ------------------------------------------------------- model pieces

def test_kv_cache_create_matches_jax():
    j = jinf.KVCache.create(JCFG, 3, 40)
    t = tinf.KVCache.create(TCFG, 3, 40, device="cpu")
    assert tuple(t.k.shape) == j.k.shape and tuple(t.v.shape) == j.v.shape
    assert t.k.dtype == torch.float32 and not t.k.any() and not t.v.any()
    b16 = tinf.KVCache.create(tl.LlamaConfig.tiny(), 1, 8, device="cpu")
    assert b16.k.dtype == torch.bfloat16


def test_forward_cached_matches_jax(params):
    """Prefill of two prompts into random (stale) caches, then one
    decode step: logits and every cache entry within 1e-5."""
    jp, tp = params
    rng = np.random.default_rng(0)
    jc, tc = _random_caches(rng, 2, 48)
    tokens = rng.integers(0, JCFG.vocab_size, size=(2, 16)).astype(np.int32)
    pos = np.arange(16, dtype=np.int32)
    jlog, jc = jinf._forward_cached(jp, jnp.asarray(tokens),
                                    jnp.asarray(pos), jc, JCFG)
    tlog, tc2 = tinf._forward_cached(tp, torch.from_numpy(tokens),
                                     torch.from_numpy(pos), tc, TCFG)
    assert tc2.k is tc.k                        # written in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    nxt = np.asarray(jnp.argmax(jlog[:, -1], axis=-1)).astype(np.int32)
    jlog, jc = jinf._forward_cached(jp, jnp.asarray(nxt[:, None]),
                                    jnp.asarray([16]), jc, JCFG)
    tlog, tc = tinf._forward_cached(tp, torch.from_numpy(nxt[:, None]),
                                    torch.tensor([16]), tc, TCFG)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_forward_cached_last_idx_picks_rows(params):
    _, tp = params
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, 256, size=(2, 16)).astype(np.int64))
    pos = torch.arange(16)
    full, _ = tinf._forward_cached(
        tp, tokens, pos, tinf.KVCache.create(TCFG, 2, 32, "cpu"), TCFG)
    last, _ = tinf._forward_cached(
        tp, tokens, pos, tinf.KVCache.create(TCFG, 2, 32, "cpu"), TCFG,
        last_idx=torch.tensor([3, 15]))
    assert last.shape == (2, 1, 256)
    np.testing.assert_allclose(last[:, 0].numpy(),
                               full[[0, 1], [3, 15]].numpy(), atol=1e-6)


def test_scatter_slot_matches_jax():
    rng = np.random.default_rng(2)
    cache = rng.standard_normal((3, 10, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 4)).astype(np.float32)
    pos = np.array([0, 9, 4], np.int32)
    ref = jcb._scatter_slot(jnp.asarray(cache), jnp.asarray(new),
                            jnp.asarray(pos))
    t = torch.from_numpy(cache.copy())
    rows = tcb._slot_rows(torch.from_numpy(pos), 10)
    got = tcb._scatter_slot(t, torch.from_numpy(new), rows)
    assert got is t                             # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # Positions past the cache clamp to its last row, as in JAX.
    past = np.array([12, 3, 10], np.int32)
    ref = jcb._scatter_slot(ref, jnp.asarray(new), jnp.asarray(past))
    tcb._scatter_slot(t, torch.from_numpy(new),
                      tcb._slot_rows(torch.from_numpy(past), 10))
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_tick_matches_jax(params, pallas_interpret, use_kernel):
    """One dense tick over four slots (one freed at position 0, one at
    the last cache row) against JAX's tick with its reference or its
    Pallas kernel in interpret mode; the port runs its plain version."""
    jp, tp = params
    rng = np.random.default_rng(3)
    jc, tc = _random_caches(rng, 4, 64)
    tokens = np.array([11, 200, 0, 42], np.int32)
    positions = np.array([20, 63, 0, 37], np.int32)
    jtok, jpos, jc, _ = jcb._decode_tick(
        jp, jnp.asarray(tokens), jnp.asarray(positions), jc, jnp.int32(0),
        JCFG, use_kernel=use_kernel)
    ttok, tpos, tc2, step = tcb._decode_tick(
        tp, torch.from_numpy(tokens), torch.from_numpy(positions), tc, 0,
        TCFG, use_kernel=False)
    assert step == 1 and tc2 is tc
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ------------------------------------------------------------ generator

def test_generator_greedy_matches_jax(params):
    jp, tp = params
    prompt = np.random.default_rng(4).integers(
        0, JCFG.vocab_size, size=(2, 9)).astype(np.int32)
    jgen = jinf.LlamaGenerator(JCFG, params=jp, max_len=64)
    tgen = tinf.LlamaGenerator(TCFG, params=tp, max_len=64, device="cpu")
    ref = np.asarray(jgen.generate(prompt, max_new_tokens=8))
    got = tgen.generate(prompt, max_new_tokens=8)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_generator_matches_full_forward():
    """KV-cached decode equals the argmax of a full forward over the
    growing sequence (the analog of tests/test_inference.py)."""
    gen = tinf.LlamaGenerator(TCFG, max_len=64, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, TCFG.vocab_size, (2, 8)))
    out = gen.generate(prompt, max_new_tokens=6, temperature=0.0)
    seq = prompt
    with torch.no_grad():
        for _ in range(6):
            logits = tl.forward(gen.params, seq, TCFG)
            seq = torch.cat([seq, logits[:, -1].argmax(-1)[:, None]], dim=1)
    np.testing.assert_array_equal(out.numpy(), seq[:, 8:].numpy())


def test_generator_sampling_deterministic_per_seed(params):
    _, tp = params
    gen = tinf.LlamaGenerator(TCFG, params=tp, max_len=32, device="cpu")
    prompt = [[5, 9, 13, 2]]
    a = gen.generate(prompt, max_new_tokens=10, temperature=1.0, seed=0)
    assert torch.equal(a, gen.generate(prompt, max_new_tokens=10,
                                       temperature=1.0, seed=0))
    assert not torch.equal(a, gen.generate(prompt, max_new_tokens=10,
                                           temperature=1.0, seed=1))
    assert ((a >= 0) & (a < TCFG.vocab_size)).all()
    with pytest.raises(ValueError, match="max_len"):
        gen.generate(prompt, max_new_tokens=29)


def test_generator_without_gpu_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.LlamaGenerator(TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcb.ContinuousBatcher(TCFG, paged=False, num_slots=2, max_len=64)


# ------------------------------------------------------- whole engine

def _drive(engine, script, max_steps=400):
    """Run ``script`` ({step: [("submit", prompt, n) | ("cancel", rid)]})
    and record what each step returns."""
    log, results, occupancy = [], {}, []
    for i in range(max_steps):
        for action in script.get(i, []):
            if action[0] == "submit":
                engine.submit(action[1], max_new_tokens=action[2])
            else:
                log.append(("cancel", action[1], engine.cancel(action[1])))
        out = engine.step()
        log.append(sorted(out.items()))
        results.update(out)
        occupancy.append((engine.active_count, len(engine._waiting)))
        if not engine.has_work() and i >= max(script):
            break
    counters = (engine.base_tick_count, engine.decoded_tokens,
                engine.prefill_batches, engine.prefill_tokens)
    return log, results, occupancy, counters


def test_dense_engine_matches_jax(params):
    """Nine requests through 3 slots: bucketed batched prefill (batch
    padding rows repeat a request), slot reuse, mid-flight arrivals and
    a cancel -- every step's finished set, every token, the occupancy
    and the counters equal to the JAX dense engine's."""
    jp, tp = params
    rng = np.random.default_rng(5)
    script = {
        0: [("submit", _prompt(rng, n), m)
            for n, m in [(5, 8), (20, 6), (40, 10), (3, 4)]],
        3: [("submit", _prompt(rng, 70), 12)],
        6: [("submit", _prompt(rng, 9), 7), ("cancel", 2)],
        9: [("submit", _prompt(rng, 33), 5), ("submit", _prompt(rng, 1), 9),
            ("submit", _prompt(rng, 17), 3)],
    }
    je = jcb.ContinuousBatcher(JCFG, params=jp, num_slots=3, max_len=128,
                               paged=False, use_decode_kernel=False)
    te = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=3, max_len=128,
                               paged=False, device="cpu")
    assert not je.paged and not te.paged
    jrun, trun = _drive(je, script), _drive(te, script)
    assert trun[0] == jrun[0]                      # per-step outputs
    assert trun[1] == jrun[1] and len(trun[1]) == 8
    assert trun[2] == jrun[2]                      # occupancy per step
    assert trun[3] == jrun[3]                      # counters
    assert not te.has_work() and sorted(te._free) == [0, 1, 2]


def test_dense_matches_paged_and_generator(params):
    """Token-for-token identical greedy output from the dense engine, the
    paged engine at two block sizes and the sequential generator, with
    slot churn (5 requests through 3 slots)."""
    _, tp = params
    rng = np.random.default_rng(21)
    reqs = [(_prompt(rng, n), m)
            for n, m in [(5, 7), (33, 4), (17, 9), (9, 3), (40, 6)]]
    results = {}
    for key, kwargs in {"dense": dict(paged=False),
                        "paged32": dict(paged=True, block_size=32),
                        "paged64": dict(paged=True, block_size=64)}.items():
        eng = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=3,
                                    max_len=128, device="cpu", **kwargs)
        assert eng.paged is kwargs["paged"]
        rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        out = eng.run_to_completion()
        results[key] = [out[r] for r in rids]
    assert results["dense"] == results["paged32"] == results["paged64"]
    gen = tinf.LlamaGenerator(TCFG, params=tp, max_len=128, device="cpu")
    for (prompt, m), toks in zip(reqs, results["dense"]):
        assert toks == gen.generate([prompt], max_new_tokens=m)[0].tolist()


def test_dense_token_callback_and_stats_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(6)
    prompts = [_prompt(rng, n) for n in (12, 30, 64, 7, 50)]
    got = {"j": [], "t": []}
    je = jcb.ContinuousBatcher(JCFG, params=jp, num_slots=4, max_len=128,
                               paged=False, use_decode_kernel=False)
    te = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=4, max_len=128,
                               paged=False, device="cpu")
    je.token_callback = lambda r, t: got["j"].append((r, t))
    te.token_callback = lambda r, t: got["t"].append((r, t))
    for e in (je, te):
        for p in prompts:
            e.submit(p, max_new_tokens=6)
        e.step()
        e.step()
    assert te.kv_block_stats() == je.kv_block_stats() == {
        "used": 0, "total": 0, "cached": 0, "shared": 0, "live_tokens": 0,
        "frag_ratio": 0.0}
    assert te.active_count == je.active_count == 4
    assert te.run_to_completion() == je.run_to_completion()
    assert got["t"] == got["j"] and len(got["t"]) == 30


@pytest.mark.parametrize("kwargs", [
    {"block_size": 24}, {"block_size": 4}, {"kv_dtype": "int8"},
    {"prefix_cache": True}, {"num_blocks": 2}])
def test_dense_engine_options_as_jax(params, kwargs):
    """On a dense engine block_size is not validated, kv_dtype resolves
    to None and prefix_cache to False, all without raising, as in JAX;
    a paged engine still validates them."""
    jp, tp = params
    je = jcb.ContinuousBatcher(JCFG, params=jp, num_slots=2, max_len=64,
                               paged=False, use_decode_kernel=False,
                               **kwargs)
    te = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=64,
                               paged=False, device="cpu", **kwargs)
    for name in ("paged", "block_size", "kv_dtype", "prefix_cache"):
        assert getattr(te, name) == getattr(je, name), name
    assert te.kv_dtype is None and te.prefix_cache is False
    rid = te.submit([1, 2, 3], max_new_tokens=2)
    assert len(te.run_to_completion()[rid]) == 2


def test_paged_engine_still_validates_block_size(params):
    _, tp = params
    with pytest.raises(ValueError, match="power of two"):
        tcb.ContinuousBatcher(TCFG, params=tp, block_size=24, device="cpu")


def test_paged_off_by_env(params, monkeypatch):
    _, tp = params
    monkeypatch.setenv("RAY_TPU_PAGED_KV", "0")
    e = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=64,
                              device="cpu")
    assert e.paged is False and isinstance(e.cache, tinf.KVCache)
    assert tuple(e.cache.k.shape) == (2, 2, 64, 2, 16)
    assert tcb._resolve_paged(True) is True


def test_dense_engine_kernel_on_cpu_raises(params):
    _, tp = params
    with pytest.raises(RuntimeError, match="CUDA"):
        tcb.ContinuousBatcher(TCFG, params=tp, paged=False, num_slots=2,
                              max_len=64, device="cpu",
                              use_decode_kernel=True)
    e = tcb.ContinuousBatcher(TCFG, params=tp, paged=False, num_slots=2,
                              max_len=64, device="cpu")
    assert e.use_decode_kernel is False


def test_dense_submit_validation(params):
    _, tp = params
    e = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=100,
                              paged=False, device="cpu")
    rid0 = e.submit([1, 2, 3], max_new_tokens=0)
    assert e.step() == {rid0: []}
    with pytest.raises(ValueError, match="max_len"):
        e.submit([1] * 90, max_new_tokens=20)
    rid = e.submit([1] * 60, max_new_tokens=40)      # no arena to outgrow
    assert e.cancel(rid) and not e.cancel(rid) and not e.has_work()


def test_dense_sampled_engine_deterministic_per_seed(params):
    _, tp = params
    rng = np.random.default_rng(8)
    prompts = [_prompt(rng, n) for n in (6, 25, 40)]

    def run(seed):
        e = tcb.ContinuousBatcher(
            TCFG, params=tp, num_slots=2, max_len=128, paged=False,
            device="cpu", sampling={"temperature": 1.0, "top_p": 0.95,
                                    "seed": seed})
        rids = [e.submit(p, max_new_tokens=12) for p in prompts]
        out = e.run_to_completion()
        return [out[r] for r in rids]

    first = run(0)
    assert run(0) == first
    assert run(1) != first
    assert all(len(o) == 12 and all(0 <= t < 256 for t in o)
               for o in first)
