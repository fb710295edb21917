"""Port parity: the paged serving engine of ray_tpu_torch against the JAX
package's, on the tiny fp32 config with the JAX init carried across.

Prefill, one decode tick and whole engine runs (mid-flight arrivals,
slot reuse, waits on a full arena, cancel; bf16 and int8 arenas) are
held to JAX token for token. Sampling cannot match JAX's bits (another
generator), so it is held to fixed-seed determinism and to its own
filtered distribution, which is itself held to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import continuous_batching as jcb
from ray_tpu.models import inference as jinf
from ray_tpu.models import llama as jl
from ray_tpu.models import paged_kv as jkv
from ray_tpu.models import sampling as jsamp
from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import inference as tinf
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import paged_kv as tkv
from ray_tpu_torch.models import sampling as tsamp

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


def _prompt(rng, n):
    return [int(t) for t in rng.integers(0, JCFG.vocab_size, size=n)]


# ------------------------------------------------------- model pieces

@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_forward_paged_matches_jax(params, quantized):
    jp, tp = params
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, JCFG.vocab_size, size=(2, 32)).astype(np.int32)
    pos = np.arange(32, dtype=np.int32)
    L, kvh, d = JCFG.num_layers, JCFG.num_kv_heads, JCFG.head_dim
    empty = jnp.zeros((L, 2, 0, kvh, d), jnp.float32)
    jlog, jst = jcb._prefill_forward_paged(
        jp, jnp.asarray(tokens), jnp.asarray(pos), empty, empty, JCFG,
        quantized)
    tlog, tst = tcb._prefill_forward_paged(
        tp, torch.from_numpy(tokens), torch.from_numpy(pos), None, None,
        TCFG, quantized)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    assert len(tst) == len(jst)
    for a, b in zip(tst, jst):
        assert a.shape == b.shape
        if a.dtype == torch.int8:
            # One int8 step at most, where fp32 K/V land on a .5 tie.
            assert np.abs(a.numpy().astype(int)
                          - np.asarray(b).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    last = torch.tensor([5, 31])
    tlast, _ = tcb._prefill_forward_paged(
        tp, torch.from_numpy(tokens), torch.from_numpy(pos), None, None,
        TCFG, quantized, last_idx=last)
    np.testing.assert_allclose(tlast[:, 0].numpy(),
                               tlog[[0, 1], [5, 31]].numpy(), atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_decode_tick_paged_matches_jax(params, kv_dtype):
    """One tick over four slots: two live, one freed (whole table on the
    garbage block) and one past its reservation (its write must go to
    the garbage block, not alias its last live block)."""
    jp, tp = params
    rng = np.random.default_rng(1)
    bs, nblk = 16, 10
    jc = jkv.PagedKVCache.create(JCFG, nblk, bs, kv_dtype)
    fill = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        arr = getattr(jc, name)
        if arr is None:
            continue
        if arr.dtype == jnp.int8:
            fill[name] = rng.integers(-127, 128, arr.shape).astype(np.int8)
        else:
            fill[name] = (rng.random(arr.shape).astype(np.float32) * 0.05
                          if "scale" in name else
                          rng.standard_normal(arr.shape).astype(np.float32))
    jc = jkv.PagedKVCache(**{n: jnp.asarray(a) for n, a in fill.items()})
    tc = tkv.PagedKVCache(**{n: torch.from_numpy(a.copy())
                             for n, a in fill.items()})
    tables = np.array([[3, 5, 5, 5], [1, 2, 4, 6], [0, 0, 0, 0],
                       [7, 7, 7, 7]], np.int32)
    positions = np.array([20, 63, 0, 17], np.int32)
    limits = np.array([32, 64, 0, 16], np.int32)
    tokens = np.array([11, 200, 0, 42], np.int32)
    jtok, jpos, jcache, _ = jcb._decode_tick_paged(
        jp, *map(jnp.asarray, (tokens, positions, tables, limits)), jc,
        jnp.int32(0), JCFG, use_kernel=False)
    ttok, tpos, tcache, step = tcb._decode_tick_paged(
        tp, *map(torch.from_numpy, (tokens, positions, tables, limits)),
        tc, 0, TCFG, use_kernel=False)
    assert step == 1 and tcache is tc
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for name in fill:
        a, b = getattr(tcache, name).numpy(), np.asarray(getattr(jcache,
                                                                 name))
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(a, b, atol=1e-5)
    # The overrun slot's block 7 is untouched; its token landed in block 0.
    np.testing.assert_array_equal(tcache.k[:, 7].numpy(), fill["k"][:, 7])
    assert not np.array_equal(tcache.k[:, 0, 1].numpy(), fill["k"][:, 0, 1])


def test_lm_head_logits_bf16_matches_jax():
    cfg_j = jl.LlamaConfig.tiny()
    cfg_t = tl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(cfg_j, jax.random.PRNGKey(2)))
    tp = params_from_numpy(jp, "cpu")
    x = np.random.default_rng(2).standard_normal((2, 3, 64)).astype(
        np.float32)
    ref = jinf.lm_head_logits(jnp.asarray(x, jnp.bfloat16), jp, cfg_j)
    got = tinf.lm_head_logits(torch.from_numpy(x).to(torch.bfloat16), tp,
                              cfg_t)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    # bf16 operands, fp32 sums and fp32 output on both sides.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_attend_cached_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    pos = np.array([4, 5, 6, 7, 8], np.int32)
    ref = jinf._attend_cached(*map(jnp.asarray, (q, k, v, pos)), 0.25)
    got = tinf._attend_cached(*map(torch.from_numpy, (q, k, v, pos)), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_buckets_match_jax():
    for n in (0, 1, 15, 16, 17, 100, 513, 2048):
        assert tcb._bucket(n) == jcb._bucket(n)
        assert tcb._bucket(n, floor=1) == jcb._bucket(n, floor=1)
        assert tcb._bucket_floor(n) == jcb._bucket_floor(n)


# ------------------------------------------------------- whole engine

def _engines(params, **kw):
    jp, tp = params
    je = jcb.ContinuousBatcher(JCFG, params=jp, paged=True,
                               prefix_cache=False, use_decode_kernel=False,
                               **kw)
    te = tcb.ContinuousBatcher(TCFG, params=tp, device="cpu", **kw)
    return je, te


def _drive(engine, script, max_steps=400):
    """Run ``script`` ({step: [("submit", prompt, n) | ("cancel", rid)]})
    and record what each step returns."""
    log, results, stats = [], {}, []
    for i in range(max_steps):
        for action in script.get(i, []):
            if action[0] == "submit":
                engine.submit(action[1], max_new_tokens=action[2])
            else:
                log.append(("cancel", action[1], engine.cancel(action[1])))
        out = engine.step()
        log.append(sorted(out.items()))
        results.update(out)
        stats.append((engine.active_count, engine.kv_block_stats()["used"],
                      len(engine._waiting)))
        if not engine.has_work() and i >= max(script):
            break
    counters = (engine.base_tick_count, engine.decoded_tokens,
                engine.prefill_batches, engine.prefill_tokens)
    return log, results, stats, counters


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_greedy_matches_jax(params, kv_dtype):
    """Eight requests through 3 slots and an 11-block arena: bucketed
    batched prefill, slot reuse, a head request waiting on arena blocks,
    mid-flight arrivals and a cancel — every step's finished set and
    every token equal to the JAX engine's."""
    rng = np.random.default_rng(4)
    script = {
        0: [("submit", _prompt(rng, n), m)
            for n, m in [(5, 8), (20, 6), (40, 10), (3, 4)]],
        3: [("submit", _prompt(rng, 70), 12)],      # needs 6 blocks: waits
        6: [("submit", _prompt(rng, 9), 7), ("cancel", 2)],
        9: [("submit", _prompt(rng, 33), 5), ("submit", _prompt(rng, 1), 9)],
    }
    je, te = _engines(params, num_slots=3, max_len=128, block_size=16,
                      num_blocks=12, kv_dtype=kv_dtype)
    jrun, trun = _drive(je, script), _drive(te, script)
    assert trun[0] == jrun[0]                      # per-step outputs
    assert trun[1] == jrun[1] and len(trun[1]) == 7
    assert trun[2] == jrun[2]                      # occupancy per step
    assert trun[3] == jrun[3]                      # counters
    # A queued head waited on arena blocks with a slot free.
    assert any(active < 3 and waiting for active, _, waiting in trun[2])
    assert te.allocator.free_count == 11 and not te.has_work()


def test_engine_token_callback_and_stats_match_jax(params):
    rng = np.random.default_rng(5)
    prompts = [_prompt(rng, n) for n in (12, 30, 64, 7, 50)]
    got = {"j": [], "t": []}
    je, te = _engines(params, num_slots=4, max_len=128, block_size=16)
    je.token_callback = lambda r, t: got["j"].append((r, t))
    te.token_callback = lambda r, t: got["t"].append((r, t))
    for e in (je, te):
        for p in prompts:
            e.submit(p, max_new_tokens=6)
        e.step()
        e.step()
    assert te.kv_block_stats() == je.kv_block_stats()
    assert te.active_count == je.active_count == 4
    assert te.run_to_completion() == je.run_to_completion()
    assert got["t"] == got["j"] and len(got["t"]) == 30


def test_submit_validation(params):
    _, tp = params
    e = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=100,
                              num_blocks=4, block_size=16, device="cpu")
    rid0 = e.submit([1, 2, 3], max_new_tokens=0)
    assert e.step() == {rid0: []}
    with pytest.raises(ValueError, match="max_len"):
        e.submit([1] * 90, max_new_tokens=20)
    with pytest.raises(ValueError, match="arena"):
        e.submit([1] * 60, max_new_tokens=10)   # 5 blocks > 3 usable
    with pytest.raises(ValueError, match="power of two"):
        tcb.ContinuousBatcher(TCFG, params=tp, block_size=24, device="cpu")
    rid = e.submit([4, 5], max_new_tokens=3)
    assert e.cancel(rid) and not e.cancel(rid) and not e.has_work()


@pytest.mark.parametrize("kwargs,item", [
    ({"prefix_cache": True}, "prefix cache"),
    ({"sync_every": 4}, "buffered decode"),
    ({"spec_k": 2}, "speculative decode"),
    ({"role": "prefill"}, "prefill/decode split"),
])
def test_unported_features_raise(params, kwargs, item):
    _, tp = params
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as info:
        tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=64,
                              device="cpu", **kwargs)
    assert item in str(info.value)


def test_prefix_cache_defaults_off(params, monkeypatch):
    _, tp = params
    monkeypatch.delenv("RAY_TPU_PREFIX_CACHE", raising=False)
    e = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=64,
                              device="cpu")
    assert e.prefix_cache is False and e.paged and not e.use_decode_kernel


# ------------------------------------------------------------ sampling

@pytest.mark.parametrize("temperature,top_p", [(1.0, 1.0), (0.7, 0.9),
                                               (1.3, 0.5)])
def test_filtered_probs_matches_jax(temperature, top_p):
    logits = np.random.default_rng(6).standard_normal((4, 50)).astype(
        np.float32) * 2
    ref = jsamp.filtered_probs(jnp.asarray(logits), temperature, top_p)
    got = tsamp.filtered_probs(torch.from_numpy(logits), temperature, top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_sample_tokens_follow_filtered_probs():
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]])
    probs = tsamp.filtered_probs(logits, 0.8, 0.9)[0]
    n = 40000
    draws = tsamp.sample_tokens(logits.expand(n, -1),
                                tsamp.step_key(7, 0), 0.8, 0.9)
    freq = torch.bincount(draws.long(), minlength=6).double() / n
    # Binomial standard error <= 0.0025 per bin at n=40000; 5 sigma.
    np.testing.assert_allclose(freq.numpy(), probs.double().numpy(),
                               atol=0.0125)
    assert freq[probs == 0].sum() == 0            # top-p cut never drawn
    greedy = tsamp.sample_tokens(logits, None, 0.0, 1.0)
    assert greedy.tolist() == [0] and greedy.dtype == torch.int32


def test_step_key_streams():
    a = torch.rand(4, generator=tsamp.step_key(1, 5))
    assert torch.equal(a, torch.rand(4, generator=tsamp.step_key(1, 5)))
    for other in (tsamp.step_key(2, 5), tsamp.step_key(1, 6),
                  tsamp.step_key(1, 5, salt=1)):
        assert not torch.equal(a, torch.rand(4, generator=other))


def test_sampled_engine_deterministic_per_seed(params):
    _, tp = params
    rng = np.random.default_rng(8)
    prompts = [_prompt(rng, n) for n in (6, 25, 40)]

    def run(seed):
        e = tcb.ContinuousBatcher(
            TCFG, params=tp, num_slots=2, max_len=128, block_size=16,
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
