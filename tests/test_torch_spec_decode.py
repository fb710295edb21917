"""Port parity: speculative decode in the paged engine (self-draft and
external drafter, batched verify, ``spec_commit``, adaptive k) in
ray_tpu_torch against the JAX package's, on the tiny fp32 config with
the same weights on both sides.

Mirrors every case of ``tests/test_spec_decode.py`` on the port (the
plain attention route: the CUDA kernels' cases are the ``gpu`` tests in
``tests/test_torch_kernels_gpu.py``), with the port's own
``LlamaGenerator`` as the sequential reference, and holds the engine,
``spec_commit`` and the draft and verify passes to JAX's: greedy tokens
equal, fp32 logits within 1e-5, arena contents equal. Sampled draws
cannot match JAX's bits (another generator), so sampled spec decode is
held to its distribution and to fixed-seed replay.
"""

import dataclasses

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
from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import inference as tinf
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import paged_kv as tkv
from ray_tpu_torch.models import sampling as tsamp

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
SPEC = dict(spec_k=2, spec_draft_layers=1, spec_adaptive=False)
# JAX's passes, compiled once for every case that calls them (eager
# dispatch of their scans costs seconds).
J_VERIFY = jax.jit(jcb._verify_forward_paged, static_argnums=(6, 7))
J_DRAFT = jax.jit(jcb._draft_forward_paged, static_argnums=(1, 7, 8))
J_DENSE = jax.jit(jcb._draft_forward_dense, static_argnums=(4,))
J_SPEC = jax.jit(jcb._spec_tick_paged, static_argnums=(7, 8, 9, 10, 11))


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


def _ints(rng, n):
    return list(map(int, rng.integers(1, 250, size=n)))


def _run(tp, reqs, **kw):
    eng = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=4, max_len=128,
                                paged=True, device="cpu", **kw)
    rids = [eng.submit(list(p), max_new_tokens=m) for p, m in reqs]
    out = eng.run_to_completion()
    return [out[r] for r in rids], eng


def _run_jax(jp, reqs, **kw):
    kw.setdefault("use_decode_kernel", False)
    eng = jcb.ContinuousBatcher(JCFG, params=jp, num_slots=4, max_len=128,
                                paged=True, **kw)
    rids = [eng.submit(list(p), max_new_tokens=m) for p, m in reqs]
    out = eng.run_to_completion()
    return [[int(t) for t in out[r]] for r in rids], eng


def _counters(eng):
    return (eng.decoded_tokens, eng.spec_tick_count, eng.base_tick_count,
            eng.spec_draft_tokens, eng.spec_accepted_tokens)


# ------------------------------------------------------------ parity

def _matrix_requests():
    rng = np.random.default_rng(40)
    shared = _ints(rng, 32)
    return [(shared + _ints(rng, 4), 6), (shared + _ints(rng, 2), 5),
            (_ints(rng, 7), 7)]


def test_greedy_parity_matrix_paged_kernel(setup, pallas_interpret):
    """The JAX spec engine through its paged Pallas kernel (interpret
    mode) gives the port's spec tokens and counters."""
    jp, tp, _ = setup
    reqs = _matrix_requests()
    kw = dict(block_size=16, prefix_cache=False, **SPEC)
    spec, eng = _run(tp, reqs, **kw)
    jax_out, jeng = _run_jax(jp, reqs, use_decode_kernel=True, **kw)
    assert jeng.use_decode_kernel
    assert spec == jax_out
    assert _counters(eng) == _counters(jeng)


def test_eos_and_max_new_cut_spec_windows_exactly(setup):
    """A window past a request's end leaks nothing: max_new cuts the
    committed window mid-tick, and an EOS inside it finishes the request
    there."""
    _, tp, gen = setup
    prompt = _ints(np.random.default_rng(41), 9)
    ref = _reference(gen, prompt, 8)
    # Full-depth self-draft: every window commits k+1 = 3 tokens, so
    # max_new = 8 ends mid-window.
    full = dict(spec_k=2, spec_draft_layers=TCFG.num_layers,
                spec_adaptive=False)
    out, eng = _run(tp, [(prompt, 8)], **full)
    assert out[0] == ref
    assert eng.decoded_tokens == 7       # token 1 comes from the prefill
    out, _ = _run(tp, [(prompt, 8)], eos_token=ref[2], **full)
    assert out[0] == ref[:3]


def test_external_drafter_parity_and_acceptance(setup):
    """An external drafter (own params, own dense cache) rides the same
    verify path: greedy tokens equal the generator's, and a drafter that
    is the target accepts far above chance. (Its step against JAX's:
    test_draft_forward_dense_matches_jax, test_spec_tick_matches_jax.)"""
    _, tp, gen = setup
    rng = np.random.default_rng(42)
    reqs = [(_ints(rng, n), m) for n, m in [(6, 8), (11, 6)]]
    drafter = tinf.ExternalLlamaDrafter(TCFG, params=tp)
    out, eng = _run(tp, reqs, spec_k=2, spec_adaptive=False,
                    drafter=drafter)
    assert out == [_reference(gen, p, m) for p, m in reqs]
    assert eng.spec_draft_tokens > 0
    assert eng.spec_accept_rate > 0.2
    assert eng._draft_cache.k.shape == (TCFG.num_layers, 4, 128,
                                        TCFG.num_kv_heads, TCFG.head_dim)


# ------------------------------------------------------- spec_commit

def test_spec_commit_greedy_acceptance_counts():
    """Greedy spec_commit: counts = leading exact matches + 1, committed
    row = the target's argmax stream; the same as JAX's on the same
    logits, on planted and on random drafts."""
    v = 11
    logits = np.full((2, 3, v), -10.0, np.float32)
    argmaxes = [[3, 5, 7], [2, 4, 6]]
    for b, row in enumerate(argmaxes):
        for i, t in enumerate(row):
            logits[b, i, t] = 10.0
    drafts = np.array([[3, 5], [9, 4]], np.int32)     # b0: all match
    committed, counts = tsamp.spec_commit(
        torch.from_numpy(drafts), None, torch.from_numpy(logits), 0,
        tsamp.SamplingParams())
    assert counts.tolist() == [3, 1]
    assert committed.tolist() == argmaxes
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 5, v)).astype(np.float32)
    drafts = np.where(rng.random((64, 4)) < 0.7,
                      logits[:, :4].argmax(-1),
                      rng.integers(0, v, (64, 4))).astype(np.int32)
    tc, tn = tsamp.spec_commit(torch.from_numpy(drafts), None,
                               torch.from_numpy(logits), 3,
                               tsamp.SamplingParams())
    jc, jn = jsamp.spec_commit(jnp.asarray(drafts), None,
                               jnp.asarray(logits), jnp.int32(3),
                               jsamp.SamplingParams())
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert sorted(set(tn.tolist())) == [1, 2, 3, 4, 5]
    # k = 0: one token, the argmax.
    c0, n0 = tsamp.spec_commit(torch.zeros((64, 0), dtype=torch.int32),
                               None, torch.from_numpy(logits[:, :1]), 0,
                               tsamp.SamplingParams())
    assert n0.tolist() == [1] * 64
    np.testing.assert_array_equal(c0[:, 0].numpy(), logits[:, 0].argmax(-1))


def test_spec_commit_preserves_target_distribution():
    """Rejection sampling (Leviathan et al. 2023): the committed first
    token's marginal is the target's filtered distribution even when the
    proposal q is badly mismatched. JAX's construction (1,500 draws,
    total variation under 0.06, top_p-masked tokens never committed),
    with the draws as 1,500 independent rows of one call; the bonus token
    (every draft accepted) is drawn from p_{k+1}."""
    v, n = 6, 1500
    sp = tsamp.SamplingParams(temperature=0.9, top_p=0.8, seed=5)
    rng = np.random.default_rng(123)
    p_logits = torch.from_numpy(
        (rng.standard_normal((1, 2, v)) * 2.0).astype(np.float32))
    q_logits = torch.from_numpy(
        (rng.standard_normal((1, 1, v)) * 2.0).astype(np.float32))
    # filtered_probs itself is held to JAX's in test_torch_engine.py.
    q = tsamp.filtered_probs(q_logits, sp.temperature, sp.top_p)
    target = tsamp.filtered_probs(p_logits, sp.temperature, sp.top_p)
    qd = q[0, 0].double().numpy()
    drafts = rng.choice(v, size=(n, 1), p=qd / qd.sum())
    committed, counts = tsamp.spec_commit(
        torch.from_numpy(drafts.astype(np.int32)), q.expand(n, 1, v),
        p_logits.expand(n, 2, v), 0, sp)
    want = target[0, 0].numpy()
    empirical = np.bincount(committed[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(empirical - want).sum()
    assert tv < 0.06, (tv, empirical, want)
    assert empirical[want == 0].sum() == 0
    bonus = committed[counts == 2, 1]
    assert len(bonus) and bool((target[0, 1, bonus.long()] > 0).all())
    # A replayed step commits the same tokens; another step draws anew.
    again, _ = tsamp.spec_commit(
        torch.from_numpy(drafts.astype(np.int32)), q.expand(n, 1, v),
        p_logits.expand(n, 2, v), 0, sp)
    other, _ = tsamp.spec_commit(
        torch.from_numpy(drafts.astype(np.int32)), q.expand(n, 1, v),
        p_logits.expand(n, 2, v), 1, sp)
    assert torch.equal(again, committed) and not torch.equal(other,
                                                             committed)


# ------------------------------------------------ k = 0 and adaptive k

def test_spec_k0_is_exactly_the_old_path(setup):
    """spec_k=0 is the plain engine: the same tokens and the same plain
    ticks as an engine built without spec arguments, no spec tick, no
    drafter and no look-ahead; a spec request on the dense plane, a
    negative k, a drafter of another vocabulary and a drafter on another
    device are errors."""
    _, tp, gen = setup
    reqs = [(_ints(np.random.default_rng(44), 5), 6)]
    out, eng = _run(tp, reqs, spec_k=0)
    plain, eng0 = _run(tp, reqs)
    assert out == plain == [_reference(gen, *reqs[0])]
    assert eng.base_tick_count == eng0.base_tick_count > 0
    assert eng.spec_tick_count == 0 and not eng._spec_ticks
    assert eng.drafter is None and eng._draft_cache is None
    assert eng.max_blocks == -(-128 // 64)
    with pytest.raises(ValueError, match="paged"):
        tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=128,
                              paged=False, spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=128,
                              spec_k=-1, device="cpu")
    bad = dataclasses.replace(TCFG, vocab_size=TCFG.vocab_size * 2)
    with pytest.raises(ValueError, match="vocab"):
        tcb.ContinuousBatcher(
            TCFG, params=tp, num_slots=2, max_len=128, spec_k=2,
            device="cpu", drafter=tinf.ExternalLlamaDrafter(bad,
                                                            device="cpu"))
    elsewhere = {k: ({n: t.to("meta") for n, t in v.items()}
                     if isinstance(v, dict) else v.to("meta"))
                 for k, v in tp.items()}
    with pytest.raises(ValueError, match="live on meta"):
        tcb.ContinuousBatcher(
            TCFG, params=tp, num_slots=2, max_len=128, spec_k=2,
            device="cpu", drafter=tinf.ExternalLlamaDrafter(
                TCFG, params=elsewhere))


def test_spec_env_settings_match_jax(setup, monkeypatch):
    """The RAY_TPU_SPEC_* settings resolve as JAX's do."""
    jp, tp, _ = setup
    monkeypatch.setenv("RAY_TPU_SPEC_K", "4")
    monkeypatch.setenv("RAY_TPU_SPEC_ADAPTIVE", "0")
    monkeypatch.setenv("RAY_TPU_SPEC_DRAFT_LAYERS", "2")
    te = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=128,
                               block_size=16, device="cpu")
    je = jcb.ContinuousBatcher(JCFG, params=jp, num_slots=2, max_len=128,
                               block_size=16)
    for name in ("spec_k", "spec_adaptive", "spec_draft_layers",
                 "_spec_ladder_ks", "max_blocks", "num_blocks"):
        assert getattr(te, name) == getattr(je, name), name
    assert te._spec_ladder_ks == [1, 2, 4]
    assert isinstance(te.drafter, tinf.SelfDrafter)
    monkeypatch.delenv("RAY_TPU_SPEC_DRAFT_LAYERS")
    assert tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=128,
                                 device="cpu").spec_draft_layers == 1
    with pytest.raises(ValueError, match="spec_draft_layers"):
        tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=128,
                              spec_draft_layers=3, device="cpu")
    assert [tcb._spec_ladder(k) for k in (1, 3, 8)] == [
        jcb._spec_ladder(k) for k in (1, 3, 8)] == [[1], [1, 2, 3],
                                                    [1, 2, 4, 8]]


def test_adaptive_k_probe_reenters_after_park(setup, monkeypatch):
    """Parked at k=0, the controller probes the bottom rung again after
    RAY_TPU_SPEC_PROBE_TICKS boundaries."""
    monkeypatch.setenv("RAY_TPU_SPEC_PROBE_TICKS", "3")
    monkeypatch.setenv("RAY_TPU_SPEC_WINDOW", "8")
    _, tp, gen = setup
    prompt = _ints(np.random.default_rng(46), 5)
    eng = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=128,
                                spec_k=2, spec_adaptive=True,
                                drafter=tinf.SelfDrafter(1), device="cpu")
    assert eng._spec_probe_after == 3 and eng._spec_window.maxlen == 8
    eng._spec_cur_k = 0              # as if the ladder bottomed out
    rid = eng.submit(prompt, max_new_tokens=12)
    out = eng.run_to_completion()
    assert out[rid] == _reference(gen, prompt, 12)
    assert eng.base_tick_count >= 2, "probe fired before its countdown"
    assert eng.spec_tick_count > 0, "probe never re-entered speculation"


# ------------------------------------------ reservations and accounting

def test_lookahead_blocks_reserved_and_reported(setup):
    """Reservations carry spec_k look-ahead tokens and the slot reports
    them (``la_blocks``); the blocks come back when the request ends.
    Spec-off engines reserve without look-ahead."""
    _, tp, _ = setup
    eng = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=64,
                                block_size=8, spec_k=4, spec_adaptive=False,
                                spec_draft_layers=1, prefix_cache=False,
                                device="cpu")
    # ceil((5 + 10 + 4) / 8) = 3 blocks; without look-ahead 2.
    assert eng._blocks_needed(5, 10) == 3
    assert eng._lookahead_blocks(5, 10) == 1
    assert eng.max_blocks == -(-(64 + 4) // 8)
    free0 = eng.allocator.free_count
    eng.submit([1, 2, 3, 4, 5], max_new_tokens=10)
    eng.step()
    (slot,) = eng._slots
    assert len(eng._slot_blocks[slot]) == 3
    assert eng._slots[slot]["la_blocks"] == 1
    assert eng.allocator.free_count == free0 - 3
    eng.run_to_completion()
    assert eng.allocator.free_count == free0
    eng0 = tcb.ContinuousBatcher(TCFG, params=tp, num_slots=2, max_len=64,
                                 block_size=8, device="cpu")
    assert eng0._blocks_needed(5, 10) == 2
    assert eng0._lookahead_blocks(5, 10) == 0


def test_multi_token_tick_accounting(setup):
    """Decode tokens come from committed counts, not tick counts: a
    perfect drafter commits k+1 a tick and the books agree."""
    _, tp, gen = setup
    prompt = _ints(np.random.default_rng(47), 6)
    full = dict(spec_k=2, spec_draft_layers=TCFG.num_layers,
                spec_adaptive=False)
    out, eng = _run(tp, [(prompt, 12)], **full)
    assert out[0] == _reference(gen, prompt, 12)
    assert eng.decoded_tokens == 11     # token 1 comes from the prefill
    assert eng.spec_accept_rate == 1.0
    assert eng.spec_tick_count == 4     # 11 tokens in 3-token windows
    assert eng.spec_draft_tokens == 8 and eng.spec_accepted_tokens == 8


def test_reset_restores_spec_state(setup):
    """reset() rebuilds the drafter's cache and restarts k at spec_k."""
    _, tp, gen = setup
    prompt = _ints(np.random.default_rng(48), 7)
    eng = tcb.ContinuousBatcher(
        TCFG, params=tp, num_slots=2, max_len=128, spec_k=2,
        spec_adaptive=True, device="cpu",
        drafter=tinf.ExternalLlamaDrafter(TCFG, params=tp))
    eng.submit(prompt, max_new_tokens=6)
    eng.step()
    assert eng._draft_cache.k.abs().sum() > 0
    eng._spec_cur_k = 0
    eng.reset()
    assert eng._spec_cur_k == 2 and not eng._spec_window
    assert eng._draft_cache.k.abs().sum() == 0
    rid = eng.submit(prompt, max_new_tokens=6)
    assert eng.run_to_completion()[rid] == _reference(gen, prompt, 6)


# ------------------------------------------- draft and verify passes

def _arenas(kv_dtype, seed, nblk=10, bs=16):
    """The same random arena for JAX and the port."""
    rng = np.random.default_rng(seed)
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
    return jc, tc, fill


def _assert_arenas_equal(tcache, jcache, fill):
    # Block 0 is the garbage block, where duplicate writes keep an
    # arbitrary winner on either side; every other block must agree.
    for name in fill:
        a = getattr(tcache, name).numpy()[:, 1:]
        b = np.asarray(getattr(jcache, name))[:, 1:]
        if a.dtype == np.int8:
            # One int8 step at most, where fp32 K/V land on a .5 tie.
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


# Four slots: two live, one freed (its whole table on the garbage block)
# and one whose window runs past its reservation (those writes must go to
# the garbage block, not alias its last live block).
TABLES = np.array([[3, 5, 5, 5], [1, 2, 4, 6], [0, 0, 0, 0],
                   [7, 7, 7, 7]], np.int32)
LIMITS = np.array([32, 64, 0, 16], np.int32)
POSITIONS = np.array([20, 60, 0, 14], np.int32)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_verify_forward_paged_matches_jax(setup, kv_dtype):
    jp, tp, _ = setup
    jc, tc, fill = _arenas(kv_dtype, seed=1)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, TCFG.vocab_size, (4, 3)).astype(np.int32)
    pos = (POSITIONS[:, None] + np.arange(3)[None, :]).astype(np.int32)
    # The freed slot's window stays on its garbage rows 0-2; no other
    # slot writes there.
    jlog, jcache = J_VERIFY(
        jp, *map(jnp.asarray, (tokens, pos, TABLES, LIMITS)), jc, JCFG,
        False)
    tlog, tcache = tcb._verify_forward_paged(
        tp, *map(torch.from_numpy, (tokens, pos, TABLES, LIMITS)), tc, TCFG,
        use_kernel=False)
    assert tcache is tc and tlog.shape == (4, 3, TCFG.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    _assert_arenas_equal(tcache, jcache, fill)
    # The overrun slot wrote positions 14-15 into block 7; position 16
    # went to the garbage block, not to block 7's row 0 through the table.
    np.testing.assert_array_equal(tcache.k[:, 7, :14].numpy(),
                                  fill["k"][:, 7, :14])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_draft_forward_paged_matches_jax(setup, kv_dtype):
    """Two self-draft steps through the first layer: the arena's layer 0
    is written in place, layer 1 untouched, logits as JAX's."""
    jp, tp, _ = setup
    jc, tc, fill = _arenas(kv_dtype, seed=3)
    tokens = np.array([11, 200, 0, 42], np.int32)
    pos = POSITIONS.copy()
    for _ in range(2):
        jlog, jc = J_DRAFT(
            jp, 1, *map(jnp.asarray, (tokens, pos, TABLES, LIMITS)), jc,
            JCFG, False)
        tlog, tc = tcb._draft_forward_paged(
            tp, 1, *map(torch.from_numpy, (tokens, pos, TABLES, LIMITS)),
            tc, TCFG, use_kernel=False)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-5)
        tokens = tlog.argmax(-1).to(torch.int32).numpy()
        pos = pos + 1
    _assert_arenas_equal(tc, jc, fill)
    np.testing.assert_array_equal(tc.k[1].numpy(), fill["k"][1])


def test_draft_forward_dense_matches_jax(setup):
    """The external drafter's step over its dense cache, positions
    clamped at max_len - 1 on both sides."""
    jp, tp, _ = setup
    rng = np.random.default_rng(4)
    shape = (TCFG.num_layers, 4, 40, TCFG.num_kv_heads, TCFG.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    jcache = jinf.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
    tcache = tinf.KVCache(k=torch.from_numpy(k0.copy()),
                          v=torch.from_numpy(v0.copy()))
    tokens = np.array([11, 200, 0, 42], np.int32)
    pos = np.array([5, 38, 0, 39], np.int32)
    for _ in range(2):         # the second step clamps slots 1 and 3
        jlog, jcache = J_DENSE(
            jp, jnp.asarray(tokens), jnp.asarray(pos), jcache, JCFG)
        tlog, tcache = tcb._draft_forward_dense(
            tp, torch.from_numpy(tokens), torch.from_numpy(pos), tcache,
            TCFG, use_kernel=False)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-5)
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                                   atol=1e-5)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                                   atol=1e-5)
        tokens = tlog.argmax(-1).to(torch.int32).numpy()
        pos = pos + 1


def test_spec_tick_matches_jax(setup):
    """One greedy self-draft spec tick (k=2, one draft layer) end to end,
    the port's in-place writes against JAX's threaded arena: committed
    windows, counts, next tokens and positions, and the arena after the
    drafts and verify, as JAX's."""
    jp, tp, _ = setup
    jc, tc, fill = _arenas("bf16", seed=5)
    tokens = np.array([11, 200, 0, 42], np.int32)
    args = (tokens, POSITIONS, TABLES, LIMITS)
    jout = J_SPEC(jp, *map(jnp.asarray, args), jc, jnp.int32(0), JCFG, 2,
                  1, False, jsamp.SamplingParams())
    tout = tcb._spec_tick_paged(
        tp, *map(torch.from_numpy, args), tc, 0, TCFG, 2, 1, False,
        tsamp.SamplingParams())
    for i in range(4):        # committed, counts, next tokens, positions
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    _assert_arenas_equal(tout[4], jout[4], fill)
    assert tout[5] is None and tout[6] == 1
