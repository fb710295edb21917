"""Port parity: buffered ``sync_every > 1`` decode with rewind in
ray_tpu_torch's ``ContinuousBatcher``, on paged and dense engines, at the
tiny fp32 config with the same weights on both sides.

Mirrors the buffered tests of ``tests/test_continuous_batching.py`` on
both data planes (the port's ``LlamaGenerator`` is the sequential
reference), holds a buffered run to the JAX engine step by step, and
checks the pieces the port adds: a fresh token tensor per tick, and the
host-side dispatched-step counter that a rewind sets back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import continuous_batching as jcb
from ray_tpu.models import llama as jl
from ray_tpu_torch.interop import params_to_numpy
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import inference as tinf
from ray_tpu_torch.models import llama as tl

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
PLANES = pytest.mark.parametrize("paged", [True, False],
                                 ids=["paged", "dense"])


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


def _engine(tp, paged, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 128)
    return tcb.ContinuousBatcher(TCFG, params=tp, paged=paged,
                                 device="cpu", **kw)


def _ints(rng, n):
    return list(map(int, rng.integers(1, 250, size=n)))


@PLANES
def test_buffered_sync_matches_per_tick(setup, paged):
    _, tp, gen = setup
    rng = np.random.default_rng(7)
    reqs = [(_ints(rng, n), m) for n, m in [(5, 9), (11, 4), (3, 14)]]
    eng = _engine(tp, paged, sync_every=4)
    rids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
    results = eng.run_to_completion()
    assert set(results) == set(rids)
    for rid, (prompt, n) in zip(rids, reqs):
        assert results[rid] == _reference(gen, prompt, n), rid


@PLANES
def test_buffered_cancel_last_request_does_not_wedge(setup, paged):
    """Cancelling the only active request while a fetch is pending must
    drain the in-flight state, not wedge admission."""
    _, tp, _ = setup
    eng = _engine(tp, paged, sync_every=4)
    rid = eng.submit([1, 2, 3], max_new_tokens=50)
    for _ in range(5):  # past one flush: a pending fetch exists
        eng.step()
    assert eng._pending is not None
    eng.cancel(rid)
    for _ in range(12):
        eng.step()
        if not eng.has_work():
            break
    assert not eng.has_work(), "engine wedged after cancel"
    rid2 = eng.submit([4, 5], max_new_tokens=3)
    out = eng.run_to_completion()
    assert rid2 in out and len(out[rid2]) == 3


def test_paged_buffered_arena_wait_keeps_pipelining(setup):
    """An arena-blocked waiting request must not force a sync boundary
    every tick: the pipeline keeps buffering until blocks free."""
    _, tp, gen = setup
    eng = _engine(tp, True, num_slots=3, block_size=16, num_blocks=5,
                  sync_every=4)
    r1 = eng.submit(list(range(1, 40)), max_new_tokens=20)  # 4 blocks
    r2 = eng.submit([1, 2, 3], max_new_tokens=3)            # waits: 0 free
    for _ in range(4):
        eng.step()
    assert eng.active_count == 1
    assert len(eng._buf) + (eng._pending is not None) > 0, \
        "arena-blocked waiter collapsed speculative buffering"
    out = eng.run_to_completion()
    assert len(out[r1]) == 20
    assert out[r2] == _reference(gen, [1, 2, 3], 3)


@PLANES
def test_buffered_overrun_heavy_parity(setup, paged):
    """Requests the device runs past during speculation (finish detection
    lags 2K ticks; paged overrun writes go to the garbage block, dense
    ones past the request's end): outputs equal per-tick sync's."""
    _, tp, gen = setup
    rng = np.random.default_rng(99)
    pa, pc = _ints(rng, 5), _ints(rng, 4)
    outs = {}
    for k in (1, 8):
        eng = _engine(tp, paged, num_slots=3, max_len=64, block_size=16,
                      sync_every=k)
        ra = eng.submit(pa, max_new_tokens=26)
        rc = eng.submit(pc, max_new_tokens=20)
        o = eng.run_to_completion()
        outs[k] = (o[ra], o[rc])
    assert outs[1] == outs[8]
    assert outs[1][0] == _reference(gen, pa, 26)


@PLANES
def test_buffered_admission_not_starved(setup, paged):
    """A request submitted mid-pipeline with a free slot joins within
    ~2K ticks, and the long request's output survives the rewinds."""
    _, tp, gen = setup
    eng = _engine(tp, paged, sync_every=4)
    r_long = eng.submit([1, 2, 3], max_new_tokens=100)
    for _ in range(6):
        eng.step()
    r_short = eng.submit([4, 5, 6], max_new_tokens=3)
    finished = {}
    for _ in range(30):
        finished.update(eng.step())
        if r_short in finished:
            break
    assert r_short in finished, "waiting request starved behind pipeline"
    assert r_long not in finished
    out = eng.run_to_completion()
    assert out[r_long] == _reference(gen, [1, 2, 3], 100)


@PLANES
def test_sampled_buffered_equals_per_tick(setup, paged):
    """Sampled decode with requests submitted up front (each with a
    slot): sync_every=4 gives the same tokens as sync_every=1, through
    the rewinds at each finish (they replay the same sampling step
    numbers). A request admitted later can start at another global step,
    as in JAX."""
    _, tp, _ = setup
    rng = np.random.default_rng(31)
    reqs = [(_ints(rng, n), m) for n, m in [(5, 8), (17, 6), (9, 11)]]
    sampling = {"temperature": 0.8, "top_p": 0.9, "seed": 42}

    def run(k):
        eng = _engine(tp, paged, num_slots=3, sync_every=k,
                      sampling=sampling)
        rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        out = eng.run_to_completion()
        return [out[r] for r in rids]

    assert run(4) == run(1)


def _drive(engine, script, max_steps=200):
    log = []
    for i in range(max_steps):
        for prompt, n in script.get(i, []):
            engine.submit(prompt, max_new_tokens=n)
        log.append(sorted(engine.step().items()))
        if not engine.has_work() and i >= max(script):
            break
    return log, engine.base_tick_count, engine.decoded_tokens


@PLANES
def test_buffered_engine_matches_jax_step_by_step(setup, paged):
    """The same script through the JAX engine and the port at
    sync_every=4: the same finished set at every step (finish detection
    lags identically), the same tick count and tokens."""
    jp, tp, _ = setup
    rng = np.random.default_rng(4)
    script = {0: [(_ints(rng, n), m) for n, m in [(5, 8), (20, 6), (3, 4)]],
              3: [(_ints(rng, 30), 12)],
              9: [(_ints(rng, 9), 7), (_ints(rng, 1), 9)]}
    kw = dict(num_slots=3, max_len=128, block_size=16, sync_every=4,
              paged=paged)
    je = jcb.ContinuousBatcher(JCFG, params=jp, use_decode_kernel=False,
                               **kw)
    te = tcb.ContinuousBatcher(TCFG, params=tp, device="cpu", **kw)
    assert _drive(te, script) == _drive(je, script)


def test_ticks_return_fresh_token_tensors(setup):
    """Buffered rows are references to each tick's token tensor, so a
    tick must never update the previous one in place."""
    _, tp, _ = setup
    eng = _engine(tp, True, sync_every=8)
    eng.submit([1, 2, 3], max_new_tokens=20)
    for _ in range(4):
        eng.step()
    rows = list(eng._buf)
    assert len(rows) == 4
    assert len({r.data_ptr() for r in rows}) == 4
    snapshot = [r.clone() for r in rows]
    eng.step()
    for r, s in zip(rows, snapshot):
        assert torch.equal(r, s)


def test_rewind_resets_the_dispatched_step(setup):
    """Ticks run ahead of the host-applied step count; the upload after a
    rewind sets the dispatched counter back to it."""
    _, tp, _ = setup
    eng = _engine(tp, True, sync_every=4)
    eng.submit([1, 2, 3], max_new_tokens=5)
    eng.submit([4, 5, 6, 7], max_new_tokens=30)
    ahead = False
    while eng.has_work():
        eng.step()
        ahead |= eng._d_step > eng._applied_steps
        if eng._dirty and not eng._buf and eng._pending is None:
            applied = eng._applied_steps
            eng._upload_state()
            assert eng._d_step == applied
    assert ahead, "buffered ticks never ran ahead of the host"
