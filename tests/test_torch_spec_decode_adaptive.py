"""Port parity: adaptive k walking down to the plain tick on a drafter
that never matches, and sampled spec decode's fixed-seed replay. Split
from ``tests/test_torch_spec_decode.py``, whose fixtures and helpers it
uses, so the test runner can spread the file's minutes over its
workers."""

import numpy as np

from ray_tpu_torch.models import inference as tinf
from test_torch_spec_decode import SPEC, TCFG, _ints, _reference, _run, setup


def test_adaptive_k_collapses_to_plain_tick_on_bad_drafter(setup):
    """A drafter that never matches walks the ladder down to 0, after
    which the engine runs the plain tick; the tokens stay the reference
    stream throughout, and the rungs run are the ladder's, each once on
    the way down."""
    _, tp, gen = setup
    prompt = _ints(np.random.default_rng(45), 8)
    # Random weights sharing the vocab: greedy proposals are noise.
    drafter = tinf.ExternalLlamaDrafter(TCFG, seed=99, device="cpu")
    out, eng = _run(tp, [(prompt, 48)], spec_k=4, spec_adaptive=True,
                    drafter=drafter)
    assert out[0] == _reference(gen, prompt, 48)
    assert eng._spec_cur_k == 0, (eng._spec_cur_k, eng.spec_accept_rate)
    assert eng.base_tick_count > 0, "plain tick never resumed"
    assert set(eng._spec_ticks) == {4, 2, 1}


def test_sampled_spec_deterministic_and_rewind_replay(setup):
    """Sampled spec decode replays: the same seed twice, sync_every 1
    against 4 (submitted up front), where the staggered finishes force
    rewinds mid-buffer; another seed draws other tokens."""
    _, tp, _ = setup
    rng = np.random.default_rng(43)
    reqs = [(_ints(rng, 6), 4), (_ints(rng, 10), 9)]
    kw = dict(sampling=dict(temperature=0.8, top_p=0.9, seed=11), **SPEC)
    a, _ = _run(tp, reqs, sync_every=1, **kw)
    b, _ = _run(tp, reqs, sync_every=1, **kw)
    assert a == b, "same-seed sampled spec run not deterministic"
    c, eng = _run(tp, reqs, sync_every=4, **kw)
    assert c == a, "buffered sampled spec diverged from per-tick sync"
    assert eng.spec_tick_count > 0
    kw["sampling"] = dict(temperature=0.8, top_p=0.9, seed=12)
    d, _ = _run(tp, reqs, sync_every=1, **kw)
    assert d != a
