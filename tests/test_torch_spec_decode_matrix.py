"""Port parity: speculative decode's greedy matrix (spec on against spec
off over sync_every and the prefix cache, the JAX spec engine and the
generator). Split from ``tests/test_torch_spec_decode.py``, whose
fixtures and helpers it uses, so the test runner can spread the file's
minutes over its workers."""

import pytest

from test_torch_spec_decode import (SPEC, _counters, _matrix_requests,
                                    _reference, _run, _run_jax, setup)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_greedy_parity_matrix(setup, kv_dtype):
    """Greedy tokens spec-on equal spec-off over sync_every {1, 4} x
    prefix cache on/off, equal the JAX spec engine's (with its counters),
    and, where the arena stores the model dtype, the generator's."""
    jp, tp, gen = setup
    reqs = _matrix_requests()
    kw = dict(kv_dtype=kv_dtype, block_size=16)
    base, _ = _run(tp, reqs, **kw)
    jax_out, jeng = _run_jax(jp, reqs, prefix_cache=False, **SPEC, **kw)
    assert jax_out == base
    refs = [_reference(gen, p, m) for p, m in reqs]
    for sync_every in (1, 4):
        for prefix in (False, True):
            tag = (kv_dtype, sync_every, prefix)
            spec, eng = _run(tp, reqs, sync_every=sync_every,
                             prefix_cache=prefix, **SPEC, **kw)
            assert spec == base, tag
            assert eng.spec_tick_count > 0, tag
            if kv_dtype == "bf16":
                assert spec == refs, tag
            if (sync_every, prefix) == (1, False):
                assert _counters(eng) == _counters(jeng), tag
