"""Port parity: the engine's parameter and scoring hooks in
ray_tpu_torch's ``ContinuousBatcher`` (``score_logprobs``, ``swap_params``
with ``weight_version``, ``reset``) against the JAX package's, at the
tiny fp32 config with the same weights on both sides.

``score_logprobs`` is held to JAX's within 1e-5; a swap mid-request
continues the request under the new weights token for token as the JAX
engine does (``tests/test_rl_loop.py``'s tick-boundary swap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import continuous_batching as jcb
from ray_tpu.models import llama as jl
from ray_tpu_torch.interop import params_from_numpy, params_to_numpy
from ray_tpu_torch.models import continuous_batching as tcb
from ray_tpu_torch.models import llama as tl

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    # The port draws the weights and JAX gets the same numbers through
    # numpy (JAX's eager init costs seconds of per-op compiles).
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tl.init_params(
        TCFG, torch.Generator().manual_seed(0), "cpu")))
    jp2 = jax.tree.map(lambda a: a * 0.5, jp)      # the "trained" weights
    return ((jp, params_from_numpy(jax.device_get(jp), "cpu")),
            (jp2, params_from_numpy(jax.device_get(jp2), "cpu")))


def _engines(params, **kw):
    (jp, tp), _ = params
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 64)
    je = jcb.ContinuousBatcher(JCFG, params=jp, use_decode_kernel=False,
                               **kw)
    te = tcb.ContinuousBatcher(TCFG, params=tp, device="cpu", **kw)
    return je, te


def _ints(rng, n):
    return list(map(int, rng.integers(1, 250, size=n)))


@pytest.mark.parametrize("n_prompt,n_out", [(5, 7), (1, 1), (20, 12),
                                            (30, 34)])
def test_score_logprobs_matches_jax(params, n_prompt, n_out):
    """Within 1e-5 of JAX's, padded to min(bucket, max_len): 12 tokens
    pad to 16, 32 to 32, 64 to max_len=64."""
    je, te = _engines(params)
    rng = np.random.default_rng(n_prompt)
    prompt, out = _ints(rng, n_prompt), _ints(rng, n_out)
    got = te.score_logprobs(prompt, out)
    want = je.score_logprobs(prompt, out)
    assert got.dtype == np.float32 and got.shape == (n_out,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.all(got <= 0)


def test_score_logprobs_edges(params):
    _, te = _engines(params)
    assert te.score_logprobs([1, 2], []).shape == (0,)
    with pytest.raises(ValueError, match="max_len"):
        te.score_logprobs([1] * 60, [2] * 5)


def test_score_logprobs_picks_served_greedy_tokens(params):
    """Every greedy token the engine serves is the argmax of the scored
    distribution: its logprob is the row's maximum."""
    _, te = _engines(params)
    prompt = _ints(np.random.default_rng(3), 9)
    rid = te.submit(prompt, max_new_tokens=10)
    out = te.run_to_completion()[rid]
    logits = tl.forward(te.params, torch.tensor([prompt + out]), TCFG)
    logp = torch.log_softmax(logits[0].float(), -1)
    rows = logp[len(prompt) - 1:len(prompt) - 1 + len(out)]
    assert rows.argmax(-1).tolist() == out
    np.testing.assert_allclose(te.score_logprobs(prompt, out),
                               rows.max(-1).values.numpy(), atol=1e-5)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_swap_params_mid_request_matches_jax(params, paged):
    """Swap after three steps: the in-flight request finishes its full
    budget under the new weights, token for token as in JAX; the version
    bumps; a later request and the scores run on the new weights."""
    _, (jp2, tp2) = params
    je, te = _engines(params, paged=paged)
    outs = []
    for eng, new in ((je, jp2), (te, tp2)):
        assert eng.weight_version == 0
        rid = eng.submit(list(range(1, 6)), max_new_tokens=8)
        done = {}
        for _ in range(3):
            done.update(eng.step())
        assert eng.swap_params(new) == 1 == eng.weight_version
        done.update(eng.run_to_completion())
        assert len(done[rid]) == 8
        rid2 = eng.submit([1, 2, 3], max_new_tokens=4)
        outs.append((done[rid], eng.run_to_completion()[rid2],
                     eng.score_logprobs([1, 2, 3], [4, 5])))
    assert outs[1][:2] == outs[0][:2]
    np.testing.assert_allclose(outs[1][2], outs[0][2], atol=1e-5)
    assert te.swap_params(tp2, version=7) == 7 == te.weight_version


def test_swap_params_rejects_mismatched_leaf(params):
    _, te = _engines(params)
    tp = te.params

    def with_leaf(name, value):
        new = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in tp.items()}
        if "." in name:
            outer, inner = name.split(".")
            new[outer][inner] = value
        else:
            new[name] = value
        return new

    wq = tp["layers"]["wq"]
    cases = [
        (with_leaf("layers.wq", wq[..., :-1]), "'layers.wq' mismatch"),
        (with_leaf("layers.wq", wq.double()), "'layers.wq' mismatch"),
        (with_leaf("embed", torch.empty(tp["embed"].shape, device="meta")),
         "'embed' mismatch"),
        (with_leaf("final_norm", tp["final_norm"].numpy()),
         "'final_norm' mismatch"),
        ({k: v for k, v in tp.items() if k != "lm_head"}, "tree mismatch"),
    ]
    for bad, msg in cases:
        with pytest.raises(ValueError, match=msg):
            te.swap_params(bad)
    assert te.weight_version == 0 and te.params is tp


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_reset_drops_everything_and_restarts(params, paged):
    """reset() mid-flight returns every dropped request (running and
    queued), rebuilds the cache and rewinds the counters; a fresh run then
    equals a fresh engine's, as JAX's does."""
    je, te = _engines(params, paged=paged, sync_every=4)
    rng = np.random.default_rng(9)
    prompts = [_ints(rng, n) for n in (4, 18, 7)]
    for eng in (je, te):
        rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
        for _ in range(3):
            eng.step()
        assert sorted(eng.reset()) == rids
        assert not eng.has_work() and eng.active_count == 0
        assert eng._applied_steps == 0
    if paged:
        assert te.allocator.free_count == te.num_blocks - 1
        assert te.kv_block_stats() == je.kv_block_stats()
    assert not te.cache.k.any()
    runs = []
    for eng in (je, te):
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        out = eng.run_to_completion()
        runs.append([out[r] for r in rids])
    assert runs[1] == runs[0]
