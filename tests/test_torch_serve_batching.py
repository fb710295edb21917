"""Port parity: ``@serve.batch``, the request context and model
multiplexing (``ray_tpu_torch.serve``: ``batching``, ``context``,
``multiplex``) side by side with the JAX package's copies, driven through
the same schedules: results per caller, error propagation, the leader
hand-off, the multiplexed LRU, the token buckets and the tenant limiter.
"""

import asyncio
import contextvars
import threading
import time

import pytest

from ray_tpu.serve import batching as jbatching
from ray_tpu.serve import context as jcontext
from ray_tpu.serve import multiplex as jmultiplex
from ray_tpu_torch.serve import batching as tbatching
from ray_tpu_torch.serve import context as tcontext
from ray_tpu_torch.serve import multiplex as tmultiplex

PAIRS = {"batching": (jbatching, tbatching),
         "context": (jcontext, tcontext),
         "multiplex": (jmultiplex, tmultiplex)}


def _both(name):
    return pytest.mark.parametrize("mod", PAIRS[name], ids=["jax", "port"])


def _concurrent(fn, n):
    """fn(i) from n threads released together; {i: result or error}."""
    out = {}
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait()
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — the caller's error
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return out


# ---------------------------------------------------------------- batching
def _batched_class(mod, max_batch_size, fail_on=None):
    class Model:
        def __init__(self):
            self.batches = []

        @property
        def sizes(self):
            return [len(b) for b in self.batches]

        @mod.batch(max_batch_size=max_batch_size,
                   batch_wait_timeout_s=0.1)
        def __call__(self, xs):
            self.batches.append(list(xs))
            if fail_on is not None and fail_on in xs:
                raise ValueError(f"bad input {fail_on}")
            return [x * 10 for x in xs]

    return Model()


def test_results_per_caller_and_batch_bound_match():
    got = {}
    for name, mod in (("jax", jbatching), ("port", tbatching)):
        m = _batched_class(mod, 4)
        got[name] = _concurrent(m, 10)
        assert sum(m.sizes) == 10 and max(m.sizes) <= 4
        assert max(m.sizes) >= 2
    assert got["port"] == got["jax"] == {i: i * 10 for i in range(10)}


def test_sequential_calls_are_batches_of_one():
    for mod in (jbatching, tbatching):
        m = _batched_class(mod, 4)
        assert [m(i) for i in range(3)] == [0, 10, 20]
        assert m.sizes == [1, 1, 1]


def test_an_error_reaches_every_caller_of_its_batch():
    for mod in (jbatching, tbatching):
        m = _batched_class(mod, 8, fail_on=3)
        out = _concurrent(m, 6)
        for batch in m.batches:
            for x in batch:
                if 3 in batch:
                    assert isinstance(out[x], ValueError), (batch, out)
                else:
                    assert out[x] == x * 10
        assert sorted(x for b in m.batches for x in b) == list(range(6))
        with pytest.raises(ValueError, match="bad input 3"):
            m(3)                        # a batch of one fails alone
        assert m(4) == 40


def test_wrong_result_count_is_an_error():
    for mod in (jbatching, tbatching):
        class Short:
            @mod.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
            def __call__(self, xs):
                return xs[:-1]

        with pytest.raises(ValueError, match="returned 0 results"):
            Short()(1)


@pytest.mark.parametrize("mod", [jbatching, tbatching], ids=["jax", "port"])
def test_leader_hand_off(mod):
    """A follower whose leader left without draining it takes over and
    runs its own batch."""
    runs = []

    def fn(instance, xs):
        runs.append(list(xs))
        return [x + 1 for x in xs]

    q = mod._BatchQueue(fn, 4, 0.01)
    q.leader_running = True            # a leader that is about to leave
    out = []
    t = threading.Thread(target=lambda: out.append(q.submit(None, 41)))
    t.start()
    time.sleep(0.2)                    # the follower waits on the leader
    assert runs == []
    with q.lock:
        q.leader_running = False       # ...which leaves its item behind
    t.join(timeout=10)
    assert not t.is_alive()
    assert out == [42] and runs == [[41]]
    assert not q.leader_running and q.items == [] and q.results == {}


# ----------------------------------------------------------------- context
@_both("context")
def test_request_context_and_attempt(mod):
    assert mod.get_request_context() is None
    assert mod.get_request_attempt() == 0
    ctx = {"request_id": "r1", "deployment": "d", "attempt": 2}
    token = mod._set_request_context(ctx)
    try:
        assert mod.get_request_context() == ctx
        assert mod.get_request_attempt() == 2
        # It rides a copied context into an executor thread.
        copied = contextvars.copy_context()
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            copied.run(mod.get_request_context)))
        t.start()
        t.join(timeout=10)
        assert seen == [ctx]
    finally:
        mod._reset_request_context(token)
    assert mod.get_request_context() is None


# --------------------------------------------------------------- multiplex
def _loader_class(mod, capacity, is_async):
    class Mux:
        def __init__(self):
            self.loads = []

        if is_async:
            @mod.multiplexed(max_num_models_per_replica=capacity)
            async def get_model(self, model_id):
                self.loads.append(model_id)
                return f"model-{model_id}"
        else:
            @mod.multiplexed(max_num_models_per_replica=capacity)
            def get_model(self, model_id):
                self.loads.append(model_id)
                return f"model-{model_id}"

    return Mux()


@pytest.mark.parametrize("is_async", [False, True], ids=["sync", "async"])
def test_multiplexed_lru_matches(is_async):
    schedule = ["a", "a", "b", "c", "a", "b", "b", "d", "c"]
    got = {}
    for name, mod in (("jax", jmultiplex), ("port", tmultiplex)):
        m = _loader_class(mod, 2, is_async)
        models = []
        for mid in schedule:
            out = m.get_model(mid)
            if is_async:
                out = asyncio.new_event_loop().run_until_complete(out)
            models.append(out)
        assert models == [f"model-{mid}" for mid in schedule]
        assert m.get_model.__serve_multiplexed__
        got[name] = m.loads
    assert got["port"] == got["jax"] == ["a", "b", "c", "a", "b", "d", "c"]


@_both("multiplex")
def test_model_id_and_tenant(mod):
    assert mod.get_multiplexed_model_id() == ""
    token = mod._set_model_id("lora-3")
    try:
        assert mod.get_multiplexed_model_id() == "lora-3"
        assert mod.get_request_tenant() == "lora-3"
    finally:
        mod._reset_model_id(token)
    assert mod.get_request_tenant() == ""


def test_token_buckets_match_on_one_clock():
    schedule = [0.0, 0.0, 0.0, 0.1, 0.25, 0.3, 1.0, 1.0, 1.0, 1.0]
    for rate, burst in ((4.0, 2.0), (0.0, 3.0), (10.0, 0.5)):
        got = {}
        for name, mod in (("jax", jmultiplex), ("port", tmultiplex)):
            bucket = mod.TokenBucket(rate, burst)
            bucket.ts = 0.0
            got[name] = [bucket.try_acquire(now=t) for t in schedule]
        assert got["port"] == got["jax"]
    assert got["port"][0] is None and got["port"][2] is not None


def test_tenant_limiter_matches(monkeypatch):
    got = {}
    for name, mod in (("jax", jmultiplex), ("port", tmultiplex)):
        lim = mod.TenantRateLimiter()
        seq = []
        monkeypatch.delenv("RAY_TPU_TENANT_RPS", raising=False)
        seq.append(lim.try_acquire("anyone"))         # unlimited
        lim.set_limit("off", 0)
        seq.append(lim.try_acquire("off"))            # disabled: 60 s
        lim.set_limit("two", 1, burst=2)
        seq += [lim.try_acquire("two") is None for _ in range(3)]
        lim.clear_limit("two")
        seq.append(lim.try_acquire("two"))
        monkeypatch.setenv("RAY_TPU_TENANT_RPS", "1")
        monkeypatch.setenv("RAY_TPU_TENANT_BURST", "1")
        seq += [lim.try_acquire("fresh") is None for _ in range(2)]
        got[name] = seq
        assert mod.tenant_rate_limiter() is mod.tenant_rate_limiter()
    assert got["port"] == got["jax"] == [None, 60.0, True, True, False,
                                         None, True, False]
