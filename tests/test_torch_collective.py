"""The port's host collective (``ray_tpu_torch/util/collective``) against
the JAX package's: the analog of ``tests/test_collective.py``.

Four rank processes (forked from the runtime's fork server, one
module-scoped group) each hold the default process group and two named
host groups over gloo beside it. Every op's result equals what JAX's
``CollectiveGroup`` computes on the same per-rank inputs (driven here in
four threads over its own rendezvous store): exactly on integer-valued
inputs, and within rtol 1e-6 on fp32, where gloo sums in its own order.
"""

import threading

import numpy as np
import pytest

import ray_tpu
from ray_tpu.util.collective import collective as jcoll

N = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch_rl_helpers as h
    from ray_tpu_torch.runtime.replica import ReplicaProcess

    root = str(tmp_path_factory.mktemp("collective"))
    procs = [ReplicaProcess("coll", h.CollectiveWorker, (r, N, root), {},
                            False, sync_workers=2,
                            env={"CUDA_VISIBLE_DEVICES": ""})
             for r in range(N)]
    try:
        for p in procs:
            p.wait_ready(120)
        yield procs
    finally:
        for p in procs:
            p.kill()


def _port(procs, method, per_rank_args, **kwargs):
    futs = [p.call(method, args, kwargs)
            for p, args in zip(procs, per_rank_args)]
    return [f.result(timeout=120) for f in futs]


class _Remote:
    def __init__(self, fn):
        self.remote = fn


class _Store:
    """JAX's ``_RendezvousStore`` behind ``.remote`` methods, for ranks
    that are threads of this process."""

    def __init__(self, n):
        self._s = jcoll._RendezvousStore(n)
        self._lock = threading.Lock()
        self.put = _Remote(self._locked(self._s.put))
        self.collect = _Remote(self._locked(self._s.collect))

    def _locked(self, fn):
        def call(*args):
            with self._lock:
                return fn(*args)
        return call


def _jax(monkeypatch, fn, per_rank_args):
    """``fn(group, *args)`` on each of N JAX ranks (threads sharing one
    store): JAX's results in rank order."""
    monkeypatch.setattr(ray_tpu, "get", lambda x, **kw: x)
    store = _Store(N)
    groups = [jcoll.CollectiveGroup("j", N, r, store) for r in range(N)]
    out = [None] * N
    errors = []

    def run(r):
        try:
            out[r] = fn(groups[r], *per_rank_args[r])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return out


def _inputs(kind, shape=(3, 5), seed=0):
    rng = np.random.default_rng(seed)
    if kind == "int-valued":
        return [rng.integers(-8, 9, size=shape).astype(np.float32)
                for _ in range(N)]
    if kind == "int64":
        return [rng.integers(-1000, 1000, size=shape) for _ in range(N)]
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(N)]


def _same(got, want, kind):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if kind == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


CASES = [(op, kind) for op in ("sum", "product", "min", "max")
         for kind in ("int-valued", "int64", "fp32")]


@pytest.mark.parametrize("op,kind", CASES)
def test_allreduce_equals_jax_rank_order_reduction(ranks, monkeypatch, op,
                                                   kind):
    xs = _inputs(kind, seed=len(op))
    want = _jax(monkeypatch, lambda g, x: g.allreduce(x, op),
                [(x,) for x in xs])
    got = _port(ranks, "op", [("allreduce", "g", x) for x in xs], op=op)
    for r in range(N):
        _same(got[r], want[r], kind)


@pytest.mark.parametrize("kind", ["int-valued", "fp32"])
def test_allreduce_tensor_in_place_equals_jax(ranks, monkeypatch, kind):
    """The in-place tensor allreduce a learner group's gradient bucket
    takes sums as JAX's group does."""
    xs = _inputs(kind, shape=(64,), seed=7)
    want = _jax(monkeypatch, lambda g, x: g.allreduce(x), [(x,) for x in xs])
    got = _port(ranks, "bucket_sum", [("g", x) for x in xs])
    for r in range(N):
        _same(got[r], want[r], kind)


@pytest.mark.parametrize("kind", ["int64", "fp32"])
def test_allgather_equals_jax(ranks, monkeypatch, kind):
    xs = _inputs(kind, shape=(2, 3), seed=7)
    want = _jax(monkeypatch, lambda g, x: g.allgather(x), [(x,) for x in xs])
    got = _port(ranks, "op", [("allgather", "h", x) for x in xs])
    for r in range(N):
        assert len(got[r]) == N
        for a, b in zip(got[r], want[r]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dst,op", [(0, "sum"), (2, "max")])
def test_reduce_equals_jax(ranks, monkeypatch, dst, op):
    xs = _inputs("int-valued", seed=11)
    want = _jax(monkeypatch, lambda g, x: g.reduce(x, dst, op),
                [(x,) for x in xs])
    got = _port(ranks, "op", [("reduce", "g", x) for x in xs],
                dst_rank=dst, op=op)
    for r in range(N):
        _same(got[r], want[r], "int-valued")
    np.testing.assert_array_equal(got[(dst + 1) % N], xs[(dst + 1) % N])


@pytest.mark.parametrize("src", [0, 3])
def test_broadcast_equals_jax(ranks, monkeypatch, src):
    xs = [np.full((2, 2), r + 1.0, np.float32) for r in range(N)]
    # Only the source's array matters: the others send none of theirs.
    xs[src] = np.arange(7, dtype=np.int64).reshape(7)
    want = _jax(monkeypatch, lambda g, x: g.broadcast(x, src),
                [(x,) for x in xs])
    got = _port(ranks, "op", [("broadcast", "h", x) for x in xs],
                src_rank=src)
    for r in range(N):
        np.testing.assert_array_equal(got[r], want[r])
        assert got[r].dtype == xs[src].dtype


@pytest.mark.parametrize("length", [8, 10])
def test_reducescatter_equals_jax(ranks, monkeypatch, length):
    xs = _inputs("int-valued", shape=(length,), seed=length)
    want = _jax(monkeypatch, lambda g, x: g.reducescatter(x),
                [(x,) for x in xs])
    got = _port(ranks, "op", [("reducescatter", "g", x) for x in xs])
    for r in range(N):
        _same(got[r], want[r], "int-valued")


def test_send_recv_by_tag_is_fifo(ranks):
    a, b = np.ones((2, 3), np.float32), np.arange(5)
    plans = [[("send", a, 1, "x"), ("send", b, 1, "x"),
              ("send", a * 3, 1, "y")],
             [("recv", 0, "y"), ("recv", 0, "x"), ("recv", 0, "x")],
             [], []]
    got = _port(ranks, "p2p", [("g", plan) for plan in plans])
    np.testing.assert_array_equal(got[1][0], a * 3)
    np.testing.assert_array_equal(got[1][1], a)
    np.testing.assert_array_equal(got[1][2], b)


def test_barrier_and_group_registry(ranks):
    assert _port(ranks, "op", [("barrier", "h")] * N) == [None] * N
    infos = _port(ranks, "info", [("g",)] * N)
    assert infos == [(True, r, N, False) for r in range(N)]


def test_named_groups_beside_the_default_group(ranks):
    """Each process holds the default group and two named groups; the
    named groups' rounds leave the default group working."""
    xs = [np.full(3, r, np.int64) for r in range(N)]
    g = _port(ranks, "op", [("allreduce", "g", x) for x in xs])
    h = _port(ranks, "op", [("allreduce", "h", x * 2) for x in xs])
    assert all((a == 6).all() for a in g) and all((a == 12).all() for a in h)
    assert _port(ranks, "default_group_sum",
                 [(r,) for r in range(N)]) == [6.0] * N


def test_a_group_needs_a_rendezvous():
    from ray_tpu_torch.util import collective

    with pytest.raises(ValueError, match="rendezvous"):
        collective.init_collective_group(1, 0, "lonely")
    with pytest.raises(ValueError, match="not initialized"):
        collective.allreduce(np.ones(2), group_name="lonely")
