"""The port's cluster data plane on the CPU: the node store is the native
shared-memory store, and a value over the inline bound crosses through a
segment (JAX's ``put_bytes_to_node`` / ``read_object_reply``,
``ray_tpu/_private/runtime/cluster.py:101-145``, and the worker's result
and stream-item puts).

A 4 MB put and a worker's 4 MB result go through segments and raise the
node's stats; a get on the node maps the segment and hands a read-only
view; a bf16 tensor round-trips without a copy (a tensor over the
mapping); a worker of another node of the host maps the segment too;
stream items over 100 KB go through segments; ``free`` and
``Cluster.shutdown()`` leave no segment; a put past the store's budget
spills the coldest object to the node's spill directory and a get brings
it back, and the budget counts whole pages; a tensor read from a message's bytes is a copy; and one script on
JAX's cluster and on the port's gives equal values. Every test is
bounded by an alarm of its own.
"""

import os
import signal
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.runtime.cluster import INLINE_RESULT_MAX
from ray_tpu_torch._private.shm import SEGMENT_PREFIX
from ray_tpu_torch.cluster_utils import Cluster

T = 60
LIMIT_S = 90
MB4 = 4 << 20


@pytest.fixture(autouse=True)
def _bounded():
    def expire(*_):
        raise TimeoutError(f"test ran past its {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _segments():
    return {n for n in os.listdir("/dev/shm")
            if n.startswith(SEGMENT_PREFIX)}


@pytest.fixture(scope="module")
def cluster():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2})
    c.wait_for_nodes()
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


def _core():
    return worker_mod.global_worker().core


def test_large_put_and_result_go_through_segments(cluster):
    used0, count0 = cluster.head_node.store_stats()
    before = _segments()
    value = np.arange(MB4 // 8, dtype=np.float64)
    ref = rt.put(value)
    used1, count1 = cluster.head_node.store_stats()
    assert count1 == count0 + 1 and used1 - used0 > MB4
    # The client made the segment (named after the object); the RPC
    # carried no bytes of it.
    assert f"{SEGMENT_PREFIX}{ref.id().hex()}" in _segments() - before
    # A worker on the node reads it as a read-only view of the mapping.
    info = rt.get(rt.remote(cases.view_info).remote(ref), timeout=T)
    assert info == {"writeable": False, "in_segment": True,
                    "sum": float(value.sum())}
    # A 4 MB result: the worker's own segment, and the driver's get maps
    # it (nothing of it in the push reply).
    big = rt.get(rt.remote(cases.make_big).remote(MB4 // 8), timeout=T)
    used2, count2 = cluster.head_node.store_stats()
    assert count2 == count1 + 1 and used2 - used1 > MB4
    assert not big.flags.writeable and cases.in_segment(big)
    np.testing.assert_array_equal(big, np.arange(MB4 // 8))
    _core().free([ref])


def test_a_get_on_another_node_of_the_host_maps_its_segment(cluster):
    """Two nodes of one host share ``/dev/shm``: a worker of the other
    node maps the putting node's segment instead of pulling a copy."""
    other = cluster.add_node(num_cpus=1, resources={"other": 1.0})
    cluster.wait_for_nodes()
    try:
        value = np.arange(MB4 // 8, dtype=np.float64)
        ref = rt.put(value)
        on_other = rt.remote(resources={"other": 1.0})
        info = rt.get(on_other(cases.view_info).remote(ref), timeout=T)
        assert info == {"writeable": False, "in_segment": True,
                        "sum": float(value.sum())}
        assert rt.get(on_other(cases.where).remote(), timeout=T) == \
            other.node_id
        assert other.store_stats() == (0, 0)      # nothing was pulled
        _core().free([ref])
    finally:
        cluster.remove_node(other)


def test_bf16_tensor_round_trips_without_a_copy(cluster):
    t = torch.randn(1024, 1024, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    ref = rt.put(t)
    # Another process's get: a tensor over the segment, equal bit for bit.
    got = rt.get(rt.remote(cases.add).remote(ref, 0), timeout=T)
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    info = rt.get(rt.remote(cases.view_info).remote(ref), timeout=T)
    assert info["in_segment"] and info["sum"] == float(t.float().sum())
    # In this process, a get of a result the node holds maps it too.
    out_ref = rt.remote(cases.add).remote(t, 1)
    out = rt.get(out_ref, timeout=T)
    assert cases.in_segment(out) and torch.equal(out, t + 1)
    # What a reader may do with it: read it, copy it, and write it in
    # place, which copies the pages it touches and leaves the segment
    # (and every other reader) as it was.
    out[0, 0] = 7
    assert float(out[0, 0]) == 7
    info = rt.get(rt.remote(cases.view_info).remote(out_ref), timeout=T)
    assert info["sum"] == float((t + 1).float().sum())
    _core().free([ref, out_ref])


def test_a_tensor_read_from_a_message_is_a_copy(cluster):
    """A tensor that arrives inside a message (an inline task argument or
    result, immutable bytes) is a copy: a task may write its argument in
    place, and a write reaches neither those bytes nor another read of
    them."""
    from ray_tpu_torch._private.serialization import dumps, loads

    t = torch.arange(4096, dtype=torch.float32)    # its bytes out of band
    ref = rt.remote(cases.bump).remote(t)
    assert torch.equal(rt.get(ref, timeout=T), t + 1)
    assert torch.equal(t, torch.arange(4096, dtype=torch.float32))
    for dtype in (torch.float32, torch.bfloat16):
        wire = dumps({"x": t.to(dtype)})
        loads(wire)["x"].add_(1)
        assert torch.equal(loads(wire)["x"], t.to(dtype))
    _core().free([ref])


def test_stream_items_over_the_bound_go_through_segments(cluster):
    size = INLINE_RESULT_MAX * 2
    gen = rt.remote(num_returns="streaming")(cases.big_stream).remote(3, size)
    refs = list(gen)
    items = rt.get(refs, timeout=T)
    assert [int(x[0]) for x in items] == [0, 1, 2]
    assert all(x.nbytes == size and not x.flags.writeable
               and cases.in_segment(x) for x in items)
    # In the node's store while their refs live (the store's count moves
    # with other tests' objects, which reference counts free meanwhile).
    from ray_tpu_torch._private import messages as pb

    assert all(cluster.head_node.GetObjectsMeta(pb.GetObjectsMetaRequest(
        object_ids=[r.binary() for r in refs]), None).found)
    _core().free(refs)


def _segments_of(oids):
    """The segments in ``/dev/shm`` of these object ids (a client's
    ``rtst-<oid>`` or a store's ``rtst-<store>.<oid>``): other processes
    of the host make and drop segments of their own meanwhile."""
    hexes = [o.hex() for o in oids]
    return {n for n in _segments() if any(n.endswith(h) for h in hexes)}


def test_owner_local_large_get_is_identity(cluster):
    """``tests/test_object_zero_copy.py``'s case the other tests here do
    not hold: a get in the putting process is a hit of its own store and
    returns the very object put, no copy and no deserialization."""
    arr = np.random.default_rng(0).integers(0, 255, size=MB4,
                                            dtype=np.uint8)
    ref = rt.put(arr)
    assert rt.get(ref, timeout=T) is arr


def test_free_and_shutdown_leave_no_segment(cluster):
    c = Cluster(head_node_args={"num_cpus": 1})
    store = c.head_node._shm.prefix
    # This test's own cluster: a second runtime would need a second
    # process, so it drives the node's service the way a driver does.
    from ray_tpu_torch._private import messages as pb
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.runtime.cluster import put_to_node
    from ray_tpu_torch._private.serialization import Serializer

    node = rpc.get_stub("NodeService", c.head_node.address)
    ids = [os.urandom(28) for _ in range(3)]
    for i, oid in enumerate(ids):
        s = Serializer().serialize(np.full(MB4 if i else 10, i))
        assert put_to_node(node, oid, s, "test")
    # The small object in a segment of the store's, the large ones in
    # segments their putter made.
    assert len(_segments_of(ids)) == 3
    assert _segments_of(ids[:1]) == {f"{store}.{ids[0].hex()}"}
    assert c.head_node.store_stats()[1] == 3
    node.FreeObjects(pb.FreeObjectsRequest(object_ids=ids[:1]))
    assert c.head_node.store_stats()[1] == 2
    assert _segments_of(ids) == _segments_of(ids[1:]) and \
        len(_segments_of(ids)) == 2
    c.shutdown()
    assert not _segments_of(ids)
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(store)]
    # And the module's cluster: a freed put leaves nothing behind.
    ref = rt.put(np.ones(MB4 // 8))
    seg = f"{SEGMENT_PREFIX}{ref.id().hex()}"
    assert seg in _segments()
    _core().free([ref])
    assert seg not in _segments()


def _node_value(node, oid):
    from ray_tpu_torch._private import messages as pb
    from ray_tpu_torch._private.runtime.cluster import read_object_reply

    reply = node.GetObject(pb.GetObjectRequest(object_id=oid))
    assert reply.found
    found, value = read_object_reply(reply)
    assert found
    return value


def test_put_past_the_budget_raises_naming_item_20b(monkeypatch, tmp_path):
    """(Named for what it checked before spilling was ported.) A put past
    the store's budget spills the coldest object to the node's spill
    directory instead of being refused; a get brings the spilled object
    back (spilling the other), both equal to what was put, and the
    node's end removes the spill directory."""
    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_BYTES", str(MB4))
    c = Cluster(head_node_args={"num_cpus": 1,
                                "spill_dir": str(tmp_path / "spill")})
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.runtime.cluster import put_to_node
    from ray_tpu_torch._private.serialization import Serializer

    node = rpc.get_stub("NodeService", c.head_node.address)
    first, second = os.urandom(28), os.urandom(28)
    # 1.5 MB and 2.5 MB: both do not fit 4 MB, either alone stays under
    # the high-water mark.
    a, b = np.full(MB4 * 3 // 64, 1.0), np.full(MB4 * 5 // 64, 2.0)
    try:
        assert put_to_node(node, first, Serializer().serialize(a), "test")
        assert put_to_node(node, second, Serializer().serialize(b), "test")
        spilled = c.head_node.spilled_objects()
        assert list(spilled) == [first.hex()]
        assert os.path.dirname(spilled[first.hex()][0]) == \
            str(tmp_path / "spill")
        assert not _segments_of([first]) and len(_segments_of([second])) == 1
        assert np.array_equal(_node_value(node, first), a)
        assert list(c.head_node.spilled_objects()) == [second.hex()]
        assert np.array_equal(_node_value(node, second), b)
        assert c.head_node.spill_stats["restored"] == 2
    finally:
        c.shutdown()
    assert not _segments_of([first, second])
    assert not (tmp_path / "spill").exists()


def test_the_budget_counts_whole_pages(monkeypatch):
    """Each object takes at least a page of ``/dev/shm``, and the budget
    counts pages: eight small objects fill eight pages' budget, which is
    past the high-water mark, so the coldest spill down to the low-water
    mark a page an object; the ninth, which used to be refused, is
    seated; freed objects leave neither pages nor files."""
    import mmap

    from ray_tpu_torch._private import messages as pb
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.runtime.cluster import put_to_node
    from ray_tpu_torch._private.serialization import Serializer

    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_BYTES", str(8 * mmap.PAGESIZE))
    c = Cluster(head_node_args={"num_cpus": 1})
    head = c.head_node
    node = rpc.get_stub("NodeService", head.address)
    ids = [os.urandom(28) for _ in range(10)]
    try:
        for oid in ids[:8]:
            assert put_to_node(node, oid, Serializer().serialize(1), "test")
        # Eight pages are past the high-water mark: the node's spill
        # thread drains down to the low-water mark, a page an object.
        low = int(head.SPILL_LOW * 8)
        deadline = time.monotonic() + 10
        while head._store_pages > low * mmap.PAGESIZE and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        used, count = head.store_stats()
        assert head._store_pages == count * mmap.PAGESIZE <= \
            low * mmap.PAGESIZE and used < mmap.PAGESIZE
        assert len(head.spilled_objects()) == 8 - count
        assert ids[0].hex() in head.spilled_objects()
        assert all(node.GetObjectsMeta(pb.GetObjectsMetaRequest(
            object_ids=ids[:8])).found)
        # The ninth, once refused, is seated; a spilled one comes back.
        assert put_to_node(node, ids[8], Serializer().serialize(1), "test")
        assert _node_value(node, ids[0]) == 1
        assert head._store_pages <= 8 * mmap.PAGESIZE
        node.FreeObjects(pb.FreeObjectsRequest(object_ids=ids[:9]))
        assert head._store_pages == 0 and not head.spilled_objects()
        assert put_to_node(node, ids[9], Serializer().serialize(1), "test")
    finally:
        c.shutdown()


def _parity_script(pkg, cases_mod):
    """One script's values: a large put read back by a task, a large
    result, a large streamed item, a small put."""
    add = pkg.remote(cases_mod.add)
    big = np.arange(300_000, dtype=np.int64)
    ref = pkg.put(big)
    out = [int(pkg.get(add.remote(ref, 1), timeout=T).sum())]
    res = pkg.get(pkg.remote(cases_mod.make_big).remote(200_000), timeout=T)
    out.append((int(res.sum()), res.dtype.str, res.shape))
    gen = pkg.remote(num_returns="streaming")(cases_mod.big_stream).remote(
        2, 150_000)
    out.append([int(pkg.get(r, timeout=T).sum()) for r in gen])
    out.append(pkg.get(pkg.put({"k": [1, 2, 3]}), timeout=T))
    return out


def test_same_script_equal_values_on_jax_cluster(cluster):
    from ray_tpu.cluster_utils import Cluster as JCluster

    port = _parity_script(rt, cases)
    jc = JCluster(head_node_args={"num_cpus": 2})
    try:
        ray_tpu.init(address=jc.address)
        try:
            jax_out = _parity_script(ray_tpu, cases)
        finally:
            ray_tpu.shutdown()
    finally:
        jc.shutdown()
    assert port == jax_out
