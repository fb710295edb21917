"""Distributed reference counts and lineage reconstruction on the port's
cluster runtime, held to ``tests/test_refcount_lineage.py`` (its nine
cases, in its words where they still hold).

Reference behaviours: ``reference_count.h:66`` (an object is freed when
every ref to it is gone), ``task_manager.h:274`` ``ResubmitTask`` and the
object recovery manager (a lost object is made again by running its task
again). Each case starts a fresh port cluster (a 4-CPU head); the cases'
functions and classes are module-level (``tests/torch_cluster_cases.py``).
Every test is bounded by an alarm of its own.
"""

import gc
import os
import signal
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import rpc
from ray_tpu_torch.cluster_utils import Cluster

LIMIT_S = 90

produce = rt.remote(cases.produce)
RefHolder = rt.remote(cases.RefHolder)
sum_nested = rt.remote(cases.sum_nested)
CtorConsumer = rt.remote(cases.CtorConsumer)


@pytest.fixture(autouse=True)
def _bounded():
    def expire(*_):
        raise TimeoutError(f"test ran past its {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def fresh_cluster():
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 4})
    yield c
    rt.shutdown()
    c.shutdown()


def _directory_locations(gcs_address: str, oid: bytes):
    gcs = rpc.get_stub("GcsService", gcs_address)
    return list(gcs.GetObjectLocations(
        pb.GetObjectLocationsRequest(object_id=oid)).node_ids)


def _until(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def test_refcount_zero_frees_stored_object(fresh_cluster):
    c = fresh_cluster
    rt.init(address=c.address)
    # A large value: the node's store and a directory entry.
    ref = rt.put(np.ones(300_000, np.uint8))
    oid = ref.id().binary()
    assert rt.get(ref).sum() == 300_000
    assert _until(lambda: _directory_locations(c.address, oid), 10)
    del ref
    gc.collect()
    # The count's flush (100 ms), the GCS's grace (500 ms), the free.
    assert _until(lambda: not _directory_locations(c.address, oid), 10), \
        "object not freed after all references dropped"
    seg = f"rtst-{oid.hex()}"
    assert _until(lambda: seg not in os.listdir("/dev/shm"), 5)


def test_live_reference_keeps_object(fresh_cluster):
    c = fresh_cluster
    rt.init(address=c.address)
    ref = rt.put(np.ones(300_000, np.uint8))
    oid = ref.id().binary()
    rt.get(ref)
    time.sleep(1.5)  # longer than the flush and grace windows
    assert _directory_locations(c.address, oid), \
        "object freed while a reference is still live"
    assert rt.get(ref).sum() == 300_000


def test_lineage_reconstruction_cpu(fresh_cluster):
    from ray_tpu_torch._private import worker as worker_mod

    c = fresh_cluster
    second = c.add_node(num_cpus=2)
    c.wait_for_nodes()
    rt.init(address=c.address)
    # Enough producers that some land on the second node.
    refs = [produce.options(scheduling_strategy="SPREAD").remote(i)
            for i in range(6)]
    vals = rt.get(refs, timeout=60)
    assert all(v.sum() == 300_000 * 7 for v in vals)
    runtime = worker_mod.global_worker().core
    runtime.memory.delete([r.id() for r in refs])
    del vals
    c.remove_node(second, allow_graceful=False)
    assert _until(lambda: len([n for n in rt.nodes() if n["Alive"]]) == 1,
                  15)
    # Every object comes back: survivors from the head's store, the lost
    # ones run again from their lineage.
    vals = rt.get(refs, timeout=120)
    assert all(v.sum() == 300_000 * 7 for v in vals)


def test_dead_worker_holder_reaped(fresh_cluster):
    """kill -9 of a worker holding the only refs left: the objects are
    freed (the reference ties refs to their holder's liveness)."""
    c = fresh_cluster
    rt.init(address=c.address)
    holder = RefHolder.remote()
    ref = rt.put(np.ones(300_000, np.uint8))
    oid = ref.id().binary()
    assert rt.get(holder.hold.remote([ref]), timeout=60) is True
    pid = rt.get(holder.pid.remote(), timeout=60)
    del ref
    gc.collect()
    time.sleep(1.5)  # the driver's decrement flushed; the actor's borrow
    assert _directory_locations(c.address, oid), \
        "actor borrow should keep the object alive"
    os.kill(pid, signal.SIGKILL)
    assert _until(lambda: not _directory_locations(c.address, oid), 15), \
        "dead worker's refcounts were not reaped"


def test_borrower_of_freed_object_gets_object_lost_error(fresh_cluster):
    from ray_tpu_torch._private.object_ref import ObjectRef

    c = fresh_cluster
    rt.init(address=c.address)
    ref = rt.put(np.ones(300_000, np.uint8))
    oid = ref.id().binary()
    binary, owner = ref.binary(), ref.owner_address()
    assert _until(lambda: _directory_locations(c.address, oid), 10)
    del ref
    gc.collect()
    assert _until(lambda: not _directory_locations(c.address, oid), 10)
    # A late borrower (a stale ref deserialized) fails fast and typed.
    stale = ObjectRef.from_binary(binary, owner)
    t0 = time.monotonic()
    with pytest.raises(rt.exceptions.ObjectLostError):
        rt.get(stale, timeout=30)
    assert time.monotonic() - t0 < 10, "ObjectLostError should be fast"


def test_nested_ref_pinned_across_submit(fresh_cluster):
    """Refs nested in containers are pinned for the task's flight."""
    c = fresh_cluster
    rt.init(address=c.address)
    ref = rt.put(np.ones(300_000, np.uint8))
    out = sum_nested.remote([ref])
    del ref  # only the task in flight references it now
    gc.collect()
    assert rt.get(out, timeout=60) == 300_000


def test_nested_ref_pinned_across_actor_submit(fresh_cluster):
    c = fresh_cluster
    rt.init(address=c.address)
    holder = RefHolder.remote()
    ref = rt.put(np.full(300_000, 3, np.uint8))
    oid = ref.id().binary()
    ok = holder.hold.remote([ref])
    del ref
    gc.collect()
    assert rt.get(ok, timeout=60) is True
    time.sleep(1.5)  # the flush windows: the actor's borrow pins it now
    assert _directory_locations(c.address, oid)


def test_stale_driver_holder_reaped(fresh_cluster, monkeypatch):
    """A crashed driver (no last flush) stops pinging; its counts are
    reaped after the TTL instead of pinning objects for ever."""
    from ray_tpu_torch._private.gcs import server as gcs_server_mod
    from ray_tpu_torch._private.refcount import ReferenceCounter

    monkeypatch.setattr(gcs_server_mod, "DRIVER_HOLDER_TTL_S", 1.5)
    c = fresh_cluster
    rt.init(address=c.address)
    ref = rt.put(np.ones(300_000, np.uint8))
    oid = ref.id().binary()
    # A second driver registers a count, then "crashes" (its flush
    # thread stopped without the last decrement).
    gcs = rpc.get_stub("GcsService", c.address)
    crashed = ReferenceCounter(gcs, "crashed-driver", is_driver=True)
    crashed.incr(oid)
    assert crashed.flush()
    crashed._stop.set()  # no more pings: crashed, as the GCS sees it
    del ref
    gc.collect()
    assert _until(lambda: not _directory_locations(c.address, oid), 45), \
        "stale driver holder not reaped"


def test_ctor_args_pinned_until_actor_settles(fresh_cluster):
    """An actor's constructor arguments (nested refs too) are pinned
    until it is ALIVE or DEAD: placement can outlast the caller's last
    ref."""
    c = fresh_cluster
    rt.init(address=c.address)
    ref = rt.put(np.full(300_000, 2, np.uint8))
    a = CtorConsumer.remote([ref])
    del ref
    gc.collect()
    assert rt.get(a.total_.remote(), timeout=60) == 600_000
