"""Spilling and the memory monitor on the port's cluster, held to
``tests/test_spilling.py`` (its four cases).

Reference: spilling to disk with restore on access
(``src/ray/raylet/local_object_manager.h:41``) and the host memory
monitor that sheds retriable work before the OS's OOM killer picks a
victim (``src/ray/common/memory_monitor.h:52``). The port's store counts
whole pages against its budget, so "under budget" reads the node's page
count. The cases' functions are module-level
(``tests/torch_cluster_cases.py``). Every test is bounded by an alarm of
its own.
"""

import gc
import signal
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch.cluster_utils import Cluster

MB = 1024 * 1024
LIMIT_S = 120


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
def small_store_cluster(monkeypatch, tmp_path):
    # A 4 MB budget, so a handful of ~1 MB objects spill.
    monkeypatch.setenv("RAY_TPU_OBJECT_STORE_BYTES", str(4 * MB))
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2,
                                "spill_dir": str(tmp_path / "spill")})
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()
    assert not (tmp_path / "spill").exists()


def test_spill_and_restore_roundtrip(small_store_cluster):
    """Filling the store past its budget spills to disk, keeps the store
    under its budget, and still serves every object back on get."""
    node = small_store_cluster.head_node
    refs = [rt.put(np.full(100_000, i, dtype=np.float64))  # ~800 KB each
            for i in range(12)]
    # The drain runs on the node's spill thread.
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if node.spilled_objects() and node._store_pages <= 4 * MB:
            break
        time.sleep(0.05)
    assert node.spilled_objects(), "expected cold objects to spill"
    assert node._store_pages <= 4 * MB, \
        f"store over budget after spill: {node._store_pages}"
    from ray_tpu_torch._private import worker as worker_mod

    # The driver's own copies go: every get reads the node's store.
    worker_mod.global_worker().core.memory.delete([r.id() for r in refs])
    for i, r in enumerate(refs):
        v = rt.get(r, timeout=60)
        assert int(v[0]) == i and v.shape == (100_000,)


def test_spill_task_outputs(small_store_cluster):
    """Task returns written by a worker (its segments registered) spill
    and come back as a driver's puts do."""
    make = rt.remote(cases.make_floats)
    refs = [make.remote(i, 130_000) for i in range(10)]  # ~1 MB each
    vals = [rt.get(r, timeout=120) for r in refs]
    assert [int(v[0]) for v in vals] == list(range(10))
    assert small_store_cluster.head_node.spill_stats["spilled"] > 0


def test_memory_monitor_kills_newest_task_worker(tmp_path, monkeypatch):
    """Above the usage threshold the node kills its newest leased task
    worker; the owner's crash retry finishes the task."""
    usage = tmp_path / "usage"
    usage.write_text("0.0")
    monkeypatch.setenv("RAY_TPU_MEMORY_USAGE_FILE", str(usage))
    monkeypatch.setenv("RAY_TPU_MEMORY_USAGE_THRESHOLD", "0.9")
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2})
    rt.init(address=c.address)
    try:
        slow = rt.remote(max_retries=2)(cases.slow_first_attempt)
        ref = slow.remote(str(tmp_path))
        deadline = time.monotonic() + 30
        while not (tmp_path / "attempt").exists() and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        assert (tmp_path / "attempt").exists(), "task never started"
        usage.write_text("0.99")
        node = c.head_node
        deadline = time.monotonic() + 20
        while node.oom_kills == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert node.oom_kills >= 1, "memory monitor never killed a worker"
        usage.write_text("0.0")  # pressure relieved: the retry finishes
        assert rt.get(ref, timeout=90) == "done"
    finally:
        rt.shutdown()
        c.shutdown()


def test_concurrent_store_pressure_stress(small_store_cluster):
    """Concurrent create, seal, spill, restore and free at four times the
    capacity: writers push 512 KB objects through a 4 MB store while
    readers fetch; every object reads back intact (from the store or
    its spill file), and nothing deadlocks."""
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker().core
    rng = np.random.default_rng(0)
    payloads = {i: rng.integers(0, 255, size=512 * 1024, dtype=np.uint8)
                for i in range(32)}
    refs = {}
    refs_lock = threading.Lock()
    errors = []

    def writer(start, end):
        try:
            for i in range(start, end):
                r = rt.put(payloads[i])
                core.memory.delete([r.id()])  # reads go to the store
                with refs_lock:
                    refs[i] = r
        except Exception as e:  # noqa: BLE001
            errors.append(("writer", e))

    def reader():
        try:
            for _ in range(40):
                with refs_lock:
                    items = list(refs.items())
                for i, r in items[-6:]:
                    out = rt.get(r, timeout=120)
                    assert out[0] == payloads[i][0]
                    assert out[-1] == payloads[i][-1]
        except Exception as e:  # noqa: BLE001
            errors.append(("reader", e))

    threads = [threading.Thread(target=writer, args=(0, 16)),
               threading.Thread(target=writer, args=(16, 32)),
               threading.Thread(target=reader),
               threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "stress thread hung"
    assert not errors, errors[:3]
    # Everything written survived the churn.
    for i, r in refs.items():
        out = rt.get(r, timeout=120)
        assert out.nbytes == payloads[i].nbytes
        assert out[0] == payloads[i][0] and out[-1] == payloads[i][-1]
    # Free half; the rest still resolves (the free path under load).
    for i in list(refs)[::2]:
        del refs[i]
    gc.collect()
    core.memory.delete([r.id() for r in refs.values()])
    for i, r in refs.items():
        assert rt.get(r, timeout=120)[0] == payloads[i][0]
