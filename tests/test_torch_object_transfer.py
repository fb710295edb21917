"""Transfer management and resource-view deltas on the port's cluster,
held to ``tests/test_object_transfer.py`` (its five cases): the pull
manager's admission (reference ``pull_manager.h:53``: one pull of an
object shared by its getters, a byte budget that blocks and releases,
an object over the budget admitted alone), capped outbound pushes
(``push_manager.h:30``) still serving every pull, and the resource view
updated by pushed deltas without a poll (``ray_syncer``). The cases'
functions are module-level (``tests/torch_cluster_cases.py``).
"""

import threading
import time

import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch._private.runtime.cluster import _PullManager
from ray_tpu_torch.cluster_utils import Cluster


# ------------------------------------------------------------ PullManager
def test_pull_manager_dedups_concurrent_pulls():
    pm = _PullManager(budget_bytes=1 << 20)
    assert pm.begin(b"obj1", 100) is None          # admitted
    ev = pm.begin(b"obj1", 100)                    # same object: wait
    assert ev is not None and not ev.is_set()
    pm.end(b"obj1", 100)
    assert ev.is_set()
    assert pm.begin(b"obj1", 100) is None          # admitted again
    pm.end(b"obj1", 100)


def test_pull_manager_budget_blocks_then_releases():
    pm = _PullManager(budget_bytes=1000)
    assert pm.begin(b"a", 800) is None
    got = []

    def second():
        got.append(pm.begin(b"b", 800))            # waits for budget
        pm.end(b"b", 800)

    t = threading.Thread(target=second)
    t.start()
    time.sleep(0.3)
    assert not got                                  # still waiting
    pm.end(b"a", 800)
    t.join(timeout=10)
    assert got == [None]                            # admitted after it


def test_pull_manager_fails_open_on_oversize():
    pm = _PullManager(budget_bytes=100)
    # One pull larger than the whole budget is capped, not deadlocked.
    assert pm.begin(b"big", 10_000) is None
    pm.end(b"big", 10_000)
    assert pm._avail == pm._budget


# ------------------------------------------------------- push caps + pulls
def test_capped_pushes_still_serve_all_pulls(monkeypatch):
    monkeypatch.setenv("RAY_TPU_MAX_CONCURRENT_PUSHES", "1")
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2})
    other = c.add_node(num_cpus=2)
    c.wait_for_nodes()
    rt.init(address=c.address)
    try:
        from ray_tpu_torch.util import NodeAffinitySchedulingStrategy

        make = rt.remote(cases.zero_bytes)
        # Two large objects on the other node, fetched here: with one
        # push slot the transfers queue but both complete.
        refs = [make.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                other.node_id, soft=False)).remote(600 * 1024)
            for _ in range(2)]
        vals = rt.get(refs, timeout=120)
        assert all(len(v) == 600 * 1024 for v in vals)
    finally:
        rt.shutdown()
        c.shutdown()


# ------------------------------------------------------------- the gossip
def test_resource_view_deltas_propagate_without_poll():
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2})
    b = c.add_node(num_cpus=4)
    c.wait_for_nodes()
    rt.init(address=c.address)
    try:
        a = c.head_node
        deadline = time.monotonic() + 10
        while not a._view_subscribed and time.monotonic() < deadline:
            time.sleep(0.05)
        assert a._view_subscribed
        from ray_tpu_torch.util import NodeAffinitySchedulingStrategy

        hold = rt.remote(num_cpus=3)(cases.hold_for)
        ref = hold.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            b.node_id, soft=False)).remote(4)
        # Seed the view, then freeze the poll: a later change must come
        # as a NODE_RES delta.
        a._cluster_view()
        a._view_ts = time.monotonic() + 3600
        deadline = time.monotonic() + 8
        seen = None
        while time.monotonic() < deadline:
            with a._view_lock:
                for n in a._view:
                    if n.node_id == b.node_id:
                        seen = n.available.get("CPU")
            if seen is not None and seen <= 1.0:
                break
            time.sleep(0.1)
        assert seen is not None and seen <= 1.0, \
            f"delta never applied (CPU available still {seen})"
        rt.get(ref, timeout=60)
    finally:
        rt.shutdown()
        c.shutdown()
