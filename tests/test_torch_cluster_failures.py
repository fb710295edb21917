"""Node death, actor restart across nodes, a lost result rebuilt from its
lineage, an actor killed while its node builds it, placement groups and
RPC chaos on the port's cluster runtime, held to
``tests/test_cluster_failures.py``.

Each case starts a fresh port cluster (a 4-CPU head); the cases are
module-level (``tests/torch_cluster_cases.py``). Placement groups go
straight to the GCS through the port's wire, as JAX's test goes through
its gRPC stub. The chaos case injects the same spec into the same calls
(``RAY_TPU_TESTING_RPC_FAILURE``).
"""

import time

import pytest

import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch._private import messages as pb
from ray_tpu_torch._private import rpc
from ray_tpu_torch.cluster_utils import Cluster

Pinned = rt.remote(cases.Counter)


@pytest.fixture
def fresh_cluster():
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 4})
    yield c
    rt.shutdown()
    c.shutdown()


def test_node_death_detected_and_actor_restarts(fresh_cluster, monkeypatch):
    c = fresh_cluster
    second = c.add_node(num_cpus=2, resources={"pin": 1.0})
    c.wait_for_nodes()
    rt.init(address=c.address)

    a = Pinned.options(resources={"pin": 1.0}, max_restarts=1).remote()
    assert rt.get(a.incr.remote(), timeout=60) == 1

    # Crash the second node (no drain): the GCS health checker must notice.
    c.remove_node(second, allow_graceful=False)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if len([n for n in rt.nodes() if n["Alive"]]) == 1:
            break
        time.sleep(0.25)
    assert len([n for n in rt.nodes() if n["Alive"]]) == 1

    # {"pin": 1} existed only on the dead node: the restart finds no
    # feasible node and the actor dies.
    deadline = time.monotonic() + 30
    died = False
    while time.monotonic() < deadline:
        try:
            rt.get(a.incr.remote(), timeout=10)
        except Exception:  # noqa: BLE001
            died = True
            break
        time.sleep(0.25)
    assert died


def test_actor_restarts_on_surviving_node(fresh_cluster):
    c = fresh_cluster
    second = c.add_node(num_cpus=2)
    c.wait_for_nodes()
    rt.init(address=c.address)

    actors = [Pinned.options(max_restarts=2).remote() for _ in range(3)]
    for a in actors:
        assert rt.get(a.incr.remote(), timeout=60) == 1

    c.remove_node(second, allow_graceful=False)

    for a in actors:
        deadline = time.monotonic() + 60
        ok = False
        while time.monotonic() < deadline:
            try:
                rt.get(a.incr.remote(), timeout=10)
                ok = True
                break
            except Exception:  # noqa: BLE001 — restarting
                time.sleep(0.5)
        assert ok, "actor did not recover after node death"


def test_a_lost_object_raises_object_lost_naming_item_20b(fresh_cluster):
    """(Named for what it checked before lineage was ported.) A result
    whose only copy died with its node is rebuilt from its lineage: the
    driver runs its task again (JAX's ``_maybe_reconstruct``), here on
    the head, since the task's affinity to the dead node is soft; a
    result nobody holds the lineage of raises ``ObjectLostError``."""
    import numpy as np

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.exceptions import ObjectLostError
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    c = fresh_cluster
    second = c.add_node(num_cpus=2, resources={"pin": 1.0})
    c.wait_for_nodes()
    rt.init(address=c.address)
    big = rt.remote(cases.make_big).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            second.node_id, soft=True))
    ref = big.remote(500_000)          # 4 MB: left in the node's store
    rt.wait([ref], num_returns=1, timeout=60, fetch_local=False)
    gcs = rpc.get_stub("GcsService", c.address)
    assert list(gcs.GetObjectLocations(pb.GetObjectLocationsRequest(
        object_id=ref.binary())).node_ids) == [second.node_id]
    c.remove_node(second, allow_graceful=False)
    assert np.array_equal(rt.get(ref, timeout=60), np.arange(500_000))
    # The same loss where this process holds no lineage of the result.
    third = c.add_node(num_cpus=2)
    c.wait_for_nodes()
    ref2 = big.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        third.node_id, soft=False)).remote(400_000)
    rt.wait([ref2], num_returns=1, timeout=60, fetch_local=False)
    core = worker_mod.global_worker().core
    assert list(core.gcs.GetObjectLocations(pb.GetObjectLocationsRequest(
        object_id=ref2.binary())).node_ids) == [third.node_id]
    with core._lineage_lock:
        core._lineage.pop(ref2.binary())
    c.remove_node(third, allow_graceful=False)
    with pytest.raises(ObjectLostError, match="cannot be reconstructed"):
        rt.get(ref2, timeout=60)


def test_an_actor_killed_while_it_is_built_stays_dead(fresh_cluster):
    """A kill that lands while the actor's node is still building it (the
    GCS placing it) leaves it DEAD: the worker built after the kill is
    stopped and the node's resources come back (the GCS marked such an
    actor ALIVE again, holding its resources for ever)."""
    c = fresh_cluster
    rt.init(address=c.address)
    a = rt.remote(num_cpus=2)(cases.SlowInit).remote(2.0)
    time.sleep(0.5)                   # placed; its constructor running
    rt.kill(a)
    gcs = rpc.get_stub("GcsService", c.address)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and \
            rt.available_resources().get("CPU") != 4.0:
        time.sleep(0.1)
    assert rt.available_resources().get("CPU") == 4.0
    info = gcs.GetActor(pb.GetActorRequest(actor_id=a._actor_id.binary()))
    assert info.found and info.info.state == "DEAD"
    with pytest.raises(rt.exceptions.ActorDiedError):
        rt.get(a.pid.remote(), timeout=30)


def _make_pg(gcs_address, group_id, strategy, bundles):
    gcs = rpc.get_stub("GcsService", gcs_address)
    req = pb.CreatePlacementGroupRequest(
        group_id=group_id, name="pg", strategy=strategy)
    for i, res in enumerate(bundles):
        req.bundles.add(index=i, resources=res)
    gcs.CreatePlacementGroup(req)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        reply = gcs.GetPlacementGroup(
            pb.GetPlacementGroupRequest(group_id=group_id))
        if reply.found and reply.info.state in ("CREATED", "INFEASIBLE"):
            return reply.info
        time.sleep(0.1)
    raise TimeoutError("placement group did not settle")


def test_placement_group_pack_and_spread(fresh_cluster):
    c = fresh_cluster
    c.add_node(num_cpus=4)
    c.wait_for_nodes()
    rt.init(address=c.address)

    info = _make_pg(c.address, b"pg1" + b"\x00" * 13, "PACK",
                    [{"CPU": 1.0}, {"CPU": 1.0}])
    assert info.state == "CREATED"
    assert len({b.node_id for b in info.bundles}) == 1

    info = _make_pg(c.address, b"pg2" + b"\x00" * 13, "STRICT_SPREAD",
                    [{"CPU": 1.0}, {"CPU": 1.0}])
    assert info.state == "CREATED"
    assert len({b.node_id for b in info.bundles}) == 2

    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if rt.available_resources().get("CPU", 8.0) <= 4.0:
            break
        time.sleep(0.2)
    assert rt.available_resources()["CPU"] <= 4.0

    gcs = rpc.get_stub("GcsService", c.address)
    gcs.RemovePlacementGroup(
        pb.RemovePlacementGroupRequest(group_id=b"pg1" + b"\x00" * 13))
    gcs.RemovePlacementGroup(
        pb.RemovePlacementGroupRequest(group_id=b"pg2" + b"\x00" * 13))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if rt.available_resources().get("CPU", 0) >= 8.0:
            break
        time.sleep(0.2)
    assert rt.available_resources()["CPU"] >= 8.0


def test_placement_group_infeasible(fresh_cluster):
    c = fresh_cluster
    c.wait_for_nodes()
    rt.init(address=c.address)
    info = _make_pg(c.address, b"pg3" + b"\x00" * 13, "STRICT_PACK",
                    [{"CPU": 100.0}])
    assert info.state == "INFEASIBLE"


def test_rpc_chaos_injection(fresh_cluster, monkeypatch):
    """The first lease request and the first task push fail; the
    submitter's failover and retry still complete the task."""
    c = fresh_cluster
    monkeypatch.setenv(
        "RAY_TPU_TESTING_RPC_FAILURE",
        "NodeService.RequestWorkerLease=1,WorkerService.PushTask=1")
    rpc.reset_chaos()
    try:
        rt.init(address=c.address)
        chaos_add = rt.remote(cases.chaos_add)
        assert rt.get(chaos_add.remote(41), timeout=60) == 42
        assert rpc._chaos._remaining == {
            "NodeService.RequestWorkerLease": 0, "WorkerService.PushTask": 0}
        assert rt.get([chaos_add.remote(i) for i in range(4)],
                      timeout=60) == [1, 2, 3, 4]
    finally:
        monkeypatch.delenv("RAY_TPU_TESTING_RPC_FAILURE", raising=False)
        rpc.reset_chaos()
