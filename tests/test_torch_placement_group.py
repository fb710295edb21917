"""The port's placement groups (:mod:`ray_tpu_torch.util.placement_group`),
held to ``tests/test_placement_group.py``: its ``test_validation`` and
its three ``test_local_mode_*`` cases, with the same assertions, and its
cluster cases on a port cluster laid out as JAX's ``pg_cluster`` (a
2-CPU head and two 4-CPU nodes of one ``tpu-slice``), the bundles
reserved through the node managers' 2PC. The local group's state is a
dataclass and the cluster's a wire message (the JAX package's is a
protobuf message), shown here to carry the same table. Both in-process
runtimes live for the module (``num_cpus=4``, no accelerator); every
``get`` has a timeout.
"""

import time

import pytest

import ray_tpu
import ray_tpu_torch as rt
import ray_tpu_torch.util
from ray_tpu_torch.util import (
    PlacementGroupSchedulingStrategy,
    get_current_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)

T = 30


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    ray_tpu.init(num_cpus=4, num_gpus=0, num_tpus=0)
    rt.init(num_cpus=4, num_gpus=0)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


def test_validation():
    with pytest.raises(ValueError, match="strategy"):
        placement_group([{"CPU": 1}], strategy="DIAGONAL")
    with pytest.raises(ValueError, match="at least one"):
        placement_group([])
    with pytest.raises(ValueError, match="non-empty"):
        placement_group([{}])


def test_local_mode_placement_group():
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(10)
    assert placement_group_table(pg)["state"] == "CREATED"

    @rt.remote(num_cpus=1)
    def f():
        return 42

    assert rt.get(f.options(
        placement_group=pg, placement_group_bundle_index=0).remote(),
        timeout=30) == 42
    # Serialized within one 1-CPU bundle:
    @rt.remote(num_cpus=1)
    def nap():
        time.sleep(0.3)
        return 1

    start = time.monotonic()
    rt.get([nap.options(placement_group=pg,
                        placement_group_bundle_index=0).remote()
            for _ in range(2)], timeout=30)
    assert time.monotonic() - start >= 0.55
    remove_placement_group(pg)
    assert placement_group_table(pg)["state"] == "REMOVED"


def test_local_mode_infeasible():
    pg = placement_group([{"CPU": 1000}])
    assert pg.wait(5) is False


def test_local_mode_capture():
    pg = placement_group([{"CPU": 2}])
    assert pg.wait(10)

    @rt.remote(num_cpus=1)
    def parent():
        cur = get_current_placement_group()
        return cur.id if cur else None

    got = rt.get(parent.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0,
            placement_group_capture_child_tasks=True)).remote(), timeout=30)
    assert got == pg.id
    remove_placement_group(pg)


# ------------------------------------------------------- the port's own

def test_cluster_cases_raise_not_ported():
    """JAX's cluster cases on the port's cluster: a PACK group's table,
    tasks and an actor placed on their bundle's node, STRICT_PACK on one
    node, PACK over two nodes kept inside one ``tpu-slice``, and removal
    giving the reservation back."""
    import torch_cluster_cases as cases
    from ray_tpu_torch.cluster_utils import Cluster

    rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2})
    try:
        c.add_node(num_cpus=4, labels={"tpu-slice": "slice-a"})
        c.add_node(num_cpus=4, labels={"tpu-slice": "slice-a"})
        c.wait_for_nodes()
        rt.init(address=c.address)
        pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
        assert pg.wait(30)
        table = placement_group_table(pg)
        assert table["state"] == "CREATED" and table["strategy"] == "PACK"
        assert set(table["bundles"]) == {0, 1}
        assert all(table["bundles_to_node_id"].values())
        where = rt.remote(num_cpus=1)(cases.where)
        got = rt.get(where.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                pg, placement_group_bundle_index=1)).remote(), timeout=T)
        assert got == pg.bundle_node_ids()[1]
        actor = rt.remote(num_cpus=1)(cases.Counter).options(
            placement_group=pg, placement_group_bundle_index=0).remote()
        assert rt.get(actor.node.remote(), timeout=T) == \
            pg.bundle_node_ids()[0]
        assert rt.get(pg.ready(), timeout=T) is True
        rt.kill(actor)
        remove_placement_group(pg)

        strict = placement_group([{"CPU": 1}] * 3, strategy="STRICT_PACK")
        assert strict.wait(30) and len(set(strict.bundle_node_ids())) == 1
        remove_placement_group(strict)
        slice_nodes = {n.node_id for n in c.nodes[1:]}
        wide = placement_group([{"CPU": 3}, {"CPU": 3}], strategy="PACK")
        assert wide.wait(30)
        assert set(wide.bundle_node_ids()) <= slice_nodes
        remove_placement_group(wide)
        deadline = time.monotonic() + 10
        while rt.available_resources().get("CPU") != 10.0 and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        assert rt.available_resources()["CPU"] == 10.0
        infeasible = placement_group([{"CPU": 100}], strategy="STRICT_PACK")
        assert not infeasible.wait(30)
        assert placement_group_table(infeasible)["state"] == "INFEASIBLE"
    finally:
        rt.shutdown()
        c.shutdown()
        rt.init(num_cpus=4, num_gpus=0)


def test_table_matches_jax_and_reserves_resources():
    """The same bundles give the same table on both packages (ids and
    node ids aside), and a created group holds its resources until
    removed."""
    import ray_tpu.util as jpg

    def table(mod):
        g = mod.placement_group([{"CPU": 1}, {"CPU": 2}],
                                strategy="STRICT_PACK", name="t")
        assert g.wait(10)
        t = mod.placement_group_table(g)
        assert len(t["placement_group_id"]) == 32
        assert all(t["bundles_to_node_id"].values())
        return g, {k: v for k, v in t.items()
                   if k not in ("placement_group_id", "bundles_to_node_id")}

    g, port = table(rt.util)
    jg, jax_ = table(jpg)
    assert port == jax_ == {"name": "t", "strategy": "STRICT_PACK",
                            "state": "CREATED",
                            "bundles": {0: {"CPU": 1.0},
                                        1: {"CPU": 2.0}}}
    assert rt.available_resources()["CPU"] == 1.0
    assert g.bundle_node_ids() == [rt.nodes()[0]["NodeID"]] * 2
    remove_placement_group(g)
    jpg.remove_placement_group(jg)
    assert rt.available_resources()["CPU"] == 4.0


def test_actor_and_ready_in_a_bundle():
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="SPREAD")
    try:
        assert rt.get(pg.ready(), timeout=T) is True

        @rt.remote
        class InGroup:
            def where(self):
                return rt.get_runtime_context().get_placement_group_id()

        a = InGroup.options(
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=1,
                placement_group_capture_child_tasks=True)).remote()
        assert rt.get(a.where.remote(), timeout=T) == pg.id.hex()
        with pytest.raises(ValueError, match="out of range"):
            rt.remote(lambda: 1).options(
                placement_group=pg, placement_group_bundle_index=5).remote()
        rt.kill(a)
    finally:
        remove_placement_group(pg)
    # STRICT_SPREAD of two bundles cannot land on the one node.
    assert placement_group([{"CPU": 1}, {"CPU": 1}],
                           strategy="STRICT_SPREAD").wait(5) is False
