"""Node-label scheduling on the port's cluster runtime, held to
``tests/test_scheduling_labels.py`` (its 10 stories: In, NotIn, Exists,
DoesNotExist for tasks and actors, hard and soft, SPREAD actors, soft
affinity falling back, and infeasible selectors).

A property test adds parity with JAX's policies: over 200 drawn node
tables and demands, the port's ``scheduler/policies.py`` and JAX's
(fed ``ray_tpu.protobuf`` ``NodeInfo`` messages built from the same
dicts) pick the same node, or the same bundle placement.
"""

import time

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.util import (DoesNotExist, Exists, In,
                                NodeAffinitySchedulingStrategy,
                                NodeLabelSchedulingStrategy, NotIn)

where = rt.remote(cases.where)
Pin = rt.remote(cases.Counter)


@pytest.fixture(scope="module")
def label_cluster():
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2, "labels": {"zone": "head"}})
    a = c.add_node(num_cpus=2, labels={"zone": "a", "tier": "fast",
                                       "tpu-slice": "slice-0"})
    b = c.add_node(num_cpus=2, labels={"zone": "b", "tpu-slice": "slice-1"})
    c.wait_for_nodes()
    rt.init(address=c.address)
    yield c, a.node_id, b.node_id
    rt.shutdown()
    c.shutdown()


def _run_on(strategy):
    return rt.get(where.options(scheduling_strategy=strategy).remote(),
                  timeout=60)


def test_hard_exact_match(label_cluster):
    _, node_a, node_b = label_cluster
    assert _run_on(NodeLabelSchedulingStrategy(hard={"zone": "a"})) == node_a
    assert _run_on(NodeLabelSchedulingStrategy(
        hard={"zone": In("b")})) == node_b


def test_hard_in_multiple(label_cluster):
    _, node_a, node_b = label_cluster
    got = {_run_on(NodeLabelSchedulingStrategy(hard={"zone": In("a", "b")}))
           for _ in range(4)}
    assert got <= {node_a, node_b}


def test_not_in_and_exists(label_cluster):
    _, node_a, node_b = label_cluster
    assert _run_on(NodeLabelSchedulingStrategy(
        hard={"tier": Exists()})) == node_a
    assert _run_on(NodeLabelSchedulingStrategy(
        hard={"zone": NotIn("a", "head")})) == node_b
    assert _run_on(NodeLabelSchedulingStrategy(
        hard={"tier": DoesNotExist(), "zone": NotIn("head")})) == node_b


def test_tpu_slice_targeting(label_cluster):
    _, _, node_b = label_cluster
    assert _run_on(NodeLabelSchedulingStrategy(
        hard={"tpu-slice": "slice-1"})) == node_b


def _wait_node_idle(node_id, cpus, timeout=20):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for n in rt.nodes():
            if n["NodeID"] == node_id and n["Available"].get("CPU", 0) >= cpus:
                return
        time.sleep(0.2)


def test_soft_prefers_but_falls_back(label_cluster):
    _, node_a, _ = label_cluster
    _wait_node_idle(node_a, 2)
    assert _run_on(NodeLabelSchedulingStrategy(soft={"zone": "a"})) == node_a
    assert _run_on(NodeLabelSchedulingStrategy(soft={"zone": "nowhere"}))


def test_hard_infeasible_errors(label_cluster):
    with pytest.raises(RayTpuError):
        rt.get(where.options(scheduling_strategy=NodeLabelSchedulingStrategy(
            hard={"zone": "mars"})).remote(), timeout=30)


def test_actor_label_scheduling(label_cluster):
    _, _, node_b = label_cluster
    a = Pin.options(scheduling_strategy=NodeLabelSchedulingStrategy(
        hard={"zone": "b"})).remote()
    assert rt.get(a.node.remote(), timeout=60) == node_b
    rt.kill(a)


def test_spread_actors_use_multiple_nodes(label_cluster):
    actors = [Pin.options(scheduling_strategy="SPREAD").remote()
              for _ in range(4)]
    nodes = {rt.get(a.node.remote(), timeout=60) for a in actors}
    assert len(nodes) >= 2, nodes
    for a in actors:
        rt.kill(a)


def test_soft_affinity_actor_falls_back(label_cluster):
    _, node_a, _ = label_cluster
    Big = rt.remote(num_cpus=2)(cases.Counter)
    _wait_node_idle(node_a, 2)
    filler = Big.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_a, soft=False)).remote()
    assert rt.get(filler.node.remote(), timeout=60) == node_a
    soft = Big.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_a, soft=True)).remote()
    got = rt.get(soft.node.remote(), timeout=60)
    assert got and got != node_a
    rt.kill(filler)
    rt.kill(soft)


def test_actor_label_infeasible_dies(label_cluster):
    a = Pin.options(scheduling_strategy=NodeLabelSchedulingStrategy(
        hard={"zone": "mars"})).remote()
    with pytest.raises(Exception):
        rt.get(a.node.remote(), timeout=30)


# ------------------------------------------------- parity with JAX's policies
_LABELS = st.dictionaries(st.sampled_from(["zone", "tier", "tpu-slice"]),
                          st.sampled_from(["a", "b", "c"]), max_size=2)


@st.composite
def _tables(draw):
    n = draw(st.integers(1, 5))
    nodes = []
    for i in range(n):
        total = {"CPU": float(draw(st.integers(1, 8)))}
        if draw(st.booleans()):
            total["GPU"] = float(draw(st.integers(1, 4)))
        if draw(st.booleans()):
            total["special"] = float(draw(st.integers(1, 2)))
        avail = {k: float(draw(st.integers(0, int(v))))
                 for k, v in total.items()}
        nodes.append(dict(node_id=f"n{i}", address=f"127.0.0.1:{i}",
                          alive=draw(st.booleans()) or i == 0,
                          resources=total, available=avail,
                          labels=draw(_LABELS)))
    demand = {"CPU": float(draw(st.integers(0, 6)))}
    if draw(st.booleans()):
        demand["GPU"] = float(draw(st.integers(1, 3)))
    bundles = [{"CPU": float(draw(st.integers(1, 4)))}
               for _ in range(draw(st.integers(1, 4)))]
    strategy = draw(st.sampled_from(["PACK", "SPREAD", "STRICT_PACK",
                                     "STRICT_SPREAD"]))
    selector = {"hard": {"zone": {"in": draw(st.lists(
        st.sampled_from(["a", "b", "c"]), min_size=1, max_size=2))}}}
    affinity = (draw(st.sampled_from([n["node_id"] for n in nodes])),
                draw(st.booleans()))
    return nodes, demand, bundles, strategy, selector, affinity


def _decisions(policies, pb, table):
    nodes, demand, bundles, strategy, selector, affinity = table
    infos = [pb.NodeInfo(**n) for n in nodes]
    group = pb.PlacementGroupInfo(group_id=b"g", strategy=strategy)
    for i, b in enumerate(bundles):
        group.bundles.add(index=i, resources=b)
    return (policies.pick_node_hybrid(infos, demand),
            policies.pick_node_hybrid(infos, demand, local_node_id="n1"),
            policies.pick_node_spread(infos, demand),
            policies.pick_node_affinity(infos, demand, *affinity),
            policies.feasible_anywhere(infos, demand),
            policies.feasible_with_labels(infos, demand, selector),
            [policies.match_labels(dict(n.labels), selector["hard"])
             for n in infos],
            policies.place_bundles(group, infos))


@settings(max_examples=200, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(_tables())
def test_policies_match_jax_over_drawn_tables(table):
    from ray_tpu._private.scheduler import policies as jpol
    from ray_tpu.protobuf import ray_tpu_pb2 as jpb

    from ray_tpu_torch._private import messages as tpb
    from ray_tpu_torch._private.scheduler import policies as tpol

    assert _decisions(tpol, tpb, table) == _decisions(jpol, jpb, table)
