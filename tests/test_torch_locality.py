"""Locality-aware lease targeting on the port's cluster, held to
``tests/test_locality.py`` (its three cases): a task whose large argument
lives on node B leases on node B instead of pulling the bytes
(reference: ``LocalityAwareLeasePolicy``,
``core_worker/lease_policy.h:58``). The cases' functions are module-level
(``tests/torch_cluster_cases.py``).
"""

import pytest

import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch.cluster_utils import Cluster

produce_on_b = rt.remote(resources={"b": 0.01})(cases.produce_here)
where = rt.remote(cases.where_pair)


@pytest.fixture(scope="module", autouse=True)
def cluster():
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 2})
    c.add_node(num_cpus=2, resources={"b": 1.0})
    c.wait_for_nodes()
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


def test_large_arg_steers_lease_to_holder():
    ref = produce_on_b.remote(2 * 1024 * 1024)  # 2 MB on node B
    producer_node, consumer_node = rt.get(where.remote(ref), timeout=60)
    assert consumer_node == producer_node, \
        "consumer should lease on the node holding its 2MB argument"


def test_small_arg_keeps_default_scheduling():
    """An argument under the bound does not steer (lease reuse stays)."""
    ref = produce_on_b.remote(1024)  # 1 KB: below LOCALITY_MIN_BYTES
    producer_node, consumer_node = rt.get(where.remote(ref), timeout=60)
    assert producer_node and consumer_node


def test_locality_yields_to_explicit_placement():
    from ray_tpu_torch.util import NodeAffinitySchedulingStrategy

    ref = produce_on_b.remote(2 * 1024 * 1024)
    rt.wait([ref], num_returns=1, timeout=60, fetch_local=False)
    head = rt.get_runtime_context().get_node_id()
    pinned = where.options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_id=head, soft=False)).remote(ref)
    _, consumer_node = rt.get(pinned, timeout=60)
    assert consumer_node == head, "explicit affinity must beat locality"
