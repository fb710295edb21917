"""The port's cluster runtime on the CPU, held to ``tests/test_cluster.py``.

Its 15 stories run on a port :class:`~ray_tpu_torch.cluster_utils.Cluster`
(a 4-CPU head and a 4-CPU node with ``special: 2``; the GCS and node
managers in this process, the workers forked processes) with the same
assertions. The cases are module-level functions and classes of
``tests/torch_cluster_cases.py``, because the cluster runtime sends
callables by reference.

Parity: one module-scoped JAX ``ray_tpu.cluster_utils.Cluster`` and one
of the port's, laid out alike (a 2-CPU head, a 2-CPU node with
``special: 1``), run the same cases; the values, the error types and each
placement group's bundle-to-node table (node ids as their place in the
cluster's node list) must be equal. Every wait has its own timeout.
"""

import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch.cluster_utils import Cluster

T = 60


@pytest.fixture(scope="module")
def cluster():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    c = Cluster(head_node_args={"num_cpus": 4})
    c.add_node(num_cpus=4, resources={"special": 2.0})
    c.wait_for_nodes()
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


add = rt.remote(cases.add)
make_big = rt.remote(cases.make_big)
Counter = rt.remote(cases.Counter)


def test_cluster_resources(cluster):
    res = rt.cluster_resources()
    assert res["CPU"] == 8.0
    assert res["special"] == 2.0
    assert len([n for n in rt.nodes() if n["Alive"]]) == 2


def test_simple_task(cluster):
    assert rt.get(add.remote(1, 2), timeout=T) == 3


def test_many_parallel_tasks(cluster):
    refs = [add.remote(i, i) for i in range(100)]
    assert sum(rt.get(refs, timeout=120)) == sum(2 * i for i in range(100))


def test_task_errors_propagate(cluster):
    with pytest.raises(ValueError, match="bad input"):
        rt.get(rt.remote(cases.boom).remote(), timeout=T)


def test_large_object_and_dependency(cluster):
    ref = make_big.remote(500_000)  # ~4 MB: through the node store
    out = rt.get(add.remote(ref, 1), timeout=T)
    np.testing.assert_array_equal(out, np.arange(500_000) + 1)


def test_put_get_roundtrip(cluster):
    data = {"x": np.random.rand(1000), "y": [1, 2, 3]}
    got = rt.get(rt.put(data), timeout=T)
    np.testing.assert_array_equal(got["x"], data["x"])
    assert got["y"] == data["y"]


def test_spillback_to_node_with_resource(cluster):
    # "special" exists only on the second node: the local lease spills.
    where = rt.remote(resources={"special": 1.0}, num_cpus=0.1)(cases.where)
    assert rt.get(where.remote(), timeout=T) == cluster.nodes[1].node_id


def test_infeasible_task_raises(cluster):
    impossible = rt.remote(resources={"nonexistent": 1.0})(cases.add)
    with pytest.raises(Exception, match="satisfy|infeasible"):
        rt.get(impossible.remote(1, 1), timeout=T)


def test_a_card_ask_without_a_card_node_never_runs_on_the_cpu(cluster):
    """No node of this cluster owns a card: a ``num_gpus=1`` task is
    infeasible and a ``num_gpus=1`` actor dies unplaced, as in JAX;
    neither runs on the CPU."""
    with pytest.raises(rt.exceptions.RayTpuError, match="satisfy"):
        rt.get(rt.remote(num_gpus=1)(cases.visible_cards).remote(),
               timeout=T)
    a = rt.remote(num_gpus=1)(cases.Counter).remote()
    with pytest.raises(rt.exceptions.ActorDiedError, match="no feasible"):
        rt.get(a.get.remote(), timeout=T)


def test_actor_lifecycle(cluster):
    c = Counter.remote(10)
    assert rt.get(c.incr.remote(), timeout=T) == 11
    assert rt.get(c.incr.remote(5), timeout=T) == 16
    assert rt.get(c.get.remote(), timeout=T) == 16


def test_actor_ordering(cluster):
    c = Counter.remote(0)
    refs = [c.incr.remote() for _ in range(20)]
    assert rt.get(refs, timeout=T) == list(range(1, 21))


def test_named_actor(cluster):
    c = Counter.options(name="global_counter").remote(100)
    rt.get(c.get.remote(), timeout=T)
    handle = rt.get_actor("global_counter")
    assert rt.get(handle.get.remote(), timeout=T) == 100
    assert "global_counter" in rt.list_named_actors()
    rt.kill(handle)


def test_actor_restart_on_worker_crash(cluster):
    c = Counter.options(max_restarts=1).remote(5)
    assert rt.get(c.get.remote(), timeout=T) == 5
    try:
        rt.get(c.crash.remote(), timeout=30)
    except Exception:  # noqa: BLE001 — the worker died mid-call
        pass
    # The GCS restarts the actor; its state resets to the __init__ args.
    deadline = time.monotonic() + 60
    value = None
    while time.monotonic() < deadline:
        try:
            value = rt.get(c.get.remote(), timeout=30)
            break
        except Exception:  # noqa: BLE001 — restarting
            time.sleep(0.5)
    assert value == 5


def test_actor_error_propagates(cluster):
    b = rt.remote(cases.Bad).remote()
    with pytest.raises(RuntimeError, match="actor method failed"):
        rt.get(b.fail.remote(), timeout=T)


def test_nested_tasks(cluster):
    assert rt.get(rt.remote(cases.nested_outer).remote(5), timeout=T) == 12


def test_wait(cluster):
    slow = rt.remote(cases.sleep_return)
    fast_ref = slow.remote(0.01)
    slow_ref = slow.remote(5.0)
    ready, not_ready = rt.wait([fast_ref, slow_ref], num_returns=1,
                               timeout=30)
    assert ready == [fast_ref]
    assert not_ready == [slow_ref]


def test_streaming_generator_and_async_task(cluster):
    gen = rt.remote(cases.gen_n).options(num_returns="streaming").remote(5)
    assert [rt.get(r, timeout=T) for r in gen] == [0, 10, 20, 30, 40]
    assert rt.get(rt.remote(cases.coro_task).remote(41), timeout=T) == 42


def test_internal_kv_and_usage_live_in_the_gcs(cluster):
    """Connected to a cluster, ``internal_kv`` and the usage records are
    the GCS's KV (a worker sees the driver's keys), as in JAX."""
    import json
    import os

    from ray_tpu_torch._private import messages as pb
    from ray_tpu_torch._private import rpc, usage
    from ray_tpu_torch.experimental import internal_kv as kv

    assert kv.internal_kv_put("k", b"v", namespace="t")
    assert not kv.internal_kv_put("k", b"w", overwrite=False, namespace="t")
    gcs = rpc.get_stub("GcsService", cluster.address)
    assert gcs.KvGet(pb.KvRequest(ns="t", key="k")).value == b"v"
    assert kv.internal_kv_list("", namespace="t") == ["k"]
    read = rt.remote(kv.internal_kv_get)
    assert rt.get(read.remote("k", namespace="t"), timeout=T) == b"v"
    assert kv.internal_kv_del("k", namespace="t")
    assert kv.internal_kv_get("k", namespace="t") is None
    usage.record_extra_usage_tag("cluster_test", "1")
    rec = json.loads(gcs.KvGet(pb.KvRequest(
        ns="usage", key=f"worker/{os.getpid()}")).value)
    assert rec["extra_tags"]["cluster_test"] == "1"


def test_closure_raises_the_module_level_rule(cluster):
    def local_fn():
        return 1

    with pytest.raises(TypeError, match="module level"):
        rt.remote(local_fn).remote()


# ------------------------------------------------------------ parity
@pytest.fixture(scope="module")
def pair(cluster):
    """A JAX cluster and a second port cluster, laid out alike; the port's
    driver moves to its cluster for the module's parity cases."""
    from ray_tpu.cluster_utils import Cluster as JaxCluster

    rt.shutdown()

    jc = JaxCluster(head_node_args={"num_cpus": 2})
    jc.add_node(num_cpus=2, resources={"special": 1.0})
    jc.wait_for_nodes()
    pc = Cluster(head_node_args={"num_cpus": 2})
    pc.add_node(num_cpus=2, resources={"special": 1.0})
    pc.wait_for_nodes()
    ray_tpu.init(address=jc.address)
    rt.init(address=pc.address)
    yield jc, pc
    rt.shutdown()
    ray_tpu.shutdown()
    pc.shutdown()
    jc.shutdown()
    rt.init(address=cluster.address)


def _node_index(c, node_id):
    return [n.node_id for n in c.nodes].index(node_id)


def _both(case):
    """``case(pkg, remote, get)`` on both packages: ``(port, jax)``, each a
    value or the raised error's type name."""
    out = []
    for pkg in (rt, ray_tpu):
        try:
            out.append(case(pkg))
        except Exception as e:  # noqa: BLE001 — compared by type name
            out.append(("raised", type(e).__name__))
    return tuple(out)


def _case_value(pkg):
    return pkg.get(pkg.remote(cases.add).remote(20, 22), timeout=T)


def _case_large(pkg):
    ref = pkg.remote(cases.make_big).remote(200_000)
    return pkg.get(pkg.remote(cases.add).remote(ref, 1), timeout=T).tolist()


def _case_error(pkg):
    return pkg.get(pkg.remote(cases.boom).remote(), timeout=T)


def _case_infeasible(pkg):
    return pkg.get(pkg.remote(resources={"nonexistent": 1.0})(
        cases.add).remote(1, 1), timeout=T)


def _case_actor(pkg):
    c = pkg.remote(cases.Counter).remote(3)
    out = pkg.get([c.incr.remote(i) for i in range(6)], timeout=T)
    pkg.kill(c)
    return out


def _case_actor_error(pkg):
    return pkg.get(pkg.remote(cases.Bad).remote().fail.remote(), timeout=T)


def _case_put_nested(pkg):
    inner = pkg.put(np.arange(10))
    return pkg.get(pkg.remote(cases.add).remote(
        pkg.get(pkg.put({"a": inner}), timeout=T)["a"], 1),
        timeout=T).tolist()


CASES = {"value": _case_value, "large_dependency": _case_large,
         "task_error": _case_error, "infeasible": _case_infeasible,
         "actor_sequence": _case_actor, "actor_error": _case_actor_error,
         "nested_ref": _case_put_nested}


@pytest.mark.parametrize("name", sorted(CASES))
def test_parity_values_and_error_types(pair, name):
    port, jax_ = _both(CASES[name])
    assert port == jax_


def test_parity_spillback_lands_on_the_same_node(pair):
    jc, pc = pair
    port = rt.get(rt.remote(resources={"special": 1.0}, num_cpus=0.1)(
        cases.where).remote(), timeout=T)
    jax_ = ray_tpu.get(ray_tpu.remote(resources={"special": 1.0},
                                      num_cpus=0.1)(cases.where_jax).remote(),
                       timeout=T)
    assert _node_index(pc, port) == _node_index(jc, jax_) == 1


def _wait_idle(pkg, total_cpu):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if pkg.available_resources().get("CPU") == total_cpu:
            return
        time.sleep(0.1)


@pytest.mark.parametrize("strategy,bundles", [
    ("PACK", [{"CPU": 1.0}, {"CPU": 1.0}]),
    ("STRICT_SPREAD", [{"CPU": 1.0}, {"CPU": 1.0}]),
    ("SPREAD", [{"CPU": 1.0}, {"special": 1.0}]),
    ("STRICT_PACK", [{"CPU": 100.0}]),
])
def test_parity_placement_group_tables(pair, strategy, bundles):
    jc, pc = pair
    tables = []
    for pkg, c in ((rt, pc), (ray_tpu, jc)):
        from importlib import import_module

        pgmod = import_module(pkg.__name__ + ".util.placement_group")
        _wait_idle(pkg, 4.0)
        pg = pgmod.placement_group(bundles, strategy=strategy)
        ok = pg.wait(timeout_seconds=20)
        table = pgmod.placement_group_table(pg)
        tables.append((ok, table["state"], {
            i: _node_index(c, n) if n else None
            for i, n in table["bundles_to_node_id"].items()}))
        pgmod.remove_placement_group(pg)
    assert tables[0] == tables[1]
