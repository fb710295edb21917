"""Serve over the port's cluster on the CPU (JAX's
``tests/test_serve_cluster.py``): with the driver connected to a cluster,
``serve.run`` creates each replica as a cluster actor the GCS places, the
routing table is pushed over the GCS pubsub, and a handle injected into a
replica routes from that replica's worker.

First, a replica that asks for a card beside a node of this process that
owns the card: it starts as a cluster actor on that node (the forked
replica path booked it in this process's card book, which the node had
taken). Then JAX's six cases: push on re-deploy, replica death retry,
COMPACT, SPREAD, async overlap and composition (the controller reached
through ``serve.api._get_controller()``, the port's way to it); the
route subscription surviving a GCS restart; and a tiny fp32 Llama served
over the cluster, whose greedy tokens equal the JAX package's engine on
the same converted params. The deployment classes are module-level in
``tests/torch_cluster_cases.py`` (a replica imports its class by name).
Every test is bounded by an alarm of its own.
"""

import os
import signal
import time

import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch import serve
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.runtime.cluster_replica import ClusterReplica
from ray_tpu_torch.serve import api as serve_api

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


@pytest.fixture(scope="module", autouse=True)
def serve_cluster():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    c = Cluster(head_node_args={"num_cpus": 8})
    c.wait_for_nodes()
    rt.init(address=c.address)
    yield c
    serve.shutdown()
    rt.shutdown()
    c.shutdown()


def test_card_replica_starts_as_a_cluster_actor_on_the_card_node(
        serve_cluster):
    card = serve_cluster.add_node(num_cpus=2, num_gpus=1, card_ids=[0])
    serve_cluster.wait_for_nodes()
    h = serve.run(serve.deployment(
        cases.CardWhere, name="CardWhere", num_replicas=2,
        ray_actor_options={"num_gpus": 0.5}).bind())
    seen = [h.remote(i).result(timeout_s=60) for i in range(6)]
    assert {s["node_id"] for s in seen} == {card.node_id}
    assert {s["cuda_visible_devices"] for s in seen} == {"0"}
    assert len({s["pid"] for s in seen}) == 2
    assert set(s["pid"] for s in seen) <= set(card.worker_pids())
    assert all(isinstance(r, ClusterReplica) for r in h._replicas)
    assert {r.info["node_id"] for r in h._replicas} == {card.node_id}
    serve.delete("CardWhere")
    serve_cluster.remove_node(card)


def test_cluster_serve_roundtrip_and_push():
    handle = serve.run(serve.deployment(cases.Echo, num_replicas=2).bind())
    assert handle.remote(7).result(timeout_s=60) == 7
    assert len(handle._replicas) == 2

    # Scale up via a re-deploy; the handle must observe the new table via
    # the pushed event (its dirty flag), not a TTL.
    controller = serve_api._get_controller()
    controller.deploy("Echo", cases.Echo, (), {}, 3, False, 100, None)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        handle.remote(0).result(timeout_s=30)
        if len(handle._replicas) == 3:
            break
        time.sleep(0.1)
    assert len(handle._replicas) == 3
    serve.delete("Echo")


def test_cluster_replica_death_retry():
    handle = serve.run(serve.deployment(cases.Worky, num_replicas=2).bind())
    assert handle.remote(3).result(timeout_s=60) == 6
    # Kill one replica out from under the handle: the in-flight or next
    # call must recover via refresh-and-retry, not surface ActorDiedError.
    victim = handle._replicas[0]
    rt.kill(victim.actor)
    ok = 0
    for i in range(10):
        assert handle.remote(i).result(timeout_s=30) == i * 2
        ok += 1
    assert ok == 10
    serve.delete("Worky")


def test_streamed_items_are_freed(serve_cluster):
    """A streamed item is a node-store object whose one reference is the
    one the handle's stream reads: with no explicit free anywhere, the
    reference counts alone take streams of many items, their end markers
    and unary results out of the node stores, whose object counts go
    back to where they were."""
    def objects():
        return sum(n.store_stats()[1] for n in serve_cluster.nodes)

    h = serve.run(serve.deployment(cases.Streamer, name="Tokens").bind())
    assert list(h.options("gen", stream=True).remote(3)) == [0, 10, 20]
    time.sleep(0.5)
    count0 = objects()
    for _ in range(3):
        got = list(h.options("gen", stream=True).remote(40))
        assert got == [i * 10 for i in range(40)]
    deadline = time.monotonic() + 20
    while objects() > count0 and time.monotonic() < deadline:
        time.sleep(0.1)
    assert objects() <= count0
    serve.delete("Tokens")


# --------------------------------------------- deployment placement strategy

def _ensure_extra_nodes(cluster, n=2):
    if not getattr(cluster, "_extra_nodes_added", False):
        for _ in range(n):
            cluster.add_node(num_cpus=4)
        cluster.wait_for_nodes()
        cluster._extra_nodes_added = True


def test_compact_placement_gangs_replicas(serve_cluster):
    """COMPACT deployments reserve a PACK placement group and land every
    replica on one node (reference: deployment_scheduler compact
    placement)."""
    _ensure_extra_nodes(serve_cluster)
    h = serve.run(serve.deployment(
        cases.WhereNode, name="WhereCompact", num_replicas=3,
        placement_strategy="COMPACT",
        ray_actor_options={"num_cpus": 1}).bind(), name="compact_app")
    nodes = {h.remote(i).result(timeout_s=60) for i in range(6)}
    assert len(nodes) == 1, nodes
    serve.delete("WhereCompact")


def test_spread_placement_uses_multiple_nodes(serve_cluster):
    _ensure_extra_nodes(serve_cluster)
    h = serve.run(serve.deployment(
        cases.WhereNode, name="WhereSpread", num_replicas=4,
        placement_strategy="SPREAD",
        ray_actor_options={"num_cpus": 1}).bind(), name="spread_app")
    nodes = {h.remote(i).result(timeout_s=60) for i in range(12)}
    assert len(nodes) >= 2, nodes
    serve.delete("WhereSpread")


def test_async_replica_overlaps_slow_requests(serve_cluster):
    """A replica with an async __call__ runs on the worker's event loop and
    overlaps slow awaits (reference: replicas execute user code on an
    asyncio loop, serve/_private/replica.py)."""
    h = serve.run(serve.deployment(
        cases.SlowAsync, name="SlowAsync", num_replicas=1,
        max_ongoing_requests=8).bind(), name="slow_async_app")
    h.remote(0).result(timeout_s=60)  # warm the replica
    t0 = time.monotonic()
    futs = [h.remote(i) for i in range(6)]
    assert sorted(f.result(timeout_s=60) for f in futs) == list(range(6))
    elapsed = time.monotonic() - t0
    assert elapsed < 6 * 0.5 * 0.7, \
        f"async replica did not overlap requests: {elapsed:.2f}s"
    serve.delete("SlowAsync")


def test_cluster_composition_pipeline(serve_cluster):
    """Nested bound deployments deploy recursively; the injected handle
    pickles into the consumer replica's process and routes from there."""
    doubler = serve.deployment(cases.Doubler, name="Doubler")
    chain = serve.deployment(cases.Chain, name="Chain")
    h = serve.run(chain.bind(doubler.bind()), name="chain_app")
    assert h.remote(20).result(timeout_s=60) == 41
    # The inner handle routes from the Chain replica's worker: after the
    # Doubler replica dies, the next call there refreshes and retries.
    rt.kill(serve_api._get_controller().get_replicas("Doubler")[0].actor)
    assert h.remote(5).result(timeout_s=60) == 11
    serve.delete("Chain")
    serve.delete("Doubler")


def test_route_subscription_survives_a_gcs_restart(tmp_path):
    """A GCS restart breaks every subscription; the route subscription of
    a process without the controller (``GcsRoutes``, as a replica's
    handles use) comes back and sees the next route change, and so does
    the handle (here, in a cluster of its own with a persisted GCS)."""
    from ray_tpu_torch.runtime.cluster_replica import GcsRoutes

    serve.shutdown()
    rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 4},
                gcs_persist_path=str(tmp_path / "gcs"))
    try:
        rt.init(address=c.address)
        h = serve.run(serve.deployment(cases.Echo, num_replicas=1).bind())
        assert h.remote(1).result(timeout_s=60) == 1
        events = []
        routes = GcsRoutes()
        routes.subscribe(events.append)
        c.restart_gcs()
        c.wait_for_nodes(timeout_s=60)
        serve_api._get_controller().deploy("Echo", cases.Echo, (), {}, 2,
                                           False, 100, None)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                len(h._replicas) != 2 or "Echo" not in events):
            h.remote(0).result(timeout_s=30)
            time.sleep(0.1)
        assert len(h._replicas) == 2 and "Echo" in events
        assert len(routes.get_routes("Echo")[1]) == 2
        assert h.remote(2).result(timeout_s=30) == 2
    finally:
        serve.shutdown()
        rt.shutdown()
        c.shutdown()


# ------------------------------------------------- the slice as a whole
def test_tiny_llama_served_over_the_cluster_gives_jax_greedy_tokens():
    """The tiny fp32 Llama deployed with ``serve.run`` on a cluster (one
    replica, a cluster actor): streamed greedy tokens through the handle
    equal the JAX package's engine on the same converted params
    (``tests/test_torch_cluster_llm.py``'s reference)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import torch_cluster_llm_cases as llm_cases
    from ray_tpu import llm as jllm
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.interop import params_to_numpy
    from ray_tpu_torch.models import llama as tl

    engine = dict(num_slots=4, max_len=128)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    tp = tl.init_params(tcfg, torch.Generator().manual_seed(5), "cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    jeng = jllm.ContinuousLlamaDeployment._cls_or_fn(
        config=jl.LlamaConfig.tiny(dtype=jnp.float32), params=jp, **engine)
    c = Cluster(head_node_args={"num_cpus": 2})
    try:
        if rt.is_initialized():
            rt.shutdown()
        rt.init(address=c.address)
        h = serve.run(serve.deployment(
            llm_cases.ScoringLlm, name="TinyLlm",
            ray_actor_options={"num_cpus": 1}).bind(
                config=tcfg, params=tp, device="cpu", **engine))
        rng = np.random.default_rng(0)
        prompts = [list(map(int, rng.integers(1, 250, size=n)))
                   for n in (5, 17, 40, 9)]
        streams = [h.options("generate", stream=True).remote(p, 12)
                   for p in prompts]
        got = [[int(t) for t in s] for s in streams]
        for p, toks in zip(prompts, got):
            assert toks == [int(t) for t in jeng.generate(p, 12)]
        replica, = h._replicas
        assert isinstance(replica, ClusterReplica)
        assert replica.pid != os.getpid()
        assert replica.pid in c.head_node.worker_pids()
    finally:
        serve.shutdown()
        rt.shutdown()
        c.shutdown()
