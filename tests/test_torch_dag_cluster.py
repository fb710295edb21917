"""The compiled DAG over the port's cluster on the CPU (JAX's
``tests/test_dag_cluster.py``): each actor of the graph runs the pinned
``__ray_dag_loop__`` in its worker process, and a hop rides the
shared-memory channels instead of a lease and a push. JAX's two cases,
with its 4x floor on the hop; after each teardown no ``rtch-*`` segment
of the DAG is left. Every test is bounded by an alarm of its own."""

import os
import signal
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.dag import InputNode

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


@pytest.fixture(scope="module")
def dag_cluster():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    c = Cluster(head_node_args={"num_cpus": 4})
    c.wait_for_nodes()
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


Adder = rt.remote(cases.Adder)


def _left(compiled):
    """The DAG's own channel segments still in ``/dev/shm``."""
    return [c.name for c in compiled._channels
            if os.path.exists(f"/dev/shm{c.name}")]


def test_cluster_compiled_pipeline(dag_cluster):
    with InputNode() as x:
        dag = Adder.bind(1000).forward.bind(Adder.bind(100).forward.bind(x))
    compiled = dag.experimental_compile()
    try:
        assert compiled._channel_mode
        out = [rt.get(compiled.execute(i), timeout=60) for i in range(4)]
        assert out == [1100 + i for i in range(4)]
        # ndarray payloads cross process boundaries through the channel
        arr = np.arange(1024, dtype=np.float32)
        got = rt.get(compiled.execute(arr), timeout=60)
        np.testing.assert_allclose(got, arr + 1100)
    finally:
        compiled.teardown()
    assert not _left(compiled)


def test_cluster_compiled_hop_is_10x_faster_than_remote(dag_cluster):
    # Two actors: the compiled loop pins its actor, so the RPC baseline
    # must use a different one.
    a = Adder.remote(0)
    b = Adder.remote(0)
    with InputNode() as x:
        dag = b.ident.bind(x)
    compiled = dag.experimental_compile()
    try:
        # Warm both paths.
        rt.get(compiled.execute(0), timeout=60)
        rt.get(a.ident.remote(0), timeout=60)

        # Best-of-N trials: a co-tenant CPU spike during ONE loop inflates
        # that loop's mean and flips the ratio; the minimum over
        # interleaved trials measures the mechanism (shm channel vs
        # lease/submit RPC), not the neighbor's load.
        n, trials = 60, 3
        dag_lat = rpc_lat = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            for i in range(n):
                rt.get(compiled.execute(i), timeout=60)
            dag_lat = min(dag_lat, (time.perf_counter() - t0) / n)

            t0 = time.perf_counter()
            for i in range(n):
                rt.get(a.ident.remote(i), timeout=60)
            rpc_lat = min(rpc_lat, (time.perf_counter() - t0) / n)

        print(f"compiled hop {dag_lat*1e6:.0f}us vs remote {rpc_lat*1e6:.0f}us"
              f" ({rpc_lat/dag_lat:.1f}x)")
        # JAX's 4x floor: the mechanism must survive a busy shared box.
        assert dag_lat * 4 <= rpc_lat, (dag_lat, rpc_lat)
    finally:
        compiled.teardown()
    assert not _left(compiled)
    rt.kill(a)
    rt.kill(b)
