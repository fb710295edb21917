"""Async actors, concurrency groups and cancellation on the port's
cluster runtime, held to ``tests/test_async_actors_cluster.py`` (12
stories) and ``tests/test_cancel_cluster.py`` (9 stories).

One module cluster (an 8-CPU head: the cancel stories saturate two CPUs
with a 2-CPU task each, as JAX's 2-CPU cluster is saturated by two
1-CPU tasks). The cases are module-level (``tests/torch_cluster_cases.py``).
"""

import time

import pytest

import ray_tpu_torch as rt
import torch_cluster_cases as cases
from ray_tpu_torch import exceptions
from ray_tpu_torch.cluster_utils import Cluster

T = 60


@pytest.fixture(scope="module", autouse=True)
def cluster():
    if rt.is_initialized():
        rt.shutdown()
    c = Cluster(head_node_args={"num_cpus": 8})
    c.wait_for_nodes()
    rt.init(address=c.address)
    yield c
    rt.shutdown()
    c.shutdown()


# ---------------------------------------------------------- async actors
def test_async_actor_basic():
    a = rt.remote(cases.AsyncActor).remote()
    refs = [a.work.remote(i) for i in range(10)]
    assert rt.get(refs, timeout=T) == [i * 2 for i in range(10)]


def test_async_actor_overlaps_slow_calls():
    a = rt.remote(cases.Sleeper).remote()
    rt.get(a.peak_seen.remote(), timeout=T)  # the actor is up
    t0 = time.monotonic()
    rt.get([a.nap.remote() for _ in range(8)], timeout=T)
    elapsed = time.monotonic() - t0
    assert elapsed < 8 * 0.4 * 0.6, f"calls did not overlap: {elapsed:.2f}s"
    assert rt.get(a.peak_seen.remote(), timeout=30) >= 4


def test_async_actor_max_concurrency_cap():
    a = rt.remote(max_concurrency=2)(cases.Capped).remote()
    rt.get([a.work.remote() for _ in range(6)], timeout=T)
    assert rt.get(a.peak_seen.remote(), timeout=30) == 2


def test_async_actor_concurrency_groups():
    a = rt.remote(concurrency_groups={"solo": 1})(cases.Grouped).remote()
    refs = [a.one_at_a_time.remote() for _ in range(4)]
    refs += [a.free.remote() for _ in range(4)]
    rt.get(refs, timeout=T)
    solo_peak, free_peak = rt.get(a.peaks.remote(), timeout=30)
    assert solo_peak == 1, f"solo group must serialize, saw {solo_peak}"
    assert free_peak >= 2, f"default group should overlap, saw {free_peak}"


def test_threaded_actor_concurrency_groups():
    a = rt.remote(max_concurrency=4, concurrency_groups={"io": 2})(
        cases.SyncGrouped).remote()
    rt.get([a.io_call.remote() for _ in range(6)], timeout=T)
    assert rt.get(a.peak_seen.remote(), timeout=30) <= 2


def test_async_actor_unknown_group_fails_typed():
    a = rt.remote(concurrency_groups={"io": 2})(cases.BadGroup).remote()
    assert rt.get(a.ok.remote(), timeout=T) == 2
    with pytest.raises(ValueError, match="concurrency_group"):
        rt.get(a.x.remote(), timeout=T)


def test_async_actor_exception_propagates():
    a = rt.remote(cases.Boom).remote()
    with pytest.raises(RuntimeError, match="async boom"):
        rt.get(a.go.remote(), timeout=T)


def test_async_generator_streaming():
    a = rt.remote(cases.Streamer).remote()
    gen = a.gen.options(num_returns="streaming").remote(5)
    assert [rt.get(r, timeout=30) for r in gen] == [0, 10, 20, 30, 40]


def test_async_actor_ordered_starts_per_caller():
    a = rt.remote(cases.Log).remote()
    rt.get([a.mark.remote(i) for i in range(10)], timeout=T)
    assert rt.get(a.get_starts.remote(), timeout=30) == list(range(10))


def test_async_normal_task():
    assert rt.get(rt.remote(cases.coro_task).remote(41), timeout=T) == 42


def test_async_actor_exit_actor():
    a = rt.remote(cases.Quitter).remote()
    assert rt.get(a.ping.remote(), timeout=T) == "pong"
    rt.get(a.quit.remote(), timeout=T)
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(a.ping.remote(), timeout=T)


def test_async_actor_concurrency_beyond_send_window():
    """One caller overlaps more than the ordered-actor send window (16):
    async actors widen the submitter's window up to 48."""
    a = rt.remote(cases.Sleeper).remote()
    rt.get([a.nap.remote(0.6) for _ in range(30)], timeout=120)
    peak = rt.get(a.peak_seen.remote(), timeout=30)
    assert peak > 16, f"async window still capped at 16 (peak={peak})"


# ---------------------------------------------------------- cancellation
spin = rt.remote(cases.spin)


def _wait_cpus(n, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if rt.available_resources().get("CPU", 0) >= n:
            return
        time.sleep(0.1)


def test_cancel_pending_task():
    _wait_cpus(8)
    wide = spin.options(num_cpus=4)
    blockers = [wide.remote(5) for _ in range(2)]  # every CPU taken
    time.sleep(0.5)
    queued = wide.remote(5)  # waits in the signature queue
    rt.cancel(queued)
    with pytest.raises(exceptions.TaskCancelledError):
        rt.get(queued, timeout=30)
    for b in blockers:
        rt.cancel(b)


def test_cancel_running_task():
    ref = spin.remote(30)
    time.sleep(1.0)
    rt.cancel(ref)
    t0 = time.monotonic()
    with pytest.raises(exceptions.TaskCancelledError):
        rt.get(ref, timeout=30)
    assert time.monotonic() - t0 < 10, "cancel did not interrupt the task"


def test_cancel_running_task_force():
    ref = rt.remote(cases.c_blocked).remote()
    time.sleep(1.0)
    rt.cancel(ref, force=True)
    t0 = time.monotonic()
    with pytest.raises((exceptions.TaskCancelledError,
                        exceptions.RayTaskError)):
        rt.get(ref, timeout=30)
    assert time.monotonic() - t0 < 15


def test_cancel_finished_task_is_noop():
    ref = spin.remote(0.01)
    assert rt.get(ref, timeout=30) == "done"
    rt.cancel(ref)
    assert rt.get(ref, timeout=30) == "done"


def test_cancel_recursive():
    ref = rt.remote(cases.spin_parent).remote()
    time.sleep(1.5)
    rt.cancel(ref, recursive=True)
    with pytest.raises((exceptions.TaskCancelledError,
                        exceptions.RayTaskError)):
        rt.get(ref, timeout=30)


def test_cancel_async_actor_task():
    a = rt.remote(cases.AsyncSlow).remote()
    assert rt.get(a.ping.remote(), timeout=T) == "pong"
    ref = a.slow.remote()
    time.sleep(1.0)
    rt.cancel(ref)
    t0 = time.monotonic()
    with pytest.raises(exceptions.TaskCancelledError):
        rt.get(ref, timeout=30)
    assert time.monotonic() - t0 < 10
    assert rt.get(a.ping.remote(), timeout=30) == "pong"


def test_cancel_streaming_generator():
    g = rt.remote(cases.gen_slow).options(num_returns="streaming").remote()
    it = iter(g)
    assert rt.get(next(it), timeout=30) == 0
    rt.cancel(g)
    with pytest.raises((exceptions.TaskCancelledError,
                        exceptions.RayTaskError, StopIteration)):
        for _ in range(1000):
            rt.get(next(it), timeout=30)


def test_cancel_queued_actor_task_no_sequence_hole():
    s = rt.remote(cases.SlowFast).remote()
    r0 = s.slow.remote(2)
    r1 = s.slow.remote(5)  # waits for its turn behind r0
    time.sleep(0.5)
    rt.cancel(r1)
    with pytest.raises(exceptions.TaskCancelledError):
        rt.get(r1, timeout=30)
    t0 = time.monotonic()
    assert rt.get(s.fast.remote(), timeout=T) == "fast"
    assert time.monotonic() - t0 < 30, "sequence hole wedged the actor"
    assert rt.get(r0, timeout=30) == "slow"


def test_cancel_actor_task_beyond_send_window():
    s = rt.remote(cases.SlowFast).remote()
    first = s.slow.remote(2)
    quicks = [s.quick.remote(i) for i in range(20)]  # 17+ gated
    rt.cancel(quicks[18])  # beyond the 16-wide window: not pushed yet
    results = []
    for i, q in enumerate(quicks):
        if i == 18:
            with pytest.raises(exceptions.TaskCancelledError):
                rt.get(q, timeout=T)
        else:
            results.append(rt.get(q, timeout=T))
    assert results == [i for i in range(20) if i != 18]
    assert rt.get(first, timeout=30) == "slow"
