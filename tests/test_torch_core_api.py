"""The port's core API (``ray_tpu_torch.init/remote/get/put/wait``, actors,
object refs) on its in-process runtime, held to ``tests/test_core_api.py``.

Each of that file's 32 cases runs here on the port with the same
assertions; a case that computes a value runs on the JAX package too and
the two values are compared. Both runtimes live side by side for the
module (``num_cpus=4``, no accelerator), so no case needs a card. Tasks
that JAX's cases sleep 5 s in wait on an event instead, which the next
case's start releases, so a module-scoped runtime starts each case idle.
Every ``get`` has a timeout.
"""

import logging
import os
import pickle
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu_torch import exceptions

T = 30          # seconds any get may wait
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Set between cases: a task that would sleep 5 s returns at once.
release = threading.Event()


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


@pytest.fixture(autouse=True)
def idle_runtime():
    """Start each case with the port's runtime idle: the previous case's
    held-back tasks released and every CPU back."""
    release.set()
    deadline = time.monotonic() + 10
    while rt.is_initialized() and time.monotonic() < deadline and (
            rt.available_resources().get("CPU") != 4.0):
        time.sleep(0.01)
    release.clear()
    yield


def on_both(case):
    """``case(pkg)`` on the port, then on the JAX package: both values."""
    return case(rt), case(ray_tpu)


def test_put_get():
    def case(ray):
        ref = ray.put(42)
        assert ray.get(ref, timeout=T) == 42
        refs = [ray.put(i) for i in range(10)]
        return ray.get(refs, timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == list(range(10))


def test_put_objectref_rejected():
    ref = rt.put(1)
    with pytest.raises(TypeError):
        rt.put(ref)


def test_remote_function():
    def case(ray):
        @ray.remote
        def f(x):
            return x + 1

        assert ray.get(f.remote(1), timeout=T) == 2
        return ray.get([f.remote(i) for i in range(20)], timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == list(range(1, 21))


def test_remote_with_options():
    @rt.remote(num_cpus=2)
    def f():
        return "ok"

    assert rt.get(f.remote(), timeout=T) == "ok"
    assert rt.get(f.options(num_cpus=1).remote(), timeout=T) == "ok"


def test_num_returns():
    def case(ray):
        @ray.remote(num_returns=3)
        def f():
            return 1, 2, 3

        a, b, c = f.remote()
        return ray.get([a, b, c], timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == [1, 2, 3]


def test_task_dependency():
    def case(ray):
        @ray.remote
        def add(a, b):
            return a + b

        x = add.remote(1, 2)
        y = add.remote(x, 3)
        z = add.remote(x, y)
        return ray.get(z, timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == 9


def test_chain_many():
    def case(ray):
        @ray.remote
        def inc(x):
            return x + 1

        ref = ray.put(0)
        for _ in range(50):
            ref = inc.remote(ref)
        return ray.get(ref, timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == 50


def test_error_propagation():
    @rt.remote
    def fail():
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        rt.get(fail.remote(), timeout=T)

    @rt.remote
    def dependent(x):
        return x

    # Error flows through dependencies without executing the dependent task.
    with pytest.raises(ValueError, match="boom"):
        rt.get(dependent.remote(fail.remote()), timeout=T)


def test_retry_exceptions():
    def case(ray):
        counter = {"n": 0}

        @ray.remote(max_retries=3, retry_exceptions=True)
        def flaky():
            counter["n"] += 1
            if counter["n"] < 3:
                raise RuntimeError("transient")
            return counter["n"]

        return ray.get(flaky.remote(), timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == 3


def test_wait():
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        release.wait(5)
        return "slow"

    a, b = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([a, b], num_returns=1, timeout=3)
    assert ready == [a]
    assert not_ready == [b]


def test_wait_timeout_none_ready():
    @rt.remote
    def slow():
        release.wait(5)

    ready, not_ready = rt.wait([slow.remote()], timeout=0.05)
    assert ready == []
    assert len(not_ready) == 1


def test_nested_tasks():
    def case(ray):
        @ray.remote
        def inner(x):
            return x * 2

        @ray.remote
        def outer(x):
            return ray.get(inner.remote(x), timeout=T) + 1

        return ray.get(outer.remote(10), timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == 21


def test_actor_basic():
    def case(ray):
        @ray.remote
        class Counter:
            def __init__(self, start=0):
                self.n = start

            def incr(self, by=1):
                self.n += by
                return self.n

            def value(self):
                return self.n

        c = Counter.remote(10)
        got = [ray.get(c.incr.remote(), timeout=T),
               ray.get(c.incr.remote(5), timeout=T),
               ray.get(c.value.remote(), timeout=T)]
        ray.kill(c)
        return got

    port, jax_ = on_both(case)
    assert port == jax_ == [11, 16, 16]


def test_actor_ordering():
    def case(ray):
        @ray.remote
        class Appender:
            def __init__(self):
                self.items = []

            def add(self, x):
                self.items.append(x)

            def get(self):
                return self.items

        a = Appender.remote()
        for i in range(100):
            a.add.remote(i)
        return ray.get(a.get.remote(), timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == list(range(100))


def test_actor_error():
    @rt.remote
    class A:
        def fail(self):
            raise KeyError("nope")

        def ok(self):
            return 1

    a = A.remote()
    with pytest.raises(KeyError):
        rt.get(a.fail.remote(), timeout=T)
    # Actor survives method errors.
    assert rt.get(a.ok.remote(), timeout=T) == 1


def test_actor_init_failure():
    @rt.remote
    class Bad:
        def __init__(self):
            raise RuntimeError("init fail")

        def m(self):
            return 1

    b = Bad.remote()
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(b.m.remote(), timeout=10)


def test_kill_actor():
    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    assert rt.get(a.ping.remote(), timeout=T) == "pong"
    rt.kill(a)
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(a.ping.remote(), timeout=10)


def test_named_actor():
    @rt.remote
    class Registry:
        def whoami(self):
            return "registry"

    Registry.options(name="reg").remote()
    h = rt.get_actor("reg")
    assert rt.get(h.whoami.remote(), timeout=T) == "registry"
    with pytest.raises(ValueError):
        rt.get_actor("missing")


def test_get_if_exists():
    @rt.remote
    class Singleton:
        def pid(self):
            return id(self)

    a = Singleton.options(name="s", get_if_exists=True).remote()
    b = Singleton.options(name="s", get_if_exists=True).remote()
    assert rt.get(a.pid.remote(), timeout=T) == rt.get(b.pid.remote(),
                                                       timeout=T)


def test_async_actor():
    import asyncio

    def case(ray):
        @ray.remote
        class AsyncActor:
            async def work(self, x):
                await asyncio.sleep(0.01)
                return x * 2

        a = AsyncActor.remote()
        refs = [a.work.remote(i) for i in range(10)]
        return ray.get(refs, timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == [i * 2 for i in range(10)]


def test_actor_method_num_returns():
    def case(ray):
        @ray.remote
        class A:
            @ray.method(num_returns=2)
            def two(self):
                return 1, 2

        a = A.remote()
        x, y = a.two.remote()
        return ray.get([x, y], timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == [1, 2]


def test_get_timeout():
    @rt.remote
    def slow():
        release.wait(5)

    with pytest.raises(exceptions.GetTimeoutError):
        rt.get(slow.remote(), timeout=0.05)


def test_runtime_context():
    ctx = rt.get_runtime_context()
    assert ctx.get_job_id()
    assert ctx.get_node_id()
    assert ctx.get_task_id() is None

    @rt.remote
    def f():
        return rt.get_runtime_context().get_task_id()

    assert rt.get(f.remote(), timeout=T) is not None


def test_cluster_resources():
    res = rt.cluster_resources()
    assert res["CPU"] == 4.0
    assert len(rt.nodes()) == 1
    assert res == ray_tpu.cluster_resources() == {"CPU": 4.0}


def test_object_ref_in_container():
    """Nested refs (inside a list) are NOT auto-resolved — parity with ray."""

    def case(ray):
        @ray.remote
        def f(refs):
            return ray.get(refs[0], timeout=T)

        inner = ray.put(7)
        return ray.get(f.remote([inner]), timeout=T)

    port, jax_ = on_both(case)
    assert port == jax_ == 7


def test_exit_actor():
    @rt.remote
    class A:
        def stop(self):
            rt.exit_actor()

        def ping(self):
            return "pong"

    a = A.remote()
    rt.get(a.stop.remote(), timeout=T)
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(a.ping.remote(), timeout=10)


def test_resource_admission():
    """num_cpus admission limits true parallelism (4-CPU runtime)."""
    running = []
    peak = [0]
    lock = threading.Lock()

    @rt.remote(num_cpus=2)
    def heavy(i):
        with lock:
            running.append(i)
            peak[0] = max(peak[0], len(running))
        time.sleep(0.15)
        with lock:
            running.remove(i)
        return i

    refs = [heavy.remote(i) for i in range(6)]
    assert sorted(rt.get(refs, timeout=T)) == list(range(6))
    assert peak[0] <= 2  # 4 CPUs / 2 per task


def test_blocked_get_releases_cpu():
    """Nested task trees must not deadlock: blocked parents release CPU."""

    @rt.remote(num_cpus=4)
    def parent():
        @rt.remote(num_cpus=4)
        def child():
            return "child-done"

        return rt.get(child.remote(), timeout=T)

    assert rt.get(parent.remote(), timeout=10) == "child-done"


def test_available_resources_reflect_load():
    @rt.remote(num_cpus=3)
    def hold():
        time.sleep(0.5)

    ref = hold.remote()
    time.sleep(0.15)
    avail = rt.available_resources()
    assert avail["CPU"] == 1.0
    rt.get(ref, timeout=T)
    time.sleep(0.15)
    assert rt.available_resources()["CPU"] == 4.0


def test_inherited_async_actor():
    import asyncio

    class Base:
        async def work(self, x):
            await asyncio.sleep(0.01)
            return x + 1

    @rt.remote
    class Child(Base):
        pass

    c = Child.remote()
    assert rt.get(c.work.remote(1), timeout=T) == 2


def test_named_actor_init_failure_unregisters():
    @rt.remote
    class Bad:
        def __init__(self):
            raise RuntimeError("nope")

        def m(self):
            return 1

    b = Bad.options(name="bad").remote()
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(b.m.remote(), timeout=10)
    # The name must be released so a replacement can be created.
    time.sleep(0.1)
    with pytest.raises(ValueError):
        rt.get_actor("bad")


def test_cancel_pending_task():
    @rt.remote(num_cpus=4)
    def blocker():
        time.sleep(1.0)

    @rt.remote(num_cpus=4)
    def victim():
        return "ran"

    b = blocker.remote()
    time.sleep(0.1)
    v = victim.remote()  # queued behind blocker
    rt.cancel(v)
    with pytest.raises(exceptions.TaskCancelledError):
        rt.get(v, timeout=10)
    rt.get(b, timeout=T)


# ------------------------------------------------------- the port's own

def test_exports_match_jax():
    assert set(rt.__all__) == set(ray_tpu.__all__)
    for name in rt.__all__:
        assert hasattr(rt, name), name


def test_package_import_loads_no_torch():
    """The fork server and every replica process import the package, so
    its top level stays free of torch (and of JAX)."""
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.dag, "
            "ray_tpu_torch.util\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu', 'numpy'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_exceptions_align_with_jax():
    import ray_tpu.exceptions as jexc

    names = [n for n, v in vars(jexc).items()
             if isinstance(v, type) and issubclass(v, BaseException)
             and v.__module__ == jexc.__name__
             and n != "JaxDistributedBootstrapError"]
    for n in names:
        assert hasattr(exceptions, n), n
    assert exceptions.RayActorError is exceptions.ActorDiedError
    assert issubclass(exceptions.ActorDiedError, exceptions.RayTaskError)
    assert issubclass(exceptions.GetTimeoutError, TimeoutError)
    err = exceptions.ActorDiedError("aid", error_msg="gone")
    assert (err.actor_id, err.error_msg, str(err)) == ("aid", "gone", "gone")
    back = pickle.loads(pickle.dumps(err))
    assert type(back) is exceptions.ActorDiedError
    assert (back.actor_id, back.error_msg) == ("aid", "gone")
    jerr = jexc.ActorDiedError("aid", error_msg="gone")
    assert (jerr.actor_id, str(jerr)) == (err.actor_id, str(err))


def test_closure_capturing_an_object_ref_resolves():
    """Functions cross to the task thread as they are (no FnRef pickle),
    so a ref captured in a closure keeps its object alive and resolves."""
    def make():
        captured = rt.put({"k": 41})

        @rt.remote
        def f():
            return rt.get(captured, timeout=T)["k"] + 1

        return f

    f = make()
    import gc

    gc.collect()
    assert rt.get(f.remote(), timeout=T) == 42
    assert rt.get(f.options(num_cpus=1).remote(), timeout=T) == 42


def test_system_config_alone_sets_task_max_retries(monkeypatch):
    """``task_max_retries`` has JAX's default and takes only
    ``init(_system_config=...)``: no environment variable reaches it. A
    key the port does not read is refused."""
    from ray_tpu._private.config import RayTpuConfig as JaxConfig
    from ray_tpu_torch._private.config import RayTpuConfig

    monkeypatch.setenv("RAY_TPU_task_max_retries", "7")
    monkeypatch.setenv("RAY_task_max_retries", "7")
    conf = RayTpuConfig()
    conf.initialize(None)
    assert conf.task_max_retries == JaxConfig()._defaults.task_max_retries
    conf.initialize('{"task_max_retries": 0}')
    assert conf.task_max_retries == 0
    conf.initialize({"task_max_retries": "2"})
    assert conf.task_max_retries == 2
    with pytest.raises(ValueError, match="Unknown _system_config"):
        conf.initialize({"object_spilling_threshold": 0.8})


def test_num_tpus_is_refused_naming_num_gpus():
    with pytest.raises(ValueError, match="num_gpus"):
        @rt.remote(num_tpus=1)
        def f():
            return 1

    @rt.remote
    def g():
        return 1

    with pytest.raises(ValueError, match="num_gpus"):
        g.options(num_tpus=1)
    with pytest.raises(ValueError, match="num_gpus"):
        g.options(resources={"GPU": 1}).remote()
    rt.shutdown()
    try:
        with pytest.raises(ValueError, match="num_gpus"):
            rt.init(num_tpus=1)
        assert not rt.is_initialized()
    finally:
        rt.init(num_cpus=4, num_gpus=0)


@pytest.mark.parametrize("address", ["127.0.0.1:6379", "auto",
                                     "ray://127.0.0.1:10001"])
def test_init_with_an_address_raises_not_ported(address, monkeypatch):
    rt.shutdown()
    try:
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md queue A, item 20 "
                                 r"\(the cluster runtime\)"):
            rt.init(address=address)
        monkeypatch.setenv("RAY_TPU_ADDRESS", address)
        with pytest.raises(NotImplementedError, match="cluster runtime"):
            rt.init()
        assert not rt.is_initialized()
    finally:
        monkeypatch.delenv("RAY_TPU_ADDRESS", raising=False)
        rt.init(num_cpus=4, num_gpus=0)


def test_num_gpus_charges_cards_and_infeasible_waits(caplog, monkeypatch):
    from ray_tpu_torch._private.accelerators.cuda import detect_num_cards
    from ray_tpu_torch._private.options import RemoteOptions

    @rt.remote(num_gpus=1)
    def on_card():
        return "ran"

    with caplog.at_level(logging.WARNING):
        ref = on_card.remote()
        ready, _ = rt.wait([ref], timeout=0.3)
    assert ready == []
    assert any("exceeds total cluster resources" in r.getMessage()
               for r in caplog.records)
    rt.cancel(ref)
    assert "GPU" not in rt.cluster_resources()
    assert RemoteOptions(num_gpus=0.5).task_resources() == {
        "CPU": 1.0, "GPU": 0.5}
    monkeypatch.setenv("RAY_TPU_NUM_GPUS", "2")
    assert detect_num_cards() == 2
    monkeypatch.delenv("RAY_TPU_NUM_GPUS")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert detect_num_cards() == 0


def test_streaming_generators_match_jax():
    def case(ray):
        @ray.remote(num_returns="streaming")
        def gen(n):
            for i in range(n):
                yield i * i

        @ray.remote
        class Source:
            def items(self, n):
                for i in range(n):
                    yield -i

        task = [ray.get(r, timeout=T) for r in gen.remote(5)]
        s = Source.remote()
        method = [ray.get(r, timeout=T) for r in
                  s.items.options(num_returns="streaming").remote(4)]
        return task, method

    port, jax_ = on_both(case)
    assert port == jax_ == ([0, 1, 4, 9, 16], [0, -1, -2, -3])


def test_threaded_actor_and_concurrency_groups():
    barrier = threading.Barrier(3, timeout=10)

    @rt.remote(max_concurrency=3, concurrency_groups={"io": 1})
    class Pool:
        def meet(self):
            barrier.wait()          # three calls run at once
            return threading.current_thread().name

        @rt.method(concurrency_group="io")
        def io(self):
            return threading.current_thread().name

    p = Pool.remote()
    names = rt.get([p.meet.remote() for _ in range(3)], timeout=T)
    assert len(set(names)) == 3
    assert "-io" in rt.get(p.io.remote(), timeout=T)


def test_simulated_process_death_kills_the_actor():
    from ray_tpu_torch._private import chaos

    @rt.remote
    class Mortal:
        def die(self):
            raise chaos.SimulatedProcessDeath("chaos: worker killed")

        def ping(self):
            return "pong"

    m = Mortal.remote()
    assert rt.get(m.ping.remote(), timeout=T) == "pong"
    with pytest.raises(exceptions.ActorDiedError, match="worker killed"):
        rt.get(m.die.remote(), timeout=T)
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(m.ping.remote(), timeout=T)


def test_named_actor_listing_and_namespaces():
    @rt.remote
    class Named:
        def ping(self):
            return 1

    a = Named.options(name="listed").remote()
    b = Named.options(name="other", namespace="ns2").remote()
    assert "listed" in rt.list_named_actors()
    assert {"name": "other", "namespace": "ns2"} in rt.list_named_actors(
        all_namespaces=True)
    assert rt.get(rt.get_actor("other", namespace="ns2").ping.remote(),
                  timeout=T) == 1
    with pytest.raises(ValueError, match="already exists"):
        Named.options(name="listed").remote()
    rt.kill(a)
    rt.kill(b)


def test_each_package_keeps_its_own_runtime():
    """A ref of one package is not a ref of the other's API, and each
    package's runtime starts and stops on its own."""
    jref = ray_tpu.put(1)
    with pytest.raises(TypeError):
        rt.get(jref, timeout=T)
    pref = rt.put(2)
    with pytest.raises(TypeError):
        ray_tpu.get(pref, timeout=T)
    assert rt.get(pref, timeout=T) == 2 and ray_tpu.get(jref, timeout=T) == 1


def test_shutdown_leaves_no_runtime_thread():
    import asyncio

    rt.shutdown()
    before = set(threading.enumerate())
    rt.init(num_cpus=4, num_gpus=0)
    core = rt._private.worker.global_worker().core

    @rt.remote
    def f(x):
        return x

    @rt.remote(max_concurrency=4)
    class Threaded:
        def ping(self):
            return 1

    @rt.remote
    class Async:
        async def ping(self):
            await asyncio.sleep(0)
            return 2

    @rt.remote(num_returns="streaming")
    def gen():
        yield 1
        yield 2

    assert rt.get([f.remote(i) for i in range(8)], timeout=T) == list(
        range(8))
    assert rt.get([Threaded.remote().ping.remote(),
                   Async.remote().ping.remote()], timeout=T) == [1, 2]
    stream = gen.remote()
    next(stream)
    del stream                       # abandoned: a reaper thread starts
    assert core.runtime_threads()
    rt.shutdown()
    assert core.runtime_threads() == []
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive()]
    assert left == [], left
    assert ray_tpu.is_initialized()          # the JAX runtime is untouched
    rt.init(num_cpus=4, num_gpus=0)



@pytest.mark.parametrize("max_concurrency", [1, 4])
def test_killed_actors_instance_is_freed(max_concurrency):
    """A killed actor's instance is dropped once its last call returns,
    so what it holds (an engine's device memory) is freed; the handle
    then raises ``ActorDiedError``."""
    import gc
    import weakref

    made = []

    @rt.remote(max_concurrency=max_concurrency)
    class Holder:
        def __init__(self):
            self.payload = bytearray(1 << 20)
            made.append(weakref.ref(self))

        def ping(self):
            return len(self.payload)

    h = Holder.remote()
    assert rt.get(h.ping.remote(), timeout=T) == 1 << 20
    rt.kill(h)
    deadline = time.monotonic() + 10
    while made[0]() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.01)
    assert made[0]() is None
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(h.ping.remote(), timeout=T)
