"""Module-level cases for the cluster tests (``tests/test_torch_cluster*.py``,
``test_torch_gcs_fault_tolerance.py``, ``test_torch_scheduling_labels.py``).

The port's cluster runtime sends functions and classes by reference, so
every case a worker runs is defined here, at module level, undecorated:
a test wraps it with ``ray_tpu_torch.remote`` (and, for the parity cases,
with ``ray_tpu.remote`` for the JAX package's cluster). The module imports
the standard library and numpy only, so a worker of either package loads
it without torch or jax; a case that calls the port's API imports it
inside.
"""

import asyncio
import os
import threading
import time

import numpy as np


# ----------------------------------------------------------------- tasks
def add(a, b):
    return a + b


def make_big(n):
    return np.arange(n)


def boom():
    raise ValueError("bad input")


def where():
    """The node id of the worker running this task."""
    import ray_tpu_torch as rt

    return rt.get_runtime_context().get_node_id()


def where_jax():
    import ray_tpu

    return ray_tpu.get_runtime_context().get_node_id()


def pid():
    return os.getpid()


def sleep_return(t):
    time.sleep(t)
    return t


def nested_outer(x):
    import ray_tpu_torch as rt

    return rt.get(rt.remote(add).remote(x, 1), timeout=60) * 2


def spin(seconds):
    # A Python-level loop: a cancel's async exception lands between
    # bytecodes.
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        time.sleep(0.01)
    return "done"


def c_blocked():
    time.sleep(30)  # one C-level block: only force stops it promptly
    return "done"


def spin_parent():
    import ray_tpu_torch as rt

    child = rt.remote(spin).remote(30)
    return rt.get(child)


def gen_slow():
    for i in range(1000):
        time.sleep(0.05)
        yield i


def gen_n(n):
    for i in range(n):
        yield i * 10


async def coro_task(x):
    await asyncio.sleep(0.01)
    return x + 1


def chaos_add(x):
    return x + 1


def double(x):
    return 2 * x


def visible_cards():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


def is_odd(row):
    return row["id"] % 2 == 1


def never(row):
    return False


def forbidden_modules():
    """The JAX modules loaded in this process (a worker's must be none)."""
    import sys

    return sorted(m for m in sys.modules if m == "jax" or
                  m.startswith("jax.") or m == "ray_tpu" or
                  m.startswith("ray_tpu.") or m == "ml_dtypes")


# ---------------------------------------------------------------- actors
class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def get(self):
        return self.value

    def crash(self):
        os._exit(1)

    def node(self):
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()

    def pid(self):
        return os.getpid()


class Bad:
    def fail(self):
        raise RuntimeError("actor method failed")


class AsyncActor:
    async def work(self, x):
        await asyncio.sleep(0.01)
        return x * 2


class Sleeper:
    def __init__(self):
        self.cur = 0
        self.peak = 0

    async def nap(self, t=0.4):
        self.cur += 1
        self.peak = max(self.peak, self.cur)
        await asyncio.sleep(t)
        self.cur -= 1
        return self.peak

    async def peak_seen(self):
        return self.peak


def _group(name):
    """``@ray_tpu_torch.method(concurrency_group=name)`` without importing
    the port at module import."""
    def decorator(m):
        m.__ray_tpu_method_options__ = {"concurrency_group": name}
        return m
    return decorator


class Capped:
    def __init__(self):
        self.cur = 0
        self.peak = 0

    async def work(self):
        self.cur += 1
        self.peak = max(self.peak, self.cur)
        await asyncio.sleep(0.1)
        self.cur -= 1

    async def peak_seen(self):
        return self.peak


class Grouped:
    def __init__(self):
        self.solo_cur = self.solo_peak = 0
        self.free_cur = self.free_peak = 0

    @_group("solo")
    async def one_at_a_time(self):
        self.solo_cur += 1
        self.solo_peak = max(self.solo_peak, self.solo_cur)
        await asyncio.sleep(0.05)
        self.solo_cur -= 1

    async def free(self):
        self.free_cur += 1
        self.free_peak = max(self.free_peak, self.free_cur)
        await asyncio.sleep(0.05)
        self.free_cur -= 1

    async def peaks(self):
        return self.solo_peak, self.free_peak


class SyncGrouped:
    def __init__(self):
        self.lock = threading.Lock()
        self.cur = 0
        self.peak = 0

    @_group("io")
    def io_call(self):
        with self.lock:
            self.cur += 1
            self.peak = max(self.peak, self.cur)
        time.sleep(0.1)
        with self.lock:
            self.cur -= 1

    def peak_seen(self):
        return self.peak


class BadGroup:
    @_group("nope")
    async def x(self):
        return 1

    async def ok(self):
        return 2


class Boom:
    async def go(self):
        await asyncio.sleep(0.01)
        raise RuntimeError("async boom")


class Streamer:
    async def gen(self, n):
        for i in range(n):
            await asyncio.sleep(0.01)
            yield i * 10


class Log:
    def __init__(self):
        self.starts = []

    async def mark(self, i):
        self.starts.append(i)
        await asyncio.sleep(0.01)
        return i

    async def get_starts(self):
        return self.starts


class Quitter:
    async def ping(self):
        return "pong"

    async def quit(self):
        import ray_tpu_torch as rt

        rt.exit_actor()


class AsyncSlow:
    async def slow(self):
        await asyncio.sleep(30)
        return "done"

    async def ping(self):
        return "pong"


class SlowFast:
    def slow(self, t):
        time.sleep(t)
        return "slow"

    def fast(self):
        return "fast"

    def quick(self, i):
        return i


class Stateful:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n


# ------------------------------------------------ serve over the cluster
# Deployment classes of ``test_torch_serve_cluster.py`` (each replica, a
# cluster actor, imports its class by name).
class Echo:
    def __call__(self, x):
        return x


class Worky:
    def __call__(self, x):
        return x * 2


class WhereNode:
    def __call__(self, _):
        import ray_tpu_torch as rt

        return rt.get_runtime_context().get_node_id()


class SlowAsync:
    async def __call__(self, x):
        await asyncio.sleep(0.5)
        return x


class Doubler:
    def __call__(self, x):
        return x * 2


class Chain:
    def __init__(self, inner):
        self.inner = inner

    def __call__(self, x):
        return self.inner.remote(x).result(timeout_s=30) + 1


class CardWhere:
    """Where a replica that asked for a card runs: its process, node and
    ``CUDA_VISIBLE_DEVICES`` (it touches no card)."""

    def __call__(self, _):
        import ray_tpu_torch as rt

        return {"pid": os.getpid(),
                "node_id": rt.get_runtime_context().get_node_id(),
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES")}


def big_stream(n, size):
    """A stream of ``n`` items of ``size`` bytes each (an item over the
    inline bound goes through a segment)."""
    for i in range(n):
        yield np.full(size, i, dtype=np.uint8)


def bump(x):
    """``x`` written in place, plus one: a task that writes its
    argument."""
    x.add_(1)
    return x


def view_info(x):
    """Whether a value a task got is a view of a store segment's mapping:
    an array's ``writeable`` flag (a tensor has none: None), whether its
    first byte lies in the mapping, and its sum."""
    if hasattr(x, "data_ptr"):       # a tensor
        return {"writeable": None, "in_segment": in_segment(x),
                "sum": float(x.float().sum())}
    return {"writeable": bool(x.flags.writeable),
            "in_segment": in_segment(x),
            "sum": float(np.asarray(x, dtype=np.float64).sum())}


def in_segment(arr) -> bool:
    """Whether the first byte of ``arr`` (an array or a tensor) lies in a
    mapping of a store segment (``/dev/shm/rtst-*``) of this process
    (``/proc/self/maps``)."""
    addr = arr.data_ptr() if hasattr(arr, "data_ptr") else \
        arr.__array_interface__["data"][0]
    with open("/proc/self/maps") as f:
        for line in f:
            fields = line.split()
            if len(fields) >= 6 and "/dev/shm/rtst-" in fields[5]:
                lo, hi = (int(v, 16) for v in fields[0].split("-"))
                if lo <= addr < hi:
                    return True
    return False


class Adder:
    """The compiled-DAG stage of ``test_torch_dag_cluster.py``."""

    def __init__(self, offset):
        self.offset = offset

    def forward(self, x):
        return x + self.offset

    def ident(self, x):
        return x


# ------------------------------------- the object plane (refcounts, lineage,
# spilling, locality, transfers): the cases of tests/test_refcount_lineage.py,
# test_spilling.py, test_locality.py and test_object_transfer.py.
def produce(tag):
    # Big enough to live in the node's store (not inline).
    return np.full(300_000, 7, np.uint8)


class RefHolder:
    def __init__(self):
        self.held = None

    def hold(self, ref_list):
        self.held = ref_list  # keeps the borrow alive in this process
        return True

    def pid(self):
        return os.getpid()


def sum_nested(lst):
    import ray_tpu_torch as rt

    return int(rt.get(lst[0]).sum())


class CtorConsumer:
    def __init__(self, lst):
        import ray_tpu_torch as rt

        self.total = int(rt.get(lst[0]).sum())

    def total_(self):
        return self.total


def make_floats(i, n):
    return np.full(n, i, dtype=np.float64)


def slow_first_attempt(marker_dir):
    # The first attempt hangs until the memory monitor kills its worker.
    mk = os.path.join(marker_dir, "attempt")
    if not os.path.exists(mk):
        open(mk, "w").close()
        time.sleep(30)
    return "done"


def produce_here(n):
    import ray_tpu_torch as rt

    return (rt.get_runtime_context().get_node_id(),
            np.zeros(n, dtype=np.uint8))


def where_pair(pair):
    import ray_tpu_torch as rt

    return pair[0], rt.get_runtime_context().get_node_id()


def zero_bytes(n):
    return bytes(n)


def hold_for(seconds):
    time.sleep(seconds)
    return 1


class SlowInit:
    """An actor whose constructor takes ``seconds``."""

    def __init__(self, seconds):
        time.sleep(seconds)

    def pid(self):
        return os.getpid()
