"""The port's native shared-memory object store on the CPU
(``ray_tpu_torch/_private/shm.py`` over its own copy of
``shm_store.cpp``), held to ``tests/test_shm_store.py``: JAX's seven
cases against the port's store, a call after the store closed answering
as an empty store, one sequence of operations on JAX's store and the
port's giving the same answers, a failed build raising with the
compiler's message, and first builds in parallel leaving one library."""

import os
import signal
import threading

import numpy as np
import pytest

from ray_tpu._private import shm as jshm
from ray_tpu_torch._private import native_build
from ray_tpu_torch._private.shm import SEGMENT_PREFIX, ShmClient, ShmStore

LIMIT_S = 60


@pytest.fixture(autouse=True)
def _bounded():
    def expire(*_):
        raise TimeoutError(f"test ran past its {LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def store():
    s = ShmStore(capacity_bytes=20_000_000)
    yield s
    s.close()


# ------------------------------------------------------ JAX's seven cases
def test_put_get_roundtrip(store):
    payload = b"hello" * 1000
    name = store.put("obj1", payload)
    assert name and name.startswith("/" + SEGMENT_PREFIX)
    meta = store.get("obj1")
    assert meta == (name, len(payload))
    assert store.read("obj1") == payload


def test_immutability_reput_noop(store):
    store.put("obj1", b"first")
    store.put("obj1", b"second")  # immutable objects: re-put ignored
    assert store.read("obj1") == b"first"


def test_client_zero_copy_put(store):
    seg = f"/{store.prefix}.client1"
    data = np.arange(100_000, dtype=np.int64).tobytes()
    assert ShmClient.create_segment(seg, data)
    assert store.register("obj2", seg, len(data))
    assert store.read("obj2") == data


def test_client_map_zero_copy_view(store):
    data = np.arange(10_000, dtype=np.float32)
    store.put("arr", data.tobytes())
    name, size = store.get("arr")
    view = ShmClient.map_segment_view(name, size)
    arr = np.frombuffer(view, dtype=np.float32)
    np.testing.assert_array_equal(arr, data)
    # The port's addition: the view is read-only, so an array over it is
    # too, as in JAX.
    assert view.readonly and not arr.flags.writeable


def test_lru_eviction(store):
    for i in range(30):
        store.put(f"e{i:02d}", os.urandom(1_000_000))
    used, count = store.stats()
    assert used <= 20_000_000
    assert count < 30
    # The most recent objects survive.
    assert store.contains("e29")
    assert not store.contains("e00")


def test_delete(store):
    store.put("gone", b"x" * 100)
    assert store.delete("gone")
    assert store.get("gone") is None
    assert not store.delete("gone")


def test_reader_survives_eviction(store):
    """POSIX unlink keeps live mappings valid: plasma's safety property."""
    data = b"y" * 1_000_000
    store.put("victim", data)
    name, size = store.get("victim")
    view = ShmClient.map_segment_view(name, size)
    store.delete("victim")
    assert bytes(view[:10]) == b"y" * 10  # mapping still readable


def test_calls_after_close_answer_as_an_empty_store():
    """A node's request still in flight when its store closes finds an
    empty store, not a freed handle; a second close is a no-op."""
    s = ShmStore(capacity_bytes=1_000_000)
    name = s.put("a", b"x" * 10)
    s.close()
    s.close()
    assert not os.path.exists(f"/dev/shm{name}")
    assert s.get("a") is None and not s.contains("a")
    assert s.put("b", b"y") is None and not s.register("c", "/nope", 1)
    assert s.stats() == (0, 0) and s.coldest() is None
    assert not s.delete("a")


# ------------------------------------------------------------- parity
def _script(store_cls, client_cls):
    """One sequence of put, re-put, register, get, coldest, delete and
    stats; the answers with the store's own prefix taken out."""
    s = store_cls(capacity_bytes=3_000_000)
    try:
        out = []

        def rel(name):
            return None if name is None else name.replace(s.prefix, "P")

        out.append(rel(s.put("a", b"a" * 1_000_000)))
        out.append(rel(s.put("a", b"z" * 10)))
        out.append(rel(s.put("b", b"b" * 500_000)))
        seg = f"/{s.prefix}.client"
        data = np.arange(50_000, dtype=np.int32).tobytes()
        out.append(client_cls.create_segment(seg, data))
        out.append(s.register("c", seg, len(data)))
        out.append((rel(s.get("a")[0]), s.get("a")[1]))
        out.append(s.coldest())
        out.append(rel(s.put("d", b"d" * 1_400_000)))   # evicts the coldest
        out.append([s.contains(k) for k in "abcd"])
        out.append(s.stats())
        out.append(s.read("c") == data)
        out.append(s.delete("a"))
        out.append(s.delete("a"))
        out.append(s.stats())
        out.append(s.coldest())
        return out
    finally:
        s.close()


def test_same_sequence_same_answers_as_jax():
    port = _script(ShmStore, ShmClient)
    jax = _script(jshm.ShmStore, jshm.ShmClient)
    assert port == jax
    assert port[7] and port[8] == [True, False, True, True]


# ------------------------------------------------------------ the build
def test_failed_build_raises_with_the_compilers_message(tmp_path):
    src = tmp_path / "broken_store.cpp"
    src.write_text('extern "C" int broken( { return undeclared_name; }\n')
    with pytest.raises(RuntimeError, match="undeclared_name") as info:
        native_build.build(str(src), str(tmp_path / "build"))
    assert "broken_store.cpp" in str(info.value)
    # Nothing half-built is left where a later load would find it.
    assert not [n for n in os.listdir(tmp_path / "build")
                if n.endswith(".so")]


def test_parallel_first_builds_leave_one_library(tmp_path):
    src = os.path.join(native_build.SRC_DIR, "shm_store.cpp")
    out = str(tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(native_build.build(src, out))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert len(set(paths)) == 1
    assert os.listdir(out) == [os.path.basename(paths[0])]
    assert paths[0] == native_build.lib_path(src, out)
