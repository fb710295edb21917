"""The port's shared-memory channel
(:mod:`ray_tpu_torch.experimental.channel`) on the CPU: write, read,
close and timeouts, reader acks, an attach-spec pickled into a spawned
process, and the byte layout both ways with the JAX package's
``Channel`` (its native library where it builds, and its mmap path).

Spawned processes import this module by name, so it imports neither
torch nor JAX at the top: the JAX package is imported inside its tests.
"""

import multiprocessing as mp
import os
import pickle

import numpy as np
import pytest

from ray_tpu_torch.experimental.channel import (Channel, ChannelClosed,
                                                ChannelTimeout)


@pytest.fixture
def channels():
    made = []

    def make(*args, **kw):
        ch = Channel(*args, **kw)
        made.append(ch)
        return ch

    yield make
    for ch in made:
        ch.destroy()


def test_write_read_close_and_timeouts(channels):
    ch = channels(capacity=1 << 16, n_readers=1)
    assert ch.name.startswith("/rtch-")
    assert os.path.exists(f"/dev/shm{ch.name}")
    r = ch.reader(0)
    with pytest.raises(ChannelTimeout):
        r.read(timeout=0.05)                       # nothing written yet
    ch.write({"a": [1, 2, 3]})
    assert r.read(timeout=1) == {"a": [1, 2, 3]}
    with pytest.raises(ChannelTimeout):
        r.read(timeout=0.05)                       # consumed: no new value
    ch.write(1)
    with pytest.raises(ChannelTimeout):
        ch.write(2, timeout=0.05)                  # the reader has not acked
    assert r.read(timeout=1) == 1
    ch.write(2, timeout=1)
    ch.close()
    assert r.read(timeout=1) == 2                  # the pending value first
    with pytest.raises(ChannelClosed):
        r.read(timeout=1)
    with pytest.raises(ChannelClosed):
        r.read(timeout=1)
    with pytest.raises(ValueError, match="capacity"):
        ch.write(np.zeros(1 << 17, np.uint8))
    with pytest.raises(ValueError, match="readers"):
        Channel(n_readers=17)
    r.destroy()
    assert not os.path.exists(f"/dev/shm{ch.name}")
    ch.destroy()                                   # already gone: a no-op


def test_reader_acks_and_lagging_readers(channels):
    ch = channels(capacity=4096, n_readers=3)
    readers = [ch.reader(i) for i in range(3)]
    assert ch.reader_acks() == (0, [0, 0, 0])
    ch.write("x")
    assert ch.lagging_readers() == [0, 1, 2]
    assert readers[1].read(timeout=1) == "x"
    ver, acks = ch.reader_acks()
    assert ver == 2 and acks == [0, 2, 0]
    assert ch.lagging_readers() == [0, 2]
    for r in (readers[0], readers[2]):
        assert r.read(timeout=1) == "x"
    assert ch.lagging_readers() == []
    ch.write("y", timeout=1)                       # every reader acked


def test_attach_waits_for_its_creator():
    """A reader that finds the segment before its creator has sized it
    and written its magic waits for both instead of failing."""
    import struct
    import threading

    name = f"/rtch-early-{os.getpid()}"
    path = f"/dev/shm{name}"
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    box = {}
    t = threading.Thread(target=lambda: box.update(ch=Channel(
        n_readers=1, name=name, _create=False, _reader_idx=0)))
    try:
        t.start()
        os.ftruncate(fd, 192 + 4096)
        t.join(timeout=0.05)
        assert t.is_alive()                    # sized, but no magic yet
        with open(path, "r+b") as f:
            f.write(struct.pack("<IIQQQ", 0x52544348, 1, 4096, 0, 0))
        t.join(timeout=10)
        assert not t.is_alive()
        assert (box["ch"].capacity, box["ch"].n_readers) == (4096, 1)
    finally:
        os.close(fd)
        os.unlink(path)


def _child_reads(spec, answer):
    """In a spawned process: read from the attach-spec, answer on a
    channel of its own (the segment outlives the process until the
    reader unlinks it)."""
    reader = pickle.loads(spec)
    value = reader.read(timeout=30)
    out = Channel(capacity=1 << 20, n_readers=1, name=answer)
    out.write({"sum": int(value.sum()), "n": int(value.size),
               "dtype": str(value.dtype)})


def test_attach_spec_crosses_into_a_spawned_process(channels):
    """A channel inside a pickled value attaches in the process that
    unpickles it (as a handoff manifest does across the replica pipe);
    the bytes arrive as the numpy buffer that was written."""
    ch = channels(capacity=1 << 20, n_readers=1)
    answer = f"/rtch-answer-{os.getpid()}"
    proc = mp.get_context("spawn").Process(
        target=_child_reads, args=(pickle.dumps(ch.reader(0)), answer))
    proc.start()
    try:
        staging = np.arange(1 << 18, dtype=np.uint8)
        ch.write(staging)
        got = Channel(n_readers=1, name=answer, _create=False,
                      _reader_idx=0)
        try:
            assert got.read(timeout=60) == {
                "sum": int(staging.sum()), "n": staging.size,
                "dtype": "uint8"}
        finally:
            got.destroy()
        proc.join(timeout=60)
        assert proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.kill()


@pytest.fixture(params=["jax-default", "jax-mmap"])
def jax_channel(request, monkeypatch):
    """The JAX package's Channel: its own choice of backend (the g++
    library where it builds), or its mmap path."""
    from ray_tpu.experimental import channel as jch

    if request.param == "jax-mmap":
        monkeypatch.setattr(jch, "_lib", None)
        monkeypatch.setattr(jch, "_lib_tried", True)
    return jch


def test_port_writes_and_jax_reads(channels, jax_channel):
    ch = channels(capacity=1 << 20, n_readers=2)
    jr = jax_channel.Channel(capacity=ch.capacity, n_readers=2,
                             name=ch.name, _create=False, _reader_idx=1)
    staging = np.random.default_rng(0).integers(
        0, 255, size=70_000, dtype=np.uint8)
    for value in ({"manifest": [1, 2]}, staging):
        ch.write(value, timeout=5)
        # The segment holds pickle's protocol-5 bytes of the value.
        assert bytes(ch._mm[192:192 + ch._size()]) == \
            pickle.dumps(value, protocol=5)
        got = jr.read(timeout=5)
        if isinstance(value, np.ndarray):
            assert got.dtype == np.uint8 and np.array_equal(got, value)
        else:
            assert got == value
        assert ch.lagging_readers() == [0]         # JAX's reader acked
        ch.reader(0).read(timeout=5)
    ch.close()
    with pytest.raises(jax_channel.ChannelClosed):
        jr.read(timeout=5)


def test_jax_writes_and_port_reads(jax_channel):
    jw = jax_channel.Channel(capacity=1 << 20, n_readers=1)
    try:
        r = Channel(n_readers=1, name=jw.name, _create=False, _reader_idx=0)
        assert r.capacity == 1 << 20 and r.n_readers == 1
        staging = np.arange(50_000, dtype=np.uint8)
        jw.write(staging, timeout=5)
        assert np.array_equal(r.read(timeout=5), staging)
        jw.write("second", timeout=5)              # the port's reader acked
        assert r.read(timeout=5) == "second"
        assert jw.reader_acks() == r.reader_acks()
        jw.close()
        with pytest.raises(ChannelClosed):
            r.read(timeout=5)
    finally:
        jw.destroy()
