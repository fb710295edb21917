"""The port's DAGs and compiled DAGs (:mod:`ray_tpu_torch.dag` over
:func:`ray_tpu_torch.experimental.channel.run_dag_loop`), held to
``tests/test_dag.py``.

Each of that file's 11 cases runs on the port with the same assertions;
where a case computes a value, the JAX package's DAG computes it too and
the two are compared. Added: no ``/dev/shm/rtch-*`` segment of a DAG
outlives its teardown (after a stage error and with results never read
too), and a channel the port's DAG loop writes reads back in the JAX
package's ``Channel`` (the layout is shared). Both runtimes live for the
module (``num_cpus=4``, no accelerator); every ``get`` has a timeout.
"""

import os
import threading

import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode, MultiOutputNode

T = 30


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


def _plus(a, b):
    return a + b


def _times(a, b):
    return a * b


class _Stage:
    def __init__(self, offset):
        self.offset = offset

    def forward(self, x):
        return x + self.offset


plus, times, Stage = (rt.remote(_plus), rt.remote(_times),
                      rt.remote(_Stage))


def on_jax(build, *inputs):
    """The JAX package's DAG of the same shape: ``build(plus, times,
    Stage, InputNode, MultiOutputNode)`` executed on each input."""
    from ray_tpu import dag as jdag

    dag = build(ray_tpu.remote(_plus), ray_tpu.remote(_times),
                ray_tpu.remote(_Stage), jdag.InputNode, jdag.MultiOutputNode)
    outs = []
    for i in inputs:
        ref = dag.execute(i)
        outs.append([ray_tpu.get(r, timeout=T) for r in ref]
                    if isinstance(ref, list) else ray_tpu.get(ref, timeout=T))
    return outs


def segments():
    return {n for n in os.listdir("/dev/shm") if n.startswith("rtch-")}


def channel_names(compiled):
    return {c.name.lstrip("/") for c in compiled._channels}


def test_task_dag():
    with InputNode() as x:
        dag = times.bind(plus.bind(x, 1), 10)
    assert rt.get(dag.execute(4), timeout=T) == 50
    assert rt.get(dag.execute(0), timeout=T) == 10
    assert on_jax(lambda p, t, S, I, M: t.bind(p.bind(I(), 1), 10),
                  4, 0) == [50, 10]


def test_actor_pipeline_dag():
    with InputNode() as x:
        s1 = Stage.bind(100)
        s2 = Stage.bind(1000)
        dag = s2.forward.bind(s1.forward.bind(x))
    assert rt.get(dag.execute(5), timeout=T) == 1105

    def build(p, t, S, I, M):
        return S.bind(1000).forward.bind(S.bind(100).forward.bind(I()))

    assert on_jax(build, 5) == [1105]


def test_multi_output():
    with InputNode() as x:
        dag = MultiOutputNode([plus.bind(x, 1), times.bind(x, 2)])
    out = [rt.get(r, timeout=T) for r in dag.execute(10)]
    assert out == [11, 20]

    def build(p, t, S, I, M):
        x = I()
        return M([p.bind(x, 1), t.bind(x, 2)])

    assert on_jax(build, 10) == [out]


def test_compiled_dag_reuses_actors():
    with InputNode() as x:
        stage = Stage.bind(7)
        dag = stage.forward.bind(x)
    compiled = dag.experimental_compile()
    try:
        for i in range(3):
            assert rt.get(compiled.execute(i), timeout=T) == i + 7
        # the same actor served all executions
        assert compiled._root._target._handle is not None
    finally:
        compiled.teardown()


def test_bound_actor_handle_method():
    actor = Stage.remote(3)
    with InputNode() as x:
        dag = actor.forward.bind(x)
    assert rt.get(dag.execute(1), timeout=T) == 4


# ------------------------------------------------------- compiled channels

def test_compiled_dag_uses_channels():
    with InputNode() as x:
        dag = Stage.bind(1).forward.bind(x)
    compiled = dag.experimental_compile()
    try:
        assert compiled._channel_mode
        refs = [compiled.execute(i) for i in range(3)]
        assert [r.get(timeout=30) for r in refs] == [1, 2, 3]
    finally:
        compiled.teardown()


def test_compiled_dag_multi_stage_pipeline():
    with InputNode() as x:
        dag = Stage.bind(1000).forward.bind(Stage.bind(100).forward.bind(x))
    compiled = dag.experimental_compile()
    try:
        out = [rt.get(compiled.execute(i), timeout=30) for i in range(5)]
        assert out == [1100 + i for i in range(5)]
    finally:
        compiled.teardown()


def test_compiled_dag_multi_output_fanout():
    with InputNode() as x:
        s1 = Stage.bind(1).forward.bind(x)   # both consume the same input
        s2 = Stage.bind(2).forward.bind(x)
        dag = MultiOutputNode([s1, s2])
    compiled = dag.experimental_compile()
    try:
        assert compiled._channel_mode
        assert compiled.execute(10).get(timeout=30) == [11, 12]
        assert compiled.execute(20).get(timeout=30) == [21, 22]
    finally:
        compiled.teardown()


def test_compiled_dag_stage_error_propagates():
    @rt.remote
    class Boom:
        def forward(self, x):
            if x == 2:
                raise ValueError("x was two")
            return x

    with InputNode() as x:
        dag = Stage.bind(0).forward.bind(Boom.bind().forward.bind(x))
    compiled = dag.experimental_compile()
    try:
        assert rt.get(compiled.execute(1), timeout=30) == 1
        with pytest.raises(ValueError, match="x was two"):
            rt.get(compiled.execute(2), timeout=30)
        # The pipeline survives an error tick.
        assert rt.get(compiled.execute(3), timeout=30) == 3
    finally:
        compiled.teardown()


def test_compiled_dag_teardown_then_execute_raises():
    with InputNode() as x:
        dag = Stage.bind(5).forward.bind(x)
    compiled = dag.experimental_compile()
    assert rt.get(compiled.execute(1), timeout=30) == 6
    compiled.teardown()
    with pytest.raises(RuntimeError, match="torn down"):
        compiled.execute(2)


def test_task_dag_falls_back_to_interpreted():
    with InputNode() as x:
        dag = times.bind(plus.bind(x, 1), 10)
    compiled = dag.experimental_compile()
    assert not compiled._channel_mode
    assert rt.get(compiled.execute(4), timeout=T) == 50


# ------------------------------------------------------- the port's own

@pytest.mark.parametrize("ending", ["read", "stage-error", "unread"])
def test_teardown_unlinks_every_segment(ending):
    @rt.remote
    class Boom:
        def forward(self, x):
            if x < 0:
                raise ValueError("negative")
            return x

    with InputNode() as x:
        s = Stage.bind(1).forward.bind(Boom.bind().forward.bind(x))
        dag = MultiOutputNode([s, Stage.bind(2).forward.bind(x)])
    compiled = dag.experimental_compile()
    names = channel_names(compiled)
    assert len(names) == 4 and names <= segments()
    if ending == "read":
        assert compiled.execute(1).get(timeout=T) == [2, 3]
    elif ending == "stage-error":
        with pytest.raises(ValueError, match="negative"):
            compiled.execute(-5).get(timeout=T)
    else:
        compiled.execute(1)
        compiled.execute(2)          # results never read
    compiled.teardown()
    assert not names & segments()


def test_dag_loop_output_reads_in_jax_channel():
    """The port's DAG loop writes a channel that the JAX package's
    ``Channel`` attaches to and reads, stage errors included."""
    from ray_tpu.experimental import channel as jch
    from ray_tpu_torch.experimental.channel import (Channel, _StageError,
                                                    run_dag_loop)

    inp = Channel(capacity=1 << 16, n_readers=1)
    out = Channel(capacity=1 << 16, n_readers=1)
    jr = jch.Channel(capacity=out.capacity, n_readers=1, name=out.name,
                     _create=False, _reader_idx=0)

    class Doubler:
        def forward(self, x):
            if x is None:
                raise KeyError("none")
            return {"x2": [2 * x]}

    ticks = []
    t = threading.Thread(target=lambda: ticks.append(run_dag_loop(
        Doubler(), [("forward", [inp.reader(0)], {}, out)])))
    t.start()
    try:
        inp.write(21)
        assert jr.read(timeout=T) == {"x2": [42]}
        inp.write(None)
        err = jr.read(timeout=T)
        assert isinstance(err, _StageError) and isinstance(err.exc, KeyError)
        inp.close()
        t.join(T)
        assert ticks == [2]
        with pytest.raises(jch.ChannelClosed):
            jr.read(timeout=T)
    finally:
        inp.close()
        t.join(T)
        inp.destroy()
        out.destroy()


def test_compiled_dag_matches_remote_calls():
    """A compiled two-stage chain computes what the same actors compute
    through ``.remote`` and ``get``, execution after execution. The DAG
    loop holds one thread of each actor, so their ``.remote`` calls need
    a second (``max_concurrency=2``)."""
    a = Stage.options(max_concurrency=2).remote(10)
    b = Stage.options(max_concurrency=2).remote(100)
    with InputNode() as x:
        dag = b.forward.bind(a.forward.bind(x))
    compiled = dag.experimental_compile()
    try:
        assert compiled._channel_mode
        for i in range(20):
            want = rt.get(b.forward.remote(a.forward.remote(i)), timeout=T)
            assert rt.get(compiled.execute(i), timeout=T) == want == i + 110
    finally:
        compiled.teardown()
    # Bound handles (not ClassNodes) outlive the teardown.
    assert rt.get(a.forward.remote(0), timeout=T) == 10


def test_a_blocked_reader_and_writer_are_woken_not_polled(monkeypatch):
    """A DAG hop waits in ``futex_wait`` on the channel's wake word: with
    the sleep slice stretched to 5 s, a blocked reader still returns as
    soon as the write lands, and a writer waiting for an ack as soon as
    the reader acks (each wake must reach the sleeper)."""
    import time

    from ray_tpu_torch.experimental import channel as chan

    monkeypatch.setattr(chan, "_WAIT_SLICE_S", 5.0)
    c = chan.Channel(capacity=4096, n_readers=1)
    r = c.reader(0)
    got = []
    try:
        t = threading.Thread(target=lambda: got.append(r.read(timeout=T)))
        t.start()
        time.sleep(0.2)                  # the reader is asleep by now
        t0 = time.monotonic()
        c.write("hop")
        t.join(T)
        assert got == ["hop"] and time.monotonic() - t0 < 2.5
        c.write(1)                       # unread: the next write waits
        t = threading.Thread(target=lambda: c.write(2, timeout=T))
        t.start()
        time.sleep(0.2)
        t0 = time.monotonic()
        assert r.read(timeout=T) == 1
        t.join(T)
        assert not t.is_alive() and time.monotonic() - t0 < 2.5
        assert r.read(timeout=T) == 2
    finally:
        c.close()
        c.destroy()
