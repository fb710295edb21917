"""The port's ingest prefetcher and async step loop against the JAX
package's.

The prefetcher cases feed the same host sources to both packages'
``DevicePrefetcher`` (CPU targets: ``device="cpu"`` for the port, the
default device for JAX) and hold the port to JAX's order, values,
accounting, shutdown and exception order. The loop cases train a tiny
fp32 Llama from the same JAX params on the same batches (both packages'
``synthetic_host_batches`` draw the same tokens from one seed): the
port's ``AsyncStepLoop`` losses equal its synced loop's bit for bit, and
JAX's ``AsyncStepLoop`` losses within rtol 1e-5 (fp32, the same math in
another summation order, as the trainer parity tests hold it)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import training as jtr
from ray_tpu.parallel import MeshConfig, make_mesh
from ray_tpu.train import ingest as jingest
from ray_tpu.train.goodput import GoodputLedger as JLedger
from ray_tpu.train.loop import AsyncStepLoop as JLoop
from ray_tpu_torch.interop import params_from_numpy
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import training as ttr
from ray_tpu_torch.train import ingest as tingest
from ray_tpu_torch.train.goodput import GoodputLedger as TLedger
from ray_tpu_torch.train.loop import AsyncStepLoop as TLoop

# (package, DevicePrefetcher, its target for the host CPU)
PACKAGES = [("jax", jingest.DevicePrefetcher, None),
            ("torch", tingest.DevicePrefetcher, "cpu")]


def _threads(prefix="rtpu-prefetch-"):
    return [t for t in threading.enumerate() if t.name.startswith(prefix)]


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# --------------------------------------------------------------- prefetcher
def test_synthetic_host_batches_match_jax():
    got = list(tingest.synthetic_host_batches(4, 16, 97, steps=3, seed=5))
    want = list(jingest.synthetic_host_batches(4, 16, 97, steps=3, seed=5))
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert g[k].dtype == w[k].dtype


def test_prefetch_order_values_and_bytes_match_jax():
    src = list(jingest.synthetic_host_batches(8, 32, 128, steps=6))
    out = {}
    for name, cls, target in PACKAGES:
        pf = cls(iter(src), target, depth=2, name=f"order-{name}")
        out[name] = ([{k: _host(v) for k, v in b.items()} for b in pf],
                     pf.stats())
    for name, _, _ in PACKAGES:
        batches, stats = out[name]
        assert len(batches) == 6
        for host, dev in zip(src, batches):
            np.testing.assert_array_equal(host["tokens"], dev["tokens"])
        assert stats["batches"] == 6.0
    assert out["torch"][1]["bytes_staged"] == out["jax"][1]["bytes_staged"]
    tb = next(iter(tingest.DevicePrefetcher(iter(src[:1]), "cpu")))
    assert tb["tokens"].device.type == "cpu"
    assert isinstance(tb["tokens"], torch.Tensor)
    # The staged batch is a copy: the source's buffer may be reused.
    assert tb["tokens"].data_ptr() != src[0]["tokens"].ctypes.data


@pytest.mark.parametrize("name,cls,target", PACKAGES,
                         ids=[p[0] for p in PACKAGES])
def test_prefetch_overlaps_producer_and_consumer(name, cls, target):
    """Serial work would take ~2*n*delay; overlapped ~n*delay. JAX's own
    bound (1.6x) holds for both."""
    delay, n = 0.02, 10

    def slow_source():
        for i in range(n):
            time.sleep(delay)
            yield {"x": np.full((4,), i, np.int32)}

    t0 = time.perf_counter()
    got = 0
    pf = cls(slow_source(), target, depth=3, name=f"overlap-{name}")
    for _ in pf:
        time.sleep(delay)
        got += 1
    wall = time.perf_counter() - t0
    assert got == n
    assert wall < 1.6 * n * delay, wall
    assert pf.stats()["batches"] == n


@pytest.mark.parametrize("name,cls,target", PACKAGES,
                         ids=[p[0] for p in PACKAGES])
def test_prefetch_runs_ahead_and_shuts_down(name, cls, target):
    pf = cls(jingest.synthetic_host_batches(2, 16, 64, steps=8), target,
             depth=2, name=f"occ-{name}")
    first = next(pf)
    # The producer fills the bounded buffer meanwhile.
    deadline = time.monotonic() + 10
    while pf.stats()["buffered_now"] < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)  # and stops there: it never runs past the bound
    assert pf.stats()["buffered_now"] == 2.0  # full: double buffer ahead
    assert len(list(pf)) == 7 and first is not None
    before = len(_threads())
    # Closed mid-stream with the producer blocked on a full buffer
    # (infinite source): close() must unblock and reap it.
    pf2 = cls(jingest.synthetic_host_batches(2, 16, 64), target, depth=2,
              name=f"midstream-{name}")
    next(pf2)
    pf2.close()
    deadline = time.time() + 5
    while time.time() < deadline and len(_threads()) > before:
        time.sleep(0.01)
    assert len(_threads()) == before
    with pytest.raises(StopIteration):
        next(pf2)


def test_prefetch_exception_order_and_stall_match_jax():
    def bad_source():
        yield {"x": np.zeros((2,), np.int32)}
        yield {"x": np.ones((2,), np.int32)}
        raise ValueError("decode exploded")

    def trickle():
        for i in range(3):
            time.sleep(0.05)
            yield {"x": np.full((2,), i, np.int32)}

    for name, cls, target in PACKAGES:
        pf = cls(bad_source(), target, depth=2, name=f"err-{name}")
        assert int(_host(next(pf)["x"])[0]) == 0
        assert int(_host(next(pf)["x"])[0]) == 1
        with pytest.raises(ValueError, match="decode exploded"):
            next(pf)
        assert not [t for t in _threads() if f"err-{name}" in t.name]
        pf = cls(trickle(), target, depth=2, name=f"stall-{name}")
        list(pf)
        stats = pf.stats()
        # A starved consumer sees the wait as input stall.
        assert stats["input_stall_s"] > 0.05
        assert 0.0 < stats["input_stall_frac"] <= 1.0


def test_prefetch_target_resolution():
    trainer = ttr.ShardedTrainer(tl.LlamaConfig.tiny(dtype=torch.float32),
                                 device="cpu")
    assert tingest._resolve_device(trainer) == torch.device("cpu")
    assert tingest._resolve_device("cpu") == torch.device("cpu")


# ------------------------------------------------------------- async loop
def _llama_pair(steps, batch=4, seq=32):
    """JAX and port trainers of one tiny fp32 Llama from the same params,
    and the host batches both draw."""
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32)
    mesh = make_mesh(MeshConfig(fsdp=-1), devices=jax.devices()[:1])
    opt = dict(warmup_steps=2, total_steps=50, learning_rate=1e-2)
    jtrainer = jtr.ShardedTrainer(jc, mesh,
                                  optimizer=jtr.default_optimizer(**opt))
    ttrainer = ttr.ShardedTrainer(tc, optimizer=ttr.default_optimizer(**opt),
                                  device="cpu")
    jstate = jtrainer.init_state(0)
    params = jax.device_get(jstate.params)
    host = list(jingest.synthetic_host_batches(batch, seq, jc.vocab_size,
                                               steps=steps, seed=3))
    return jtrainer, jstate, ttrainer, params, host


def test_async_loop_losses_match_synced_loop_and_jax():
    steps = 7
    jtrainer, jstate, ttrainer, params, host = _llama_pair(steps)
    with jax.default_matmul_precision("highest"):
        jloop = JLoop(jtrainer, jstate, sync_every=4, name="jeq")
        _, jhist = jloop.run(iter(jtrainer.shard_batch(
            {k: jnp.asarray(v) for k, v in b.items()}) for b in host))
    state = ttrainer.state_from_params(params_from_numpy(params, "cpu"))
    synced = []
    for b in host:
        state, m = ttrainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in b.items()})
        synced.append(float(m["loss"]))     # per-step sync
    loop = TLoop(ttrainer, ttrainer.state_from_params(
        params_from_numpy(params, "cpu")), sync_every=4, name="teq")
    with tingest.DevicePrefetcher(iter(host), ttrainer, depth=2) as pf:
        final, hist = loop.run(pf)
    assert [h["loss"] for h in hist] == synced   # bit-identical
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               [h["grad_norm"] for h in jhist], rtol=1e-4)
    assert loop.stats()["steps"] == jloop.stats()["steps"] == steps
    assert loop.stats()["pending"] == 0
    assert final.step == steps


@pytest.mark.parametrize("sync_every", [1, 4])
def test_loop_ledger_sums_to_measured_wall(sync_every):
    """JAX's acceptance for the ledger, on both packages: drive the real
    AsyncStepLoop + DevicePrefetcher with a stuttering source; the
    components sum to the externally measured wall within 1%, with the
    injected source delay visible as input_stall and the windowed fetch
    as sync."""

    def slow_source():
        for i in range(12):
            if i and i % 4 == 0:
                time.sleep(0.05)  # stuttering producer -> consumer stall
            yield {"x": np.full((4,), i, np.float32)}

    class JStep:
        def train_step(self, state, batch):
            return state, {"loss": jnp.asarray(batch["x"]).sum()}

    class TStep:
        def train_step(self, state, batch):
            return state, {"loss": batch["x"].sum()}

    jnp.asarray(np.zeros(4, np.float32)).sum().block_until_ready()
    for name, pf_cls, target, loop_cls, led_cls, step, state in (
            ("jax", jingest.DevicePrefetcher, None, JLoop, JLedger,
             JStep(), jnp.zeros(())),
            ("torch", tingest.DevicePrefetcher, "cpu", TLoop, TLedger,
             TStep(), torch.zeros(()))):
        t0 = time.perf_counter()
        led = led_cls()
        pf = pf_cls(slow_source(), target, depth=1, ledger=led,
                    name=f"gp{sync_every}-{name}")
        loop = loop_cls(step, state, sync_every=sync_every, ledger=led)
        _, hist = loop.run(pf)
        led.close()
        wall = time.perf_counter() - t0
        pf.close()
        snap = led.snapshot()
        comps = snap["components"]
        assert [h["loss"] for h in hist] == [4.0 * i for i in range(12)]
        assert sum(comps.values()) == pytest.approx(snap["wall_s"],
                                                    abs=1e-9)
        assert snap["wall_s"] == pytest.approx(wall, rel=0.01, abs=2e-3)
        assert comps["input_stall"] > 0.03, name
        assert comps["sync"] > 0, name
        assert comps["step"] >= 0, name
