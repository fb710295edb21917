"""The port's profiling plane (``ray_tpu_torch/_private/cuda_monitor.py``)
against the JAX package's ``xla_monitor``: the analogs of
``tests/test_xla_monitor.py``.

The same sequences of argument shapes give the same compile and retrace
counts under both monitors (the port's compile is the first call at a
new signature); the cost registry is filled by the first call, with a
plain Llama forward's counted FLOPs equal to the analytic matmul-plus-
attention count; ``note_execution`` sets the achieved gauges; the engine's
tick and prefill, the generator's prefill and decode and the trainer's
step feed the plane, with the same compile counts as JAX's engine and
generator on the same workloads; the memory sampler returns ``[]`` on the
CPU; and a capture goes out to a replica process over its control pipe
and comes back listed.
"""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private import xla_monitor as xm
from ray_tpu_torch import serve
from ray_tpu_torch._private import cuda_monitor as cm
from ray_tpu_torch._private import metrics_defs as tdefs
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import training as ttr

_uniq = iter(range(10_000))


def _name(prefix: str) -> str:
    # Program records are process-global: every case gets fresh names.
    return f"{prefix}_{next(_uniq)}"


def _gauge(metric, program):
    return {dict(k).get("program"): v for _, k, v in metric.samples()}.get(
        program, 0.0)


# ------------------------------------------------- compiles and retraces
# (policy, allowed dims, calls): each call is a tuple of (shape, dtype)
# arguments; an int stands for a Python int argument.
SEQUENCES = {
    "static-churn": ("static", (), [[((8,), "f32")], [((9,), "f32")],
                                    [((10,), "f32")]]),
    "static-repeat-int-arg": ("static", (), [[((4,), "f32"), 0],
                                             [((4,), "f32"), 1],
                                             [((4,), "f32"), 2]]),
    "bucketed-pow2-and-cap": ("bucketed", (48,), [
        [((16,), "f32")], [((32,), "f32")], [((64,), "f32")],
        [((48,), "f32")], [((17,), "f32")], [((16,), "i32")]]),
    "bucketed-2d": ("bucketed", (24,), [
        [((2, 16), "f32")], [((4, 16), "f32")], [((4, 24), "f32")],
        [((3, 16), "f32")], [((4, 16), "f32")]]),
    "free": ("free", (), [[((3,), "f32")], [((5,), "f32")],
                          [((3,), "f32")], [((7,), "i32")]]),
    "static-dtype-change": ("static", (), [[((4,), "f32")],
                                           [((4,), "i32")]]),
}


def _args(call, lib):
    out = []
    for a in call:
        if isinstance(a, int):
            out.append(a)
            continue
        shape, dt = a
        if lib == "jax":
            out.append(jnp.ones(shape, {"f32": jnp.float32,
                                        "i32": jnp.int32}[dt]))
        else:
            out.append(torch.ones(shape, dtype={"f32": torch.float32,
                                                "i32": torch.int32}[dt]))
    return out


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_compile_and_retrace_counts_match_xla_monitor(case):
    policy, allowed, calls = SEQUENCES[case]
    jname, tname = _name("j" + case), _name("t" + case)

    def fn(x, *rest):
        return x * 2

    jf = xm.instrument(fn, name=jname, shape_policy=policy,
                       allowed_dims=allowed)
    tf = cm.instrument(fn, name=tname, shape_policy=policy,
                       allowed_dims=allowed)
    for call in calls:
        jf(*_args(call, "jax"))
        tf(*_args(call, "torch"))
        js, ts = xm.program_stats(jname), cm.program_stats(tname)
        assert (ts["compiles"], ts["retraces"]) == (js["compiles"],
                                                    js["retraces"]), call
    counter = {dict(k).get("program"): v
               for _, k, v in tdefs.XLA_RETRACES.samples()}
    assert counter.get(tname, 0.0) == xm.program_stats(jname)["retraces"]
    assert tf._cache_size() == jf._cache_size()


def test_nested_call_runs_through_unobserved():
    inner, outer = _name("inner"), _name("outer")
    f = cm.instrument(lambda x: x + 1, name=inner)
    g = cm.instrument(lambda x: f(x) * 2, name=outer)
    g(torch.ones(3))
    g(torch.ones(3))
    assert cm.program_stats(outer)["compiles"] == 1
    assert cm.program_stats(inner) is None


# ----------------------------------------------------------- the cost
def test_cost_registry_filled_on_first_call_as_xla_counts_a_matmul():
    jname, tname = _name("jdot"), _name("tdot")
    xm.instrument(lambda x: jnp.dot(x, x), name=jname)(jnp.ones((64, 64)))
    cm.instrument(lambda x: x @ x, name=tname)(torch.ones(64, 64))
    js, ts = xm.program_stats(jname), cm.program_stats(tname)
    assert ts["flops"] == js["flops"] == 2 * 64 ** 3
    assert ts["bytes_accessed"] > 0 and ts["compile_seconds"] > 0


def test_plain_llama_forward_flops_match_the_analytic_count():
    c = tl.LlamaConfig.tiny(dtype=torch.float32)
    params = tl.init_params(c, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 32
    tokens = torch.randint(0, c.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    name = _name("fwd")
    cm.instrument(lambda p, t: tl.forward(p, t, c), name=name)(params,
                                                               tokens)
    E, M, L, V = c.hidden_size, c.intermediate_size, c.num_layers, \
        c.vocab_size
    H, KV, D = c.num_heads, c.num_kv_heads, c.head_dim
    per_token = (E * H * D + 2 * E * KV * D + H * D * E + 3 * E * M) * L
    matmuls = 2 * B * S * per_token + 2 * B * S * E * V
    # The plain attention computes every (query, key) pair and masks.
    attention = 4 * B * H * S * S * D * L
    flops = cm.program_stats(name)["flops"]
    assert abs(flops - (matmuls + attention)) <= 0.05 * (matmuls + attention)


def test_counted_first_step_computes_what_an_uncounted_one_does():
    """The count runs every op as it is: a counted step's grads equal an
    uncounted step's bit for bit (FlopCounterMode's own decomposition
    of ops without a formula changed them)."""
    c = tl.LlamaConfig.tiny(dtype=torch.float32)
    params = tl.init_params(c, torch.Generator().manual_seed(0), "cpu")
    batch = ttr.synthetic_batch(4, 16, c.vocab_size, seed=3, device="cpu")

    def grads(p):
        leaves = [t.clone().requires_grad_() for t in ttr._leaves(p)]
        tree = ttr._unflatten(p, leaves)
        loss, _ = tl.loss_fn(tree, batch, c)
        return torch.autograd.grad(loss, leaves)

    plain = grads(params)
    counted, cost = cm._count_cost(grads, (params,), {})
    assert cost["flops"] > 0
    assert all(torch.equal(a, b) for a, b in zip(plain, counted))


def test_kernel_cost_reaches_the_active_count():
    """A hand kernel's analytic cost lands in the count that is active
    (the dispatch mode stack, which autograd's worker threads inherit),
    and nowhere without one."""
    cm.add_kernel_cost(1e9, 1e9)            # no count active: dropped
    assert not cm.cost_active()

    def run():
        assert cm.cost_active()
        cm.add_kernel_cost(*cm.flash_cost("fwd", 1, 4, 2, 8, 8, 16, True,
                                          4))
        return torch.ones(2) * 2

    _, cost = cm._count_cost(run, (), {})
    pairs = 4 * (8 * 9 // 2)                # causal, sq == sk == 8
    # The multiply has no formula: only the kernel's FLOPs count.
    assert cost["flops"] == 4 * 16 * pairs


def test_note_execution_sets_achieved_gauges():
    name = _name("achieved")
    w = cm.instrument(lambda x: x @ x, name=name)
    w(torch.ones(32, 32))
    out = w.note_execution(0.01)
    assert out and out["achieved_flops_per_s"] > 0
    assert out["achieved_bandwidth_bytes_per_s"] > 0
    assert _gauge(tdefs.XLA_ACHIEVED_FLOPS, name) > 0
    # No card: no utilization (the peak table names the H100 only).
    assert "model_flops_utilization" not in out
    assert set(cm.PEAK_FLOPS) == {"NVIDIA H100"}


# --------------------------------- engine, generator and trainer wiring
BURSTS = [[[1, 2, 3]] * 3, [list(range(1, 21))] * 2, [[4, 5, 6, 7]] * 4]


def _drive(eng, bursts):
    for burst in bursts:
        for prompt in burst:
            eng.submit(prompt, max_new_tokens=3)
        eng.run_to_completion()


def test_engine_tick_and_prefill_feed_the_plane():
    from ray_tpu.models import llama as jl
    from ray_tpu.models.continuous_batching import ContinuousBatcher as JCB
    from ray_tpu_torch.models.continuous_batching import \
        ContinuousBatcher as TCB

    before = {p: (cm.program_stats(p) or {}).get("compiles", 0)
              for p in ("cb_tick", "cb_prefill")}
    teng = TCB(tl.LlamaConfig.tiny(dtype=torch.float32), num_slots=4,
               max_len=64, device="cpu")
    jeng = JCB(jl.LlamaConfig.tiny(dtype=jnp.float32), num_slots=4,
               max_len=64)
    _drive(teng, BURSTS)
    _drive(jeng, BURSTS)
    for prog in ("cb_tick", "cb_prefill"):
        stats = cm.program_stats(prog)
        assert stats and stats["flops"] > 0 and stats["bytes_accessed"] > 0
    assert cm.program_stats("cb_tick")["compiles"] == before["cb_tick"] + 1
    # Measured tick and prefill wall time -> achieved gauges.
    assert _gauge(tdefs.XLA_ACHIEVED_FLOPS, "cb_tick") > 0
    assert _gauge(tdefs.XLA_ACHIEVED_BW, "cb_tick") > 0
    assert _gauge(tdefs.XLA_ACHIEVED_FLOPS, "cb_prefill") > 0
    # The same bursts compile the same prefill programs as JAX's engine,
    # and pow-2 bucket growth never reads as a retrace.
    assert teng.prefill_cache_misses() == jeng.prefill_cache_misses() == 2
    assert cm.program_stats("cb_prefill")["retraces"] == 0
    assert teng.tick_bytes_estimate() == teng.param_bytes   # idle arena


def test_request_path_programs_take_their_cost_by_formula(monkeypatch):
    """The engine's and the generator's programs are priced by
    ``llama.forward_flops`` and never run under the counter (it would put
    a Python pass over every op in front of a new bucket's first
    tokens); the trainer's step still counts."""
    from ray_tpu_torch.models.continuous_batching import \
        ContinuousBatcher as TCB
    from ray_tpu_torch.models.inference import LlamaGenerator as TGen

    def no_count(*_):
        raise AssertionError("a request-path program was counted")

    monkeypatch.setattr(cm, "_count_cost", no_count)
    c = tl.LlamaConfig.tiny(dtype=torch.float32)
    eng = TCB(c, num_slots=4, max_len=64, block_size=8, device="cpu")
    _drive(eng, BURSTS[:1])
    eng.score_logprobs([1, 2, 3], [4, 5])
    TGen(c, max_len=64, device="cpu").generate(np.ones((2, 5), np.int32),
                                               max_new_tokens=2)
    keys = eng.max_blocks * eng.block_size
    assert cm.program_stats("cb_tick")["flops"] == \
        tl.forward_flops(c, 4, 4 * keys, 4)
    # BURSTS[0]: three 3-token prompts, one [4, 16] bucket (N to a power
    # of two, L to the smallest bucket), no prefix.
    assert cm.program_stats("cb_prefill")["flops"] == \
        tl.forward_flops(c, 4 * 16, 4 * (16 * 17 // 2), 4)
    assert cm.program_stats("cb_score")["flops"] == \
        tl.forward_flops(c, 16, 16 * 17 // 2, 16)   # 5 tokens, padded
    assert cm.program_stats("llama_decode")["flops"] == \
        tl.forward_flops(c, 2, 2 * 64, 2)
    for prog in ("cb_tick", "cb_prefill", "cb_score", "llama_prefill"):
        assert cm.program_stats(prog)["bytes_accessed"] > eng.param_bytes


def test_forward_flops_is_what_the_counter_counts():
    """The formula the request path uses, against the counter on a plain
    forward (every (query, key) pair computed, the head on every row)."""
    c = tl.LlamaConfig.tiny(dtype=torch.float32)
    params = tl.init_params(c, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 32
    _, cost = cm._count_cost(lambda: tl.forward(
        params, torch.ones((B, S), dtype=torch.long), c), (), {})
    want = tl.forward_flops(c, B * S, B * S * S, B * S)
    assert abs(cost["flops"] - want) <= 0.05 * want


def test_paged_tick_bytes_estimate_prices_live_blocks_as_jax():
    from ray_tpu.models import llama as jl
    from ray_tpu.models.continuous_batching import ContinuousBatcher as JCB
    from ray_tpu_torch.interop import params_from_numpy
    from ray_tpu_torch.models.continuous_batching import \
        ContinuousBatcher as TCB

    jeng = JCB(jl.LlamaConfig.tiny(dtype=jnp.float32), num_slots=4,
               max_len=64, block_size=8)
    import jax

    params = params_from_numpy(jax.device_get(jeng.params), "cpu")
    teng = TCB(tl.LlamaConfig.tiny(dtype=torch.float32), params=params,
               num_slots=4, max_len=64, block_size=8, device="cpu")
    for eng in (jeng, teng):
        eng.submit(list(range(1, 12)), max_new_tokens=6)
        eng.submit([3, 4], max_new_tokens=6)
        for _ in range(3):
            eng.step()
    assert teng.param_bytes == jeng.param_bytes
    assert teng.tick_bytes_estimate() == jeng.tick_bytes_estimate()


def test_generator_programs_compile_as_jax():
    from ray_tpu.models import llama as jl
    from ray_tpu.models.inference import LlamaGenerator as JGen
    from ray_tpu_torch.models.inference import LlamaGenerator as TGen

    def counts():
        return {p: ((cm.program_stats(p) or {}).get("compiles", 0),
                    (cm.program_stats(p) or {}).get("retraces", 0),
                    (xm.program_stats(p) or {}).get("compiles", 0),
                    (xm.program_stats(p) or {}).get("retraces", 0))
                for p in ("llama_prefill", "llama_decode")}

    before = counts()
    tgen = TGen(tl.LlamaConfig.tiny(dtype=torch.float32), max_len=64,
                device="cpu")
    jgen = JGen(jl.LlamaConfig.tiny(dtype=jnp.float32), max_len=64)
    for p in (np.ones((1, 5), np.int32), np.ones((2, 5), np.int32),
              np.ones((1, 9), np.int32)):
        tgen.generate(p, max_new_tokens=4)
        jgen.generate(p, max_new_tokens=4)
    after = counts()
    for prog in after:
        t_c, t_r, j_c, j_r = (a - b for a, b in zip(after[prog],
                                                   before[prog]))
        assert (t_c, t_r) == (j_c, j_r), prog


def test_train_step_and_async_loop_feed_the_plane():
    from ray_tpu_torch.train.loop import AsyncStepLoop

    config = tl.LlamaConfig.tiny(dtype=torch.float32)
    before = (cm.program_stats("train_step") or {}).get("compiles", 0)
    trainer = ttr.ShardedTrainer(config, device="cpu")
    state = trainer.init_state()
    batch = ttr.synthetic_batch(8, 16, config.vocab_size, device="cpu")
    for _ in range(3):
        state, metrics = trainer.train_step(state, batch)
        float(metrics["loss"])                 # sync: honest cadence
    stats = cm.program_stats("train_step")
    assert stats and stats["flops"] > 0 and stats["bytes_accessed"] > 0
    assert stats["compiles"] == before + 1     # one signature
    assert _gauge(tdefs.XLA_ACHIEVED_FLOPS, "train_step") > 0
    assert cm.program_stats("train_init")["compiles"] >= 1
    # The async loop's windows feed the measured per-step time.
    loop = AsyncStepLoop(trainer, state, sync_every=2, name="mon")
    loop.run(iter([batch] * 4))
    assert trainer._step._external_timing
    assert _gauge(tdefs.XLA_ACHIEVED_FLOPS, "train_step") > 0


# ------------------------------------------------ device memory vitals
def test_device_memory_sampler_graceful_on_cpu():
    assert cm.sample_device_memory(node_id="testnode") == []


# ------------------------------------------------------- capture plane
@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    import torch_rl_helpers as h

    session = str(tmp_path_factory.mktemp("session"))
    old = os.environ.get("RAY_TPU_SESSION_DIR")
    os.environ["RAY_TPU_SESSION_DIR"] = session   # replicas inherit it
    serve.shutdown()
    handle = serve.run(serve.deployment(h.Profiled, name="profiled")
                       .bind())
    yield handle, session
    serve.shutdown()
    if old is None:
        os.environ.pop("RAY_TPU_SESSION_DIR", None)
    else:
        os.environ["RAY_TPU_SESSION_DIR"] = old


def _wait_capture(capture_id, n=1, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        done = [e for e in cm.list_captures()
                if e.get("capture_id") == capture_id
                and e.get("status") in ("done", "failed", "busy")]
        if len(done) >= n:
            return done
        time.sleep(0.1)
    raise AssertionError("capture never came back")


def test_capture_over_the_control_pipe_is_listed(profiled):
    handle, session = profiled
    assert handle.work.remote(16).result() > 0
    capture_id = cm.request_capture("profiled", duration_s=0.3)
    [entry] = _wait_capture(capture_id)
    assert entry["status"] == "done", entry
    assert entry["replica"].startswith("profiled-")
    assert entry["pid"] != os.getpid()          # captured in the replica
    assert entry["trace_dir"].startswith(session)
    assert os.path.isdir(entry["trace_dir"]) and entry["files"] > 0
    assert tdefs.PROFILE_CAPTURES.samples() is not None
    # The program registry reaches the serving process from the replica.
    programs = [p for p in cm.list_programs() if p["name"] == "probe_mm"]
    assert programs and programs[0]["replica"] == entry["replica"]
    assert programs[0]["compiles"] == 1 and programs[0]["flops"] > 0


def test_capture_of_an_unknown_target_registers_nothing(profiled):
    capture_id = cm.request_capture("no-such-deployment", duration_s=0.1)
    time.sleep(0.3)
    assert not [e for e in cm.list_captures()
                if e.get("capture_id") == capture_id]


def test_local_capture_and_busy_plane(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_SESSION_DIR", str(tmp_path))
    capture_id = cm.request_capture("local", duration_s=0.5)
    time.sleep(0.1)
    busy = cm.capture({"capture_id": "second", "duration_s": 0.1})
    assert busy["status"] == "busy"
    [entry] = _wait_capture(capture_id)
    assert entry["status"] == "done" and entry["files"] > 0
    assert entry["trace_dir"].startswith(str(tmp_path))


def test_session_dir_defaults_under_the_temp_dir(monkeypatch, tmp_path):
    import tempfile

    monkeypatch.delenv("RAY_TPU_SESSION_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert cm.session_dir() == str(tmp_path / "ray_tpu_state")


def test_dict_insertion_order_is_one_signature_as_jax():
    """A params dict rebuilt in another key order (a weight swap's tree)
    is the signature it was: JAX's treedef keys dicts by sorted key."""
    jname, tname = _name("jorder"), _name("torder")
    jf = xm.instrument(lambda p: p["a"] + p["b"], name=jname)
    tf = cm.instrument(lambda p: p["a"] + p["b"], name=tname)
    for order in (("a", "b"), ("b", "a")):
        jf({k: jnp.ones(3) for k in order})
        tf({k: torch.ones(3) for k in order})
    assert cm.program_stats(tname)["compiles"] == \
        xm.program_stats(jname)["compiles"] == 1
