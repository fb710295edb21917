"""Where the port sets its GEMM precision.

bf16 products reduce in fp32 in the JAX package's programs. The port
states that only where its own GEMMs run: ``llama.fp32_reduction`` turns
cuBLAS's reduced-precision bf16 reduction off around the engine's step
(prefill and tick) and the trainer's step, and gives the caller's setting
back on exit. Constructing an engine or a trainer changes nothing in the
process, so the caller's own GEMMs keep their numerics.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import continuous_batching as cb
from ray_tpu_torch.models import llama, training

CUDA = torch.device("cuda")


@pytest.fixture
def flag():
    """The process's setting, restored after the test."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    yield matmul
    matmul.allow_bf16_reduced_precision_reduction = before


@pytest.mark.parametrize("start", [True, False])
def test_scope_sets_fp32_reduction_and_restores_it(flag, start):
    flag.allow_bf16_reduced_precision_reduction = start
    with llama.fp32_reduction(CUDA, torch.bfloat16):
        assert flag.allow_bf16_reduced_precision_reduction is False
    assert flag.allow_bf16_reduced_precision_reduction is start


def test_scope_restores_the_flag_on_an_exception(flag):
    flag.allow_bf16_reduced_precision_reduction = True
    with pytest.raises(ValueError, match="inside"):
        with llama.fp32_reduction(CUDA, torch.bfloat16):
            assert flag.allow_bf16_reduced_precision_reduction is False
            raise ValueError("inside the scope")
    assert flag.allow_bf16_reduced_precision_reduction is True


@pytest.mark.parametrize("start", [True, False])
def test_overlapping_scopes_in_two_threads_keep_the_flag_off(flag, start):
    """Two threads' scopes overlap, the first to open closes first: the
    flag stays off inside the second until it closes too, and then the
    value from before the first comes back."""
    import threading

    flag.allow_bf16_reduced_precision_reduction = start
    a_in, a_out, b_in = (threading.Event() for _ in range(3))
    seen = {}

    def first():
        with llama.fp32_reduction(CUDA, torch.bfloat16):
            a_in.set()
            b_in.wait(5)
            seen["a"] = flag.allow_bf16_reduced_precision_reduction
        a_out.set()

    def second():
        a_in.wait(5)
        with llama.fp32_reduction(CUDA, torch.bfloat16):
            b_in.set()
            a_out.wait(5)
            seen["b_after_a"] = flag.allow_bf16_reduced_precision_reduction
        seen["after"] = flag.allow_bf16_reduced_precision_reduction

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert a_out.is_set() and b_in.is_set()
    assert seen == {"a": False, "b_after_a": False, "after": start}
    assert flag.allow_bf16_reduced_precision_reduction is start


@pytest.mark.parametrize("device, dtype", [
    (torch.device("cpu"), torch.bfloat16), (CUDA, torch.float32)])
def test_scope_leaves_other_devices_and_dtypes_alone(flag, device, dtype):
    flag.allow_bf16_reduced_precision_reduction = True
    with llama.fp32_reduction(device, dtype):
        assert flag.allow_bf16_reduced_precision_reduction is True
    assert flag.allow_bf16_reduced_precision_reduction is True


@pytest.mark.parametrize("start", [True, False])
def test_constructors_leave_the_flag_as_they_found_it(flag, start):
    # The trainer stores its device and allocates nothing, so a bf16
    # trainer "on" CUDA constructs here too; the engine allocates its
    # caches, so it runs on the CPU and takes a step.
    cfg = llama.LlamaConfig.tiny(dtype=torch.bfloat16)
    flag.allow_bf16_reduced_precision_reduction = start
    training.ShardedTrainer(cfg, device="cuda")
    assert flag.allow_bf16_reduced_precision_reduction is start
    for paged in (True, False):
        eng = cb.ContinuousBatcher(cfg, num_slots=2, max_len=64,
                                   paged=paged, device="cpu")
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run_to_completion()
        assert flag.allow_bf16_reduced_precision_reduction is start


def _recording_scope(monkeypatch):
    """Swap ``llama.fp32_reduction`` for one that records its arguments
    and whether the scope is open."""
    import contextlib

    seen, inside = [], [False]

    @contextlib.contextmanager
    def scope(device, dtype):
        seen.append((device, dtype))
        inside[0] = True
        try:
            yield
        finally:
            inside[0] = False
    monkeypatch.setattr(llama, "fp32_reduction", scope)
    return seen, inside


def test_engine_prefill_and_tick_run_under_the_scope(monkeypatch):
    seen, inside = _recording_scope(monkeypatch)
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    eng = cb.ContinuousBatcher(cfg, num_slots=2, max_len=64, device="cpu")
    calls = []
    for name in ("_prefill", "_run_tick"):
        real = getattr(eng, name)

        def wrapped(*a, _real=real, _name=name):
            calls.append((_name, inside[0]))
            return _real(*a)
        monkeypatch.setattr(eng, name, wrapped)
    eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run_to_completion()
    assert {n for n, _ in calls} == {"_prefill", "_run_tick"}
    assert all(opened for _, opened in calls)
    assert set(seen) == {(torch.device("cpu"), torch.float32)}


def test_train_step_runs_under_the_scope(monkeypatch):
    seen, inside = _recording_scope(monkeypatch)
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    trainer = training.ShardedTrainer(cfg, device="cpu")
    grads = []
    real = trainer.grads
    monkeypatch.setattr(trainer, "grads", lambda *a: grads.append(
        inside[0]) or real(*a))
    state = trainer.init_state(0)
    batch = training.synthetic_batch(2, 16, cfg.vocab_size, seed=0,
                                     device="cpu")
    _, metrics = trainer.train_step(state, batch)
    assert grads == [True]
    assert seen == [(torch.device("cpu"), torch.float32)]
    assert np.isfinite(float(metrics["loss"]))
