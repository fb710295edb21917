"""The trainer's ingest prefetcher on the card. Every test here is marked
``gpu`` and skips without a CUDA device. The file imports neither JAX
nor ``ray_tpu``:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py
"""

import threading

import numpy as np
import pytest
import torch

from ray_tpu_torch.train.ingest import (DevicePrefetcher,
                                        synthetic_host_batches)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefetcher's side stream "
                    "and pinned copies exist only on a card (run "
                    "`pytest -m gpu` on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_prefetcher_copies_on_a_side_stream_in_order(cuda_device):
    """Batches arrive on the card in source order with the host values,
    copied on the prefetcher's own stream (not the consumer's), and the
    consumer's stream waits for each copy: a kernel that reads a batch
    right away sees its values, also while the producer runs ahead."""
    src = list(synthetic_host_batches(8, 2048, 128256, steps=6, seed=2))
    pf = DevicePrefetcher(iter(src), cuda_device, depth=2, name="gpu")
    assert pf._stream is not None
    assert pf._stream != torch.cuda.current_stream(cuda_device)
    sums = []
    for host, dev in zip(src, pf):
        assert dev["tokens"].is_cuda and dev["mask"].is_cuda
        # Consumed on the default stream at once: the event ordered it.
        sums.append(int(dev["tokens"].to(torch.int64).sum().item()))
        np.testing.assert_array_equal(dev["tokens"].cpu().numpy(),
                                      host["tokens"])
    assert sums == [int(h["tokens"].astype(np.int64).sum()) for h in src]
    stats = pf.stats()
    assert stats["batches"] == 6.0
    assert stats["bytes_staged"] == sum(
        h["tokens"].nbytes + h["mask"].nbytes for h in src)
    assert not [t for t in threading.enumerate()
                if t.name == "rtpu-prefetch-gpu"]


@pytest.mark.gpu
def test_prefetcher_batch_memory_is_not_reused_while_in_use(cuda_device):
    """Each batch's memory is recorded on the consumer's stream: holding
    batches while later ones stage keeps every one intact."""
    src = [{"x": np.full((1 << 20,), i, np.float32)} for i in range(8)]
    pf = DevicePrefetcher(iter(src), cuda_device, depth=3, name="hold")
    held = [b["x"] for b in pf]
    torch.cuda.synchronize()
    assert [float(x[0]) for x in held] == [float(i) for i in range(8)]
    assert all(float(x.min()) == float(x.max()) for x in held)
