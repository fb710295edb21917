"""The data plane feeding the trainer on the card. Every test here is
marked ``gpu`` and skips without a CUDA device. The file imports neither
JAX nor ``ray_tpu``:

    python -m pytest --noconftest -m gpu tests/test_torch_data_gpu.py
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
import torch_train_loops as loops
from ray_tpu_torch import data, train


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the worker trains on a card and "
                    "its device batches land there (run `pytest -m gpu` "
                    "on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_dataset_fed_trainer_on_card_matches_in_process(cuda_device,
                                                        tmp_path):
    """[data-train] at 2 layers and a small width: TorchTrainer with
    datasets= on one card, the shard's device batches land on cuda, the
    flash kernels run (2 L / L / L a step), and the losses equal the
    same batches through the same steps in this process."""
    batch, seq, steps = 2, 256, 4
    cfg = loops.GPU_DATA_CONFIG
    rows = np.random.default_rng(5).integers(
        0, cfg["vocab_size"], (steps * batch, seq), dtype=np.int32)
    torch.backends.cuda.matmul.allow_tf32 = False
    want = []
    loops.gpu_data_steps(loops.gpu_data_trainer(), (
        {"tokens": torch.from_numpy(rows[i:i + batch]).cuda(),
         "mask": torch.ones(batch, seq, dtype=torch.int32, device="cuda")}
        for i in range(0, len(rows), batch)), want.append)
    rt.init(num_cpus=4)
    try:
        ds = data.from_numpy(rows, parallelism=2).map_batches(
            lambda b: {"tokens": b["data"],
                       "mask": np.ones_like(b["data"])})
        ctl = train.TorchTrainer(
            loops.gpu_data_loop, train_loop_config={"batch": batch},
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(storage_path=str(tmp_path)),
            datasets={"train": ds})
        result = ctl.fit()
    finally:
        rt.shutdown()
    assert result.error is None, result.error
    got = [h["metrics"] for h in result.metrics_history]
    assert [g["device"] for g in got] == ["cuda"] * steps
    layers = cfg["num_layers"]
    assert all(g["launches"] == {"fwd": 2 * layers, "dq": layers,
                                 "dkv": layers} for g in got)
    assert [g["loss"] for g in got] == [w["loss"] for w in want]
    assert all(np.isfinite(g["loss"]) for g in got)
    assert ctl.dataset_bytes == [rows.nbytes * 2]
