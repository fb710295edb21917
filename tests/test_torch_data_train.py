"""Port parity: ``TorchTrainer(datasets=)`` and ``get_dataset_shard`` on
forked CPU workers against ``JaxTrainer``, the two cases of
``tests/test_train_ingest.py:237-290``.

The port's controller executes each rank's ``streaming_split`` shard and
ships its blocks with the run call; each rank's ids must equal the rows
JAX's ``streaming_split`` gives that rank (``iter_device_batches`` drops
a ragged tail in both). The loops live in ``torch_train_loops.py`` (a
worker imports its loop by name and must not import JAX).
"""

import json
import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_train_loops as loops
from ray_tpu import data as jdata
from ray_tpu import train as jt
from ray_tpu_torch import data as tdata
from ray_tpu_torch import train as tt


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    rt.init(num_cpus=8, num_gpus=0)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


def _cpu(n):
    return tt.ScalingConfig(num_workers=n, use_gpu=False)


def _jax_rank_ids(ds, n):
    return [[int(x) for b in it.iter_batches(batch_size=8, drop_last=True)
             for x in b["id"]] for it in ds.streaming_split(n)]


def test_streaming_split_shards_are_disjoint_across_workers(tmp_path):
    out_dir = str(tmp_path)
    trainer = tt.TorchTrainer(
        loops.dataset_shard_loop, train_loop_config={"out": out_dir},
        scaling_config=_cpu(2),
        run_config=tt.RunConfig(storage_path=str(tmp_path / "runs")),
        datasets={"train": tdata.range(64)})
    result = trainer.fit()
    assert result.error is None
    shards = []
    for rank in range(2):
        with open(os.path.join(out_dir, f"ids_{rank}.json")) as f:
            shards.append(json.load(f))
    assert shards[0] and shards[1]
    assert not (set(shards[0]) & set(shards[1])), "worker shards overlap"
    assert set(shards[0]) | set(shards[1]) == set(range(64))
    # Rank by rank, the rows JAX's streaming_split gives that rank.
    assert shards == _jax_rank_ids(jdata.range(64), 2)
    # 32 int64 ids a rank crossed with the run call.
    assert trainer.dataset_bytes == [32 * 8, 32 * 8]


def test_get_dataset_shard_unknown_name_raises(tmp_path):
    trainer = tt.TorchTrainer(
        loops.unknown_shard_loop, train_loop_config={},
        scaling_config=_cpu(1),
        run_config=tt.RunConfig(storage_path=str(tmp_path)),
        datasets={"train": tdata.range(8)})
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["ok"] == 1

    # JAX's session raises the same KeyError from its loop.
    def loop(config):
        with pytest.raises(KeyError, match="no dataset shard"):
            jt.get_dataset_shard("eval")
        jt.report({"ok": 1})

    jres = jt.JaxTrainer(loop, train_loop_config={},
                         scaling_config=jt.ScalingConfig(num_workers=1),
                         datasets={"train": jdata.range(8)}).fit()
    assert jres.error is None and jres.metrics["ok"] == 1


def test_each_attempt_splits_again_and_shards_cross_whole():
    """A restarted attempt splits the datasets again at its world size;
    a shard holds its blocks, so it pickles whole and reads back with no
    runtime in the process that unpickles it."""
    import pickle

    ds = tdata.range(30).map(lambda r: {"id": r["id"] * 2})
    trainer = tt.TorchTrainer(loops.report_loop, scaling_config=_cpu(3),
                              datasets={"train": ds, "eval": tdata.range(6)})
    first = trainer._dataset_shards(3)
    again = trainer._dataset_shards(2)
    assert len(first) == 3 and len(again) == 2
    for shards, n in ((first, 3), (again, 2)):
        got = [[r["id"] for r in s["train"].iter_rows()] for s in shards]
        want = [[r["id"] for r in it.iter_rows()]
                for it in jdata.range(30).map(
                    lambda r: {"id": r["id"] * 2}).streaming_split(n)]
        assert got == want
        assert [s["train"]._name for s in shards] == ["train"] * n
    blob = pickle.dumps(first[1])
    rt.shutdown()
    try:
        back = pickle.loads(blob)
        rows = [b["id"].tolist() for b in back["train"].iter_batches(
            batch_size=4)]
        assert not rt.is_initialized()
        assert rows == [[20, 22, 24, 26], [28, 30, 32, 34], [36, 38]]
        assert np.array_equal(back["eval"].iter_batches(
            batch_size=8).__next__()["id"], [2, 3])
    finally:
        rt.init(num_cpus=8, num_gpus=0)
