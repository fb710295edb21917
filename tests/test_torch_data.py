"""Port parity: ``ray_tpu_torch.data`` (numpy blocks) against
``ray_tpu.data`` (pyarrow blocks), every local case of
``tests/test_data.py``.

Both runtimes live side by side for the module (``num_cpus=8``, no
accelerator). Each case runs on the port with JAX's assertions, and
where it computes rows the same inputs go through the JAX package and
the rows are compared: in order wherever JAX's order is deterministic
(``random_shuffle(seed)`` draws the same numpy streams, sorts are stable,
repartition keeps row order), as sets where it is not (Arrow's hash
group_by and hash join), and float aggregates within a relative 1e-12
(Arrow's sums and numpy's pairwise ones may part in the last bits).
The case that needs a cluster asserts the port's ``not_ported`` and
runs its checks in process.
"""

import os
import threading
import time

import numpy as np
import pandas as pd
import pytest

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import data as jdata
from ray_tpu_torch import data as tdata

AGG_RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    from ray_tpu.data import dataset as jds
    from ray_tpu_torch.data import dataset as tds

    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    jds.reset_stats_cache()
    ray_tpu.init(num_cpus=8, num_tpus=0)
    rt.init(num_cpus=8, num_gpus=0)
    yield
    rt.shutdown()
    tds.reset_stats_cache()
    time.sleep(0.2)  # let JAX's fire-and-forget stats tasks land
    ray_tpu.shutdown()
    jds.reset_stats_cache()


def both(case):
    """``case(data_module)`` on the port, then on the JAX package."""
    return case(tdata), case(jdata)


def same_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)
        for k in ra:
            if isinstance(rb[k], np.ndarray):
                np.testing.assert_array_equal(ra[k], rb[k])
            else:
                assert ra[k] == rb[k] and type(ra[k]) is type(rb[k]), \
                    (k, ra[k], rb[k])


def test_range_count_take():
    def case(d):
        ds = d.range(100, parallelism=4)
        return ds.count(), ds.take(3), ds.num_blocks()

    port, jax_ = both(case)
    assert port == jax_ == (100, [{"id": 0}, {"id": 1}, {"id": 2}], 4)


def test_map_filter_flatmap_pipeline():
    def case(d):
        return (d.range(50)
                .map(lambda r: {"id": r["id"], "sq": r["id"] ** 2})
                .filter(lambda r: r["sq"] % 2 == 0)
                .flat_map(lambda r: [r, r])).take_all()

    port, jax_ = both(case)
    assert len(port) == 50
    assert all(r["sq"] == r["id"] ** 2 for r in port)
    same_rows(port, jax_)


def test_map_batches_numpy():
    def case(d):
        return d.range(64).map_batches(
            lambda b: {"id": b["id"], "double": b["id"] * 2}).take_all()

    port, jax_ = both(case)
    assert port[10]["double"] == 20
    same_rows(port, jax_)


def test_limit():
    port, jax_ = both(lambda d: d.range(1000).limit(17).take_all())
    assert len(port) == 17
    same_rows(port, jax_)


def test_repartition_and_split():
    def case(d):
        ds = d.range(90, parallelism=3).repartition(5)
        parts = d.range(10).split(2)
        return (ds.num_blocks(), ds.count(), ds.take_all(),
                [p.take_all() for p in parts])

    port, jax_ = both(case)
    assert port[:2] == (5, 90)
    assert sum(len(p) for p in port[3]) == 10
    same_rows(port[2], jax_[2])
    assert port[3] == jax_[3]


def test_random_shuffle_preserves_rows():
    def case(d):
        ds = d.range(100).random_shuffle(seed=7)
        return ds.take_all(), ds.take(5)

    port, jax_ = both(case)
    assert sorted(r["id"] for r in port[0]) == list(range(100))
    assert [r["id"] for r in port[1]] != [0, 1, 2, 3, 4]
    # The same seeded numpy draws in both stages: the same order.
    assert port == jax_


def test_sort():
    def case(d):
        return d.from_items([{"v": x} for x in [5, 3, 9, 1]]).sort(
            "v").take_all()

    port, jax_ = both(case)
    assert [r["v"] for r in port] == [1, 3, 5, 9]
    assert port == jax_


def test_groupby_agg():
    items = [{"k": i % 3, "v": i} for i in range(30)]

    def case(d):
        return d.from_items(items).groupby("k").sum("v").sort(
            "k").take_all()

    port, jax_ = both(case)
    assert port[0]["v_sum"] == sum(i for i in range(30) if i % 3 == 0)
    same_rows(port, jax_)


def test_iter_batches_shapes():
    def case(d):
        return list(d.range(100, parallelism=3).iter_batches(batch_size=32))

    port, jax_ = both(case)
    sizes = [len(b["id"]) for b in port]
    assert sum(sizes) == 100
    assert sizes[:3] == [32, 32, 32]
    assert len(port) == len(jax_)
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a["id"], b["id"])
        assert a["id"].dtype == b["id"].dtype


def test_streaming_split_for_train():
    def case(d):
        its = d.range(64).streaming_split(4)
        return [[int(x) for b in it.iter_batches(batch_size=8)
                 for x in b["id"]] for it in its]

    port, jax_ = both(case)
    assert sum(len(c) for c in port) == 64
    assert all(len(c) == 16 for c in port)
    assert port == jax_


def test_pandas_roundtrip():
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    port, jax_ = both(lambda d: d.from_pandas(df).to_pandas())
    pd.testing.assert_frame_equal(port, df)
    pd.testing.assert_frame_equal(port, jax_)


def test_read_write_parquet(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    for i in range(3):
        pq.write_table(pa.table({"x": np.arange(10) + i * 10}),
                       tmp_path / f"part{i}.parquet")

    def case(d):
        ds = d.read_parquet(str(tmp_path / "*.parquet"))
        return ds.count(), ds.take_all()

    port, jax_ = both(case)
    assert port[0] == 30
    assert sorted(r["x"] for r in port[1]) == list(range(30))
    same_rows(port[1], jax_[1])


# ---------------------------------------------------- actor pools + stats
class AddBias:
    def __init__(self, bias):
        self.bias = bias

    def __call__(self, batch):
        batch["id"] = batch["id"] + self.bias
        return batch


def test_map_batches_actor_pool_stateful():
    """A class UDF is constructed once per pool actor and reused across
    batches (reference: ActorPoolMapOperator)."""
    def case(d):
        return d.range(64, parallelism=8).map_batches(
            AddBias, compute=d.ActorPoolStrategy(size=2),
            fn_constructor_args=(1000,)).take_all()

    port, jax_ = both(case)
    assert sorted(r["id"] for r in port) == list(range(1000, 1064))
    same_rows(port, jax_)


def test_map_batches_num_gpus_pins_each_actor_to_its_card(monkeypatch):
    """``num_gpus`` reserves cards for a pool: actor i is built and
    called with card ``floor(i * num_gpus)`` current, and a pool that
    needs more cards than the process sees raises. A recording
    ``torch.cuda.device`` stands in for the card here."""
    import contextlib

    import torch

    from ray_tpu_torch.data import dataset as tdataset

    current = threading.local()

    @contextlib.contextmanager
    def device(i):
        before = getattr(current, "card", None)
        current.card = i
        try:
            yield
        finally:
            current.card = before

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "device", device)
    built, called = [], []

    class OnCard:
        def __init__(self):
            self.card = current.card
            built.append(self.card)

        def __call__(self, batch):
            called.append((current.card, self.card))
            batch["card"] = np.full(len(batch["id"]), current.card)
            return batch

    rows = tdata.range(16, parallelism=4).map_batches(
        OnCard, concurrency=2, num_gpus=1).take_all()
    assert sorted(built) == [0, 1]
    assert len(called) == 4 and all(a == b for a, b in called)
    assert sorted(r["id"] for r in rows) == list(range(16))
    assert {int(r["card"]) for r in rows} == {0, 1}
    assert tdataset._pool_cards(4, 0.5) == [0, 0, 1, 1]
    assert tdataset._pool_cards(2, None) == [None, None]
    with pytest.raises(ValueError, match="need 3 CUDA cards; this "
                                         "process sees 2"):
        tdata.range(4).map_batches(OnCard, concurrency=3,
                                   num_gpus=1).take_all()


def test_map_batches_concurrency_shorthand():
    def double(batch):
        batch["id"] = batch["id"] * 2
        return batch

    def case(d):
        return d.range(20, parallelism=4).map_batches(
            double, concurrency=2).take_all()

    port, jax_ = both(case)
    assert sorted(r["id"] for r in port) == [i * 2 for i in range(20)]
    same_rows(port, jax_)


def test_a_udf_cannot_write_into_the_stored_block():
    """A batch's columns are read-only, as Arrow's zero-copy numpy views
    are in JAX: an in-place write fails instead of changing the block
    other consumers read."""
    def inplace(batch):
        batch["id"] *= 2
        return batch

    for d in (tdata, jdata):
        ds = d.range(8, parallelism=2)
        with pytest.raises(Exception, match="read-only"):
            ds.map_batches(inplace).take_all()
        assert [r["id"] for r in ds.take_all()] == list(range(8))


def test_dataset_stats_recorded():
    def case(d):
        ds = d.range(32, parallelism=4).map(
            lambda r: {"id": r["id"] + 1}).filter(
            lambda r: r["id"] % 2 == 0)
        rows = ds.take_all()
        deadline = time.monotonic() + 10
        stats = ds.stats()
        while "filter" not in stats and time.monotonic() < deadline:
            time.sleep(0.2)  # stats reports are fire-and-forget
            stats = ds.stats()
        return rows, stats

    (prows, pstats), (jrows, jstats) = both(case)
    assert "map" in pstats and "filter" in pstats, pstats
    assert "rows in" in pstats
    same_rows(prows, jrows)
    for op in ("map", "filter"):
        line = [s for s in pstats.splitlines() if s.startswith(op + ":")]
        want = [s for s in jstats.splitlines() if s.startswith(op + ":")]
        # Blocks and rows agree; the wall time is each run's own.
        assert line[0].split(",")[:2] == want[0].split(",")[:2]


def test_read_binary_files_and_text(tmp_path):
    (tmp_path / "a.bin").write_bytes(b"\x00\x01\x02")
    (tmp_path / "b.bin").write_bytes(b"hello")
    (tmp_path / "t.txt").write_text("line1\nline2\n")

    def case(d):
        rows = sorted(d.read_binary_files(str(tmp_path / "*.bin")).take_all(),
                      key=lambda r: r["path"])
        return rows, d.read_text(str(tmp_path / "t.txt")).take_all()

    port, jax_ = both(case)
    rows, txt = port
    assert rows[0]["bytes"] == b"\x00\x01\x02"
    assert rows[1]["bytes"] == b"hello"
    assert rows[0]["path"].endswith("a.bin")
    assert [r["text"] for r in txt] == ["line1", "line2"]
    assert port == jax_


def test_read_directory_expansion(tmp_path):
    sub = tmp_path / "nested"
    sub.mkdir()
    (sub / "x.txt").write_text("deep\n")
    (tmp_path / "top.txt").write_text("top\n")
    port, jax_ = both(lambda d: d.read_text(str(tmp_path)).take_all())
    assert sorted(r["text"] for r in port) == ["deep", "top"]
    assert port == jax_


def test_memory_backpressure_env_drains_window(monkeypatch):
    """With a zero budget every block drains immediately — the pipeline
    still completes and produces correct results. The port weighs the
    ready output blocks its execution holds (``dataset._held_bytes``,
    ``block.nbytes`` each)."""
    from ray_tpu_torch.data import dataset as tdataset

    monkeypatch.setenv("RAY_TPU_DATA_MEMORY_BUDGET_BYTES", "0")
    probes = []
    real = tdataset._held_bytes
    monkeypatch.setattr(tdataset, "_held_bytes",
                        lambda refs, sizes: probes.append(
                            real(refs, sizes)) or probes[-1])

    def case(d):
        ds = d.range(100, parallelism=8).map(lambda r: {"v": r["id"] * 2})
        return sorted(r["v"] for r in ds.take_all())

    port, jax_ = both(case)
    assert port == jax_ == [i * 2 for i in range(100)]
    assert probes, "the window never weighed its blocks"
    held = tdata.range(100, parallelism=2)  # 800 bytes of int64 ids
    sizes = {}
    assert real(held._block_refs, sizes) == 800
    assert sorted(sizes.values()) == [400, 400]


def test_shuffle_is_distributed_no_driver_concat(monkeypatch):
    """JAX runs this case on a cluster, and so does the port: on a port
    cluster (a 4-CPU head, the workers forked processes), the two-stage
    shuffle (its map and reduce task counts), a descending sort, an
    order-preserving repartition, a per-key count and an all-empty sort
    (its predicate module-level: the cluster sends callables by
    reference), with no concat on the driver, equal to JAX's in
    process."""
    import torch_cluster_cases as cases
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.data import block as tblock

    rt.shutdown()
    cluster = Cluster(head_node_args={"num_cpus": 4})
    try:
        rt.init(address=cluster.address)
        _shuffle_case(monkeypatch, tblock, cases.never)
    finally:
        rt.shutdown()
        cluster.shutdown()
        rt.init(num_cpus=8, num_gpus=0)


def _shuffle_case(monkeypatch, tblock, never):

    def case(d):
        ds = d.range(300, parallelism=6)
        out = ds.random_shuffle(seed=3)
        return (out._last_shuffle, out.take_all(),
                ds.sort("id", descending=True).take_all(),
                ds.repartition(10).num_blocks(),
                ds.repartition(10).take_all(),
                sorted(r["id"] for r in ds.groupby("id").count().take_all()),
                ds.filter(never).sort("id").take_all())

    jax_ = case(jdata)
    driver = threading.get_ident()
    real = tblock.concat

    def poison(blocks):
        if threading.get_ident() == driver:
            raise AssertionError("driver-side concat in shuffle")
        return real(blocks)

    monkeypatch.setattr(tblock, "concat", poison)
    port = case(tdata)
    assert port[0] == {"mode": "distributed", "map_tasks": 6,
                       "reduce_tasks": 6}
    assert sorted(r["id"] for r in port[1]) == list(range(300))
    assert [r["id"] for r in port[2]] == list(range(299, -1, -1))
    assert port[3] == 10
    assert [r["id"] for r in port[4]] == list(range(300))
    assert port[5] == list(range(300))
    assert port[6] == []
    assert port == jax_


def test_distributed_writers_roundtrip(tmp_path):
    def case(d, root):
        ds = d.range(100, parallelism=4)
        paths = ds.write_parquet(str(root / "pq"))
        back = d.read_parquet(str(root / "pq"))
        out = [len(paths), all(p.endswith(".parquet") for p in paths),
               sorted(r["id"] for r in back.take_all())]
        ds.write_csv(str(root / "csv"))
        out.append(d.read_csv(str(root / "csv")).take_all())
        ds.write_json(str(root / "nj"))
        out.append(d.read_json(str(root / "nj")).take_all())
        # Empty blocks are skipped, not written as corrupt files.
        out.append(ds.filter(lambda r: False).write_parquet(
            str(root / "empty")))
        return out

    port = case(tdata, tmp_path / "port")
    jax_ = case(jdata, tmp_path / "jax")
    assert port[:3] == [4, True, list(range(100))]
    assert len(port[3]) == 100
    assert sorted(r["id"] for r in port[4]) == list(range(100))
    assert port[5] == []
    same_rows(port[3], jax_[3])
    same_rows(port[4], jax_[4])
    assert port[5] == jax_[5]
    # Each package reads the other's files to the same rows.
    for fmt, reader in (("pq", "read_parquet"), ("csv", "read_csv"),
                        ("nj", "read_json")):
        got = getattr(tdata, reader)(str(tmp_path / "jax" / fmt)).take_all()
        want = getattr(jdata, reader)(str(tmp_path / "port" / fmt)).take_all()
        same_rows(got, want)


# ----------------------------------------------- the port's own guarantees
def test_float_aggregates_within_tolerance():
    """sum, mean, min and max of float64 values per key against Arrow's
    (set-compared: Arrow's hash grouping does not promise an order)."""
    rng = np.random.default_rng(0)
    items = [{"k": int(k), "v": float(v)} for k, v in zip(
        rng.integers(0, 7, 500), rng.normal(size=500) * 1e3)]

    def case(d):
        ds = d.from_items(items, parallelism=5)
        g = ds.groupby("k")
        return {how: {r["k"]: r[f"v_{how}"] for r in
                      getattr(g, how)("v").take_all()}
                for how in ("sum", "mean", "min", "max")} | {
            "count": {r["k"]: r["k_count"] for r in g.count().take_all()}}

    port, jax_ = both(case)
    assert port.keys() == jax_.keys()
    for how in port:
        assert port[how].keys() == jax_[how].keys()
        for k in port[how]:
            np.testing.assert_allclose(port[how][k], jax_[how][k],
                                       rtol=AGG_RTOL)
    assert port["count"] == jax_["count"]
    assert port["min"] == jax_["min"] and port["max"] == jax_["max"]


def test_stable_sort_and_key_partition_match_jax():
    from ray_tpu.data import dataset as jds
    from ray_tpu_torch.data import dataset as tds

    items = [{"k": k, "i": i} for i, k in enumerate(
        [3, 1, 3, 2, 1, 3, 2, 2, 1, 3] * 4)]
    for desc in (False, True):
        port, jax_ = both(lambda d: d.from_items(items, parallelism=1).sort(
            "k", descending=desc).take_all())
        assert port == jax_
    for v in (0, 0.0, -0.0, 1, 1.0, float("nan"), "a", b"a", 2 ** 62,
              np.int64(5), np.float32(2.5), (1, 2)):
        for n in (1, 4, 7):
            assert tds._key_partition(v, n) == jds._key_partition(v, n)


def test_float_keys_group_as_arrow_does():
    """Arrow groups floats by value bits: 0.0 and -0.0 apart, every NaN
    together."""
    items = [{"k": k, "v": 1} for k in (0.0, -0.0, 1.0, float("nan"),
                                        float("nan"))]
    port, jax_ = both(lambda d: d.from_items(items).groupby(
        "k").count().take_all())
    assert sorted(r["k_count"] for r in port) == [1, 1, 1, 2]
    key = (lambda r: (repr(r["k"]), r["k_count"]))
    assert sorted(map(key, port)) == sorted(map(key, jax_))


def test_no_data_actor_or_thread_outlives_shutdown():
    """A pipeline with a stats actor, an actor pool and fire-and-forget
    stats leaves nothing behind once ``shutdown()`` returns: no thread
    of the runtime, no new thread at all, and no runtime started again
    by a late stats record."""
    from ray_tpu_torch._private import worker as tworker

    rt.shutdown()
    before = set(threading.enumerate())
    rt.init(num_cpus=8, num_gpus=0)
    core = tworker.global_worker().core
    ds = tdata.range(64, parallelism=8).map(
        lambda r: {"id": r["id"] + 1}).map_batches(
        AddBias, concurrency=2, fn_constructor_args=(1,))
    assert sorted(r["id"] for r in ds.take_all()) == list(range(2, 66))
    assert "_rtpu_data_stats" in rt.list_named_actors()
    rt.shutdown()
    time.sleep(0.5)
    assert not rt.is_initialized()
    assert core.runtime_threads() == []
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert left == [], left
    rt.init(num_cpus=8, num_gpus=0)  # restore the module's runtime


def test_exports_match_jax():
    assert set(tdata.__all__) == set(jdata.__all__)
    assert os.path.basename(tdata.__file__) == "__init__.py"
