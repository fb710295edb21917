"""Port parity: the ``Datasource`` interface, zip, join and tensor columns
of ``ray_tpu_torch.data`` against ``ray_tpu.data``, every case of
``tests/test_data_sources.py``.

A tensor column is a numpy array ``[N, ...]`` in the port's blocks (a
fixed-size list with its shape in the field's metadata in JAX's). Rows
compare in order where JAX's order is deterministic (zip keeps the left
side's rows); joins compare as sets of rows (Arrow's hash join does not
promise an order).
"""

from functools import partial

import numpy as np
import pyarrow as pa
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import data as jdata
from ray_tpu.data.datasource import Datasource as JDatasource
from ray_tpu_torch import data as tdata
from ray_tpu_torch.data.datasource import Datasource as TDatasource


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    for pkg in (ray_tpu, rt):
        if pkg.is_initialized():
            pkg.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0)
    rt.init(num_cpus=4, num_gpus=0)
    yield
    rt.shutdown()
    ray_tpu.shutdown()


def both(case):
    return case(tdata), case(jdata)


def _spans(n, parallelism):
    step = max(1, n // parallelism)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _port_span(span):
    return {"id": np.arange(*span, dtype=np.int64)}


def _jax_span(span):
    return pa.table({"id": list(range(*span))})


class PortRangeSource(TDatasource):
    """Synthetic in-memory datasource: n rows split across read tasks,
    each a numpy block."""

    def __init__(self, n):
        self.n = n

    def get_read_tasks(self, parallelism):
        return [partial(_port_span, s) for s in _spans(self.n, parallelism)]


class JaxRangeSource(JDatasource):
    def __init__(self, n):
        self.n = n

    def get_read_tasks(self, parallelism):
        return [partial(_jax_span, s) for s in _spans(self.n, parallelism)]


def row_set(rows):
    return sorted(tuple(sorted((k, repr(v)) for k, v in r.items()))
                  for r in rows)


def test_custom_datasource():
    def case(d, source):
        ds = d.read_datasource(source(100), parallelism=4)
        doubled = ds.map(lambda r: {"id": r["id"] * 2})
        return ds.num_blocks(), ds.take_all(), doubled.take_all()

    port = case(tdata, PortRangeSource)
    jax_ = case(jdata, JaxRangeSource)
    assert sorted(r["id"] for r in port[1]) == list(range(100))
    assert sorted(r["id"] for r in port[2]) == [2 * i for i in range(100)]
    assert port == jax_
    # A read task may hand back a pyarrow Table where pyarrow exists.
    src = JaxRangeSource(10)
    got = tdata.read_datasource(src, parallelism=2).take_all()
    assert got == [{"id": i} for i in range(10)]


def test_builtin_readers_still_work(tmp_path):
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"x": [1, 2, 3]}), tmp_path / "a.parquet")
    pq.write_table(pa.table({"x": [4, 5]}), tmp_path / "b.parquet")
    port, jax_ = both(lambda d: d.read_parquet(
        str(tmp_path / "*.parquet")).take_all())
    assert sorted(r["x"] for r in port) == [1, 2, 3, 4, 5]
    assert port == jax_


def test_zip_misaligned_blocks():
    def case(d):
        a = d.range(20, parallelism=3)
        b = d.from_items([{"y": i * 10} for i in range(20)], parallelism=5)
        return a.zip(b).take_all()

    port, jax_ = both(case)
    assert sorted((r["id"], r["y"]) for r in port) == \
        [(i, i * 10) for i in range(20)]
    assert port == jax_


def test_zip_duplicate_columns_and_mismatch():
    port, jax_ = both(lambda d: d.range(5).zip(d.range(5)).take_all())
    assert "id" in port[0] and "id_1" in port[0]
    assert port == jax_
    with pytest.raises(ValueError, match="equal row counts"):
        tdata.range(5).zip(tdata.range(6)).take_all()


def test_join_inner_and_left_outer():
    def case(d):
        users = d.from_items(
            [{"uid": i, "name": f"u{i}"} for i in range(8)], parallelism=3)
        orders = d.from_items(
            [{"uid": i % 4, "amount": i * 100} for i in range(10)],
            parallelism=2)
        return (users.join(orders, on="uid").take_all(),
                users.join(orders, on="uid",
                           join_type="left outer").take_all())

    port, jax_ = both(case)
    inner, outer = port
    assert len(inner) == 10  # every order matches one of uid 0..3
    assert all(r["name"] == f"u{r['uid']}" for r in inner)
    # uid 4..7 have no orders but survive with null amounts.
    assert len(outer) == 14
    unmatched = [r for r in outer if r["amount"] is None]
    assert sorted(r["uid"] for r in unmatched) == [4, 5, 6, 7]
    assert row_set(inner) == row_set(jax_[0])
    assert row_set(outer) == row_set(jax_[1])
    assert [list(r) for r in inner[:1]] == [list(r) for r in jax_[0][:1]]


@pytest.mark.parametrize("join_type", ["right outer", "full outer",
                                       "left semi", "left anti",
                                       "right semi", "right anti"])
def test_other_join_types_match_arrow(join_type):
    def case(d):
        left = d.from_items([{"k": i % 6, "a": i} for i in range(9)],
                            parallelism=2)
        right = d.from_items([{"k": i % 7 + 2, "b": -i} for i in range(8)],
                             parallelism=3)
        return left.join(right, on="k", join_type=join_type,
                         num_partitions=3).take_all()

    port, jax_ = both(case)
    assert port and row_set(port) == row_set(jax_)


def test_tensor_columns_round_trip():
    arr = np.arange(24 * 5, dtype=np.float32).reshape(24, 5)
    imgs = np.random.default_rng(0).random((12, 4, 3)).astype(np.float32)

    def case(d):
        batches = list(d.from_numpy(arr, parallelism=3).iter_batches(
            batch_size=8, batch_format="numpy"))
        ds2 = d.from_numpy(imgs, parallelism=2).map_batches(
            lambda b: {"data": b["data"] * 2.0})
        return (np.concatenate([b["data"] for b in batches]),
                np.concatenate([b["data"] for b in
                                ds2.iter_batches(batch_size=6)]))

    (got, out), (jgot, jout) = both(case)
    np.testing.assert_array_equal(np.sort(got[:, 0]), np.sort(arr[:, 0]))
    assert got.shape == (24, 5) and got.dtype == np.float32
    # Higher-rank tensors (images) keep their exact shape through
    # map_batches and iter_batches.
    assert out.shape == (12, 4, 3)
    np.testing.assert_allclose(np.sort(out.ravel()),
                               np.sort((imgs * 2).ravel()), rtol=1e-6)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(out, jout)
    assert out.dtype == jout.dtype


def test_tensor_batches_are_mesh_shardable():
    """iter_batches output is the exact [B, ...] array, JAX's batch as it
    is; the port's device batches land as torch tensors of that shape."""
    arr = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
    port, jax_ = both(lambda d: list(d.from_numpy(
        arr, parallelism=2).iter_batches(batch_size=8)))
    assert [b["data"].shape for b in port] == [(8, 6), (8, 6)]
    for a, b in zip(port, jax_):
        np.testing.assert_array_equal(a["data"], b["data"])
    it = tdata.from_numpy(arr, parallelism=2).iterator()
    with it.iter_device_batches("cpu", batch_size=8) as pf:
        staged = list(pf)
    assert [tuple(b["data"].shape) for b in staged] == [(8, 6), (8, 6)]
    assert all(b["data"].device.type == "cpu" for b in staged)
    torch.testing.assert_close(torch.cat([b["data"] for b in staged]),
                               torch.from_numpy(arr), rtol=0, atol=0)


def test_zip_preserves_tensor_shape_and_join_key_errors():
    arr = np.zeros((12, 4, 3), dtype=np.float32)

    def case(d):
        ds = d.from_numpy(arr, parallelism=2)
        labels = d.from_items([{"y": i} for i in range(12)], parallelism=2)
        return next(iter(ds.zip(labels).iter_batches(batch_size=12)))

    port, jax_ = both(case)
    assert port["data"].shape == (12, 4, 3), \
        "tensor shape lost through zip"
    np.testing.assert_array_equal(port["y"], jax_["y"])
    for d in (tdata, jdata):
        with pytest.raises(Exception, match="uuid"):
            d.from_items([{"uid": 1}]).join(
                d.from_items([{"uid": 1}]), on="uuid").take_all()


def test_join_matches_arrow_semantics_for_signed_zero():
    """Partitioning must be no coarser than Arrow's join equality: the
    distributed join gives the SAME answer as a single-table Arrow join
    (0.0/-0.0 land in one partition, then the join decides: Arrow keeps
    them apart and matches NaN with NaN, as the port's join does)."""
    lt = pa.table({"k": [0.0, 1.0], "side": ["a", "a2"]})
    rt_ = pa.table({"k": [-0.0, 1.0], "amt": [1, 2]})
    expected = len(lt.join(rt_, keys=["k"], join_type="inner"))
    port, jax_ = both(lambda d: d.from_arrow(lt).join(
        d.from_arrow(rt_), on="k", num_partitions=4).take_all())
    assert len(port) == expected == len(jax_)
    assert row_set(port) == row_set(jax_)
    nl = pa.table({"k": [float("nan"), 0.0], "a": [1, 2]})
    nr = pa.table({"k": [float("nan"), -0.0], "b": [3, 4]})
    port, jax_ = both(lambda d: d.from_arrow(nl).join(
        d.from_arrow(nr), on="k", join_type="full outer").take_all())
    assert len(port) == len(nl.join(nr, keys="k",
                                    join_type="full outer")) == 3
    assert row_set(port) == row_set(jax_)


def test_tensor_rows_and_pandas_keep_shape():
    arr = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3)

    def case(d):
        ds = d.from_numpy(arr, parallelism=1)
        return ds.take_all()[0], next(iter(ds.iter_batches(
            batch_size=2, batch_format="pandas")))

    (row, df), (jrow, jdf) = both(case)
    assert getattr(row["data"], "shape", None) == (4, 3)
    assert df["data"].iloc[0].shape == (4, 3)
    np.testing.assert_array_equal(row["data"], jrow["data"])
    np.testing.assert_array_equal(df["data"].iloc[1], jdf["data"].iloc[1])


def test_parquet_without_pyarrow_raises_naming_it(monkeypatch, tmp_path):
    """The card's machine has no pyarrow: parquet and Arrow interchange
    raise ``ImportError`` naming it there, and the rest reads on."""
    import builtins
    import sys

    real = builtins.__import__

    def no_pyarrow(name, *a, **k):
        if name == "pyarrow" or name.startswith("pyarrow."):
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)

    for mod in [m for m in sys.modules if m == "pyarrow"
                or m.startswith("pyarrow.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    (tmp_path / "t.txt").write_text("a\nb\n")
    ds = tdata.range(4, parallelism=2)
    with pytest.raises(Exception, match="pyarrow"):
        ds.write_parquet(str(tmp_path / "pq"))
    with pytest.raises(ImportError, match="pyarrow"):
        tdata.from_arrow(None)
    assert [r["text"] for r in tdata.read_text(
        str(tmp_path / "t.txt")).take_all()] == ["a", "b"]
    paths = ds.write_csv(str(tmp_path / "csv"))
    assert len(paths) == 2
    assert sorted(r["id"] for r in tdata.read_csv(
        str(tmp_path / "csv")).take_all()) == [0, 1, 2, 3]
