"""Custom data sources: the ``Datasource`` interface (the port of
``ray_tpu/data/datasource.py``).

Reference: ``python/ray/data/datasource/datasource.py:11`` — a datasource
turns itself into a list of *read tasks*; each task runs remotely and
produces one block. The five built-in file readers are built on this
interface, and users plug in anything by subclassing.

A block is a dict of numpy columns (:mod:`.block`). JAX reads CSV and JSON
through ``pyarrow.csv`` and ``pyarrow.json``; the port reads them with the
standard library and types each column as pyarrow infers it on such
files: int64, float64, bool, else strings. Parquet (and ``from_arrow``)
imports pyarrow when called and converts to numpy blocks: the card's
machine has no pyarrow, so there they raise ``ImportError`` naming it.
A read task may also return a pyarrow Table, converted the same way.
"""

from __future__ import annotations

import abc
import json
from typing import Callable, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as B


def _require_pyarrow(what: str, module: str = "pyarrow"):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{what} needs pyarrow ({module}), which this machine does not "
            f"have; the port's blocks are numpy columns, and CSV, JSON, "
            f"text and binary files read without it") from e


def from_arrow_table(table) -> B.Block:
    """A pyarrow Table as a block: a tensor column (a fixed-size list
    with ``tensor_shape`` in its field's metadata, as JAX writes it)
    reshaped to ``[N, ...]``; a column without nulls as its numpy array
    (strings as Python objects); a list or null-holding column as an
    object array of its Python values."""
    pa = _require_pyarrow("from_arrow")
    out: B.Block = {}
    for i, name in enumerate(table.column_names):
        field = table.schema.field(i)
        col = table.column(i).combine_chunks() if table.num_rows else \
            table.column(i)
        if pa.types.is_fixed_size_list(field.type) and table.num_rows \
                and not col.null_count:
            flat = col.values.to_numpy(zero_copy_only=False)
            shape = (field.type.list_size,)
            if field.metadata and b"tensor_shape" in field.metadata:
                shape = tuple(json.loads(field.metadata[b"tensor_shape"]))
            out[name] = flat.reshape((len(col),) + shape)
        elif (pa.types.is_integer(field.type)
              or pa.types.is_floating(field.type)
              or pa.types.is_boolean(field.type)) and not col.null_count:
            out[name] = np.asarray(col.to_numpy(zero_copy_only=False))
        else:
            out[name] = B.column_from_values(col.to_pylist())
            if out[name].dtype != object:
                out[name] = B.object_column(col.to_pylist())
    return out


def to_arrow(blk: B.Block):
    """A block as a pyarrow Table in JAX's layout (a tensor column as a
    fixed-size list with its shape in the field's metadata), so either
    package reads the other's files."""
    pa = _require_pyarrow("to_arrow")
    arrays, fields = [], []
    for name, col in blk.items():
        if col.ndim > 1:
            inner = int(np.prod(col.shape[1:]))
            flat = pa.array(np.ascontiguousarray(col).reshape(-1))
            arr = pa.FixedSizeListArray.from_arrays(flat, inner)
            meta = {b"tensor_shape": json.dumps(
                list(col.shape[1:])).encode()}
            fields.append(pa.field(name, arr.type, metadata=meta))
        else:
            arr = pa.array(B.py_values(col) if col.dtype == object else col)
            fields.append(pa.field(name, arr.type))
        arrays.append(arr)
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _as_block(out) -> B.Block:
    if isinstance(out, dict):
        return out
    if type(out).__module__.startswith("pyarrow"):
        return from_arrow_table(out)
    raise TypeError(
        f"read task must return a block (a dict of numpy columns) or a "
        f"pyarrow.Table, got {type(out).__name__}")


class Datasource(abc.ABC):
    """A pluggable source of blocks.

    Implement :meth:`get_read_tasks` to return up to ``parallelism``
    zero-argument callables; each is executed as ONE remote task and must
    return a block (a dict of numpy columns, or a pyarrow Table where
    pyarrow is installed).
    """

    @abc.abstractmethod
    def get_read_tasks(self, parallelism: int) -> List[Callable[[], B.Block]]:
        ...

    def estimate_inmemory_data_size(self) -> int:
        """Optional size hint (bytes); -1 = unknown."""
        return -1


@ray_tpu_torch.remote
def _run_read_task(task) -> B.Block:
    return _as_block(task())


def read_datasource(source: Datasource, *, parallelism: int = 8):
    """A :class:`Datasource` as a Dataset: one remote task per read
    task, blocks stay in the object store."""
    from ray_tpu_torch.data.dataset import Dataset

    tasks = source.get_read_tasks(parallelism)
    if not tasks:
        return Dataset([ray_tpu_torch.put({})])
    return Dataset([_run_read_task.remote(t) for t in tasks])


# --------------------------------------------------------------- builtins
class _FileDatasource(Datasource):
    """Shared scaffold: expand paths, stride into ≤parallelism groups,
    one read task per group."""

    def __init__(self, paths):
        self.paths = paths

    def get_read_tasks(self, parallelism: int):
        from functools import partial

        from ray_tpu_torch.data.dataset import _expand_paths

        files = _expand_paths(self.paths)
        groups = [g for i in range(max(1, parallelism))
                  if (g := files[i::max(1, parallelism)])]
        return [partial(self._read_group, g) for g in groups]

    @abc.abstractmethod
    def _read_group(self, group: List[str]) -> B.Block:
        ...


class ParquetDatasource(_FileDatasource):
    def _read_group(self, group):
        pq = _require_pyarrow("read_parquet", "pyarrow.parquet")
        return B.concat([from_arrow_table(pq.read_table(p)) for p in group])


_TRUE = ("true", "True", "TRUE")
_FALSE = ("false", "False", "FALSE")


def _csv_column(cells: List[str]) -> np.ndarray:
    """One CSV column, typed as pyarrow's reader infers it: int64 if
    every non-empty cell is an integer, float64 if a number, bool if
    true/false (an empty cell is a null there), else strings (an empty
    cell stays "")."""
    present = [c for c in cells if c != ""]

    def all_parse(fn):
        try:
            for v in present:
                fn(v)
            return True
        except ValueError:
            return False

    if present and all_parse(int):
        conv = int
    elif present and all_parse(float):
        conv = float
    elif present and all(v in _TRUE + _FALSE for v in present):
        def conv(v):
            return v in _TRUE
    else:
        return B.object_column(cells)
    typed = [None if c == "" else conv(c) for c in cells]
    if len(present) < len(cells):
        return B.object_column(typed)
    return B.column_from_values(typed)


def _read_csv_file(path: str) -> B.Block:
    """A CSV file with a header row."""
    import csv

    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        return {}
    header, rows = rows[0], rows[1:]
    return {name: _csv_column([r[j] if j < len(r) else "" for r in rows])
            for j, name in enumerate(header)}


class CSVDatasource(_FileDatasource):
    def _read_group(self, group):
        return B.concat([_read_csv_file(p) for p in group])


class JSONDatasource(_FileDatasource):
    """Newline-delimited JSON objects, one row each."""

    def _read_group(self, group):
        rows = []
        for path in group:
            with open(path, encoding="utf-8") as f:
                rows.extend(json.loads(line) for line in f if line.strip())
        return B.from_rows(rows)


class BinaryFilesDatasource(_FileDatasource):
    """One row per file: ``{"bytes": ..., "path": ...}``."""

    def __init__(self, paths, include_paths: bool = True):
        super().__init__(paths)
        self.include_paths = include_paths

    def _read_group(self, group):
        rows = {"bytes": []}
        if self.include_paths:
            rows["path"] = []
        for path in group:
            with open(path, "rb") as f:
                rows["bytes"].append(f.read())
            if self.include_paths:
                rows["path"].append(path)
        return {k: B.object_column(v) for k, v in rows.items()}


class TextDatasource(_FileDatasource):
    """One row per line: ``{"text": ...}``."""

    def _read_group(self, group):
        lines = []
        for path in group:
            with open(path, encoding="utf-8") as f:
                # Only \n terminates rows (str.splitlines would also
                # split on unicode separators); rstrip handles CRLF.
                lines.extend(line.rstrip("\r\n") for line in f)
        return {"text": B.object_column(lines)}


__all__ = [
    "Datasource", "read_datasource", "ParquetDatasource", "CSVDatasource",
    "JSONDatasource", "BinaryFilesDatasource", "TextDatasource",
]
