"""Blocks: the unit ``ray_tpu_torch.data`` moves and transforms.

The JAX package's blocks are pyarrow Tables (``ray_tpu/data/dataset.py``,
``_table_from_rows`` to ``_table_from_batch``). The card's machine has no
pyarrow, so a block here is an ordered dict of column name -> numpy
array, every column of the same length. A tensor column keeps its shape
``[N, d1, ...]`` natively (JAX stores it as a fixed-size list with the
shape in the field's metadata). A column that numpy cannot hold as one
typed array (strings, bytes, ragged lists, values with ``None``) is an
object array of the row values.

Rows read back as Python values, as Arrow's ``to_pylist`` gives them:
numbers as ``int``/``float``/``bool``, a tensor column's cell as its
``ndarray``. pandas is imported only by the pandas format, as in JAX.
"""

from __future__ import annotations

import builtins
from typing import Any, Dict, Iterable, List, Sequence

import numpy as np

Block = Dict[str, np.ndarray]


def num_rows(block: Block) -> int:
    for col in block.values():
        return len(col)
    return 0


def nbytes(block: Block) -> int:
    """The bytes a block's typed columns hold (an object column counts
    its pointers only)."""
    return sum(int(col.nbytes) for col in block.values())


def object_column(vals: Sequence[Any]) -> np.ndarray:
    out = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        out[i] = v
    return out


def column_from_values(vals: Sequence[Any]) -> np.ndarray:
    """One column from per-row values, typed as Arrow would type it:
    bools, int64, float64 (ints and floats mixed), a numpy scalar type
    shared by every value, else an object array of the values."""
    if not len(vals):
        return np.empty(0, dtype=object)
    first = vals[0]
    if isinstance(first, np.generic) and all(
            isinstance(v, np.generic) and v.dtype == first.dtype
            for v in vals) and first.dtype.kind in "biuf":
        return np.array(vals, dtype=first.dtype)
    if all(isinstance(v, (bool, np.bool_)) for v in vals):
        return np.array(vals, dtype=bool)
    if all(isinstance(v, (int, np.integer))
           and not isinstance(v, (bool, np.bool_)) for v in vals):
        try:
            return np.array(vals, dtype=np.int64)
        except OverflowError:
            return object_column(vals)
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in vals):
        return np.array(vals, dtype=np.float64)
    return object_column(vals)


def from_rows(rows: List[Any]) -> Block:
    """A block from row dicts (a non-dict row becomes ``{"item": row}``).
    Rows of ndarrays of one shape and dtype become a tensor column."""
    if rows and not isinstance(rows[0], dict):
        rows = [{"item": r} for r in rows]
    if not rows:
        return {}
    out: Block = {}
    for k in rows[0]:
        vals = [r.get(k) for r in rows]
        first = vals[0]
        if (isinstance(first, np.ndarray) and first.ndim >= 1
                and all(isinstance(v, np.ndarray) and v.shape == first.shape
                        and v.dtype == first.dtype for v in vals)):
            out[k] = np.stack(vals)
        else:
            out[k] = column_from_values(vals)
    return out


def _cell(v):
    return v.item() if isinstance(v, np.generic) else v


def rows_of(block: Block) -> List[Dict[str, Any]]:
    """The block's rows as dicts of Python values; a tensor column's cell
    is its ``ndarray`` (a view of the column)."""
    n = num_rows(block)
    cols = {}
    for k, col in block.items():
        if col.ndim > 1:
            cols[k] = list(col)
        elif col.dtype == object:
            cols[k] = [_cell(v) for v in col]
        else:
            cols[k] = col.tolist()
    return [{k: cols[k][i] for k in block} for i in builtins.range(n)]


def _column_from_batch(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        arr = v
    else:
        try:
            arr = np.asarray(v)
        except Exception:  # noqa: BLE001 — a ragged list of lists
            arr = object_column(list(v))
    if arr.dtype.kind in "US":
        # Arrow holds strings and bytes as variable-width values; read
        # back they are Python objects, not fixed-width numpy ones.
        return object_column(arr.tolist())
    return arr


def from_batch(batch) -> Block:
    """A block from a ``map_batches`` result: a dict of columns (arrays
    or sequences) or a pandas DataFrame."""
    if isinstance(batch, dict):
        out = {k: _column_from_batch(v) for k, v in batch.items()}
        lens = {len(c) for c in out.values()}
        if len(lens) > 1:
            raise ValueError(
                f"batch columns have different lengths: "
                f"{ {k: len(c) for k, c in out.items()} }")
        return out
    import pandas as pd

    if isinstance(batch, pd.DataFrame):
        return from_pandas(batch)
    raise TypeError(f"unsupported batch type {type(batch)}")


def batch_of(block: Block, fmt: str):
    """The block in a batch format: ``numpy``/``default`` (a dict of
    arrays; a ragged list cell comes back as an ``ndarray``, as Arrow's
    list columns do) or ``pandas``."""
    if fmt == "pandas":
        return to_pandas(block)
    if fmt not in ("numpy", "default"):
        raise ValueError(f"unsupported batch format {fmt!r} (the port's "
                         f"blocks are numpy columns: numpy, default or "
                         f"pandas)")
    out = {}
    for k, col in block.items():
        if col.dtype == object and any(
                isinstance(v, (list, tuple)) for v in col):
            col = object_column([np.asarray(v) if isinstance(
                v, (list, tuple)) else v for v in col])
        out[k] = col
    return out


def to_pandas(block: Block):
    import pandas as pd

    return pd.DataFrame({k: (list(col) if col.ndim > 1 else col)
                         for k, col in block.items()})


def from_pandas(df) -> Block:
    out: Block = {}
    for k in df.columns:
        col = df[k].to_numpy()
        if col.dtype == object:
            col = object_column([None if _is_na(v) else v for v in col])
        out[str(k)] = col
    return out


def _is_na(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def slice_block(block: Block, off: int, length: int) -> Block:
    return {k: col[off:off + length] for k, col in block.items()}


def take(block: Block, idx) -> Block:
    idx = np.asarray(idx, dtype=np.int64)
    return {k: col[idx] for k, col in block.items()}


def empty_like(block: Block) -> Block:
    """No rows, the block's columns and types."""
    return slice_block(block, 0, 0)


def concat(blocks: Iterable[Block]) -> Block:
    """Rows of ``blocks`` in order. The column set is the first block's
    (a block without columns is skipped); a column whose blocks disagree
    on dtype becomes an object column."""
    blocks = [b for b in blocks if b]
    if not blocks:
        return {}
    live = [b for b in blocks if num_rows(b)]
    if not live:
        return dict(blocks[0])
    blocks = live
    if len(blocks) == 1:
        return dict(blocks[0])
    out: Block = {}
    for k in blocks[0]:
        cols = [b[k] for b in blocks]
        if len({(c.dtype, c.shape[1:]) for c in cols}) == 1:
            out[k] = np.concatenate(cols)
        elif all(c.ndim == 1 and c.dtype.kind in "iuf" for c in cols):
            out[k] = np.concatenate([c.astype(np.float64) for c in cols])
        else:
            out[k] = object_column([v for c in cols for v in c])
    return out


def py_values(col: np.ndarray) -> list:
    """A 1-D column's cells as Python values."""
    return [_cell(v) for v in col] if col.dtype == object else col.tolist()
