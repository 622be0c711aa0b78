"""MTable — the host-side columnar table.

PyTorch port: a copy of ``alink_tpu/common/mtable.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

Replaces the reference's Flink ``Table``/``Row`` substrate (operators there
produce Tables; models are Tables of Rows). TPU-first split: strings and
objects live in host numpy columns; only encoded numeric tensors are shipped
to the device (SURVEY §7 "Rows of strings never touch the TPU").

Columns are numpy arrays (numeric dtypes, or dtype=object for strings /
vectors / nested MTables).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .types import AlinkTypes, TableSchema
from .vector import DenseVector, SparseVector, VectorUtil


class MTable:
    def __init__(self, columns: Union[Dict[str, Any], Sequence[Sequence[Any]], np.ndarray],
                 schema: Union[TableSchema, str, Sequence[str], None] = None):
        if isinstance(schema, str):
            schema = TableSchema.parse(schema)

        if isinstance(columns, dict):
            names = list(columns.keys())
            cols = [_as_column(v) for v in columns.values()]
        else:
            # row-major input: list of rows (tuples) or 2-D ndarray
            if isinstance(columns, np.ndarray) and columns.ndim == 2:
                rows = [tuple(r) for r in columns]
            else:
                rows = [tuple(r) if isinstance(r, (tuple, list, np.ndarray)) else (r,)
                        for r in columns]
            ncol = len(rows[0]) if rows else (len(schema) if schema is not None else 0)
            cols = [_as_column([r[j] for r in rows]) for j in range(ncol)]
            if isinstance(schema, TableSchema):
                names = list(schema.names)
            elif schema is not None:
                names = list(schema)
                schema = None
            else:
                names = [f"col{j}" for j in range(ncol)]

        if isinstance(schema, TableSchema):
            self.schema = schema.copy()
            names = schema.names
        else:
            if schema is not None and not isinstance(schema, TableSchema):
                names = list(schema)
            types = [_infer_type(c) for c in cols]
            self.schema = TableSchema(names, types)

        if len(cols) != len(self.schema):
            raise ValueError(f"{len(cols)} columns vs schema of {len(self.schema)}")
        n = cols[0].shape[0] if cols else 0
        for c in cols:
            if c.shape[0] != n:
                raise ValueError("ragged columns")
        self._cols: Dict[str, np.ndarray] = dict(zip(self.schema.names, cols))

    # ------------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        if not self._cols:
            return 0
        return next(iter(self._cols.values())).shape[0]

    @property
    def col_names(self) -> List[str]:
        return list(self.schema.names)

    @property
    def col_types(self) -> List[str]:
        return list(self.schema.types)

    def col(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(f"column '{name}' not in {self.col_names}")
        return self._cols[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.col(name)

    def __len__(self):
        return self.num_rows

    def numeric_block(self, names: Sequence[str], dtype=np.float64) -> np.ndarray:
        """Stack numeric columns into an (n, k) array — the device-encode boundary."""
        return np.stack([np.asarray(self._cols[n], dtype=dtype) for n in names], axis=1) \
            if names else np.zeros((self.num_rows, 0), dtype)

    def rows(self) -> Iterable[Tuple]:
        cols = [self._cols[n] for n in self.schema.names]
        for i in range(self.num_rows):
            yield tuple(c[i] for c in cols)

    def row(self, i: int) -> Tuple:
        return tuple(self._cols[n][i] for n in self.schema.names)

    def to_rows(self) -> List[Tuple]:
        return list(self.rows())

    # -- relational ops (back the SQL operator family) -------------------
    def select(self, names: Union[str, Sequence[str]]) -> "MTable":
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        sub = TableSchema(names, [self.schema.type_of(n) for n in names])
        return MTable({n: self._cols[n] for n in names}, sub)

    def take_rows(self, idx) -> "MTable":
        idx = np.asarray(idx)
        if idx.dtype != bool:
            idx = idx.astype(np.intp)
        return MTable({n: c[idx] for n, c in self._cols.items()}, self.schema)

    def first_n(self, n: int) -> "MTable":
        return self.take_rows(np.arange(min(n, self.num_rows)))

    def filter_mask(self, mask: np.ndarray) -> "MTable":
        return self.take_rows(np.nonzero(np.asarray(mask, dtype=bool))[0])

    def add_column(self, name: str, values, type_: Optional[str] = None) -> "MTable":
        col = _as_column(values)
        cols = dict(self._cols)
        names, types = list(self.schema.names), list(self.schema.types)
        if name in cols:
            i = names.index(name)
            types[i] = type_ or _infer_type(col)
        else:
            names.append(name)
            types.append(type_ or _infer_type(col))
        cols[name] = col
        return MTable(cols, TableSchema(names, types))

    def drop_columns(self, names: Sequence[str]) -> "MTable":
        keep = [n for n in self.schema.names if n not in set(names)]
        return self.select(keep)

    def rename(self, mapping_or_names) -> "MTable":
        if isinstance(mapping_or_names, dict):
            names = [mapping_or_names.get(n, n) for n in self.schema.names]
        else:
            names = list(mapping_or_names)
        return MTable({new: c for new, c in zip(names, (self._cols[o] for o in self.schema.names))},
                      TableSchema(names, list(self.schema.types)))

    def concat_rows(self, other: "MTable") -> "MTable":
        if other.col_names != self.col_names:
            other = other.select(self.col_names)
        return MTable({n: _concat(self._cols[n], other._cols[n]) for n in self.schema.names},
                      self.schema)

    def order_by(self, name: str, ascending: bool = True, limit: Optional[int] = None) -> "MTable":
        key = self._cols[name]
        try:
            order = np.argsort(key, kind="stable")
        except TypeError:
            order = np.argsort(np.asarray([str(v) for v in key]), kind="stable")
        if not ascending:
            order = order[::-1]
        if limit is not None:
            order = order[:limit]
        return self.take_rows(order)

    def distinct(self) -> "MTable":
        seen, keep = set(), []
        for i, r in enumerate(self.rows()):
            k = tuple(_hashable(v) for v in r)
            if k not in seen:
                seen.add(k)
                keep.append(i)
        return self.take_rows(keep)

    def group_indices(self, by: Sequence[str]) -> Dict[Tuple, np.ndarray]:
        keys: Dict[Tuple, List[int]] = {}
        cols = [self._cols[n] for n in by]
        for i in range(self.num_rows):
            k = tuple(_hashable(c[i]) for c in cols)
            keys.setdefault(k, []).append(i)
        return {k: np.asarray(v) for k, v in keys.items()}

    # ------------------------------------------------------------------
    def clone(self) -> "MTable":
        return MTable({n: c.copy() for n, c in self._cols.items()}, self.schema)

    def __repr__(self):
        return f"MTable[{self.num_rows} rows]({self.schema.to_spec()})"

    def to_display_string(self, max_rows: int = 20) -> str:
        lines = ["\t".join(self.schema.names)]
        for i, r in enumerate(self.rows()):
            if i >= max_rows:
                lines.append(f"... ({self.num_rows} rows)")
                break
            lines.append("\t".join(_cell(v) for v in r))
        return "\n".join(lines)

    # -- (de)serialization ------------------------------------------------
    def to_json_rows(self) -> dict:
        def enc(v, t):
            if AlinkTypes.is_vector(t) or isinstance(v, (DenseVector, SparseVector)):
                return VectorUtil.to_string(VectorUtil.parse(v))
            if isinstance(v, (np.generic,)):
                return v.item()
            if isinstance(v, MTable):
                return v.to_json_rows()
            return None if _is_null(v) else v
        return {
            "schema": self.schema.to_spec(),
            "rows": [[enc(v, t) for v, t in zip(r, self.schema.types)] for r in self.rows()],
        }

    @staticmethod
    def from_json_rows(obj: dict) -> "MTable":
        schema = TableSchema.parse(obj["schema"])
        rows = []
        for r in obj["rows"]:
            out = []
            for v, t in zip(r, schema.types):
                if v is not None and AlinkTypes.is_vector(t):
                    v = VectorUtil.parse(v)
                elif v is not None and t == AlinkTypes.M_TABLE:
                    v = MTable.from_json_rows(v)
                out.append(v)
            rows.append(tuple(out))
        return MTable(rows, schema)


def _as_column(v) -> np.ndarray:
    if getattr(v, "__mtable_column__", False):
        return v  # columnar column classes duck-type the ndarray surface
    if isinstance(v, np.ndarray) and v.ndim == 1:
        return v
    v = list(v)
    if v and isinstance(v[0], (DenseVector, SparseVector, MTable)):
        out = np.empty(len(v), dtype=object)
        out[:] = v
        return out
    arr = np.asarray(v)
    if arr.ndim != 1:
        out = np.empty(len(v), dtype=object)
        out[:] = v
        return out
    if arr.dtype.kind in "US":
        out = np.empty(len(v), dtype=object)
        out[:] = [None if x is None else str(x) for x in v]
        return out
    return arr


def _infer_type(col: np.ndarray) -> str:
    if col.dtype != object:
        return AlinkTypes.from_numpy_dtype(col.dtype)
    for v in col:
        if v is None:
            continue
        return AlinkTypes.from_value(v)
    return AlinkTypes.STRING


def _concat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if getattr(a, "__mtable_column__", False):
        same = a.concat_same(b)
        if same is not None:
            return same
        a = a.materialize()
    if getattr(b, "__mtable_column__", False):
        b = b.materialize()
    if a.dtype == object or b.dtype == object:
        out = np.empty(a.shape[0] + b.shape[0], dtype=object)
        out[:a.shape[0]] = a
        out[a.shape[0]:] = b
        return out
    return np.concatenate([a, b])


def _hashable(v):
    if isinstance(v, (DenseVector, SparseVector)):
        return VectorUtil.to_string(v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _is_null(v) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v))


def _cell(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)
