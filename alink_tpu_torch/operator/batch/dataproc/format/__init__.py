"""Format-conversion operator matrix.

Counterpart: ``alink_tpu/operator/batch/dataproc/format/__init__.py``,
the re-design of batch/dataproc/format/ (BaseFormatTransBatchOp.java and
the named ops {Columns,Csv,Json,Kv,Vector}To{...}, TripleTo*,
AnyToTriple). One host-side core: every source format reads a row into
an ordered ``{name/index: value}`` mapping and every target format
writes that mapping out; ``FORMAT_OPS`` is generated from the read and
write tables by ``_mkop``, as there. Host Python; none takes a device.

The port's difference: a ``…ToVectorBatchOp`` given ``vector_size``
whose rows all come out sparse writes vectors, not their strings
(``SPARSE_VECTOR``): a columnar ``SparseVectorColumn`` when every row
has the same number of entries (the trainers read its index and value
arrays without a parse, as they read OneHot's and FeatureHasher's),
else one ``SparseVector`` a row. Each row's vector equals the JAX
package's string parsed. ``VectorTo…`` ops read a columnar column's
arrays directly. Everything else is the JAX package's, strings
included.
"""

from __future__ import annotations

import json as _json
from typing import Any, Dict, List

import numpy as np

from .....common.mtable import MTable
from .....common.params import ParamInfo
from .....common.types import AlinkTypes, TableSchema
from .....common.vector import (DenseVector, SparseVector,
                                SparseVectorColumn, VectorUtil)
from ....base import BatchOperator

__all__ = ["BaseFormatTransBatchOp", "FORMAT_OPS"]


def _cast(value, typ: str):
    if value is None:
        return None
    t = typ.upper()
    try:
        if t in ("DOUBLE", "FLOAT"):
            return float(value)
        if t in ("LONG", "INT", "BIGINT", "INTEGER"):
            return int(float(value))
        if t == "BOOLEAN":
            return (value if isinstance(value, bool)
                    else str(value).strip().lower() in ("true", "1"))
        return str(value)
    except (TypeError, ValueError):
        return None


# -- readers: row -> ordered dict ------------------------------------------

def _read_columns(op, t: MTable):
    cols = op.params._m.get("selected_cols") or list(t.col_names)
    data = [t.col(c) for c in cols]
    for i in range(t.num_rows):
        yield {c: data[j][i] for j, c in enumerate(cols)}


def _read_csv(op, t: MTable):
    col = op.params._m["csv_col"]
    schema = TableSchema.parse(op.params._m["schema_str"])
    delim = op.params._m.get("csv_field_delimiter", ",")
    for v in t.col(col):
        parts = str(v).split(delim) if v is not None else []
        yield {n: _cast(parts[i] if i < len(parts) else None, ty)
               for i, (n, ty) in enumerate(zip(schema.names, schema.types))}


def _read_json(op, t: MTable):
    col = op.params._m["json_col"]
    for v in t.col(col):
        try:
            d = _json.loads(v) if v is not None else {}
        except (TypeError, ValueError):
            d = {}
        yield dict(d) if isinstance(d, dict) else {}


def _read_kv(op, t: MTable):
    col = op.params._m["kv_col"]
    cd = op.params._m.get("kv_col_delimiter", ",")
    vd = op.params._m.get("kv_val_delimiter", ":")
    for v in t.col(col):
        d = {}
        if v is not None:
            for item in str(v).split(cd):
                k, sep, val = item.partition(vd)
                if sep:
                    d[k.strip()] = val
        yield d


def _read_vector(op, t: MTable):
    col = op.params._m["vector_col"]
    data = t.col(col)
    if isinstance(data, SparseVectorColumn):
        # columnar: the rows' arrays, no per-row vector objects
        for ii, vv in zip(data.idx.tolist(), data.val.tolist()):
            yield dict(zip(map(str, ii), vv))
        return
    for v in data:
        if v is None:
            yield {}
            continue
        vec = VectorUtil.parse(v)
        if isinstance(vec, SparseVector):
            yield {str(int(i)): float(x)
                   for i, x in zip(vec.indices, vec.values)}
        else:
            yield {str(i): float(x) for i, x in enumerate(vec.data)}


# -- writers: dicts -> output columns --------------------------------------

def _from_vector(op) -> bool:
    # only the Vector reader keys its dicts by component index; KV/JSON data
    # with digit keys must NOT be remapped positionally
    return getattr(op, "FROM_FORMAT", "") == "Vector"


def _write_columns(op, dicts: List[Dict], t: MTable, reserved: List[str]):
    schema = TableSchema.parse(op.params._m["schema_str"])
    cols = {c: t.col(c) for c in reserved}
    vector_in = _from_vector(op)
    for j, (n, ty) in enumerate(zip(schema.names, schema.types)):
        # vector-sourced dicts are keyed by component index: map positionally
        key = str(j) if vector_in else n
        cols[n] = [_cast(d.get(key), ty) for d in dicts]
    out_names = reserved + [n for n in schema.names]
    out_types = [t.schema.type_of(c) for c in reserved] + list(schema.types)
    return MTable(cols, TableSchema(out_names, out_types))


def _fmt_scalar(v) -> str:
    return str(v)


def _write_csv(op, dicts, t, reserved):
    out_col = op.params._m["csv_col"]
    delim = op.params._m.get("csv_field_delimiter", ",")
    schema = op.params._m.get("schema_str")
    if schema:
        keys = TableSchema.parse(schema).names
        if _from_vector(op):
            keys = [str(j) for j in range(len(keys))]  # positional
    else:
        all_keys = {k for d in dicts for k in d}
        keys = sorted(all_keys, key=int) if _from_vector(op) else sorted(all_keys)
    vals = [delim.join("" if d.get(k) is None else _fmt_scalar(d[k])
                       for k in keys) for d in dicts]
    return _with_out(op, t, reserved, out_col, vals, AlinkTypes.STRING)


def _write_json(op, dicts, t, reserved):
    out_col = op.params._m["json_col"]
    vals = [_json.dumps(d, default=str) for d in dicts]
    return _with_out(op, t, reserved, out_col, vals, AlinkTypes.STRING)


class _FloatStr(dict):
    """``str`` of a float, each value formatted once: equal floats other
    than 0.0 and NaN have one bit pattern, so their string is kept (0.0
    equals -0.0 and NaN equals nothing: those are formatted each time)."""

    def __missing__(self, v):
        s = str(v)
        if v == v and v != 0.0:
            self[v] = s
        return s


def _write_kv(op, dicts, t, reserved):
    out_col = op.params._m["kv_col"]
    cd = op.params._m.get("kv_col_delimiter", ",")
    vd = op.params._m.get("kv_val_delimiter", ":")
    # ``_fmt_scalar``'s ``str``; a float's from the cache (exact type
    # only: 1, True and 1.0 are equal keys)
    fs = _FloatStr()
    vals = [cd.join([f"{k}{vd}{fs[v] if type(v) is float else v!s}"
                     for k, v in d.items() if v is not None])
            for d in dicts]
    return _with_out(op, t, reserved, out_col, vals, AlinkTypes.STRING)


def _sparse_vectors(dicts, size: int):
    """The rows as sparse vectors of ``size``, or None when a row is
    empty or has a key that is not an index (the JAX package writes a
    dense vector there): a ``SparseVectorColumn`` when every row has
    the same number of entries, else one ``SparseVector`` a row. Each
    row's entries sorted by index (stably), as ``SparseVector`` sorts."""
    keys, vals, widths = [], [], []
    for d in dicts:
        ks = [k for k, v in d.items() if v is not None]
        if not ks:
            return None
        keys.extend(ks)
        vals.extend([v for v in d.values() if v is not None])
        widths.append(len(ks))
    keys = list(map(str, keys))
    # all digits implies digits after a leading "-": the second, slower
    # test only where the first fails
    if not (all(map(str.isdigit, keys))
            or all(k.lstrip("-").isdigit() for k in keys)):
        return None
    idx = np.array(list(map(int, keys)), np.int64)
    val = np.array(list(map(float, vals)), np.float64)
    n = len(widths)
    if len(set(widths)) > 1:
        cuts = np.cumsum(widths)[:-1]
        out = np.empty(n, object)
        out[:] = [SparseVector(size, i.tolist(), x.tolist()) for i, x in
                  zip(np.split(idx, cuts), np.split(val, cuts))]
        return out
    w = widths[0] if widths else 0
    idx, val = idx.reshape(n, w), val.reshape(n, w)
    order = np.argsort(idx, axis=1, kind="stable")
    idx = np.take_along_axis(idx, order, 1)
    val = np.take_along_axis(val, order, 1)
    if w and (idx[:, -1] >= size).any():
        bad = int(idx[:, -1].max())
        raise ValueError(f"index {bad} out of bound {size}")
    idx32 = idx.astype(np.int32)
    if not np.array_equal(idx32, idx):
        raise OverflowError("an index out of the int32 range")
    return SparseVectorColumn(idx32, val, size)


def _write_vector(op, dicts, t, reserved):
    out_col = op.params._m["vector_col"]
    size = op.params._m.get("vector_size")
    if size:
        vecs = _sparse_vectors(dicts, int(size))
        if vecs is not None:
            return _with_out(op, t, reserved, out_col, vecs,
                             AlinkTypes.SPARSE_VECTOR)
    vals = []
    for d in dicts:
        items = [(k, v) for k, v in d.items() if v is not None]
        if items and all(str(k).lstrip("-").isdigit() for k, _ in items):
            idx = [int(k) for k, _ in items]
            n = int(size) if size else (max(idx) + 1 if idx else 0)
            vals.append(str(SparseVector(n, idx, [float(v) for _, v in items])))
        else:
            vals.append(str(DenseVector([float(v) for _, v in items])))
    return _with_out(op, t, reserved, out_col, vals, AlinkTypes.STRING)


def _with_out(op, t, reserved, out_col, vals, out_type):
    cols = {c: t.col(c) for c in reserved if c != out_col}
    names = [c for c in reserved if c != out_col]
    cols[out_col] = vals
    return MTable(cols, TableSchema(
        names + [out_col],
        [t.schema.type_of(c) for c in names] + [out_type]))


_READERS = {"Columns": _read_columns, "Csv": _read_csv, "Json": _read_json,
            "Kv": _read_kv, "Vector": _read_vector}
_WRITERS = {"Columns": _write_columns, "Csv": _write_csv, "Json": _write_json,
            "Kv": _write_kv, "Vector": _write_vector}

# which input columns are "consumed" (dropped from default reserved cols)
_CONSUMED = {"Columns": "selected_cols", "Csv": "csv_col", "Json": "json_col",
             "Kv": "kv_col", "Vector": "vector_col"}


class BaseFormatTransBatchOp(BatchOperator):
    """reference: batch/dataproc/format/BaseFormatTransBatchOp.java"""
    FROM_FORMAT: str = ""
    TO_FORMAT: str = ""

    # the full param surface; each concrete op uses its subset
    SELECTED_COLS = ParamInfo("selected_cols", list, "columns to convert")
    RESERVED_COLS = ParamInfo("reserved_cols", list, "input columns to keep")
    CSV_COL = ParamInfo("csv_col", str, "csv string column")
    SCHEMA_STR = ParamInfo("schema_str", str, "schema of the converted fields")
    CSV_FIELD_DELIMITER = ParamInfo("csv_field_delimiter", str,
                                    "csv field delimiter", default=",")
    JSON_COL = ParamInfo("json_col", str, "json string column")
    KV_COL = ParamInfo("kv_col", str, "key:value string column")
    KV_COL_DELIMITER = ParamInfo("kv_col_delimiter", str,
                                 "delimiter between kv pairs", default=",")
    KV_VAL_DELIMITER = ParamInfo("kv_val_delimiter", str,
                                 "delimiter between key and value", default=":")
    VECTOR_COL = ParamInfo("vector_col", str, "vector column")
    VECTOR_SIZE = ParamInfo("vector_size", int, "sparse vector size")

    def link_from(self, in_op: BatchOperator) -> "BaseFormatTransBatchOp":
        t = in_op.get_output_table()
        consumed_key = _CONSUMED[self.FROM_FORMAT]
        consumed = self.params._m.get(consumed_key)
        consumed = (set(consumed) if isinstance(consumed, list)
                    else {consumed} if consumed else set())
        if self.FROM_FORMAT == "Columns" and not consumed:
            consumed = set(t.col_names)
        default_reserved = [c for c in t.col_names if c not in consumed]
        reserved = self.params._m.get("reserved_cols")
        if reserved is None:
            reserved = default_reserved
        else:
            reserved = [c for c in reserved if c in t.col_names]
        dicts = list(_READERS[self.FROM_FORMAT](self, t))
        self.set_output_table(
            _WRITERS[self.TO_FORMAT](self, dicts, t, reserved))
        return self


class AnyToTripleBatchOp(BaseFormatTransBatchOp):
    """reference: batch/dataproc/format/AnyToTripleBatchOp.java — expand
    each row's converted fields to (row-id, column, value) triples."""
    FROM_FORMAT = "Columns"
    TRIPLE_COLUMN_VALUE_SCHEMA_STR = ParamInfo(
        "triple_column_value_schema_str", str,
        "schema of the (column, value) output pair",
        default="column STRING, value STRING")

    def link_from(self, in_op: BatchOperator) -> "AnyToTripleBatchOp":
        t = in_op.get_output_table()
        dicts = list(_READERS[self.FROM_FORMAT](self, t))
        cv = TableSchema.parse(self.params._m.get(
            "triple_column_value_schema_str", "column STRING, value STRING"))
        reserved = self.params._m.get("reserved_cols") or []
        rows = []
        for i, d in enumerate(dicts):
            base = tuple(t.col(c)[i] for c in reserved)
            for k, v in d.items():
                if v is not None:
                    rows.append(base + (i,) + (_cast(k, cv.types[0]),
                                               _cast(v, cv.types[1])))
        names = reserved + ["row"] + cv.names
        types = ([t.schema.type_of(c) for c in reserved]
                 + [AlinkTypes.LONG] + list(cv.types))
        self.set_output_table(MTable(rows, TableSchema(names, types)))
        return self


class TripleToAnyBase(BatchOperator):
    """reference: TripleTo*BatchOp — group (row, column, value) triples back
    into rows, then write in the target format."""
    TO_FORMAT: str = ""
    TRIPLE_ROW_COL = ParamInfo("triple_row_col", str, "row-id column")
    TRIPLE_COLUMN_COL = ParamInfo("triple_column_col", str, "column-name column",
                                  optional=False)
    TRIPLE_VALUE_COL = ParamInfo("triple_value_col", str, "value column",
                                 optional=False)
    # writer params (same descriptors as BaseFormatTransBatchOp).
    # NOTE: no RESERVED_COLS — triples are grouped into rows, so the only
    # passthrough identity is the row column itself; accepting the param
    # and ignoring it would be a silent lie.
    CSV_COL = BaseFormatTransBatchOp.CSV_COL
    SCHEMA_STR = BaseFormatTransBatchOp.SCHEMA_STR
    CSV_FIELD_DELIMITER = BaseFormatTransBatchOp.CSV_FIELD_DELIMITER
    JSON_COL = BaseFormatTransBatchOp.JSON_COL
    KV_COL = BaseFormatTransBatchOp.KV_COL
    KV_COL_DELIMITER = BaseFormatTransBatchOp.KV_COL_DELIMITER
    KV_VAL_DELIMITER = BaseFormatTransBatchOp.KV_VAL_DELIMITER
    VECTOR_COL = BaseFormatTransBatchOp.VECTOR_COL
    VECTOR_SIZE = BaseFormatTransBatchOp.VECTOR_SIZE

    def link_from(self, in_op: BatchOperator) -> "TripleToAnyBase":
        t = in_op.get_output_table()
        row_col = self.params._m.get("triple_row_col")
        col_col = self.params._m["triple_column_col"]
        val_col = self.params._m["triple_value_col"]
        cols_v = t.col(col_col)
        vals_v = t.col(val_col)
        if row_col:
            rows_v = t.col(row_col)
        else:
            rows_v = [0] * t.num_rows
        order: List = []
        grouped: Dict[Any, Dict] = {}
        for r, c, v in zip(rows_v, cols_v, vals_v):
            if r not in grouped:
                grouped[r] = {}
                order.append(r)
            grouped[r][str(c)] = v
        dicts = [grouped[r] for r in order]
        # synthesize a table carrying the row ids for reserved passthrough
        row_t = MTable({"row": order},
                       TableSchema(["row"],
                                   [t.schema.type_of(row_col) if row_col
                                    else AlinkTypes.LONG]))
        reserved = ["row"] if row_col else []
        self.set_output_table(
            _WRITERS[self.TO_FORMAT](self, dicts, row_t, reserved))
        return self


# -- generate the named op matrix ------------------------------------------

# reference names the triple-grouping base TripleToAnyBatchOp; it is
# abstract (TO_FORMAT unset) so it stays out of FORMAT_OPS — the generator
# matrices must only mint concrete ops from that dict
TripleToAnyBatchOp = TripleToAnyBase

FORMAT_OPS: Dict[str, type] = {"AnyToTripleBatchOp": AnyToTripleBatchOp}


def _mkop(name: str, base: type, ns: Dict) -> type:
    # use the base's metaclass so WithParams accessor generation runs
    ns["__doc__"] = f"reference: batch/dataproc/format/{name}.java"
    ns.setdefault("__module__", __name__)
    return type(base)(name, (base,), ns)


for _src in _READERS:
    for _dst in _WRITERS:
        if _src == _dst:
            continue
        _name = f"{_src}To{_dst}BatchOp"
        FORMAT_OPS[_name] = _mkop(_name, BaseFormatTransBatchOp,
                                  {"FROM_FORMAT": _src, "TO_FORMAT": _dst})
    _name = f"{_src}ToTripleBatchOp"
    # reuse AnyToTriple's expansion with this reader
    FORMAT_OPS[_name] = _mkop(_name, AnyToTripleBatchOp,
                              {"FROM_FORMAT": _src})

for _dst in _WRITERS:
    _name = f"TripleTo{_dst}BatchOp"
    FORMAT_OPS[_name] = _mkop(_name, TripleToAnyBase, {"TO_FORMAT": _dst})

globals().update(FORMAT_OPS)
__all__ += sorted(FORMAT_OPS) + ["TripleToAnyBatchOp"]
