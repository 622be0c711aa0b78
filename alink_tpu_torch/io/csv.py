"""CSV and LibSVM read / write.

Counterpart: ``alink_tpu/io/csv.py`` (the reference's common/io/csv/:
CsvUtil, CsvParser, CsvFormatter): schema-aware CSV <-> ``MTable`` with
the reference's ``"col TYPE, col TYPE"`` schema strings, and LibSVM
files. Numeric CSV without quotes or empty cells, and every LibSVM file,
parse through the port's native library (``alink_tpu_torch/native``);
other CSV goes through Python's ``csv`` module. Paths are local files,
glob patterns or ``http://`` / ``https://`` URLs (read whole by
``urllib``; a sharded read of a URL is refused).
"""

from __future__ import annotations

import csv
import io
import os
from typing import Optional
from urllib.request import urlopen

import numpy as np

from ..common.mtable import MTable
from ..common.types import AlinkTypes, TableSchema
from ..common.vector import DenseVector, SparseVector, VectorUtil
from ..native import parse_libsvm_bytes_parallel, parse_numeric_csv_bytes
from .sharding import read_file_shard, shard_paths


def _parse_cell(s: str, type_: str):
    if s is None or s == "":
        return None
    t = type_.upper()
    if t in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
        return float(s)
    if t in (AlinkTypes.LONG, AlinkTypes.INT):
        return int(float(s))
    if t == AlinkTypes.BOOLEAN:
        return s.strip().lower() in ("true", "1", "t")
    if AlinkTypes.is_vector(t):
        return VectorUtil.parse(s)
    return s


def _csv_bytes_native(data: bytes, schema: TableSchema, field_delimiter: str,
                      quote_char: str) -> Optional[MTable]:
    """The numeric-only fast path through the native parser
    (``csv_dims`` / ``csv_fill``): an ``MTable``, or None when the data is
    not all numbers in the schema's columns (quotes, empty cells, other
    types, a delimiter of more than one byte)."""
    if len(field_delimiter.encode()) != 1:
        return None
    num = {AlinkTypes.DOUBLE, AlinkTypes.FLOAT, AlinkTypes.LONG, AlinkTypes.INT}
    if not all(t.upper() in num for t in schema.types):
        return None
    if quote_char.encode() in data:
        return None
    m = parse_numeric_csv_bytes(data, field_delimiter)
    if m.shape[1] != len(schema.names) or np.isnan(m).any():
        return None  # missing cells need the None-aware Python path
    cols = {}
    for j, (n, t) in enumerate(zip(schema.names, schema.types)):
        c = m[:, j]
        if t.upper() in (AlinkTypes.LONG, AlinkTypes.INT):
            c = c.astype(np.int64)
        cols[n] = c
    return MTable(cols, schema)


def _csv_bytes(data: bytes, schema: TableSchema, field_delimiter: str,
               quote_char: str, skip_blank: bool) -> MTable:
    fast = _csv_bytes_native(data, schema, field_delimiter, quote_char)
    if fast is not None:
        return fast
    reader = csv.reader(io.StringIO(data.decode("utf-8")),
                        delimiter=field_delimiter, quotechar=quote_char)
    rows = []
    for rec in reader:
        if skip_blank and not rec:
            continue
        rows.append(tuple(_parse_cell(rec[j] if j < len(rec) else None, t)
                          for j, t in enumerate(schema.types)))
    return MTable(rows, schema)


def _load_line_bytes(path: str, ignore_first_line: bool,
                     shard=None, quote_char: str = '"') -> bytes:
    """The bytes of ``path``'s lines for this reader.

    ``shard=(i, n)`` selects one reader's slice (``io/sharding.py``): a
    glob pattern shards round-robin by file, one file by newline-aligned
    byte range. The header drops from every file of a glob, and from
    shard 0 of a byte range."""
    q = quote_char.encode("utf-8") if quote_char else None

    def drop_header(b: bytes) -> bytes:
        # quote-aware: a header record whose quoted field holds a newline
        # spans physical lines, so skip lines until the quotes balance. A
        # stray quote must not swallow data: past 64 lines the input is
        # refused (a header that long is malformed, not a header)
        first_nl = b.find(b"\n")
        if first_nl < 0:
            return b""
        if q is None:
            return b[first_nl + 1:]
        pos, quotes = 0, 0
        for _ in range(64):
            nl = b.find(b"\n", pos)
            if nl < 0:
                return b[first_nl + 1:]
            quotes += b.count(q, pos, nl)
            if quotes % 2 == 0:
                return b[nl + 1:]
            pos = nl + 1
        raise ValueError(
            "header record spans >64 physical lines (unbalanced quote?); "
            "refusing to guess where the header ends")

    if path.startswith(("http://", "https://")):
        if shard is not None and shard[1] > 1:
            raise ValueError("sharded reads of http sources are unsupported")
        data = urlopen(path).read()
        return drop_header(data) if ignore_first_line else data
    if shard is None:
        with open(path, "rb") as f:
            data = f.read()
        return drop_header(data) if ignore_first_line else data
    files = shard_paths(path, *shard)
    if files is not None:
        parts = []
        for p in files:
            with open(p, "rb") as f:
                b = f.read()
            if ignore_first_line:
                b = drop_header(b)
            if b and not b.endswith(b"\n"):
                b += b"\n"
            parts.append(b)
        return b"".join(parts)
    data = read_file_shard(path, *shard)
    if ignore_first_line and shard[0] == 0:
        data = drop_header(data)
    return data


def read_csv(path: str, schema: TableSchema, field_delimiter: str = ",",
             quote_char: str = '"', skip_blank: bool = True,
             ignore_first_line: bool = False, shard=None) -> MTable:
    data = _load_line_bytes(path, ignore_first_line, shard, quote_char)
    return _csv_bytes(data, schema, field_delimiter, quote_char, skip_blank)


def _csv_cells(table: MTable):
    for row in table.rows():
        yield ["" if v is None else
               VectorUtil.to_string(VectorUtil.parse(v))
               if AlinkTypes.is_vector(t) else v
               for v, t in zip(row, table.schema.types)]


def write_csv(table: MTable, path: str, field_delimiter: str = ",",
              quote_char: str = '"', with_header: bool = False):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, delimiter=field_delimiter, quotechar=quote_char)
        if with_header:
            writer.writerow(table.col_names)
        writer.writerows(_csv_cells(table))


def format_csv_rows(table: MTable, field_delimiter: str = ",",
                    quote_char: str = '"') -> str:
    """CSV-encode a table to a string (stream sinks append a micro-batch)."""
    buf = io.StringIO()
    writer = csv.writer(buf, delimiter=field_delimiter, quotechar=quote_char)
    writer.writerows(_csv_cells(table))
    return buf.getvalue()


def format_libsvm_rows(table: MTable, label_col: str, vector_col: str,
                       start_index: int = 1) -> str:
    """LibSVM lines ``label i:v ...``, one a row. Floats print by
    ``repr``, so a parse reads back the same bits."""
    lines = []
    for lbl, vec in zip(table.col(label_col), table.col(vector_col)):
        v = VectorUtil.parse(vec)
        if isinstance(v, DenseVector):
            pairs = [(i, x) for i, x in enumerate(v.data) if x != 0]
        else:
            pairs = list(zip(v.indices, v.values))
        body = " ".join(f"{int(i) + start_index}:{x}" for i, x in pairs)
        lines.append(f"{lbl} {body}\n")
    return "".join(lines)


def read_libsvm(path: str, start_index: int = 1, shard=None,
                vector_size=None) -> MTable:
    """LibSVM lines -> (label DOUBLE, features SPARSE_VECTOR) (reference
    common/io/LibSvmSourceBatchOp), parsed by the native library in
    newline-aligned chunks on a thread pool.

    Sharded reads should pass ``vector_size``: each shard's own largest
    index would otherwise give different shards different widths."""
    data = _load_line_bytes(path, ignore_first_line=False, shard=shard)
    labels, indptr, indices, values = parse_libsvm_bytes_parallel(
        data, start_index)
    if vector_size is not None:
        max_idx = int(vector_size)
        if max_idx <= 0:
            raise ValueError(f"vector_size must be positive, got {vector_size}")
    else:
        max_idx = int(indices.max()) + 1 if indices.size else 0
    col = [SparseVector(max_idx, indices[indptr[i]:indptr[i + 1]],
                        values[indptr[i]:indptr[i + 1]])
           for i in range(len(labels))]
    return MTable({"label": labels, "features": col},
                  TableSchema(["label", "features"],
                              [AlinkTypes.DOUBLE, AlinkTypes.SPARSE_VECTOR]))


def write_libsvm(table: MTable, path: str, label_col: str, vector_col: str,
                 start_index: int = 1):
    with open(path, "w", encoding="utf-8") as f:
        f.write(format_libsvm_rows(table, label_col, vector_col, start_index))
