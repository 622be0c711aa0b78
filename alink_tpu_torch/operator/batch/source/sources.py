"""Batch source operators.

Counterpart: ``alink_tpu/operator/batch/source/sources.py``. Ported:
``BaseSourceBatchOp``, ``MemSourceBatchOp`` (the in-memory source that
carries a warm-start model table or a table of rows) and the file
sources ``CsvSourceBatchOp``, ``LibSvmSourceBatchOp`` and
``TextSourceBatchOp``; the generators ``NumSeqSourceBatchOp`` and
``RandomTableSourceBatchOp`` (the JAX package's ``RandomState`` draws,
so the tables are equal); and the database sources ``DBSourceBatchOp``
(a table or a free query of a ``BaseDB``, ``io/db.py``) and
``MySqlSourceBatchOp``. CSV files may also be http URLs
(``io/csv.py``). All run on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import ParamInfo, Params
from ....common.types import AlinkTypes, TableSchema
from ....io.csv import read_csv, read_libsvm
from ....io.sharding import resolve_shard
from ...base import BatchOperator


class BaseSourceBatchOp(BatchOperator):
    """Source base: no inputs (reference batch/source/BaseSourceBatchOp.java)."""

    def link_from(self, *inputs):
        raise RuntimeError(f"{type(self).__name__} is a source; it takes no inputs")


class MemSourceBatchOp(BaseSourceBatchOp):
    """In-memory rows source (reference MemSourceBatchOp)."""

    def __init__(self, rows, schema=None, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        if isinstance(rows, MTable):
            self._output = rows if schema is None else MTable(rows.to_rows(), schema)
        else:
            if isinstance(schema, str):
                schema = TableSchema.parse(schema)
            self._output = MTable(rows, schema)


class _FileSourceBase(BaseSourceBatchOp):
    """File sources load lazily, so fluent ``set_file_path(...)`` works.

    ``sharded=True`` makes the reader take only its own slice of the
    input (a glob shards by file, one file by newline-aligned byte range:
    ``io/sharding.py``); ``shard_index`` / ``num_shards`` override the
    default topology of one process.
    """

    SHARDED = ParamInfo("sharded", bool, default=False)
    SHARD_INDEX = ParamInfo("shard_index", int, "override shard index")
    NUM_SHARDS = ParamInfo("num_shards", int, "override shard count")

    def _shard(self):
        if not self.get_sharded():
            return None
        return resolve_shard(self.get_shard_index(), self.get_num_shards())

    def _load(self):  # pragma: no cover - interface
        raise NotImplementedError

    def get_output_table(self) -> MTable:
        if self._output is None:
            self._load()
        return super().get_output_table()


class CsvSourceBatchOp(_FileSourceBase):
    """reference: batch/source/CsvSourceBatchOp (common/io/csv/CsvUtil)."""

    FILE_PATH = ParamInfo("file_path", str, "csv path or glob", optional=False)
    SCHEMA_STR = ParamInfo("schema_str", str, "'col TYPE, col TYPE'", optional=False)
    FIELD_DELIMITER = ParamInfo("field_delimiter", str, default=",")
    QUOTE_CHAR = ParamInfo("quote_char", str, default='"')
    IGNORE_FIRST_LINE = ParamInfo("ignore_first_line", bool, default=False)

    def _load(self):
        self._output = read_csv(
            self.get_file_path(), TableSchema.parse(self.get_schema_str()),
            field_delimiter=self.get_field_delimiter(),
            quote_char=self.get_quote_char(),
            ignore_first_line=self.get_ignore_first_line(),
            shard=self._shard())


class LibSvmSourceBatchOp(_FileSourceBase):
    """reference: batch/source/LibSvmSourceBatchOp."""

    FILE_PATH = ParamInfo("file_path", str, optional=False)
    START_INDEX = ParamInfo("start_index", int, default=1)
    VECTOR_SIZE = ParamInfo("vector_size", int,
                            "fixed feature dim (required for shard-"
                            "consistent widths)")

    def _load(self):
        self._output = read_libsvm(self.get_file_path(),
                                   self.get_start_index(),
                                   shard=self._shard(),
                                   vector_size=self.get_vector_size())


class TextSourceBatchOp(_FileSourceBase):
    """One STRING column named 'text' a line (reference TextSourceBatchOp)."""

    FILE_PATH = ParamInfo("file_path", str, optional=False)
    TEXT_COL = ParamInfo("text_col", str, default="text")

    def _load(self):
        with open(self.get_file_path(), "r", encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f]
        self._output = MTable({self.get_text_col(): lines},
                              TableSchema([self.get_text_col()],
                                          [AlinkTypes.STRING]))


class NumSeqSourceBatchOp(BaseSourceBatchOp):
    """Integer sequence [from, to] (reference NumSeqSourceBatchOp)."""

    def __init__(self, from_: int = 0, to: int = 0, col_name: str = "num",
                 params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        seq = np.arange(from_, to + 1, dtype=np.int64)
        self._output = MTable({col_name: seq}, TableSchema([col_name], [AlinkTypes.LONG]))


class RandomTableSourceBatchOp(BaseSourceBatchOp):
    """Random numeric table (reference RandomTableSourceBatchOp)."""

    def __init__(self, num_rows: int, num_cols: int, seed: int = 0,
                 output_col_prefix: str = "col", params=None, **kwargs):
        super().__init__(params, **kwargs)
        rng = np.random.RandomState(seed)
        cols = {f"{output_col_prefix}{i}": rng.rand(num_rows)
                for i in range(num_cols)}
        self._output = MTable(cols)


from ....io.db import HasDB as _HasDB
from ....io.db import HasMySqlDB as _HasMySqlDB


class DBSourceBatchOp(_HasDB, BaseSourceBatchOp):
    """Read a table (or free query) from a registered BaseDB
    (reference: batch/source/DBSourceBatchOp.java over common/io/BaseDB)."""
    INPUT_TABLE_NAME = ParamInfo("input_table_name", str, "table to read")
    QUERY = ParamInfo("query", str, "free-form SELECT overriding table name")

    def link_from(self, *inputs) -> "DBSourceBatchOp":
        q = self.params._m.get("query")
        db = self._db()
        self.set_output_table(db.query(q) if q else
                              db.read_table(self.params._m["input_table_name"]))
        return self

    # sources are roots: allow use without link_from
    def get_output_table(self):
        if self._output is None:
            self.link_from()
        return self._output


class MySqlSourceBatchOp(_HasMySqlDB, DBSourceBatchOp):
    """reference: batch/source/MySqlSourceBatchOp.java"""
