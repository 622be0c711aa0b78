"""Batch source operators.

Counterpart: ``alink_tpu/operator/batch/source/sources.py``. Ported:
``BaseSourceBatchOp``, ``MemSourceBatchOp`` (the in-memory source that
carries a warm-start model table or a table of rows) and the file
sources ``CsvSourceBatchOp``, ``LibSvmSourceBatchOp`` and
``TextSourceBatchOp``. The database and generator sources are not
ported yet (ROADMAP A8).
"""

from __future__ import annotations

from typing import Optional

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
