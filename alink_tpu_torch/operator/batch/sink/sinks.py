"""Batch sink operators.

Counterpart: ``alink_tpu/operator/batch/sink/sinks.py``. Ported: the
file sinks ``CsvSinkBatchOp``, ``LibSvmSinkBatchOp`` and
``TextSinkBatchOp`` on ``BaseSinkBatchOp``; ``MemSinkBatchOp`` (the
rows in host memory); and the database sinks ``DBSinkBatchOp`` (into a
``BaseDB`` table, ``io/db.py``) and ``MySqlSinkBatchOp``. All pass the
table through.
"""

from __future__ import annotations

from typing import List, Optional

from ....common.mtable import MTable
from ....common.params import ParamInfo, Params
from ....io.csv import write_csv, write_libsvm
from ...base import BatchOperator


class BaseSinkBatchOp(BatchOperator):
    """Common sink shape (reference batch/sink/BaseSinkBatchOp.java):
    write the input out with ``_sink`` and pass the table through."""

    def _sink(self, t: MTable) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def link_from(self, in_op: BatchOperator) -> "BaseSinkBatchOp":
        t = in_op.get_output_table()
        self._sink(t)
        self._output = t
        return self


class CsvSinkBatchOp(BaseSinkBatchOp):
    FILE_PATH = ParamInfo("file_path", str, optional=False)
    FIELD_DELIMITER = ParamInfo("field_delimiter", str, default=",")
    WITH_HEADER = ParamInfo("with_header", bool, default=False)

    def _sink(self, t: MTable) -> None:
        write_csv(t, self.get_file_path(),
                  field_delimiter=self.get_field_delimiter(),
                  with_header=self.get_with_header())


class LibSvmSinkBatchOp(BaseSinkBatchOp):
    FILE_PATH = ParamInfo("file_path", str, optional=False)
    LABEL_COL = ParamInfo("label_col", str, optional=False)
    VECTOR_COL = ParamInfo("vector_col", str, optional=False)

    def _sink(self, t: MTable) -> None:
        write_libsvm(t, self.get_file_path(), self.get_label_col(),
                     self.get_vector_col())


class TextSinkBatchOp(BaseSinkBatchOp):
    """Write a one-column table as plain lines (reference
    batch/sink/TextSinkBatchOp.java: exactly one input column)."""

    FILE_PATH = ParamInfo("file_path", str, optional=False)

    def _sink(self, t: MTable) -> None:
        if len(t.col_names) != 1:
            raise ValueError(
                f"TextSink requires exactly one column, got {t.col_names}")
        with open(self.get_file_path(), "w") as f:
            for v in t.col(t.col_names[0]):
                f.write(("" if v is None else str(v)) + "\n")


class MemSinkBatchOp(BatchOperator):
    """Collect rows into host memory (reference MemSinkBatchOp / CollectHelper)."""

    def __init__(self, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self.rows: List[tuple] = []

    def link_from(self, in_op: BatchOperator) -> "MemSinkBatchOp":
        self._output = in_op.get_output_table()
        self.rows = self._output.to_rows()
        return self


from ....io.db import HasDB as _HasDB
from ....io.db import HasMySqlDB as _HasMySqlDB


class DBSinkBatchOp(_HasDB, BatchOperator):
    """Write the input table into a registered BaseDB
    (reference: batch/sink/DBSinkBatchOp.java)."""
    OUTPUT_TABLE_NAME = ParamInfo("output_table_name", str, optional=False)
    OVERWRITE_SINK = ParamInfo("overwrite_sink", bool, default=False)

    def link_from(self, in_op: BatchOperator) -> "DBSinkBatchOp":
        t = in_op.get_output_table()
        self._db().write_table(self.params._m["output_table_name"], t,
                               append=not self.params._m.get("overwrite_sink",
                                                             False))
        self.set_output_table(t)
        return self


class MySqlSinkBatchOp(_HasMySqlDB, DBSinkBatchOp):
    """reference: batch/sink/MySqlSinkBatchOp.java"""
