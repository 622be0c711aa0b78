"""Stream source operators.

Counterpart: ``alink_tpu/operator/stream/source/sources.py``. Ported:
``BoundedTableStreamSource``, ``MemSourceStreamOp``,
``TableSourceStreamOp`` and the file sources ``CsvSourceStreamOp``,
``LibSvmSourceStreamOp`` and ``TextSourceStreamOp``. A bounded table is
chopped into timed micro-batches: ``batch_size`` rows each, at event time
``k * time_per_batch`` for the k-th. The generators
``NumSeqSourceStreamOp`` and ``RandomTableSourceStreamOp`` draw as the
JAX package's do, so the tables are equal; ``DBSourceStreamOp`` and
``MySqlSourceStreamOp`` read a ``BaseDB`` table or query at their first
drain. The Kafka and Hive stream sources are in ``io/kafka.py`` and
``io/hive.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import Params
from ....common.types import TableSchema
from ....io.csv import read_csv, read_libsvm
from ...base import BatchOperator, StreamOperator


class BoundedTableStreamSource(StreamOperator):
    """Base: replayable stream over a host table."""

    def __init__(self, params: Optional[Params] = None, batch_size: int = 256,
                 time_per_batch: float = 1.0, **kwargs):
        super().__init__(params, **kwargs)
        self.batch_size = int(batch_size)
        self.time_per_batch = float(time_per_batch)
        self._table: Optional[MTable] = None

    def _resolve(self) -> MTable:
        if self._table is None:
            raise RuntimeError(f"{type(self).__name__} has no table")
        return self._table

    def _set_table(self, table: MTable):
        self._table = table
        self._schema = table.schema

        def gen():
            t = self._resolve()
            n = t.num_rows
            b = max(1, self.batch_size)
            for k, start in enumerate(range(0, n, b)):
                yield (k * self.time_per_batch,
                       t.take_rows(np.arange(start, min(start + b, n))))

        self._stream_fn = gen
        return self

    def link_from(self, *inputs):
        raise RuntimeError(f"{type(self).__name__} is a source; it takes no inputs")


class MemSourceStreamOp(BoundedTableStreamSource):
    """reference: stream/source/MemSourceStreamOp."""

    def __init__(self, rows, schema=None, batch_size: int = 256,
                 time_per_batch: float = 1.0, params=None, **kwargs):
        super().__init__(params, batch_size, time_per_batch, **kwargs)
        table = rows if isinstance(rows, MTable) else MTable(rows, schema)
        self._set_table(table)


class TableSourceStreamOp(BoundedTableStreamSource):
    """Stream view of a batch table / operator (reference TableSourceStreamOp;
    also the batch→stream hand-off used all over the reference examples)."""

    def __init__(self, table, batch_size: int = 256, time_per_batch: float = 1.0,
                 params=None, **kwargs):
        super().__init__(params, batch_size, time_per_batch, **kwargs)
        if isinstance(table, BatchOperator):
            table = table.get_output_table()
        self._set_table(table)


class CsvSourceStreamOp(BoundedTableStreamSource):
    """reference: stream/source/CsvSourceStreamOp."""

    def __init__(self, file_path: str, schema_str: str, field_delimiter: str = ",",
                 batch_size: int = 256, time_per_batch: float = 1.0,
                 params=None, **kwargs):
        super().__init__(params, batch_size, time_per_batch, **kwargs)
        self._set_table(read_csv(file_path, TableSchema.parse(schema_str),
                                 field_delimiter))


class LibSvmSourceStreamOp(BoundedTableStreamSource):
    """reference: stream/source/LibSvmSourceStreamOp."""

    def __init__(self, file_path: str, batch_size: int = 256,
                 time_per_batch: float = 1.0, params=None, **kwargs):
        super().__init__(params, batch_size, time_per_batch, **kwargs)
        self._set_table(read_libsvm(file_path))


class TextSourceStreamOp(BoundedTableStreamSource):
    """reference: stream/source/TextSourceStreamOp (one 'text' column)."""

    def __init__(self, file_path: str, text_col: str = "text", batch_size: int = 256,
                 time_per_batch: float = 1.0, params=None, **kwargs):
        super().__init__(params, batch_size, time_per_batch, **kwargs)
        with open(file_path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        self._set_table(MTable({text_col: lines}))


class NumSeqSourceStreamOp(BoundedTableStreamSource):
    """reference: stream/source/NumSeqSourceStreamOp."""

    def __init__(self, from_: int, to: int, col_name: str = "num",
                 batch_size: int = 256, time_per_batch: float = 1.0,
                 params=None, **kwargs):
        super().__init__(params, batch_size, time_per_batch, **kwargs)
        self._set_table(MTable({col_name: np.arange(from_, to + 1, dtype=np.int64)}))


class RandomTableSourceStreamOp(BoundedTableStreamSource):
    """reference: stream/source/RandomTableSourceStreamOp (numeric columns)."""

    def __init__(self, num_rows: int, num_cols: int, seed: int = 0,
                 batch_size: int = 256, time_per_batch: float = 1.0,
                 params=None, **kwargs):
        super().__init__(params, batch_size, time_per_batch, **kwargs)
        rng = np.random.default_rng(seed)
        cols = {f"col{i}": rng.random(num_rows) for i in range(num_cols)}
        self._set_table(MTable(cols))


# the reference's abstract base name for all stream sources
BaseSourceStreamOp = BoundedTableStreamSource


from ....io.db import HasDB as _HasDB
from ....io.db import HasMySqlDB as _HasMySqlDB
from ....common.params import ParamInfo as _ParamInfo


class DBSourceStreamOp(_HasDB, BoundedTableStreamSource):
    """Stream a DB table as micro-batches
    (reference: stream/source/DBSourceStreamOp.java)."""
    INPUT_TABLE_NAME = _ParamInfo("input_table_name", str, "table to read")
    QUERY = _ParamInfo("query", str, "free-form SELECT overriding table name")

    def _resolve(self) -> MTable:
        if self._table is None:
            q = self.params._m.get("query")
            db = self._db()
            table = (db.query(q) if q else
                     db.read_table(self.params._m["input_table_name"]))
            self._set_table(table)
        return self._table

    def timed_batches(self):
        self._resolve()
        return super().timed_batches()

    def get_schema(self):
        self._resolve()
        return super().get_schema()


class MySqlSourceStreamOp(_HasMySqlDB, DBSourceStreamOp):
    """reference: stream/source/MySqlSourceStreamOp.java"""
