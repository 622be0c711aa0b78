"""Stream source operators.

Counterpart: ``alink_tpu/operator/stream/source/sources.py``. Ported:
``BoundedTableStreamSource``, ``MemSourceStreamOp`` and
``TableSourceStreamOp``. A bounded table is chopped into timed
micro-batches: ``batch_size`` rows each, at event time ``k *
time_per_batch`` for the k-th. The file sources wait for the IO slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import Params
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
