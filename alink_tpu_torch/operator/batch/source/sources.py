"""Batch source operators.

Counterpart: ``alink_tpu/operator/batch/source/sources.py``. Only
``BaseSourceBatchOp`` and ``MemSourceBatchOp`` are ported: the in-memory
source that carries a warm-start model table or a table of rows. The
file, database and generator sources wait for the IO slice.
"""

from __future__ import annotations

from typing import Optional

from ....common.mtable import MTable
from ....common.params import Params
from ....common.types import TableSchema
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
