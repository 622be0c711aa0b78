"""User-function and utility operators.

Counterpart: ``alink_tpu/operator/batch/utils/fn_ops.py``, the
re-design of batch/utils/{UDFBatchOp, UDTFBatchOp, FlatMapBatchOp,
PrintBatchOp, DataSetWrapperBatchOp}.java. The reference registers Flink
ScalarFunction / TableFunction objects and generates a SQL clause
(UDFBatchOp.java:50-67); here, as in the JAX package, the function is a
plain Python callable applied on the host over the columnar table, with
the same selectedCols / outputCol(s) / reservedCols contract. None takes
a device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from ....common.mtable import MTable
from ....common.params import ParamInfo, Params
from ....common.types import AlinkTypes, TableSchema
from ....params.shared import (HasOutputCol, HasOutputCols, HasReservedCols,
                               HasSelectedCols)
from ...base import BatchOperator, TableSourceBatchOp

__all__ = ["UDFBatchOp", "UDTFBatchOp", "FlatMapBatchOp", "PrintBatchOp",
           "DataSetWrapperBatchOp"]


def _reserved(t: MTable, reserved: Optional[Sequence[str]], out_cols: Sequence[str]):
    cols = list(t.col_names) if reserved is None else list(reserved)
    return [c for c in cols if c not in out_cols]


class UDFBatchOp(BatchOperator, HasSelectedCols, HasOutputCol, HasReservedCols):
    """Scalar user function over selected columns (reference
    batch/utils/UDFBatchOp.java:50-67).

    ``func(*selected_values) -> value`` per row; ``output_col`` may collide
    with selected/reserved names, in which case it replaces them — the same
    column-collision contract the reference documents.
    """

    RESULT_TYPE = ParamInfo("result_type", str, default=AlinkTypes.DOUBLE)

    def __init__(self, params: Optional[Params] = None, func: Optional[Callable] = None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.func = func

    def set_func(self, func: Callable) -> "UDFBatchOp":
        self.func = func
        return self

    def link_from(self, in_op: BatchOperator) -> "UDFBatchOp":
        if self.func is None:
            raise ValueError("a function must be set with set_func")
        t = in_op.get_output_table()
        sel = self.get_selected_cols()
        out_col = self.params._m["output_col"]
        data = [t.col(c) for c in sel]
        out = np.empty(t.num_rows, object)
        out[:] = [self.func(*vals) for vals in zip(*data)] if sel else \
            [self.func() for _ in range(t.num_rows)]
        keep = _reserved(t, self.params._m.get("reserved_cols"), [out_col])
        names = keep + [out_col]
        types = [t.schema.type_of(c) for c in keep] + [self.get_result_type()]
        cols = {c: t.col(c) for c in keep}
        cols[out_col] = out
        self._output = MTable(cols, TableSchema(names, types))
        return self


class UDTFBatchOp(BatchOperator, HasSelectedCols, HasOutputCols, HasReservedCols):
    """Table user function: one row in, zero-or-more out (reference
    batch/utils/UDTFBatchOp.java:47-67).

    ``func(*selected_values) -> iterable of output tuples`` (scalars are
    treated as 1-tuples); reserved columns are replicated per emitted row.
    """

    RESULT_TYPES = ParamInfo("result_types", list, "types of output_cols")

    def __init__(self, params: Optional[Params] = None, func: Optional[Callable] = None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.func = func

    def set_func(self, func: Callable) -> "UDTFBatchOp":
        self.func = func
        return self

    def link_from(self, in_op: BatchOperator) -> "UDTFBatchOp":
        if self.func is None:
            raise ValueError("a function must be set with set_func")
        t = in_op.get_output_table()
        sel = self.get_selected_cols()
        out_cols = self.get_output_cols()
        keep = _reserved(t, self.params._m.get("reserved_cols"), out_cols)
        keep_data = [t.col(c) for c in keep]
        sel_data = [t.col(c) for c in sel]
        rows: List[tuple] = []
        for i in range(t.num_rows):
            for emitted in self.func(*(d[i] for d in sel_data)):
                if not isinstance(emitted, (tuple, list)):
                    emitted = (emitted,)
                rows.append(tuple(d[i] for d in keep_data) + tuple(emitted))
        types = ([t.schema.type_of(c) for c in keep]
                 + list(self.params._m.get("result_types")
                        or [AlinkTypes.DOUBLE] * len(out_cols)))
        self._output = MTable(rows, TableSchema(keep + list(out_cols), types))
        return self


class FlatMapBatchOp(BatchOperator):
    """Row to zero-or-more rows with a new schema (reference
    batch/utils/FlatMapBatchOp.java).

    ``func(row_tuple) -> iterable of row tuples`` in ``schema_str`` layout.
    """

    SCHEMA_STR = ParamInfo("schema_str", str, "output schema", optional=False)

    def __init__(self, params: Optional[Params] = None, func: Optional[Callable] = None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.func = func

    def set_func(self, func: Callable) -> "FlatMapBatchOp":
        self.func = func
        return self

    def link_from(self, in_op: BatchOperator) -> "FlatMapBatchOp":
        if self.func is None:
            raise ValueError("a function must be set with set_func")
        t = in_op.get_output_table()
        schema = TableSchema.parse(self.get_schema_str())
        rows: List[tuple] = []
        for row in t.to_rows():
            rows.extend(tuple(r) for r in self.func(row))
        self._output = MTable(rows, schema)
        return self


class PrintBatchOp(BatchOperator):
    """Print the input table and pass it through (reference
    batch/utils/PrintBatchOp.java)."""

    def link_from(self, in_op: BatchOperator) -> "PrintBatchOp":
        t = in_op.get_output_table()
        print(t.to_display_string())
        self._output = t
        return self


class DataSetWrapperBatchOp(TableSourceBatchOp):
    """Wrap an existing table as an operator (reference
    batch/utils/DataSetWrapperBatchOp.java wraps a DataSet<Row> + schema)."""
