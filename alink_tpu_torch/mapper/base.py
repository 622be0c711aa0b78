"""Mapper / model-serving layer.

PyTorch port: a copy of ``alink_tpu/mapper/base.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

Re-design of the reference mapper stack (common/mapper/Mapper.java,
ModelMapper + ModelMapperAdapter.java:36-45, OutputColsHelper).

TPU-first change: the primary interface is **batched** —
``map_table(MTable) -> MTable`` — so model application can jit one device
kernel over the whole batch instead of the reference's per-row ``map(Row)``
(ModelMapperAdapter.java:42-45). A per-row ``map_row`` remains for
LocalPredictor-style embedded serving and defaults to a 1-row table trip.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..common.mtable import MTable
from ..common.params import Params, WithParams
from ..common.types import TableSchema


class OutputColsHelper:
    """Merge reserved input columns with mapper output columns.

    reference: common/utils/OutputColsHelper.java — output schema =
    reserved cols (default: all input cols) + appended/overwritten
    output cols.
    """

    def __init__(self, data_schema: TableSchema, output_cols: Sequence[str],
                 output_types: Sequence[str], reserved_cols: Optional[Sequence[str]] = None):
        self.data_schema = data_schema
        self.output_cols = list(output_cols)
        self.output_types = list(output_types)
        if reserved_cols is None:
            reserved_cols = [c for c in data_schema.names]
        self.reserved_cols = [c for c in reserved_cols if c not in set(self.output_cols)]

    def get_output_schema(self) -> TableSchema:
        names = self.reserved_cols + self.output_cols
        types = ([self.data_schema.type_of(c) for c in self.reserved_cols]
                 + self.output_types)
        return TableSchema(names, types)

    def build_output(self, data: MTable, out_columns: Sequence[Any]) -> MTable:
        cols = {c: data.col(c) for c in self.reserved_cols}
        for name, values in zip(self.output_cols, out_columns):
            cols[name] = values
        return MTable(cols, self.get_output_schema())


class Mapper(WithParams):
    """Stateless row/batch transformer (reference common/mapper/Mapper.java)."""

    def __init__(self, data_schema: TableSchema, params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self.data_schema = data_schema

    def get_output_schema(self) -> TableSchema:  # pragma: no cover - interface
        raise NotImplementedError

    def map_table(self, data: MTable) -> MTable:  # pragma: no cover - interface
        raise NotImplementedError

    def map_row(self, row: Tuple) -> Tuple:
        """Single-row path for embedded serving; default via 1-row batch."""
        one = MTable([row], self.data_schema)
        return self.map_table(one).row(0)

    def serving_kernel(self, ship_dtype=None):
        """The mapper's serving contract, or ``None``.

        Mappers whose scoring splits into (host encode -> device score
        -> host decode) return a
        :class:`alink_tpu_torch.serving.predictor.ServingKernel` whose
        model arrays are in ``ship_dtype``. ``None`` (the default) keeps
        the mapper on the host path."""
        return None


class ModelMapper(Mapper):
    """Mapper initialized from model rows (reference ModelMapper.loadModel,
    common/mapper/ModelMapperAdapter.java:36-40)."""

    def __init__(self, model_schema: TableSchema, data_schema: TableSchema,
                 params: Optional[Params] = None, **kwargs):
        super().__init__(data_schema, params, **kwargs)
        self.model_schema = model_schema

    def load_model(self, model_table: MTable):  # pragma: no cover - interface
        raise NotImplementedError

    def _pred_output_schema(self, label_type: str,
                            regression: bool) -> TableSchema:
        """The standard prediction-output contract: a prediction column
        (DOUBLE for regression, the model's label type otherwise), an
        optional STRING detail column for classifiers, reserved input
        columns merged by :class:`OutputColsHelper`. One implementation
        so a mapper's declared schema (the stream twins' ``_open``) can
        never drift from what its emit path builds."""
        from ..common.types import AlinkTypes
        pred_col = self.params._m.get("prediction_col", "pred")
        detail_col = self.params._m.get("prediction_detail_col")
        reserved = self.params._m.get("reserved_cols")
        if regression:
            cols, types = [pred_col], [AlinkTypes.DOUBLE]
        else:
            cols, types = [pred_col], [label_type]
            if detail_col:
                cols.append(detail_col)
                types.append(AlinkTypes.STRING)
        return OutputColsHelper(self.data_schema, cols, types,
                                reserved).get_output_schema()
