"""Vector dataproc operators.

Counterpart: ``alink_tpu/operator/batch/dataproc/vector_ops.py``, the
re-design of operator/batch/dataproc/vector/ (VectorAssembler,
VectorSlice, VectorNormalize, VectorElementwiseProduct,
VectorInteraction, VectorPolynomialExpand, VectorSizeHint,
VectorToColumns, the vector scalers VectorStandardScaler,
VectorMinMaxScaler and VectorMaxAbsScaler, VectorImputer and
VectorSerialize). Host numpy, as there; none takes a device.
``VectorPolynomialExpand`` keeps the JAX package's term order
(``itertools.combinations_with_replacement`` by degree). The port's
differences: the scaler and imputer mappers declare their output schema,
so their stream twins open, and ``VectorAssemblerBatchOp`` takes an
empty table with vector columns, so its twin's probe opens (the JAX
package's do neither).
"""


from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo, Params, RangeValidator
from ....common.types import AlinkTypes, TableSchema
from ....common.vector import DenseVector, SparseVector, VectorUtil
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import SimpleModelDataConverter, decode_array, encode_array
from ....params.shared import (HasOutputCol, HasOutputCols, HasReservedCols,
                               HasSelectedCol, HasSelectedCols, HasVectorCol)
from ...base import BatchOperator
from ...common.statistics.summarizer import summarize_vector_col
from ..utils.model_map import ModelMapBatchOp


def _parse_col(t: MTable, name: str):
    return [VectorUtil.parse(v) for v in t.col(name)]


class VectorAssemblerBatchOp(BatchOperator, HasSelectedCols, HasOutputCol,
                             HasReservedCols):
    """Merge numeric/vector columns into one vector (reference VectorAssembler)."""

    def link_from(self, in_op: BatchOperator) -> "VectorAssemblerBatchOp":
        t = in_op.get_output_table()
        cols = self.get_selected_cols()
        out_col = self.params._m.get("output_col") or "assembled_vec"
        parts = []
        for c in cols:
            if AlinkTypes.is_numeric(t.schema.type_of(c)):
                parts.append(np.asarray(t.col(c), np.float64)[:, None])
            else:
                dense = [VectorUtil.parse(v).to_dense().data for v in t.col(c)]
                # an empty table (a stream twin's probe) has no width
                parts.append(np.stack(dense) if dense else np.zeros((0, 0)))
        X = np.concatenate(parts, axis=1)
        vecs = np.empty(t.num_rows, object)
        vecs[:] = [DenseVector(x) for x in X]
        helper = OutputColsHelper(t.schema, [out_col], [AlinkTypes.DENSE_VECTOR],
                                  self.params._m.get("reserved_cols"))
        self._output = helper.build_output(t, [vecs])
        return self


class VectorSliceBatchOp(BatchOperator, HasSelectedCol, HasOutputCol):
    INDICES = ParamInfo("indices", list, "indices to keep", optional=False)

    def link_from(self, in_op: BatchOperator) -> "VectorSliceBatchOp":
        t = in_op.get_output_table()
        c = self.get_selected_col()
        idx = np.asarray(self.get_indices(), np.int64)
        out_col = self.params._m.get("output_col") or c
        vecs = np.empty(t.num_rows, object)
        for i, v in enumerate(_parse_col(t, c)):
            vecs[i] = DenseVector(v.to_dense().data[idx])
        helper = OutputColsHelper(t.schema, [out_col], [AlinkTypes.DENSE_VECTOR])
        self._output = helper.build_output(t, [vecs])
        return self


class VectorNormalizeBatchOp(BatchOperator, HasSelectedCol, HasOutputCol):
    P = ParamInfo("p", float, default=2.0)

    def link_from(self, in_op: BatchOperator) -> "VectorNormalizeBatchOp":
        t = in_op.get_output_table()
        c = self.get_selected_col()
        out_col = self.params._m.get("output_col") or c
        p = self.get_p()
        vecs = np.empty(t.num_rows, object)
        src = _parse_col(t, c)
        for i, v in enumerate(src):
            vecs[i] = v.normalize(p)
        out_type = t.schema.type_of(c) if AlinkTypes.is_vector(t.schema.type_of(c)) \
            else AlinkTypes.DENSE_VECTOR
        helper = OutputColsHelper(t.schema, [out_col], [out_type])
        self._output = helper.build_output(t, [vecs])
        return self


class VectorElementwiseProductBatchOp(BatchOperator, HasSelectedCol, HasOutputCol):
    SCALING_VECTOR = ParamInfo("scaling_vector", str, "vector string to multiply by",
                               optional=False)

    def link_from(self, in_op: BatchOperator) -> "VectorElementwiseProductBatchOp":
        t = in_op.get_output_table()
        c = self.get_selected_col()
        out_col = self.params._m.get("output_col") or c
        scale = VectorUtil.parse(self.get_scaling_vector()).to_dense().data
        vecs = np.empty(t.num_rows, object)
        for i, v in enumerate(_parse_col(t, c)):
            if isinstance(v, SparseVector):
                vecs[i] = SparseVector(v.n, v.indices.copy(),
                                       v.values * scale[v.indices])
            else:
                vecs[i] = DenseVector(v.data * scale[:v.size()])
        helper = OutputColsHelper(t.schema, [out_col], [t.schema.type_of(c)])
        self._output = helper.build_output(t, [vecs])
        return self


class VectorInteractionBatchOp(BatchOperator, HasSelectedCols, HasOutputCol):
    """Outer-product interaction of two vector columns (reference VectorInteraction)."""

    def link_from(self, in_op: BatchOperator) -> "VectorInteractionBatchOp":
        t = in_op.get_output_table()
        c1, c2 = self.get_selected_cols()
        out_col = self.params._m.get("output_col") or "interaction"
        v1 = _parse_col(t, c1)
        v2 = _parse_col(t, c2)
        vecs = np.empty(t.num_rows, object)
        for i in range(t.num_rows):
            a, b = v1[i].to_dense().data, v2[i].to_dense().data
            vecs[i] = DenseVector(np.outer(a, b).reshape(-1))
        helper = OutputColsHelper(t.schema, [out_col], [AlinkTypes.DENSE_VECTOR])
        self._output = helper.build_output(t, [vecs])
        return self


class VectorPolynomialExpandBatchOp(BatchOperator, HasSelectedCol, HasOutputCol):
    DEGREE = ParamInfo("degree", int, default=2, validator=RangeValidator(1, None))

    def link_from(self, in_op: BatchOperator) -> "VectorPolynomialExpandBatchOp":
        from itertools import combinations_with_replacement
        t = in_op.get_output_table()
        c = self.get_selected_col()
        out_col = self.params._m.get("output_col") or c
        deg = self.get_degree()
        vecs = np.empty(t.num_rows, object)
        for i, v in enumerate(_parse_col(t, c)):
            x = v.to_dense().data
            terms = []
            for d in range(1, deg + 1):
                for combo in combinations_with_replacement(range(len(x)), d):
                    terms.append(np.prod(x[list(combo)]))
            vecs[i] = DenseVector(np.asarray(terms))
        helper = OutputColsHelper(t.schema, [out_col], [AlinkTypes.DENSE_VECTOR])
        self._output = helper.build_output(t, [vecs])
        return self


class VectorSizeHintBatchOp(BatchOperator, HasSelectedCol, HasOutputCol):
    SIZE = ParamInfo("size", int, optional=False)
    HANDLE_INVALID = ParamInfo("handle_invalid_method", str, default="error",
                               validator=InValidator(["error", "skip", "optimistic"]))

    def link_from(self, in_op: BatchOperator) -> "VectorSizeHintBatchOp":
        t = in_op.get_output_table()
        c = self.get_selected_col()
        size = self.get_size()
        keep = []
        for i, v in enumerate(_parse_col(t, c)):
            n = v.size() if not isinstance(v, SparseVector) or v.n >= 0 else size
            if n == size or self.get_handle_invalid_method() == "optimistic":
                keep.append(i)
            elif self.get_handle_invalid_method() == "error":
                raise ValueError(f"row {i}: vector size {n} != hint {size}")
        self._output = t.take_rows(keep)
        return self


class VectorToColumnsBatchOp(BatchOperator, HasSelectedCol, HasOutputCols,
                             HasReservedCols):
    """Split a vector column into numeric columns (reference format ops)."""

    def link_from(self, in_op: BatchOperator) -> "VectorToColumnsBatchOp":
        t = in_op.get_output_table()
        c = self.get_selected_col()
        dense = np.stack([v.to_dense().data for v in _parse_col(t, c)])
        out_cols = self.params._m.get("output_cols") or \
            [f"v{i}" for i in range(dense.shape[1])]
        helper = OutputColsHelper(t.schema, out_cols,
                                  [AlinkTypes.DOUBLE] * len(out_cols),
                                  self.params._m.get("reserved_cols"))
        self._output = helper.build_output(t, list(dense.T))
        return self


# -- vector scalers ---------------------------------------------------------

class _VectorScalerConverter(SimpleModelDataConverter):
    def serialize_model(self, model):
        kind, stats = model
        return Params({"kind": kind}), [json.dumps({k: v.tolist()
                                                    for k, v in stats.items()})]

    def deserialize_model(self, meta, data):
        return meta._m["kind"], {k: np.asarray(v, np.float64)
                                 for k, v in json.loads(data[0]).items()}


class _VectorScalerTrainBase(BatchOperator, HasSelectedCol, HasVectorCol):
    KIND = ""

    def link_from(self, in_op: BatchOperator):
        t = in_op.get_output_table()
        col = self.params._m.get("selected_col") or self.params._m.get("vector_col")
        s = summarize_vector_col(t, col)
        stats = self._stats(s)
        self._output = _VectorScalerConverter().save_model((self.KIND, stats))
        return self

    def _stats(self, s):
        raise NotImplementedError


class VectorStandardScalerTrainBatchOp(_VectorScalerTrainBase):
    KIND = "standard"

    def _stats(self, s):
        return {"mean": s.mean(), "std": s.standard_deviation()}


class VectorMinMaxScalerTrainBatchOp(_VectorScalerTrainBase):
    KIND = "minmax"

    def _stats(self, s):
        return {"min": s.min(), "max": s.max()}


class VectorMaxAbsScalerTrainBatchOp(_VectorScalerTrainBase):
    KIND = "maxabs"

    def _stats(self, s):
        return {"maxabs": np.maximum(np.abs(s.min()), np.abs(s.max()))}


class VectorScalerModelMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.kind = None
        self.stats = None

    def load_model(self, model_table: MTable):
        self.kind, self.stats = _VectorScalerConverter().load_model(model_table)

    def get_output_schema(self):
        col = self.params._m.get("selected_col") or self.params._m.get("vector_col")
        out_col = self.params._m.get("output_col") or col
        return OutputColsHelper(self.data_schema, [out_col],
                                [AlinkTypes.DENSE_VECTOR]).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        col = self.params._m.get("selected_col") or self.params._m.get("vector_col")
        out_col = self.params._m.get("output_col") or col
        vecs = np.empty(data.num_rows, object)
        for i, v in enumerate(_parse_col(data, col)):
            x = v.to_dense().data
            d = len(x)
            if self.kind == "standard":
                std = np.where(self.stats["std"][:d] > 0, self.stats["std"][:d], 1.0)
                y = (x - self.stats["mean"][:d]) / std
            elif self.kind == "minmax":
                span = self.stats["max"][:d] - self.stats["min"][:d]
                y = (x - self.stats["min"][:d]) / np.where(span > 0, span, 1.0)
            else:
                ma = np.where(self.stats["maxabs"][:d] > 0, self.stats["maxabs"][:d], 1.0)
                y = x / ma
            vecs[i] = DenseVector(y)
        helper = OutputColsHelper(data.schema, [out_col], [AlinkTypes.DENSE_VECTOR])
        return helper.build_output(data, [vecs])


class VectorStandardScalerPredictBatchOp(ModelMapBatchOp, HasSelectedCol,
                                         HasVectorCol, HasOutputCol):
    MAPPER_CLS = VectorScalerModelMapper


class VectorMinMaxScalerPredictBatchOp(VectorStandardScalerPredictBatchOp):
    pass


class VectorMaxAbsScalerPredictBatchOp(VectorStandardScalerPredictBatchOp):
    pass


# -- vector imputer ---------------------------------------------------------

class VectorImputerTrainBatchOp(BatchOperator, HasSelectedCol, HasVectorCol):
    """Fill-value model over a vector column (reference
    dataproc/vector/VectorImputerTrainBatchOp over
    VectorImputerModelDataConverter.java; strategies MEAN/MIN/MAX/VALUE)."""

    STRATEGY = ParamInfo("strategy", str, default="MEAN",
                         validator=InValidator(["MEAN", "MIN", "MAX", "VALUE"]))
    FILL_VALUE = ParamInfo("fill_value", float, "fill for strategy VALUE")

    def link_from(self, in_op: BatchOperator) -> "VectorImputerTrainBatchOp":
        t = in_op.get_output_table()
        col = self.params._m.get("selected_col") or self.params._m.get("vector_col")
        strategy = self.get_strategy().upper()
        if strategy == "VALUE":
            fill = np.asarray([self.params._m["fill_value"]], np.float64)
        else:
            # NaN-aware per-component stats (the summarizer assumes finite data)
            X = np.stack([v.to_dense().data for v in _parse_col(t, col)])
            with np.errstate(invalid="ignore"):
                fill = {"MEAN": np.nanmean, "MIN": np.nanmin,
                        "MAX": np.nanmax}[strategy](X, axis=0)
        self._output = _VectorScalerConverter().save_model(
            ("imputer:" + strategy, {"fill": np.asarray(fill, np.float64)}))
        return self


class VectorImputerModelMapper(ModelMapper):
    """reference: dataproc/vector/VectorImputerModelMapper.java — replace
    NaN entries with the trained fill values."""

    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.fill = None
        self.strategy = None

    def load_model(self, model_table: MTable):
        tag, stats = _VectorScalerConverter().load_model(model_table)
        self.strategy = tag.split(":", 1)[1] if ":" in tag else tag
        self.fill = stats["fill"]

    def get_output_schema(self):
        col = self.params._m.get("selected_col") or self.params._m.get("vector_col")
        out_col = self.params._m.get("output_col") or col
        return OutputColsHelper(self.data_schema, [out_col],
                                [self.data_schema.type_of(col)]
                                ).get_output_schema()

    def _fill_at(self, idx: np.ndarray, row: int) -> np.ndarray:
        fill = self.fill
        if self.strategy == "VALUE":  # one scalar for every component
            return np.full(len(idx), fill[0])
        if idx.size and int(idx.max()) >= len(fill):
            raise ValueError(
                f"row {row}: vector component {int(idx.max())} has no trained "
                f"fill value (model was fit on {len(fill)}-dim vectors)")
        return fill[idx]

    def map_table(self, data: MTable) -> MTable:
        col = self.params._m.get("selected_col") or self.params._m.get("vector_col")
        out_col = self.params._m.get("output_col") or col
        vecs = np.empty(data.num_rows, object)
        for i, v in enumerate(_parse_col(data, col)):
            if isinstance(v, SparseVector):
                bad = ~np.isfinite(v.values)
                if bad.any():
                    vals = v.values.copy()
                    vals[bad] = self._fill_at(v.indices[bad], i)
                    vecs[i] = SparseVector(v.n, v.indices.copy(), vals)
                else:
                    vecs[i] = v
            else:
                x = v.data
                bad = ~np.isfinite(x)
                if bad.any():
                    x = x.copy()
                    x[bad] = self._fill_at(np.nonzero(bad)[0], i)
                vecs[i] = DenseVector(x)
        helper = OutputColsHelper(data.schema, [out_col],
                                  [data.schema.type_of(col)])
        return helper.build_output(data, [vecs])


class VectorImputerPredictBatchOp(ModelMapBatchOp, HasSelectedCol, HasVectorCol,
                                  HasOutputCol):
    MAPPER_CLS = VectorImputerModelMapper


class VectorSerializeBatchOp(BatchOperator):
    """Format every vector-typed column to its string literal (reference
    batch/utils/VectorSerializeBatchOp.java / VectorSerializeMapper)."""

    def link_from(self, in_op: BatchOperator) -> "VectorSerializeBatchOp":
        t = in_op.get_output_table()
        cols = {}
        types = []
        for c in t.col_names:
            ty = t.schema.type_of(c)
            if AlinkTypes.is_vector(ty):
                col = np.empty(t.num_rows, object)
                col[:] = [None if v is None else VectorUtil.to_string(
                    VectorUtil.parse(v)) for v in t.col(c)]
                cols[c] = col
                types.append(AlinkTypes.STRING)
            else:
                cols[c] = t.col(c)
                types.append(ty)
        self._output = MTable(cols, TableSchema(list(t.col_names), types))
        return self
