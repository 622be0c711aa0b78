"""Scaler and imputer operators (the column family).

Counterpart: ``alink_tpu/operator/batch/dataproc/scalers.py``, ported
whole: the StandardScaler, MinMaxScaler, MaxAbsScaler and Imputer train
and predict ops (the reference's common/dataproc train/predict pairs
and their model converters), which share ``_ColScalerMapper`` and one
model converter. Fit is one summarizer pass; transform is vectorized
column arithmetic in float64, operation for operation the JAX
package's.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo, Params
from ....common.types import AlinkTypes, TableSchema
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import SimpleModelDataConverter
from ....params.shared import HasOutputCols, HasSelectedCols
from ...base import BatchOperator
from ...common.statistics.summarizer import summarize_table
from ..utils.model_map import ModelMapBatchOp


class _ColScalerModel:
    def __init__(self, kind: str, cols: List[str], stats: Dict[str, np.ndarray],
                 extra: Optional[Dict] = None):
        self.kind = kind
        self.cols = cols
        self.stats = stats      # name -> array of per-col constants
        self.extra = extra or {}


class _ColScalerConverter(SimpleModelDataConverter):
    def serialize_model(self, m: _ColScalerModel):
        meta = Params({"kind": m.kind, "cols": m.cols, **m.extra})
        return meta, [json.dumps({k: v.tolist() for k, v in m.stats.items()})]

    def deserialize_model(self, meta: Params, data):
        stats = {k: np.asarray(v, np.float64)
                 for k, v in json.loads(data[0]).items()}
        extra = {k: v for k, v in meta._m.items() if k not in ("kind", "cols")}
        return _ColScalerModel(meta._m["kind"], list(meta._m["cols"]), stats, extra)


class _ColScalerMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model: Optional[_ColScalerModel] = None

    def load_model(self, model_table: MTable):
        self.model = _ColScalerConverter().load_model(model_table)

    def get_output_schema(self) -> TableSchema:
        out_cols = self.params._m.get("output_cols") or self.model.cols
        return OutputColsHelper(self.data_schema, out_cols,
                                [AlinkTypes.DOUBLE] * len(out_cols)).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        out_cols = self.params._m.get("output_cols") or m.cols
        outs = []
        for i, c in enumerate(m.cols):
            v = np.asarray(data.col(c), np.float64)
            outs.append(_transform_col(m, i, v))
        helper = OutputColsHelper(data.schema, out_cols,
                                  [AlinkTypes.DOUBLE] * len(out_cols))
        return helper.build_output(data, outs)


def _transform_col(m: _ColScalerModel, i: int, v: np.ndarray) -> np.ndarray:
    if m.kind == "standard":
        mean, std = m.stats["mean"][i], m.stats["std"][i]
        if not m.extra.get("with_mean", True):
            mean = 0.0
        if not m.extra.get("with_std", True):
            return v - mean
        return (v - mean) / (std if std > 0 else 1.0)
    if m.kind == "minmax":
        mn, mx = m.stats["min"][i], m.stats["max"][i]
        lo, hi = m.extra.get("min_out", 0.0), m.extra.get("max_out", 1.0)
        span = mx - mn
        scaled = (v - mn) / (span if span > 0 else 1.0)
        return scaled * (hi - lo) + lo
    if m.kind == "maxabs":
        ma = m.stats["maxabs"][i]
        return v / (ma if ma > 0 else 1.0)
    if m.kind == "imputer":
        fill = m.stats["fill"][i]
        return np.where(np.isnan(v), fill, v)
    raise ValueError(m.kind)


class _ColScalerTrainBase(BatchOperator, HasSelectedCols):
    KIND = ""

    def _fit_stats(self, t: MTable, cols: List[str]) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _extra(self) -> Dict:
        return {}

    def link_from(self, in_op: BatchOperator):
        t = in_op.get_output_table()
        cols = self.get_selected_cols()
        if not cols:
            cols = [n for n, tp in zip(t.schema.names, t.schema.types)
                    if AlinkTypes.is_numeric(tp)]
        stats = self._fit_stats(t, cols)
        model = _ColScalerModel(self.KIND, cols, stats, self._extra())
        self._output = _ColScalerConverter().save_model(model)
        return self


class StandardScalerTrainBatchOp(_ColScalerTrainBase):
    """reference: dataproc/StandardScalerTrainBatchOp"""
    KIND = "standard"
    WITH_MEAN = ParamInfo("with_mean", bool, default=True)
    WITH_STD = ParamInfo("with_std", bool, default=True)

    def _fit_stats(self, t, cols):
        s = summarize_table(t, cols)
        return {"mean": np.asarray([s.mean(c) for c in cols]),
                "std": np.asarray([s.standard_deviation(c) for c in cols])}

    def _extra(self):
        return {"with_mean": self.get_with_mean(), "with_std": self.get_with_std()}


class MinMaxScalerTrainBatchOp(_ColScalerTrainBase):
    KIND = "minmax"
    MIN = ParamInfo("min_out", float, default=0.0, aliases=("min",))
    MAX = ParamInfo("max_out", float, default=1.0, aliases=("max",))

    def _fit_stats(self, t, cols):
        s = summarize_table(t, cols)
        return {"min": np.asarray([s.min(c) for c in cols]),
                "max": np.asarray([s.max(c) for c in cols])}

    def _extra(self):
        return {"min_out": self.get_min_out(), "max_out": self.get_max_out()}


class MaxAbsScalerTrainBatchOp(_ColScalerTrainBase):
    KIND = "maxabs"

    def _fit_stats(self, t, cols):
        s = summarize_table(t, cols)
        return {"maxabs": np.asarray([max(abs(s.min(c)), abs(s.max(c)))
                                      for c in cols])}


class ImputerTrainBatchOp(_ColScalerTrainBase):
    """reference: dataproc/ImputerTrainBatchOp (MEAN/MIN/MAX/VALUE strategies)"""
    KIND = "imputer"
    STRATEGY = ParamInfo("strategy", str, default="MEAN",
                         validator=InValidator(["MEAN", "MIN", "MAX", "VALUE"]))
    FILL_VALUE = ParamInfo("fill_value", float, default=0.0)

    def _fit_stats(self, t, cols):
        s = summarize_table(t, cols)
        strat = self.get_strategy().upper()
        if strat == "MEAN":
            fill = [s.mean(c) for c in cols]
        elif strat == "MIN":
            fill = [s.min(c) for c in cols]
        elif strat == "MAX":
            fill = [s.max(c) for c in cols]
        else:
            fill = [self.get_fill_value()] * len(cols)
        return {"fill": np.asarray(fill)}


class _ColScalerPredictBase(ModelMapBatchOp, HasOutputCols):
    MAPPER_CLS = _ColScalerMapper


class StandardScalerPredictBatchOp(_ColScalerPredictBase):
    pass


class MinMaxScalerPredictBatchOp(_ColScalerPredictBase):
    pass


class MaxAbsScalerPredictBatchOp(_ColScalerPredictBase):
    pass


class ImputerPredictBatchOp(_ColScalerPredictBase):
    pass
