"""FM classifier and regressor batch operators.

Counterpart: ``alink_tpu/operator/batch/classification/fm_ops.py`` (the
re-design of the reference's FmClassifierTrainBatchOp and
FmRegressorTrainBatchOp with their predict ops over common/fm). The model
table, its converter, ``FmModelInfo`` and the host mapper are the JAX
package's numpy code, so a model table saved by either package loads in
the other. A train op takes ``device=`` (``cuda`` unless the caller asks
for the CPU; raises without it) and ``dtype=`` (``torch.float32`` by
default; ``torch.float64`` for parity with the JAX package under x64),
where the JAX package reads ``jax_enable_x64``.
``FmModelMapper.serving_kernel`` scores on the device through the FM
score kernel (``kernels/fm.py::fm_scores``, "P4") for
``serving.CompiledPredictor``, keeping the JAX package's padding to
``SERVE_CHUNK`` and its encode and decode.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import ParamInfo, Params, RangeValidator
from ....common.types import AlinkTypes, TableSchema
from ....mapper.base import ModelMapper, OutputColsHelper
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....params.shared import (HasFeatureCols, HasLabelCol, HasPredictionCol,
                               HasPredictionDetailCol, HasReservedCols, HasSeed,
                               HasVectorCol, HasWeightCol)
from ...base import BatchOperator
from ...common.dataproc.feature_extract import extract_design, resolve_feature_cols
from ...common.fm.fm import FmTrainParams, fm_predict_margin, fm_train
from ...common.linear.base import encode_labels
from ..utils.model_map import ModelMapBatchOp


class FmModelData:
    def __init__(self, w0, w, V, is_regression, vector_col, feature_cols,
                 label_values, label_type=AlinkTypes.STRING):
        self.w0, self.w, self.V = w0, w, V
        self.is_regression = is_regression
        self.vector_col = vector_col
        self.feature_cols = feature_cols
        self.label_values = label_values
        self.label_type = label_type


class FmModelDataConverter(SimpleModelDataConverter):
    """reference: common/fm/FmModelDataConverter.java"""

    def serialize_model(self, m: FmModelData):
        meta = Params({"is_regression": m.is_regression, "vector_col": m.vector_col,
                       "feature_cols": m.feature_cols,
                       "label_values": [str(v) for v in (m.label_values or [])],
                       "label_type": m.label_type,
                       "raw_labels": json.dumps(m.label_values, default=str)})
        return meta, [encode_array(np.asarray([m.w0])), encode_array(m.w),
                      encode_array(m.V)]

    def deserialize_model(self, meta, data):
        labels = meta._m.get("label_values") or []
        lt = meta._m.get("label_type", AlinkTypes.STRING)
        if lt in (AlinkTypes.LONG, AlinkTypes.INT):
            labels = [int(float(v)) for v in labels]
        elif lt in (AlinkTypes.DOUBLE, AlinkTypes.FLOAT):
            labels = [float(v) for v in labels]
        return FmModelData(
            float(decode_array(data[0])[0]), decode_array(data[1]),
            decode_array(data[2]), bool(meta._m.get("is_regression")),
            meta._m.get("vector_col"), meta._m.get("feature_cols"), labels, lt)


class _FmTrainParamsMixin(HasLabelCol, HasFeatureCols, HasVectorCol, HasWeightCol,
                          HasSeed):
    NUM_FACTOR = ParamInfo("num_factor", int, "latent factors", default=10,
                           validator=RangeValidator(1, None))
    NUM_EPOCHS = ParamInfo("num_epochs", int, default=10,
                           validator=RangeValidator(1, None))
    LEARN_RATE = ParamInfo("learn_rate", float, default=0.05)
    INIT_STDEV = ParamInfo("init_stdev", float, default=0.05)
    LAMBDA_0 = ParamInfo("lambda_0", float, default=0.0)
    LAMBDA_1 = ParamInfo("lambda_1", float, default=0.0)
    LAMBDA_2 = ParamInfo("lambda_2", float, default=0.0)
    WITH_INTERCEPT = ParamInfo("with_intercept", bool, default=True)
    WITH_LINEAR_ITEM = ParamInfo("with_linear_item", bool, default=True)


_SHIP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class BaseFmTrainBatchOp(BatchOperator, _FmTrainParamsMixin):
    IS_REGRESSION = False

    def __init__(self, params: Optional[Params] = None, device=None,
                 dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(params, **kwargs)
        if dtype not in _SHIP_DTYPES:
            raise ValueError(f"dtype {dtype}: want torch.float32 or "
                             f"torch.float64")
        self.device = resolve_device(device)
        self.dtype = dtype

    def link_from(self, in_op: BatchOperator):
        t = in_op.get_output_table()
        dtype = _SHIP_DTYPES[self.dtype]
        vector_col = self.params._m.get("vector_col")
        feature_cols = self.params._m.get("feature_cols")
        label_col = self.get_label_col()
        weight_col = self.params._m.get("weight_col")
        if not vector_col:
            feature_cols = resolve_feature_cols(
                t, feature_cols, label_col,
                exclude=[weight_col] if weight_col else [])
        design = extract_design(t, feature_cols, vector_col, dtype)
        raw = t.col(label_col)
        label_type = t.schema.type_of(label_col)
        if self.IS_REGRESSION:
            labels, y = [], np.asarray(raw, dtype)
        else:
            labels, y = encode_labels(
                raw, self.params._m.get("positive_label_value_string"))
        w = (np.asarray(t.col(weight_col), dtype) if weight_col
             else np.ones(t.num_rows, dtype))
        data = {k: v for k, v in design.items() if k in ("X", "idx", "val")}
        data["y"] = y.astype(dtype)
        data["w"] = w
        p = FmTrainParams(
            num_factors=self.get_num_factor(), learn_rate=self.get_learn_rate(),
            init_stdev=self.get_init_stdev(), num_epochs=self.get_num_epochs(),
            lambda_0=self.get_lambda_0(), lambda_1=self.get_lambda_1(),
            lambda_2=self.get_lambda_2(), with_intercept=self.get_with_intercept(),
            with_linear_item=self.get_with_linear_item(),
            is_regression=self.IS_REGRESSION, seed=self.get_seed())
        w0, wv, V, curve, steps = fm_train(
            data, design["dim"], p, env=MLEnvironment(device=self.device))
        model = FmModelData(w0, wv, V, self.IS_REGRESSION, vector_col,
                            feature_cols, labels, label_type)
        self._output = FmModelDataConverter().save_model(model)
        self._side_outputs = [MTable({"epoch": np.arange(1, len(curve) + 1),
                                      "loss": curve.astype(np.float64)})]
        return self

    def get_model_info(self) -> MTable:
        m = FmModelDataConverter().load_model(self.get_output_table())
        return FmModelInfo(m).to_table()


class FmClassifierTrainBatchOp(BaseFmTrainBatchOp):
    IS_REGRESSION = False


class FmRegressorTrainBatchOp(BaseFmTrainBatchOp):
    IS_REGRESSION = True


class FmModelInfo:
    """FM model summary (reference common/fm/FmModelInfo.java:18-58): task,
    latent dimension, vector size, factor matrix, feature columns."""

    def __init__(self, m: FmModelData):
        self._m = m

    def get_task(self) -> str:
        return "REGRESSION" if self._m.is_regression else "BINARY_CLASSIFICATION"

    def get_num_factor(self) -> int:
        return int(self._m.V.shape[1])

    def get_vector_size(self) -> int:
        return int(self._m.w.shape[0])

    def get_factors(self) -> np.ndarray:
        return np.asarray(self._m.V)

    def get_col_names(self):
        return self._m.feature_cols

    def to_table(self) -> MTable:
        m = self._m
        V = np.asarray(m.V)
        return MTable({
            "task": [self.get_task()],
            "vector_size": [self.get_vector_size()],
            "num_factor": [self.get_num_factor()],
            "intercept": [float(m.w0)],
            "linear_norm": [float(np.linalg.norm(np.asarray(m.w)))],
            "factor_norm": [float(np.linalg.norm(V))],
            "feature_cols": [",".join(m.feature_cols or [])
                             if m.feature_cols else (m.vector_col or "")],
        })

    def __repr__(self):
        return (f"FmModelInfo(task={self.get_task()}, "
                f"vector_size={self.get_vector_size()}, "
                f"num_factor={self.get_num_factor()})")


class FmModelInfoBatchOp(BatchOperator):
    """Link to the output of an FM trainer to summarize the model
    (reference operator/common/fm/FmModelInfoBatchOp.java:15-40, built on
    ExtractModelInfoBatchOp). ``collect_model_info()`` returns the
    FmModelInfo; the op's output table is the one-row summary."""

    def link_from(self, in_op: BatchOperator) -> "FmModelInfoBatchOp":
        model = FmModelDataConverter().load_model(in_op.get_output_table())
        self._info = FmModelInfo(model)
        self._output = self._info.to_table()
        return self

    def collect_model_info(self) -> FmModelInfo:
        return self._info

    def lazy_print_model_info(self, title=None) -> "FmModelInfoBatchOp":
        def show(t: MTable):
            if title:
                print(title)
            print(t.to_display_string())
        return self._lazy("model_info", self.get_output_table(), show)


class FmModelMapper(ModelMapper):
    """reference: common/fm/FmModelMapper.java"""

    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model: Optional[FmModelData] = None

    def load_model(self, model_table: MTable):
        self.model = FmModelDataConverter().load_model(model_table)

    def get_output_schema(self) -> TableSchema:
        """Output schema without running the mapper — required by the
        stream predict twins (`ModelMapStreamOp._open`); the batch path
        never calls it, which is why the FM twin could not open."""
        m = self.model
        return self._pred_output_schema(
            m.label_type if m else AlinkTypes.STRING,
            bool(m is not None and m.is_regression))

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        design = extract_design(data, m.feature_cols, m.vector_col, np.float64,
                                vector_size=m.w.shape[0])
        return self._finish(fm_predict_margin(m.w0, m.w, m.V, design), data)

    def serving_kernel(self, ship_dtype: torch.dtype = torch.float32):
        """The serving contract (``serving/predictor.py``) for FM: the
        margin ``w0 + <w,x> + 1/2 sum_f((Vx)_f^2 - (V^2 x^2)_f)`` with every
        feature and factor sum strictly left to right, the JAX package's
        ``scan_sum`` order, in ONE launch of the FM score kernel
        (``kernels/fm.py::fm_scores``) a request batch, so padding is a
        bitwise no-op. The weights ``(w0, w, V)`` are the model arrays, in
        ``ship_dtype`` (float32 on the card; float64 for parity with the
        JAX package under x64), their feature axis padded with zeros to a
        multiple of ``SERVE_CHUNK``, as the sparse width is."""
        m = self.model
        if m is None:
            raise RuntimeError(
                "load_model must be called before serving_kernel")
        if ship_dtype not in _SHIP_DTYPES:
            raise ValueError(f"ship dtype {ship_dtype}: want float32 or "
                             f"float64")
        from ....kernels.fm import fm_scores
        from ....serving.predictor import GeometryRefused, ServingKernel
        from ....serving.sharded import SERVE_CHUNK
        ship_dt = _SHIP_DTYPES[ship_dtype]
        dim = int(m.w.shape[0])
        k = int(m.V.shape[1])
        dim8 = -(-dim // SERVE_CHUNK) * SERVE_CHUNK
        w = np.zeros(dim8, ship_dt)
        w[:dim] = np.asarray(m.w, ship_dt)
        V = np.zeros((dim8, k), ship_dt)
        V[:dim] = np.asarray(m.V, ship_dt)
        model_arrays = (torch.tensor([m.w0], dtype=ship_dtype),
                        torch.from_numpy(w), torch.from_numpy(V))
        signature = ("fm", bool(m.is_regression), dim, k,
                     str(ship_dt.__name__))

        def encode(data: MTable, bucket: int):
            design = extract_design(data, m.feature_cols, m.vector_col,
                                    ship_dt, vector_size=dim)
            n = data.num_rows
            if design["kind"] == "dense":
                Xf = design["X"]
                if Xf.shape[1] > dim:
                    raise GeometryRefused(
                        f"request has {Xf.shape[1]} features, model has "
                        f"{dim}")
                X = np.zeros((bucket, dim8), ship_dt)
                X[:n, :Xf.shape[1]] = Xf
                return ("dense", (torch.from_numpy(X),))
            idx0, val0 = design["idx"], design["val"]
            if idx0.size and (idx0.min() < 0 or idx0.max() >= dim):
                raise GeometryRefused(
                    f"request feature index {int(idx0.max())} out of range "
                    f"for a model of {dim} features")
            w0 = max(idx0.shape[1], 1)
            width = -(-w0 // SERVE_CHUNK) * SERVE_CHUNK
            idx = np.zeros((bucket, width), np.int32)
            val = np.zeros((bucket, width), ship_dt)
            idx[:n, :idx0.shape[1]] = idx0
            val[:n, :val0.shape[1]] = val0
            return ("sparse", (torch.from_numpy(idx), torch.from_numpy(val)))

        def decode(outputs, data: MTable) -> MTable:
            return self._finish(np.asarray(outputs[0], np.float64), data)

        return ServingKernel(
            signature=signature, model_arrays=model_arrays, encode=encode,
            device_fns={"dense": lambda mdl, X: fm_scores(mdl, None, X),
                        "sparse": lambda mdl, idx, val: fm_scores(mdl, idx,
                                                                  val)},
            decode=decode)

    def _finish(self, margin: np.ndarray, data: MTable) -> MTable:
        """Margins -> output table (label pick, detail, column merge) —
        split out of :meth:`map_table` so the serving tier decodes
        DEVICE-computed margins through the exact same host logic."""
        m = self.model
        pred_col = self.params._m.get("prediction_col", "pred")
        detail_col = self.params._m.get("prediction_detail_col")
        reserved = self.params._m.get("reserved_cols")
        if m.is_regression:
            cols, types, vals = [pred_col], [AlinkTypes.DOUBLE], [margin]
        else:
            p_pos = 1.0 / (1.0 + np.exp(-np.clip(margin, -500, 500)))
            preds = np.empty(len(margin), object)
            preds[:] = [m.label_values[0] if s > 0 else m.label_values[1]
                        for s in margin]
            cols, types, vals = [pred_col], [m.label_type], [preds]
            if detail_col:
                details = np.asarray(
                    [json.dumps({str(m.label_values[0]): float(p),
                                 str(m.label_values[1]): float(1 - p)})
                     for p in p_pos], object)
                cols.append(detail_col)
                types.append(AlinkTypes.STRING)
                vals.append(details)
        helper = OutputColsHelper(data.schema, cols, types, reserved)
        return helper.build_output(data, vals)


class FmPredictBatchOp(ModelMapBatchOp, HasPredictionCol, HasPredictionDetailCol,
                       HasReservedCols):
    MAPPER_CLS = FmModelMapper


FmClassifierPredictBatchOp = FmPredictBatchOp
FmRegressorPredictBatchOp = FmPredictBatchOp
