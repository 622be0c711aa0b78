"""LinearModelMapper — batched model serving.

Counterpart: ``alink_tpu/operator/common/linear/mapper.py``. The host
path (``map_table``, ``_finish``) is the JAX package's numpy code;
:meth:`LinearModelMapper.serving_kernel` builds the device path, scored
by the CUDA kernels of ``kernels/serve.py``: for the binary and
regression family (LR, SVM, Perceptron, LinearReg, SVR) one launch a
request block, for Softmax one launch for each of its ``k - 1``
non-pivot class columns (``f32`` mode whatever ``ALINK_TPU_SERVE_DTYPE``
says, as the JAX package serves Softmax). Each column sums a row left
to right in the order of the JAX package's Softmax serving program
(``seq_chunk_sum``), so its scores keep their bits in every bucket.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ....common.mtable import MTable
from ....common.types import AlinkTypes, TableSchema
from ....mapper.base import ModelMapper, OutputColsHelper
from ..dataproc.feature_extract import extract_design
from .base import LinearModelData, LinearModelDataConverter, LinearModelType

_SHIP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -500, 500)))


class LinearModelMapper(ModelMapper):
    def __init__(self, model_schema, data_schema, params=None, **kwargs):
        super().__init__(model_schema, data_schema, params, **kwargs)
        self.model: Optional[LinearModelData] = None

    def load_model(self, model_table: MTable):
        self.model = LinearModelDataConverter.load_table(model_table)

    # ------------------------------------------------------------------
    def _scores(self, data: MTable) -> np.ndarray:
        m = self.model
        design = extract_design(data, m.feature_names, m.vector_col,
                                np.float64, vector_size=m.vector_size)
        coef = m.coef
        if m.linear_model_type == LinearModelType.Softmax:
            k = len(m.label_values)
            W = coef.reshape(k - 1, -1)
            if m.has_intercept:
                b, Wf = W[:, 0], W[:, 1:]
            else:
                b, Wf = np.zeros(k - 1), W
            Z = _matmul(design, Wf.T, m.vector_size) + b
            return np.concatenate([Z, np.zeros((Z.shape[0], 1))], 1)
        if m.has_intercept:
            b, wf = coef[0], coef[1:]
        else:
            b, wf = 0.0, coef
        return _matmul(design, wf, m.vector_size) + b

    def predict_scores(self, data: MTable) -> np.ndarray:
        return self._scores(data)

    # ------------------------------------------------------------------
    def serving_kernel(self, ship_dtype: torch.dtype = torch.float32):
        """The serving contract (``serving/predictor.py``): host encode
        -> device score -> host decode through :meth:`_finish`.

        The model arrays are CPU tensors in ``ship_dtype`` (float32 on
        the card; the parity tests ship float64, as the JAX package does
        under x64), or in the low-precision layout of
        ``ALINK_TPU_SERVE_DTYPE``. The feature axis pads with zeros to a
        multiple of ``LANE_PAD``, the sparse width to a multiple of
        ``SERVE_CHUNK``; zero padding is a no-op in the strict
        left-to-right sum, so a row scores the same in every bucket. The
        signature carries the model geometry only."""
        m = self.model
        if m is None:
            raise RuntimeError(
                "load_model must be called before serving_kernel")
        if ship_dtype not in _SHIP_DTYPES:
            raise ValueError(f"ship dtype {ship_dtype}: want float32 or "
                             f"float64")
        from ....kernels.serve import (lowp_model_arrays, make_score_fns,
                                       serve_dtype)
        from ....serving.predictor import ServingKernel
        from ....serving.sharded import LANE_PAD, SERVE_CHUNK
        ship_dt = _SHIP_DTYPES[ship_dtype]
        softmax = m.linear_model_type == LinearModelType.Softmax
        coef = np.asarray(m.coef, ship_dt)
        if softmax:
            W = coef.reshape(len(m.label_values) - 1, -1)
            if m.has_intercept:
                b, wf = W[:, 0], W[:, 1:]
            else:
                b, wf = np.zeros(W.shape[0], ship_dt), W
        elif m.has_intercept:
            b, wf = coef[0], coef[1:]
        else:
            b, wf = ship_dt(0.0), coef
        dim = wf.shape[-1]
        dim8 = -(-dim // LANE_PAD) * LANE_PAD
        sdtype = "f32" if softmax else serve_dtype()
        signature = ("linear", str(m.linear_model_type), int(dim),
                     bool(m.has_intercept), softmax,
                     len(m.label_values or ()), ship_dt.__name__, sdtype)

        def encode(data: MTable, bucket: int):
            design = extract_design(data, m.feature_names, m.vector_col,
                                    ship_dt, vector_size=m.vector_size)
            n = data.num_rows
            if design["kind"] == "dense":
                Xf = design["X"]
                if Xf.shape[1] > dim:
                    raise ValueError(
                        f"request has {Xf.shape[1]} features, model has "
                        f"{dim}")
                X = np.zeros((bucket, dim8), ship_dt)
                X[:n, :Xf.shape[1]] = Xf
                return ("dense", (torch.from_numpy(X),))
            idx0, val0 = design["idx"], design["val"]
            if idx0.size and (idx0.min() < 0 or idx0.max() >= dim):
                raise ValueError(
                    f"request feature index {int(idx0.max())} out of range "
                    f"for a model of {dim} features")
            # pad width in steps of the chunk so a few widths cover
            # drifting nnz
            w0 = max(idx0.shape[1], 1)
            width = -(-w0 // SERVE_CHUNK) * SERVE_CHUNK
            idx = np.zeros((bucket, width), np.int32)
            val = np.zeros((bucket, width), ship_dt)
            idx[:n, :idx0.shape[1]] = idx0
            val[:n, :val0.shape[1]] = val0
            return ("sparse", (torch.from_numpy(idx), torch.from_numpy(val)))

        wf8 = np.zeros(wf.shape[:-1] + (dim8,), ship_dt)
        wf8[..., :dim] = wf
        if softmax:
            model_arrays = (torch.from_numpy(wf8),
                            torch.from_numpy(np.ascontiguousarray(b)))
            device_fns = _softmax_score_fns(make_score_fns("f32"))
        elif sdtype == "f32":
            model_arrays = (torch.from_numpy(wf8),
                            torch.tensor(b, dtype=ship_dtype))
            device_fns = make_score_fns(sdtype)
        else:
            model_arrays = lowp_model_arrays(wf8, b, sdtype)
            device_fns = make_score_fns(sdtype)

        def decode(outputs, data: MTable) -> MTable:
            scores = np.asarray(outputs[0])
            if softmax:     # the pivot class's zero logit
                scores = np.concatenate(
                    [scores, np.zeros((scores.shape[0], 1), scores.dtype)],
                    axis=1)
            return self._finish(scores, data)

        return ServingKernel(signature=signature, model_arrays=model_arrays,
                             encode=encode, device_fns=device_fns,
                             decode=decode)

    def get_output_schema(self) -> TableSchema:
        m = self.model
        pred_col = self.params._m.get("prediction_col", "pred")
        detail_col = self.params._m.get("prediction_detail_col")
        reserved = self.params._m.get("reserved_cols")
        regression = m.linear_model_type in LinearModelType.IS_REGRESSION if m else False
        out_type = AlinkTypes.DOUBLE if regression else (m.label_type if m else "STRING")
        cols, types = [pred_col], [out_type]
        if detail_col:
            cols.append(detail_col)
            types.append(AlinkTypes.STRING)
        return OutputColsHelper(self.data_schema, cols, types, reserved).get_output_schema()

    def map_table(self, data: MTable) -> MTable:
        m = self.model
        if m is None:
            raise RuntimeError("load_model must be called before map_table")
        return self._finish(self._scores(data), data)

    def _finish(self, scores: np.ndarray, data: MTable) -> MTable:
        """Scores -> output table (label pick, detail, column merge).

        Split out of :meth:`map_table` so the serving tier
        (``serving/predictor.py``) can decode DEVICE-computed scores
        through the exact same host logic — predictions depend only on
        the scores, whichever path produced them."""
        m = self.model
        pred_col = self.params._m.get("prediction_col", "pred")
        detail_col = self.params._m.get("prediction_detail_col")
        reserved = self.params._m.get("reserved_cols")
        out_cols, out_types = [], []
        details = None
        if m.linear_model_type in LinearModelType.IS_REGRESSION:
            preds = scores
            out_types = [AlinkTypes.DOUBLE]
        elif m.linear_model_type == LinearModelType.Softmax:
            e = np.exp(scores - scores.max(1, keepdims=True))
            probs = e / e.sum(1, keepdims=True)
            pick = probs.argmax(1)
            label_arr = np.empty(len(m.label_values), object)
            label_arr[:] = list(m.label_values)
            preds = _label_array(label_arr[pick])
            if detail_col:
                from ..evaluation.detail import PredictionDetailColumn
                details = PredictionDetailColumn(
                    [str(l) for l in m.label_values], probs)
            out_types = [m.label_type]
        else:
            label_arr = np.empty(2, object)
            label_arr[:] = [m.label_values[0], m.label_values[1]]
            # ~(s > 0), not (s <= 0): a NaN score must keep mapping to the
            # negative label as the per-row 'if s > 0' did
            preds = _label_array(label_arr[(~(scores > 0)).astype(np.intp)])
            if detail_col:
                from ..evaluation.detail import PredictionDetailColumn
                p_pos = _sigmoid(scores)
                details = PredictionDetailColumn(
                    [str(m.label_values[0]), str(m.label_values[1])],
                    np.stack([p_pos, 1.0 - p_pos], axis=1))
            out_types = [m.label_type]
        cols = [pred_col]
        values = [preds]
        if detail_col:
            cols.append(detail_col)
            out_types.append(AlinkTypes.STRING)
            values.append(details if details is not None
                          else np.asarray([None] * len(preds), object))
        helper = OutputColsHelper(data.schema, cols, out_types, reserved)
        return helper.build_output(data, values)


def _softmax_score_fns(fns):
    """Softmax's ``device_fns`` over the binary ones: each non-pivot class
    column ``(W[c], b[c])`` scored by one launch, stacked to (rows,
    k - 1)."""
    def per_class(fn):
        def score(mdl, *encoded):
            W, b = mdl
            return torch.stack([fn((W[c], b[c]), *encoded)
                                for c in range(W.shape[0])], 1)
        return score
    return {kind: per_class(fn) for kind, fn in fns.items()}


def _matmul(design, w, dim):
    if design["kind"] == "dense":
        return design["X"] @ w
    idx, val = design["idx"], design["val"]
    if w.ndim == 1:
        return (val * w[idx]).sum(-1)
    # (n, nnz, k)
    return (val[..., None] * w[idx]).sum(1)


def _label_array(values: List) -> np.ndarray:
    first = values[0] if len(values) else ""
    if isinstance(first, (int, np.integer)):
        return np.asarray(values, np.int64)
    if isinstance(first, (float, np.floating)):
        return np.asarray(values, np.float64)
    out = np.empty(len(values), object)
    out[:] = values
    return out
