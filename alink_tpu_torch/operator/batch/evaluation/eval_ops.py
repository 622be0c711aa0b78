"""Evaluation batch operators.

Counterpart: ``alink_tpu/operator/batch/evaluation/eval_ops.py`` (the
re-design of the reference's operator/batch/evaluation/). Ported:
``parse_detail_probs`` (its columnar branch reads the port's
``PredictionDetailColumn`` without parsing), ``EvalBinaryClassBatchOp``,
``EvalMultiClassBatchOp``, ``EvalRegressionBatchOp`` and
``EvalClusterBatchOp``. Each outputs a one-row metrics-JSON table and
exposes ``collect_metrics()`` (the reference's collectMetrics); the
metrics are the host numpy of ``common/evaluation/metrics.py``.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import ParamInfo
from ....common.types import AlinkTypes, TableSchema
from ....params.shared import (HasLabelCol, HasPositiveLabelValueString,
                               HasPredictionCol, HasPredictionDetailCol,
                               HasVectorCol)
from ...base import BatchOperator
from ...common.evaluation.metrics import (BinaryClassMetrics, ClusterMetrics,
                                          MultiClassMetrics, RegressionMetrics,
                                          binary_metrics, cluster_metrics,
                                          multiclass_metrics,
                                          regression_metrics)


def _metrics_table(metrics) -> MTable:
    return MTable([(metrics.to_json(),)], TableSchema(["Data"], [AlinkTypes.STRING]))


def parse_detail_probs(details, pos_value: Optional[str] = None):
    """Extract (labels, p_pos) from prediction-detail json strings.

    Default positive label matches the trainer's choice (largest numeric
    first, else reverse lexicographic — see base.encode_labels).
    """
    from ...common.evaluation.detail import PredictionDetailColumn
    if isinstance(details, PredictionDetailColumn):
        # columnar predict output: read the probability matrix zero-parse
        keys = sorted(details.labels, key=_num_sort_key, reverse=True)
        if pos_value is None:
            pos_value = keys[0]
        try:
            col = details.labels.index(str(pos_value))
            p_pos = np.asarray(details.probs[:, col], np.float64)
        except ValueError:
            p_pos = np.zeros(len(details))
        return pos_value, p_pos
    probs = [json.loads(d) for d in details]
    keys = sorted({k for p in probs for k in p}, key=_num_sort_key, reverse=True)
    if pos_value is None:
        pos_value = keys[0]
    p_pos = np.asarray([float(p.get(str(pos_value), 0.0)) for p in probs])
    return pos_value, p_pos


def _num_sort_key(v: str):
    try:
        return (1, float(v), "")
    except (TypeError, ValueError):
        return (0, 0.0, str(v))


class EvalBinaryClassBatchOp(BatchOperator, HasLabelCol, HasPredictionDetailCol,
                             HasPositiveLabelValueString):
    """reference: EvalBinaryClassBatchOp (AUC/KS/PRC/logloss/confusion)."""

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._metrics: Optional[BinaryClassMetrics] = None

    def link_from(self, in_op: BatchOperator) -> "EvalBinaryClassBatchOp":
        t = in_op.get_output_table()
        labels = t.col(self.get_label_col())
        details = t.col(self.get_prediction_detail_col() or "pred_detail")
        pos, p_pos = parse_detail_probs(
            details, self.params._m.get("positive_label_value_string"))
        self._metrics = binary_metrics(labels, p_pos, pos)
        self._output = _metrics_table(self._metrics)
        return self

    def collect_metrics(self) -> BinaryClassMetrics:
        if self._metrics is None:
            raise RuntimeError("link the evaluator first")
        return self._metrics


class EvalMultiClassBatchOp(BatchOperator, HasLabelCol, HasPredictionCol,
                            HasPredictionDetailCol):
    """reference: EvalMultiClassBatchOp (confusion matrix, macro / weighted
    / micro statistics; log loss from the details)."""

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._metrics: Optional[MultiClassMetrics] = None

    def link_from(self, in_op: BatchOperator) -> "EvalMultiClassBatchOp":
        t = in_op.get_output_table()
        labels = t.col(self.get_label_col())
        preds = t.col(self.get_prediction_col())
        detail_col = self.params._m.get("prediction_detail_col")
        details = t.col(detail_col) if detail_col else None
        self._metrics = multiclass_metrics(labels, preds, details)
        self._output = _metrics_table(self._metrics)
        return self

    def collect_metrics(self) -> MultiClassMetrics:
        if self._metrics is None:
            raise RuntimeError("link the evaluator first")
        return self._metrics


class EvalRegressionBatchOp(BatchOperator, HasLabelCol, HasPredictionCol):
    """reference: EvalRegressionBatchOp (SSE, MSE, RMSE, MAE, R2, MAPE)."""

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._metrics: Optional[RegressionMetrics] = None

    def link_from(self, in_op: BatchOperator) -> "EvalRegressionBatchOp":
        t = in_op.get_output_table()
        y = np.asarray(t.col(self.get_label_col()), np.float64)
        p = np.asarray(t.col(self.get_prediction_col()), np.float64)
        self._metrics = regression_metrics(y, p)
        self._output = _metrics_table(self._metrics)
        return self

    def collect_metrics(self) -> RegressionMetrics:
        if self._metrics is None:
            raise RuntimeError("link the evaluator first")
        return self._metrics


class EvalClusterBatchOp(BatchOperator, HasVectorCol, HasPredictionCol):
    """reference: EvalClusterBatchOp (CH / DB / silhouette; purity, NMI
    and ARI with ``label_col``)."""
    LABEL_COL = ParamInfo("label_col", str, "true labels (optional)")

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._metrics: Optional[ClusterMetrics] = None

    def link_from(self, in_op: BatchOperator) -> "EvalClusterBatchOp":
        from ...common.dataproc.feature_extract import extract_design
        t = in_op.get_output_table()
        vec_col = self.params._m.get("vector_col")
        design = extract_design(t, None, vec_col) if vec_col else None
        X = None
        if design is not None:
            X = design["X"] if design["kind"] == "dense" else None
            if X is None:
                from ....common.vector import SparseBatch
                X = SparseBatch(design["idx"], design["val"], design["dim"]).to_dense()
        assignment = np.asarray(t.col(self.get_prediction_col()))
        label_col = self.params._m.get("label_col")
        labels = t.col(label_col) if label_col else None
        self._metrics = cluster_metrics(X, assignment, labels)
        self._output = _metrics_table(self._metrics)
        return self

    def collect_metrics(self) -> ClusterMetrics:
        if self._metrics is None:
            raise RuntimeError("link the evaluator first")
        return self._metrics
