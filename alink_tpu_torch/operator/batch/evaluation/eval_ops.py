"""Binary evaluation batch operator.

Counterpart: ``alink_tpu/operator/batch/evaluation/eval_ops.py``.
Ported: ``parse_detail_probs`` (its columnar branch reads the port's
``PredictionDetailColumn`` without parsing) and
``EvalBinaryClassBatchOp``, which outputs a one-row metrics-JSON table
and exposes ``collect_metrics()``. The multiclass, regression and
cluster eval ops wait with their metrics.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ....common.mtable import MTable
from ....common.types import AlinkTypes, TableSchema
from ....params.shared import (HasLabelCol, HasPositiveLabelValueString,
                               HasPredictionDetailCol)
from ...base import BatchOperator
from ...common.evaluation.metrics import BinaryClassMetrics, binary_metrics


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
