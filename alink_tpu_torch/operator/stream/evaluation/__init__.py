"""Stream evaluation: windowed and cumulative metrics.

Counterpart: ``alink_tpu/operator/stream/evaluation/__init__.py`` (the
re-design of the reference's stream/evaluation/,
BaseEvalClassStreamOp.java:44-87: ``timeWindowAll(timeInterval)`` emits
a "window" metrics row and an "all" cumulative row per interval).
Ported: ``_BaseEvalStreamOp``, ``EvalBinaryClassStreamOp``,
``EvalMultiClassStreamOp`` and ``EvalRegressionStreamOp``. Each closed
event-time window (the first ends at ``(floor(t / interval) + 1)
* interval``; a window that saw no rows does not fire) emits
(Statistics='window', Data=json) over its rows and (Statistics='all',
Data=json) over every row so far; in a window with one label class AUC,
KS and PRC are null. The multiclass and regression windows compute the
batch ops' metrics (``multiclass_metrics`` without details,
``regression_metrics``) over the window's rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import ParamInfo
from ....common.types import AlinkTypes, TableSchema
from ....params.shared import (HasLabelCol, HasPositiveLabelValueString,
                               HasPredictionCol, HasPredictionDetailCol)
from ...base import StreamOperator
from ...batch.evaluation.eval_ops import parse_detail_probs
from ...common.evaluation.metrics import (BinaryClassMetrics, binary_metrics,
                                          multiclass_metrics,
                                          regression_metrics)

_OUT_SCHEMA = TableSchema(["Statistics", "Data"],
                          [AlinkTypes.STRING, AlinkTypes.STRING])


class _BaseEvalStreamOp(StreamOperator):
    """Windowed+cumulative metric emission over timed micro-batches."""

    TIME_INTERVAL = ParamInfo("time_interval", float, default=1.0)

    def _metrics_json(self, table: MTable) -> str:  # pragma: no cover
        raise NotImplementedError

    def link_from(self, in_op: StreamOperator) -> "_BaseEvalStreamOp":
        interval = float(self.get_time_interval())
        self._schema = _OUT_SCHEMA

        def emit(window_rows: Optional[MTable], all_rows: Optional[MTable]):
            rows = []
            if window_rows is not None and window_rows.num_rows:
                rows.append(("window", self._metrics_json(window_rows)))
            if all_rows is not None and all_rows.num_rows:
                rows.append(("all", self._metrics_json(all_rows)))
            return MTable(rows, _OUT_SCHEMA) if rows else None

        def gen():
            window: Optional[MTable] = None
            total: Optional[MTable] = None
            window_end = None
            for t, mt in in_op.timed_batches():
                if window_end is None:
                    window_end = (np.floor(t / interval) + 1) * interval
                while t >= window_end:
                    # fire only for windows that saw data (Flink timeWindowAll
                    # does not fire empty windows)
                    if window is not None:
                        out = emit(window, total)
                        if out is not None:
                            yield (window_end, out)
                    window = None
                    window_end += interval
                window = mt if window is None else window.concat_rows(mt)
                total = mt if total is None else total.concat_rows(mt)
            out = emit(window, total)
            if out is not None:
                yield (window_end if window_end is not None else interval, out)

        self._stream_fn = gen
        return self


class EvalBinaryClassStreamOp(_BaseEvalStreamOp, HasLabelCol,
                              HasPredictionDetailCol, HasPositiveLabelValueString):
    """reference: stream/evaluation/EvalBinaryClassStreamOp."""

    def _metrics_json(self, table: MTable) -> str:
        labels = table.col(self.get_label_col())
        details = table.col(self.get_prediction_detail_col() or "pred_detail")
        pos, p_pos = parse_detail_probs(
            details, self.params._m.get("positive_label_value_string"))
        m = binary_metrics(labels, p_pos, pos)
        if len(set(str(l) for l in labels)) < 2:
            # a window that saw one label class still emits the full schema
            # (reference BaseEvalClassStreamOp windows do) — confusion-matrix
            # metrics are well-defined; rank metrics are not, so null them
            d = m.to_dict()
            for k in ("AUC", "KS", "PRC"):
                d[k] = None
            return BinaryClassMetrics(d).to_json()
        return m.to_json()


class EvalMultiClassStreamOp(_BaseEvalStreamOp, HasLabelCol, HasPredictionCol,
                             HasPredictionDetailCol):
    """reference: stream/evaluation/EvalMultiClassStreamOp."""

    def _metrics_json(self, table: MTable) -> str:
        labels = table.col(self.get_label_col())
        preds = table.col(self.get_prediction_col())
        return multiclass_metrics(labels, preds).to_json()


class EvalRegressionStreamOp(_BaseEvalStreamOp, HasLabelCol, HasPredictionCol):
    """reference: stream/evaluation/EvalRegressionStreamOp."""

    def _metrics_json(self, table: MTable) -> str:
        y = np.asarray(table.col(self.get_label_col()), np.float64)
        p = np.asarray(table.col(self.get_prediction_col()), np.float64)
        return regression_metrics(y, p).to_json()
