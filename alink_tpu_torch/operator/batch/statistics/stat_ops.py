"""Statistics batch operators.

Counterpart: ``alink_tpu/operator/batch/statistics/stat_ops.py``, the
re-design of operator/batch/statistics/ (SummarizerBatchOp,
VectorSummarizerBatchOp, CorrelationBatchOp, VectorCorrelationBatchOp,
ChiSquareTestBatchOp, VectorChiSquareTestBatchOp and the
collectStatistics path, BatchOperator.java:576-603). All six run on the
host in numpy, as there; none takes a device.
"""


from __future__ import annotations

from typing import List, Optional

import numpy as np

from ....common.mtable import MTable
from ....common.params import InValidator, ParamInfo
from ....common.types import AlinkTypes, TableSchema
from ....params.shared import (HasLabelCol, HasSelectedCol, HasSelectedCols,
                               HasVectorCol)
from ...base import BatchOperator
from ...common.statistics.hypothesis import (chi_square_test, pearson_corr,
                                             spearman_corr)
from ...common.statistics.summarizer import (TableSummary, summarize_table,
                                             summarize_vector_col)


class SummarizerBatchOp(BatchOperator, HasSelectedCols):
    """reference: SummarizerBatchOp → TableSummary."""

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._summary: Optional[TableSummary] = None

    def link_from(self, in_op: BatchOperator) -> "SummarizerBatchOp":
        t = in_op.get_output_table()
        self._summary = summarize_table(t, self.get_selected_cols())
        self._output = self._summary.to_mtable()
        return self

    def collect_summary(self) -> TableSummary:
        if self._summary is None:
            raise RuntimeError("link first")
        return self._summary


class VectorSummarizerBatchOp(BatchOperator, HasVectorCol, HasSelectedCol):
    """reference: VectorSummarizerBatchOp."""

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._summary = None

    def link_from(self, in_op: BatchOperator) -> "VectorSummarizerBatchOp":
        t = in_op.get_output_table()
        col = self.params._m.get("vector_col") or self.params._m.get("selected_col")
        self._summary = summarize_vector_col(t, col)
        s = self._summary
        self._output = MTable({
            "id": np.arange(s.vector_size()), "mean": s.mean(),
            "standardDeviation": s.standard_deviation(), "min": s.min(),
            "max": s.max(), "numNonZero": s.num_non_zero().astype(np.float64)})
        return self

    def collect_vector_summary(self):
        if self._summary is None:
            raise RuntimeError("link first")
        return self._summary


class CorrelationBatchOp(BatchOperator, HasSelectedCols):
    """reference: CorrelationBatchOp (PEARSON | SPEARMAN)."""
    METHOD = ParamInfo("method", str, default="PEARSON",
                       validator=InValidator(["PEARSON", "SPEARMAN"]))

    def __init__(self, params=None, **kwargs):
        super().__init__(params, **kwargs)
        self._corr: Optional[np.ndarray] = None

    def link_from(self, in_op: BatchOperator) -> "CorrelationBatchOp":
        t = in_op.get_output_table()
        cols = self.get_selected_cols()
        if not cols:
            cols = [n for n, tp in zip(t.schema.names, t.schema.types)
                    if AlinkTypes.is_numeric(tp)]
        X = t.numeric_block(cols)
        C = (pearson_corr(X) if self.get_method().upper() == "PEARSON"
             else spearman_corr(X))
        self._corr = C
        data = {"colName": cols}
        for j, c in enumerate(cols):
            data[c] = C[:, j]
        self._output = MTable(data)
        return self

    def collect_correlation(self) -> np.ndarray:
        if self._corr is None:
            raise RuntimeError("link first")
        return self._corr


class VectorCorrelationBatchOp(BatchOperator, HasVectorCol):
    METHOD = CorrelationBatchOp.METHOD

    def link_from(self, in_op: BatchOperator) -> "VectorCorrelationBatchOp":
        from ...common.dataproc.feature_extract import extract_dense_matrix
        t = in_op.get_output_table()
        X = extract_dense_matrix(t, None, self.params._m.get("vector_col"))
        C = (pearson_corr(X) if self.get_method().upper() == "PEARSON"
             else spearman_corr(X))
        self._corr = C
        self._output = MTable({f"c{j}": C[:, j] for j in range(C.shape[1])})
        return self

    def collect_correlation(self) -> np.ndarray:
        return self._corr


class ChiSquareTestBatchOp(BatchOperator, HasSelectedCols, HasLabelCol):
    """reference: ChiSquareTestBatchOp — per-column chi2 vs label."""

    def link_from(self, in_op: BatchOperator) -> "ChiSquareTestBatchOp":
        t = in_op.get_output_table()
        label = t.col(self.get_label_col())
        rows = []
        for c in self.get_selected_cols():
            chi2, p, df = chi_square_test(t.col(c), label)
            rows.append((c, p, chi2, float(df)))
        self._output = MTable(rows, TableSchema(
            ["colName", "p", "value", "df"],
            [AlinkTypes.STRING, AlinkTypes.DOUBLE, AlinkTypes.DOUBLE, AlinkTypes.DOUBLE]))
        return self


class VectorChiSquareTestBatchOp(BatchOperator, HasVectorCol, HasSelectedCol,
                                 HasLabelCol):
    """reference: VectorChiSquareTestBatchOp — per-component chi2 of the
    vector column against the label."""

    def link_from(self, in_op: BatchOperator) -> "VectorChiSquareTestBatchOp":
        from ...common.dataproc.feature_extract import extract_dense_matrix
        t = in_op.get_output_table()
        col = self.params._m.get("vector_col") or self.params._m.get("selected_col")
        X = extract_dense_matrix(t, None, col)
        label = t.col(self.get_label_col())
        rows = []
        for j in range(X.shape[1]):
            chi2, p, df = chi_square_test(X[:, j], label)
            rows.append((str(j), p, chi2, float(df)))
        self._output = MTable(rows, TableSchema(
            ["colName", "p", "value", "df"],
            [AlinkTypes.STRING, AlinkTypes.DOUBLE, AlinkTypes.DOUBLE,
             AlinkTypes.DOUBLE]))
        return self
