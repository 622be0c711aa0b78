"""Table and vector summarizers.

Counterpart: ``alink_tpu/operator/common/statistics/summarizer.py`` (a
copy: the file is numpy only, and the port keeps its own so that it
never imports the JAX package): ``TableSummary`` and
``summarize_table``, the per-column moments the scalers fit from, and
``VectorSummary`` and ``summarize_vector_col``, the vector scalers' and
``VectorSummarizerBatchOp``'s.

The summary is a moment vector (count, sum, sum2, sum3, sum4, min, max,
sum of absolute values) per column, in one pass.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ....common.mtable import MTable
from ....common.types import AlinkTypes, TableSchema
from ....common.vector import DenseVector, VectorUtil


class TableSummary:
    """Per-column moments with reference TableSummary-style getters."""

    def __init__(self, col_names: List[str], stats: Dict[str, np.ndarray],
                 total_count: int):
        self._names = col_names
        self._s = stats  # name -> [cnt, sum, sum2, sum3, sum4, min, max, nnz]
        self._n = total_count

    def count(self) -> int:
        return self._n

    def get_col_names(self):
        return list(self._names)

    def sum(self, col):
        return float(self._s[col][1])

    def mean(self, col):
        c = self._s[col][0]
        return float(self._s[col][1] / c) if c else 0.0

    def variance(self, col):
        c = self._s[col][0]
        if c <= 1:
            return 0.0
        m = self._s[col][1] / c
        return float((self._s[col][2] - c * m * m) / (c - 1))

    def standard_deviation(self, col):
        return float(np.sqrt(max(self.variance(col), 0.0)))

    def min(self, col):
        return float(self._s[col][5])

    def max(self, col):
        return float(self._s[col][6])

    def num_missing_value(self, col):
        return int(self._n - self._s[col][0])

    def num_valid_value(self, col):
        return int(self._s[col][0])

    def normL1(self, col):
        return float(self._s[col][7])

    def normL2(self, col):
        return float(np.sqrt(self._s[col][2]))

    def central_moment(self, col, order: int):
        c = self._s[col][0]
        if c == 0:
            return 0.0
        s1, s2, s3, s4 = self._s[col][1:5]
        m = s1 / c
        if order == 2:
            return float(s2 / c - m ** 2)
        if order == 3:
            return float(s3 / c - 3 * m * s2 / c + 2 * m ** 3)
        if order == 4:
            return float(s4 / c - 4 * m * s3 / c + 6 * m * m * s2 / c - 3 * m ** 4)
        raise ValueError(order)

    def to_mtable(self) -> MTable:
        rows = []
        for c in self._names:
            rows.append((c, self.num_valid_value(c), self.num_missing_value(c),
                         self.sum(c), self.mean(c), self.variance(c),
                         self.standard_deviation(c), self.min(c), self.max(c)))
        return MTable(rows, TableSchema(
            ["colName", "count", "missing", "sum", "mean", "variance",
             "standardDeviation", "min", "max"],
            [AlinkTypes.STRING] + [AlinkTypes.LONG] * 2 + [AlinkTypes.DOUBLE] * 6))

    def to_display_string(self) -> str:
        return self.to_mtable().to_display_string(max_rows=len(self._names))

    __repr__ = to_display_string


def summarize_table(table: MTable, selected_cols: Optional[Sequence[str]] = None) -> TableSummary:
    if selected_cols is None:
        selected_cols = [n for n, t in zip(table.schema.names, table.schema.types)
                         if AlinkTypes.is_numeric(t)]
    stats = {}
    for c in selected_cols:
        v = np.asarray(table.col(c), np.float64)
        ok = ~np.isnan(v)
        vv = v[ok]
        stats[c] = np.asarray([
            ok.sum(), vv.sum(), (vv ** 2).sum(), (vv ** 3).sum(), (vv ** 4).sum(),
            vv.min() if vv.size else np.nan, vv.max() if vv.size else np.nan,
            np.abs(vv).sum()])
    return TableSummary(list(selected_cols), stats, table.num_rows)


class VectorSummary:
    """Dense/sparse vector column summary (reference BaseVectorSummary)."""

    def __init__(self, cnt: int, sum_, sum2, minv, maxv, nnz):
        self._cnt = cnt
        self._sum = sum_
        self._sum2 = sum2
        self._min = minv
        self._max = maxv
        self._nnz = nnz

    def vector_size(self) -> int:
        return int(self._sum.shape[0])

    def count(self) -> int:
        return self._cnt

    def sum(self):
        return self._sum

    def mean(self):
        return self._sum / max(self._cnt, 1)

    def variance(self):
        if self._cnt <= 1:
            return np.zeros_like(self._sum)
        m = self.mean()
        return np.maximum((self._sum2 - self._cnt * m * m) / (self._cnt - 1), 0.0)

    def standard_deviation(self):
        return np.sqrt(self.variance())

    def min(self):
        return self._min

    def max(self):
        return self._max

    def num_non_zero(self):
        return self._nnz


def summarize_vector_col(table: MTable, vector_col: str) -> VectorSummary:
    vecs = [VectorUtil.parse(v) for v in table.col(vector_col)]
    dim = 0
    for v in vecs:
        dim = max(dim, v.size() if isinstance(v, DenseVector)
                  else (v.n if v.n >= 0 else int(v.indices[-1]) + 1 if v.indices.size else 0))
    s = np.zeros(dim)
    s2 = np.zeros(dim)
    mn = np.full(dim, np.inf)
    mx = np.full(dim, -np.inf)
    nnz = np.zeros(dim)
    for v in vecs:
        if isinstance(v, DenseVector):
            d = np.zeros(dim)
            d[:v.size()] = v.data
            s += d
            s2 += d * d
            mn = np.minimum(mn, d)
            mx = np.maximum(mx, d)
            nnz += d != 0
        else:
            idx, val = v.indices, v.values
            np.add.at(s, idx, val)
            np.add.at(s2, idx, val * val)
            np.minimum.at(mn, idx, val)
            np.maximum.at(mx, idx, val)
            np.add.at(nnz, idx, (val != 0).astype(np.float64))
    n = len(vecs)
    # sparse implicit zeros participate in min/max
    if any(not isinstance(v, DenseVector) for v in vecs):
        mn = np.minimum(mn, 0.0)
        mx = np.maximum(mx, 0.0)
    mn = np.where(np.isfinite(mn), mn, 0.0)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    return VectorSummary(n, s, s2, mn, mx, nnz.astype(np.int64))
