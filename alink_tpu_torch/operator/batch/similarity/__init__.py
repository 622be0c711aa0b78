"""Similarity batch operators.

Counterpart: ``alink_tpu/operator/batch/similarity/__init__.py``, the
re-design of operator/batch/similarity/ (StringSimilarityPairwiseBatchOp,
TextSimilarityPairwiseBatchOp, ApproxVectorSimilarityJoinLSHBatchOp,
ApproxVectorSimilarityTopNLSHBatchOp over common/similarity/ metrics and
common/feature/BaseLSH/MinHashLSH/BucketRandomProjectionLSH). The LSH
ops take ``device=`` (``cuda`` unless the caller asks for the CPU;
raises without it), where the Euclidean hash runs
(``common/similarity/lsh.py``); ``stage_seconds`` holds the last link's
split (extract, hash, buckets, re-score). The port's own param
``bucket_width`` sets the Euclidean hash's bucket width; left unset it
is the JAX package's default. The string ops run on the host and take
no device.
"""


from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ....common.device import resolve_device

from ....common.mtable import MTable
from ....common.params import ParamInfo, Params
from ....common.types import AlinkTypes, TableSchema
from ....params.shared import HasOutputCol, HasSelectedCols, HasSeed
from ...base import BatchOperator
from ...common.similarity.lsh import approx_join
from ...common.similarity.metrics import SIMILARITY_FUNCS


class StringSimilarityPairwiseBatchOp(BatchOperator, HasSelectedCols, HasOutputCol):
    """Row-wise similarity of two string columns
    (reference batch/similarity/StringSimilarityPairwiseBatchOp)."""

    METRIC = ParamInfo("metric", str, default="LEVENSHTEIN_SIM")

    def link_from(self, in_op: BatchOperator) -> "StringSimilarityPairwiseBatchOp":
        t = in_op.get_output_table()
        c0, c1 = self.get_selected_cols()
        fn = SIMILARITY_FUNCS.get(self.get_metric().upper())
        if fn is None:
            raise ValueError(f"unknown metric {self.get_metric()}; "
                             f"use {sorted(SIMILARITY_FUNCS)}")
        vals = np.asarray([fn(str(a) if a is not None else "",
                              str(b) if b is not None else "")
                           for a, b in zip(t.col(c0), t.col(c1))])
        out = self.params._m.get("output_col") or "similarity"
        self._output = t.add_column(out, vals, AlinkTypes.DOUBLE)
        return self


class TextSimilarityPairwiseBatchOp(StringSimilarityPairwiseBatchOp):
    """Token-level variant (reference TextSimilarityPairwiseBatchOp):
    each distinct token of the pair maps to one private-use codepoint, so
    the character metrics operate on token sequences."""

    def link_from(self, in_op: BatchOperator) -> "TextSimilarityPairwiseBatchOp":
        t = in_op.get_output_table()
        c0, c1 = self.get_selected_cols()
        fn = SIMILARITY_FUNCS.get(self.get_metric().upper())
        if fn is None:
            raise ValueError(f"unknown metric {self.get_metric()}")

        def row_val(a, b):
            ta = str(a).split() if a is not None else []
            tb = str(b).split() if b is not None else []
            codes = {w: chr(0xE000 + i)
                     for i, w in enumerate(dict.fromkeys(ta + tb))}
            return fn("".join(codes[w] for w in ta),
                      "".join(codes[w] for w in tb))

        vals = np.asarray([row_val(a, b) for a, b in zip(t.col(c0), t.col(c1))])
        out = self.params._m.get("output_col") or "similarity"
        self._output = t.add_column(out, vals, AlinkTypes.DOUBLE)
        return self


class ApproxVectorSimilarityJoinLSHBatchOp(BatchOperator, HasSeed):
    """LSH candidate join + exact re-score, distance <= threshold
    (reference ApproxVectorSimilarityJoinLSHBatchOp)."""

    LEFT_COL = ParamInfo("left_col", str, optional=False)
    RIGHT_COL = ParamInfo("right_col", str, optional=False)
    LEFT_ID_COL = ParamInfo("left_id_col", str, optional=False)
    RIGHT_ID_COL = ParamInfo("right_id_col", str, optional=False)
    DISTANCE_THRESHOLD = ParamInfo("distance_threshold", float, default=float("inf"))
    METRIC = ParamInfo("metric", str, default="EUCLIDEAN")
    # the port's own: the Euclidean bucket width (left unset, the JAX
    # package's BucketRandomProjectionLSH default, 1.0)
    BUCKET_WIDTH = ParamInfo("bucket_width", float, "Euclidean bucket width")

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)
        self.stage_seconds: Dict[str, float] = {}

    def link_from(self, left: BatchOperator,
                  right: BatchOperator) -> "ApproxVectorSimilarityJoinLSHBatchOp":
        self.stage_seconds = {}
        width = self.params._m.get("bucket_width")
        lsh_kw = ({} if width is None or self.get_metric().upper() == "JACCARD"
                  else {"bucket_width": width})
        rows = approx_join(
            left.get_output_table(), right.get_output_table(),
            self.get_left_col(), self.get_right_col(),
            self.get_left_id_col(), self.get_right_id_col(),
            threshold=float(self.get_distance_threshold()),
            metric=self.get_metric(), top_n=self._top_n(),
            seed=int(self.get_seed() or 0), device=self.device,
            stages=self.stage_seconds, **lsh_kw)
        lt = left.get_schema().type_of(self.get_left_id_col())
        rt = right.get_schema().type_of(self.get_right_id_col())
        self._output = MTable(rows or [],
                              TableSchema([self.get_left_id_col(),
                                           self.get_right_id_col(), "distance"],
                                          [lt, rt, AlinkTypes.DOUBLE]))
        return self

    def _top_n(self) -> Optional[int]:
        return None


class ApproxVectorSimilarityTopNLSHBatchOp(ApproxVectorSimilarityJoinLSHBatchOp):
    """TopN variant (reference ApproxVectorSimilarityTopNLSHBatchOp)."""

    TOP_N = ParamInfo("top_n", int, default=10)

    def _top_n(self) -> Optional[int]:
        return int(self.get_top_n())
