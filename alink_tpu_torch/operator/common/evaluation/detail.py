"""Columnar prediction-detail column.

PyTorch port: a copy of ``alink_tpu/operator/common/evaluation/detail.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

The predict -> eval hot path used to round-trip every row through JSON:
the mapper ``json.dumps``-ed one detail dict per row and the stream
evaluator ``json.loads``-ed them back (re-parsing the whole cumulative
span every window). This class keeps the per-class probabilities
columnar — ``(labels, probs (n, k))`` — and renders the EXACT
``json.dumps({str(label): float(p), ...})`` string only when a consumer
actually asks for a row (sinks, to_rows); ``parse_detail_probs``
recognizes it and reads the probability matrix zero-parse.
"""

from __future__ import annotations

import json
from typing import List, Sequence

import numpy as np

from ....common.columnar import ColumnarColumn


class PredictionDetailColumn(ColumnarColumn):
    """Columnar (labels, probs) details (protocol: common/columnar.py)."""

    __slots__ = ("labels", "probs")

    def __init__(self, labels: Sequence[str], probs: np.ndarray):
        assert probs.ndim == 2 and probs.shape[1] == len(labels)
        self.labels: List[str] = [str(l) for l in labels]
        self.probs = probs

    def __len__(self):
        return self.probs.shape[0]

    def _render_row(self, i: int) -> str:
        return json.dumps({l: float(p)
                           for l, p in zip(self.labels, self.probs[i])})

    def _subset(self, sel):
        return PredictionDetailColumn(self.labels, self.probs[sel])

    def copy(self) -> "PredictionDetailColumn":
        return PredictionDetailColumn(self.labels, self.probs.copy())

    def concat_same(self, other):
        if (isinstance(other, PredictionDetailColumn)
                and other.labels == self.labels):
            return PredictionDetailColumn(
                self.labels, np.concatenate([self.probs, other.probs]))
        return None
