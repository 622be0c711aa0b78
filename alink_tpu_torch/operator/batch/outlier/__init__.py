"""Outlier detection batch operators.

Counterpart: ``alink_tpu/operator/batch/outlier/__init__.py``, the
re-design of operator/batch/outlier/SosBatchOp.java +
operator/common/outlier/SOSImpl.java (Stochastic Outlier Selection,
Janssens et al. 2012).

``SosBatchOp`` runs the JAX package's ``_sos_kernel`` on ``device`` in
``dtype`` (``DeviceTrainBatchOp``'s convention: ``cuda`` unless the
caller asks for the CPU, float32 unless ``torch.float64``): squared
distances by one product, 64 batched bisection steps on every row's
affinity bandwidth beta, then each column's log-sum of the
complementary binding probabilities. It runs in blocks of rows
(:func:`sos_scores`): the distances, the bisection and the binding
probabilities are row-wise, and the column sums add up across blocks,
so no (n, n) array is ever whole (at ODDS shuttle's 49,097 rows one is
19.3 GB in float64). A float32 product on the card raises while TF32 is
on (``objfunc.check_full_float32``).

The port's difference: each row's distances are shifted by the row's
smallest off-diagonal distance ``d_min`` before ``exp``
(:func:`_shift_rows`), in the bisection and in the binding
probabilities. The binding probabilities ``a / sum(a)`` do not change,
and the entropy ``log sum(a) + beta * sum(d2 a) / sum(a)`` becomes
``log sum(a') - beta d_min + beta * sum(d2 a') / sum(a')``, which is
the same formula on the shifted distances, so the code computes that
(no cancellation of two large terms). The nearest neighbour's affinity
is then exp(0) = 1, so ``sum(a')`` is at least 1 and never underflows:
in the JAX package (and this op before) a row whose affinities all
underflow float32 at its beta (``exp`` of -104 and below) made a 0/0
binding row and every other column's score NaN (ODDS shuttle in
float32). The floors stay the JAX package's weak-typed ``1e-300``
(0 in float32), now inert in both dtypes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ....common.mtable import MTable
from ....common.params import ParamInfo
from ....common.types import AlinkTypes, TableSchema
from ....params.shared import HasPredictionCol, HasVectorCol
from ...base import BatchOperator
from ...common.dataproc.feature_extract import extract_design
from ..utils.model_map import DeviceTrainBatchOp

SOS_BLOCK_BYTES = 1 << 30        # one (rows, n) array of a row block


def sos_block_rows(n: int, itemsize: int,
                   budget: int = SOS_BLOCK_BYTES) -> int:
    """Rows a block: as many as keep one (rows, n) array within
    ``budget`` bytes (at least one, at most n)."""
    return max(1, min(n, budget // max(n * itemsize, 1)))


def _sq_dists(X, sq, r0: int, r1: int, diag) -> torch.Tensor:
    """Rows r0:r1 of the squared-distance matrix, ``inf`` on the
    diagonal (the JAX package's ``(sq_i + sq_j) - 2 x_i.x_j``, at 0 or
    above)."""
    p = X[r0:r1] @ X.T
    d2 = sq[r0:r1, None] + sq[None, :]
    d2.sub_(p.mul_(2.0))
    del p
    d2.clamp_min_(0.0)
    d2[diag] = float("inf")
    return d2


def _shift_rows(d2) -> torch.Tensor:
    """``d2`` less each row's smallest entry (its nearest neighbour's
    distance; the diagonal's ``inf`` stays), in place."""
    return d2.sub_(d2.amin(1, keepdim=True))


def _solve_beta(d2, diag, log_perp, floor, n_iter: int) -> torch.Tensor:
    """Each row's beta after ``n_iter`` bisection steps on the entropy
    of its binding distribution (SOSImpl.solveForBeta, batched), from
    the rows' shifted distances (:func:`_shift_rows`)."""
    rows, dt, dev = d2.shape[0], d2.dtype, d2.device
    lo = torch.zeros(rows, dtype=dt, device=dev)
    hi = torch.full((rows,), float("inf"), dtype=dt, device=dev)
    beta = torch.ones(rows, dtype=dt, device=dev)
    for _ in range(n_iter):
        # log H = log(sum a) + beta * sum(d2 a) / sum(a), a = exp(-beta d2)
        a = torch.mul(d2, -beta[:, None]).exp_()
        s = a.sum(1) + floor
        a.mul_(d2)
        a[diag] = 0.0
        err = torch.log(s) + beta * (a.sum(1) / s) - log_perp
        # err > 0: the entropy is too high, beta goes up
        up = err > 0
        lo = torch.where(up, beta, lo)
        hi = torch.where(up, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    return beta


def sos_scores(X: torch.Tensor, perplexity: float, n_iter: int = 64,
               block_rows: Optional[int] = None) -> torch.Tensor:
    """Outlier probabilities of the rows of ``X`` (n, d) on its device
    and in its dtype, ``block_rows`` rows at a time (by default
    :func:`sos_block_rows`). (n, d) -> (n,)."""
    n = X.shape[0]
    dt, dev = X.dtype, X.device
    floor = torch.tensor(1e-300, dtype=dt, device=dev)   # 0 in float32
    sq = (X * X).sum(1)
    log_perp = torch.log(torch.tensor(min(perplexity, n - 1.0), dtype=dt,
                                      device=dev))
    B = block_rows or sos_block_rows(n, X.element_size())
    colsum = torch.zeros(n, dtype=dt, device=dev)
    for r0 in range(0, n, B):
        r1 = min(n, r0 + B)
        local = torch.arange(r1 - r0, device=dev)
        diag = (local, local + r0)
        d2 = _shift_rows(_sq_dists(X, sq, r0, r1, diag))
        beta = _solve_beta(d2, diag, log_perp, floor, n_iter)
        # binding probabilities, then log(1 - b) for p_j = prod_i (1 - b_ij)
        b = torch.mul(d2, -beta[:, None]).exp_()
        del d2
        b.div_(b.sum(1, keepdim=True) + floor)
        log1m = torch.maximum(b.neg_().add_(1.0), floor).log_()
        log1m[diag] = 0.0
        colsum += log1m.sum(0)
        del b, log1m
    return torch.exp(colsum)


class SosBatchOp(DeviceTrainBatchOp, HasVectorCol, HasPredictionCol):
    """reference: operator/batch/outlier/SosBatchOp.java (appends an
    outlier-probability DOUBLE column to the input), through
    :func:`sos_scores` on the op's device and dtype."""
    PERPLEXITY = ParamInfo("perplexity", float, "target affinity perplexity",
                           default=4.0)

    def link_from(self, in_op: BatchOperator) -> "SosBatchOp":
        from ...common.optim.objfunc import check_full_float32
        t = in_op.get_output_table()
        design = extract_design(t, None, self.get_vector_col(), np.float64)
        if design["kind"] == "dense":
            X = design["X"]
        else:
            from ....common.vector import SparseBatch
            X = SparseBatch(design["idx"], design["val"],
                            design["dim"]).to_dense(np.float64)
        Xd = torch.from_numpy(np.asarray(X, np.float64)).to(self.device,
                                                            self.dtype)
        check_full_float32({"X": Xd})
        probs = sos_scores(Xd, float(self.get_perplexity()))
        cols = {c: t.col(c) for c in t.col_names}
        cols[self.get_prediction_col()] = probs.cpu().numpy().astype(np.float64)
        schema = TableSchema(t.col_names + [self.get_prediction_col()],
                             list(t.schema.types) + [AlinkTypes.DOUBLE])
        self._output = MTable(cols, schema)
        return self
