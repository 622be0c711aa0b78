"""ALS batch operators.

Counterpart: ``alink_tpu/operator/batch/recommendation/als_ops.py`` (the
re-design of the reference's batch/recommendation/ AlsTrainBatchOp,
AlsPredictBatchOp, AlsTopKPredictBatchOp and common/recommendation/
AlsModelDataConverter). The model table is the JAX package's, so a
table saved by either package loads in the other. ``AlsTrainBatchOp``
takes ``device=`` (``cuda`` unless the caller asks for the CPU; raises
without it) and trains ``als_train`` on a one-worker session there. The
ratings and the top-K scores are the JAX package's host float64 numpy,
copied: there is no device route for them here, as there is none in
the reference.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from ....common.device import resolve_device
from ....common.mlenv import MLEnvironment
from ....common.mtable import MTable
from ....common.params import ParamInfo, Params, RangeValidator
from ....common.types import AlinkTypes
from ....model.converters import (SimpleModelDataConverter, decode_array,
                                  encode_array)
from ....params.shared import HasPredictionCol, HasReservedCols, HasSeed
from ...base import BatchOperator
from ...common.recommendation.als import AlsTrainParams, als_train


class AlsModelData:
    def __init__(self, user_ids: List, item_ids: List, user_factors: np.ndarray,
                 item_factors: np.ndarray, user_col: str, item_col: str,
                 rate_col: str):
        self.user_ids = user_ids
        self.item_ids = item_ids
        self.user_factors = user_factors
        self.item_factors = item_factors
        self.user_col, self.item_col, self.rate_col = user_col, item_col, rate_col


class AlsModelDataConverter(SimpleModelDataConverter):
    """reference: common/recommendation/AlsModelDataConverter.java"""

    def serialize_model(self, m: AlsModelData):
        meta = Params({"user_col": m.user_col, "item_col": m.item_col,
                       "rate_col": m.rate_col,
                       "user_ids": [str(u) for u in m.user_ids],
                       "item_ids": [str(i) for i in m.item_ids]})
        return meta, [encode_array(m.user_factors), encode_array(m.item_factors)]

    def deserialize_model(self, meta, data):
        return AlsModelData(
            list(meta._m.get("user_ids", [])), list(meta._m.get("item_ids", [])),
            decode_array(data[0]), decode_array(data[1]),
            meta._m.get("user_col", "user"), meta._m.get("item_col", "item"),
            meta._m.get("rate_col", "rating"))


class AlsTrainBatchOp(BatchOperator, HasSeed):
    """reference: batch/recommendation/AlsTrainBatchOp.java. Trains on
    ``device`` (``cuda`` by default; raises without it). Side output 0:
    ``iter`` / ``train_rmse``, one row a superstep run."""
    USER_COL = ParamInfo("user_col", str, optional=False)
    ITEM_COL = ParamInfo("item_col", str, optional=False)
    RATE_COL = ParamInfo("rate_col", str, optional=False)
    RANK = ParamInfo("rank", int, default=10, validator=RangeValidator(1, None))
    NUM_ITER = ParamInfo("num_iter", int, default=10,
                         validator=RangeValidator(1, None))
    LAMBDA = ParamInfo("lambda_", float, default=0.1, aliases=("lambda",))
    IMPLICIT_PREFS = ParamInfo("implicit_prefs", bool, default=False)
    ALPHA = ParamInfo("alpha", float, default=40.0)
    NONNEGATIVE = ParamInfo("nonnegative", bool, default=False)
    SHARD_SOLVE = ParamInfo("shard_solve", bool, default=False,
                            description="shard the normal-equation "
                                        "accumulation + solve by id range "
                                        "(reduce_scatter) and all_gather "
                                        "only the solved factors")

    def __init__(self, params: Optional[Params] = None, device=None,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.device = resolve_device(device)

    def link_from(self, in_op: BatchOperator) -> "AlsTrainBatchOp":
        t = in_op.get_output_table()
        uc, ic, rc = self.get_user_col(), self.get_item_col(), self.get_rate_col()
        users_raw = t.col(uc)
        items_raw = t.col(ic)
        user_ids = sorted({_c(v) for v in users_raw}, key=str)
        item_ids = sorted({_c(v) for v in items_raw}, key=str)
        u_lookup = {v: i for i, v in enumerate(user_ids)}
        i_lookup = {v: i for i, v in enumerate(item_ids)}
        users = np.asarray([u_lookup[_c(v)] for v in users_raw], np.int32)
        items = np.asarray([i_lookup[_c(v)] for v in items_raw], np.int32)
        ratings = np.asarray(t.col(rc), np.float64)
        p = AlsTrainParams(
            rank=self.get_rank(), num_iter=self.get_num_iter(),
            lambda_reg=self.get_lambda_(), implicit_prefs=self.get_implicit_prefs(),
            alpha=self.get_alpha(), nonnegative=self.get_nonnegative(),
            seed=self.get_seed(), shard_solve=self.get_shard_solve())
        uf, if_, curve = als_train(users, items, ratings, p,
                                   env=MLEnvironment(device=self.device),
                                   num_users=len(user_ids),
                                   num_items=len(item_ids))
        model = AlsModelData(user_ids, item_ids, np.asarray(uf, np.float64),
                             np.asarray(if_, np.float64), uc, ic, rc)
        self._output = AlsModelDataConverter().save_model(model)
        self._side_outputs = [MTable({"iter": np.arange(1, len(curve) + 1),
                                      "train_rmse": curve.astype(np.float64)})]
        return self


def _c(v):
    return v.item() if isinstance(v, np.generic) else v


def _id_index(ids) -> dict:
    """id -> row index under both the raw and the string form of the id."""
    lookup: dict = {}
    for i, v in enumerate(ids):
        lookup.setdefault(v, i)
        lookup.setdefault(str(v), i)
    return lookup


def _encode_ids(col, lookup: dict) -> np.ndarray:
    """id -> factor-row encode; -1 for unknown ids.

    The column collapses to its distinct values first (np.unique), so only
    O(distinct) Python-level dict probes run regardless of row count — the
    factor math afterwards is a single gather + einsum. Columns whose
    values don't sort (mixed types) fall back to a memoized row loop."""
    arr = np.asarray(col)
    try:
        uniq, inv = np.unique(arr, return_inverse=True)
    except TypeError:
        out = np.empty(len(col), np.int64)
        memo: dict = {}
        for r, v in enumerate(col):
            v = _c(v)
            j = memo.get(v)
            if j is None:
                j = lookup.get(str(v), lookup.get(v, -1))
                memo[v] = j
            out[r] = j
        return out
    codes = np.asarray([lookup.get(str(_c(v)), lookup.get(_c(v), -1))
                        for v in uniq], np.int64)
    return codes[inv.reshape(-1)]


class AlsRater:
    """Loaded ALS factors + id lookups, reusable across calls — the stream
    predict op loads this once and rates every micro-batch with it."""

    def __init__(self, model_table: MTable):
        self.m = AlsModelDataConverter().load_model(model_table)
        # ids round-trip to strings through the model table, so index both
        # the raw and the str form of every id
        self.u_lookup = _id_index(self.m.user_ids)
        self.i_lookup = _id_index(self.m.item_ids)

    def rate_table(self, t: MTable, user_col: str, item_col: str,
                   prediction_col: str, reserved_cols=None) -> MTable:
        m = self.m
        ui = _encode_ids(t.col(user_col), self.u_lookup)
        ii = _encode_ids(t.col(item_col), self.i_lookup)
        valid = (ui >= 0) & (ii >= 0)
        # one gather per side + a row-wise dot; unknown ids -> NaN
        preds = np.einsum("ij,ij->i", m.user_factors[np.maximum(ui, 0)],
                          m.item_factors[np.maximum(ii, 0)])
        preds = np.where(valid, preds, np.nan)
        from ....mapper.base import OutputColsHelper
        helper = OutputColsHelper(t.schema, [prediction_col],
                                  [AlinkTypes.DOUBLE], reserved_cols)
        return helper.build_output(t, [preds])


class AlsPredictBatchOp(BatchOperator, HasPredictionCol, HasReservedCols):
    """Predict the rating of (user, item) rows (reference AlsPredictBatchOp)."""
    USER_COL = ParamInfo("user_col", str, optional=False)
    ITEM_COL = ParamInfo("item_col", str, optional=False)

    def link_from(self, model_op: BatchOperator, data_op: BatchOperator):
        rater = AlsRater(model_op.get_output_table())
        self._output = rater.rate_table(
            data_op.get_output_table(), self.get_user_col(),
            self.get_item_col(), self.params._m.get("prediction_col", "pred"),
            self.params._m.get("reserved_cols"))
        return self


class AlsTopKPredictBatchOp(BatchOperator, HasPredictionCol):
    """Top-K item recommendations per user row (reference AlsTopKPredictBatchOp)."""
    USER_COL = ParamInfo("user_col", str, optional=False)
    TOP_K = ParamInfo("top_k", int, default=10)

    def link_from(self, model_op: BatchOperator, data_op: BatchOperator):
        m = AlsModelDataConverter().load_model(model_op.get_output_table())
        t = data_op.get_output_table()
        u_lookup = _id_index(m.user_ids)
        k = min(self.get_top_k(), len(m.item_ids))
        recs = np.empty(t.num_rows, object)
        # one matmul for all requested users (MXU-sized batch)
        uidx = _encode_ids(t.col(self.get_user_col()), u_lookup)
        valid = uidx >= 0
        scores = m.user_factors[np.maximum(uidx, 0)] @ m.item_factors.T
        top = np.argsort(-scores, axis=1)[:, :k]
        for r in range(t.num_rows):
            if not valid[r]:
                recs[r] = None
                continue
            recs[r] = json.dumps({
                "object": [str(m.item_ids[j]) for j in top[r]],
                "rate": [float(scores[r, j]) for j in top[r]]})
        from ....mapper.base import OutputColsHelper
        helper = OutputColsHelper(t.schema,
                                  [self.params._m.get("prediction_col",
                                                      "recommendations")],
                                  [AlinkTypes.STRING])
        self._output = helper.build_output(t, [recs])
        return self
