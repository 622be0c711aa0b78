"""Stream recommendation operators.

Counterpart: ``alink_tpu/operator/stream/recommendation.py`` (the
re-design of the reference's operator/stream/recommendation/
AlsPredictStreamOp.java): the batch-trained ALS model crosses from its
batch operator (the reference's DirectReader side channel) and rates
each (user, item) micro-batch with ``AlsRater``'s host float64 ratings,
the batch op's own.
"""

from __future__ import annotations

from typing import Optional

from ...common.mtable import MTable
from ...common.params import Params
from ..base import BatchOperator
from ..batch.recommendation.als_ops import AlsPredictBatchOp, AlsRater
from .core import BaseStreamTransformOp

__all__ = ["AlsPredictStreamOp"]


class AlsPredictStreamOp(BaseStreamTransformOp):
    """Rate (user, item) pairs on a stream with a batch-trained ALS model.

    The model is converted and its id lookups built ONCE per drain
    (reference loads the model once via the DirectReader side channel);
    each micro-batch then only pays the per-row dot products.
    """

    USER_COL = AlsPredictBatchOp.USER_COL
    ITEM_COL = AlsPredictBatchOp.ITEM_COL
    PREDICTION_COL = AlsPredictBatchOp.param_infos()["prediction_col"]
    RESERVED_COLS = AlsPredictBatchOp.param_infos()["reserved_cols"]

    def __init__(self, model_op: Optional[BatchOperator] = None,
                 params: Optional[Params] = None, **kwargs):
        super().__init__(params, **kwargs)
        self._model_op = model_op

    def _open(self, in_schema):
        self._rater = AlsRater(self._model_op.get_output_table())
        return self._transform(MTable([], in_schema)).schema

    def _transform(self, mt: MTable):
        return self._rater.rate_table(
            mt, self.params._m["user_col"], self.params._m["item_col"],
            self.params._m.get("prediction_col", "pred"),
            self.params._m.get("reserved_cols"))

    def link_from(self, *inputs) -> "AlsPredictStreamOp":
        if len(inputs) == 2 and isinstance(inputs[0], BatchOperator):
            self._model_op = inputs[0]
            inputs = inputs[1:]
        return super().link_from(*inputs)
