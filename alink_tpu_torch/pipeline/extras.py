"""Pipeline wrappers completing the reference inventory: ALS.

Counterpart: ``alink_tpu/pipeline/extras.py`` (:170-199, the reference's
pipeline/recommendation/ALS and ALSModel). ``ALS`` trains
``AlsTrainBatchOp`` on its ``device`` (``cuda`` unless given
``device="cpu"``); ``ALSModel.transform`` rates (user, item) rows with
``AlsPredictBatchOp`` and ``recommend_top_k`` ranks items with
``AlsTopKPredictBatchOp``, both on the host. The rest of the JAX
package's module (GLM, isotonic and AFT regression, GMM and bisecting
KMeans, MLPC, the indexers, the vector and format transformers and the
reference's base-class names) waits for its ops (ROADMAP A7).
"""

from __future__ import annotations

from ..operator.base import BatchOperator, TableSourceBatchOp
from ..operator.batch.recommendation.als_ops import (AlsPredictBatchOp,
                                                     AlsTopKPredictBatchOp,
                                                     AlsTrainBatchOp)
from .base import Estimator, Model, _as_op


class ALSModel(Model):
    """Fitted ALS factors (reference pipeline/recommendation/ALSModel)."""

    _PARAM_INFOS = {**AlsTrainBatchOp._PARAM_INFOS,
                    **AlsPredictBatchOp._PARAM_INFOS}

    def transform(self, in_op) -> BatchOperator:
        op = AlsPredictBatchOp(self.params.clone())
        return op.link_from(TableSourceBatchOp(self.get_model_data()),
                            _as_op(in_op))

    def recommend_top_k(self, in_op, k: int = 10) -> BatchOperator:
        op = AlsTopKPredictBatchOp(self.params.clone(), top_k=k)
        return op.link_from(TableSourceBatchOp(self.get_model_data()),
                            _as_op(in_op))


class ALS(Estimator):
    """reference pipeline/recommendation/ALS.java"""

    _PARAM_INFOS = dict(ALSModel._PARAM_INFOS)

    def fit(self, in_op) -> ALSModel:
        train = AlsTrainBatchOp(self.params.clone(), device=self.device)
        train.link_from(_as_op(in_op))
        model = ALSModel(self.params.clone(), device=self.device)
        model.set_model_data(train.get_output_table())
        return model
