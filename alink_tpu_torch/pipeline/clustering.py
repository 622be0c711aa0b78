"""Pipeline wrappers: clustering.

Counterpart: ``alink_tpu/pipeline/clustering.py`` (the reference's
pipeline/clustering/): ``KMeans`` and ``KMeansModel``. The model
assigns on its ``device`` (the estimator's, ``cuda`` when none is
given). ``Lda`` waits for its ops (ROADMAP A7).
"""

import functools

from ..operator.base import TableSourceBatchOp
from ..operator.batch.clustering.kmeans_ops import (KMeansModelMapper,
                                                    KMeansPredictBatchOp,
                                                    KMeansTrainBatchOp,
                                                    _KMeansParams)
from ..params.shared import HasPredictionCol, HasReservedCols
from .base import LocalPredictor, MapModel, Trainer, _as_op


class KMeansModel(MapModel, HasPredictionCol, HasReservedCols):
    MAPPER_CLS = KMeansModelMapper
    PREDICTION_DISTANCE_COL = KMeansPredictBatchOp.PREDICTION_DISTANCE_COL

    def transform(self, in_op):
        op = KMeansPredictBatchOp(self.params.clone(), device=self.device)
        return op.link_from(TableSourceBatchOp(self.get_model_data()),
                            _as_op(in_op))

    def get_local_predictor(self) -> LocalPredictor:
        return LocalPredictor(
            functools.partial(KMeansModelMapper, device=self.device),
            self.get_model_data(), self.params)


class KMeans(Trainer, _KMeansParams, HasPredictionCol, HasReservedCols):
    TRAIN_OP_CLS = KMeansTrainBatchOp
    MODEL_CLS = KMeansModel
    PREDICTION_DISTANCE_COL = KMeansPredictBatchOp.PREDICTION_DISTANCE_COL
