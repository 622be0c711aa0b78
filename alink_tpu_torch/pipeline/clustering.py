"""Pipeline wrappers: clustering.

Counterpart: ``alink_tpu/pipeline/clustering.py`` (the reference's
pipeline/clustering/): ``KMeans`` and ``KMeansModel``, ``Lda`` and
``LdaModel``. A model assigns or infers on its ``device`` (the
estimator's, ``cuda`` when none is given).
"""

import functools

from ..operator.base import TableSourceBatchOp
from ..operator.batch.clustering.kmeans_ops import (KMeansModelMapper,
                                                    KMeansPredictBatchOp,
                                                    KMeansTrainBatchOp,
                                                    _KMeansParams)
from ..operator.batch.clustering.lda_ops import (LdaModelMapper,
                                                 LdaPredictBatchOp,
                                                 LdaTrainBatchOp,
                                                 _LdaTrainParams)
from ..params.shared import (HasPredictionCol, HasPredictionDetailCol,
                             HasReservedCols)
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


class LdaModel(MapModel, HasPredictionCol, HasPredictionDetailCol,
               HasReservedCols):
    """reference: pipeline/clustering/LdaModel.java"""
    MAPPER_CLS = LdaModelMapper

    def transform(self, in_op):
        op = LdaPredictBatchOp(self.params.clone(), device=self.device)
        return op.link_from(TableSourceBatchOp(self.get_model_data()),
                            _as_op(in_op))

    def get_local_predictor(self) -> LocalPredictor:
        return LocalPredictor(
            functools.partial(LdaModelMapper, device=self.device),
            self.get_model_data(), self.params)


class Lda(Trainer, _LdaTrainParams, HasPredictionCol, HasPredictionDetailCol,
          HasReservedCols):
    """reference: pipeline/clustering/Lda.java"""
    TRAIN_OP_CLS = LdaTrainBatchOp
    MODEL_CLS = LdaModel
