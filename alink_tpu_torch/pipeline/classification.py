"""Pipeline wrappers: classification.

Counterpart: ``alink_tpu/pipeline/classification.py`` (the reference's
pipeline/classification/ shells over the batch ops, Trainer.java's
reflection pattern). Ported: ``LogisticRegression`` and
``LogisticRegressionModel``; each estimator carries both train and
predict params so the fitted model transforms directly. The estimator
trains on ``cuda`` unless given ``device=`` (``Trainer.fit``). The SVM,
Softmax and Perceptron shells wait for their train ops (ROADMAP Queue
A).
"""

from ..operator.batch.classification.linear import (
    LogisticRegressionTrainBatchOp, _LinearPredictParams, _LinearTrainParams)
from ..operator.common.linear.mapper import LinearModelMapper
from ..params.shared import HasPositiveLabelValueString
from .base import MapModel, Trainer


class _LinearParams(_LinearTrainParams, _LinearPredictParams):
    pass


class LogisticRegressionModel(MapModel, _LinearPredictParams):
    MAPPER_CLS = LinearModelMapper


class LogisticRegression(Trainer, _LinearParams, HasPositiveLabelValueString):
    TRAIN_OP_CLS = LogisticRegressionTrainBatchOp
    MODEL_CLS = LogisticRegressionModel
